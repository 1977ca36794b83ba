"""heston_tpu_torch.utils.native (the OpenMP C++ engine of
csrc/heston_cpu.cpp, built into build/heston_tpu_torch/) against dense
numpy, the JAX package's native engine and the port's eager loop,
float64 on the CPU (tests/test_native.py's checks on the port)."""

import dataclasses
import functools

import numpy as np
import pytest

from heston_tpu.config import (GOLDEN_DIVIDENDS, Barrier, GridSpec,
                               HestonParams, SolverConfig)
from heston_tpu.utils import native as jnative
import heston_tpu_torch
from heston_tpu_torch.models import douglas
from heston_tpu_torch.ops import operators
from heston_tpu_torch.utils import native

from torch_parity import CPU, npy, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

KS = np.array([85.0, 100.0, 115.0])
AMER_DIV = dict(american=True, dividends=GOLDEN_DIVIDENDS)
# (spec, solver, keywords) of each book: every scheme with and without
# Rannacher start-up, American with the golden dividends, a put, an up-out
# barrier and a digital
CASES = {
    **{f"{scheme}_rann{r}": (GridSpec(m1=24, m2=12),
                             SolverConfig(n_steps=6, scheme=scheme,
                                          rannacher_steps=r), AMER_DIV)
       for scheme in ("do", "cs", "mcs", "hv") for r in (0, 2)},
    "euro": (GridSpec(m1=30, m2=15), SolverConfig(n_steps=8), {}),
    "put_amer_div": (GridSpec(m1=30, m2=15), SolverConfig(n_steps=8),
                     dict(AMER_DIV, option_type="put")),
    "digital_amer": (GridSpec(m1=30, m2=15), SolverConfig(n_steps=8),
                     dict(american=True, option_type="digital_call")),
    "up_out_amer_div": (GridSpec(m1=24, m2=12,
                                 barrier=Barrier("up-out", 160.0)),
                        SolverConfig(n_steps=6), AMER_DIV),
}
# a maturity ladder in one call: groups of 5 and 10 steps at dt = 0.1
LADDER_KS = np.array([90.0, 100.0, 110.0, 95.0, 105.0])
LADDER_GROUPS = ((0, 3, 5), (3, 5, 10))
LADDER_SPEC = GridSpec(m1=30, m2=15)
LADDER_SOLVER = SolverConfig(n_steps=10, rannacher_steps=2)
# the cases also held against the JAX package's native engine (its field
# assembly compiles once per configuration): one per scheme, Rannacher,
# a put and the barrier
JAX_CASES = ("do_rann0", "cs_rann2", "mcs_rann0", "hv_rann2",
             "put_amer_div", "up_out_amer_div")
# measured max abs gaps over CASES (prices ~1..20): port native against
# the JAX package's native engine 3.0e-14, against the port's eager loop
# ("scan") 3.2e-14; pinned at about 10x
JAX_NATIVE_TOL = 3e-13
EAGER_TOL = 3e-13


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load()
    except Exception as exc:  # pragma: no cover
        pytest.skip(f"native toolchain unavailable: {exc}")


@functools.cache
def _jax_native(name):
    """The JAX package's native engine on a case of JAX_CASES or the
    ladder, once per process."""
    args = (100.0, *param_args(HestonParams()))
    if name == "ladder":
        return jnative.price_batch_cpu(
            LADDER_SPEC, LADDER_SOLVER, LADDER_KS, *args,
            group_steps=LADDER_GROUPS, **AMER_DIV)
    spec, sol, kw = CASES[name]
    return jnative.price_batch_cpu(spec, sol, KS, *args, **kw)


def test_build_goes_to_the_port_build_dir(lib):
    path = native.build()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "heston_tpu_torch")
    assert path.name.startswith("heston_cpu_") and path.exists()
    assert native.omp_threads() >= 1


def test_native_tridiag(lib, rng):
    n = 31
    md = 3.0 + rng.standard_normal(n)
    ml = 0.4 * rng.standard_normal(n)
    mu = 0.4 * rng.standard_normal(n)
    ml[0] = mu[-1] = 0.0
    rhs = rng.standard_normal(n)
    x = native.tridiag_solve(ml, md, mu, rhs)
    dense = np.diag(md) + np.diag(ml[1:], -1) + np.diag(mu[:-1], 1)
    np.testing.assert_allclose(x, np.linalg.solve(dense, rhs), atol=1e-11)


def test_native_penta(lib, rng):
    n = 21
    d = 4.0 + rng.standard_normal(n)
    l1 = 0.4 * rng.standard_normal(n)
    l2 = 0.2 * rng.standard_normal(n)
    u1 = 0.4 * rng.standard_normal(n)
    u2 = 0.2 * rng.standard_normal(n)
    l1[0] = 0.0
    l2[:2] = 0.0
    u1[-1] = 0.0
    u2[-2:] = 0.0
    rhs = rng.standard_normal(n)
    x = native.penta_solve(l2, l1, d, u1, u2, rhs)
    dense = (np.diag(d) + np.diag(l1[1:], -1) + np.diag(l2[2:], -2)
             + np.diag(u1[:-1], 1) + np.diag(u2[:-2], 2))
    np.testing.assert_allclose(x, np.linalg.solve(dense, rhs), atol=1e-11)


@pytest.mark.parametrize("name", list(CASES))
def test_price_batch_cpu_matches_jax_native_and_eager(lib, params, name):
    spec, sol, kw = CASES[name]
    args = (100.0, *param_args(params))
    got = native.price_batch_cpu(port_cfg(spec), port_cfg(sol), KS, *args,
                                 **_port_kw(kw))
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    if name in JAX_CASES:
        np.testing.assert_allclose(got, _jax_native(name), rtol=0,
                                   atol=JAX_NATIVE_TOL)
    eager = heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(dataclasses.replace(
            sol, solver_engine="scan")), t64(KS), *args, device=CPU,
        **_port_kw(kw))
    np.testing.assert_allclose(got, npy(eager), rtol=0, atol=EAGER_TOL)


def test_price_batch_cpu_ladder(lib, params):
    """A maturity ladder in one call (per-option step counts and the
    per-option Rannacher clamp) equals the JAX package's native ladder
    and the port's native engine run group by group at the shared dt."""
    args = (100.0, *param_args(params))
    sol = port_cfg(LADDER_SOLVER)
    got = native.price_batch_cpu(port_cfg(LADDER_SPEC), sol, LADDER_KS,
                                 *args, group_steps=LADDER_GROUPS,
                                 **_port_kw(AMER_DIV))
    np.testing.assert_allclose(got, _jax_native("ladder"), rtol=0,
                               atol=JAX_NATIVE_TOL)
    per_group = np.concatenate([native.price_batch_cpu(
        port_cfg(LADDER_SPEC), dataclasses.replace(
            sol, n_steps=n, maturity=n * sol.delta_t), LADDER_KS[a:e],
        *args, **_port_kw(AMER_DIV)) for a, e, n in LADDER_GROUPS])
    np.testing.assert_allclose(got, per_group, rtol=0, atol=1e-13)


def test_price_batch_cpu_rejects_bad_inputs(lib, params):
    args = (100.0, *param_args(params))
    spec, sol = port_cfg(LADDER_SPEC), port_cfg(LADDER_SOLVER)
    with pytest.raises(ValueError, match="group_steps"):
        native.price_batch_cpu(spec, sol, LADDER_KS, *args,
                               group_steps=((0, 3, 5), (4, 5, 10)))
    with pytest.raises(ValueError, match="scheme"):
        native.price_batch_cpu(spec, dataclasses.replace(sol, scheme="nope"),
                               LADDER_KS, *args)


@pytest.mark.parametrize("option_type,knock_top", [
    ("call", False), ("put", False), ("call", True)])
def test_native_apply_dividend_matches(lib, option_type, knock_top):
    """ht_apply_dividend == douglas.apply_dividend (call zero-fill, put
    column-0 copy, a top-knocked barrier's re-knock)."""
    rng = np.random.default_rng(3)
    vec_s = np.sort(rng.uniform(0.0, 300.0, 21))
    vec_s[0] = 0.0
    u = rng.normal(size=(9, 21))
    barrier = (heston_tpu_torch.Barrier("up-out", 250.0) if knock_top
               else None)
    want = douglas.apply_dividend(t64(u.T)[None], t64(vec_s)[None], 5.0,
                                  0.02, option_type, barrier)[0]
    got = native.apply_dividend(u, vec_s, 5.0, 0.02,
                                put=operators.is_put(option_type),
                                knock_top=knock_top)
    np.testing.assert_allclose(got, npy(want).T, rtol=0, atol=1e-12)


@pytest.mark.parametrize("scheme,rann,american", [
    ("do", 0, False), ("do", 0, True), ("hv", 2, True)])
def test_native_do_solve_matches_eager(lib, params, scheme, rann, american):
    """The whole loop of one option natively (ht_do_solve) against the
    eager loop's terminal surface."""
    spec = heston_tpu_torch.GridSpec(m1=20, m2=12)
    sol = heston_tpu_torch.SolverConfig(n_steps=8, scheme=scheme,
                                        rannacher_steps=rann)
    inst = douglas.prepare_instance(spec, sol, t64([95.0]), 100.0,
                                    *param_args(params))
    b_rate = operators.boundary_rate(params.r_d, params.r_f)
    got = native.do_solve(inst, sol, b_rate, american=american)
    want = douglas.run_time_loop(inst, sol, b_rate, american=american)[0]
    assert got.shape == (spec.m1 + 1, spec.m2 + 1)
    np.testing.assert_allclose(got, npy(want), rtol=0, atol=1e-10)


@pytest.mark.parametrize("scheme,american", [
    ("do", False), ("do", True), ("cs", False), ("mcs", False),
    ("hv", False)])
def test_eager_loop_and_native_match_dense_oracle(lib, params, scheme,
                                                  american):
    """The port's eager loop and the native engine against the dense
    transliteration of the reference (tests/oracle_dense.py, numpy), one
    option at 10 x 8 x 6, as tests/test_douglas.py:65-91 and
    tests/test_schemes.py:44-60 hold the JAX package."""
    import oracle_dense as od

    m1, m2, n = 10, 8, 6
    p = params
    spec = heston_tpu_torch.GridSpec(m1=m1, m2=m2)
    sol = heston_tpu_torch.SolverConfig(n_steps=n, theta=0.8, maturity=1.0,
                                        a2_variant="upwind", scheme=scheme)
    vs, vv, ds, dv = od.build_grid_np(m1, m2, 100.0, 100.0, p.v0)
    a1 = od.dense_a1(vs, vv, ds, p.r_d, p.r_f)
    a2 = od.dense_a2(vs, vv, dv, p.r_d, p.kappa, p.eta, p.sigma, upwind=True)
    a0 = od.dense_a0(vs, vv, ds, dv, p.rho, p.sigma)
    b1, b2 = od.boundary_vectors(vs, m1, m2, p.r_d, p.r_f, n, sol.delta_t)
    u0 = (np.maximum(vs[None, :] - 100.0, 0.0)
          * np.ones((m2 + 1, 1))).reshape(-1)
    dense = {"do": od.do_scheme_dense, "cs": od.cs_scheme_dense,
             "mcs": od.mcs_scheme_dense, "hv": od.hv_scheme_dense}[scheme]
    kw = dict(american=True) if american else {}
    want = dense(m1, m2, n, sol.delta_t, 0.8, p.r_f, a0, a1, a2, b1 + b2,
                 b1, b2, u0, **kw).reshape(m2 + 1, m1 + 1).T
    inst = douglas.prepare_instance(spec, sol, t64([100.0]), 100.0,
                                    *param_args(params))
    eager = douglas.run_time_loop(inst, sol, p.r_f, american=american)[0]
    np.testing.assert_allclose(npy(eager), want, rtol=0, atol=1e-10)
    np.testing.assert_allclose(native.do_solve(inst, sol, p.r_f,
                                               american=american),
                               want, rtol=0, atol=1e-10)

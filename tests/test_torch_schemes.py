"""The corrector schemes of SolverConfig.scheme (Craig-Sneyd "cs",
modified Craig-Sneyd "mcs", Hundsdorfer-Verwer "hv") in heston_tpu_torch
against heston_tpu: the plain versions of both time-loop kernels, primal
and forward mode, fed the JAX package's own fields against its Pallas
kernels in interpret mode, and every entry path under a scheme —
price_batch on both routes (with Rannacher start-up), a mixed-maturity
book, batch_greeks with the parameter Jacobian and calibrate_device.
float64 on the CPU; the CUDA kernels themselves are compared with the
plain versions on the card in tests/test_torch_cuda.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, CalibrationConfig, GridSpec,
                               HestonParams, RateSchedule, SolverConfig)
from heston_tpu.models import bs as jbs
from heston_tpu.models import calibration as jcal
from heston_tpu.models import douglas as jdouglas
from heston_tpu.models import greeks as jgreeks
from heston_tpu.ops import operators as jops
from heston_tpu.pallas import fused_do as jfd
import heston_tpu_torch
from heston_tpu_torch.convert import fields_from_jax, tangent_fields_from_jax
from heston_tpu_torch.kernels import assembly, fused_do, fused_single

from torch_parity import CPU, assert_close, npy, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

SEED = 17
P = HestonParams()
CORRECTORS = ("cs", "mcs", "hv")
SPEC = GridSpec(m1=10, m2=8)
SOLVER = SolverConfig(n_steps=6, a2_variant="upwind", solver_engine="pallas")
# the forward-mode runs: a smaller grid and three steps (the golden
# dividends before steps 1, 2 and 2)
JAC_SPEC = GridSpec(m1=8, m2=6)
JAC_SOLVER = dataclasses.replace(SOLVER, n_steps=3)
ARMS = {"euro": dict(american=False, dividends=None),
        "amer": dict(american=True, dividends=None),
        "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS)}
STRIKES = np.random.default_rng(SEED).uniform(80.0, 120.0, 4)
R_F = 0.01          # growing boundary coefficients (kb2b != 0)


def _with(solver, scheme, **kw):
    return dataclasses.replace(solver, scheme=scheme, **kw)


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


def _numpy(fields):
    return {k: v if isinstance(v, float) else np.asarray(v)
            for k, v in fields.items()}


def _loop_kw(solver, fields, arm):
    """The port's loop arguments of one main phase on `fields`."""
    events = assembly.dividend_plan(port_cfg(solver),
                                    port_cfg(ARMS[arm]["dividends"]))
    remaps = assembly.build_remap_fields(fields["vecs"], events)
    return [e[0] for e in events], remaps, dict(
        theta=solver.theta, delta_t=solver.delta_t, n_steps=solver.n_steps,
        rf=fields["rf_val"], american=ARMS[arm]["american"])


# ---------------------------------------------------------------------------
# kernel 1: the plain loop against the JAX kernel, primal and forward mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_surfaces():
    """(port fields, JAX u, JAX lam) of one interpret-mode launch plan per
    (scheme, arm), on the JAX package's own fields; both [B, ns, nv]."""
    runs = {}

    def get(scheme, arm):
        if (scheme, arm) not in runs:
            solver = _with(SOLVER, scheme)
            ks, tile, n_tiles, _ = jfd._pad_strikes(
                SPEC, jnp.asarray(STRIKES), strict=False)
            jf, vec_s, _, _, _ = jfd._assemble(SPEC, solver, ks, 100.0,
                                               *param_args(P, R_F))
            jf["rf_val"] = jops.boundary_rate(P.r_d, R_F, "call")
            u, lam, _ = jfd._run_chunks(
                SPEC, solver, ARMS[arm]["american"],
                ARMS[arm]["dividends"], jf["u"].dtype, True, False, n_tiles,
                tile, jf, vec_s)
            runs[scheme, arm] = (fields_from_jax(_numpy(jf)),
                                 np.asarray(u).transpose(2, 0, 1),
                                 np.asarray(lam).transpose(2, 0, 1))
        return runs[scheme, arm]
    return get


@pytest.mark.parametrize("arm", ["euro", "amer_div"])
@pytest.mark.parametrize("scheme", CORRECTORS)
def test_plain_loop_matches_jax_kernel(jax_surfaces, scheme, arm):
    """fused_do_reference under a corrector scheme, fed the JAX package's
    fields, against its Pallas kernel in interpret mode: surfaces (and
    the American multiplier) at 1e-11 on every grid point; the surfaces
    are not Douglas's."""
    tf, want_u, want_lam = jax_surfaces(scheme, arm)
    steps, remaps, kw = _loop_kw(SOLVER, tf, arm)
    got_u, got_lam = fused_do.fused_do_reference(tf, steps, remaps, **kw,
                                                 scheme=scheme)
    np.testing.assert_allclose(npy(got_u), want_u, rtol=0, atol=1e-11)
    if kw["american"]:
        np.testing.assert_allclose(npy(got_lam), want_lam, rtol=0,
                                   atol=1e-11)
    douglas, _ = fused_do.fused_do_reference(tf, steps, remaps, **kw)
    assert float((got_u - douglas).abs().max()) > 1e-6


@pytest.fixture(scope="module")
def jax_forward_mode():
    """Per (scheme, arm): the JAX package's linearized assembly along
    (kappa, eta, sigma, rho) (its fused_theta_jacobian's, v0_mode
    "stencil"), its forward-mode Pallas kernel in interpret mode on it,
    and the Jacobian that function reads off the surfaces."""
    runs = {}
    tv = jnp.asarray([P.kappa, P.eta, P.sigma, P.rho, P.v0])

    def get(scheme, arm):
        if (scheme, arm) in runs:
            return runs[scheme, arm]
        solver = _with(JAC_SOLVER, scheme)
        b = len(STRIKES)
        ks, tile, n_tiles, _ = jfd._pad_strikes(
            JAC_SPEC, jnp.asarray(STRIKES), n_tangents=jfd.JAC_TANGENTS,
            strict=False)

        if "linearized" not in runs:
            # the assembly does not depend on the scheme: one linearized
            # assembly, one compiled program, serves every scheme
            def linearized():
                def prep(t):
                    full = jnp.concatenate([t, tv[4:]])
                    f, vec_s, idx_s, idx_v, _ = jfd._assemble(
                        JAC_SPEC, solver, ks, 100.0, full[0], full[1],
                        full[2], full[3], full[4], P.r_d, P.r_f)
                    return (tuple(f[k] for k in jfd._TANGENT_KEYS),
                            (f, vec_s, idx_s, idx_v))

                _, jvp_fn, aux = jax.linearize(
                    prep, tv[:jfd.JAC_TANGENTS], has_aux=True)
                return aux, jax.vmap(jvp_fn)(jnp.eye(jfd.JAC_TANGENTS))

            runs["linearized"] = jax.jit(linearized)()
        (jf, vec_s, idx_s, idx_v), dfields = runs["linearized"]
        jf = dict(jf, rf_val=jops.boundary_rate(P.r_d, P.r_f, "call"))
        tangents = [{k: leaf[kk] for k, leaf in zip(jfd._TANGENT_KEYS,
                                                     dfields)}
                    for kk in range(jfd.JAC_TANGENTS)]
        u, _, dus = jfd._run_chunks(
            JAC_SPEC, solver, ARMS[arm]["american"], ARMS[arm]["dividends"],
            jf["u"].dtype, True, False, n_tiles, tile, jf, vec_s, tangents)
        # heston_tpu/pallas/fused_do.py:2078-2084
        base = jfd._extract(u, idx_s, idx_v, b)
        jac = jnp.stack([jfd._extract(du, idx_s, idx_v, b) for du in dus]
                        + [jfd._v0_stencil_col(JAC_SPEC, u, jf["vfl"], idx_s,
                                               idx_v, b, tv[4])], axis=-1)
        runs[scheme, arm] = dict(
            fields=fields_from_jax(_numpy(jf)),
            tangents=tangent_fields_from_jax(
                [{k: np.asarray(x) for k, x in t.items()} for t in tangents]),
            u=np.asarray(u).transpose(2, 0, 1),
            dus=[np.asarray(du).transpose(2, 0, 1) for du in dus],
            base=np.asarray(base), jac=np.asarray(jac))
        return runs[scheme, arm]
    return get


def _assert_normalized(got, want, tol):
    """max |got - want| / max(1, |want|) <= tol."""
    got, want = npy(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))
    assert err <= tol, err


# the arm of each scheme's forward-mode run: CS on the bench's jac_cs arm
# (European, bench.py:901-902), MCS American, HV American with the golden
# dividends (remaps of every tangent)
TANGENT_ARMS = {"cs": "euro", "mcs": "amer", "hv": "amer_div"}


@pytest.mark.parametrize("scheme", CORRECTORS)
def test_plain_tangent_loop_matches_jax_kernel(jax_forward_mode, scheme):
    """The plain forward-mode loop under a corrector scheme (the tangent
    corrector, heston_tpu/pallas/fused_do.py:1008-1054), fed JAX's
    fields and its four tangent field sets, against JAX's K = 4
    forward-mode kernel: primal surfaces at 1e-11, tangent surfaces at
    1e-10 normalized by max(1, |du|)."""
    arm = TANGENT_ARMS[scheme]
    run = jax_forward_mode(scheme, arm)
    steps, remaps, kw = _loop_kw(JAC_SOLVER, run["fields"], arm)
    got_u, _, got_du, _ = fused_do.fused_do_reference(
        run["fields"], steps, remaps, **kw, tangents=run["tangents"],
        scheme=scheme)
    np.testing.assert_allclose(npy(got_u), run["u"], rtol=0, atol=1e-11)
    assert len(got_du) == fused_do.JAC_TANGENTS
    for g, w in zip(got_du, run["dus"]):
        _assert_normalized(g, w, 1e-10)


@pytest.mark.parametrize("scheme", CORRECTORS)
def test_fused_theta_jacobian_matches_jax(jax_forward_mode, scheme):
    """The port's fused_theta_jacobian under a corrector scheme (its own
    linearized assembly, one forward-mode launch, the v0 surface stencil)
    against JAX's: base prices at 1e-11, the Jacobian at 1e-10
    normalized; the base prices are the primal launch's, bitwise."""
    arm = TANGENT_ARMS[scheme]
    run = jax_forward_mode(scheme, arm)
    args = (port_cfg(JAC_SPEC), port_cfg(_with(JAC_SOLVER, scheme)),
            t64(STRIKES), 100.0)
    kw = _port_kw(ARMS[arm])
    base, jac = fused_do.fused_theta_jacobian(
        *args, t64([P.kappa, P.eta, P.sigma, P.rho, P.v0]), P.r_d, P.r_f,
        **kw)
    np.testing.assert_allclose(npy(base), run["base"], rtol=0, atol=1e-11)
    _assert_normalized(jac, run["jac"], 1e-10)
    assert torch.equal(base, fused_do.fused_price_batch(
        *args, *param_args(P), **kw))


@pytest.mark.parametrize("scheme", CORRECTORS)
def test_packed_jacobian_matches_jax(jax_forward_mode, scheme):
    """The card's route to the Jacobian (fused_do.packed_jacobian: the
    packed book plan, the tangent rows, the forward mode a phase straight
    from both; on the CPU their plain versions) under a corrector scheme
    against JAX's fused_theta_jacobian on the same inputs: base prices at
    1e-11, the Jacobian at 1e-10 normalized; and bitwise the host route's
    (fused_theta_jacobian on CPU strikes)."""
    arm = TANGENT_ARMS[scheme]
    run = jax_forward_mode(scheme, arm)
    args = (port_cfg(JAC_SPEC), port_cfg(_with(JAC_SOLVER, scheme)),
            t64(STRIKES), 100.0, t64([P.kappa, P.eta, P.sigma, P.rho, P.v0]),
            P.r_d, P.r_f)
    kw = _port_kw(ARMS[arm])
    base, jac = fused_do.packed_jacobian(*args, **kw)
    np.testing.assert_allclose(npy(base), run["base"], rtol=0, atol=1e-11)
    _assert_normalized(jac, run["jac"], 1e-10)
    host_base, host_jac = fused_do.fused_theta_jacobian(*args, **kw)
    assert torch.equal(base, host_base) and torch.equal(jac, host_jac)


# ---------------------------------------------------------------------------
# the entry paths
# ---------------------------------------------------------------------------

# (scheme, batch, rannacher steps, arm): each scheme through the
# single-option kernel, and Rannacher + scheme on both routes
ROUTES = {
    "cs_single_euro": ("cs", 1, 0, "euro"),
    "mcs_single_amer": ("mcs", 1, 0, "amer"),
    "hv_single_rann_amer_div": ("hv", 1, 2, "amer_div"),
    "mcs_batched_rann_amer_div": ("mcs", 4, 2, "amer_div"),
}


@pytest.mark.parametrize("case", sorted(ROUTES))
def test_price_batch_matches_jax(monkeypatch, case):
    """price_batch under a corrector scheme against JAX's price_batch with
    solver_engine="pallas" (its single-option kernel at B = 1, the
    batched one at B = 4, both in interpret mode) at 1e-11, and against
    its XLA scan engine at 1e-10. A spy on both loops shows the route and
    one launch per phase: a Douglas damp phase, then the scheme's."""
    scheme, batch, rann, arm = ROUTES[case]
    solver = _with(SOLVER, scheme, rannacher_steps=rann)
    strikes = STRIKES[:batch]
    kw = ARMS[arm]
    args = (100.0, *param_args(P, R_F))
    want = np.asarray(jdouglas.price_batch(SPEC, solver, jnp.asarray(strikes),
                                           *args, **kw))
    scan = np.asarray(jdouglas.price_batch(
        SPEC, dataclasses.replace(solver, solver_engine="scan"),
        jnp.asarray(strikes), *args, **kw))
    calls = []

    def spy(name, fn):
        def wrapped(*a, **loop_kw):
            calls.append((name, loop_kw["scheme"]))
            return fn(*a, **loop_kw)
        return wrapped

    monkeypatch.setattr(fused_single, "fused_single_loop",
                        spy("single", fused_single.fused_single_loop))
    monkeypatch.setattr(fused_do, "fused_do_loop",
                        spy("batched", fused_do.fused_do_loop))
    got = heston_tpu_torch.price_batch(
        port_cfg(SPEC), port_cfg(solver), t64(strikes), *args,
        **_port_kw(kw), device=CPU)
    route = "single" if batch == 1 else "batched"
    assert calls == [(route, "do")] * (rann > 0) + [(route, scheme)]
    np.testing.assert_allclose(npy(got), want, rtol=0, atol=1e-11)
    np.testing.assert_allclose(npy(got), scan, rtol=0, atol=1e-10)


@pytest.mark.parametrize("scheme", CORRECTORS)
def test_single_and_batched_plain_loops_agree(scheme):
    """One American-dividend option through both plain loops under a
    corrector scheme (PCR against Thomas, the two kernels' orders of
    arithmetic): equal to rounding."""
    kw = _port_kw(ARMS["amer_div"])
    args = (port_cfg(SPEC), port_cfg(_with(SOLVER, scheme)), t64([104.0]),
            100.0, *param_args(P))
    single = fused_single.fused_price_single(*args, **kw)
    batched = fused_do.fused_price_batch(*args, **kw)
    np.testing.assert_allclose(npy(single), npy(batched), rtol=1e-10,
                               atol=1e-12)


def test_mixed_book_matches_jax():
    """A mixed-maturity American-dividend book under HV in one launch
    (per-option step counts) against JAX's per-lane launch in interpret
    mode, rtol 1e-9 / atol 1e-10."""
    solver = _with(SOLVER, "hv")
    nst = [2, 6, 3, 1, 6, 4]
    strikes = np.linspace(85.0, 115.0, 6)
    kw = ARMS["amer_div"]
    want = jax.jit(lambda k: jfd.fused_price_batch(
        SPEC, solver, k, 100.0, *param_args(P), interpret=True,
        n_steps_per=jnp.asarray(nst), **kw))(jnp.asarray(strikes))
    got = fused_do.fused_price_batch(
        port_cfg(SPEC), port_cfg(solver), t64(strikes), 100.0,
        *param_args(P), **_port_kw(kw), n_steps_per=nst)
    assert_close(got, want, rtol=1e-9, atol=1e-10)


def test_batch_greeks_with_jacobian_matches_jax():
    """batch_greeks(param_jacobian=True) under HV (the scheme the JAX
    package recommends for vanna and volga) on a European book: one
    surface launch and one forward-mode launch on both sides; every
    column at rtol 1e-9 / atol 1e-10."""
    solver = _with(JAC_SOLVER, "hv")
    strikes = np.linspace(80.0, 120.0, 6)
    want = jgreeks.batch_greeks(JAC_SPEC, solver, jnp.asarray(strikes),
                                100.0, *param_args(P), param_jacobian=True)
    got = heston_tpu_torch.batch_greeks(
        port_cfg(JAC_SPEC), port_cfg(solver), t64(strikes), 100.0,
        *param_args(P), param_jacobian=True, device=CPU)
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], rtol=1e-9, atol=1e-10, err_msg=k)


def test_calibrate_device_matches_jax(monkeypatch):
    """calibrate_device(jacobian_mode="ad") under CS against the JAX
    package's (its fused Jacobian and trial pricing in interpret mode),
    three LM iterations of an American chain, at rtol 1e-9 / atol 1e-10 on
    the parameters and the whole history; one forward-mode and one
    primal launch per iteration, each under CS."""
    solver = _with(SOLVER, "cs")
    strikes = np.linspace(85.0, 115.0, 6)
    market = np.asarray(jbs.generate_market_data(100.0, 1.0, P.r_d,
                                                 jnp.asarray(strikes)))
    init = np.array([1.2, 0.05, 0.4, -0.5, 0.05])
    cfg = CalibrationConfig(max_iter=3, tol=1e-10, jacobian_mode="ad")
    wtv, winfo = jcal.calibrate_device(
        SPEC, solver, jnp.asarray(strikes), jnp.asarray(market), 100.0,
        jnp.asarray(init), P.r_d, P.r_f, cfg=cfg, american=True)
    calls = []
    loop = fused_do.fused_do_loop

    def spy(*a, **loop_kw):
        calls.append((loop_kw.get("tangents") is not None,
                      loop_kw["scheme"]))
        return loop(*a, **loop_kw)

    monkeypatch.setattr(fused_do, "fused_do_loop", spy)
    gtv, ginfo = heston_tpu_torch.calibrate_device(
        port_cfg(SPEC), port_cfg(solver), t64(strikes), t64(market), 100.0,
        t64(init), P.r_d, P.r_f, cfg=port_cfg(cfg), american=True,
        device=CPU)
    np.testing.assert_allclose(npy(gtv), np.asarray(wtv), rtol=1e-9,
                               atol=1e-10)
    assert ginfo["iterations"] == int(winfo["iterations"]) == 3
    for k in ("error", "lam", "params"):
        np.testing.assert_allclose(npy(ginfo["history"][k]),
                                   np.asarray(winfo["history"][k]),
                                   rtol=1e-9, atol=1e-10, err_msg=k)
    np.testing.assert_array_equal(npy(ginfo["history"]["accepted"]),
                                  np.asarray(winfo["history"]["accepted"]))
    assert sorted(calls) == [(False, "cs")] * 3 + [(True, "cs")] * 3


# ---------------------------------------------------------------------------
# the gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["single", "batched", "jacobian", "loops"])
def test_unknown_scheme_is_a_value_error(entry):
    """An unknown scheme raises ValueError on every path (the JAX kernels'
    own check, heston_tpu/pallas/fused_do.py:386-388; tests/
    test_schemes.py:81-87); nothing runs it as Douglas."""
    solver = port_cfg(_with(SOLVER, "nope"))
    args = (port_cfg(SPEC), solver)
    with pytest.raises(ValueError, match="scheme"):
        if entry == "single":
            heston_tpu_torch.price_batch(*args, t64([100.0]), 100.0,
                                         *param_args(P), device=CPU)
        elif entry == "batched":
            heston_tpu_torch.price_batch(*args, t64([90.0, 110.0]), 100.0,
                                         *param_args(P), device=CPU)
        elif entry == "jacobian":
            fused_do.fused_theta_jacobian(
                *args, t64([90.0, 110.0]), 100.0,
                t64([P.kappa, P.eta, P.sigma, P.rho, P.v0]), P.r_d, P.r_f)
        else:
            fields, kw = _book_inputs()
            fused_do.fused_do_loop(fields, [], [], **kw, scheme="nope")
    fields, kw = _book_inputs()
    with pytest.raises(ValueError, match="scheme"):
        fused_do._launch(fields, [], [], **kw, scheme="nope")


def _book_inputs():
    """A two-option book's loop fields and the arguments of a two-step
    American launch."""
    fields, _, _, _, _ = assembly.assemble(
        port_cfg(SPEC), port_cfg(SOLVER), t64([90.0, 110.0]), 100.0,
        *param_args(P))
    return fields, dict(theta=0.5, delta_t=0.1, n_steps=2, rf=0.0,
                        american=True)


@pytest.mark.parametrize("case", ["rannacher_tangents", "put"])
def test_scheme_keeps_the_other_gates(case):
    """A corrector scheme composes with the eager loop as with the
    kernels: the AD Jacobian of a damped curve book (the JAX package's
    XLA linearize path, atol 1e-9) and a put curve book on the scan
    engine (atol 1e-12) equal the JAX package's under HV."""
    solver = _with(SOLVER, "hv", rannacher_steps=2)
    jcurve = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.0))
    ks = np.array([90.0, 110.0])
    theta = np.array([P.kappa, P.eta, P.sigma, P.rho, P.v0])
    if case == "put":
        scan = dataclasses.replace(solver, solver_engine="scan")
        got = heston_tpu_torch.price_batch(
            port_cfg(SPEC), port_cfg(scan), t64(ks), 100.0, *param_args(P),
            option_type="put", rate_schedule=port_cfg(jcurve), device=CPU)
        want = jdouglas.price_batch(SPEC, scan, jnp.asarray(ks), 100.0,
                                    *param_args(P), option_type="put",
                                    rate_schedule=jcurve)
        assert_close(got, want, rtol=0, atol=1e-12)
        return
    got = heston_tpu_torch.models.calibration.jacobian_and_prices_ad(
        port_cfg(SPEC), port_cfg(solver), t64(ks), 100.0, t64(theta), P.r_d,
        P.r_f, rate_schedule=port_cfg(jcurve), device=CPU)
    want = jcal.jacobian_and_prices_ad(SPEC, solver, jnp.asarray(ks), 100.0,
                                       jnp.asarray(theta), P.r_d, P.r_f,
                                       rate_schedule=jcurve)
    for g, w in zip(got, want):
        assert_close(g, w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("scheme", CORRECTORS)
def test_loops_on_cpu_run_the_plain_versions(scheme):
    """Both wrappers hand a CPU tensor to the plain version under the
    scheme they are given, bitwise, and count no launch."""
    fields, kw = _book_inputs()
    kw["scheme"] = scheme
    before = (fused_do.fused_do_loop.launches,
              fused_single.fused_single_loop.launches)
    got = fused_do.fused_do_loop(fields, [], [], **kw)
    want = fused_do.fused_do_reference(fields, [], [], **kw)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    sf, phases, _ = fused_single.single_plan(
        port_cfg(SPEC), port_cfg(_with(SOLVER, scheme)), t64([100.0]),
        100.0, *param_args(P), american=True)
    (steps1, remaps1, kw1), = phases
    assert kw1["scheme"] == scheme
    got1 = fused_single.fused_single_loop(sf, steps1, remaps1, **kw1)
    want1 = fused_single.fused_single_reference(sf, steps1, remaps1, **kw1)
    assert all(torch.equal(g, w) for g, w in zip(got1, want1))
    assert (fused_do.fused_do_loop.launches,
            fused_single.fused_single_loop.launches) == before

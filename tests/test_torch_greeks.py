"""heston_tpu_torch.models.greeks against heston_tpu.models.greeks: book
risk read off the solution surfaces (batch_greeks, its pde_theta and gamma
wrappers), uniform and mixed-maturity, with the parameter Jacobian and the
rate sensitivities. The JAX side runs its fused engine in interpret mode;
the port runs the plain version of the kernel. float64 on the CPU, every
column at rtol 1e-9 / atol 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, GridSpec, HestonParams,
                               RateSchedule, SolverConfig)
from heston_tpu.models import greeks as jgreeks
import heston_tpu_torch
from heston_tpu_torch.models import greeks

from torch_parity import CPU, assert_close, npy, param_args, port_cfg, t64

P = HestonParams()
SPEC = GridSpec(m1=12, m2=8)
SOLVER = SolverConfig(n_steps=6, a2_variant="upwind", solver_engine="pallas")
STRIKES = np.linspace(80.0, 120.0, 8)
AMER_DIV = dict(american=True, dividends=GOLDEN_DIVIDENDS)
CASES = {
    "uniform_amer_div": dict(AMER_DIV),
    "mixed_amer_div": dict(AMER_DIV,
                           group_steps=((0, 3, 2), (3, 5, 6), (5, 8, 4))),
    # European keeps the JAX side's six interpret-mode launches (surfaces,
    # forward mode, four rate bumps) inside its budget
    "jacobian_rates": dict(group_steps=((0, 4, 3), (4, 8, 6)),
                           param_jacobian=True, rates=True),
}


@pytest.fixture(scope="module")
def jax_risk():
    """One JAX batch_greeks run per case, shared by the module's tests."""
    runs = {}

    def get(case):
        if case not in runs:
            out = jgreeks.batch_greeks(SPEC, SOLVER, jnp.asarray(STRIKES),
                                       100.0, *param_args(P), **CASES[case])
            runs[case] = {k: np.asarray(v) for k, v in out.items()}
        return runs[case]
    return get


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_greeks_matches_jax(jax_risk, case):
    """Every RISK_KEYS column (and param_jacobian, rho_rd, rho_rf where
    asked for) against the JAX package's batch_greeks."""
    want = jax_risk(case)
    got = heston_tpu_torch.batch_greeks(
        port_cfg(SPEC), port_cfg(SOLVER), t64(STRIKES), 100.0,
        *param_args(P), **_port_kw(CASES[case]), device=CPU)
    assert set(got) == set(want)
    assert set(greeks.RISK_KEYS) <= set(got)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], rtol=1e-9, atol=1e-10, err_msg=k)
    assert float(got["gamma"].abs().min()) > 0.0


@pytest.mark.parametrize("name", ["pde_theta", "gamma"])
def test_one_option_wrappers(jax_risk, name):
    """pde_theta and gamma of one strike: a book of one on the batched
    kernel, equal to the first option's column of the JAX book."""
    want = jax_risk("uniform_amer_div")["theta" if name == "pde_theta"
                                        else "gamma"][0]
    got = getattr(heston_tpu_torch, name)(
        port_cfg(SPEC), port_cfg(SOLVER), t64(STRIKES[0]), 100.0,
        *param_args(P), **_port_kw(AMER_DIV), device=CPU)
    assert got.dim() == 0
    assert_close(got, want, rtol=1e-9, atol=1e-10)


JCURVE = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.0))
CURVE = port_cfg(JCURVE)


# a curve book's risk runs (tests/test_torch_curves.py); with group_steps
# or rates=True it raises ValueError, as heston_tpu/models/greeks.py:
# 451-462 routes it. The "scan" engine's book risk and a curve book's
# parameter Jacobian (the linearized eager loop, :522-530) equal the JAX
# package's. Each case: (engine, keywords, the exception and its match, or
# None for a parity case)
OUT_OF_SLICE = {
    "scan": ("scan", {}, None),
    "mixed_max": ("pallas", dict(group_steps=((0, 4, 3), (4, 8, 5))),
                  (ValueError, "max")),
    "curve_jacobian": ("pallas", dict(rate_schedule=CURVE,
                                      param_jacobian=True), None),
    "curve_groups": ("pallas", dict(rate_schedule=CURVE,
                                    group_steps=((0, 4, 6), (4, 8, 3))),
                     (ValueError, "group_steps")),
    "curve_rates": ("pallas", dict(rate_schedule=CURVE, rates=True),
                    (ValueError, "rates")),
}


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_batch_greeks_out_of_slice(case):
    """Raises where the JAX package raises; otherwise every column equals
    the JAX package's at rtol 1e-9 / atol 1e-10 (a curve book's
    param_jacobian against its XLA linearize path)."""
    engine, kw, raises = OUT_OF_SLICE[case]
    solver = SolverConfig(n_steps=6, solver_engine=engine)
    args = (t64(STRIKES), 100.0, *param_args(P))
    if raises is not None:
        with pytest.raises(raises[0], match=raises[1]):
            heston_tpu_torch.batch_greeks(port_cfg(SPEC), port_cfg(solver),
                                          *args, **kw, device=CPU)
        return
    got = heston_tpu_torch.batch_greeks(port_cfg(SPEC), port_cfg(solver),
                                        *args, **kw, device=CPU)
    if case == "scan":
        want = jgreeks.batch_greeks(SPEC, solver, jnp.asarray(STRIKES),
                                    100.0, *param_args(P))
    else:
        from heston_tpu.models import calibration as jcal

        jac, _ = jcal.jacobian_and_prices_ad(
            SPEC, solver, jnp.asarray(STRIKES), 100.0,
            jnp.asarray([P.kappa, P.eta, P.sigma, P.rho, P.v0]), P.r_d,
            P.r_f, rate_schedule=JCURVE)
        want = {"param_jacobian": jac}
    for k in want:
        assert_close(got[k], want[k], rtol=1e-9, atol=1e-10, err_msg=k)


def test_price_and_greeks_waits_for_the_eager_pricer():
    """price_and_greeks runs on the eager pricer: the "pallas" branch (the
    forward-mode kernel, delta and the rate rhos off the eager loop)
    equals the JAX package's "scan" branch at rtol 1e-9 / atol 1e-10,
    the tolerance at which the JAX package holds its two branches
    (tests/test_greeks.py:50-63); tests/test_torch_host_calibration.py
    holds the "scan" branch against JAX's."""
    got = greeks.price_and_greeks(port_cfg(SPEC), port_cfg(SOLVER),
                                  t64(100.0), 100.0, *param_args(P),
                                  device=CPU)
    want = jgreeks.price_and_greeks(
        SPEC, SolverConfig(n_steps=6, solver_engine="scan"), 100.0, 100.0,
        *param_args(P))
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], rtol=1e-9, atol=1e-10, err_msg=k)


def test_batch_greeks_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        heston_tpu_torch.batch_greeks(
            port_cfg(SPEC), port_cfg(SOLVER), t64(STRIKES), 100.0,
            *param_args(P))


def test_float32_book_on_the_plain_version():
    """A float32 mixed book through the plain version: finite columns of
    the strikes' dtype, prices within 1e-4 of the float64 book's."""
    kw = _port_kw(CASES["mixed_amer_div"])
    args = (port_cfg(SPEC), port_cfg(SOLVER))
    got = heston_tpu_torch.batch_greeks(
        *args, torch.tensor(STRIKES, dtype=torch.float32), 100.0,
        *param_args(P), **kw, device=CPU)
    want = heston_tpu_torch.batch_greeks(
        *args, t64(STRIKES), 100.0, *param_args(P), **kw,
        device=CPU)
    for k in greeks.RISK_KEYS:
        assert got[k].dtype == torch.float32 and torch.isfinite(got[k]).all()
    np.testing.assert_allclose(npy(got["price"]), npy(want["price"]),
                               rtol=0, atol=1e-4)

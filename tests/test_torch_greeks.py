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


CURVE = port_cfg(RateSchedule(times=(0.5,), r_d=(0.02, 0.03),
                              r_f=(0.0, 0.0)))


# a curve book's risk runs (tests/test_torch_curves.py); with group_steps
# or rates=True it raises ValueError and its parameter Jacobian (the JAX
# package's XLA linearize path) NotImplementedError, as
# heston_tpu/models/greeks.py:451-462, :522-530 route them
@pytest.mark.parametrize("engine,kw,err,match", [
    ("scan", {}, NotImplementedError, "ROADMAP A6"),
    ("pallas", dict(group_steps=((0, 4, 3), (4, 8, 5))), ValueError, "max"),
    ("pallas", dict(rate_schedule=CURVE, param_jacobian=True),
     NotImplementedError, "ROADMAP A6"),
    ("pallas", dict(rate_schedule=CURVE, group_steps=((0, 4, 6), (4, 8, 3))),
     ValueError, "group_steps"),
    ("pallas", dict(rate_schedule=CURVE, rates=True), ValueError, "rates"),
])
def test_batch_greeks_out_of_slice(engine, kw, err, match):
    solver = port_cfg(SolverConfig(n_steps=6, solver_engine=engine))
    with pytest.raises(err, match=match):
        heston_tpu_torch.batch_greeks(
            port_cfg(SPEC), solver, t64(STRIKES), 100.0, *param_args(P),
            **kw, device=CPU)


def test_price_and_greeks_waits_for_the_eager_pricer():
    with pytest.raises(NotImplementedError, match="ROADMAP A6"):
        greeks.price_and_greeks(port_cfg(SPEC), port_cfg(SOLVER), 100.0,
                                100.0, *param_args(P))


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

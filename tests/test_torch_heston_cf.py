"""heston_tpu_torch.models.heston_cf (the characteristic-function pricer)
and calibrate_device(pricer="cf") against heston_tpu's, float64 on the
CPU; the oracle checks of tests/test_heston_cf.py on the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import CalibrationConfig, GridSpec, SolverConfig
from heston_tpu.models import bs as jbs
from heston_tpu.models import calibration as jcal
from heston_tpu.models import heston_cf as jcf
import heston_tpu_torch
from heston_tpu_torch.models import bs, douglas
from heston_tpu_torch.models import heston_cf as cf

from torch_parity import CPU, npy, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

P = dict(s0=100.0, v0=0.04, kappa=1.5, eta=0.04, sigma=0.3, rho=-0.9,
         r=0.025, t=1.0)
ARGS = (P["v0"], P["kappa"], P["eta"], P["sigma"], P["rho"], P["r"], P["t"])
TRUE_HESTON = 8.8948693600540167    # ref: src/solver.cpp:1666
FD_GOLDEN = 8.8943383103218502      # ref: src/solver.cpp:399
CHAIN = np.linspace(60.0, 150.0, 19)
# the port against the JAX package, max abs over CHAIN at P: measured
# 2.8e-14 (calls, puts) and 2.2e-16 (digitals), pinned at about 10x
CHAIN_TOL = {"call": 3e-13, "put": 3e-13, "digital_call": 3e-15,
             "digital_put": 3e-15}
# a float32 chain (complex64) against the float64 one, max abs over
# CHAIN: measured 1.36e-5 (calls), pinned at about 1.5x
F32_TOL = 2e-5

# calibrate_device(pricer="cf"): a two-maturity chain (T = 0.5 and 1 at
# N = 20, groups of 10 and 20 steps) of flat-vol Black-Scholes quotes,
# which no Heston parameters fit exactly (the SSE stays ~1e-2 and
# measurable); three LM iterations from INIT. The FD Jacobian's 1e-3
# bumps turn the packages' ~1e-14 price gap into ~7e-10 in the
# parameters by the third iteration
LADDER = np.tile(np.linspace(80.0, 120.0, 10), 2)
GROUPS = ((0, 10, 10), (10, 20, 20))
INIT = np.array([1.2, 0.05, 0.3, -0.4, 0.05])
CAL_SPEC = GridSpec(m1=10, m2=6)          # not read by the CF pricer
CAL_SOLVER = SolverConfig(n_steps=20)


@pytest.fixture(scope="module")
def jax_chains():
    return {ot: np.asarray(jcf.price_chain(
        P["s0"], jnp.asarray(CHAIN), *ARGS, option_type=ot))
        for ot in CHAIN_TOL}


@pytest.mark.parametrize("option_type", list(CHAIN_TOL))
def test_price_chain_matches_jax(jax_chains, option_type):
    got = cf.price_chain(P["s0"], t64(CHAIN), *ARGS,
                         option_type=option_type, device=CPU)
    assert got.dtype == torch.float64 and got.shape == CHAIN.shape
    np.testing.assert_allclose(npy(got), jax_chains[option_type], rtol=0,
                               atol=CHAIN_TOL[option_type])


def test_price_chain_float32(jax_chains):
    """A float32 chain runs in complex64 at about float32's resolution of
    the quadrature's sum (no overflow at u_max = 200)."""
    got = cf.price_chain(P["s0"], torch.tensor(CHAIN, dtype=torch.float32),
                         *ARGS, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(npy(got).astype(np.float64),
                               jax_chains["call"], rtol=0, atol=F32_TOL)


def test_cf_reproduces_reference_true_value():
    got = float(cf.call_price(P["s0"], 100.0, *ARGS))
    assert abs(got - TRUE_HESTON) < 1e-10
    # the FD golden is the true value less the discretization's small,
    # systematic domain bias
    assert abs(got - FD_GOLDEN) < 1e-3


def test_cf_degenerates_to_black_scholes():
    """sigma -> 0 with v0 = eta makes Heston collapse to BS(vol=sqrt(v0))."""
    got = float(cf.call_price(100.0, 105.0, 0.04, 2.0, 0.04, 1e-4, 0.0,
                              0.02, 0.8, n_quad=384))
    want = float(bs.call_price(100.0, 105.0, 0.02, 0.2, 0.8))
    assert abs(got - want) < 1e-4


def test_cf_chain_monotone_and_positive():
    prices = npy(cf.price_chain(P["s0"], t64(np.linspace(60.0, 150.0, 10)),
                                *ARGS, device=CPU))
    assert np.all(prices > 0)
    assert np.all(np.diff(prices) < 0)


def test_cf_tangents_match_fd():
    """Forward-mode AD through the complex sqrt, log and exp: the
    linearized chain over (kappa, eta, sigma, rho, v0) against a central
    1e-3 bump (normalized by max(1, |J|): measured 1.3e-3, the bump's
    truncation, held at 3e-3). (The JAX package's linearized chain is
    held by the "ad" fit below, at 1e-8 in the parameters.)"""
    tv = t64([1.5, 0.04, 0.3, -0.9, 0.04])

    def chain(t):
        return cf.price_chain(P["s0"], t64(CHAIN), t[4], t[0], t[1], t[2],
                              t[3], P["r"], P["t"], device=CPU)

    jac, base = douglas.linearize(chain, tv)
    np.testing.assert_array_equal(npy(base), npy(chain(tv)))
    eye = torch.eye(5, dtype=torch.float64)
    fd = torch.stack([(chain(tv + 1e-3 * e) - chain(tv - 1e-3 * e)) / 2e-3
                      for e in eye])
    assert float(((jac - fd).abs() / fd.abs().clamp(min=1.0)).max()) < 3e-3


def _ladder_market():
    return np.concatenate([np.asarray(jbs.generate_market_data(
        100.0, CAL_SOLVER.maturity * n / CAL_SOLVER.n_steps, 0.025,
        jnp.asarray(LADDER[a:b]))) for a, b, n in GROUPS])


@pytest.mark.parametrize("mode", ["ad", "fd"])
def test_calibrate_device_cf_matches_jax(mode):
    """Three LM iterations on a two-maturity chain: the same iterations
    and accept flags as the JAX package,
    theta and the history's parameters within 1e-8, the SSE within 1e-9
    relative; r_f is not read (the JAX package passes r_d alone)."""
    market = _ladder_market()
    cfg = CalibrationConfig(max_iter=3, tol=1e-10, eps=1e-3,
                            jacobian_mode=mode)
    wtv, winfo = jcal.calibrate_device(
        CAL_SPEC, CAL_SOLVER, jnp.asarray(LADDER), jnp.asarray(market),
        100.0, jnp.asarray(INIT), 0.025, 0.0, cfg=cfg, group_steps=GROUPS,
        pricer="cf")
    gtv, ginfo = heston_tpu_torch.calibrate_device(
        port_cfg(CAL_SPEC), port_cfg(CAL_SOLVER), t64(LADDER), t64(market),
        100.0, t64(INIT), 0.025, 0.03, cfg=port_cfg(cfg),
        group_steps=GROUPS, pricer="cf", device=CPU)
    assert gtv.dtype == torch.float64
    assert ginfo["iterations"] == int(winfo["iterations"]) == 3
    np.testing.assert_array_equal(npy(ginfo["history"]["accepted"]),
                                  np.asarray(winfo["history"]["accepted"]))
    np.testing.assert_allclose(npy(gtv), np.asarray(wtv), rtol=0, atol=1e-8)
    np.testing.assert_allclose(npy(ginfo["history"]["params"]),
                               np.asarray(winfo["history"]["params"]),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(float(ginfo["final_error"]),
                               float(winfo["final_error"]), rtol=1e-9)
    np.testing.assert_allclose(npy(ginfo["fitted_prices"]),
                               np.asarray(winfo["fitted_prices"]), rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("kw", [dict(american=True),
                                dict(dividends="golden")])
def test_cf_pricer_rejects_american_or_dividend_chains(kw):
    if "dividends" in kw:
        kw = dict(dividends=heston_tpu_torch.GOLDEN_DIVIDENDS)
    with pytest.raises(ValueError, match="European chains only"):
        heston_tpu_torch.calibrate_device(
            port_cfg(CAL_SPEC), port_cfg(CAL_SOLVER), t64(LADDER[:10]),
            t64(np.ones(10)), 100.0, t64(INIT), 0.025, 0.0, pricer="cf",
            device=CPU, **kw)


def test_price_chain_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cf.price_chain(P["s0"], t64(CHAIN), *ARGS)


def test_cf_fit_of_a_synthetic_market():
    """tests/test_heston_cf.py's fit: the port's device LM with the CF
    pricer fits a 20-strike chain generated from known parameters."""
    strikes = np.linspace(80.0, 120.0, 20)
    market = cf.price_chain(100.0, t64(strikes), 0.06, 2.0, 0.05, 0.4, -0.6,
                            0.025, 1.0, device=CPU)
    cfg = dataclasses.replace(CalibrationConfig(), max_iter=25, tol=1e-10,
                              jacobian_mode="ad")
    _, info = heston_tpu_torch.calibrate_device(
        port_cfg(CAL_SPEC), port_cfg(SolverConfig(n_steps=2)), t64(strikes),
        market, 100.0, t64([1.0, 0.03, 0.2, -0.3, 0.03]), 0.025, 0.0,
        cfg=port_cfg(cfg), pricer="cf", device=CPU)
    rms = float(torch.sqrt(torch.mean((info["fitted_prices"] - market)
                                      ** 2)))
    assert rms < 2e-2
    assert float(info["final_error"]) < 1e-2

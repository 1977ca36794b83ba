"""Calibration fit quality of the port at the reference's sizes, for the
six reference scenarios (tests/test_calibration_quality.py on
heston_tpu_torch, float64 on the CPU; slow, deselected by -m 'not slow').

The market is a Heston market — the port's characteristic-function
pricer for the European no-dividend chains (cross-model), the port's PDE
at the true parameters otherwise (self-consistent) — the fit starts from
a perturbed vector, and the tests assert the SSE's collapse and the
recovery of the identifiable parameters, with the JAX package's bounds.
"""

import dataclasses

import numpy as np
import pytest
import torch

from heston_tpu_torch.config import (CalibrationConfig, GridSpec,
                                     HestonParams, SolverConfig)
from heston_tpu_torch.models import calibration as calib
from heston_tpu_torch.models import heston_cf
from heston_tpu_torch.scenarios import SCENARIOS

CPU = "cpu"
TRUE = HestonParams()  # kappa=1.5 eta=0.04 sigma=0.3 rho=-0.9 v0=0.04
INIT = dataclasses.replace(
    TRUE, kappa=1.2, eta=0.06, sigma=0.45, rho=-0.5, v0=0.06)
SPEC = GridSpec(m1=50, m2=25)          # ref: src/heston_calibration.cpp:48
SOLVER = SolverConfig(n_steps=20)
SPY = 20                               # steps per year for ladders


def _heston_market(targets):
    """Market prices from the TRUE Heston parameters: CF for European
    no-dividend chains, the PDE itself otherwise."""
    prices = np.zeros_like(targets.prices)
    euro_vanilla = (not targets.american) and targets.dividends is None
    for t in np.unique(targets.maturities):
        idx = targets.maturities == t
        ks = torch.as_tensor(targets.strikes[idx], dtype=torch.float64)
        if euro_vanilla:
            out = heston_cf.price_chain(
                targets.s0, ks, TRUE.v0, TRUE.kappa, TRUE.eta, TRUE.sigma,
                TRUE.rho, targets.r_d, float(t), device=CPU)
        else:
            n = max(1, int(round(SPY * float(t))))
            sol = dataclasses.replace(SOLVER, n_steps=n, maturity=float(t))
            out = calib.base_prices(
                SPEC, sol, ks, targets.s0,
                torch.tensor(TRUE.bumpable(), dtype=torch.float64),
                targets.r_d, targets.r_f, american=targets.american,
                dividends=targets.dividends, device=CPU)
        prices[idx] = out.numpy()
    return prices


def _run(name):
    targets = SCENARIOS[name].build_targets()
    targets = dataclasses.replace(targets, prices=_heston_market(targets))
    cfg = CalibrationConfig(max_iter=15, tol=1e-8)
    result = calib.calibrate(targets, SPEC, SOLVER, INIT, cfg,
                             steps_per_year=SPY, device=CPU)
    return result, result.history[0]["sse"]


# the JAX package's two regimes and bounds
# (tests/test_calibration_quality.py:73-103)
SELF_CONSISTENT = {
    #                       sse drop, |drho|, |dsigma|, |dv0|
    "american":               (1e4, 0.01, 0.01, 0.001),
    "dividends":              (1e4, 0.01, 0.01, 0.001),
    "american_dividends":     (1e4, 0.01, 0.01, 0.001),
    "american_dividends_multi": (1e4, 0.01, 0.01, 0.001),
}
CF_MARKET = {
    #                       sse drop, |dv0|
    "european":               (100.0, 0.01),
    "european_multi":         (100.0, 0.01),
}


@pytest.mark.slow
@pytest.mark.parametrize("name", list(SELF_CONSISTENT))
def test_scenario_recovers_parameters(name):
    drop, tol_rho, tol_sigma, tol_v0 = SELF_CONSISTENT[name]
    result, sse0 = _run(name)
    p = result.params
    assert result.final_error < sse0 / drop, (
        f"SSE only {sse0:.4g} -> {result.final_error:.4g}")
    assert abs(p.rho - TRUE.rho) < tol_rho, p
    assert abs(p.sigma - TRUE.sigma) < tol_sigma, p
    assert abs(p.v0 - TRUE.v0) < tol_v0, p
    assert abs(p.kappa - TRUE.kappa) < 0.05 and abs(p.eta - TRUE.eta) < 0.005


@pytest.mark.slow
@pytest.mark.parametrize("name", list(CF_MARKET))
def test_scenario_fits_cf_market(name):
    drop, tol_v0 = CF_MARKET[name]
    result, sse0 = _run(name)
    p = result.params
    assert result.final_error < sse0 / drop, (
        f"SSE only {sse0:.4g} -> {result.final_error:.4g}")
    assert abs(p.v0 - TRUE.v0) < tol_v0, p
    assert 0.1 < p.kappa < 10.0 and 0.005 < p.eta < 0.5, p
    assert 0.05 < p.sigma < 1.0 and -1.0 <= p.rho < 0.0, p


@pytest.mark.slow
def test_cf_pricer_recovers_exactly():
    """When the LM's pricer is the CF pricer, the 60-strike chain
    recovers the whole parameter vector (calibrate_device, pricer='cf')."""
    targets = SCENARIOS["european"].build_targets()
    market = _heston_market(targets)
    cfg = CalibrationConfig(max_iter=25, tol=1e-12)
    tv, _ = calib.calibrate_device(
        SPEC, SOLVER, torch.as_tensor(targets.strikes),
        torch.as_tensor(market), targets.s0,
        torch.tensor(INIT.bumpable(), dtype=torch.float64), targets.r_d,
        targets.r_f, cfg=cfg, pricer="cf", device=CPU)
    want = np.asarray(TRUE.bumpable())
    atol = np.array([5e-2, 2e-3, 1e-3, 1e-3, 1e-3])
    assert np.all(np.abs(tv.numpy() - want) < atol), tv

"""Calibration scenario presets mirroring the reference's six drivers
(PyTorch port of `heston_tpu.scenarios`).

The reference hardcodes six `test_calibration_*` functions (European,
American, dividends, American+dividends, and European / American+dividend
multi-maturity chains; ref: src/heston_calibration.cpp:26, :515, :1036,
:1588, :2428, :3245), and the JAX package adds European and American
puts. Each scenario is a preset over one runner: a synthetic market
(Black–Scholes at flat vol 0.2, or the PDE itself at PDE_MARKET_PARAMS),
an LM fit of the five Heston parameters — on the device
(`calibrate_device`) or by the host loop (`calibrate`) — and an optional
CSV export with implied-vol differences.

The fit's precision is the targets' dtype (`dtype=`, float32 by default,
as the JAX package without x64): float32 takes the exact AD Jacobian,
where a 1e-6 bump would drown in rounding.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from heston_tpu_torch.config import (CalibrationConfig, DividendSchedule,
                                     GridSpec, HestonParams, SolverConfig)
from heston_tpu_torch.models import bs
from heston_tpu_torch.models import calibration as calib
from heston_tpu_torch.models import douglas
from heston_tpu_torch.utils import io as hio

# Dividend schedule of the reference's dividend calibrations
# (ref: src/heston_calibration.cpp:1090-1092)
CALIB_DIVIDENDS = DividendSchedule(
    dates=(0.25, 0.75), amounts=(0.5, 0.5), percentages=(0.01, 0.01))

# "True" parameters of the self-consistent PDE-generated markets
# (market="pde"): an American-put chain has no Black–Scholes analog that
# the model could fit exactly, so the market is the port's own pricer at
# these parameters on the scenario's spec and solver, and the scenario is
# a parameter recovery from the default init.
PDE_MARKET_PARAMS = HestonParams(
    kappa=2.0, eta=0.06, sigma=0.45, rho=-0.6, v0=0.06)


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    num_strikes: int = 60
    maturities: tuple = (1.0,)
    strikes_per_maturity: Optional[int] = None
    american: bool = False
    dividends: Optional[DividendSchedule] = None
    s0: float = 100.0
    r_d: float = 0.025
    r_f: float = 0.0
    max_iter: int = 15
    tol: float = 0.1
    option_type: str = "call"
    market: str = "bs"          # "pde": the chain priced by the port at
                                # PDE_MARKET_PARAMS

    def build_targets(self, spec: Optional[GridSpec] = None,
                      solver: Optional[SolverConfig] = None,
                      steps_per_year: int = 20, dtype=torch.float64,
                      device=None) -> calib.CalibrationTargets:
        """The scenario's chain: strikes 0.7*S0 + i at one maturity (ref:
        src/heston_calibration.cpp:62) or a ladder of
        strikes_per_maturity strikes per maturity (:2465), priced in
        `dtype` (the strikes are numpy arrays of that dtype, so a fit of
        the targets runs in it). A "pde" market runs `price_batch` on
        `device` (None: the card)."""
        if len(self.maturities) == 1:
            strikes = np.array(
                [self.s0 * 0.7 + i for i in range(self.num_strikes)])
            mats = np.full(self.num_strikes, self.maturities[0])
        else:
            per = self.strikes_per_maturity or 20
            ks = np.array([self.s0 * 0.8 + i * 0.4 * self.s0 / per
                           for i in range(per)])
            strikes = np.tile(ks, len(self.maturities))
            mats = np.repeat(np.asarray(self.maturities), per)
        strikes = torch.as_tensor(strikes).to(dtype).numpy()
        prices = np.zeros(len(strikes))
        if self.market == "pde" and (spec is None or solver is None):
            raise ValueError("market='pde' targets need spec and solver")
        for t in np.unique(mats):
            idx = mats == t
            ks_t = torch.as_tensor(strikes[idx])
            if self.market == "pde":
                sol_t = dataclasses.replace(
                    solver,
                    n_steps=max(1, int(round(steps_per_year * float(t)))),
                    maturity=float(t))
                out = douglas.price_batch_params(
                    spec, sol_t, ks_t, self.s0,
                    dataclasses.replace(PDE_MARKET_PARAMS, r_d=self.r_d,
                                        r_f=self.r_f),
                    american=self.american, dividends=self.dividends,
                    option_type=self.option_type, device=device)
            elif self.dividends is not None:
                out = bs.generate_market_data_with_dividends(
                    self.s0, float(t), self.r_d, ks_t, self.dividends.dates,
                    self.dividends.amounts, self.dividends.percentages,
                    option_type=self.option_type)
            else:
                out = bs.generate_market_data(
                    self.s0, float(t), self.r_d, ks_t,
                    option_type=self.option_type)
            prices[idx] = out.detach().cpu().numpy()
        return calib.CalibrationTargets(
            strikes=strikes, maturities=mats, prices=prices, s0=self.s0,
            r_d=self.r_d, r_f=self.r_f, american=self.american,
            dividends=self.dividends, option_type=self.option_type)


SCENARIOS = {
    "european": Scenario("european"),
    "american": Scenario("american", american=True),
    "dividends": Scenario("dividends", dividends=CALIB_DIVIDENDS),
    "american_dividends": Scenario(
        "american_dividends", american=True, dividends=CALIB_DIVIDENDS),
    "european_multi": Scenario(
        "european_multi",
        maturities=(0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0),
        strikes_per_maturity=20),
    "american_dividends_multi": Scenario(
        "american_dividends_multi", american=True,
        dividends=CALIB_DIVIDENDS,
        maturities=(0.25, 0.5, 0.75, 1.0), strikes_per_maturity=20),
    # the JAX package's extensions (the reference is calls-only): a
    # flat-vol BS put chain, and a parameter recovery on an American-put
    # chain priced at PDE_MARKET_PARAMS; both stop on a tight delta norm
    "european_puts": Scenario("european_puts", option_type="put",
                              tol=1e-4),
    "american_puts": Scenario(
        "american_puts", american=True, option_type="put", market="pde",
        tol=1e-4),
}


def _group_steps(targets, steps_per_year: int):
    """(start, end, n_steps) slices per maturity group, the targets
    ordered by maturity (build_targets orders them)."""
    out = []
    mats = targets.maturities
    start = 0
    for i in range(1, len(mats) + 1):
        if i == len(mats) or mats[i] != mats[start]:
            n = max(1, int(round(steps_per_year * float(mats[start]))))
            out.append((start, i, n))
            start = i
    return tuple(out)


def run_scenario(
    name: str,
    spec: GridSpec = GridSpec(m1=50, m2=25),
    solver: SolverConfig = SolverConfig(n_steps=20),
    init: HestonParams = HestonParams(),
    steps_per_year: Optional[int] = 20,
    csv_path: Optional[str] = None,
    pricing_fns=None,
    verbose: bool = True,
    device_loop: bool = False,
    weighting: str = "none",
    dtype=torch.float32,
    device=None,
):
    """Fit the scenario `name` (heston_tpu/scenarios.py:160-254):
    device_loop=True runs `calibrate_device` (group_steps from the
    maturities), False the host loop `calibrate` (`pricing_fns` passed
    through). weighting="vega" fits with 1/vega^2 weights
    (`calibration.vega_weights`). `dtype` is the fit's precision
    (float32: the AD Jacobian); `device` where it runs (None: the card).
    Returns (CalibrationResult, wall seconds)."""
    scenario = SCENARIOS[name]
    spy = steps_per_year or solver.n_steps
    targets = scenario.build_targets(spec=spec, solver=solver,
                                     steps_per_year=spy, dtype=dtype,
                                     device=device)
    if weighting == "vega":
        targets = dataclasses.replace(
            targets, weights=calib.vega_weights(targets))
    elif weighting != "none":
        raise ValueError(f"unknown weighting {weighting!r}")
    cfg = CalibrationConfig(max_iter=scenario.max_iter, tol=scenario.tol)
    if dtype == torch.float32:
        cfg = dataclasses.replace(cfg, jacobian_mode="ad")
    t0 = time.perf_counter()
    if device_loop:
        dev = douglas.resolve_device(device)
        groups = _group_steps(targets, spy)
        if len(groups) == 1:
            groups = ()
        tv, info = calib.calibrate_device(
            spec, solver, torch.as_tensor(targets.strikes, device=dev),
            torch.as_tensor(targets.prices, device=dev).to(dtype),
            targets.s0, torch.tensor(init.bumpable(), dtype=dtype,
                                     device=dev),
            targets.r_d, targets.r_f, cfg=cfg, american=targets.american,
            dividends=targets.dividends, group_steps=groups,
            option_type=targets.option_type,
            weights=None if targets.weights is None
            else torch.as_tensor(targets.weights, device=dev).to(dtype),
            device=dev)
        tv = tv.detach().cpu().numpy()
        iters = int(info["iterations"])
        result = calib.CalibrationResult(
            params=dataclasses.replace(
                init, kappa=float(tv[0]), eta=float(tv[1]),
                sigma=float(tv[2]), rho=float(tv[3]), v0=float(tv[4])),
            initial_params=init,
            final_error=float(info["final_error"]),
            iterations=iters,
            converged=bool(info["converged"]),
            fitted_prices=info["fitted_prices"].detach().cpu().numpy(),
            market_prices=np.asarray(targets.prices),
            strikes=np.asarray(targets.strikes),
            history=[],
            total_pde_solves=len(targets.strikes) * 7 * iters,
        )
    else:
        result = calib.calibrate(
            targets, spec, solver, init, cfg, steps_per_year=steps_per_year,
            verbose=verbose, pricing_fns=pricing_fns, device=device)
    wall = time.perf_counter() - t0
    if verbose:
        p = result.params
        print(f"[{name}] {result.iterations} iters, "
              f"sse={result.final_error:.6e}, wall={wall:.3f}s, "
              f"kappa={p.kappa:.4f} eta={p.eta:.4f} sigma={p.sigma:.4f} "
              f"rho={p.rho:.4f} v0={p.v0:.4f}")
    if csv_path:
        hio.export_calibration_fit(
            csv_path, result, scenario.s0, max(scenario.maturities),
            scenario.r_d, dividends=scenario.dividends,
            option_type=scenario.option_type,
            maturities=(targets.maturities
                        if len(scenario.maturities) > 1 else None))
    return result, wall

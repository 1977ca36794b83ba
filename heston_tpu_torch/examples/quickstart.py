"""End-to-end worked example: price a book, compute Greeks, calibrate to a
synthetic market, export the fit (the port of examples/quickstart.py).

    python -m heston_tpu_torch.examples.quickstart               # the card
    python -m heston_tpu_torch.examples.quickstart --device cpu
"""

import argparse
import dataclasses
import os
import tempfile

import numpy as np
import torch

from heston_tpu_torch import (GOLDEN_DIVIDENDS, CalibrationConfig, GridSpec,
                              HestonParams, SolverConfig)
from heston_tpu_torch.models import bs, calibration, douglas, greeks
from heston_tpu_torch.ops.grid import validate_book
from heston_tpu_torch.utils import io as hio
from heston_tpu_torch.utils import native


def main(argv=None):
    ap = argparse.ArgumentParser(prog="quickstart")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--csv", default=os.path.join(tempfile.gettempdir(),
                                                  "quickstart_fit.csv"),
                    help="where to write the calibration fit")
    args = ap.parse_args(argv)
    dev = douglas.resolve_device(args.device)

    params = HestonParams()          # canonical reference parameter set
    spec = GridSpec(m1=50, m2=25)    # production grid
    solver = SolverConfig(n_steps=20)
    s0 = 100.0
    args5 = (params.kappa, params.eta, params.sigma, params.rho, params.v0,
             params.r_d, params.r_f)

    # --- 1. price a book ---------------------------------------------------
    strikes = torch.linspace(80.0, 120.0, 9, device=dev)
    validate_book(spec, s0, strikes)
    euro = douglas.price_batch_params(spec, solver, strikes, s0, params,
                                      device=dev)
    amer_div = douglas.price_batch_params(
        spec, solver, strikes, s0, params,
        american=True, dividends=GOLDEN_DIVIDENDS, device=dev)
    print("European:         ", np.round(euro.cpu().numpy(), 4))
    print("American+dividends:", np.round(amer_div.cpu().numpy(), 4))

    # --- 1b. puts (the reference prices calls only) ------------------------
    amer_puts = douglas.price_batch_params(
        spec, solver, strikes, s0, params, american=True,
        option_type="put", device=dev)
    print("American puts:     ", np.round(amer_puts.cpu().numpy(), 4))

    # --- 2. Greeks by forward-mode AD through the PDE solve ----------------
    g = greeks.price_and_greeks(spec, solver, torch.tensor(100.0), s0,
                                *args5, device=dev)
    print("ATM delta %.4f  vega(v0) %.2f" % (float(g["delta"]),
                                            float(g["vega_v0"])))

    # --- 2b. whole-book risk in one batched solve --------------------------
    risk = greeks.batch_greeks(spec, solver, strikes, s0, *args5,
                               american=True, dividends=GOLDEN_DIVIDENDS,
                               device=dev)
    print("book delta:", np.round(risk["delta"].cpu().numpy(), 4))
    print("book gamma:", np.round(risk["gamma"].cpu().numpy(), 5))

    # --- 2c. a mixed-maturity book: group_steps = (start, end, n_steps)
    # slices at the shared dt, T_i = n_i * delta_t; under the "pallas"
    # engine the whole ladder runs in one launch of the batched kernel
    mixed = greeks.batch_greeks(
        spec, solver, strikes, s0, *args5, american=True,
        group_steps=((0, 5, 10), (5, len(strikes), 20)),  # T=0.5 and 1.0
        device=dev)
    print("mixed-book theta:", np.round(mixed["theta"].cpu().numpy(), 4))

    # --- 3. calibrate to a synthetic flat-vol market -----------------------
    chain = torch.linspace(70.0, 129.0, 30, device=dev)
    market = bs.generate_market_data(s0, 1.0, params.r_d, chain)
    init = torch.tensor([1.0, 0.05, 0.4, -0.5, 0.05], device=dev)
    tv, info = calibration.calibrate_device(
        spec, solver, chain, market, s0, init, params.r_d, params.r_f,
        cfg=CalibrationConfig(max_iter=10, tol=0.1, jacobian_mode="ad"),
        device=dev)
    tv = tv.cpu().numpy()
    print("calibrated (kappa, eta, sigma, rho, v0):", np.round(tv, 4),
          "sse %.4e in %d iterations" % (float(info["final_error"]),
                                         int(info["iterations"])))

    # --- 4. export a fit CSV -----------------------------------------------
    result = calibration.CalibrationResult(
        params=dataclasses.replace(
            params, kappa=float(tv[0]), eta=float(tv[1]),
            sigma=float(tv[2]), rho=float(tv[3]), v0=float(tv[4])),
        initial_params=params,
        final_error=float(info["final_error"]),
        iterations=int(info["iterations"]),
        converged=bool(info["converged"]),
        fitted_prices=info["fitted_prices"].cpu().numpy(),
        market_prices=market.cpu().numpy(), strikes=chain.cpu().numpy(),
        history=[], total_pde_solves=0)
    path = hio.export_calibration_fit(args.csv, result, s0, 1.0, params.r_d)
    print("fit exported to", path)

    # --- 5. the native C++ CPU engine (no card needed) ---------------------
    cpu = native.price_batch_cpu(
        spec, solver, strikes.cpu().numpy(), s0, *args5, american=True,
        dividends=GOLDEN_DIVIDENDS)
    print("CPU engine max |diff| vs device:",
          float(np.max(np.abs(cpu - amer_div.cpu().double().numpy()))))


if __name__ == "__main__":
    main()

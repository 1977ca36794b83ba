"""CSV exporters for surfaces, convergence studies, book risk, calibration
fits and benchmark sweeps (PyTorch port of `heston_tpu.utils.io`).

The same text as the JAX package's writers for the same inputs: the
reference's ResultsExporter surfaces (ref: src/solver.cpp:17-48), its
ConvergenceExporter tables (ref: src/solver.cpp:50-312), the calibration
fit with implied-vol differences (ref: src/heston_calibration.cpp:
463-511) and the performance-test CSV (ref: src/perfomance_test.cpp:
214-221). Tensors are read once to the host as numpy float arrays.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch


def _host(x, dtype=None) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


def export_surface(path, grid, surface, metadata: Optional[dict] = None):
    """Write (s, v, U) triplets, one row per node, v-major as the JAX
    package writes them (ref: src/solver.cpp:17-48). `surface` is one
    option's [ns, nv] in the port's layout (a book of one, [1, ns, nv],
    as `price_surface` returns it, is taken too); `grid.vec_s` [ns] or
    [1, ns]."""
    path = Path(path)
    vec_s = _host(grid.vec_s).reshape(-1)
    vec_v = _host(grid.vec_v).reshape(-1)
    u = _host(surface).reshape(len(vec_s), len(vec_v))
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        if metadata:
            f.write("# " + ", ".join(f"{k}={v}" for k, v in metadata.items())
                    + "\n")
        w.writerow(["s", "v", "price"])
        for j, v in enumerate(vec_v):
            for i, s in enumerate(vec_s):
                w.writerow([s, v, u[i, j]])
    return path


def export_convergence(path, rows: Sequence[dict], reference_price: float):
    """Write a convergence table (m1, m2, n_steps, price, error, runtime),
    the reference's ConvergenceExporter format (ref: src/solver.cpp:
    281-311)."""
    path = Path(path)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        f.write(f"# reference_price={reference_price!r}\n")
        w.writerow(["m1", "m2", "n_steps", "price", "abs_error",
                    "runtime_s"])
        for r in rows:
            w.writerow([r["m1"], r["m2"], r["n_steps"], r["price"],
                        abs(r["price"] - reference_price),
                        r.get("runtime_s", "")])
    return path


def export_book_risk(path, strikes, risk: dict, metadata=None,
                     maturities=None):
    """Write one row per option of a `batch_greeks` report: strike
    [, maturity], price, delta, gamma, theta, vega_v0, vanna, volga
    [, rho_rd, rho_rf] [, the five parameter sensitivities when risk
    carries 'param_jacobian']."""
    path = Path(path)
    strikes = _host(strikes)
    risk = {k: _host(v) for k, v in risk.items()}
    if maturities is not None:
        maturities = _host(maturities)
    cols = ["strike"] + (["maturity"] if maturities is not None else [])
    value_cols = ["price", "delta", "gamma", "theta"]
    value_cols += [k for k in ("vega_v0", "vanna", "volga",
                               "rho_rd", "rho_rf") if k in risk]
    cols += value_cols
    jac = risk.get("param_jacobian")
    if jac is not None:
        cols += ["d_kappa", "d_eta", "d_sigma", "d_rho", "d_v0"]
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        if metadata:
            f.write("# " + ", ".join(f"{k}={v}" for k, v in metadata.items())
                    + "\n")
        w.writerow(cols)
        for i, k in enumerate(strikes):
            row = [k]
            if maturities is not None:
                row.append(maturities[i])
            row += [float(risk[c][i]) for c in value_cols]
            if jac is not None:
                row += [float(v) for v in jac[i]]
            w.writerow(row)
    return path


def export_calibration_fit(path, result, s0: float, t: float, r_d: float,
                           iv_epsilon: float = 0.01, dividends=None,
                           option_type: str = "call", maturities=None):
    """Write strike / market / fitted / IV-difference rows under a header
    of the initial and final parameters (ref: src/heston_calibration.cpp:
    468-511). The implied vols invert at the escrowed-dividend spot when
    there are dividends (ref: src/heston_calibration.cpp:1500-1529), puts
    through parity, each point at its own maturity with `maturities`
    (ref: src/heston_calibration.cpp:2800-2860), float64 on the CPU with
    the port's `bs.implied_vol`."""
    from heston_tpu_torch.models import bs
    from heston_tpu_torch.ops import operators

    if operators.is_digital(option_type):
        raise ValueError(
            "export_calibration_fit inverts BS implied vols — "
            "vanilla chains only (digital quotes have no IV column)")
    path = Path(path)
    strikes = _host(result.strikes)
    market = _host(result.market_prices)
    fitted = _host(result.fitted_prices)
    mats = (np.full(len(strikes), float(t)) if maturities is None
            else _host(maturities).astype(float))

    iv_mkt = np.zeros(len(strikes))
    iv_fit = np.zeros(len(strikes))
    for tm in sorted(set(mats.tolist())):
        idx = mats == tm
        s_iv = s0
        if dividends is not None and len(dividends) > 0:
            s_iv = float(bs.escrowed_spot(
                s0, tm, r_d, dividends.dates, dividends.amounts,
                dividends.percentages))
        ks_g = torch.as_tensor(strikes[idx], dtype=torch.float64)
        mkt_c = torch.as_tensor(market[idx], dtype=torch.float64)
        fit_c = torch.as_tensor(fitted[idx], dtype=torch.float64)
        if operators.is_put(option_type):
            # the parity-equivalent call quotes at the same spot (an
            # American put's premium inflates both columns alike)
            mkt_c = bs.put_to_call_parity(mkt_c, s_iv, ks_g, r_d, tm)
            fit_c = bs.put_to_call_parity(fit_c, s_iv, ks_g, r_d, tm)
        iv_mkt[idx] = bs.implied_vol(mkt_c, s_iv, ks_g, r_d, tm).numpy()
        iv_fit[idx] = bs.implied_vol(fit_c, s_iv, ks_g, r_d, tm).numpy()

    init = result.initial_params
    fin = result.params
    meta = {
        "n_options": len(strikes),
        "final_error": result.final_error,
        "iterations": result.iterations,
        "total_pde_solves": result.total_pde_solves,
        "init_kappa": init.kappa, "init_eta": init.eta,
        "init_sigma": init.sigma, "init_rho": init.rho, "init_v0": init.v0,
        "kappa": fin.kappa, "eta": fin.eta, "sigma": fin.sigma,
        "rho": fin.rho, "v0": fin.v0,
    }
    with path.open("w", newline="") as f:
        f.write("# " + ", ".join(f"{k}={v}" for k, v in meta.items()) + "\n")
        w = csv.writer(f)
        # one Maturity column spliced in for a multi-maturity chain
        header = ["Strike", "MarketPrice", "FittedPrice", "IVDifference"]
        if maturities is not None:
            header.insert(1, "Maturity")
        w.writerow(header)
        for i, k in enumerate(strikes):
            row = [k, market[i], fitted[i], abs(iv_mkt[i] - iv_fit[i])]
            if maturities is not None:
                row.insert(1, mats[i])
            w.writerow(row)
    return path


def export_benchmark(path, rows: Sequence[dict]):
    """Benchmark CSV: instances, total_runtime, runtime_per_instance,
    throughput (ref: src/perfomance_test.cpp:214-221)."""
    path = Path(path)
    with path.open("w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["m1", "m2", "n_steps", "instances", "total_runtime_s",
                    "runtime_per_instance_s", "throughput_per_s"])
        for r in rows:
            w.writerow([r["m1"], r["m2"], r["n_steps"], r["instances"],
                        r["total_runtime_s"],
                        r["total_runtime_s"] / r["instances"],
                        r["instances"] / r["total_runtime_s"]])
    return path

"""A plain Levenberg-Marquardt fit with the program's accept/reject rule,
for the control of the fit cell: the reference's prices and Jacobian put
in the program's place (`kinds/fit.py`, `control.py`). It returns what
`calibrate_device` returns: (parameters, info) with final_error,
iterations, converged, fitted_prices and history (error, lam, accepted,
params; rows past `iterations` NaN)."""

from __future__ import annotations

import torch

from perfbench.reference.market import clamp, lm_update


def fit(jacobian, prices, market, init, lm: dict):
    """`jacobian(params)` -> (base prices, J); `prices(params)`; `lm` the
    mix's LM settings."""
    dtype, dev = market.dtype, market.device
    lo = torch.tensor(lm["clamp_lo"], dtype=dtype, device=dev)
    hi = torch.tensor([float("inf") if x is None else x
                       for x in lm["clamp_hi"]], dtype=dtype, device=dev)
    n = lm["max_iter"]
    nan = float("nan")
    hist = dict(error=torch.full((n,), nan, dtype=dtype),
                lam=torch.full((n,), nan, dtype=dtype),
                accepted=torch.zeros((n,), dtype=torch.bool),
                params=torch.full((n, 5), nan, dtype=dtype))
    tv = torch.tensor(init, dtype=dtype, device=dev)
    lam = lm["lambda_init"]
    err, fitted, converged, it = None, None, False, 0
    while it < n:
        base, jac = jacobian(tuple(tv.tolist()))
        resid = market - base
        current = float(resid @ resid)
        delta = lm_update(jac, resid, lam)
        new = clamp(tv + delta, lo, hi)
        conv = (float(torch.linalg.norm(delta)) < lm["tol"]
                or current < lm["tol"])
        trial = prices(tuple(new.tolist()))
        new_err = float((market - trial) @ (market - trial))
        accept = new_err < current
        hist["error"][it], hist["lam"][it] = current, lam
        hist["accepted"][it] = accept and not conv
        if conv or accept:
            tv = new
        hist["params"][it] = tv.cpu()
        if not conv:
            lam = (max(lam * lm["lambda_down"], lm["lambda_min"]) if accept
                   else min(lam * lm["lambda_up"], lm["lambda_max"]))
        err = current if conv else min(new_err, current)
        fitted = base if conv or not accept else trial
        converged = converged or conv
        it += 1
        if converged:
            break
    return tv, dict(final_error=torch.tensor(err), iterations=it,
                    converged=torch.tensor(converged), lam=lam,
                    fitted_prices=fitted, history=hist)

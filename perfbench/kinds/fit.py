"""Surface calibration: one request fits the five Heston parameters to a
surface of European call prices through
`models.calibration.calibrate_device(..., group_steps=)` (the whole
ladder in one launch of kernel 1's forward mode and one primal launch
per Levenberg-Marquardt iteration) and ends when the fitted parameters
are on the host.

The mix gives the ladder (strikes `lo + step * i`, i < n, at each of the
`maturities`, group steps round(steps_per_year T)), the LM settings and
the draws of the market state; the market is the float64 Heston (1993)
prices of the ladder at that state (`reference/market.py`), made before
the request starts and handed to the program in the configuration's
precision. Correct, on a sample of the fits: the fitted
prices against the reference's prices at the parameters that produced
them (`fit_price_gap`), the final SSE against the reference's SSE there
(`fit_sse_gap`, relative) and the first step the fit took, recomputed by
the reference from the iterate before it (its Jacobian, residual and
damped step with the program's lambda and the same clamps;
`fit_step_gap`, the distance of the two new iterates over the length of
the reference's step). The first step, not the last: a step taken at
the lambda of a converging fit (1e-5 and below) follows the small
singular directions of J^T J, where float32 rounding of the Jacobian
moves it by up to ~7% (the last step's gap); the first step's lambda is
at least the initial one and its residual is large.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench import roofline
from perfbench.kinds.common import Deployment, market, worst
from perfbench.reference import heston_ref, lm
from perfbench.reference import market as mkt


class Workload:
    """The fit traffic: its entry, its check and its control."""

    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        from heston_tpu_torch import CalibrationConfig

        self.dep = d = Deployment(cfg, device)
        self.mix = mix
        lo, step, n = mix["strikes"]
        self.k_one = np.array([lo + step * i for i in range(n)])
        self.mats = list(mix["maturities"])
        self.group_steps = [max(1, round(mix["steps_per_year"] * t))
                            for t in self.mats]
        if max(self.group_steps) != d.solver.n_steps:
            raise ValueError("the ladder's longest maturity must take the "
                             "configuration's step count")
        self.groups = tuple((i * n, (i + 1) * n, g)
                            for i, g in enumerate(self.group_steps))
        self.ks = torch.tensor(np.tile(self.k_one, len(self.mats)),
                               dtype=d.dtype, device=device)
        lm = mix["lm"]
        lo_c, hi_c = lm["clamp_lo"], lm["clamp_hi"]
        self.cfg = CalibrationConfig(
            max_iter=lm["max_iter"], tol=lm["tol"],
            jacobian_mode=lm["jacobian_mode"],
            lambda_init=lm["lambda_init"], lambda_down=lm["lambda_down"],
            lambda_up=lm["lambda_up"], lambda_min=lm["lambda_min"],
            lambda_max=lm["lambda_max"], kappa_min=lo_c[0],
            eta_min=lo_c[1], sigma_min=lo_c[2], rho_min=lo_c[3],
            rho_max=hi_c[3], v0_min=lo_c[4])
        self.init = tuple(lm["init"])
        self.clamp = [tuple(math.inf if x is None else x for x in hi_c),
                      tuple(lo_c)]
        self.limits = mix["limits"]
        if d.r_f:
            raise ValueError("the fit's market is priced without r_f")

    def prepare(self, fields) -> dict:
        """The request: its fields and the market's prices (float64,
        host)."""
        d = self.dep
        return dict(fields, market=mkt.heston_calls(
            d.s0, self.k_one, d.r_d, self.mats, *market(fields)))

    def call(self, request):
        from heston_tpu_torch.models import calibration

        d = self.dep
        prices = torch.as_tensor(request["market"]).to(d.device, d.dtype)
        tv, info = calibration.calibrate_device(
            d.spec, d.solver, self.ks, prices, d.s0,
            torch.tensor(self.init, dtype=d.dtype), d.r_d, d.r_f,
            cfg=self.cfg, group_steps=self.groups, device=d.device)
        return dict(params=tv.cpu(), info=info, market=prices)

    def control(self, request, dtype=torch.bfloat16):
        """The fit with the reference in `dtype` in the program's place."""
        d = self.dep
        prices = torch.as_tensor(request["market"]).to(d.device, d.dtype)

        def jacobian(params):
            return self.ladder(params, dtype, jac=True)

        def prices_at(params):
            return self.ladder(params, dtype)

        tv, info = lm.fit(jacobian, prices_at, prices.to(dtype), self.init,
                          self.mix["lm"])
        return dict(params=tv.cpu(), info=info, market=prices)

    def expected_launches(self, request, out):
        it = out["info"]["iterations"]
        return {"kernel2": 0, "kernel1": it, "kernel1_fwd": it}

    # -- the reference ----------------------------------------------------

    def ladder(self, params, dtype=torch.float64, jac=False):
        """The reference's prices (and Jacobian) of the ladder at
        `params`, group by group."""
        d = self.dep
        ks = self.ks.to(dtype)
        fn = heston_ref.jacobian if jac else heston_ref.prices
        parts = [fn(d.ref_spec, ks[a:b], d.s0, params, d.r_d, d.r_f, d.dt, n)
                 for a, b, n in self.groups]
        if not jac:
            return torch.cat(parts)
        return (torch.cat([p for p, _ in parts]),
                torch.cat([j for _, j in parts]))

    def check(self, done):
        price, sse, step = [], [], []
        for request, out in done:
            p, s, st = self.gaps(out)
            price.append(p)
            sse.append(s)
            step.append(st)
        checks = []
        worst(checks, "fit_price_gap", price, self.limits["fit_price_gap"])
        worst(checks, "fit_sse_gap", sse, self.limits["fit_sse_gap"])
        worst(checks, "fit_step_gap", step, self.limits["fit_step_gap"])
        return checks

    def gaps(self, out):
        """(price gap, relative SSE gap, relative step gap) of one fit."""
        info = out["info"]
        dev, f64 = self.ks.device, torch.float64
        it = info["iterations"]
        hist = {k: v.to(f64).cpu() if v.is_floating_point() else v.cpu()
                for k, v in info["history"].items()}
        conv = bool(info["converged"])
        before = [torch.tensor(self.init, dtype=f64)] + list(hist["params"])
        # the parameters whose prices the fit returns: the iterate before
        # the last step when that step converged, else the last iterate
        at = before[it - 1] if conv else before[it]
        market = out["market"].to(f64)
        ref = self.ladder(tuple(at.tolist()))
        price_gap = float((info["fitted_prices"].to(f64) - ref).abs().max())
        ref_sse = float(((market - ref) ** 2).sum())
        sse_gap = abs(float(info["final_error"]) - ref_sse) / ref_sse
        # the first step taken: the first accepted or the converging one
        taken = [k for k in range(it) if bool(hist["accepted"][k])]
        if conv:
            taken.append(it - 1)
        if not taken:
            return price_gap, sse_gap, 0.0
        k = taken[0]
        start = before[k].to(dev)
        base, jac = self.ladder(tuple(start.tolist()), jac=True)
        delta = mkt.lm_update(jac, market - base,
                              float(hist["lam"][k]))
        hi, lo = (torch.tensor(c, dtype=f64, device=dev) for c in self.clamp)
        new_ref = mkt.clamp(start + delta, lo, hi)
        new_prog = before[k + 1].to(dev)
        step_gap = float(torch.linalg.norm(new_prog - new_ref)
                         / torch.linalg.norm(new_ref - start))
        return price_gap, sse_gap, step_gap

    def traced(self, request, out):
        """The frozen bound of the fit's forward-mode launches (one per
        iteration) and its iteration count."""
        d = self.dep
        lane = [n for a, b, n in self.groups for _ in range(b - a)]
        bound_ms = roofline.kernel_bound(
            lane, [0] * len(lane), d.spec.m1 + 1, d.spec.m2 + 1, 0,
            self.ks.element_size(), False, n_tangents=4, per_lane=True)[0]
        it = out["info"]["iterations"]
        return {"kernel1_fwd_bound_ms": bound_ms * it, "iterations": it}

"""Chain calibration with American exercise and discrete dividends: one
request fits the five Heston parameters to a multi-maturity chain of
American calls through `models.calibration.calibrate_device(...,
american=True, dividends=, group_steps=)` (the whole chain in one
forward-mode launch of kernel 1 and one primal launch per
Levenberg-Marquardt iteration) and ends when the fitted parameters are
on the host.

The mix gives the ladder and the LM settings as the fit traffic does
(`kinds/fit.py`, whose entry, check and control this kind keeps) and the
draw of the market's flat vol; the market is the float64 Black-Scholes
calls of the ladder on the spot escrowed for the configuration's
dividends (`reference/bs_market.py`), made before the request starts.
The reference prices and Jacobians the check and the control use carry
the American update and the dividends; the control is the reference in
float32, the precision below the configuration's float64.
"""

from __future__ import annotations

import torch

from perfbench.kinds import fit, risk
from perfbench.reference import bs_market, heston_ref


class Workload(fit.Workload):
    """The calibration traffic: its entry, its check and its control."""

    # the frozen float64 bound of one launch over the chain, as the risk
    # traffic counts a book's: the trial's primal (`n_tangents` 0) or the
    # Jacobian's forward mode with its four tangents
    _bound_ms = risk.Workload._bound_ms

    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        super().__init__(cfg, mix, device)
        self.dividends = self.dep.program_dividends()
        self.bound_ms = self._bound_ms()
        self.fwd_bound_ms = self._bound_ms(n_tangents=4)

    def prepare(self, fields) -> dict:
        """The request: its fields and the market's prices (float64,
        host)."""
        d = self.dep
        return dict(fields, market=bs_market.calls(
            d.s0, self.k_one, d.r_d, self.mats, fields["vol"],
            d.dividends))

    def call(self, request):
        from heston_tpu_torch.models import calibration

        d = self.dep
        prices = torch.as_tensor(request["market"]).to(d.device, d.dtype)
        tv, info = calibration.calibrate_device(
            d.spec, d.solver, self.ks, prices, d.s0,
            torch.tensor(self.init, dtype=d.dtype), d.r_d, d.r_f,
            cfg=self.cfg, american=True, dividends=self.dividends,
            group_steps=self.groups, device=d.device)
        return dict(params=tv.cpu(), info=info, market=prices)

    def control(self, request, dtype=torch.float32):
        """The fit with the reference in `dtype` in the program's place."""
        return super().control(request, dtype)

    def ladder(self, params, dtype=torch.float64, jac=False):
        """The reference's prices (and Jacobian) of the American chain
        with the dividends at `params`, group by group."""
        d = self.dep
        ks = self.ks.to(dtype)
        fn = heston_ref.jacobian if jac else heston_ref.prices
        parts = [fn(d.ref_spec, ks[a:b], d.s0, params, d.r_d, d.r_f, d.dt, n,
                    True, d.dividends) for a, b, n in self.groups]
        if not jac:
            return torch.cat(parts)
        return (torch.cat([p for p, _ in parts]),
                torch.cat([j for _, j in parts]))

    def traced(self, request, out):
        """The frozen bounds of the fit's primal and forward-mode launches
        (one of each per iteration) and its iteration count."""
        it = out["info"]["iterations"]
        return {"kernel1_bound_ms": self.bound_ms * it,
                "kernel1_fwd_bound_ms": self.fwd_bound_ms * it,
                "iterations": it}

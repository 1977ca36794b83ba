"""Book risk: one request reads the risk of a mixed-maturity book of
American calls with the configuration's dividends through
`models.greeks.batch_greeks(..., group_steps=, param_jacobian=True)`
(one book plan and one launch of kernel 1 for the surfaces, the stencil
and theta epilogue, the linearized assembly and one launch of kernel 1's
forward mode for the Jacobian) and ends when the seven risk columns and
the five parameter sensitivities of every option are on the host, as
one [B, 12] tensor (`COLUMNS`).

The mix gives the book as the book traffic does (strikes, groups' step
counts at the configuration's dt, the draws of the market state).
Correct: the columns of a sample of the books against the reference in
float64 (`reference/risk_ref.py`), group by group at the group's step
count and the book's dt, in blocks of strikes (`REFERENCE_BLOCK`): per
column the widest absolute gap over the book divided by the largest
absolute reference value of the column; `risk_gap` the largest of the
seven surface columns', `jac_gap` of the five sensitivities'.
"""

from __future__ import annotations

import torch

from perfbench import roofline, roofline_fp64
from perfbench.kinds.common import Deployment, market, worst
from perfbench.reference import risk_ref

# options a call of the reference (see kinds/book.py)
REFERENCE_BLOCK = 250
# the program's result keys, in the order of risk_ref's columns
COLUMNS = (*risk_ref.SURFACE_KEYS, "param_jacobian")


class Workload:
    """The risk traffic: its entry, its check and its control."""

    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        self.dep = d = Deployment(cfg, device)
        self.mix = mix
        self.limits = mix["limits"]
        lo, hi, n = mix["strikes"]
        k_one = torch.linspace(lo, hi, n, dtype=torch.float64)
        steps = mix["group_steps"]
        self.groups = tuple((i * n, (i + 1) * n, g)
                            for i, g in enumerate(steps))
        self.ks = k_one.repeat(len(steps)).to(device, d.dtype)
        self.dividends = d.program_dividends()
        self.bound_ms = self._bound_ms()
        self.fwd_bound_ms = self._bound_ms(n_tangents=4)

    def prepare(self, fields):
        return fields

    def call(self, fields):
        from heston_tpu_torch.models import greeks

        d = self.dep
        out = greeks.batch_greeks(
            d.spec, d.solver, self.ks, d.s0, *market(fields), d.r_d, d.r_f,
            american=True, dividends=self.dividends,
            group_steps=self.groups,
            param_jacobian=True, device=d.device)
        cols = [out[k] for k in COLUMNS[:-1]]
        return torch.cat([torch.stack(cols, 1), out[COLUMNS[-1]]], 1).cpu()

    def expected_launches(self, fields, out):
        # the surfaces' launch and the Jacobian's, no Rannacher start-up
        return {"kernel2": 0, "kernel1": 1, "kernel1_fwd": 1}

    def reference(self, fields, dtype=torch.float64):
        """The reference's [B, 12] of the book in `dtype`, on the card."""
        d = self.dep
        return risk_ref.book(d.ref_spec, self.ks.to(dtype), self.groups,
                             d.s0, market(fields), d.r_d, d.r_f, d.dt, True,
                             d.dividends, REFERENCE_BLOCK)

    def control(self, fields, dtype=torch.float32):
        """The reference in `dtype`, the precision below the
        configuration's float64, in the program's place."""
        return self.reference(fields, dtype).cpu()

    def check(self, done):
        risk, jac = [], []
        n_surface = len(risk_ref.SURFACE_KEYS)
        for fields, out in done:
            g = risk_ref.gaps(out, self.reference(fields).cpu())
            risk.append(g[:n_surface].max())
            jac.append(g[n_surface:].max())
        checks = []
        worst(checks, "risk_gap", risk, self.limits["risk_gap"])
        worst(checks, "jac_gap", jac, self.limits["jac_gap"])
        return checks

    def traced(self, fields, out):
        return {"kernel1_bound_ms": self.bound_ms,
                "kernel1_fwd_bound_ms": self.fwd_bound_ms}

    def _bound_ms(self, n_tangents=0):
        """The frozen bound of a book's launch of kernel 1 (the same for
        every book): the benchmark's operations and bytes of the surfaces'
        primal launch (`n_tangents` 0) or of the Jacobian's forward-mode
        launch with its four tangents, over the card's float64 peak and
        its HBM rate."""
        d = self.dep
        ev = roofline.dividend_steps(d.dividends, d.dt, d.solver.n_steps)
        lanes = [n for a, b, n in self.groups for _ in range(b - a)]
        _, _, flops, nbytes = roofline.kernel_bound(
            lanes, roofline.lane_events(ev, lanes), d.spec.m1 + 1,
            d.spec.m2 + 1, len(ev), self.ks.element_size(), True,
            n_tangents=n_tangents, per_lane=True)
        return roofline_fp64.bound_ms(flops, nbytes)

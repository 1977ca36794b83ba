"""Book revaluation: one request prices a mixed-maturity book of American
calls with the configuration's dividends through
`models.douglas.price_batch(..., group_steps=)` (one `fused_do.book_plan`
and one launch of kernel 1 a phase, each option stopping at its own step
count) and ends when the prices are on the host.

The mix gives the strikes (`linspace(lo, hi, n)`, the same in every
maturity group), the groups' step counts at the configuration's dt
(T_i = n_i dt) and the draws of the market state. Correct: the prices of
a sample of the books against the reference in float64, group by group
at the group's step count and the book's dt (`book_gap`, the widest
absolute gap). The reference inverts its implicit systems as dense
matrices, so it runs in blocks of strikes (`REFERENCE_BLOCK`) that the
card's memory holds.
"""

from __future__ import annotations

import torch

from perfbench import roofline, roofline_fp64
from perfbench.kinds.common import Deployment, market, worst
from perfbench.reference import heston_ref

# options a call of the reference: its dense inverses and band matrices
# take ~3 MB an option in float64
REFERENCE_BLOCK = 250


class Workload:
    """The book traffic: its entry, its check and its control."""

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

    def prepare(self, fields):
        return fields

    def call(self, fields):
        from heston_tpu_torch.models import douglas

        d = self.dep
        out = douglas.price_batch(
            d.spec, d.solver, self.ks, d.s0, *market(fields), d.r_d, d.r_f,
            american=True, dividends=self.dividends, device=d.device,
            group_steps=self.groups)
        return out.cpu()

    def expected_launches(self, fields, out):
        # one launch a phase: the configuration has no Rannacher start-up
        return {"kernel2": 0, "kernel1": 1, "kernel1_fwd": 0}

    def reference(self, fields, dtype=torch.float64):
        """The reference's prices of the book in `dtype`, on the card."""
        d = self.dep
        ks = self.ks.to(dtype)
        return torch.cat([
            heston_ref.prices(d.ref_spec, ks[i:min(i + REFERENCE_BLOCK, b)],
                              d.s0, market(fields), d.r_d, d.r_f, d.dt, n,
                              True, d.dividends)
            for a, b, n in self.groups
            for i in range(a, b, REFERENCE_BLOCK)])

    def control(self, fields, dtype=torch.float32):
        """The reference in `dtype`, the precision below the
        configuration's float64, in the program's place."""
        return self.reference(fields, dtype).cpu()

    def check(self, done):
        gaps = [(out.double() - self.reference(fields).cpu()).abs().max()
                for fields, out in done]
        checks = []
        worst(checks, "book_gap", gaps, self.limits["book_gap"])
        return checks

    def traced(self, fields, out):
        return {"kernel1_bound_ms": self.bound_ms}

    def _bound_ms(self):
        """The frozen bound of a book's launch of kernel 1 (the same for
        every book): the benchmark's operations and bytes of the launch
        over the card's float64 peak and its HBM rate."""
        d = self.dep
        ev = roofline.dividend_steps(d.dividends, d.dt, d.solver.n_steps)
        lanes = [n for a, b, n in self.groups for _ in range(b - a)]
        _, _, flops, nbytes = roofline.kernel_bound(
            lanes, roofline.lane_events(ev, lanes), d.spec.m1 + 1,
            d.spec.m2 + 1, len(ev), self.ks.element_size(), True,
            per_lane=True)
        return roofline_fp64.bound_ms(flops, nbytes)

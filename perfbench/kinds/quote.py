"""Single-option quotes: one request prices one option through
`models.douglas.price_batch` with one strike (the single-option route:
`fused_single.single_plan` and one launch of kernel 2) and ends when the
price is on the host.

The mix cycles the strike lattice and the products (`european`,
`european_dividends` and `american_dividends`: European or American with
the configuration's dividends) and draws the market state. Correct: the
prices of a sample of the quotes against the reference in float64
(`quote_gap`, the widest gap).
"""

from __future__ import annotations

import torch

from perfbench import roofline
from perfbench.kinds.common import Deployment, market, worst
from perfbench.reference import heston_ref

PRODUCTS = {"european": (False, False), "european_dividends": (False, True),
            "american_dividends": (True, True)}


class Workload:
    """The quote traffic: its entry, its check and its control."""

    def __init__(self, cfg: dict, mix: dict, device: torch.device):
        self.dep = Deployment(cfg, device)
        self.mix = mix
        self.limits = mix["limits"]

    def product(self, fields):
        """(american, dividends) of the request's product."""
        american, div = PRODUCTS[fields["product"]]
        return american, self.dep.dividends if div else ()

    def prepare(self, fields):
        return fields

    def call(self, fields):
        from heston_tpu_torch.models import douglas

        d = self.dep
        american, div = self.product(fields)
        strike = torch.tensor([fields["strike"]], dtype=d.dtype,
                              device=d.device)
        out = douglas.price_batch(
            d.spec, d.solver, strike, d.s0, *market(fields), d.r_d, d.r_f,
            american=american,
            dividends=d.program_dividends() if div else None,
            device=d.device)
        return out.cpu()

    def expected_launches(self, fields, out):
        return {"kernel2": 1, "kernel1": 0, "kernel1_fwd": 0}

    def reference(self, fields, dtype=torch.float64):
        d = self.dep
        american, div = self.product(fields)
        strike = torch.tensor([fields["strike"]], dtype=d.dtype,
                              device=d.device).to(dtype)
        return heston_ref.prices(d.ref_spec, strike, d.s0, market(fields),
                                 d.r_d, d.r_f, d.dt, d.solver.n_steps,
                                 american, div)

    def control(self, fields, dtype=torch.bfloat16):
        """The reference in `dtype` in the program's place."""
        return self.reference(fields, dtype).float().cpu()

    def check(self, done):
        gaps = [(out.double() - self.reference(fields).cpu()).abs().max()
                for fields, out in done]
        checks = []
        worst(checks, "quote_gap", gaps, self.limits["quote_gap"])
        return checks

    def traced(self, fields, out):
        """The frozen throughput bound of the request's launch of kernel
        2."""
        d = self.dep
        american, div = self.product(fields)
        n = d.solver.n_steps
        ev = roofline.dividend_steps(div, d.dt, n)
        bound_ms = roofline.kernel_bound(
            [n], [len(ev)], d.spec.m1 + 1, d.spec.m2 + 1, len(ev),
            torch.tensor([], dtype=d.dtype).element_size(), american)[0]
        return {"kernel2_bound_ms": bound_ms}

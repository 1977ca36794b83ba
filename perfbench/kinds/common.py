"""What the kinds of traffic share: the deployment's grid, scheme and
market from its configuration file, the program's objects built from
them, the market state of a request and the comparisons that decide
`correct`."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from perfbench.reference import heston_ref

PARAMS = ("kappa", "eta", "sigma", "rho", "v0")
DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Check(NamedTuple):
    """One number compared, with its limit: correct when value <= limit
    (a value that is not finite is never correct)."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def worst(checks, name: str, values, limit: float) -> None:
    """Append the largest of `values` under `name` (nan if any is not
    finite)."""
    values = [float(v) for v in values]
    value = (max(values) if all(math.isfinite(v) for v in values)
             else math.nan)
    checks.append(Check(name, value, limit))


class Deployment:
    """A configuration file's deployment, for the program and for the
    reference."""

    def __init__(self, cfg: dict, device: torch.device):
        from heston_tpu_torch import GridSpec, SolverConfig

        g, s, m = cfg["grid"], cfg["scheme"], cfg["market"]
        self.device = device
        self.dtype = DTYPES[cfg["precision"]]
        self.spec = GridSpec(m1=g["m1"], m2=g["m2"],
                             s_max_mult=g["s_max_mult"], c_mult=g["c_mult"],
                             v_max=g["v_max"], d_div=g["d_div"])
        self.solver = SolverConfig(
            n_steps=s["n_steps"], theta=s["theta"], maturity=s["maturity"],
            a2_variant=s["a2_variant"], scheme={"douglas": "do"}[s["name"]],
            solver_engine="pallas")
        self.ref_spec = heston_ref.Spec.from_config(cfg)
        self.s0, self.r_d, self.r_f = m["s0"], m["r_d"], m["r_f"]
        self.dt = s["maturity"] / s["n_steps"]
        self.dividends = tuple(tuple(d) for d in cfg["dividends"])

    def program_dividends(self):
        from heston_tpu_torch import DividendSchedule

        dates, amounts, pcts = zip(*self.dividends)
        return DividendSchedule(dates=dates, amounts=amounts,
                                percentages=pcts)


def market(fields: dict) -> tuple:
    """The request's (kappa, eta, sigma, rho, v0)."""
    return tuple(fields[k] for k in PARAMS)

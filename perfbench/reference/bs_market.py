"""Market data of the calibration traffic in plain float64 torch: the
Black-Scholes price of European calls on a spot escrowed for its discrete
dividends, as the upstream makes the market its calibrations fit
(src/bs.hpp:78-114). It imports nothing of the program.

Each dividend (date, amount, proportion) paid before a call's maturity
takes its cash amount and its proportion of the spot today out of the
spot, discounted from its date at the domestic rate: S* = S0 - sum over
dates < T of (amount + proportion S0) e^{-r date}. The call is then the
Black-Scholes call on S* at the flat vol, N written with erfc.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

Dividends = Sequence[Tuple[float, float, float]]   # (date, amount, pct)


def escrowed_spot(s0: float, t: float, r: float,
                  dividends: Dividends) -> float:
    """S0 less the present value of the dividends paid before t."""
    pv = sum((amount + pct * s0) * math.exp(-r * date)
             for date, amount, pct in dividends if date < t)
    return s0 - pv


def calls(s0: float, strikes, r: float, maturities, vol: float,
          dividends: Dividends = ()) -> torch.Tensor:
    """Float64 call prices [len(maturities) * len(strikes)], maturity by
    maturity, each strike at each maturity."""
    k = torch.as_tensor(strikes, dtype=torch.float64)
    out = []
    for t in maturities:
        s = escrowed_spot(s0, t, r, dividends)
        sd = vol * math.sqrt(t)
        d1 = (torch.log(s / k) + (r + 0.5 * vol * vol) * t) / sd
        d2 = d1 - sd
        n1 = 0.5 * torch.special.erfc(-d1 / math.sqrt(2.0))
        n2 = 0.5 * torch.special.erfc(-d2 / math.sqrt(2.0))
        out.append(s * n1 - k * math.exp(-r * t) * n2)
    return torch.cat(out)

"""Finite-difference stencil weights on non-uniform grids.

PyTorch counterpart of `heston_tpu.ops.coeff` (ref: src/coeff.cpp:7-100).
Each helper takes the two spacings the reference function reads and
returns the 3 stencil weights, elementwise over tensors of any shape.

  delta — central 2nd derivative            (positions -1, 0, +1)
  beta  — central 1st derivative            (positions -1, 0, +1)
  alpha — backward (upwind) 1st derivative  (positions -2, -1, 0)
  gamma — forward one-sided 1st derivative  (positions 0, +1, +2)
"""

from __future__ import annotations

from typing import Tuple

import torch

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def w_delta(h0, h1) -> Triple:
    """Central 2nd-derivative weights (positions -1, 0, +1)."""
    s = h0 + h1
    return (2.0 / (h0 * s), -2.0 / (h0 * h1), 2.0 / (h1 * s))


def w_beta(h0, h1) -> Triple:
    """Central 1st-derivative weights (positions -1, 0, +1)."""
    s = h0 + h1
    return (-h1 / (h0 * s), (h1 - h0) / (h0 * h1), h0 / (h1 * s))


def w_alpha(hm, h0) -> Triple:
    """Backward upwind 1st-derivative weights (positions -2, -1, 0)."""
    s = hm + h0
    return (h0 / (hm * s), (-hm - h0) / (hm * h0), (hm + 2.0 * h0) / (h0 * s))


def w_gamma(h1, h2) -> Triple:
    """Forward one-sided 1st-derivative weights (positions 0, +1, +2)."""
    s = h1 + h2
    return ((-2.0 * h1 - h2) / (h1 * s), s / (h1 * h2), -h1 / (h2 * s))

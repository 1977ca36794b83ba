"""heston_tpu_torch — Heston PDE pricing in PyTorch with hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of the JAX package `heston_tpu`, which stays the reference. The
configuration dataclasses are shared with it, not copied:
`heston_tpu.config` imports no JAX. Layout mirrors the JAX package:
`ops/` (grids, stencils, operator bands), `kernels/` (host side, wrapper
and plain version of each GPU kernel; CUDA sources in `csrc/`), `models/`
(pricing entry points) and `convert.py` (inputs carried across from JAX).

Ported so far: batched Douglas pricing of vanilla calls, European or
American, with or without discrete dividends, at flat rates
(`price_batch` with `solver_engine="pallas"`). The rest raises
NotImplementedError naming its ROADMAP item.
"""

from heston_tpu.config import (
    GOLDEN_DIVIDENDS,
    DividendSchedule,
    GridSpec,
    HestonParams,
    SolverConfig,
)
from heston_tpu_torch.models.douglas import price_batch, price_batch_params

__all__ = [
    "HestonParams",
    "GridSpec",
    "SolverConfig",
    "DividendSchedule",
    "GOLDEN_DIVIDENDS",
    "price_batch",
    "price_batch_params",
]

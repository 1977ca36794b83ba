"""Douglas (DO) ADI pricing of option books (PyTorch).

Counterpart of the batched entry points of `heston_tpu.models.douglas`.
`solver_engine="pallas"` — the engine that reaches the hand-written time
loop kernel in the JAX package — runs `kernels.fused_do`: its CUDA kernel
for CUDA tensors, its plain version for CPU tensors. The other engines,
schemes and products are not ported yet and raise NotImplementedError
naming their ROADMAP item; nothing falls back to another path.
"""

from __future__ import annotations

from typing import Optional

import torch

from heston_tpu.config import (DividendSchedule, GridSpec, HestonParams,
                               SolverConfig)
from heston_tpu_torch.kernels import fused_do


def price_batch(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa,
    eta,
    sigma,
    rho,
    v0,
    r_d,
    r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    rate_schedule=None,
) -> torch.Tensor:
    """Prices [B] of a book of options at `strikes` [B], one shared spot,
    model and schedule. Device and dtype come from `strikes`.

    A batch of one goes through the same batched kernel (the JAX package
    sends it to its single-option kernel, which is not ported yet —
    ROADMAP A11)."""
    if solver.solver_engine != "pallas":
        raise NotImplementedError(
            f"solver_engine {solver.solver_engine!r} is not ported yet; "
            f"only 'pallas', the fused time-loop kernel (ROADMAP A4, A5)")
    return fused_do.fused_price_batch(
        spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american=american, dividends=dividends, option_type=option_type,
        rate_schedule=rate_schedule)


def price_batch_params(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    params: HestonParams,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    rate_schedule=None,
) -> torch.Tensor:
    """price_batch taking a HestonParams dataclass."""
    return price_batch(
        spec, solver, strikes, s0, params.kappa, params.eta, params.sigma,
        params.rho, params.v0, params.r_d, params.r_f,
        american=american, dividends=dividends, option_type=option_type,
        rate_schedule=rate_schedule)

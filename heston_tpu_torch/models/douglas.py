"""ADI pricing of option books (PyTorch).

Counterpart of the batched entry points of `heston_tpu.models.douglas`.
`solver_engine="pallas"` — the engine that reaches the hand-written time
loop kernels in the JAX package — runs `kernels.fused_single` for a batch
of one and `kernels.fused_do` for every other book, under any of the four
schemes of `SolverConfig.scheme` ("do", "cs", "mcs", "hv"; an unknown one
raises ValueError), for calls, puts and cash-or-nothing digitals
(`option_type`), with or without a knock-out barrier on the spec
(`price_knock_in` prices the knock-in by in–out parity), at flat rates or
on a piecewise-constant curve (`rate_schedule`: one launch of the batched
kernel per rate segment piece). The entry points run on the card unless the caller
passes `device="cpu"`, which runs the plain PyTorch version of the kernel
instead; without a card and without `device="cpu"` they raise. The other
engines and products are not ported yet and raise NotImplementedError
naming their ROADMAP item; nothing falls back to another path or scheme.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from heston_tpu_torch.config import (DividendSchedule, GridSpec, HestonParams,
                               SolverConfig)
from heston_tpu_torch.kernels import fused_do, fused_single
from heston_tpu_torch.ops import grid as gridmod


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: the card (cuda) unless the caller
    names another. Raises when the card is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "heston_tpu_torch runs on the card by default, and "
            "torch.cuda.is_available() is False: pass device='cpu' to run "
            "the plain PyTorch versions of the kernels on the CPU")
    return dev


def as_strikes(strikes, device: torch.device) -> torch.Tensor:
    """Strikes as a float tensor on `device` (float tensors keep their
    dtype; anything else becomes torch's default float dtype)."""
    strikes = torch.as_tensor(strikes)
    if not strikes.is_floating_point():
        strikes = strikes.to(torch.get_default_dtype())
    return strikes.to(device)


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
    device=None,
) -> torch.Tensor:
    """Prices [B] of a book of options at `strikes` [B], one shared spot,
    model and schedule. The strikes go to `device` (None: the card; "cpu"
    runs the plain version of the kernel); the dtype is the strikes'.

    Dispatch as in the JAX package (heston_tpu/models/douglas.py:
    868-887): a batch of one at flat rates whose grid fits the latency
    kernel (`fused_single.use_single`) goes through
    `fused_single.fused_price_single`, every other book, a curve book of
    one (`rate_schedule`) included, through the batched
    `fused_do.fused_price_batch`. A kernel that fails to build or
    launch raises; nothing falls back to the other route. A barrier book
    is validated first (`grid.validate_book`, heston_tpu/models/douglas.py:
    693-709, :935): a knocked-out spot or one the grid cannot hold raises
    ValueError before anything launches."""
    if solver.solver_engine != "pallas":
        raise NotImplementedError(
            f"solver_engine {solver.solver_engine!r} is not ported yet; "
            f"only 'pallas', the fused time-loop kernel (ROADMAP A6)")
    strikes = as_strikes(strikes, resolve_device(device))
    if spec.barrier is not None:
        gridmod.validate_book(spec, float(s0), strikes)
    if rate_schedule is None and fused_single.use_single(
            spec, solver, strikes.shape[0]):
        return fused_single.fused_price_single(
            spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d,
            r_f, american=american, dividends=dividends,
            option_type=option_type)
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
    device=None,
) -> torch.Tensor:
    """price_batch taking a HestonParams dataclass."""
    return price_batch(
        spec, solver, strikes, s0, params.kappa, params.eta, params.sigma,
        params.rho, params.v0, params.r_d, params.r_f,
        american=american, dividends=dividends, option_type=option_type,
        rate_schedule=rate_schedule, device=device)


def price_knock_in(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    device=None,
) -> torch.Tensor:
    """European knock-in prices [B] by in–out parity, vanilla − knock-out
    (heston_tpu/models/douglas.py:942-985): exact path by path under
    continuous monitoring, discrete dividends included. spec.barrier
    names the trigger by its "-out" kind (an up-and-in call passes
    Barrier("up-out", level)). European only: early exercise breaks the
    parity. The two legs run on their own grids, so a few per mille of
    discretization mismatch at coarse grids is inherent."""
    if spec.barrier is None:
        raise ValueError(
            "price_knock_in needs spec.barrier (the knock trigger)")
    args = (solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f)
    kw = dict(dividends=dividends, option_type=option_type, device=device)
    vanilla = price_batch(dataclasses.replace(spec, barrier=None), *args,
                          **kw)
    return vanilla - price_batch(spec, *args, **kw)

"""Levenberg–Marquardt calibration of the 5 Heston parameters (PyTorch).

Counterpart of the on-device loop of `heston_tpu.models.calibration`
(ref: src/jacobian_computation.cpp, src/heston_calibration.cpp).
`calibrate_device` fits (kappa, eta, sigma, rho, v0) to a chain of
quotes. Each iteration takes one Jacobian pass — with
`jacobian_mode="ad"`, one launch of the forward-mode time-loop kernel
(`kernels.fused_do.fused_theta_jacobian`) for the whole chain, every
maturity group included (per-option step counts); with "fd", six pricing
launches of bumped parameters — then a damped 5x5 solve of the normal
equations, the clamps, and one trial pricing launch, all on tensors on
the device. The Jacobian and the trial prices come from the same time
loop, under `solver.scheme` (heston_tpu/models/calibration.py:584-591).

The JAX package runs the whole loop as one `lax.while_loop` on the chip.
Here it is a Python loop over device tensors: the only value that leaves
the card per iteration is the stop flag (converged, read once); the
iteration count lives on the host. Capturing an iteration in a CUDA
graph is later work.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from heston_tpu_torch.config import (CalibrationConfig, DividendSchedule,
                                     GridSpec, SolverConfig)
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import bs, douglas
from heston_tpu_torch.ops import operators

N_PARAMS = 5  # (kappa, eta, sigma, rho, v0)


@dataclasses.dataclass(frozen=True)
class CalibrationTargets:
    """Market data to fit: one entry per (strike, maturity) point."""

    strikes: np.ndarray          # (n_points,)
    maturities: np.ndarray       # (n_points,)
    prices: np.ndarray           # (n_points,)
    s0: float
    r_d: float
    r_f: float = 0.0
    american: bool = False
    dividends: Optional[DividendSchedule] = None
    option_type: str = "call"
    # optional per-point least-squares weights w_i >= 0: the objective
    # becomes sum_i w_i r_i^2 (None = the reference's unweighted one);
    # see `vega_weights`
    weights: Optional[np.ndarray] = None

    def groups(self) -> List[Tuple[float, np.ndarray]]:
        """(maturity, point-index array) per distinct maturity, in order."""
        return [(t, np.nonzero(self.maturities == t)[0])
                for t in sorted(set(self.maturities.tolist()))]


def lm_update(jac: torch.Tensor, residual: torch.Tensor, lam,
              weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Damped normal-equations step: solve (JtWJ * (1+lam on diag)) d = JtWr
    (ref: src/jacobian_computation.cpp:107-195). A singular system gives
    non-finite steps instead of an error, as in the JAX package."""
    wjac = jac if weights is None else jac * weights[:, None]
    jtj = wjac.T @ jac
    jtj = jtj * (1.0 + lam * torch.eye(N_PARAMS, dtype=jac.dtype,
                                       device=jac.device))
    return torch.linalg.solve_ex(jtj, (wjac.T @ residual)[:, None])[0][:, 0]


def clamp_params(vec: np.ndarray, cfg: CalibrationConfig) -> np.ndarray:
    """Parameter clamps (ref: src/heston_calibration.cpp:286-290)."""
    return np.array([
        max(cfg.kappa_min, vec[0]),
        max(cfg.eta_min, vec[1]),
        max(cfg.sigma_min, vec[2]),
        min(cfg.rho_max, max(cfg.rho_min, vec[3])),
        max(cfg.v0_min, vec[4]),
    ])


def clamp_params_tensor(vec: torch.Tensor,
                        cfg: CalibrationConfig) -> torch.Tensor:
    """The clamps on a parameter tensor, without leaving the device."""
    lo = torch.tensor([cfg.kappa_min, cfg.eta_min, cfg.sigma_min,
                       cfg.rho_min, cfg.v0_min], dtype=vec.dtype,
                      device=vec.device)
    hi = torch.tensor([np.inf, np.inf, np.inf, cfg.rho_max, np.inf],
                      dtype=vec.dtype, device=vec.device)
    return torch.minimum(torch.maximum(vec, lo), hi)


def validate_group_steps(group_steps, n: int, n_steps=None) -> None:
    """Check that (start, end, n_steps) maturity-group slices tile [0, n)
    contiguously in order; n_steps (optional): the launch step count must
    equal the largest group's."""
    if not group_steps:
        return
    prev = 0
    for a, e, g in group_steps:
        if a != prev or e <= a or g < 1:
            raise ValueError(
                f"group_steps must tile [0, {n}) contiguously in order "
                f"(start==previous end, end>start, n_steps>=1); got "
                f"{tuple(group_steps)}")
        prev = e
    if prev != n:
        raise ValueError(
            f"group_steps cover [0, {prev}) but the book has {n} options")
    if n_steps is not None and n_steps != max(g for _, _, g in group_steps):
        raise ValueError("solver.n_steps must be max(group n_steps)")


def lane_steps(group_steps) -> Optional[torch.Tensor]:
    """Per-option step counts [B] of (start, end, n_steps) groups, the
    `n_steps_per` of one launch for the whole book; None for no groups."""
    if not group_steps:
        return None
    return torch.cat([torch.full((e - a,), n) for a, e, n in group_steps])


def vega_weights(targets: CalibrationTargets,
                 floor_frac: float = 0.05) -> np.ndarray:
    """Market-standard 1/vega^2 calibration weights: to first order
    r_i = vega_i * (iv_model - iv_market), so the weighted price objective
    is the sum of squared implied-vol errors. Vega at each point's market
    implied vol (escrowed-dividend spot; puts through parity), floored at
    (floor_frac * max vega)^-2 and normalized to mean 1. float64 on the
    CPU."""
    if operators.is_digital(targets.option_type):
        raise ValueError(
            "vega_weights is vanilla-only (BS vega/implied-vol have no "
            "meaning for cash-or-nothing digital quotes); use explicit "
            "weights for digital chains")
    ks = torch.as_tensor(np.asarray(targets.strikes, np.float64))
    ts = np.asarray(targets.maturities, np.float64)
    ps = torch.as_tensor(np.asarray(targets.prices, np.float64))
    s_adj = np.full(len(ts), float(targets.s0))
    if targets.dividends is not None:
        d = targets.dividends
        s_adj = np.array([bs.escrowed_spot(targets.s0, t, targets.r_d,
                                           d.dates, d.amounts,
                                           d.percentages) for t in ts])
    s_adj = torch.as_tensor(s_adj)
    t_all = torch.as_tensor(ts)
    p_call = ps
    if targets.option_type == "put":
        p_call = bs.put_to_call_parity(ps, s_adj, ks, targets.r_d, t_all)
    iv = bs.implied_vol(p_call, s_adj, ks, targets.r_d, t_all)
    vegas = bs.call_vega(s_adj, ks, targets.r_d,
                         torch.clamp(iv, min=1e-4), t_all).numpy()
    floor = floor_frac * float(np.max(vegas))
    w = 1.0 / np.maximum(vegas, floor) ** 2
    return w / w.mean()


def _group_solver(solver: SolverConfig, n: int) -> SolverConfig:
    """The solver of a maturity group priced with n steps at the shared
    dt (T_i = n_i * dt)."""
    return dataclasses.replace(
        solver, n_steps=n, maturity=solver.maturity * n
        / max(solver.n_steps, 1))


def jacobian_and_prices_ad(spec: GridSpec, solver: SolverConfig, strikes,
                           s0, theta_vec, r_d, r_f, eps: float = 0.0,
                           american: bool = False, dividends=None,
                           option_type: str = "call",
                           v0_mode: str = "stencil", rate_schedule=None,
                           device=None):
    """(J [B, 5], base prices [B]) by exact forward-mode AD through the
    forward-mode time-loop kernel (one launch per phase): the fused branch
    of the JAX package's jacobian_and_prices_ad (heston_tpu/models/
    calibration.py:165-201). `eps` is ignored (the FD signature).
    v0_mode: "stencil" (the v0 column off the surface v-stencil) or "ad"
    (all five directions through the kernel, the v0 one the grid motion;
    `fused_do.fused_theta_jacobian`). A curve book (`rate_schedule`)
    takes the JAX package's XLA linearize path, not the fused kernel, and
    raises NotImplementedError (ROADMAP A6). The device defaults to the
    card (`douglas.resolve_device`)."""
    if solver.solver_engine != "pallas":
        raise NotImplementedError(
            f"the AD Jacobian through solver_engine "
            f"{solver.solver_engine!r} is not ported yet; only 'pallas', "
            f"the fused time-loop kernel (ROADMAP A6)")
    if rate_schedule is not None:
        raise NotImplementedError(
            "the AD Jacobian of a curve book runs the XLA linearize path of "
            "the eager pricer, which is not ported yet (ROADMAP A6)")
    dev = douglas.resolve_device(device)
    strikes = douglas.as_strikes(strikes, dev)
    base, jac = fused_do.fused_theta_jacobian(
        spec, solver, strikes, s0, theta_vec, r_d, r_f, american=american,
        dividends=dividends, option_type=option_type, v0_mode=v0_mode)
    return jac, base


def calibrate_device(
    spec: GridSpec,
    solver: SolverConfig,
    strikes,
    market_prices,
    s0,
    init_vec,
    r_d,
    r_f,
    cfg: CalibrationConfig = CalibrationConfig(),
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    group_steps: Tuple[Tuple[int, int, int], ...] = (),
    pricer: str = "pde",
    option_type: str = "call",
    weights=None,
    device=None,
):
    """Levenberg–Marquardt on the device: the counterpart of the JAX
    package's `calibrate_device` with `solver_engine="pallas"` (the
    reference's loop, ref: src/heston_calibration.cpp:206-417).

    Each iteration: the Jacobian and base prices of the whole chain
    (cfg.jacobian_mode "ad": one forward-mode kernel launch; "fd": six
    bumped pricing passes), the damped 5x5 solve of the normal equations,
    the clamps, one trial pricing pass, and the accept/reject update of
    the parameters and the damping. The loop is Python over device
    tensors; the only host read per iteration is the stop flag (see the
    module docstring).

    `group_steps`: optional (start, end, n_steps) slices of a
    multi-maturity chain, each priced with its own step count at the
    shared dt. More than one group takes the JAX package's one-launch
    branch (heston_tpu/models/calibration.py:548-578, :658-668): the
    whole chain in one launch per pass, each option stopping at its
    group's count (per-option step counts). `weights` (optional
    [n_points]): least-squares weights of the objective, normal equations
    and accept/reject test. Inputs go to `device` (None: the card; "cpu"
    runs the plain version of the kernels); the dtype is the strikes'
    (at least float32).

    Returns (theta_vec [5], info) with info's keys as in the JAX package:
    final_error, iterations, converged, lam, fitted_prices and history
    (error, lam, accepted, params rows in [cfg.max_iter] arrays; rows past
    `iterations` are NaN)."""
    if pricer == "cf":
        raise NotImplementedError(
            "pricer='cf' (the characteristic-function pricer) is not ported "
            "yet (ROADMAP A7)")
    if pricer != "pde":
        raise ValueError(f"unknown pricer: {pricer!r}")
    if solver.solver_engine != "pallas":
        raise NotImplementedError(
            f"solver_engine {solver.solver_engine!r} is not ported yet; "
            f"only 'pallas', the fused time-loop kernel (ROADMAP A6)")
    if cfg.jacobian_mode not in ("ad", "fd"):
        raise ValueError(f"unknown jacobian_mode: {cfg.jacobian_mode!r}")
    dev = douglas.resolve_device(device)
    strikes = douglas.as_strikes(strikes, dev)
    dtype = torch.promote_types(strikes.dtype, torch.float32)
    strikes = strikes.to(dtype)
    market = torch.as_tensor(market_prices, device=dev).to(dtype)
    wvec = None if weights is None else torch.as_tensor(
        weights, device=dev).to(dtype)
    if wvec is not None and wvec.shape != market.shape:
        raise ValueError(
            f"weights shape {tuple(wvec.shape)} != market shape "
            f"{tuple(market.shape)}")
    n_points = int(strikes.shape[0])
    validate_group_steps(group_steps, n_points)
    groups = group_steps or ((0, n_points, solver.n_steps),)
    r_d, r_f = float(r_d), float(r_f)
    # the chain's solver at the largest group's count, and each option's
    # own count when there is more than one group
    sol = _group_solver(solver, max(n for _, _, n in groups))
    kw = dict(american=american, dividends=dividends,
              option_type=option_type,
              n_steps_per=lane_steps(groups) if len(groups) > 1 else None)

    def fleet_prices(tv):
        return fused_do.fused_price_batch(
            spec, sol, strikes, s0, tv[0], tv[1], tv[2], tv[3], tv[4], r_d,
            r_f, **kw)

    def fleet_jacobian(tv):
        if cfg.jacobian_mode == "ad":
            base, jac = fused_do.fused_theta_jacobian(
                spec, sol, strikes, s0, tv, r_d, r_f, **kw)
            return jac, base
        # finite differences: base + one bump per parameter, each a full
        # pricing pass (ref: src/jacobian_computation.cpp:292-361)
        bump = torch.cat([torch.zeros(1, N_PARAMS, dtype=dtype, device=dev),
                          cfg.eps * torch.eye(N_PARAMS, dtype=dtype,
                                              device=dev)])
        pmat = tv[None, :] + bump
        prices = torch.stack([fleet_prices(pmat[i])
                              for i in range(N_PARAMS + 1)])
        base = prices[0]
        return ((prices[1:] - base[None, :]) / cfg.eps).T, base

    def sse(resid):
        return resid @ (resid if wvec is None else wvec * resid)

    tv = torch.as_tensor(init_vec, device=dev).to(dtype)
    lam = torch.tensor(cfg.lambda_init, dtype=dtype, device=dev)
    err = torch.tensor(float("inf"), dtype=dtype, device=dev)
    converged = torch.tensor(False, device=dev)
    fitted = torch.zeros_like(market)
    nan = float("nan")
    hist = dict(
        error=torch.full((cfg.max_iter,), nan, dtype=dtype, device=dev),
        lam=torch.full((cfg.max_iter,), nan, dtype=dtype, device=dev),
        accepted=torch.zeros((cfg.max_iter,), dtype=torch.bool, device=dev),
        params=torch.full((cfg.max_iter, N_PARAMS), nan, dtype=dtype,
                          device=dev),
    )
    it = 0
    while it < cfg.max_iter:
        jac, base = fleet_jacobian(tv)
        resid = market - base
        current_error = sse(resid)
        delta = lm_update(jac, resid, lam, wvec)
        new_vec = clamp_params_tensor(tv + delta, cfg)
        conv_now = ((torch.linalg.norm(delta) < cfg.tol)
                    | (current_error < cfg.tol))
        trial = fleet_prices(new_vec)
        new_error = sse(market - trial)
        accept = new_error < current_error

        hist["error"][it] = current_error
        hist["lam"][it] = lam
        hist["accepted"][it] = accept & ~conv_now
        tv = torch.where(conv_now | accept, new_vec, tv)
        hist["params"][it] = tv
        lam_next = torch.where(
            accept, torch.clamp(lam * cfg.lambda_down, min=cfg.lambda_min),
            torch.clamp(lam * cfg.lambda_up, max=cfg.lambda_max))
        lam = torch.where(conv_now, lam, lam_next)
        err = torch.where(conv_now, current_error,
                          torch.minimum(new_error, current_error))
        fitted = torch.where(conv_now | ~accept, base, trial)
        converged = converged | conv_now
        it += 1
        if bool(converged):      # the one host read of the iteration
            break
    return tv, dict(final_error=err, iterations=it, converged=converged,
                    lam=lam, fitted_prices=fitted, history=hist)

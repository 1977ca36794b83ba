"""Levenberg–Marquardt calibration of the 5 Heston parameters (PyTorch).

Counterpart of `heston_tpu.models.calibration` (ref:
src/jacobian_computation.cpp, src/heston_calibration.cpp). Two loops
fit (kappa, eta, sigma, rho, v0) to a chain of quotes:

* `calibrate_device`, the JAX package's on-device loop: each iteration
  one Jacobian pass — under "pallas" with `jacobian_mode="ad"` one launch
  of the forward-mode time-loop kernel (`kernels.fused_do.
  fused_theta_jacobian`) for the whole chain, every maturity group
  included (per-option step counts); under "scan" or "pcr" the eager
  loop linearized per group; with "fd", six pricing passes of bumped
  parameters — then a damped 5x5 solve of the normal equations, the
  clamps and one trial pricing pass, on tensors on the device. The
  Jacobian and the trial prices come from the same time loop, under
  `solver.scheme` (heston_tpu/models/calibration.py:584-591). The JAX
  package runs it as one `lax.while_loop` on the chip; here it is a
  Python loop over device tensors whose only host read per iteration is
  the stop flag. Spans: `heston.calibrate_device` holds one
  `heston.lm_iteration` an iteration; counters `calibrate_device.calls`,
  `.iterations` and `.host_reads`.
* `calibrate`, the host LM loop (`lm_host_loop`): per maturity group a
  Jacobian pass (`jacobian_and_prices_ad` or the FD `jacobian_and_prices`)
  and trial prices from the eager loop (`base_prices`), as the JAX
  package computes them, the accept/reject loop in numpy on the host,
  and optional checkpoints (`utils.checkpoint`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from heston_tpu_torch.config import (CalibrationConfig, DividendSchedule,
                                     GridSpec, HestonParams, SolverConfig)
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import bs, douglas, heston_cf
from heston_tpu_torch.models.douglas import lane_steps, validate_group_steps
from heston_tpu_torch.ops import operators
from heston_tpu_torch.utils.checkpoint import LMState, problem_key
from heston_tpu_torch.utils.profiling import scope

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


def _bumped_param_matrix(theta_vec: torch.Tensor, eps: float) -> torch.Tensor:
    """Rows [base, kappa+eps, eta+eps, sigma+eps, rho+eps, v0+eps], the
    reference Jacobian's column order (ref: src/jacobian_computation.cpp:
    292-361; heston_tpu/models/calibration.py:96-106)."""
    bump = torch.cat([
        torch.zeros(1, N_PARAMS, dtype=theta_vec.dtype,
                    device=theta_vec.device),
        eps * torch.eye(N_PARAMS, dtype=theta_vec.dtype,
                        device=theta_vec.device)])
    return theta_vec.expand(N_PARAMS + 1, N_PARAMS) + bump


def _theta_on(theta_vec, strikes: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(theta_vec, device=strikes.device).to(strikes.dtype)


def jacobian_and_prices(spec: GridSpec, solver: SolverConfig, strikes, s0,
                        theta_vec, r_d, r_f, eps: float = 1e-6,
                        american: bool = False, dividends=None,
                        option_type: str = "call", device=None):
    """(J [B, 5], base prices [B]) by forward finite differences on the
    eager loop: the base and the five bumped parameter rows
    (`_bumped_param_matrix`), each a pricing pass over the book — the
    JAX package's vmap over bumps and strikes (heston_tpu/models/
    calibration.py:109-145; ref: src/jacobian_computation.cpp:204-364),
    lane for lane. The device defaults to the card."""
    strikes = douglas.as_strikes(strikes, douglas.resolve_device(device))
    douglas._validate_barrier_book(spec, s0, strikes)
    pmat = _bumped_param_matrix(_theta_on(theta_vec, strikes), eps)
    prices = torch.stack([
        douglas._price(spec, solver, strikes, s0, *row, r_d, r_f, american,
                       dividends, option_type, None) for row in pmat])
    base = prices[0]
    return ((prices[1:] - base[None, :]) / eps).T, base


def base_prices(spec: GridSpec, solver: SolverConfig, strikes, s0,
                theta_vec, r_d, r_f, american: bool = False, dividends=None,
                option_type: str = "call", device=None) -> torch.Tensor:
    """Prices [B] of a book at one parameter set on the eager loop
    (heston_tpu/models/calibration.py:229-257; ref:
    src/jacobian_computation.cpp:368). The device defaults to the card."""
    strikes = douglas.as_strikes(strikes, douglas.resolve_device(device))
    douglas._validate_barrier_book(spec, s0, strikes)
    return douglas._price(spec, solver, strikes, s0,
                          *_theta_on(theta_vec, strikes), r_d, r_f, american,
                          dividends, option_type, None)


def jacobian_and_prices_ad(spec: GridSpec, solver: SolverConfig, strikes,
                           s0, theta_vec, r_d, r_f, eps: float = 0.0,
                           american: bool = False, dividends=None,
                           option_type: str = "call",
                           v0_mode: str = "stencil", rate_schedule=None,
                           device=None):
    """(J [B, 5], base prices [B]) by exact forward-mode AD
    (heston_tpu/models/calibration.py:148-226); `eps` is ignored (the FD
    signature). Under "pallas" at flat rates: one launch per phase of the
    forward-mode time-loop kernel (`fused_do.fused_theta_jacobian`).
    Otherwise — "scan", "pcr", or a curve book (`rate_schedule`) under any
    engine — the eager loop linearized (`douglas.linearize`): v0_mode
    "stencil" over (kappa, eta, sigma, rho) with the v0 column the
    surface v-stencil (`douglas.price_and_v0_stencil`), "ad" over all
    five, the v0 direction moving the v-grid. The device defaults to the
    card."""
    if v0_mode not in ("stencil", "ad"):
        raise ValueError(f"unknown v0_mode: {v0_mode!r}")
    strikes = douglas.as_strikes(strikes, douglas.resolve_device(device))
    theta_vec = _theta_on(theta_vec, strikes)
    if solver.solver_engine == "pallas" and rate_schedule is None:
        base, jac = fused_do.fused_theta_jacobian(
            spec, solver, strikes, s0, theta_vec, r_d, r_f,
            american=american, dividends=dividends, option_type=option_type,
            v0_mode=v0_mode)
        return jac, base
    douglas._validate_barrier_book(spec, s0, strikes)
    tail = (r_d, r_f, american, dividends, option_type, rate_schedule)
    if v0_mode == "stencil":
        v0 = theta_vec[4]

        def fleet4(tv4):
            return douglas._price_and_v0_stencil(
                spec, solver, strikes, s0, *tv4, v0, *tail)

        jac4, (base, dv0) = douglas.linearize(fleet4, theta_vec[:4],
                                              has_aux=True)
        return torch.cat([jac4.T, dv0[:, None]], dim=1), base

    def fleet(tv):
        return douglas._price(spec, solver, strikes, s0, *tv, *tail)

    jac, base = douglas.linearize(fleet, theta_vec)
    return jac.T, base


@scope("calibrate_device")
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
    package's `calibrate_device` (the reference's loop, ref:
    src/heston_calibration.cpp:206-417).

    Each iteration: the Jacobian and base prices of the whole chain
    (cfg.jacobian_mode "ad": under "pallas" one forward-mode kernel launch,
    under "scan" or "pcr" the eager loop linearized per maturity group,
    `jacobian_and_prices_ad`; "fd": six bumped pricing passes), the
    damped 5x5 solve of the normal equations,
    the clamps, one trial pricing pass, and the accept/reject update of
    the parameters and the damping. The loop is Python over device
    tensors; the only host read per iteration is the stop flag (see the
    module docstring).

    `group_steps`: optional (start, end, n_steps) slices of a
    multi-maturity chain, each priced with its own step count at the
    shared dt (the eager engines price them group by group). Under
    "pallas" more than one group takes the JAX package's one-launch
    branch (heston_tpu/models/calibration.py:548-578, :658-668): the
    whole chain in one launch per pass, each option stopping at its
    group's count (per-option step counts). `weights` (optional
    [n_points]): least-squares weights of the objective, normal equations
    and accept/reject test. `pricer="cf"` prices the chain with the
    characteristic-function pricer (`models.heston_cf`; European, no
    dividends, else ValueError), each group at its maturity T·n/N and the
    flat rate r_d (r_f is not read, as in the JAX package); its "ad"
    Jacobian linearizes all five parameters (v0 moves no grid). Inputs go
    to `device` (None: the card; "cpu" runs the plain version of the
    kernels); the dtype is the strikes' (at least float32).

    Returns (theta_vec [5], info) with info's keys as in the JAX package:
    final_error, iterations, converged, lam, fitted_prices and history
    (error, lam, accepted, params rows in [cfg.max_iter] arrays; rows past
    `iterations` are NaN).

    Each iteration runs in the span `heston.lm_iteration` (the Jacobian
    pass, the solve, the trial pricing and the stop flag's read). Counts
    each fit in `calibrate_device.calls`, its iterations in
    `.iterations` and each read of the stop flag in `.host_reads`."""
    if pricer not in ("pde", "cf"):
        raise ValueError(f"unknown pricer: {pricer!r}")
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
    if pricer == "cf":
        # heston_tpu/models/calibration.py:643-656 and :622-626
        if american or dividends is not None:
            raise ValueError("pricer='cf' supports European chains only")
        parts = [(a, b, solver.maturity * n / max(solver.n_steps, 1))
                 for a, b, n in groups]

        def fleet_prices(tv):
            return torch.cat([heston_cf.price_chain(
                s0, strikes[a:b], tv[4], tv[0], tv[1], tv[2], tv[3], r_d, t,
                option_type=option_type, device=dev) for a, b, t in parts])

        def ad_jacobian(tv):
            jac, base = douglas.linearize(fleet_prices, tv)
            return jac.T, base
    elif solver.solver_engine == "pallas":
        # the chain's solver at the largest group's count, and each
        # option's own count when there is more than one group
        sol = _group_solver(solver, max(n for _, _, n in groups))
        kw = dict(american=american, dividends=dividends,
                  option_type=option_type,
                  n_steps_per=lane_steps(groups) if len(groups) > 1
                  else None)

        def fleet_prices(tv):
            return fused_do.fused_price_batch(
                spec, sol, strikes, s0, *tv, r_d, r_f, **kw)

        def ad_jacobian(tv):
            base, jac = fused_do.fused_theta_jacobian(
                spec, sol, strikes, s0, tv, r_d, r_f, **kw)
            return jac, base
    else:
        # the eager loop per maturity group (heston_tpu/models/
        # calibration.py:675-683, :608-623)
        douglas._validate_barrier_book(spec, s0, strikes)
        parts = [(a, b, _group_solver(solver, n)) for a, b, n in groups]

        def fleet_prices(tv):
            return torch.cat([douglas._price(
                spec, sol_g, strikes[a:b], s0, *tv, r_d, r_f, american,
                dividends, option_type, None) for a, b, sol_g in parts])

        def ad_jacobian(tv):
            jb = [jacobian_and_prices_ad(
                spec, sol_g, strikes[a:b], s0, tv, r_d, r_f,
                american=american, dividends=dividends,
                option_type=option_type, device=dev)
                for a, b, sol_g in parts]
            return (torch.cat([j for j, _ in jb]),
                    torch.cat([b for _, b in jb]))

    def fleet_jacobian(tv):
        if cfg.jacobian_mode == "ad":
            return ad_jacobian(tv)
        # finite differences: base + one bump per parameter, each a full
        # pricing pass (ref: src/jacobian_computation.cpp:292-361)
        pmat = _bumped_param_matrix(tv, cfg.eps)
        prices = torch.stack([fleet_prices(row) for row in pmat])
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
    calibrate_device.calls += 1
    it = 0
    while it < cfg.max_iter:
        with scope("lm_iteration"):
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
                accept,
                torch.clamp(lam * cfg.lambda_down, min=cfg.lambda_min),
                torch.clamp(lam * cfg.lambda_up, max=cfg.lambda_max))
            lam = torch.where(conv_now, lam, lam_next)
            err = torch.where(conv_now, current_error,
                              torch.minimum(new_error, current_error))
            fitted = torch.where(conv_now | ~accept, base, trial)
            converged = converged | conv_now
            it += 1
            calibrate_device.iterations += 1
            calibrate_device.host_reads += 1
            if bool(converged):      # the one host read of the iteration
                break
    return tv, dict(final_error=err, iterations=it, converged=converged,
                    lam=lam, fitted_prices=fitted, history=hist)


calibrate_device.calls = 0
calibrate_device.iterations = 0
calibrate_device.host_reads = 0


# ---------------------------------------------------------------------------
# the host LM loop
# ---------------------------------------------------------------------------

def lm_host_loop(market, cfg: CalibrationConfig, state, eval_step,
                 eval_prices, checkpoint_path=None, pkey: str = "",
                 verbose: bool = False, weights=None):
    """The damped accept/reject Levenberg–Marquardt loop on the host
    (heston_tpu/models/calibration.py:325-410; ref: src/
    heston_calibration.cpp:206-417): clamps, the Marquardt damping
    schedule, the convergence tests, a checkpoint after every iteration,
    and the repricing of a run resumed from a finished checkpoint.

    eval_step(theta_vec, lam) -> (delta [5], base prices [n], current
    error): one Jacobian pass and damped normal-equation solve;
    eval_prices(theta_vec) -> [n]: trial pricing; numpy in and out.
    `weights` (optional [n]): the trial error becomes sum w_i r_i^2 (the
    caller weights eval_step's error and normal equations the same way).
    `state`: a checkpoint.LMState, fresh or resumed. Returns (theta_vec,
    lam, iters, final_error, converged, history, fitted)."""
    market = np.asarray(market)
    theta_vec = np.asarray(state.theta_vec)
    lam = state.lam
    history = state.history
    converged = state.converged
    final_error = state.final_error
    iters = start_iter = state.iteration
    fitted = np.zeros_like(market)

    def save():
        if checkpoint_path:
            LMState(np.asarray(theta_vec), lam, iters, final_error,
                    converged, history, key=pkey).save(checkpoint_path)

    for it in range(start_iter, cfg.max_iter):
        if converged:
            break
        iters = it + 1
        delta, base, current_error = eval_step(theta_vec, lam)
        fitted = np.asarray(base)
        delta = np.asarray(delta)
        new_vec = clamp_params(theta_vec + delta, cfg)
        delta_norm = float(np.linalg.norm(delta))

        if verbose:
            print(f"iter {iters}: sse={current_error:.6e} "
                  f"|delta|={delta_norm:.3e} lambda={lam:.1e}")

        if delta_norm < cfg.tol or current_error < cfg.tol:
            theta_vec = new_vec
            converged = True
            final_error = current_error
            history.append(dict(iter=iters, sse=current_error,
                                delta_norm=delta_norm, lam=lam,
                                accepted=True))
            save()
            break

        new_prices = eval_prices(new_vec)
        new_resid = market - new_prices
        new_error = (float(new_resid @ new_resid) if weights is None
                     else float(new_resid @ (np.asarray(weights)
                                             * new_resid)))
        accepted = new_error < current_error
        if accepted:
            theta_vec = new_vec
            fitted = new_prices
            lam = max(lam * cfg.lambda_down, cfg.lambda_min)
        else:
            lam = min(lam * cfg.lambda_up, cfg.lambda_max)
        final_error = min(new_error, current_error)
        history.append(dict(iter=iters, sse=current_error,
                            new_sse=new_error, delta_norm=delta_norm,
                            lam=lam, accepted=accepted))
        save()

    if iters == start_iter:
        # resumed from a finished checkpoint: the loop never ran, so
        # price the final parameters instead of returning zeros
        fitted = eval_prices(theta_vec)
    return theta_vec, lam, iters, final_error, converged, history, fitted


@dataclasses.dataclass
class CalibrationResult:
    params: HestonParams
    initial_params: HestonParams
    final_error: float
    iterations: int
    converged: bool
    fitted_prices: np.ndarray
    market_prices: np.ndarray
    strikes: np.ndarray
    history: List[Dict]
    total_pde_solves: int


def calibrate(
    targets: CalibrationTargets,
    spec: GridSpec,
    solver: SolverConfig,
    init: HestonParams,
    cfg: CalibrationConfig = CalibrationConfig(),
    steps_per_year: Optional[int] = None,
    verbose: bool = False,
    pricing_fns=None,
    checkpoint_path: Optional[str] = None,
    device=None,
) -> CalibrationResult:
    """The host Levenberg–Marquardt loop (heston_tpu/models/
    calibration.py:751-881; ref: src/heston_calibration.cpp:26-512 and the
    multi-maturity variants :2428-2935): `lm_host_loop` with one Jacobian
    pass and one trial pricing per iteration, each maturity group of the
    targets priced with round(steps_per_year * T) steps (default
    solver.n_steps per year).

    The Jacobian: cfg.jacobian_mode "ad" (`jacobian_and_prices_ad`: under
    "pallas" one launch of the forward-mode kernel per maturity group) or
    "fd" (`jacobian_and_prices`, six pricing passes of the eager loop);
    the trial prices come from the eager loop (`base_prices`) under every
    engine, as in the JAX package. `pricing_fns`: an optional (jac_fn,
    price_fn) with those functions' signatures replacing them (without
    `device`; they get tensors on the device). `targets.weights`: the
    least-squares weights. `checkpoint_path`: the LM state is saved after
    every iteration and an existing file resumes the run; a file of
    another problem raises (`utils.checkpoint`).

    Inputs go to `device` (None: the card; "cpu" runs the plain versions
    of the kernels) in the strikes' float dtype (float32 strikes give a
    float32 fit); the damped normal equations are solved there in
    float64, the accept/reject loop runs on the host."""
    dev = douglas.resolve_device(device)
    ks_all = douglas.as_strikes(np.asarray(targets.strikes), dev)
    if pricing_fns is not None:
        jac_fn, price_fn = pricing_fns[0], pricing_fns[1]
    else:
        jac_fn = functools.partial(
            jacobian_and_prices_ad if cfg.jacobian_mode == "ad"
            else jacobian_and_prices, device=dev)
        price_fn = functools.partial(base_prices, device=dev)

    spy = steps_per_year if steps_per_year is not None else solver.n_steps
    groups = targets.groups()

    def solver_for(mat: float) -> SolverConfig:
        n = max(1, int(round(spy * mat)))
        return dataclasses.replace(solver, n_steps=n, maturity=mat)

    market = np.asarray(targets.prices)
    # the key fingerprints the problem, not the LM settings: resuming
    # with a larger max_iter or a looser tol continues the run
    weights = (None if targets.weights is None
               else np.asarray(targets.weights, np.float64))
    if weights is not None and (weights.shape != market.shape
                                or np.any(weights < 0)):
        raise ValueError(
            f"weights must be >= 0 with shape {market.shape}; got shape "
            f"{weights.shape}")
    pkey = problem_key(targets.strikes, targets.prices,
                       targets.maturities, targets.s0, targets.r_d,
                       targets.r_f, targets.american,
                       targets.option_type, spec, solver, spy, weights)
    state = LMState.fresh(init, cfg.lambda_init)
    state.key = pkey
    state = state.maybe_resume(checkpoint_path)
    common = dict(american=targets.american, dividends=targets.dividends,
                  option_type=targets.option_type)

    def host(x):
        return x.detach().cpu().numpy()

    def theta(tv):
        return torch.as_tensor(np.asarray(tv), device=dev).to(ks_all.dtype)

    def eval_jacobian(tv):
        jac = np.zeros((len(market), N_PARAMS))
        prices = np.zeros(len(market))
        for mat, idx in groups:
            j, p = jac_fn(spec, solver_for(mat), ks_all[idx], targets.s0,
                          theta(tv), targets.r_d, targets.r_f, eps=cfg.eps,
                          **common)
            jac[idx] = host(j)
            prices[idx] = host(p)
        return jac, prices

    def eval_prices(tv):
        prices = np.zeros(len(market))
        for mat, idx in groups:
            prices[idx] = host(price_fn(
                spec, solver_for(mat), ks_all[idx], targets.s0, theta(tv),
                targets.r_d, targets.r_f, **common))
        return prices

    def eval_step(tv, lam_):
        jac, base = eval_jacobian(tv)
        residual = market - base
        current_error = (float(residual @ residual) if weights is None
                         else float(residual @ (weights * residual)))
        delta = lm_update(torch.from_numpy(jac).to(dev),
                          torch.from_numpy(residual).to(dev), lam_,
                          None if weights is None
                          else torch.from_numpy(weights).to(dev))
        return host(delta), base, current_error

    (theta_vec, lam, iters, final_error, converged, history, fitted
     ) = lm_host_loop(market, cfg, state, eval_step, eval_prices,
                      checkpoint_path=checkpoint_path, pkey=pkey,
                      verbose=verbose, weights=weights)

    calibrated = dataclasses.replace(
        init, kappa=float(theta_vec[0]), eta=float(theta_vec[1]),
        sigma=float(theta_vec[2]), rho=float(theta_vec[3]),
        v0=float(theta_vec[4]))
    return CalibrationResult(
        params=calibrated,
        initial_params=init,
        final_error=final_error,
        iterations=iters,
        converged=converged,
        fitted_prices=fitted,
        market_prices=market,
        strikes=np.asarray(targets.strikes),
        history=history,
        total_pde_solves=len(market) * (N_PARAMS + 2) * iters - len(market),
    )

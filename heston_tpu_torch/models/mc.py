"""Monte Carlo Heston oracle — all paths advance together (PyTorch).

Counterpart of `heston_tpu.models.mc` (ref: src/MC_hes.cpp:48-99, the
reference's path-by-path CPU simulator). Every path advances one time
step at a time as plain tensor ops on the device, in a Python loop where
the JAX package runs `lax.scan`; draws come from an explicit
`torch.Generator` on that device in place of a `jax.random` key. No
PyTorch generator reproduces JAX's stream (one key split per step), so
the two packages agree in distribution, not path by path.

Scheme (the reference's, up to the random numbers):
    dW_v = sqrt(dt) Z1,  dW_s = sqrt(dt) (rho Z1 + sqrt(1-rho^2) Z2)
    V += kappa (eta - V) dt + sigma sqrt(max(V,0)) dW_v
    S += (r_d - r_f) S dt + S sqrt(max(V,0)) dW_s
350 steps a year (ref: src/MC_hes.hpp N_DAYS_PER_YEAR), the discounted
payoff's mean and its 95% confidence half-width (NORMAL_SCORE = 1.96).

Beyond the reference, as in the JAX package: puts and digitals, discrete
dividend jumps on the path, knock-out barriers by Brownian-bridge
survival weights (knock-ins from the same paths), antithetic variates,
Andersen's Quadratic-Exponential variance scheme (`scheme="qe"`), and a
Longstaff–Schwartz American pricer (`price_american_lsmc`).

The dtype is the strike's (a Python number takes torch's default float
dtype, as `douglas.as_strikes`), the device the card unless the caller
passes `device="cpu"`; the generator must live on that device. Nothing
inside the step loops reads a value back to the host: the estimators
return 0-d tensors on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from heston_tpu_torch.models.douglas import as_strikes, resolve_device
from heston_tpu_torch.ops import operators

N_STEPS_PER_YEAR = 350
NORMAL_SCORE = 1.96
SCHEMES = ("truncation", "reflection", "qe")
BARRIER_KINDS = ("up-out", "down-out", "double-out")


def feller_condition(kappa, eta, sigma) -> bool:
    """2*kappa*eta > sigma^2 (ref: src/MC_hes.cpp:18-20)."""
    return 2.0 * kappa * eta > sigma * sigma


def select_scheme(kappa, eta, sigma) -> str:
    """Feller-driven variance-scheme dispatch, the reference's automatic
    selection (ref: src/MC_hes.cpp:18-20, 102): truncation where
    2*kappa*eta > sigma^2 keeps V positive in distribution, reflection
    where the condition fails. A host-side branch on the parameters'
    values."""
    return ("truncation"
            if feller_condition(float(kappa), float(eta), float(sigma))
            else "reflection")


def _dividend_jumps(dividends, t, n_steps: int):
    """Per-calendar-step (mult, sub, has_event) numpy arrays folding the
    schedule's discrete jumps s -> s*(1-pct) - amount, computed on the
    host (heston_tpu/models/mc.py:66-102).

    The schedule's dates are time to maturity (the PDE applies the event
    before backward step n = floor(date/dt), config.events_for_step), so
    in calendar time the jump lands after forward step m = n_steps - n
    (0-based). Same-step events compose in calendar order, the reverse of
    date order — the PDE's sequential surface remaps, whose
    U0(f_d1(f_d2(s))) composition makes the larger time to maturity (the
    earlier calendar event) hit the forward spot path first."""
    mult = np.ones(n_steps)
    sub = np.zeros(n_steps)
    has = np.zeros(n_steps, dtype=bool)
    if dividends is not None and len(dividends) > 0:
        dt = float(t) / n_steps
        for n in range(1, n_steps + 1):
            m = n_steps - n
            for amt, pct in reversed(dividends.events_for_step(n, dt)):
                # compose "apply this event AFTER the current composite"
                mult[m] *= (1.0 - pct)
                sub[m] = sub[m] * (1.0 - pct) + amt
                has[m] = True
    return mult, sub, has


def _scalar(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """x as a 0-d tensor on the device; a Python number is filled there
    (no copy from the host, which would wait for the device)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device)
    return torch.full((), float(x), dtype=dtype, device=device)


def _simulate(generator, s0, v0, r_d, r_f, kappa, eta, sigma, rho, t,
              mult, sub, has_ev, num_paths: int, n_steps: int, scheme: str,
              keep_panel: bool, dtype: torch.dtype, device: torch.device,
              antithetic: bool = False, barrier_kind=None,
              barrier_level=None, barrier_level_hi=None):
    """The shared forward simulator (heston_tpu/models/mc.py:105-265):
    Euler (truncation or reflection) or Andersen QE, plus dividend jumps
    on event steps only (without dividends the Euler dynamics are the
    reference's: no absorbing barrier at 0). Returns the terminal (s, v,
    survival weight) or, with keep_panel, the [n_steps, paths] panels of
    (s, v) after steps 1..n_steps (for LSMC).

    antithetic=True drives paths [0, P/2) with Z and their mirrors
    [P/2, P) with -Z (QE's variance draw: U and 1-U); num_paths must be
    even. barrier_kind ("up-out", "down-out", "double-out"): a
    continuously monitored knock-out as a per-path survival weight, each
    step multiplying by the Brownian-bridge non-crossing probability
        1 - exp(-2 (b - x_n)(b - x_{n+1}) / (v_n dt)),   x = ln S
    (0 once an endpoint lands beyond the barrier), the start-of-step
    variance as the bridge's."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown MC scheme: {scheme!r}")
    if antithetic and num_paths % 2:
        raise ValueError("antithetic variates need an even num_paths")

    def c(x):
        return _scalar(x, dtype, device)

    s0, v0, r_d, r_f, kappa, eta, sigma, rho = map(
        c, (s0, v0, r_d, r_f, kappa, eta, sigma, rho))
    dt = c(t / n_steps)
    sqrt_dt = torch.sqrt(dt)
    rho_c = torch.sqrt(1.0 - rho * rho)
    tiny = torch.finfo(dtype).tiny
    bridge_checks = []                          # (log level, is_upper)
    if barrier_kind is not None:
        if barrier_kind not in BARRIER_KINDS:
            raise ValueError(f"unknown barrier kind: {barrier_kind!r}")
        if barrier_kind != "up-out":
            bridge_checks.append((torch.log(c(barrier_level)), False))
        if barrier_kind == "up-out":
            bridge_checks.append((torch.log(c(barrier_level)), True))
        elif barrier_kind == "double-out":
            bridge_checks.append((torch.log(c(barrier_level_hi)), True))
    if scheme == "qe":
        # the variance transition V -> V' over dt has exact conditional
        # mean m and variance s2 (affine in V); the log-spot takes the
        #   ln S' = ln S + (r_d-r_f) dt + K0 + K1 V + K2 V'
        #           + sqrt(K3 (V + V')) Z
        # relation with the central weights (gamma1 = gamma2 = 1/2).
        # Needs kappa > 0.
        e_kdt = torch.exp(-kappa * dt)
        sig2 = sigma * sigma
        var_c1 = sig2 * e_kdt * (1.0 - e_kdt) / kappa       # x V
        var_c2 = eta * sig2 * (1.0 - e_kdt) ** 2 / (2.0 * kappa)
        k0 = -rho * kappa * eta * dt / sigma
        k1 = 0.5 * dt * (kappa * rho / sigma - 0.5) - rho / sigma
        k2 = 0.5 * dt * (kappa * rho / sigma - 0.5) + rho / sigma
        k3 = 0.5 * dt * (1.0 - rho * rho)
        u_eps = torch.finfo(dtype).eps
    draw = dict(generator=generator, dtype=dtype, device=device)
    half = num_paths // 2

    def normals(rows):
        if antithetic:
            zh = torch.randn((rows, half), **draw)
            return torch.cat([zh, -zh], dim=1)
        return torch.randn((rows, num_paths), **draw)

    s = torch.full((num_paths,), 1.0, dtype=dtype, device=device) * s0
    v = torch.full((num_paths,), 1.0, dtype=dtype, device=device) * v0
    surv = torch.ones(num_paths, dtype=dtype, device=device)
    if keep_panel:
        panel_s = torch.empty((n_steps, num_paths), dtype=dtype,
                              device=device)
        panel_v = torch.empty_like(panel_s)
    for m in range(n_steps):
        if scheme == "qe":
            # the uniform for the variance sampler, the normal for the
            # spot; both samplers are monotone in their draw, so the
            # mirrored path is the QE analog of the Euler -Z path
            if antithetic:
                uh = torch.rand(half, **draw)
                u = torch.cat([uh, 1.0 - uh])
            else:
                u = torch.rand(num_paths, **draw)
            u = torch.clamp(u, u_eps, 1.0 - u_eps)
            z_s = normals(1)[0]
            vp = torch.clamp(v, min=0.0)    # defensive: QE keeps V' >= 0
            mean = eta + (vp - eta) * e_kdt
            s2 = vp * var_c1 + var_c2
            psi = s2 / (mean * mean)        # mean > 0 whenever eta > 0
            # quadratic branch (psi <= 1.5): V' = a (b + Z)^2, Z from the
            # same uniform by the inverse normal CDF
            inv_psi = 2.0 / psi
            b2 = torch.clamp(
                inv_psi - 1.0
                + torch.sqrt(torch.clamp(inv_psi * (inv_psi - 1.0),
                                         min=0.0)), min=0.0)
            a = mean / (1.0 + b2)
            zv = torch.special.ndtri(u)
            v_quad = a * (torch.sqrt(b2) + zv) ** 2
            # exponential branch (psi > 1.5): mass p at 0 and an
            # exponential tail, inverted from the same uniform
            p = (psi - 1.0) / (psi + 1.0)
            beta = (1.0 - p) / mean
            v_exp = torch.where(
                u <= p, 0.0,
                torch.log((1.0 - p) / torch.clamp(1.0 - u, min=u_eps))
                / beta)
            v_new = torch.where(psi <= 1.5, v_quad, v_exp)
            s_new = s * torch.exp(
                (r_d - r_f) * dt + k0 + k1 * vp + k2 * v_new
                + torch.sqrt(torch.clamp(k3 * (vp + v_new), min=0.0)) * z_s)
        else:
            z = normals(2)
            dw_v = sqrt_dt * z[0]
            dw_s = sqrt_dt * (rho * z[0] + rho_c * z[1])
            sqv = torch.sqrt(torch.clamp(v, min=0.0))
            v_new = v + kappa * (eta - v) * dt + sigma * sqv * dw_v
            if scheme == "reflection":
                v_new = torch.abs(v_new)
            s_new = s + (r_d - r_f) * s * dt + s * sqv * dw_s
        if has_ev[m]:
            s_new = torch.clamp(s_new * float(mult[m]) - float(sub[m]),
                                min=0.0)
        if bridge_checks:
            # the bridge over [s, s_new] in log space at the start-of-step
            # variance; a dividend lands at the step's end, so the
            # post-jump spot is the endpoint (a jump through the barrier
            # knocks out by the endpoint test)
            x0 = torch.log(torch.clamp(s, min=tiny))
            x1 = torch.log(torch.clamp(s_new, min=tiny))
            bvar = torch.clamp(torch.clamp(v, min=0.0) * dt, min=tiny)
            for b_log, up in bridge_checks:
                d0 = b_log - x0
                d1 = b_log - x1
                if not up:
                    d0, d1 = -d0, -d1
                p_cross = torch.exp(-2.0 * d0 * d1 / bvar)
                surv = surv * torch.where((d0 > 0.0) & (d1 > 0.0),
                                          1.0 - p_cross, 0.0)
        s, v = s_new, v_new
        if keep_panel:
            panel_s[m] = s
            panel_v[m] = v
    if keep_panel:
        return panel_s, panel_v
    return s, v, surv


def _mc_mean_ci(payoff: torch.Tensor, num_paths: int, antithetic: bool):
    """(mean, 95% half-width), 0-d tensors. Under antithetic pairing the
    iid samples are the pair means (path i with its mirror i + P/2): the
    raw paths' variance would ignore the negative covariance within a
    pair that the method exists for."""
    if antithetic:
        half = num_paths // 2
        samples = 0.5 * (payoff[:half] + payoff[half:])
    else:
        samples = payoff
    n = samples.shape[0]
    mean = torch.mean(samples)
    # standard error of the mean (the reference divides by M twice,
    # ref: src/MC_hes.cpp:91-94; corrected as in the JAX package)
    var_mean = (torch.mean(samples ** 2) - mean ** 2) / n
    return mean, NORMAL_SCORE * torch.sqrt(var_mean)


def _setup(generator, strike, device, scheme, kappa, eta, sigma, dividends,
           t, n_steps):
    dev = resolve_device(device)
    k = as_strikes(strike, dev)
    if k.ndim != 0:
        raise ValueError(f"one strike, got shape {tuple(k.shape)}")
    if generator.device.type != dev.type:
        raise ValueError(f"the generator is on {generator.device}, the "
                         f"simulation on {dev}")
    if scheme == "auto":
        scheme = select_scheme(kappa, eta, sigma)
    return dev, k, scheme, _dividend_jumps(dividends, t, n_steps)


def price_european_call_mc(
    generator: torch.Generator,
    s0,
    v0,
    strike,
    r_d,
    r_f,
    kappa,
    eta,
    sigma,
    rho,
    t,
    num_paths: int = 100_000,
    n_steps: int = N_STEPS_PER_YEAR,
    scheme: str = "auto",
    option_type: str = "call",
    dividends=None,
    antithetic: bool = False,
    barrier=None,
    knock_in: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(price, 95% confidence half-width), 0-d tensors on the device
    (heston_tpu/models/mc.py:285-376).

    scheme "auto" (the default): the Feller-driven choice between
    "truncation" (sqrt(max(V, 0)) in the diffusion terms, the reference's
    standard variant) and "reflection" (V -> |V| after each update; the
    reference's is disabled, this one works). "qe": Andersen's
    Quadratic-Exponential scheme, near-flat weak error in dt (~16 steps a
    year price within MC noise where Euler needs 350); needs kappa > 0.
    option_type: "call", "put", "digital_call", "digital_put".
    `dividends`: jumps s -> s*(1-pct) - cash on the path at the
    schedule's calendar times. antithetic=True mirrors half the paths
    (even num_paths). `barrier` (a config.Barrier): a continuously
    monitored knock-out by Brownian-bridge survival weights;
    knock_in=True weights by 1 - survival instead, from the same
    survival tensor, so MC(knock-in) + MC(knock-out) == MC(vanilla)
    exactly at one seed."""
    if knock_in and barrier is None:
        raise ValueError("knock_in=True needs a barrier (the trigger)")
    dev, k, scheme, (mult, sub, has_ev) = _setup(
        generator, strike, device, scheme, kappa, eta, sigma, dividends, t,
        n_steps)
    s_fin, _, surv = _simulate(
        generator, s0, v0, r_d, r_f, kappa, eta, sigma, rho, t, mult, sub,
        has_ev, num_paths, n_steps, scheme, False, k.dtype, dev,
        antithetic=antithetic,
        barrier_kind=None if barrier is None else barrier.kind,
        barrier_level=None if barrier is None else barrier.level,
        barrier_level_hi=None if barrier is None else barrier.level_hi)
    disc = torch.exp(-_scalar(r_d, k.dtype, dev) * _scalar(t, k.dtype, dev))
    weight = (1.0 - surv) if knock_in else surv
    payoff = disc * operators.payoff_value(s_fin, k, option_type) * weight
    return _mc_mean_ci(payoff, num_paths, antithetic)


def price_american_lsmc(
    generator: torch.Generator,
    s0,
    v0,
    strike,
    r_d,
    r_f,
    kappa,
    eta,
    sigma,
    rho,
    t,
    num_paths: int = 100_000,
    n_steps: int = 50,
    scheme: str = "auto",
    option_type: str = "put",
    dividends=None,
    antithetic: bool = False,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """American option by Longstaff–Schwartz least-squares Monte Carlo
    (heston_tpu/models/mc.py:378-480), an oracle independent of the PDE's
    multiplier method. Returns (price, 95% half-width of the pathwise
    estimator; 0 when the immediate-exercise floor binds), 0-d tensors.

    The forward simulation of `price_european_call_mc` keeps the [n_steps,
    P] panel of (S, V) on the device; the backward induction regresses
    the continuation value at each exercise date on [1, S/K, (S/K)^2, V,
    (S/K) V] over the in-the-money paths (weighted 5x5 normal equations
    with a ridge of 1e-9 P, solved on the device without a host read) and
    exercises where the intrinsic value beats it. The policy is
    suboptimal, so the estimate is slightly low (~1e-2 at the money).
    scheme and antithetic as for the European pricer."""
    dev, k, scheme, (mult, sub, has_ev) = _setup(
        generator, strike, device, scheme, kappa, eta, sigma, dividends, t,
        n_steps)
    dtype = k.dtype
    s_path, v_path = _simulate(
        generator, s0, v0, r_d, r_f, kappa, eta, sigma, rho, t, mult, sub,
        has_ev, num_paths, n_steps, scheme, True, dtype, dev,
        antithetic=antithetic)
    dt = _scalar(t / n_steps, dtype, dev)
    disc = torch.exp(-_scalar(r_d, dtype, dev) * dt)
    ridge = 1e-9 * num_paths * torch.eye(5, dtype=dtype, device=dev)

    def exercise_value(s):
        return operators.payoff_value(s, k, option_type)

    # terminal cashflow per path, valued at maturity
    cf = exercise_value(s_path[-1])
    # exercise dates n_steps-1 .. 1 (at t = 0 only the floor below)
    for i in range(n_steps - 2, -1, -1):
        s, v = s_path[i], v_path[i]
        y = disc * cf                  # continuation, valued at this date
        ex = exercise_value(s)
        itm = (ex > 0.0).to(dtype)
        # features normalized by the strike keep the Gram matrix scaled:
        # raw S and S^2 put ~1e13 on the diagonal, and any usable ridge
        # would then swamp the low-order coefficients
        sn = s / k
        x = torch.stack([torch.ones_like(sn), sn, sn * sn, v, sn * v])
        xw = x * itm[None, :]
        gram = xw @ x.T                                       # [5, 5]
        rhs = xw @ y                                          # [5]
        beta = torch.linalg.solve_ex(gram + ridge, rhs[:, None])[0][:, 0]
        cont = beta @ x
        take = (itm > 0.0) & (ex > cont)
        cf = torch.where(take, ex, y)
    pay0 = disc * cf                   # discount the first date to t = 0
    mean, half = _mc_mean_ci(pay0, num_paths, antithetic)
    # immediate exercise at t = 0 floors the price at intrinsic; the
    # floored value is deterministic, so its half-width is 0
    floor = exercise_value(_scalar(s0, dtype, dev))
    return (torch.maximum(mean, floor),
            torch.where(mean >= floor, half, torch.zeros_like(half)))

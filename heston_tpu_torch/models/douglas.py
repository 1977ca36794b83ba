"""ADI pricing: the eager time loop and the batched entry points (PyTorch).

Counterpart of `heston_tpu.models.douglas`. Two engines price a book:

* `solver_engine="pallas"`, the engine that reaches the hand-written time
  loop kernels in the JAX package: `price_batch` runs
  `kernels.fused_single` for a batch of one and `kernels.fused_do` for
  every other book. It never reaches the eager loop below: the JAX
  package falls back to it only when a grid overflows the TPU kernel's
  VMEM, a limit the port does not have.
* "scan" and "pcr", the eager ADI loop of this module: `prepare_instance`
  builds each option's grid, operator set and implicit factorizations,
  `run_time_loop` runs the phase plan (Rannacher start-up, dividend
  remaps, rate-curve segments) one `_do_step` at a time with plain tensor
  ops, the implicit solves through `ops.banded` under the engine named.
  The loop is batched over a leading option axis where the JAX package
  vmaps a per-option function, and computes per lane what the JAX
  package's XLA loop computes, in the same order: u updated plainly (no
  delta form, no compensated carry), the Ikonen–Toivanen multiplier for
  American exercise. The single-option functions (`price_option`,
  `price_and_v0_stencil`, `price_surface`) run it under every engine,
  "scan" standing in for "pallas", as in the JAX package
  (heston_tpu/models/douglas.py:293-296); so do the host calibration loop's
  trial prices and the linearized greeks. The loop is built from
  out-of-place tensor ops, with no host read of a tensor's value, so
  `torch.func.jvp` and `torch.func.vmap` run through it (`linearize`).

Every scheme of `SolverConfig.scheme` ("do", "cs", "mcs", "hv"; an unknown
one raises ValueError), calls, puts and cash-or-nothing digitals
(`option_type`), knock-out barriers (`price_knock_in` prices the knock-in
by in–out parity), flat rates or a piecewise-constant curve
(`rate_schedule`). The entry points run on the card unless the caller
passes `device="cpu"`; without a card and without `device="cpu"` they
raise. Nothing falls back to another path or scheme.

Layout: surfaces are [B, ns, nv] (s-major, the port's layout; the JAX
package keeps [nv, ns] per option). The tridiagonal factors are [B, nv,
ns] and the pentadiagonal ones [B, nv], `ops.banded`'s conventions on
the transposed surface.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from heston_tpu_torch.config import (DividendSchedule, GridSpec, HestonParams,
                                     SolverConfig)
from heston_tpu_torch.kernels import fused_do, fused_single
from heston_tpu_torch.ops import banded, coeff, operators
from heston_tpu_torch.ops import grid as gridmod
from heston_tpu_torch.ops.grid import Grid
from heston_tpu_torch.utils.profiling import scope


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


def linearize(fn, x: torch.Tensor, n_dir: Optional[int] = None,
              has_aux: bool = False):
    """fn at x and its directional derivatives along the first `n_dir`
    basis vectors (all of x's by default), in one pass: `torch.func.vmap`
    over `torch.func.jvp`, the primal computed once — the counterpart of
    `jax.linearize` followed by `vmap(jvp_fn)(eye)`. Returns (tangents
    [n_dir, ...], out), or (tangents, (out, aux)) with `has_aux`."""
    n = x.shape[0] if n_dir is None else n_dir
    basis = torch.eye(x.shape[0], dtype=x.dtype, device=x.device)[:n]

    def along(d):
        if has_aux:
            out, dout, aux = torch.func.jvp(fn, (x,), (d,), has_aux=True)
            return dout, (out, aux)
        out, dout = torch.func.jvp(fn, (x,), (d,))
        return dout, out

    return torch.func.vmap(along, out_dims=(0, None))(basis)


# ---------------------------------------------------------------------------
# the eager engine: operator sets
# ---------------------------------------------------------------------------

class DampOps(NamedTuple):
    """The Rannacher start-up phase's implicit factorizations: the bands at
    theta = 1 and dt/2. The explicit bands and the boundary vectors are
    the main set's (their baked e^{-rate dt (N-1)} is the main solver's
    convention; the damp sub-steps scale by e^{rate (dt/2) k}, which lands
    on the same absolute times; heston_tpu/models/douglas.py:51-60)."""

    a1_fac: banded.TridiagFactor
    a2_fac: banded.PentaFactor


class SegmentOps(NamedTuple):
    """The operator set of one rate segment (or of a flat-rate book): the
    explicit operators with A0, the A1 bands and b = b1 + b2
    (`operators.build_operators`, epilogue=True), b1 and b2 apart, the
    implicit factorizations at theta*dt, and the damp set."""

    ops: operators.HestonOperators
    b1: torch.Tensor                 # [B, ns, nv]
    b2: torch.Tensor
    a1_fac: banded.TridiagFactor     # [B, nv, ns]
    a2_fac: banded.PentaFactor       # [B, nv]
    damp: Optional[DampOps] = None


class PreparedInstance(NamedTuple):
    """Everything a book needs to run the eager time loop."""

    grid: Grid
    ops: operators.HestonOperators
    b1: torch.Tensor
    b2: torch.Tensor
    a1_fac: banded.TridiagFactor
    a2_fac: banded.PentaFactor
    u0: torch.Tensor        # payoff surfaces [B, ns, nv] (barrier-masked)
    idx_s: torch.Tensor     # spot node per option [B]
    idx_v: torch.Tensor     # v0 node (0-d; the v-grid is the book's)
    damp: Optional[DampOps] = None   # rannacher_steps > 0 only
    barrier: object = None           # spec.barrier (dividend re-knock)
    # a RateSchedule book: one SegmentOps per segment, ascending; () at
    # flat rates. The top-level operator set is then the LAST segment's
    # (valuation time tau = T, what the theta epilogue differentiates).
    rate_segments: tuple = ()


def _factor(ops: operators.HestonOperators, td: float, batch: int):
    """The factorizations of I - td*A1 (along s) and I - td*A2 (along v)
    from the explicit bands, assembled as the JAX package's
    build_operators does (heston_tpu/ops/operators.py:484-497)."""
    t = lambda x: x.transpose(-1, -2)
    a1 = banded.tridiag_factor(t(-td * ops.a1_ml), t(1.0 - td * ops.a1_md),
                               t(-td * ops.a1_mu))
    a2 = banded.penta_factor(-td * ops.a2_l2, -td * ops.a2_l1,
                             1.0 - td * ops.a2_d, -td * ops.a2_u1,
                             -td * ops.a2_u2)
    return a1, banded.PentaFactor(*(x.expand(batch, -1) for x in a2))


def _build_op_set(grid: Grid, solver: SolverConfig, kappa, eta, sigma, rho,
                  r_d, r_f, option_type, barrier, boundary_anchor=None,
                  need_damp=None) -> SegmentOps:
    """Operators, factorizations and (optionally) the Rannacher damp set
    for one (rates, anchor) pair (heston_tpu/models/douglas.py:94-143).
    The damp set differs from the main one only in the implicit bands'
    scalar (dt/2 in place of theta*dt), so it is derived from the same
    explicit bands."""
    batch = grid.vec_s.shape[0]
    nsf = torch.full((batch,), float(solver.n_steps),
                     dtype=grid.vec_v.dtype, device=grid.vec_v.device)
    ops = operators.build_operators(
        grid, kappa, eta, sigma, rho, r_d, r_f, solver.delta_t, nsf,
        solver.a2_variant, option_type, epilogue=True, barrier=barrier,
        anchor=boundary_anchor)
    b1, b2 = operators.boundary_vectors(grid, r_d, r_f, solver.delta_t, nsf,
                                        option_type, barrier,
                                        boundary_anchor)
    a1_fac, a2_fac = _factor(ops, solver.theta * solver.delta_t, batch)
    damp = None
    if need_damp is None:
        need_damp = bool(solver.rannacher_steps)
    if need_damp:
        if solver.rannacher_steps < 0:
            raise ValueError(f"rannacher_steps must be >= 0; got "
                             f"{solver.rannacher_steps}")
        damp = DampOps(*_factor(ops, solver.delta_t / 2.0, batch))
    return SegmentOps(ops, b1, b2, a1_fac, a2_fac, damp)


def _segment_structure(solver: SolverConfig, rate_schedule,
                       option_type: str):
    """The static segments of a RateSchedule (operators.
    rate_segment_structure, shared with the fused kernel)."""
    return operators.rate_segment_structure(
        solver.n_steps, solver.delta_t, solver.maturity, rate_schedule,
        option_type)


def prepare_instance(spec: GridSpec, solver: SolverConfig,
                     strikes: torch.Tensor, s0, kappa, eta, sigma, rho, v0,
                     r_d, r_f, option_type: str = "call",
                     rate_schedule=None) -> PreparedInstance:
    """Grids, operator sets, factorizations and payoffs of a book of
    `strikes` [B] (heston_tpu/models/douglas.py:155-226). With a
    `rate_schedule` the scalar r_d, r_f are not read: one SegmentOps per
    rate segment, the top-level set the last one's."""
    grid = gridmod.make_grid(spec, s0, strikes, v0)
    payoff = operators.grid_payoff(grid.vec_s, strikes[:, None], option_type)
    if spec.barrier is not None:
        # knocked at expiry too: Dirichlet 0 from the payoff on, and the
        # American floor, so the multiplier cannot resurrect the column
        payoff = spec.barrier.mask_payoff(payoff)
    u0 = payoff[:, :, None].expand(-1, -1, spec.m2 + 1)
    idx_s = gridmod.find_node(grid.vec_s, s0)
    idx_v = gridmod.find_node(grid.vec_v, v0)
    if rate_schedule is not None:
        r = (min(solver.rannacher_steps, solver.n_steps)
             if solver.rannacher_steps else 0)
        seg_ops = tuple(
            _build_op_set(grid, solver, kappa, eta, sigma, rho, seg_rd,
                          seg_rf, option_type, spec.barrier,
                          boundary_anchor=anchor,
                          need_damp=bool(r) and n_lo <= r)
            for n_lo, _, seg_rd, seg_rf, _, anchor in _segment_structure(
                solver, rate_schedule, option_type))
        last = seg_ops[-1]
        return PreparedInstance(
            grid, last.ops, last.b1, last.b2, last.a1_fac, last.a2_fac, u0,
            idx_s, idx_v, damp=seg_ops[0].damp, barrier=spec.barrier,
            rate_segments=seg_ops)
    s = _build_op_set(grid, solver, kappa, eta, sigma, rho, r_d, r_f,
                      option_type, spec.barrier)
    return PreparedInstance(grid, s.ops, s.b1, s.b2, s.a1_fac, s.a2_fac, u0,
                            idx_s, idx_v, damp=s.damp, barrier=spec.barrier)


# ---------------------------------------------------------------------------
# the eager engine: one step, dividends, the phase plan
# ---------------------------------------------------------------------------

def apply_dividend(u: torch.Tensor, vec_s: torch.Tensor, amount, pct,
                   option_type: str = "call", barrier=None) -> torch.Tensor:
    """Surface re-map of a book for one discrete dividend
    (heston_tpu/models/douglas.py:229-272; ref: src/solver.hpp:382-425):
    each node's new_s = s*(1-pct) - amount, the old surface interpolated
    linearly there. u [B, ns, nv], vec_s [B, ns]. Its quirks: no node above
    new_s (or new_s below every node) falls through to index 0 and copies
    column 0; where new_s <= 0 a call takes 0 and a put column 0 (U(0) ~
    K); a top-knocked barrier re-knocks its top node. A down-out needs
    nothing: its bottom node falls below the grid onto column 0, itself 0."""
    m1 = vec_s.shape[-1] - 1
    new_s = vec_s * (1.0 - pct) - amount
    # first node strictly above new_s, as a comparison count; 0 if none
    idx = (vec_s[:, :, None] <= new_s[:, None, :]).sum(1)
    idx = torch.where(idx > m1, 0, idx)
    idx_lo = torch.clamp(idx - 1, min=0)
    s_lo = torch.gather(vec_s, 1, idx_lo)
    s_hi = torch.gather(vec_s, 1, idx)
    w = ((new_s - s_lo) / torch.where(s_hi == s_lo, torch.ones_like(s_hi),
                                       s_hi - s_lo))[:, :, None]
    nv = u.shape[-1]
    u_lo = torch.gather(u, 1, idx_lo[:, :, None].expand(-1, -1, nv))
    u_hi = torch.gather(u, 1, idx[:, :, None].expand(-1, -1, nv))
    interp = (1.0 - w) * u_lo + w * u_hi
    left = u[:, 0:1, :].expand_as(u)
    out = torch.where((idx == 0)[:, :, None], left, interp)
    above = (new_s > 0.0)[:, :, None]
    if operators.is_put(option_type):
        out = torch.where(above, out, left)
    else:
        out = torch.where(above, out, torch.zeros_like(out))
    if barrier is not None and barrier.knock_top:
        out = torch.cat([out[:, :-1], torch.zeros_like(out[:, -1:])], 1)
    return out


def _engine(solver: SolverConfig) -> str:
    """The banded engine of the eager loop: "scan" stands in for "pallas"
    (heston_tpu/models/douglas.py:293-296); anything but "scan" and "pcr"
    raises ValueError in the solves."""
    return "scan" if solver.solver_engine == "pallas" else solver.solver_engine


def _time_factors(b_rate, dt: float, n: int, like: torch.Tensor):
    """(e^{b_rate dt (n-1)}, e^{b_rate dt n}): host floats for a float
    rate, tensors for a tensor one (a rate carrying a tangent)."""
    if isinstance(b_rate, torch.Tensor):
        rate = b_rate.to(like.dtype) * dt
        return torch.exp(rate * (n - 1.0)), torch.exp(rate * float(n))
    rate = b_rate * dt
    return math.exp(rate * (n - 1.0)), math.exp(rate * float(n))


def _solve_s(fac, rhs, engine):
    """(I - td A1)^{-1} rhs along s of surfaces [B, ns, nv]."""
    return banded.tridiag_solve(fac, rhs.transpose(-1, -2),
                                engine).transpose(-1, -2)


def _solve_v(fac, rhs, engine):
    """(I - td A2)^{-1} rhs along v of surfaces [B, ns, nv]."""
    return banded.penta_solve(fac, rhs.transpose(-1, -2),
                              engine).transpose(-1, -2)


def _do_step(n: int, u, lam, inst: PreparedInstance, solver: SolverConfig,
             b_rate, american: bool, projected: bool = False):
    """One ADI step of a book, n the 1-based step index of the phase
    (heston_tpu/models/douglas.py:275-387): Douglas, Craig–Sneyd, modified
    Craig–Sneyd or Hundsdorfer–Verwer (`solver.scheme`); `b_rate` scales
    the boundary vectors through time. American books take the
    Ikonen–Toivanen update with lambda(s_max) = 0, or (`projected`, the
    digitals) the static pin of full-payoff nodes and the box projection
    onto [payoff, 1]."""
    ops = inst.ops
    dt = solver.delta_t
    theta = solver.theta
    engine = _engine(solver)
    e_nm1, e_n = _time_factors(b_rate, dt, n, u)

    a0r = operators.a0_multiply(ops, u)
    a1r = operators.a1_multiply(ops, u)
    a2r = operators.a2_multiply(ops, u)

    def stage_solves(y0_stage):
        rhs1 = y0_stage + theta * dt * (
            inst.b1 * e_n - (a1r + inst.b1 * e_nm1))
        y1 = _solve_s(inst.a1_fac, rhs1, engine)
        rhs2 = y1 + theta * dt * (inst.b2 * e_n - (a2r + inst.b2 * e_nm1))
        return _solve_v(inst.a2_fac, rhs2, engine)

    y0 = u + dt * (a0r + a1r + a2r + ops.b * e_nm1)
    if american:
        y0 = y0 + dt * lam
    y2 = stage_solves(y0)

    if solver.scheme == "cs":
        a0_y2 = operators.a0_multiply(ops, y2)
        u_bar = stage_solves(y0 + 0.5 * dt * (a0_y2 - a0r))
    elif solver.scheme == "mcs":
        a0_y2 = operators.a0_multiply(ops, y2)
        a1_y2 = operators.a1_multiply(ops, y2)
        a2_y2 = operators.a2_multiply(ops, y2)
        y0_hat = y0 + theta * dt * (a0_y2 - a0r)
        full_new = a0_y2 + a1_y2 + a2_y2 + ops.b * e_n
        full_old = a0r + a1r + a2r + ops.b * e_nm1
        u_bar = stage_solves(y0_hat + (0.5 - theta) * dt
                             * (full_new - full_old))
    elif solver.scheme == "hv":
        # second-stage corrections anchored at y2: the t_n boundary
        # terms cancel inside both
        a0_y2 = operators.a0_multiply(ops, y2)
        a1_y2 = operators.a1_multiply(ops, y2)
        a2_y2 = operators.a2_multiply(ops, y2)
        full_new = a0_y2 + a1_y2 + a2_y2 + ops.b * e_n
        full_old = a0r + a1r + a2r + ops.b * e_nm1
        y0_tilde = y0 + 0.5 * dt * (full_new - full_old)
        y1t = _solve_s(inst.a1_fac, y0_tilde - theta * dt * a1_y2, engine)
        u_bar = _solve_v(inst.a2_fac, y1t - theta * dt * a2_y2, engine)
    elif solver.scheme == "do":
        u_bar = y2
    else:
        raise ValueError(f"unknown scheme: {solver.scheme!r}")

    if not american:
        return u_bar, lam
    if projected:
        # r_d >= 0: exercise is optimal wherever the payoff is 1 — pin
        # those nodes, box the rest onto [payoff, 1]; lambda stays 0
        pin = inst.u0 == 1.0
        return torch.where(pin, inst.u0, torch.minimum(
            torch.maximum(u_bar, inst.u0), torch.ones_like(u_bar))), lam
    # maximum, not clamp: its tangent splits at ties, as jnp.maximum's
    u_new = torch.maximum(u_bar - dt * lam, inst.u0)
    lam_new = lam + (inst.u0 - u_bar) / dt
    lam_new = torch.maximum(lam_new, torch.zeros_like(lam_new))
    lam_new = torch.cat([lam_new[:, :-1], torch.zeros_like(lam_new[:, -1:])],
                        1)                      # lambda(s_max) = 0
    return u_new, lam_new


def _schedule(solver: SolverConfig, dividends, spans=None):
    """The time loop's actions in order, expanded from the kernels' launch
    plan (fused_do.phase_plan, one schedule for every engine; the JAX
    package's _phase_plan and _loop_views, heston_tpu/models/douglas.py:
    390-529): ('div', amount, pct) re-maps and ('step', damp, segment, k)
    local steps. The damp phase runs the Rannacher sub-steps k = 1..2R
    (Douglas, theta = 1, dt/2), the main phase steps R+1..N; a dividend of
    main step n fires before its first local step; `spans` (a curve's
    main-step ranges) split both phases at the segment boundaries."""
    for ph in fused_do.phase_plan(solver, dividends, segments=spans):
        for k in range(ph["first_step"], ph["last_step"] + 1):
            for step, amount, pct in ph["events"]:
                if step == k:
                    yield ("div", amount, pct)
            yield ("step", ph["damp"], ph["segment"], k)


def _loop_views(inst: PreparedInstance, solver: SolverConfig, b_rate,
                option_type: str, rate_schedule):
    """(spans, views) of the loop: the rate segments' main-step ranges
    (None at flat rates) and views[(damp, segment)] = (instance view,
    solver view, boundary rate), each segment with its own operator set
    and boundary rate, the damp views with the damped factors."""
    if rate_schedule is None:
        segs, spans = [(inst, b_rate)], None
    else:
        structure = _segment_structure(solver, rate_schedule, option_type)
        if len(inst.rate_segments) != len(structure):
            raise ValueError(
                "PreparedInstance was built with a different rate schedule "
                f"({len(inst.rate_segments)} operator segments vs "
                f"{len(structure)} in the plan) — rebuild it via "
                "prepare_instance(..., rate_schedule=...)")
        segs = [(inst._replace(ops=seg.ops, b1=seg.b1, b2=seg.b2,
                               a1_fac=seg.a1_fac, a2_fac=seg.a2_fac,
                               damp=seg.damp), st[4])
                for st, seg in zip(structure, inst.rate_segments)]
        spans = [st[:2] for st in structure]
    views = {}
    for si, (main, br) in enumerate(segs):
        views[(False, si)] = (main, solver, br)
        if main.damp is not None:
            views[(True, si)] = (
                main._replace(a1_fac=main.damp.a1_fac,
                              a2_fac=main.damp.a2_fac),
                solver.damping_solver(), br)
    if solver.rannacher_steps and (True, 0) not in views:
        raise ValueError(
            "solver.rannacher_steps > 0 but the PreparedInstance has no "
            "damping operators — it was prepared with a different solver; "
            "rebuild it via prepare_instance(spec, solver, ...)")
    return spans, views


def _run(inst, solver, b_rate, american, dividends, option_type,
         rate_schedule, track):
    """The time loop; with `track`, also every full-dt state."""
    spans, views = _loop_views(inst, solver, b_rate, option_type,
                               rate_schedule)
    projected = operators.is_digital(option_type)
    u, lam = inst.u0, torch.zeros_like(inst.u0)
    hist = [(u, lam)] if track else None
    for act in _schedule(solver, dividends, spans):
        if act[0] == "step":
            _, damp, si, k = act
            view, sol, br = views[(damp, si)]
            u, lam = _do_step(k, u, lam, view, sol, br, american, projected)
            if track and not (damp and k % 2):
                hist.append((u, lam))
        else:
            _, amount, pct = act
            u = apply_dividend(u, inst.grid.vec_s, amount, pct, option_type,
                               inst.barrier)
    return (u, lam), hist


def run_time_loop(inst: PreparedInstance, solver: SolverConfig, b_rate,
                  american: bool = False,
                  dividends: Optional[DividendSchedule] = None,
                  option_type: str = "call", with_lambda: bool = False,
                  rate_schedule=None):
    """Every step of the plan (Rannacher sub-steps, dividend re-maps,
    rate segments) from the payoff (heston_tpu/models/douglas.py:574-631);
    the terminal surfaces [B, ns, nv], or (u, lambda) with `with_lambda`
    (the American multiplier the theta epilogue reads). `b_rate` scales
    the boundary vectors through time (operators.boundary_rate); a
    `rate_schedule`'s segments carry their own."""
    (u, lam), _ = _run(inst, solver, b_rate, american, dividends,
                       option_type, rate_schedule, track=False)
    return (u, lam) if with_lambda else u


def solve_with_tracking(inst: PreparedInstance, solver: SolverConfig,
                        b_rate, american: bool = False,
                        dividends: Optional[DividendSchedule] = None,
                        option_type: str = "call", rate_schedule=None):
    """The time loop recording the surfaces and multipliers after every
    step (heston_tpu/models/douglas.py:634-690): (surfaces, lambdas), each
    [B, N+1, ns, nv], index 0 the payoff. A damped window records every
    second sub-step, the full-dt boundaries, so the count stays N+1."""
    _, hist = _run(inst, solver, b_rate, american, dividends, option_type,
                   rate_schedule, track=True)
    return (torch.stack([h[0] for h in hist], 1),
            torch.stack([h[1] for h in hist], 1))


# ---------------------------------------------------------------------------
# the eager engine: entry points
# ---------------------------------------------------------------------------

def _validate_barrier_book(spec: GridSpec, s0, strikes) -> None:
    """A barrier book the grid cannot hold raises ValueError
    (grid.validate_book), on concrete inputs, before anything runs
    (heston_tpu/models/douglas.py:693-710); callers that transform the
    pricer validate before transforming."""
    if spec.barrier is not None:
        gridmod.validate_book(spec, float(s0), strikes)


def _extract(u, inst: PreparedInstance):
    """Price [B] at each option's spot node and the v0 node."""
    return u[torch.arange(u.shape[0], device=u.device), inst.idx_s,
             inst.idx_v]


def _solve(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
           american, dividends, option_type, rate_schedule):
    """(terminal surfaces [B, ns, nv], instance) of `strikes` [B] on the
    eager loop (no validation)."""
    inst = prepare_instance(spec, solver, strikes, s0, kappa, eta, sigma,
                            rho, v0, r_d, r_f, option_type, rate_schedule)
    u = run_time_loop(inst, solver,
                      operators.boundary_rate(r_d, r_f, option_type),
                      american, dividends, option_type,
                      rate_schedule=rate_schedule)
    return u, inst


def _price(*args):
    """Prices [B] of a book on the eager loop (`_solve`'s arguments)."""
    return _extract(*_solve(*args))


def _price_and_v0_stencil(spec, solver, strikes, s0, kappa, eta, sigma, rho,
                          v0, r_d, r_f, american, dividends, option_type,
                          rate_schedule):
    """(prices [B], dP/dv0 [B]) of `strikes` [B] (no validation)."""
    u, inst = _solve(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
                     r_d, r_f, american, dividends, option_type,
                     rate_schedule)
    vv = inst.grid.vec_v
    rows = torch.arange(u.shape[0], device=u.device)
    j = torch.clamp(inst.idx_v, 1, spec.m2 - 1)
    h0 = vv[j] - vv[j - 1]
    h1 = vv[j + 1] - vv[j]
    bm, b0, bp = coeff.w_beta(h0, h1)
    dm, d0, dp = coeff.w_delta(h0, h1)
    col = [u[rows, inst.idx_s, jj] for jj in (j - 1, j, j + 1)]
    first = bm * col[0] + b0 * col[1] + bp * col[2]
    second = dm * col[0] + d0 * col[1] + dp * col[2]
    return _extract(u, inst), first + second * (v0 - vv[j])


def _book(strike, device):
    """(strikes [B] on the device, shape to return)."""
    strikes = as_strikes(strike, resolve_device(device))
    return strikes.reshape(-1), strikes.shape


def price_option(spec: GridSpec, solver: SolverConfig, strike, s0, kappa,
                 eta, sigma, rho, v0, r_d, r_f, american: bool = False,
                 dividends: Optional[DividendSchedule] = None,
                 option_type: str = "call", rate_schedule=None,
                 device=None) -> torch.Tensor:
    """Prices of options on the eager loop (heston_tpu/models/douglas.py:
    713-770): a strike gives a 0-d tensor, a tensor of strikes a tensor of
    prices (the book batched, where the JAX package vmaps). "scan" stands
    in for "pallas". A `rate_schedule` replaces the scalar r_d, r_f. The
    strikes go to `device` (None: the card); the dtype is theirs."""
    strikes, shape = _book(strike, device)
    _validate_barrier_book(spec, s0, strikes)
    return _price(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
                  r_d, r_f, american, dividends, option_type,
                  rate_schedule).reshape(shape)


def price_and_v0_stencil(spec: GridSpec, solver: SolverConfig, strike, s0,
                         kappa, eta, sigma, rho, v0, r_d, r_f,
                         american: bool = False,
                         dividends: Optional[DividendSchedule] = None,
                         option_type: str = "call", rate_schedule=None,
                         device=None):
    """(price, dPrice/dv0) from one solve (heston_tpu/models/douglas.py:
    773-820): v0 enters the discrete price only through the grid, so dP/dv0
    is dU/dv at (s0, v0), the discretization's 3-point v-stencil at the
    inserted v0 node, centred on the clipped interior node and evaluated
    at v0. Shapes and device as in `price_option`."""
    strikes, shape = _book(strike, device)
    _validate_barrier_book(spec, s0, strikes)
    price, dv = _price_and_v0_stencil(
        spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american, dividends, option_type, rate_schedule)
    return price.reshape(shape), dv.reshape(shape)


def price_surface(spec: GridSpec, solver: SolverConfig, strike, s0,
                  params: HestonParams, american: bool = False,
                  dividends: Optional[DividendSchedule] = None,
                  option_type: str = "call", rate_schedule=None,
                  device=None):
    """(terminal surfaces [B, ns, nv], grid) of a book of strikes [B] (a
    scalar strike is a book of one; heston_tpu/models/douglas.py:823-843,
    which returns one [nv, ns] surface)."""
    strikes, _ = _book(strike, device)
    _validate_barrier_book(spec, s0, strikes)
    u, inst = _solve(spec, solver, strikes, s0, params.kappa, params.eta,
                     params.sigma, params.rho, params.v0, params.r_d,
                     params.r_f, american, dividends, option_type,
                     rate_schedule)
    return u, inst.grid


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


def group_solver(solver: SolverConfig, n) -> SolverConfig:
    """A maturity group's solver at the book's dt (T = n * dt;
    heston_tpu/models/greeks.py:74, :512, :549); the book's own for n
    None. calibration._group_solver is the calibration module's: the JAX
    package derives T there as T * n / N, which may differ in the last
    bit."""
    if n is None:
        return solver
    return dataclasses.replace(solver, n_steps=n, maturity=n * solver.delta_t)


def group_dividends(solver: SolverConfig,
                    dividends: Optional[DividendSchedule], n):
    """The dividend events of the book's steps 1..n (at the book's dt),
    dated k * dt_g on the step axis of `group_solver(solver, n)`, so each
    falls on the step the book's dt gives it, as the batched kernel and
    the reference apply it. n * dt rounds, so dt_g can sit an ulp from dt
    and move an event on a step boundary by a step (a dividend at 0.2 at
    dt = 0.05: step 3 instead of 4 in a group of 6 steps). The schedule
    as it is for n None."""
    if dividends is None or n is None:
        return dividends
    dt_g = group_solver(solver, n).delta_t
    events = [(k, amount, pct) for k in range(1, n + 1)
              for amount, pct in dividends.events_for_step(k, solver.delta_t)]
    return DividendSchedule(dates=tuple(k * dt_g for k, _, _ in events),
                            amounts=tuple(a for _, a, _ in events),
                            percentages=tuple(p for _, _, p in events))


@scope("price_batch")
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
    group_steps=(),
) -> torch.Tensor:
    """Prices [B] of a book of options at `strikes` [B], one shared spot,
    model and schedule. The strikes go to `device` (None: the card; "cpu"
    runs the plain version of the kernel); the dtype is the strikes'.

    group_steps: optional (start, end, n_steps) slices of a mixed-maturity
    book, in order and covering it, under the shared-dt convention
    T_i = n_i * solver.delta_t with n_i in 1..solver.n_steps (as
    `greeks.batch_greeks`). Under "pallas" the whole book, a batch of one
    included, runs on the batched kernel: one `fused_do.book_plan` and
    one launch a phase, each option stopping at its own count. "scan" and
    "pcr" run the eager loop one group at a time (`group_solver`, the
    dividends on the book's step axis, `group_dividends`). Not with
    `rate_schedule` (ValueError).

    Dispatch as in the JAX package (heston_tpu/models/douglas.py:
    846-899): under "pallas", a batch of one at flat rates and without
    groups whose grid fits the latency kernel (`fused_single.use_single`)
    goes through `fused_single.fused_price_single`, every other book, a
    curve book of one (`rate_schedule`) included, through the batched
    `fused_do.fused_price_batch`; a kernel that fails to build or launch
    raises, and nothing falls back to the other route or to the eager
    loop. "scan" and "pcr" run the eager loop (`price_option` over the
    book). A barrier book is validated first (`grid.validate_book`,
    heston_tpu/models/douglas.py:693-709, :935): a knocked-out spot or one
    the grid cannot hold raises ValueError before anything runs."""
    strikes = as_strikes(strikes, resolve_device(device))
    _validate_barrier_book(spec, s0, strikes)
    if group_steps:
        if rate_schedule is not None:
            raise ValueError(
                "rate_schedule does not compose with group_steps: price a "
                "mixed-maturity curve book per maturity group")
        validate_group_steps(group_steps, int(strikes.shape[0]))
        if max(n for _, _, n in group_steps) > solver.n_steps:
            raise ValueError(
                f"group_steps' step counts must lie in 1..solver.n_steps "
                f"({solver.n_steps}); got {tuple(group_steps)}")
    if solver.solver_engine != "pallas":
        model = (s0, kappa, eta, sigma, rho, v0, r_d, r_f, american)
        if group_steps:
            return torch.cat([_price(
                spec, group_solver(solver, n), strikes[a:e], *model,
                group_dividends(solver, dividends, n), option_type, None)
                for a, e, n in group_steps])
        return _price(spec, solver, strikes, *model, dividends, option_type,
                      rate_schedule)
    if (not group_steps and rate_schedule is None
            and fused_single.use_single(spec, solver, strikes.shape[0])):
        return fused_single.fused_price_single(
            spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d,
            r_f, american=american, dividends=dividends,
            option_type=option_type)
    return fused_do.fused_price_batch(
        spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american=american, dividends=dividends, option_type=option_type,
        n_steps_per=lane_steps(group_steps), rate_schedule=rate_schedule)


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

"""The inputs both time-loop kernels read (the Python side of
csrc/plan.cuh) and the one home of what both must agree on. The kernel
layer, from the bottom: `ops/`; this module and `kernels.cuda_build`
(how a kernel is built and called); kernel 1 (`kernels.fused_do`, a
book) and kernel 2 (`kernels.fused_single`, one option), which do not
import each other; `models/`.

Field layout (batch first, one row per option):
  big fields      [B, ns, nv]   (s-major per option; ns = m1+1, nv = m2+1)
  s-fields        [B, ns]
  v-fields        [B, nv]
  scalars         [B]
where the JAX package uses [ns, nv, B] / [n, B] / [1, B] (see
heston_tpu_torch.convert.fields_from_jax).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from heston_tpu_torch.config import DividendSchedule, GridSpec, SolverConfig
from heston_tpu_torch.ops import coeff
from heston_tpu_torch.ops import grid as gridmod
from heston_tpu_torch.ops import operators
from heston_tpu_torch.utils.profiling import scope

# the fields of the JAX package's _assemble (the time loop reads all but
# bs0 and bv0: its stencils are in difference form, the centre weight is
# implied)
BIG_KEYS = ("u", "lam")
S_KEYS = ("a1pl", "a1ql", "a1pd", "a1qd", "a1pu", "a1qu", "sfac",
          "bsm", "bs0", "bsp", "b2r", "vecs")
V_KEYS = ("vfl", "vfac", "bvm", "bv0", "bvp", "al2", "al1", "ad", "au1",
          "au2")
SCALAR_KEYS = ("b1v", "kk")

# packing order of both kernels' coefficient rows — must match the SField
# / VField enums of csrc/fused_do.cu and csrc/fused_single.cu
KERNEL_S_KEYS = ("a1pl", "a1ql", "a1pd", "a1qd", "a1pu", "a1qu", "sfac",
                 "bsm", "bsp", "b2r", "vecs")
KERNEL_V_KEYS = ("vfl", "vfac", "bvm", "bvp", "al2", "al1", "ad", "au1",
                 "au2")
# time-loop schemes, in the order of the kernels' Scheme enum: Douglas,
# Craig-Sneyd, modified Craig-Sneyd, Hundsdorfer-Verwer
SCHEMES = ("do", "cs", "mcs", "hv")


def check_scheme(scheme: str) -> None:
    """Raise ValueError for a scheme outside SCHEMES."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; want one of {SCHEMES}")


def check_slice(spec: GridSpec, solver: SolverConfig, option_type: str,
                n_steps_per=None, strikes=None):
    """Raise ValueError for a scheme outside SCHEMES, an unknown payoff
    or malformed step counts: the one gate of both routes (the batched
    kernel and the single-option one). Every flag of the time loop is
    ported; what the JAX package routes off the fused kernels (the other
    engines, the Jacobian of a curve book) is refused by the entry
    points.

    `n_steps_per`: optional per-option step counts of a mixed-maturity
    book of `strikes` [B] under the shared-dt convention T_i = n_i * dt
    (heston_tpu/pallas/fused_do.py:1860-1862): B integers in
    1..solver.n_steps, else ValueError (a shard of a mixed book may hold
    only its shorter maturities; the launch runs solver.n_steps steps and
    each option stops at its own count). Returns them as an int64 tensor
    [B] on the host (None for a uniform book)."""
    check_scheme(solver.scheme)
    operators.is_put(option_type)        # ValueError for an unknown name
    if n_steps_per is None:
        return None
    nst = torch.as_tensor(n_steps_per).detach().to("cpu")
    if (nst.dim() != 1 or nst.numel() == 0
            or tuple(nst.shape) != tuple(strikes.shape)):
        raise ValueError(f"n_steps_per must hold one step count per "
                         f"option {tuple(strikes.shape)}, got shape "
                         f"{tuple(nst.shape)}")
    if nst.is_floating_point() and bool((nst != torch.round(nst)).any()):
        raise ValueError(f"n_steps_per must be integers, got {nst.tolist()}")
    nst = nst.to(torch.int64)
    if int(nst.min()) < 1 or int(nst.max()) > solver.n_steps:
        raise ValueError(
            f"n_steps_per must lie in 1..solver.n_steps "
            f"({solver.n_steps}), got min {int(nst.min())}, max "
            f"{int(nst.max())}")
    return nst


def barrier_positions(spec: GridSpec) -> tuple:
    """The knocked s columns of a knock-out spec: (m1,) up-out, (0,)
    down-out, (0, m1) double-out, () without a barrier
    (heston_tpu/pallas/fused_do.py:214-222)."""
    b = spec.barrier
    if b is None:
        return ()
    return tuple(p for p, k in ((0, b.knock_bottom), (spec.m1, b.knock_top))
                 if k)


def n_react(option_type: str, knocked, ns: int, nv: int) -> int:
    """`operators.n_react` of a launch whose knocked s columns are
    `knocked`: a knock at column ns - 1 is a top knock."""
    return operators.n_react(option_type, (ns - 1) in knocked, nv)


def remaps_apart(option_type: str, knocked) -> bool:
    """True when a dividend remaps u and its compensation separately (puts
    and barriers: mass at column 0 or at the knock, where folding costs
    ~3x the arm's f32 error, heston_tpu/pallas/fused_do.py:1221-1232);
    False when the compensation folds into u first. The one owner of that
    choice: the plain version reads it and kernel 1 takes it as a launch
    argument."""
    return operators.is_put(option_type) or bool(knocked)


def exercise_floor(vecs, kk, option_type: str, knocked=()):
    """The American floor [..., ns] a launch rebuilds from the s-grid
    `vecs` [..., ns] and the strikes `kk` [...]: the call or put
    intrinsic floored at 0, or a digital's clipped cell average
    (operators.grid_payoff), zero at the knocked columns
    (heston_tpu/pallas/fused_do.py:506-534)."""
    row = operators.grid_payoff(vecs, kk[..., None], option_type)
    if knocked:
        row = row.clone()
        row[..., list(knocked)] = 0.0
    return row


def two_sum(a, b):
    """Knuth 2Sum: s = fl(a + b) and err = a + b - s exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def penta_factors(f, td: float):
    """The factorization of I - td*A2 along v that both plain versions
    run, from the bands f["al2"] .. f["au2"] [..., nv]: (m, gm, hm, c, c2),
    each a list of nv [...] rows."""
    c1p = c2p = cc1p = cc2p = torch.zeros_like(f["ad"][..., 0])
    rows = []
    for j in range(f["ad"].shape[-1]):
        il2 = -td * f["al2"][..., j]
        il1 = -td * f["al1"][..., j]
        idd = 1.0 - td * f["ad"][..., j]
        iu1 = -td * f["au1"][..., j]
        iu2 = -td * f["au2"][..., j]
        big_l = il1 - il2 * c2p
        m = 1.0 / (idd - big_l * c1p - il2 * cc2p)
        c = (iu1 - big_l * cc1p) * m
        c2 = iu2 * m
        rows.append((m, big_l * m, il2 * m, c, c2))
        c1p, c2p, cc1p, cc2p = c, c1p, c2, cc1p
    return [list(x) for x in zip(*rows)]


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------

def prepare_batched(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
                    r_d, r_f, nsteps=None, epilogue=False,
                    option_type="call", anchor=None):
    """Grid and operator assembly of a book of `option_type` options on
    `spec` (with its knock-out barrier, if any), batched over `strikes`
    [B]; `nsteps` (optional, [B]): per-option step counts, which scale
    each option's boundary data by its own e^{-rate dt (n_i - 1)}
    (heston_tpu/pallas/fused_do.py:1362-1438); `epilogue`: also build the
    operator set's dense fields (operators.build_operators); `anchor`: a
    rate segment's boundary anchor in place of that factor
    (operators.rate_segment_structure).

    Returns (u0 [B, ns], (a1pl, a1ql, a1pd, a1qd, a1pu, a1qu) [B, ns],
    scol [B, ns], vrow [nv], b1val [B], b2row [B, ns], grid, ops,
    idx_s [B], idx_v []) — the counterpart of the vmapped `one` of
    heston_tpu.pallas.fused_do._prepare_batched for flat-rate books."""
    g = gridmod.make_grid(spec, s0, strikes, v0)
    nsf = (torch.full_like(strikes, float(solver.n_steps)) if nsteps is None
           else nsteps.to(strikes.dtype))
    ops = operators.build_operators(g, kappa, eta, sigma, rho, r_d, r_f,
                                    solver.delta_t, nsf, solver.a2_variant,
                                    option_type, epilogue=epilogue,
                                    barrier=spec.barrier, anchor=anchor)
    u0 = operators.grid_payoff(g.vec_s, strikes[:, None], option_type)
    if spec.barrier is not None:
        # knocked at expiry too: Dirichlet 0 from the payoff onward
        u0 = spec.barrier.mask_payoff(u0)
    # separable A0 coefficient rho*sigma*s (cols 1..m1-1) x v (rows
    # 1..m2-1)
    scol = rho * sigma * g.vec_s
    scol[:, 0] = 0.0
    scol[:, -1] = 0.0
    vrow = g.vec_v.clone()
    vrow[0] = 0.0
    vrow[-1] = 0.0
    # rank-2 form of the explicit A1 bands: A1[i, j] = v_j * P[i] + Q[i];
    # row 0 zero (calls) or the -r_d/2 reaction of the put far field
    # K e^{-r_d tau}, row m1 only the -r_d/2 reaction
    m1 = spec.m1
    h0 = g.dels[:, : m1 - 1]
    h1 = g.dels[:, 1:m1]
    dm, d0, dp = coeff.w_delta(h0, h1)
    bm, b0, bp = coeff.w_beta(h0, h1)
    s_int = g.vec_s[:, 1:m1]
    a = 0.5 * s_int * s_int
    bb = (r_d - r_f) * s_int
    zcol = torch.zeros_like(s_int[:, :1])

    def cat(left, mid, right):
        return torch.cat([zcol + left, mid, zcol + right], dim=1)

    q_left = -0.5 * r_d if operators.is_put(option_type) else 0.0
    a1pq = (cat(0.0, a * dm, 0.0), cat(0.0, bb * bm, 0.0),
            cat(0.0, a * d0, 0.0),
            cat(q_left, bb * b0 - 0.5 * r_d, -0.5 * r_d),
            cat(0.0, a * dp, 0.0), cat(0.0, bb * bp, 0.0))
    # boundary data: b1 scalar + top-v-row values, scaled through time at
    # the calls' boundary rate r_f; zeros for the injection-free payoffs
    # and top-knocked barriers
    b1val, b2row = operators.boundary_data(g, r_d, r_f, solver.delta_t, nsf,
                                           option_type, spec.barrier, anchor)
    idx_s = gridmod.find_node(g.vec_s, s0)
    idx_v = gridmod.find_node(g.vec_v, v0)
    return u0, a1pq, scol, vrow, b1val, b2row, g, ops, idx_s, idx_v


@scope("assemble")
def assemble(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d,
             r_f, nsteps=None, epilogue=False, option_type="call",
             anchor=None):
    """Every time-loop input field of a book of `option_type` options
    (batch first, see the module docstring) plus the grids, the extraction
    indices and the operator set. `nsteps` (optional, [B] integers):
    per-option step counts, carried as the field "nst"; `epilogue`: the
    operator set with its dense fields, for book risk
    (heston_tpu/pallas/fused_do.py:1571-1613); `anchor`: a rate segment's
    boundary anchor (`prepare_batched`). Counts each assembly in
    `assemble.calls` (one under `_linearized_assemble`'s vmap over jvp).

    Returns (fields, vec_s [B, ns], idx_s [B], idx_v [B], ops)."""
    assemble.calls += 1
    (u0, a1pq, scol, vrow, b1val, b2row, g, ops, idx_s, idx_v
     ) = prepare_batched(spec, solver, strikes, s0, kappa, eta, sigma,
                         rho, v0, r_d, r_f, nsteps, epilogue, option_type,
                         anchor)
    b, ns = g.vec_s.shape
    nv = g.vec_v.shape[0]

    def per_option(x):          # shared [nv] v-field -> [B, nv]
        return x.expand(b, nv).contiguous()

    u = u0[:, :, None].expand(b, ns, nv).contiguous()
    fields = dict(
        u=u, lam=torch.zeros_like(u),
        a1pl=a1pq[0], a1ql=a1pq[1], a1pd=a1pq[2], a1qd=a1pq[3],
        a1pu=a1pq[4], a1qu=a1pq[5],
        vfl=per_option(g.vec_v), sfac=scol, vfac=per_option(vrow),
        bsm=ops.bs_wm, bs0=ops.bs_w0, bsp=ops.bs_wp,
        bvm=per_option(ops.bv_wm), bv0=per_option(ops.bv_w0),
        bvp=per_option(ops.bv_wp),
        al2=per_option(ops.a2_l2), al1=per_option(ops.a2_l1),
        ad=per_option(ops.a2_d), au1=per_option(ops.a2_u1),
        au2=per_option(ops.a2_u2),
        b1v=b1val, b2r=b2row, vecs=g.vec_s, kk=strikes.clone(),
    )
    if nsteps is not None:
        fields["nst"] = nsteps
    return fields, g.vec_s, idx_s, idx_v.expand(b), ops


assemble.calls = 0


def assemble_rate_segments(spec, solver, strikes, s0, kappa, eta, sigma,
                           rho, v0, rate_schedule, nsteps=None,
                           epilogue=False, option_type="call"):
    """One `assemble` per segment of a `config.RateSchedule`
    (operators.rate_segment_structure), each at its segment's (r_d, r_f,
    anchor): the counterpart of heston_tpu/pallas/fused_do.py:1797-1822.
    Returns (segments, vec_s, idx_s, idx_v, ops) with segments a list of
    (n_lo, n_hi, b_rate, fields): the main steps the segment covers, its
    boundary rate and its fields (segment 0's carry the launch state: the
    payoff is rate-free); ops is the last segment's operator set, at
    valuation time tau = T (with the dense fields under `epilogue`: the
    theta epilogue of book risk reads it). Per-lane step counts raise
    ValueError: one calendar curve maps to other step windows per
    maturity."""
    if nsteps is not None:
        raise ValueError(
            "rate_schedule does not compose with per-lane step counts: "
            "price a mixed-maturity curve book per maturity group")
    structure = operators.rate_segment_structure(
        solver.n_steps, solver.delta_t, solver.maturity, rate_schedule,
        option_type)
    segments = []
    for k, (n_lo, n_hi, rd, rf, br, anchor) in enumerate(structure):
        fields, vec_s, idx_s, idx_v, ops = assemble(
            spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, rd, rf,
            epilogue=epilogue and k == len(structure) - 1,
            option_type=option_type, anchor=anchor)
        segments.append((n_lo, n_hi, br, fields))
    return segments, vec_s, idx_s, idx_v, ops


def dividend_plan(solver: SolverConfig,
                  dividends: Optional[DividendSchedule]):
    """(step, amount, pct) for every dividend event, in processing order:
    the events of step n (1-based; window n*dt <= date < (n+1)*dt,
    DividendSchedule.events_for_step) are applied before step n runs."""
    return _events(solver, dividends, 1, solver.n_steps, lambda n: n)


def _events(solver, dividends, n_lo, n_hi, to_local):
    """(to_local(n), amount, pct) for the events of main steps
    n_lo..n_hi, in processing order."""
    if dividends is None:
        return []
    return [(to_local(n), amount, pct)
            for n in range(n_lo, n_hi + 1)
            for amount, pct in dividends.events_for_step(n, solver.delta_t)]


def phase_plan(solver: SolverConfig,
               dividends: Optional[DividendSchedule], nsteps=None,
               segments=None):
    """The launches of one time loop, shared by both kernels: the optional
    Rannacher start-up phase, then the main phase
    (heston_tpu/pallas/fused_do.py:1692-1723), each split at the rate
    segments' boundaries.

    With R = min(rannacher_steps, n_steps) > 0, the damp phase runs main
    steps 1..R as Douglas at theta = 1 and delta_t / 2, local sub-steps
    2n-1 and 2n for main step n; the main phase runs local steps
    R+1..n_steps at the solver's theta and delta_t. The boundary fields
    stay the main phase's, so the damp sub-steps' e^{rate*(dt/2)*k} land
    on the same absolute times. The dividend events of main step n are
    applied before its first local step (to_local, as
    _chunk_dividend_plan maps them, heston_tpu/pallas/fused_do.py:
    1532-1566).

    `nsteps` (optional, [B] integers): the per-option step counts of a
    mixed-maturity book (heston_tpu/pallas/fused_do.py:1703-1723). Lane i
    runs 2*min(n_i, R) damp sub-steps and main steps R+1..n_i, so a lane
    with n_i <= R runs no main step; the events keep their shared local
    steps.

    `segments` (optional): the main-step ranges [(n_lo, n_hi)] of a rate
    curve's segments, ascending over 1..n_steps (a flat book is one
    segment). Each phase window is split at their boundaries into
    pieces, one launch each, the damp phase in its local steps too
    (heston_tpu/pallas/fused_do.py:1728-1742); a piece holds the events
    of its own main steps (heston_tpu/pallas/fused_do.py:1745-1749).

    Returns a list of dicts, one per launch: theta, delta_t, scheme (the
    damp phase is always Douglas, the main phase runs solver.scheme;
    heston_tpu/pallas/fused_do.py:1715-1720), damp (whether the launch
    belongs to the damp phase), first_step and last_step
    (the launch's local steps, inclusive), events [(local step, amount,
    pct)] in processing order, nst, each lane's last local step of the
    phase ([B], None for a uniform book), and segment, the index of the
    launch's rate segment. The state crosses launches as u + comp (folded
    at the end of a launch) and lambda unscaled."""
    n = solver.n_steps
    r = min(solver.rannacher_steps, n) if solver.rannacher_steps else 0
    windows = []
    if r:
        windows.append((1, r, lambda k: 2 * k - 1, dict(
            theta=1.0, delta_t=solver.delta_t / 2.0, scheme="do", damp=True,
            nst=None if nsteps is None else 2 * torch.clamp(nsteps, max=r))))
    if r < n:
        windows.append((r + 1, n, lambda k: k, dict(
            theta=solver.theta, delta_t=solver.delta_t,
            scheme=solver.scheme, damp=False, nst=nsteps)))
    phases = []
    for lo_w, hi_w, to_local, phase in windows:
        for k, (s_lo, s_hi) in enumerate(segments or [(1, n)]):
            lo, hi = max(lo_w, s_lo), min(hi_w, s_hi)
            if lo <= hi:
                phases.append(dict(
                    phase, first_step=to_local(lo),
                    last_step=to_local(hi + 1) - 1,
                    events=_events(solver, dividends, lo, hi, to_local),
                    segment=k))
    return phases


def loop_kwargs(ph: dict, rf, american: bool, option_type: str,
                knocked) -> dict:
    """The loop keywords of the launch `ph` of `phase_plan`, for either
    kernel: every plan of a phase (both kernels', `plan_phases`) calls it."""
    return dict(theta=ph["theta"], delta_t=ph["delta_t"],
                scheme=ph["scheme"], first_step=ph["first_step"],
                n_steps=ph["last_step"], rf=rf, american=american,
                option_type=option_type, knocked=knocked)


@scope("remaps")
def build_remap_fields(vec_s, events, nsteps=None, option_type="call",
                       knocked=()):
    """Per event, the 2-point interpolation remap of the s axis of a book
    as (i0, w0, i1, w1), each [B, ns]: U_new[:, i] = w0[i]*U[:, i0[i]] +
    w1[i]*U[:, i1[i]] (ref: src/solver.hpp:382-425;
    heston_tpu/pallas/fused_do.py:1447-1526). i0/i1 are int64.
    `nsteps` (optional, [B]): each lane's last local step; a lane that
    stops before an event's step gets the identity row there (i0 = i1 =
    own column, w0 = 1, w1 = 0).

    The first strictly-greater node comes from searchsorted(right=True);
    an index past the top node maps to 0, and index 0 (left
    extrapolation) copies column 0. Calls zero the columns whose shifted
    spot new_s <= 0; puts (`option_type` put or digital_put) copy column
    0 there instead, since U(0) ~ K. A top-knocked barrier (ns - 1 in
    `knocked`) zeroes the weights of column ns-1, re-knocking it, before
    the frozen lanes' identity rows; a down-out needs nothing (its
    bottom node falls below the grid and copies column 0, itself zero).
    The weight pair is derived from whichever weight is >= 0.5, so 1 - w
    is exact (Sterbenz) and the pair sums to exactly 1 — the kernel's
    difference-form remap weights the column's own value implicitly by
    1 - w0 - w1."""
    m1 = vec_s.shape[1] - 1
    own = torch.arange(m1 + 1, device=vec_s.device).expand(vec_s.shape)
    fields = []
    for step, amount, pct in events:
        new_s = vec_s * (1.0 - pct) - amount
        idx = torch.searchsorted(vec_s, new_s, right=True)
        idx = torch.where(idx > m1, 0, idx)
        lo = torch.clamp(idx - 1, min=0)
        s_lo = torch.gather(vec_s, 1, lo)
        s_hi = torch.gather(vec_s, 1, idx)
        w = (new_s - s_lo) / torch.where(s_hi == s_lo,
                                         torch.ones_like(s_hi), s_hi - s_lo)
        valid = (torch.ones_like(new_s) if operators.is_put(option_type)
                 else (new_s > 0.0).to(vec_s.dtype))
        is_left = idx == 0
        i0 = torch.where(is_left, 0, lo)
        i1 = torch.where(is_left, 0, idx)
        w0i = 1.0 - w
        w1i = torch.where(w >= 0.5, w, 1.0 - w0i)
        w0 = valid * torch.where(is_left, torch.ones_like(w), w0i)
        w1 = valid * torch.where(is_left, torch.zeros_like(w), w1i)
        if m1 in knocked:
            w0[:, m1] = 0.0
            w1[:, m1] = 0.0
        if nsteps is not None:
            act = (nsteps >= step)[:, None]
            i0 = torch.where(act, i0, own)
            i1 = torch.where(act, i1, own)
            w0 = torch.where(act, w0, torch.ones_like(w0))
            w1 = torch.where(act, w1, torch.zeros_like(w1))
        fields.append((i0, w0, i1, w1))
    return fields


def run_phases(loop, fields, phases, tangents=None):
    """The state after every launch of a plan (`fused_do.book_phases`, or
    `fused_single.single_plan`'s), one call of `loop` (a kernel wrapper or
    its plain version) per launch, the state handed from each launch to
    the next: (u, lam), or with `tangents` (kernel 1's forward-mode loop)
    (u, lam, dus, dlams)."""
    state = dict(u=fields["u"], lam=fields["lam"])
    for steps, remaps, kw in phases:
        if tangents is None:
            state["u"], state["lam"] = loop({**fields, **state}, steps,
                                            remaps, **kw)
        else:
            state = dict(zip(("u", "lam", "du", "dlam"), loop(
                {**fields, **state}, steps, remaps, **kw,
                tangents=tangents)))
    return tuple(state.values())


# ---------------------------------------------------------------------------
# the plan kernels' ABI (csrc/plan.cuh): both kernels' plans on the card
# ---------------------------------------------------------------------------

# events a launch of a plan kernel takes (csrc/plan.cuh kPlanEvents); a
# longer schedule takes more launches of the same kernel
PLAN_EVENTS = 32
# phases a plan holds (kPlanPhases): the damp phase and the main one
PLAN_PHASES = 2
# knock-out kinds, in the order of the plan kernels' BarrierKind
PLAN_BARRIERS = (None, "up-out", "down-out", "double-out")


class PlanArgs(ctypes.Structure):
    # csrc/plan.cuh PlanArgs
    _fields_ = ([(k, ctypes.c_double) for k in (
        "s0", "kappa", "eta", "sigma", "rho", "v0", "r_d", "r_f",
        "s_max_mult", "c_mult", "v_max", "d_div", "delta_t", "b_level",
        "b_level_hi")]
        + [(k, ctypes.c_int) for k in (
            "m1", "m2", "n_steps", "payoff", "upwind", "barrier",
            "fields")])


class PlanEvents(ctypes.Structure):
    # csrc/plan.cuh PlanEvents
    _fields_ = [("amount", ctypes.c_double * PLAN_EVENTS),
                ("pct", ctypes.c_double * PLAN_EVENTS),
                ("step", ctypes.c_int * PLAN_EVENTS),
                ("first", ctypes.c_int), ("count", ctypes.c_int)]


class PlanPhases(ctypes.Structure):
    # csrc/plan.cuh PlanPhases
    _fields_ = [("first", ctypes.c_int * PLAN_PHASES),
                ("count", ctypes.c_int * PLAN_PHASES),
                ("damp", ctypes.c_int * PLAN_PHASES),
                ("n", ctypes.c_int), ("rannacher", ctypes.c_int)]


def market_buffer(market, device):
    """The market (s0, kappa, eta, sigma, rho, v0, r_d, r_f) as a plan
    kernel reads it: None when no value is a tensor (the kernel takes them
    by value), else every value in a float64 [8] on `device`, made there
    (a tensor cast on its device, a number filled in) so nothing is read
    back to the host."""
    if not any(isinstance(x, torch.Tensor) for x in market):
        return None
    return torch.stack([
        x.to(device=device, dtype=torch.float64).reshape(())
        if isinstance(x, torch.Tensor)
        else torch.full((), float(x), dtype=torch.float64, device=device)
        for x in market])


def plan_args(spec: GridSpec, solver: SolverConfig, market, buf,
              option_type: str) -> PlanArgs:
    """The plan kernels' Python numbers: the market by value (zeros where
    `buf`, its `market_buffer`, carries it), the grid, the barrier, the
    solver's dt and step count and the payoff. ValueError for an A2
    variant the plan does not build."""
    if solver.a2_variant not in ("central", "upwind"):
        raise ValueError(f"unknown A2 variant: {solver.a2_variant!r}")
    b = spec.barrier
    return PlanArgs(
        *(0.0 if buf is not None else float(x) for x in market),
        spec.s_max_mult, spec.c_mult, spec.v_max, spec.d_div, solver.delta_t,
        0.0 if b is None else b.level,
        0.0 if b is None or b.level_hi is None else b.level_hi,
        spec.m1, spec.m2, solver.n_steps,
        operators.OPTION_TYPES.index(option_type),
        int(solver.a2_variant == "upwind"),
        PLAN_BARRIERS.index(None if b is None else b.kind), 1)


def plan_phases(spec, solver, dividends, american, option_type, r_d, r_f):
    """(events [(local step, amount, pct)] in processing order, phases
    [(first event, events, loop kwargs)]) of a flat-rate `phase_plan` at
    the boundary rate of (r_d, r_f) and the spec's knocked columns: what a
    packed plan (`fused_do.BookPlan`, `fused_single.DevicePlan`) holds."""
    rf = operators.boundary_rate(r_d, r_f, option_type)
    knocked = barrier_positions(spec)
    events, phases = [], []
    for ph in phase_plan(solver, dividends):
        phases.append((len(events), len(ph["events"]), loop_kwargs(
            ph, rf, american, option_type, knocked)))
        events += ph["events"]
    return events, phases


def run_plan_kernel(fn, name, args: PlanArgs, events, before, ptrs, after,
                    dev) -> int:
    """Every launch of a plan kernel `fn` (ctypes) on `dev`'s current
    stream: fn(&args, &events, *before, *ptrs, *after, stream), the first
    launch with args.fields set and the events 0..PLAN_EVENTS - 1 of
    `events` [(local step, amount, pct)], one more launch, with
    args.fields cleared, for each PLAN_EVENTS after them. Returns the
    launches made."""
    launches = 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for first in range(0, max(1, len(events)), PLAN_EVENTS):
            chunk = events[first:first + PLAN_EVENTS]
            ev = PlanEvents(first=first, count=len(chunk))
            for e, (step, amount, pct) in enumerate(chunk):
                ev.step[e], ev.amount[e], ev.pct[e] = step, amount, pct
            rc = fn(ctypes.byref(args), ctypes.byref(ev), *before, *ptrs,
                    *after, stream)
            if rc != 0:
                raise RuntimeError(f"{name} kernel launch failed: CUDA "
                                   f"error {rc}")
            launches += 1
            args.fields = 0
    return launches

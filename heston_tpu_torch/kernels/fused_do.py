"""Batched ADI time loop: host-side assembly, the CUDA kernel's wrapper
and its plain PyTorch version.

PyTorch counterpart of `heston_tpu.pallas.fused_do` for the four schemes
of `SolverConfig.scheme` (Douglas, Craig-Sneyd, modified Craig-Sneyd,
Hundsdorfer-Verwer) with calls, puts and cash-or-nothing digitals
(`option_type`), with or without a knock-out barrier (`GridSpec.barrier`),
European or American, with or without discrete dividends, at flat rates
or on a piecewise-constant rate curve (`config.RateSchedule`), with or
without Rannacher start-up damping (whose damp phase is always Douglas).
Each phase of the time loop (`phase_plan`: the main phase, after the
damp phase when there is one) runs in ONE launch of `csrc/fused_do.cu`
(one thread block per option; every dividend event of the phase inside
the same launch), a mixed-maturity book too: with per-option step counts
each option's block stops at its own count. A curve book splits each
phase at its rate segments' boundaries, one launch per piece with that
segment's fields and boundary rate (`_assemble_rate_segments`). `fused_surface_batch` returns the
terminal surfaces and the operator set that book risk reads.
`fused_do_reference` computes the same algebra with tensor ops
and Python loops over steps and sweep rows; the wrapper `fused_do_loop`
takes it only for tensors on the CPU. A batch of one goes to
`kernels.fused_single` instead, which shares this module's assembly, gate
(`_check_slice`), phase plan and remap fields.

Forward mode: given K tangent field sets (the JVP of the assembly along K
parameter directions, `_TANGENT_KEYS`), the same launch also carries K
tangent surfaces through the loop, each implicit solve reusing the primal
factorization (dx = T^-1 (dr - dT x)), and hands its tangent state on to
the next phase as it does u and lambda. `fused_theta_jacobian` builds the
calibration Jacobian from it, with four tangents (the v0 column off the
surface stencil) or five (v0_mode "ad", the v-grid's motion).

Field layout (batch first, one row per option):
  big fields      [B, ns, nv]   (s-major per option; ns = m1+1, nv = m2+1)
  s-fields        [B, ns]
  v-fields        [B, nv]
  scalars         [B]
where the JAX package uses [ns, nv, B] / [n, B] / [1, B] (see
heston_tpu_torch.convert.fields_from_jax).

Numerics carried over from the TPU kernel (heston_tpu/pallas/fused_do.py):
the delta form of the step (the solves run on increments, u enters through
one add per step), difference-form explicit stencils with the analytic
reaction rows, the rank-2 A1 bands v_j*P[i] + Q[i] with the implicit rows
derived in the loop, the Fast2Sum-compensated state update, the dt-scaled
LCP multiplier of the American floor, and the difference-form 2-point
dividend remap with the compensation folded into u by 2Sum (calls and
digital calls without a barrier) or remapped beside u (puts, digital
puts and barriers).

Payoffs (heston_tpu/pallas/fused_do.py:506-534, :592-598, :922-941,
:1221-1232): a launch takes `option_type` and the knocked s columns of a
barrier (`barrier_positions`). It rebuilds the American floor from the
s-grid (the put intrinsic, or the digitals' clipped cell average), zero
at knocked columns; puts, digitals and top-knocked barriers take the
-r_d/2 reaction on every A2 row (`n_react = nv`); an American digital is
projected onto [floor, 1] with its full-payoff nodes pinned, and keeps
its multiplier. Knocked columns stay exactly zero: the payoff and the
boundary data arrive masked and every operator keeps a zero column at
zero.

Builds (ROADMAP C9): each source compiles twice, with -fmad=false (every
float64 launch, the float32 forward mode, and the float32 launches held
bitwise against the plain version) and -fmad=true (multiply-adds
contracted into FMAs, as XLA does: every other float32 launch,
`use_fmad`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from heston_tpu_torch.config import DividendSchedule, GridSpec, SolverConfig
from heston_tpu_torch.ops import coeff
from heston_tpu_torch.ops import grid as gridmod
from heston_tpu_torch.ops import operators
from heston_tpu_torch.ops.operators import b1_mask, shift
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

# packing order of the kernel's per-option coefficient rows — must match
# the SField / VField enums of csrc/fused_do.cu
_KERNEL_S_KEYS = ("a1pl", "a1ql", "a1pd", "a1qd", "a1pu", "a1qu", "sfac",
                  "bsm", "bsp", "b2r", "vecs")
_KERNEL_V_KEYS = ("vfl", "vfac", "bvm", "bvp", "al2", "al1", "ad", "au1",
                  "au2")
# time-loop schemes, in the order of the kernels' Scheme enum: Douglas,
# Craig-Sneyd, modified Craig-Sneyd, Hundsdorfer-Verwer
SCHEMES = ("do", "cs", "mcs", "hv")

# per-tangent fields of the forward-mode loop: the JVP of the assembly
# along one parameter direction (heston_tpu.pallas.fused_do._TANGENT_KEYS;
# the A1 bands, s-grid, boundary data and remaps are parameter-free)
_TANGENT_KEYS = ("vfl", "sfac", "vfac", "bvm", "bv0", "bvp", "al2", "al1",
                 "ad", "au1", "au2")
_TANGENT_S_KEYS = ("sfac",)
# packing order of the kernel's tangent v-rows — must match the TVField
# enum of csrc/fused_do.cu. bv0 and ad are not read: the tangent bands
# are zero-sum, so the difference-form stencils imply their centre
# weight, as in the primal loop.
_KERNEL_TV_KEYS = ("vfl", "vfac", "bvm", "bvp", "al2", "al1", "au1", "au2")
# tangent count of the Jacobian launch under v0_mode "stencil": kappa, eta,
# sigma, rho ride the kernel; the v0 column is read off the primal surface
# (_v0_stencil_col). v0_mode "ad" carries all five parameters.
JAC_TANGENTS = 4

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "fused_do.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "heston_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "--split-compile=0")

# The working fields of a launch's blocks, in the kernel's Field order
# (csrc/fused_do.cu), which is the placement order: the sweeps' operands
# first (d, the Thomas factors tw and ti, the corrector's rhs e, the
# tangent rhs tbuf and the corrector's trb), then u, the compensation, the
# multiplier (American), the predictor's L u, the Thomas solutions' copies
# z1 and z1c, the tangents du and their multipliers dlam (American). Each
# is one surface [ns][row_stride(nv)], or one per tangent of the block
_FIELDS_PER_TANGENT = ("tbuf", "trb", "du", "dlam")
FIELDS = ("d", "tw", "ti", "e", "tbuf", "trb", "u", "comp", "lam", "luw",
          "z1", "z1c", "du", "dlam")
# the kernel's shared rows a block: 11 s-rows and the floor row, 9 v-rows
# and 5 penta factor rows, per tangent one s-row and 8 v-rows (the SField,
# VField, Penta and TVField enums); then two int32 b1 nodes per v-column
_ROWS_S = len(_KERNEL_S_KEYS) + 1
_ROWS_V = len(_KERNEL_V_KEYS) + 5
_ROWS_TANGENT_V = len(_KERNEL_TV_KEYS)
# An H100's shared memory (NVIDIA's Hopper tuning guide): 228 KB an SM, of
# which one block may opt into 227 KB, and each resident block costs 1 KB
# more; 132 SMs
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1_024
N_SM = 132
# resident blocks an SM a placement keeps room for: a primal book's (500
# options in one wave on 132 SMs at 4), a tangent group block's at most
PRIMAL_BLOCKS_PER_SM = 4
GROUP_BLOCKS_PER_SM = 3
# threads of a block: 128, or 256 for a block with an SM to itself or one
# other (a Douglas primal book or a forward-mode launch of at most two
# blocks an SM, a forward-mode block with all K tangents)
PRIMAL_THREADS = 128
WIDE_THREADS = 256


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------

def _check_slice(spec: GridSpec, solver: SolverConfig, option_type: str,
                 n_steps_per=None, strikes=None):
    """Raise ValueError for a scheme outside SCHEMES, an unknown payoff
    or malformed step counts: the one gate of both routes (this module's
    batched kernel and kernels.fused_single). Every flag of the time loop
    is ported; what the JAX package routes off the fused kernels (the
    other engines, the Jacobian of a curve book) is refused by the entry
    points.

    `n_steps_per`: optional per-option step counts of a mixed-maturity
    book of `strikes` [B] under the shared-dt convention T_i = n_i * dt
    (heston_tpu/pallas/fused_do.py:1860-1862): B integers in
    1..solver.n_steps, else ValueError (a shard of a mixed book may hold
    only its shorter maturities; the launch runs solver.n_steps steps and
    each option stops at its own count). Returns them as an int64 tensor
    [B] on the strikes' device (None for a uniform book)."""
    if solver.scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {solver.scheme!r}; the time loop "
                         f"implements {SCHEMES}")
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
    return nst.to(strikes.device)


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


def _prepare_batched(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
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
def _assemble(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d,
              r_f, nsteps=None, epilogue=False, option_type="call",
              anchor=None):
    """Every time-loop input field of a book of `option_type` options
    (batch first, see the module docstring) plus the grids, the extraction
    indices and the operator set. `nsteps` (optional, [B] integers):
    per-option step counts, carried as the field "nst"; `epilogue`: the
    operator set with its dense fields, for book risk
    (heston_tpu/pallas/fused_do.py:1571-1613); `anchor`: a rate segment's
    boundary anchor (`_prepare_batched`).

    Returns (fields, vec_s [B, ns], idx_s [B], idx_v [B], ops)."""
    (u0, a1pq, scol, vrow, b1val, b2row, g, ops, idx_s, idx_v
     ) = _prepare_batched(spec, solver, strikes, s0, kappa, eta, sigma,
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


def _assemble_rate_segments(spec, solver, strikes, s0, kappa, eta, sigma,
                            rho, v0, rate_schedule, nsteps=None,
                            epilogue=False, option_type="call"):
    """One `_assemble` per segment of a `config.RateSchedule`
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
        fields, vec_s, idx_s, idx_v, ops = _assemble(
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


@scope("remaps")
def _build_remap_fields(vec_s, events, nsteps=None, option_type="call",
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


def _extract(u, idx_s, idx_v):
    """Price U[idx_s, idx_v] per option of u [B, ns, nv]."""
    return u[torch.arange(u.shape[0], device=u.device), idx_s, idx_v]


def book_phases(solver: SolverConfig, dividends, vec_s, rf, american,
                nsteps=None, option_type="call", knocked=(), segments=None):
    """The launches of a book on the batched kernel: per launch of
    `phase_plan`, (event steps, remaps, keyword arguments of the loop),
    the remaps with identity rows past each lane's own count (`nsteps`,
    optional [B]); `option_type` and the barrier's `knocked` columns go
    to the remaps and to every launch. `rf`: the boundary rate of a flat
    book; `segments` (optional): a curve book's rate segments
    (`_assemble_rate_segments`), whose boundary rate and fields each
    launch takes instead (the loop's `segment`)."""
    spans = None if segments is None else [s[:2] for s in segments]
    launches = []
    for ph in phase_plan(solver, dividends, nsteps, spans):
        kw = dict(theta=ph["theta"], delta_t=ph["delta_t"],
                  scheme=ph["scheme"], first_step=ph["first_step"],
                  n_steps=ph["last_step"], rf=rf, american=american,
                  nst=ph["nst"], option_type=option_type, knocked=knocked)
        if segments is not None:
            _, _, kw["rf"], seg = segments[ph["segment"]]
            kw["segment"] = {k: v for k, v in seg.items()
                             if k not in BIG_KEYS}
        launches.append((
            [e[0] for e in ph["events"]],
            _build_remap_fields(vec_s, ph["events"], ph["nst"], option_type,
                                knocked), kw))
    return launches


def run_phases(loop, fields, phases, tangents=None):
    """The state after every launch of a plan (`book_phases`, or
    `fused_single.single_plan`'s), one call of `loop` (a kernel wrapper or
    its plain version) per launch, the state handed from each launch to
    the next: (u, lam), or with `tangents` (the forward-mode loop)
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


@scope("book_plan")
def book_plan(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d,
              r_f, american=False, dividends=None, option_type="call",
              n_steps_per=None, rate_schedule=None, epilogue=False):
    """Assembly and launch plan of a book (`strikes` [B]) on the batched
    kernel: (fields, phases, (idx_s, idx_v), ops, vec_s); `run_phases`
    runs it. `n_steps_per`: optional per-option step counts (see
    `_check_slice`); `rate_schedule`: an optional `config.RateSchedule`,
    whose segments each take their own launches (the scalar r_d, r_f are
    then not read; `_assemble_rate_segments`); `epilogue`: the operator
    set with its dense fields (a curve book's: its last segment's).
    Counts each plan in `book_plan.calls` and its options in
    `book_plan.lanes`."""
    nst = _check_slice(spec, solver, option_type, n_steps_per,
                       strikes=strikes)
    book_plan.calls += 1
    book_plan.lanes += int(strikes.shape[0])
    knocked = barrier_positions(spec)
    if rate_schedule is None:
        fields, vec_s, idx_s, idx_v, ops = _assemble(
            spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
            nst, epilogue, option_type)
        phases = book_phases(solver, dividends, vec_s,
                             operators.boundary_rate(r_d, r_f, option_type),
                             american, nst, option_type, knocked)
    else:
        segments, vec_s, idx_s, idx_v, ops = _assemble_rate_segments(
            spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
            rate_schedule, nst, epilogue, option_type)
        fields = segments[0][3]
        phases = book_phases(solver, dividends, vec_s, None, american, None,
                             option_type, knocked, segments)
    return fields, phases, (idx_s, idx_v), ops, vec_s


book_plan.calls = 0
book_plan.lanes = 0


def fused_price_batch(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    n_steps_per=None,
    rate_schedule=None,
) -> torch.Tensor:
    """Prices [B] of a book of strikes through the batched ADI time loop
    (solver.scheme): the CUDA kernel for a CUDA `strikes` tensor, its plain version
    for a CPU one, one launch per phase of `phase_plan` (two with
    Rannacher start-up damping). Device and dtype come from `strikes`.

    n_steps_per: optional per-option step counts of a mixed-maturity book
    (T_i = n_i * delta_t, solver.n_steps = max(n_i)), still one launch
    per phase: each option's block stops at its own count
    (heston_tpu/pallas/fused_do.py:1860-1865).

    rate_schedule: an optional `config.RateSchedule`; the scalar r_d and
    r_f are then not read, and each phase runs one launch per rate
    segment piece with that segment's fields, boundary rate and anchor
    (heston_tpu/pallas/fused_do.py:1866-1873). Not with n_steps_per
    (ValueError)."""
    fields, phases, at, _, _ = book_plan(
        spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american, dividends, option_type, n_steps_per, rate_schedule)
    u, _ = run_phases(fused_do_loop, fields, phases)
    return _extract(u, *at)


def fused_surface_batch(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    n_steps_per=None,
    rate_schedule=None,
):
    """Like fused_price_batch, but returns the whole terminal surfaces:
    (u, lam, ops, vec_s [B, ns], idx_s [B], idx_v [B]), with u and the
    American multiplier lam (zeros for European books) in the port's
    layout [B, ns, nv] (s-major; the JAX package returns [B, nv, ns]) and
    ops the operator set with its dense fields
    (heston_tpu/pallas/fused_do.py:1899-1954) — the input of book risk
    (models.greeks); a curve book's ops are its last segment's (valuation
    time tau = T). A batch of one stays on this kernel."""
    fields, phases, at, ops, vec_s = book_plan(
        spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american, dividends, option_type, n_steps_per, rate_schedule,
        epilogue=True)
    u, lam = run_phases(fused_do_loop, fields, phases)
    return u, lam, ops, vec_s, *at


def _linearized_assemble(spec, solver, strikes, s0, theta_vec, r_d, r_f,
                         nsteps=None, option_type="call",
                         v0_mode="stencil"):
    """The assembly at theta_vec = (kappa, eta, sigma, rho, v0) and its
    JVP along the basis directions of (kappa, eta, sigma, rho) at fixed
    v0 (v0_mode "stencil", JAC_TANGENTS directions) or of all five ("ad":
    the v0 direction moves the v-grid through the v0 node's insertion,
    ops.grid.make_v_nodes) — the counterpart of the JAX package's
    `jax.linearize` over `_assemble` (fused_theta_jacobian,
    heston_tpu/pallas/fused_do.py:2039-2074). `nsteps`: optional
    per-option step counts (parameter-free); `option_type`: the payoff.

    One pass: `torch.func.vmap` over `torch.func.jvp` pushes the basis
    tangents through the assembly together; the primal fields come back
    as the (unbatched) aux output, equal to `_assemble`'s.
    Returns (fields, tangents, vec_s, idx_s, idx_v) with tangents a list
    of K dicts of the `_TANGENT_KEYS` fields."""
    n_tg = _n_tangents(v0_mode)

    def prep(tv):
        full = torch.cat([tv, theta_vec[n_tg:]])
        f, vec_s, idx_s, idx_v, _ = _assemble(
            spec, solver, strikes, s0, *full, r_d, r_f, nsteps,
            option_type=option_type)
        return tuple(f[k] for k in _TANGENT_KEYS), (f, vec_s, idx_s, idx_v)

    def along(direction):
        _, dfields, aux = torch.func.jvp(prep, (theta_vec[:n_tg],),
                                         (direction,), has_aux=True)
        return dfields, aux

    basis = torch.eye(n_tg, dtype=theta_vec.dtype, device=theta_vec.device)
    dfields, (fields, vec_s, idx_s, idx_v) = torch.func.vmap(
        along, out_dims=(0, None))(basis)
    tangents = [{k: d[kk] for k, d in zip(_TANGENT_KEYS, dfields)}
                for kk in range(n_tg)]
    return fields, tangents, vec_s, idx_s, idx_v


def _n_tangents(v0_mode: str) -> int:
    """The tangent count of a Jacobian launch: JAC_TANGENTS under
    v0_mode "stencil", all five parameters under "ad"; ValueError for
    any other mode."""
    if v0_mode not in ("stencil", "ad"):
        raise ValueError(f"unknown v0_mode: {v0_mode!r}")
    return JAC_TANGENTS if v0_mode == "stencil" else 5


def _v0_stencil_col(spec, u, vfl, idx_s, idx_v, v0):
    """dPrice/dv0 [B] as the discretization's own v-derivative stencil
    at the inserted v0 node, read off the primal surfaces u [B, ns, nv]
    (heston_tpu/pallas/fused_do.py:1964-1998). v0 enters the discrete
    price only through the grid, so the continuum dP/dv0 is dU/dv at
    (s0, v0). The 3-point parabola is centred on the clipped interior
    node j and evaluated at v0 (a no-op when idx_v is interior)."""
    j = torch.clamp(idx_v, 1, spec.m2 - 1)

    def v_at(jj):
        return torch.gather(vfl, 1, jj[:, None])[:, 0]

    v_m, v_0, v_p = v_at(j - 1), v_at(j), v_at(j + 1)
    u_m = _extract(u, idx_s, j - 1)
    u_0 = _extract(u, idx_s, j)
    u_p = _extract(u, idx_s, j + 1)
    h0 = v_0 - v_m
    h1 = v_p - v_0
    bm, b0, bpw = coeff.w_beta(h0, h1)
    dm, d0, dpw = coeff.w_delta(h0, h1)
    first = bm * u_m + b0 * u_0 + bpw * u_p
    second = dm * u_m + d0 * u_0 + dpw * u_p
    return first + second * (torch.as_tensor(v0, dtype=u.dtype,
                                             device=u.device) - v_0)


def fused_theta_jacobian(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    theta_vec: torch.Tensor,
    r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    n_steps_per=None,
    v0_mode: str = "stencil",
):
    """(base prices [B], Jacobian [B, 5]) of a book of strikes with
    respect to theta_vec = (kappa, eta, sigma, rho, v0), by exact
    forward-mode AD: the linearized assembly gives the tangent fields, the
    forward-mode time loop carries the primal and the tangent surfaces
    through one launch per phase of `phase_plan` (two with Rannacher
    start-up damping: the state u, lam and the tangents du_k, dlam_k
    handed from the damp launch to the main one; the CUDA kernel for a
    CUDA `strikes`, the plain version for a CPU one). Counterpart of
    heston_tpu.pallas.fused_do.fused_theta_jacobian; device and dtype
    come from `strikes`.

    v0_mode: "stencil" carries the JAC_TANGENTS directions (kappa, eta,
    sigma, rho) and reads the v0 column off the primal surface with the
    discretization's v-stencil (`_v0_stencil_col`); "ad" carries all five,
    the v0 column the grid-motion tangent (heston_tpu/pallas/fused_do.py:
    2039-2074; far worse conditioned in float32).
    n_steps_per: optional per-option step counts — a whole mixed-maturity
    Jacobian, primal and tangents, in one launch per phase (see
    fused_price_batch)."""
    _n_tangents(v0_mode)             # ValueError for an unknown mode
    nst = _check_slice(spec, solver, option_type, n_steps_per,
                       strikes=strikes)
    theta_vec = torch.as_tensor(theta_vec, dtype=strikes.dtype,
                                device=strikes.device)
    fields, tangents, vec_s, idx_s, idx_v = _linearized_assemble(
        spec, solver, strikes, s0, theta_vec, r_d, r_f, nst, option_type,
        v0_mode)
    phases = book_phases(
        solver, dividends, vec_s,
        operators.boundary_rate(r_d, r_f, option_type), american, nst,
        option_type, barrier_positions(spec))
    u, _, dus, _ = run_phases(fused_do_loop, fields, phases, tangents)
    return _read_jacobian(spec, u, dus, fields["vfl"], idx_s, idx_v,
                          theta_vec[4])


def _read_jacobian(spec, u, dus, vfl, idx_s, idx_v, v0):
    """(base prices [B], Jacobian [B, 5]) read off the terminal primal
    surfaces u and the tangent surfaces dus: of all five parameters
    (v0_mode "ad"), or of (kappa, eta, sigma, rho) with the v0 column
    the surface v-stencil."""
    cols = [_extract(du, idx_s, idx_v) for du in dus]
    if len(cols) == JAC_TANGENTS:
        cols.append(_v0_stencil_col(spec, u, vfl, idx_s, idx_v, v0))
    return _extract(u, idx_s, idx_v), torch.stack(cols, dim=-1)


# ---------------------------------------------------------------------------
# the time loop: plain version
# ---------------------------------------------------------------------------

def _two_sum(a, b):
    """Knuth 2Sum: s = fl(a + b) and err = a + b - s exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fused_do_reference(fields, ev_steps, remaps, *, theta: float,
                       delta_t: float, n_steps: int, rf, american: bool,
                       tangents=None, first_step: int = 1, nst=None,
                       scheme: str = "do", option_type: str = "call",
                       knocked=(), segment=None):
    """Plain PyTorch version of the kernel: the ADI time loop of a book on
    [B, ns, nv] tensors over the local steps first_step..n_steps (one
    launch of `phase_plan`). Returns (u, lam): the terminal surfaces
    [B, ns, nv] (u + compensation) and the multiplier; with `tangents`,
    (u, lam, [du_k], [dlam_k]). `segment` (optional): a dict of fields
    that replace `fields`' own for this launch (a rate segment's,
    `book_phases`).

    scheme: one of SCHEMES. "do" is the Douglas step; "cs", "mcs" and
    "hv" add the TPU kernel's corrector after the predictor's two solves
    (heston_tpu/pallas/fused_do.py:833-911), in delta form: the
    predictor's L u is reused, the corrector's stage-1 right-hand side
    adds the A0 (CS, MCS) or L (MCS, HV) terms of the predictor increment
    z2, and both solves run again; HV's increment is relative to
    y2 = u + z2 (no b2 injection before its second solve; the step's
    increment is z2 + w2).

    nst: optional [B] per-lane last local steps (a mixed-maturity book,
    `phase_plan`): once step n passes nst[i], lane i keeps its state,
    compensation, dt-scaled multiplier and tangents — the JAX kernel's
    freeze (heston_tpu/pallas/fused_do.py:1088-1102); the remaps carry
    identity rows for such lanes (`_build_remap_fields`).

    The state enters as fields["u"] and fields["lam"]. The LCP multiplier
    crosses launches unscaled and is carried dt-scaled inside one: dt*lam
    on entry, lam_carry/dt on exit (the JAX kernel's convention,
    heston_tpu/pallas/fused_do.py:1159, :1248), so a phase at delta_t/2
    hands the next one the same multiplier. A European loop never
    touches it and hands fields["lam"] back.

    ev_steps: the local step of each dividend event (applied before that
    step); remaps: the matching (i0, w0, i1, w1) fields of
    _build_remap_fields. rf: the boundary growth rate
    (operators.boundary_rate).
    tangents: optional list of K dicts of `_TANGENT_KEYS` fields ([B, ns]
    s-fields, [B, nv] v-fields) — the forward-mode variant
    (heston_tpu/pallas/fused_do.py:961-1102): the K tangent surfaces
    start at fields["du"] and the multiplier tangents at fields["dlam"]
    (each a list of K [B, ns, nv] tensors, dlam unscaled like lam; zero
    when absent: the state an earlier launch hands on, :1677-1690) and go
    through the same steps, reusing the primal factorizations; a
    corrector scheme differentiates its stage-1 right-hand side and
    re-runs both tangent solves against the corrector's own increments
    (:1008-1054). The multiplier tangents are carried dt-scaled like the
    multiplier (:1159-1162, :1248-1252); a European loop hands them back
    as they came.

    option_type, knocked: the payoff and a barrier's knocked s columns
    (`barrier_positions`). They set the American floor
    (`exercise_floor`), the reaction rows (`n_react`), the dividend remap
    (`remaps_apart`: u and the compensation each in difference form, u's
    captured rounding added to the remapped compensation) and, for an
    American digital, the static-pin + box projection in place of the
    multiplier update (:922-941; tangent :1058-1070): pin u to the floor
    where it is 1, else min(max(q, floor), 1); the compensation restarts
    wherever a bound binds and the multiplier is carried unchanged."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; want one of {SCHEMES}")
    f = fields if segment is None else {**fields, **segment}
    u = f["u"].clone()
    b, ns, nv = u.shape
    dtype, dev = u.dtype, u.device
    dt = delta_t
    td = theta * delta_t

    def s_(k):
        return f[k][:, :, None]

    def v_(k):
        return f[k][:, None, :]

    vfl = v_("vfl")
    # implicit A1 rows I - td*A1 from the rank-2 bands
    il = -td * (vfl * s_("a1pl") + s_("a1ql"))
    idg = -td * (vfl * s_("a1pd") + s_("a1qd")) + 1.0
    iu = -td * (vfl * s_("a1pu") + s_("a1qu"))
    # Thomas factorization along s, once per launch
    tw = torch.zeros_like(u)
    ti = torch.empty_like(u)
    temp = idg[:, 0]
    ti[:, 0] = 1.0 / temp
    for i in range(1, ns):
        wi = il[:, i] / temp
        temp = idg[:, i] - wi * iu[:, i - 1]
        tw[:, i] = wi
        ti[:, i] = 1.0 / temp
    # pentadiagonal factorization of I - td*A2 along v
    pm, pgm, phm, pc, pc2 = (torch.empty(b, nv, dtype=dtype, device=dev)
                             for _ in range(5))
    zero = torch.zeros(b, dtype=dtype, device=dev)
    c1p = c2p = cc1p = cc2p = zero
    for j in range(nv):
        il2 = -td * f["al2"][:, j]
        il1 = -td * f["al1"][:, j]
        idd = 1.0 - td * f["ad"][:, j]
        iu1 = -td * f["au1"][:, j]
        iu2 = -td * f["au2"][:, j]
        big_l = il1 - il2 * c2p
        m = 1.0 / (idd - big_l * c1p - il2 * cc2p)
        c = (iu1 - big_l * cc1p) * m
        c2 = iu2 * m
        pc[:, j], pc2[:, j], pgm[:, j], phm[:, j], pm[:, j] = (
            c, c2, big_l * m, il2 * m, m)
        c1p, c2p, cc1p, cc2p = c, c1p, c2, cc1p

    def thomas(d):
        """In-place solve of (I - td*A1) along s of d [..., ns, nv]."""
        for i in range(1, ns):
            d[..., i, :] = d[..., i, :] - tw[:, i] * d[..., i - 1, :]
        d[..., ns - 1, :] = d[..., ns - 1, :] * ti[:, ns - 1]
        for i in range(ns - 2, -1, -1):
            d[..., i, :] = (d[..., i, :] - iu[:, i] * d[..., i + 1, :]) \
                * ti[:, i]

    def penta(d):
        """In-place solve of (I - td*A2) along v of d [..., ns, nv]."""
        zrow = torch.zeros_like(d[..., 0])
        d[..., 0] = pm[:, :1] * d[..., 0]
        for j in range(1, nv):
            dp2 = d[..., j - 2] if j >= 2 else zrow
            d[..., j] = (pm[:, j:j + 1] * d[..., j]
                         - pgm[:, j:j + 1] * d[..., j - 1]
                         - phm[:, j:j + 1] * dp2)
        for j in range(nv - 2, -1, -1):
            x2 = d[..., j + 2] if j + 2 < nv else zrow
            d[..., j] = (d[..., j] - pc[:, j:j + 1] * d[..., j + 1]
                         - pc2[:, j:j + 1] * x2)

    def sdiffs(x):
        return shift(x, -1, -2) - x, shift(x, 1, -2) - x

    def dv_of(x, wm, wp):
        """beta_v stencil along v (zero-sum weights, difference form)."""
        return wm * (shift(x, -1, -1) - x) + wp * (shift(x, 1, -1) - x)

    def a2mul(x, l2, l1, u1, u2):
        """Pentadiagonal multiply along v in difference form (the centre
        weight implied; the caller adds the reaction)."""
        return (l2 * (shift(x, -2, -1) - x) + l1 * (shift(x, -1, -1) - x)
                + u1 * (shift(x, 1, -1) - x) + u2 * (shift(x, 2, -1) - x))

    c_a0 = s_("sfac") * v_("vfac")
    b1f = b1_mask(ns, nv, dtype, dev) * f["b1v"][:, None, None]
    bottom = torch.zeros(ns, nv, dtype=dtype, device=dev)
    bottom[1:, nv - 1] = 1.0
    b2f = bottom * s_("b2r")
    # analytic reaction rows: A1 row 0 carries a1qd[0], every other row
    # -r_d/2 = a1qd[m1]; A2 rows 0..n_react-1 carry -r_d/2
    react_row = f["a1qd"][:, ns - 1]
    react_s = torch.where(torch.arange(ns, device=dev)[None, :] == 0,
                          f["a1qd"][:, :1], react_row[:, None])[:, :, None]
    react_v = torch.where(
        torch.arange(nv, device=dev)[None, :]
        < n_react(option_type, knocked, ns, nv),
        react_row[:, None], torch.zeros_like(react_row)[:, None])[:, None, :]
    u0 = exercise_floor(f["vecs"], f["kk"], option_type, knocked)[:, :, None]
    digital = american and operators.is_digital(option_type)
    apart = remaps_apart(option_type, knocked)
    smax_mask = (torch.arange(ns, device=dev) != ns - 1).to(dtype)
    smax_mask = smax_mask[None, :, None]
    rf_t = torch.as_tensor(rf, dtype=dtype, device=dev)

    comp = torch.zeros_like(u)
    lam = dt * f["lam"]            # dt-scaled LCP multiplier carry
    bsm, bsp = s_("bsm"), s_("bsp")
    bvm, bvp = v_("bvm"), v_("bvp")
    pl, ql, pu, qu = s_("a1pl"), s_("a1ql"), s_("a1pu"), s_("a1qu")
    al2, al1, au1, au2 = v_("al2"), v_("al1"), v_("au1"), v_("au2")

    def a1mul_d(dlo, dhi, x):
        """Explicit A1 multiply on precomputed s-differences."""
        return vfl * (pl * dlo + pu * dhi) + (ql * dlo + qu * dhi) \
            + react_s * x

    def lparts(x):
        """(A0 x, A1 x, A2 x) in difference form, each stencil formed
        once; L x = (A0 x + A1 x) + A2 x, and dsx = beta_s(x) for the
        tangents."""
        dlo, dhi = sdiffs(x)
        dsx = bsm * dlo + bsp * dhi
        return (c_a0 * dv_of(dsx, bvm, bvp), a1mul_d(dlo, dhi, x),
                a2mul(x, al2, al1, au1, au2) + react_v * x, dsx)

    if tangents is not None:
        # tangent fields stacked over directions: s-fields [K, B, ns, 1],
        # v-fields [K, B, 1, nv]; tangent surfaces [K, B, ns, nv]
        tg = {k: torch.stack([t[k] for t in tangents]) for k in _TANGENT_KEYS}
        ts = {k: tg[k][..., :, None] for k in _TANGENT_S_KEYS}
        tv = {k: tg[k][..., None, :] for k in _TANGENT_KEYS
              if k not in _TANGENT_S_KEYS}
        dc_a0 = ts["sfac"] * v_("vfac") + s_("sfac") * tv["vfac"]
        dus, dlams_in = _tangent_state(f, len(tangents), u)
        dlams = dt * dlams_in

        def mt_exp(x):
            """Tangent of the explicit A1 multiply: d(band) = dvfl x P
            (P rows are zero-sum, so the difference form is exact)."""
            xlo, xhi = sdiffs(x)
            return (tv["vfl"] * pl) * xlo + (tv["vfl"] * pu) * xhi

        def ta2(x):
            """Tangent A2 bands on x (zero-sum: no reaction term)."""
            return a2mul(x, tv["al2"], tv["al1"], tv["au1"], tv["au2"])

        def ta0(dsx, y):
            """d(A0 x) along each direction: coefficient and v-weight
            motion on x (its beta_s stencil dsx), then A0 on y = dx."""
            ylo, yhi = sdiffs(y)
            return ((dc_a0 * dv_of(dsx, bvm, bvp)
                     + c_a0 * dv_of(dsx, tv["bvm"], tv["bvp"]))
                    + c_a0 * dv_of(bsm * ylo + bsp * yhi, bvm, bvp))

    events = list(zip(ev_steps, remaps))

    for n in range(first_step, n_steps + 1):
        while events and events[0][0] == n:
            _, (i0, w0, i1, w1) = events.pop(0)
            wsum = torch.where(w0 + w1 > 0.5, torch.ones_like(w0),
                               torch.zeros_like(w0))[:, :, None]

            def remap_acc(x):
                """The difference-form remap's correction to x's own
                column, w0 (x[i0] - x) + w1 (x[i1] - x)."""
                g0 = torch.gather(x, 1, i0[:, :, None].expand(b, ns, nv))
                g1 = torch.gather(x, 1, i1[:, :, None].expand(b, ns, nv))
                return (w0[:, :, None] * (g0 - x)
                        + w1[:, :, None] * (g1 - x))

            if apart:
                # u and the compensation remapped separately; u's
                # captured rounding joins the remapped compensation
                comp_r = wsum * comp + remap_acc(comp)
                u, e2 = _two_sum(wsum * u, remap_acc(u))
                comp = comp_r + e2
            else:
                # fold the compensation into u, remap in difference
                # form, and restart the compensation from the remap's own
                # rounding
                src = u + comp
                u, comp = _two_sum(wsum * src, remap_acc(src))
            if tangents is not None:
                # the remap is linear and parameter-free: each tangent
                # takes the value of the same 2Sum (no compensation)
                shape = dus.shape
                t0 = torch.gather(dus, 2, i0[None, :, :, None].expand(shape))
                t1 = torch.gather(dus, 2, i1[None, :, :, None].expand(shape))
                dus = wsum * dus + (w0[:, :, None] * (t0 - dus)
                                    + w1[:, :, None] * (t1 - dus))

        if nst is not None:
            held = (u, comp, lam, dus, dlams) if tangents is not None \
                else (u, comp, lam)
        e0 = torch.exp(rf_t * dt * (n - 1.0))
        e1 = torch.exp(rf_t * dt * float(n))
        kb1 = dt * e0 + td * (e1 - e0)
        kb2a = dt * e0
        kb2b = td * (e1 - e0)

        # explicit (A0 + A1 + A2) u in difference form
        a0u, a1u, a2u, dsu = lparts(u)
        lu = a0u + a1u + a2u
        d = dt * lu + (kb1 * b1f + kb2a * b2f)
        if american:
            d = d + lam

        thomas(d)
        z1 = d.clone() if tangents is not None else None
        # b2 injection on the top v-row, then the penta solve along v
        d[:, :, nv - 1] = d[:, :, nv - 1] + kb2b * f["b2r"]
        penta(d)
        inc = d                    # the step's increment: z2 for Douglas

        if scheme != "do":
            # the corrector's stage-1 right-hand side from the predictor
            # increment z2 = d and the predictor's own L u
            a0z, a1z, a2z, dsz = lparts(d)
            if scheme == "cs":
                dc = dt * lu + (0.5 * dt) * a0z + kb1 * b1f + kb2a * b2f
            elif scheme == "mcs":
                kmc = (0.5 - theta) * dt * (e1 - e0)
                dc = (dt * lu + td * a0z + ((0.5 - theta) * dt)
                      * (a0z + a1z + a2z)
                      + (kb1 + kmc) * b1f + (kb2a + kmc) * b2f)
            else:
                khv = 0.5 * dt * (e1 - e0)
                dc = (dt * lu + (0.5 * dt) * (a0z + a1z + a2z) - d
                      + (dt * e0 + khv) * (b1f + b2f))
            if american:
                dc = dc + lam
            thomas(dc)
            z1c = dc.clone() if tangents is not None else None
            if scheme != "hv":
                dc[:, :, nv - 1] = dc[:, :, nv - 1] + kb2b * f["b2r"]
            penta(dc)
            inc = d + dc if scheme == "hv" else dc

        if tangents is not None:
            # dz1 = T1^-1 (dR1 + td dA1 z1), dz2 = T2^-1 (dz1 + td dA2 z2)
            a2t = ta2(u) + (a2mul(dus, al2, al1, au1, au2) + react_v * dus)
            ylo, yhi = sdiffs(dus)
            trhs = dt * (ta0(dsu, dus) + mt_exp(u)
                         + a1mul_d(ylo, yhi, dus) + a2t)
            if american:
                trhs = trhs + dlams
            dz = trhs + td * mt_exp(z1)
            thomas(dz)
            dz = dz + td * ta2(d)
            penta(dz)
            dinc = dz
            if scheme != "do":
                # the corrector's tangent: d/dtheta of its stage-1 rhs,
                # then both solves against the corrector's increments
                da0z = ta0(dsz, dz)
                if scheme == "cs":
                    crhs = trhs + (0.5 * dt) * da0z
                else:
                    zlo, zhi = sdiffs(dz)
                    dlz = (da0z + mt_exp(d) + ta2(d)
                           + a1mul_d(zlo, zhi, dz)
                           + (a2mul(dz, al2, al1, au1, au2)
                              + react_v * dz))
                    if scheme == "mcs":
                        crhs = trhs + td * da0z + ((0.5 - theta) * dt) * dlz
                    else:
                        crhs = trhs - dz + (0.5 * dt) * dlz
                dw = crhs + td * mt_exp(z1c)
                thomas(dw)
                # stage 2 anchors at the corrector's own penta solution
                dw = dw + td * ta2(dc)
                penta(dw)
                dinc = dz + dw if scheme == "hv" else dw
            dubar = dus + dinc

        # compensated update u' = u + increment (Fast2Sum), American floor
        if digital:
            # static-pin + box projection onto [floor, 1]; the multiplier
            # (and its tangents) carried unchanged
            t_inc = inc + comp
            q = u + t_inc
            err = t_inc - (q - u)
            pin = u0 == 1.0
            qm = torch.maximum(q, u0)
            if tangents is not None:
                dm = torch.where(q > u0, dubar, torch.where(
                    q < u0, torch.zeros_like(dubar), 0.5 * dubar))
                dus = torch.where(pin, torch.zeros_like(dm), torch.where(
                    qm < 1.0, dm, torch.where(qm > 1.0, torch.zeros_like(dm),
                                              0.5 * dm)))
            u = torch.where(pin, u0.expand_as(q), torch.clamp(qm, max=1.0))
            comp = torch.where((q > u0) & (qm < 1.0) & ~pin, err,
                               torch.zeros_like(err))
        elif american:
            t_inc = (inc - lam) + comp
            q = u + t_inc
            err = t_inc - (q - u)
            lam_arg = (u0 - q) - err
            if tangents is not None:
                # the maximum-JVP of XLA: weight 0.5 on ties, branching
                # on the same compensated primal values as the update
                da = dubar - dlams
                dus = torch.where(q > u0, da, torch.where(
                    q < u0, torch.zeros_like(da), 0.5 * da))
                darg = dlams - dubar
                dlams = torch.where(lam_arg > 0.0, darg, torch.where(
                    lam_arg < 0.0, torch.zeros_like(darg), 0.5 * darg)
                ) * smax_mask
            u = torch.maximum(q, u0)
            comp = torch.where(q > u0, err, torch.zeros_like(err))
            lam = torch.clamp(lam_arg, min=0.0) * smax_mask
        else:
            t_inc = inc + comp
            q = u + t_inc
            comp = t_inc - (q - u)
            u = q
            if tangents is not None:
                dus = dubar
        if nst is not None:
            # lanes past their own count keep what they held (the
            # kernel's block has stopped there)
            act = (nst >= n)[:, None, None]
            new = (u, comp, lam, dus, dlams) if tangents is not None \
                else (u, comp, lam)
            u, comp, lam, *rest = (torch.where(act, x, h)
                                   for x, h in zip(new, held))
            if tangents is not None:
                dus, dlams = rest
    lam_out = lam / dt if american else f["lam"]
    if tangents is not None:
        dl_out = dlams / dt if american else dlams_in
        return (u + comp, lam_out, list(dus.unbind(0)),
                list(dl_out.unbind(0)))
    return u + comp, lam_out


def _tangent_state(fields, k, u):
    """(du, dlam) [K, B, ns, nv] a forward-mode launch starts from:
    fields["du"] and fields["dlam"] (lists of K [B, ns, nv] tensors), or
    zeros where absent."""
    return tuple(torch.stack(list(fields[key]))
                 if fields.get(key) is not None
                 else torch.zeros((k, *u.shape), dtype=u.dtype,
                                  device=u.device)
                 for key in ("du", "dlam"))


# ---------------------------------------------------------------------------
# the time loop: CUDA kernel
# ---------------------------------------------------------------------------

def _nvcc(source: Path) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home} or on PATH: the kernel is "
            f"built from {source} at first use")
    return found


def nvcc_flags(fmad: bool = False) -> tuple:
    """The nvcc flags of a build: NVCC_FLAGS, with -fmad=true for the
    FMA build."""
    return tuple("-fmad=true" if f == "-fmad=false" and fmad else f
                 for f in NVCC_FLAGS)


def use_fmad(dtype: torch.dtype, fmad: Optional[bool] = None,
             tangent: bool = False) -> bool:
    """The build a launch takes: the one named by `fmad` (the
    kernel-against-plain checks name False), else -fmad=true for a float32
    primal launch and -fmad=false for float64 and for the forward mode
    (`tangent`). On an H100 the FMA build brings the hv euro arm's float32
    RMSE within the bench's 2e-5 (-fmad=false: 2.26e-5) and keeps every
    other primal arm within its budget (ROADMAP C9, chip_smoke.py's
    fma_build phase). Which multiply-adds the FMA build contracts follows
    the code's shape, not its arithmetic: after the shared-memory redesign
    it took the float32 Jacobian of the American-dividend arm to 3.42e-5
    against the bench's 3e-5 (2.51e-5 before), so the forward mode keeps
    the -fmad=false build, whose rounding is the plain version's. float64
    stays on -fmad=false, within 1e-10 of the plain versions. Chosen by
    dtype and purpose only: nothing switches builds on a failure."""
    if fmad is not None:
        return bool(fmad)
    return dtype == torch.float32 and not tangent


def build(source: Path = SOURCE, fmad: bool = False) -> Path:
    """Compile one CUDA source of csrc/ (this module's kernel by default)
    into build/heston_tpu_torch/, once per content of the source and the
    flags (`nvcc_flags(fmad)`), and return the shared library's path.
    Each source is self-contained (no shared header), so its hash covers
    all it compiles; the two builds of a source have separate hashes.
    Counts each compile in `build.nvcc_runs`."""
    flags = nvcc_flags(fmad)
    src = source.read_bytes()
    tag = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    out = BUILD_DIR / f"{source.stem}_{tag[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(source), *flags, "-o", tmp, str(source)]
    build.nvcc_runs += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


build.nvcc_runs = 0


@functools.cache
def _library(fmad: bool = False) -> ctypes.CDLL:
    # `_library.loads` counts the cache's misses, as `_sm_count.queries`
    # does kernel 1's device queries for a launch plan
    _library.loads += 1
    lib = ctypes.CDLL(str(build(SOURCE, fmad)))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    ll = ctypes.c_longlong
    for name in ("fused_do_f32", "fused_do_f64"):
        fn = getattr(lib, name)
        # u0, lam0, u_out, lam_out, work, sfields, vfields, scalars,
        # ev_step, ev_idx, ev_w, nst (null: every lane runs every step);
        # B, ns, nv, first_step, n_steps, american, n_events, scheme,
        # payoff, n_react, knock0, knock1, apart; the plan (fmask, threads,
        # scratch values a block); dt, td, rf, (1/2 - theta)*dt; stream
        fn.argtypes = [p] * 12 + [i] * 15 + [ll] + [d] * 4 + [p]
        fn.restype = ctypes.c_int
    for name in ("fused_do_tangent_f32", "fused_do_tangent_f64"):
        fn = getattr(lib, name)
        # the primal's twelve pointers, then tsfields, tvfields, du0,
        # dlam0 (null: zero), du_out, dlam_out; the primal's thirteen
        # ints, then K and G; the plan; the four doubles; stream
        fn.argtypes = [p] * 18 + [i] * 17 + [ll] + [d] * 4 + [p]
        fn.restype = ctypes.c_int
    # f64, tan, ns, nv, american, scheme, payoff, apart, K, G, fmask,
    # threads; out: blocks an SM, registers, shared bytes
    lib.fused_do_occupancy.argtypes = [i] * 12 + [p] * 3
    lib.fused_do_occupancy.restype = ctypes.c_int
    return lib


_library.loads = 0


def launch_flags(option_type: str, knocked, ns: int, nv: int) -> list:
    """The payoff's launch arguments of both kernels: the payoff's index
    in operators.OPTION_TYPES (call, put, digital_call, digital_put, the
    kernels' Payoff enum), `n_react`, and the knocked s columns as two
    ints (-1: none). ValueError for a knocked column off the grid."""
    knocked = tuple(knocked)
    if len(knocked) > 2 or any(not 0 <= c < ns for c in knocked):
        raise ValueError(f"knocked columns must be at most two s indices "
                         f"in 0..{ns - 1}, got {knocked}")
    ks = list(knocked) + [-1] * (2 - len(knocked))
    return [operators.OPTION_TYPES.index(
        operators._validate_option_type(option_type)),
        n_react(option_type, knocked, ns, nv), *ks]


def _check_field(name, t, shape, dtype, dev):
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"field {name!r}: want {shape} {dtype} on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")


def check_events(ev_steps, remaps, first_step, n_steps, shape, dtype, dev):
    """Raise ValueError unless the event steps ascend within
    first_step..n_steps, one remap each, and every remap field has the
    given shape on `dev` (int64 indices, `dtype` weights)."""
    steps = list(ev_steps)
    if len(steps) != len(remaps):
        raise ValueError("one remap per event step")
    if steps != sorted(steps) or any(not first_step <= s <= n_steps
                                     for s in steps):
        raise ValueError(f"event steps must ascend within "
                         f"{first_step}..{n_steps}: {steps}")
    for rm in remaps:
        for t, want in zip(rm, (torch.int64, dtype, torch.int64, dtype)):
            if t.device != dev or t.dtype != want or tuple(t.shape) != shape:
                raise ValueError(f"remap fields must be {shape} on the "
                                 f"state's device (int64 indices)")
    return steps


def row_stride(nv: int) -> int:
    """The s-row stride of a working surface: nv and its two border
    columns on each side, rounded up to an odd count, so that the penta
    sweep's threads, one s-row apart, fall on distinct shared-memory
    banks."""
    return (nv + 4) | 1


def surface_elems(ns: int, nv: int) -> int:
    """Values of one working surface: [ns][nv] inside a zero border of one
    s-row and two v-columns on each side (the kernel's stencils read it as
    the zero outside the grid), at row_stride(nv)."""
    return (ns + 2) * row_stride(nv)


def field_counts(scheme: str, american: bool, kg: int = 0) -> dict:
    """{field: surfaces} a block keeps, in FIELDS order, for a launch of
    `scheme`, with `kg` tangents a block (0: the primal loop)."""
    corr, tan = scheme != "do", kg > 0
    have = {"d": True, "tw": True, "ti": True, "e": corr, "tbuf": tan,
            "trb": tan and corr, "u": True, "comp": True, "lam": american,
            "luw": corr, "z1": tan, "z1c": tan and corr, "du": tan,
            "dlam": tan and american}
    return {f: kg if f in _FIELDS_PER_TANGENT else 1
            for f in FIELDS if have[f]}


class LaunchPlan(NamedTuple):
    groups: int           # G: tangent groups, a block each (1: primal)
    threads: int          # threads a block
    smem_fields: tuple    # the fields in shared memory, in FIELDS order
    fmask: int            # their bits (the index in FIELDS)
    smem_bytes: int       # dynamic shared memory a block
    scratch_elems: int    # values of global scratch a block


def tangent_groups(b: int, k: int, n_sm: int = N_SM) -> int:
    """G of a forward-mode launch of b options and k tangents: k, one
    tangent a block, when the b*k blocks fit in one wave at
    GROUP_BLOCKS_PER_SM, else 1 (all k in each option's block)."""
    return k if b * k <= GROUP_BLOCKS_PER_SM * n_sm else 1


def default_smem_budget(b: int, k: int, groups: int,
                        n_sm: int = N_SM) -> int:
    """Shared memory a block of the launch may take: the room of the
    blocks an SM the launch needs to run in one wave, capped at
    PRIMAL_BLOCKS_PER_SM (primal) or GROUP_BLOCKS_PER_SM (tangent groups);
    a forward-mode block with all k tangents is alone on its SM."""
    waves = -(-b * groups // n_sm)
    per_sm = (min(PRIMAL_BLOCKS_PER_SM, waves) if not k else
              min(GROUP_BLOCKS_PER_SM, waves) if groups > 1 else 1)
    return min(SMEM_PER_BLOCK,
               SMEM_PER_SM // max(1, per_sm) - SMEM_RESERVED)


def launch_plan(b: int, ns: int, nv: int, itemsize: int, scheme: str,
                american: bool, k: int = 0, *, n_sm: int = N_SM,
                smem_budget: Optional[int] = None,
                groups: Optional[int] = None) -> LaunchPlan:
    """Where a launch of the kernel keeps its working fields, decided from
    sizes before the launch: the shared rows first, then the fields in
    FIELDS order until the next one no longer fits in `smem_budget` bytes
    (None: default_smem_budget); the rest in global scratch. b options of
    [ns, nv] at `itemsize` bytes a value, k tangents (0: the primal loop)
    in `groups` (None: tangent_groups) groups of k/groups; the block's
    threads (WIDE_THREADS for a Douglas primal book or a forward-mode
    launch of at most two blocks an SM, and for a forward-mode block with
    all k tangents)."""
    if groups is None:
        groups = tangent_groups(b, k, n_sm) if k else 1
    if groups < 1 or (k % groups if k else groups != 1):
        raise ValueError(f"groups must divide the {k} tangents (1 for the "
                         f"primal loop), got {groups}")
    kg = k // groups
    if smem_budget is None:
        smem_budget = default_smem_budget(b, k, groups, n_sm)
    surface = surface_elems(ns, nv) * itemsize
    used = (itemsize * (_ROWS_S * ns + _ROWS_V * nv
                        + kg * (ns + _ROWS_TANGENT_V * nv)) + 4 * 2 * nv)
    smem, scratch = [], 0
    for f, n in field_counts(scheme, american, kg).items():
        if not scratch and used + n * surface <= smem_budget:
            smem.append(f)
            used += n * surface
        else:
            scratch += n * surface // itemsize
    wide = (groups == 1 or b * groups <= 2 * n_sm if k else
            scheme == "do" and b <= 2 * n_sm)
    return LaunchPlan(groups, WIDE_THREADS if wide else PRIMAL_THREADS,
                      tuple(smem), sum(1 << FIELDS.index(f) for f in smem),
                      used, scratch)


@functools.cache
def _sm_count(index: int) -> int:
    _sm_count.queries += 1
    return torch.cuda.get_device_properties(index).multi_processor_count


_sm_count.queries = 0


def occupancy(dtype: torch.dtype, ns: int, nv: int, scheme: str,
              american: bool, plan: LaunchPlan, k: int = 0,
              option_type: str = "call", knocked=()) -> dict:
    """The resources of the kernel a launch with `plan` takes on the
    current card (CUDA only, the launch's own build): registers a thread,
    dynamic shared memory a block (the kernel's own count, equal to the
    plan's) and resident blocks an SM of plan.threads threads
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the attributes the
    launch sets); k tangents, G = plan.groups."""
    lib = _library(use_fmad(dtype, None, k > 0))
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()]
    payoff = launch_flags(option_type, knocked, ns, nv)[0]
    rc = lib.fused_do_occupancy(
        int(dtype == torch.float64), int(k > 0), ns, nv, int(american),
        SCHEMES.index(scheme), payoff, int(remaps_apart(option_type,
                                                        knocked)),
        k, plan.groups, plan.fmask, plan.threads,
        *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"fused_do_occupancy failed: CUDA error {rc}")
    blocks, regs, smem = (x.value for x in out)
    return {"blocks_per_sm": blocks, "registers": regs,
            "threads": plan.threads,
            "smem_bytes": smem, "groups": plan.groups,
            "smem_fields": list(plan.smem_fields)}


def _launch(fields, ev_steps, remaps, *, theta, delta_t, n_steps, rf,
            american, tangents=None, first_step=1, nst=None, scheme="do",
            option_type="call", knocked=(), segment=None, fmad=None,
            smem_budget=None, groups=None):
    if scheme not in SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}; want one of {SCHEMES}")
    if segment is not None:
        fields = {**fields, **segment}
    u = fields["u"]
    dtype, dev = u.dtype, u.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_do kernel takes float32/float64, got {dtype}")
    if u.dim() != 3:
        raise ValueError(f"u must be [B, ns, nv], got {tuple(u.shape)}")
    b, ns, nv = u.shape
    shapes = {"lam": (b, ns, nv),
              **{k: (b, ns) for k in _KERNEL_S_KEYS},
              **{k: (b, nv) for k in _KERNEL_V_KEYS},
              **{k: (b,) for k in SCALAR_KEYS}}
    for k, shape in shapes.items():
        _check_field(k, fields[k], shape, dtype, dev)
    if tangents is not None:
        if not tangents:
            raise ValueError("tangents: want at least one direction")
        for t in tangents:
            for k in _TANGENT_KEYS:
                _check_field(f"tangent {k}", t[k],
                             (b, ns) if k in _TANGENT_S_KEYS else (b, nv),
                             dtype, dev)
        for key in ("du", "dlam"):
            state = fields.get(key)
            if state is not None and len(state) != len(tangents):
                raise ValueError(f"{key}: want one surface per tangent "
                                 f"({len(tangents)}), got {len(state)}")
            for x in state or ():
                _check_field(key, x, (b, ns, nv), dtype, dev)
    steps = check_events(ev_steps, remaps, first_step, n_steps, (b, ns),
                         dtype, dev)
    nst_ptr = 0      # a null pointer: every lane runs every step
    if nst is not None:
        if (nst.device != dev or nst.is_floating_point()
                or tuple(nst.shape) != (b,)):
            raise ValueError(f"nst must be ({b},) integers on {dev}, got "
                             f"{tuple(nst.shape)} {nst.dtype} on "
                             f"{nst.device}")
        nst = nst.to(torch.int32).contiguous()
        nst_ptr = nst.data_ptr()

    u0 = u.contiguous()
    lam0 = fields["lam"].contiguous()
    sf = torch.stack([fields[k] for k in _KERNEL_S_KEYS], 1).contiguous()
    vf = torch.stack([fields[k] for k in _KERNEL_V_KEYS], 1).contiguous()
    sc = torch.stack([fields[k] for k in SCALAR_KEYS], 1).contiguous()
    n_ev = len(steps)
    ev_step = torch.tensor(steps, dtype=torch.int32, device=dev)
    if n_ev:
        ev_idx = torch.stack([torch.stack([rm[0], rm[2]], 1)
                              for rm in remaps], 1).to(torch.int32)
        ev_w = torch.stack([torch.stack([rm[1], rm[3]], 1)
                            for rm in remaps], 1)
    else:
        ev_idx = torch.empty(b, 0, 2, ns, dtype=torch.int32, device=dev)
        ev_w = torch.empty(b, 0, 2, ns, dtype=dtype, device=dev)
    ev_idx, ev_w = ev_idx.contiguous(), ev_w.contiguous()
    out = torch.empty_like(u0)
    lam_out = torch.empty_like(u0)
    n_tan = 0 if tangents is None else len(tangents)
    plan = launch_plan(b, ns, nv, u0.element_size(), scheme, american, n_tan,
                       n_sm=_sm_count(dev.index if dev.index is not None
                                      else torch.cuda.current_device()),
                       smem_budget=smem_budget, groups=groups)
    # the fields the plan leaves out of shared memory, per block
    work = torch.empty(b * plan.groups * plan.scratch_elems, dtype=dtype,
                       device=dev)
    ptrs = [t.data_ptr() for t in (u0, lam0, out, lam_out, work, sf, vf, sc,
                                   ev_step, ev_idx, ev_w)] + [nst_ptr]
    if tangents is not None:
        tsf = torch.stack([t["sfac"] for t in tangents], 1).contiguous()
        tvf = torch.stack([torch.stack([t[k] for k in _KERNEL_TV_KEYS], 1)
                           for t in tangents], 1).contiguous()
        # the tangent state in ([B, K, ns, nv], a null pointer for zero;
        # dlam read by American loops only) and out
        state_in = [torch.stack(list(fields[key]), 1).contiguous()
                    if fields.get(key) is not None
                    and (key == "du" or american) else None
                    for key in ("du", "dlam")]
        du = torch.empty(b, n_tan, ns, nv, dtype=dtype, device=dev)
        dlam = torch.empty_like(du) if american else None
        ptrs += [0 if t is None else t.data_ptr()
                 for t in (tsf, tvf, *state_in, du, dlam)]

    flags = launch_flags(option_type, knocked, ns, nv)
    lib = _library(use_fmad(dtype, fmad, tangents is not None))
    name = "fused_do_tangent_" if tangents is not None else "fused_do_"
    fn = getattr(lib, name + ("f32" if dtype == torch.float32 else "f64"))
    ints = [b, ns, nv, first_step, n_steps, int(american), n_ev,
            SCHEMES.index(scheme), *flags,
            int(remaps_apart(option_type, knocked))]
    if tangents is not None:
        ints += [n_tan, plan.groups]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, *ints, plan.fmask, plan.threads, plan.scratch_elems,
                float(delta_t), float(theta * delta_t), float(rf),
                float((0.5 - theta) * delta_t), stream)
    if rc != 0:
        raise RuntimeError(f"{name}kernel launch failed: CUDA error {rc}")
    lam = lam_out if american else fields["lam"]
    if tangents is not None:
        fused_do_loop.tangent_launches += 1
        dlams = (dlam.unbind(1) if american
                 else _tangent_state(fields, n_tan, u)[1].unbind(0))
        return out, lam, list(du.unbind(1)), list(dlams)
    fused_do_loop.launches += 1
    return out, lam


@scope("loop")
def fused_do_loop(fields, ev_steps, remaps, *, theta: float, delta_t: float,
                  n_steps: int, rf, american: bool, tangents=None,
                  first_step: int = 1, nst=None, scheme: str = "do",
                  option_type: str = "call", knocked=(), segment=None,
                  fmad: Optional[bool] = None, smem_budget=None,
                  groups=None):
    """The ADI time loop of a book over the local steps
    first_step..n_steps (one launch of `phase_plan`) under `scheme` (one
    of SCHEMES): (u, lam), the terminal surfaces [B, ns, nv] and the
    multiplier unscaled for the next launch; with `tangents` (K dicts of
    `_TANGENT_KEYS` fields), (u, lam, [du_k], [dlam_k]) from the
    forward-mode variant, which starts from the tangent state
    fields["du"], fields["dlam"] (zero where absent). `nst` (optional,
    [B] integers): each lane's last local step, a mixed-maturity book in
    the same launch. `option_type`, `knocked`: the payoff and a barrier's
    knocked s columns; `segment`: a rate segment's fields in place of
    `fields`' own (see fused_do_reference). Launches csrc/fused_do.cu (one launch, every
    dividend event of the phase included; the build `use_fmad(dtype,
    fmad, tangents is not None)`) for CUDA tensors and counts the launch in
    `fused_do_loop.launches` (primal) or `fused_do_loop.tangent_launches`
    (forward mode); runs fused_do_reference for CPU tensors (`fmad` has no
    meaning there); raises for any other device. `smem_budget` and
    `groups` (private, for tests and measurements) override
    `launch_plan`'s shared-memory budget and tangent groups; no entry
    point passes them."""
    dev = fields["u"].device
    kw = dict(theta=theta, delta_t=delta_t, n_steps=n_steps, rf=rf,
              american=american, tangents=tangents, first_step=first_step,
              nst=nst, scheme=scheme, option_type=option_type,
              knocked=knocked, segment=segment)
    if dev.type == "cpu":
        return fused_do_reference(fields, ev_steps, remaps, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_do runs on cuda or cpu tensors, got {dev}")
    return _launch(fields, ev_steps, remaps, **kw, fmad=fmad,
                   smem_budget=smem_budget, groups=groups)


fused_do_loop.launches = 0
fused_do_loop.tangent_launches = 0

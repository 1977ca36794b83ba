"""Kernel 1, the batched ADI time loop of a book: its plans, the CUDA
kernel's wrapper and its plain PyTorch version.

PyTorch counterpart of `heston_tpu.pallas.fused_do` for the four schemes
of `SolverConfig.scheme` (Douglas, Craig-Sneyd, modified Craig-Sneyd,
Hundsdorfer-Verwer) with calls, puts and cash-or-nothing digitals
(`option_type`), with or without a knock-out barrier (`GridSpec.barrier`),
European or American, with or without discrete dividends, at flat rates
or on a piecewise-constant rate curve (`config.RateSchedule`), with or
without Rannacher start-up damping (whose damp phase is always Douglas).
Each phase of the time loop (`assembly.phase_plan`: the main phase, after
the damp phase when there is one) runs in ONE launch of
`csrc/fused_do.cu` (one thread block per option; every dividend event of
the phase inside the same launch), a mixed-maturity book too: with
per-option step counts each option's block stops at its own count. A
curve book splits each phase at its rate segments' boundaries, one
launch per piece with that segment's fields and boundary rate
(`assembly.assemble_rate_segments`). `fused_surface_batch` returns the
terminal surfaces and the operator set that book risk reads.

The plan of a book comes two ways. `book_plan` assembles it on the host
with PyTorch operations (`assembly.assemble` and the remaps: a few
hundred small kernels on the card), as field dicts; `device_book_plan`
packs it in the kernel's own layout (`BookPlan`), and for CUDA strikes
builds it on the card in one launch of `book_plan_kernel`
(csrc/fused_do.cu, one block an option, the arithmetic of csrc/plan.cuh
that the single-option plan kernel shares), with nothing read back to
the host. `fused_price_batch` runs a flat-rate book through
`device_book_plan` on either device and `run_book_plan` launches the
kernel straight from the packed buffers; a curve book and book risk's
surfaces keep `book_plan`'s dicts (they need the segments or the
operator set). `fused_do_reference` computes the same
algebra with tensor ops and Python loops over steps and sweep rows; the
wrapper `fused_do_loop` takes it only for tensors on the CPU. A batch of
one goes to kernel 2 instead (the layers: `kernels.assembly`). One
launch path: `_launch` checks and packs a field dict (`_pack`, which
`pack_book_plan` uses per phase) for `_launch_packed`, which alone takes
a build (`fmad`) or a launch plan (`plan`).

Forward mode: given K tangent field sets (the JVP of the assembly along K
parameter directions, `_TANGENT_KEYS`), the same launch also carries K
tangent surfaces through the loop, each implicit solve reusing the primal
factorization (dx = T^-1 (dr - dT x)), and hands its tangent state on to
the next phase as it does u and lambda. `fused_theta_jacobian` builds the
calibration Jacobian from it, with four tangents (the v0 column off the
surface stencil) or five (v0_mode "ad", the v-grid's motion). Which
Jacobians take the card plan: a flat-rate book's on CUDA strikes under
v0_mode "stencil" (`packed_jacobian`: the book's plan kernel, then
`tangent_rows_kernel` writes the four directions' rows in the packed
layout, one launch, and kernel 1's forward mode launches straight from
both, `run_book_plan(plan, tangent)`); CPU strikes and v0_mode "ad"
(whose v0 direction moves the v-grid) keep the host's vmap over jvp of
the assembly (`linearized_jacobian`, `_linearized_assemble`).

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
barrier (`assembly.barrier_positions`). It rebuilds the American floor
from the s-grid (the put intrinsic, or the digitals' clipped cell
average), zero at knocked columns; puts, digitals and top-knocked
barriers take the -r_d/2 reaction on every A2 row (`n_react = nv`); an
American digital is projected onto [floor, 1] with its full-payoff nodes
pinned, and keeps its multiplier. Knocked columns stay exactly zero: the
payoff and the boundary data arrive masked and every operator keeps a
zero column at zero.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from heston_tpu_torch.config import DividendSchedule, GridSpec, SolverConfig
from heston_tpu_torch.kernels.assembly import (
    BIG_KEYS, KERNEL_S_KEYS, KERNEL_V_KEYS, SCALAR_KEYS, SCHEMES, PlanPhases,
    assemble, assemble_rate_segments, barrier_positions, build_remap_fields,
    check_scheme, check_slice, exercise_floor, loop_kwargs, market_buffer,
    n_react, penta_factors, phase_plan, plan_args, plan_phases,
    remaps_apart, run_phases, run_plan_kernel, two_sum)
from heston_tpu_torch.kernels.cuda_build import (
    build, check_dtype, check_events, check_field, check_fields,
    launch_flags, on_card, use_fmad)
from heston_tpu_torch.ops import coeff, operators
from heston_tpu_torch.ops.operators import b1_mask, shift
from heston_tpu_torch.utils.profiling import scope

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

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_do.cu"

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
_ROWS_S = len(KERNEL_S_KEYS) + 1
_ROWS_V = len(KERNEL_V_KEYS) + 5
_ROWS_TANGENT_V = len(_KERNEL_TV_KEYS)
# An H100's shared memory (NVIDIA's Hopper tuning guide): 228 KB an SM, of
# which one block may opt into 227 KB, and each resident block costs 1 KB
# more; 132 SMs
SMEM_PER_SM = 233_472
SMEM_PER_BLOCK = 232_448
SMEM_RESERVED = 1_024
N_SM = 132
# resident blocks an SM a placement keeps room for: a primal book's (500
# options in one wave on 132 SMs at 4; the bounded kernel's launch bounds
# ask for as many, `bounded_kernel`), a tangent group block's at most
PRIMAL_BLOCKS_PER_SM = 4
GROUP_BLOCKS_PER_SM = 3
# threads of a block: 128, or 256 for a block with an SM to itself or one
# other (a Douglas primal book or a forward-mode launch of at most two
# blocks an SM, a forward-mode block with all K tangents)
PRIMAL_THREADS = 128
WIDE_THREADS = 256


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
    (`assemble_rate_segments`), whose boundary rate and fields each
    launch takes instead (the loop's `segment`)."""
    spans = None if segments is None else [s[:2] for s in segments]
    launches = []
    for ph in phase_plan(solver, dividends, nsteps, spans):
        kw = dict(loop_kwargs(ph, rf, american, option_type, knocked),
                  nst=ph["nst"])
        if segments is not None:
            _, _, kw["rf"], seg = segments[ph["segment"]]
            kw["segment"] = {k: v for k, v in seg.items()
                             if k not in BIG_KEYS}
        launches.append((
            [e[0] for e in ph["events"]],
            build_remap_fields(vec_s, ph["events"], ph["nst"], option_type,
                               knocked), kw))
    return launches


@scope("book_plan")
def book_plan(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d,
              r_f, american=False, dividends=None, option_type="call",
              n_steps_per=None, rate_schedule=None, epilogue=False):
    """Assembly and launch plan of a book (`strikes` [B]) on the batched
    kernel: (fields, phases, (idx_s, idx_v), ops, vec_s); `run_phases`
    runs it. `n_steps_per`: optional per-option step counts (see
    `check_slice`); `rate_schedule`: an optional `config.RateSchedule`,
    whose segments each take their own launches (the scalar r_d, r_f are
    then not read; `assemble_rate_segments`); `epilogue`: the operator
    set with its dense fields (a curve book's: its last segment's).
    Counts each plan in `book_plan.calls` and its options in
    `book_plan.lanes`."""
    nst = check_slice(spec, solver, option_type, n_steps_per,
                      strikes=strikes)
    nst = None if nst is None else nst.to(strikes.device)
    book_plan.calls += 1
    book_plan.lanes += int(strikes.shape[0])
    knocked = barrier_positions(spec)
    if rate_schedule is None:
        fields, vec_s, idx_s, idx_v, ops = assemble(
            spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
            nst, epilogue, option_type)
        phases = book_phases(solver, dividends, vec_s,
                             operators.boundary_rate(r_d, r_f, option_type),
                             american, nst, option_type, knocked)
    else:
        segments, vec_s, idx_s, idx_v, ops = assemble_rate_segments(
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
    (ValueError).

    A flat-rate book takes its packed plan (`device_book_plan`: on the
    card the plan kernel, on the CPU `book_plan` packed), one launch a
    phase straight from it (`run_book_plan`) and the prices gathered at
    the plan's nodes, with nothing read back to the host before the
    caller's own copy; a curve book takes `book_plan`'s field dicts, one
    launch a phase and segment piece."""
    if rate_schedule is None:
        plan = device_book_plan(
            spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
            american, dividends, option_type, n_steps_per)
        u, _ = run_book_plan(plan)
        return torch.take(u, plan.at)
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


# ---------------------------------------------------------------------------
# a book's packed plan, built on the card by the book's plan kernel
# ---------------------------------------------------------------------------

class BookPlan(NamedTuple):
    """The launches of a flat-rate book in kernel 1's packed layout: what
    `_launch_packed` reads, one launch a phase. Phase p's events are one
    block [B, count, 2, ns] of ev_idx and ev_w (flat), after the blocks of
    the phases before it (`book_phase_events`)."""

    u: torch.Tensor        # [B, ns, nv] the payoff on every v column
    lam: torch.Tensor      # [B, ns, nv] zeros
    sf: torch.Tensor       # [B, 11, ns] s-rows, KERNEL_S_KEYS order
    vf: torch.Tensor       # [B, 9, nv] v-columns, KERNEL_V_KEYS order
    sc: torch.Tensor       # [B, 2] b1v, kk
    ev_step: torch.Tensor  # int32 [n_ev] each event's local step
    ev_idx: torch.Tensor   # int32 [n_ev * B * 2 * ns] source columns
    ev_w: torch.Tensor     # [n_ev * B * 2 * ns] weights w0, w1
    nst: Optional[torch.Tensor]  # int32 [phases, B] or None (uniform)
    at: torch.Tensor       # int64 [B] b*ns*nv + idx_s*nv + idx_v
    phases: list           # per phase: (first event, events, loop kwargs)


def book_phase_events(plan: BookPlan, p: int):
    """Phase p's (event steps int32 [count], ev_idx int32 and ev_w
    [B, count, 2, ns], nst int32 [B] or None): views of the plan."""
    first, count, _ = plan.phases[p]
    b, ns, _ = plan.u.shape
    lo, hi = b * first * 2 * ns, b * (first + count) * 2 * ns
    return (plan.ev_step[first:first + count],
            plan.ev_idx[lo:hi].view(b, count, 2, ns),
            plan.ev_w[lo:hi].view(b, count, 2, ns),
            None if plan.nst is None else plan.nst[p])


def _pack(fields, ev_steps, remaps, nst=None):
    """`_launch_packed`'s buffers of a field dict and one launch's events:
    the one packer of kernel 1, for `_launch` and `pack_book_plan`."""
    u = fields["u"]
    b, ns, _ = u.shape
    if remaps:
        ev_idx = torch.stack([torch.stack([rm[0], rm[2]], 1)
                              for rm in remaps], 1).to(torch.int32)
        ev_w = torch.stack([torch.stack([rm[1], rm[3]], 1)
                            for rm in remaps], 1)
    else:
        ev_idx = torch.empty(b, 0, 2, ns, dtype=torch.int32, device=u.device)
        ev_w = torch.empty(b, 0, 2, ns, dtype=u.dtype, device=u.device)
    return (u.contiguous(), fields["lam"].contiguous(),
            torch.stack([fields[k] for k in KERNEL_S_KEYS], 1).contiguous(),
            torch.stack([fields[k] for k in KERNEL_V_KEYS], 1).contiguous(),
            torch.stack([fields[k] for k in SCALAR_KEYS], 1).contiguous(),
            torch.tensor(list(ev_steps), dtype=torch.int32, device=u.device),
            ev_idx.contiguous(), ev_w.contiguous(),
            None if nst is None else nst.to(torch.int32).contiguous())


def pack_book_plan(fields, phases, at) -> BookPlan:
    """`book_plan`'s (fields, phases, (idx_s, idx_v)) of a flat-rate book
    as a BookPlan: each phase packed by `_pack`, the events of every phase
    in processing order, each phase's nst a row, the nodes as flat
    indices."""
    packed = [_pack(fields, steps, remaps, kw["nst"])
              for steps, remaps, kw in phases]
    b, ns, nv = fields["u"].shape
    out, first = [], 0
    for steps, _, kw in phases:
        # nst is the plan's own row
        out.append((first, len(steps),
                    {k: v for k, v in kw.items() if k != "nst"}))
        first += len(steps)
    idx_s, idx_v = at
    return BookPlan(
        *packed[0][:5], torch.cat([p[5] for p in packed]),
        torch.cat([p[6].reshape(-1) for p in packed]),
        torch.cat([p[7].reshape(-1) for p in packed]),
        None if packed[0][8] is None else torch.stack(
            [p[8] for p in packed]),
        (torch.arange(b, device=idx_s.device) * (ns * nv) + idx_s * nv
         + idx_v).to(torch.int64),
        out)


def device_book_plan(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    n_steps_per=None,
) -> BookPlan:
    """The launches of a flat-rate book (`strikes` [B]) on the batched
    kernel, packed (`BookPlan`). CUDA strikes: built on the card by the
    book's plan kernel (`book_plan_kernel`, one block an option; one
    launch for up to PLAN_EVENTS dividend events, one more for each
    PLAN_EVENTS after them) on the current stream, the per-lane step
    counts (`n_steps_per`, validated on the host) uploaded in one copy,
    nothing read back to the host; the market as numbers (by value) or
    tensors (`market_buffer`, read on the card). Counts each plan in
    `book_plan.calls` and `.lanes` and each launch in
    `device_book_plan.launches`. CPU strikes: `book_plan` packed
    (`pack_book_plan`)."""
    args = (spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
            american, dividends, option_type, n_steps_per)
    if strikes.dim() != 1:
        raise ValueError(f"device_book_plan takes strikes [B], got "
                         f"{tuple(strikes.shape)}")
    if on_card(strikes, "device_book_plan"):
        return _device_book_plan(*args)
    return pack_book_plan(*book_plan(*args)[:3])


@scope("book_plan")
def _device_book_plan(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
                      r_d, r_f, american, dividends, option_type,
                      n_steps_per) -> BookPlan:
    nst = check_slice(spec, solver, option_type, n_steps_per,
                      strikes=strikes)
    # each block reads strikes[b] at strikes + b
    strikes = strikes.contiguous()
    dtype, dev = strikes.dtype, strikes.device
    check_dtype(dtype, "the plan kernel")
    market = (s0, kappa, eta, sigma, rho, v0, r_d, r_f)
    buf = market_buffer(market, dev)
    a = plan_args(spec, solver, market, buf, option_type)
    b, ns, nv = int(strikes.shape[0]), spec.m1 + 1, spec.m2 + 1
    events, phases = plan_phases(spec, solver, dividends, american,
                                 option_type, r_d, r_f)
    # with R > 0 the first phase is the damp one (phase_plan)
    r = (min(solver.rannacher_steps, solver.n_steps)
         if solver.rannacher_steps else 0)
    ph = PlanPhases(n=len(phases), rannacher=r)
    for p, (first, count, _) in enumerate(phases):
        ph.first[p], ph.count[p], ph.damp[p] = first, count, int(r and not p)
    n_ev = len(events)
    # the one upload: pinned, so the copy waits for nothing
    nst_in = (None if nst is None else nst.to(torch.int32).pin_memory().to(
        dev, non_blocking=True))
    out = BookPlan(
        torch.empty(b, ns, nv, dtype=dtype, device=dev),
        torch.empty(b, ns, nv, dtype=dtype, device=dev),
        torch.empty(b, len(KERNEL_S_KEYS), ns, dtype=dtype, device=dev),
        torch.empty(b, len(KERNEL_V_KEYS), nv, dtype=dtype, device=dev),
        torch.empty(b, len(SCALAR_KEYS), dtype=dtype, device=dev),
        torch.empty(n_ev, dtype=torch.int32, device=dev),
        torch.empty(n_ev * b * 2 * ns, dtype=torch.int32, device=dev),
        torch.empty(n_ev * b * 2 * ns, dtype=dtype, device=dev),
        None if nst is None else torch.empty(ph.n, b, dtype=torch.int32,
                                             device=dev),
        torch.empty(b, dtype=torch.int64, device=dev), phases)
    lib = _library(use_fmad(dtype))
    fn = lib.book_plan_f32 if dtype == torch.float32 else lib.book_plan_f64
    ptrs = [None if buf is None else buf.data_ptr(), strikes.data_ptr(),
            None if nst_in is None else nst_in.data_ptr(),
            *(t.data_ptr() for t in out[:8]),
            None if out.nst is None else out.nst.data_ptr(),
            out.at.data_ptr()]
    book_plan.calls += 1
    book_plan.lanes += b
    device_book_plan.launches += run_plan_kernel(
        fn, "book_plan", a, events, (ctypes.byref(ph),), ptrs, (b,), dev)
    return out


device_book_plan.launches = 0


def run_book_plan(plan: BookPlan, tangent=None):
    """(u, lam) after every phase of a packed book plan, one launch of
    kernel 1 a phase: on the card straight from the packed buffers
    (`_launch_packed`, in the `loop` span), on the CPU through
    `fused_do_loop`'s field dict (its plain version). `tangent`: the
    forward mode's rows (tsf [B, K, ns], tvf [B, K, 8, nv], as
    `tangent_rows` gives them), each launch the forward-mode variant with
    the tangent state du, dlam handed from phase to phase as u and lam
    are: (u, lam, du [B, K, ns, nv], dlam [B, K, ns, nv] or None for a
    European book)."""
    u, lam = plan.u, plan.lam
    state = () if tangent is None else (None, None)
    for p, (_, _, kw) in enumerate(plan.phases):
        steps, idx, w, nst = book_phase_events(plan, p)
        if u.device.type == "cpu":
            fields = {"u": u, "lam": lam,
                      **dict(zip(KERNEL_S_KEYS, plan.sf.unbind(1))),
                      **dict(zip(KERNEL_V_KEYS, plan.vf.unbind(1))),
                      **dict(zip(SCALAR_KEYS, plan.sc.unbind(1)))}
            remaps = [(i[:, 0].long(), ww[:, 0], i[:, 1].long(), ww[:, 1])
                      for i, ww in zip(idx.unbind(1), w.unbind(1))]
            if tangent is None:
                u, lam = fused_do_loop(fields, steps.tolist(), remaps,
                                       nst=nst, **kw)
                continue
            fields.update((k, None if s is None else list(s.unbind(1)))
                          for k, s in zip(("du", "dlam"), state))
            u, lam, dus, dlams = fused_do_loop(
                fields, steps.tolist(), remaps, nst=nst, **kw,
                tangents=_unpack_tangents(*tangent))
            state = (torch.stack(dus, 1),
                     torch.stack(dlams, 1) if kw["american"] else None)
        else:
            with scope("loop"):
                if tangent is None:
                    u, lam = _launch_packed(u, lam, plan.sf, plan.vf,
                                            plan.sc, steps, idx, w, nst, **kw)
                    continue
                u, lam, *state = _launch_packed(
                    u, lam, plan.sf, plan.vf, plan.sc, steps, idx, w, nst,
                    **kw, tangent=(*tangent, *state))
    return (u, lam, *state)


def _unpack_tangents(tsf, tvf):
    """The K tangent field dicts (`_TANGENT_KEYS`) of the forward mode's
    packed rows, for the plain version: bv0 and ad zero, as the loop
    reads neither (its tangent bands are zero-sum)."""
    zero = torch.zeros_like(tvf[:, 0, 0])
    return [{"sfac": tsf[:, k], "bv0": zero, "ad": zero,
             **dict(zip(_KERNEL_TV_KEYS, tvf[:, k].unbind(1)))}
            for k in range(tsf.shape[1])]


def tangent_rows(plan: BookPlan, theta_vec: torch.Tensor, a2_variant: str):
    """The forward mode's rows of a flat-rate book's Jacobian under
    v0_mode "stencil": (tsf [B, K, ns], tvf [B, K, 8, nv]) with K =
    JAC_TANGENTS directions (kappa, eta, sigma, rho) at theta_vec (its
    first four; on the plan's device, in its dtype), in the layout
    `_launch_packed` reads (`_KERNEL_TV_KEYS` order), from the packed
    plan's s-grid and v-grid rows. These directions leave both grids
    where they are, so each row is a closed form of the grids and the
    market: what `_linearized_assemble`'s vmap over jvp gives, bitwise.
    `a2_variant`: the A2 bands' ("central" or "upwind"). CUDA: one launch
    of csrc/fused_do.cu's tangent_rows_kernel (one block an option),
    counted in `tangent_rows.launches`; CPU: its plain version."""
    if a2_variant not in ("central", "upwind"):
        raise ValueError(f"unknown A2 variant: {a2_variant!r}")
    sf, vf = plan.sf, plan.vf
    b, _, ns = sf.shape
    nv = vf.shape[2]
    dtype, dev = sf.dtype, sf.device
    if (theta_vec.dtype, theta_vec.device) != (dtype, dev) or \
            theta_vec.dim() != 1 or theta_vec.shape[0] < JAC_TANGENTS:
        raise ValueError(f"theta_vec: want at least {JAC_TANGENTS} {dtype} "
                         f"values on {dev}, got {tuple(theta_vec.shape)} "
                         f"{theta_vec.dtype} on {theta_vec.device}")
    upwind = a2_variant == "upwind"
    if not on_card(sf, "tangent_rows"):
        return _tangent_rows_plain(
            theta_vec, sf[:, KERNEL_S_KEYS.index("vecs")],
            vf[:, KERNEL_V_KEYS.index("vfl")], upwind)
    theta = theta_vec.contiguous()
    tsf = torch.empty(b, JAC_TANGENTS, ns, dtype=dtype, device=dev)
    tvf = torch.empty(b, JAC_TANGENTS, _ROWS_TANGENT_V, nv, dtype=dtype,
                      device=dev)
    lib = _library(use_fmad(dtype, None, True))
    fn = lib.tangent_rows_f32 if dtype == torch.float32 \
        else lib.tangent_rows_f64
    with torch.cuda.device(dev):
        rc = fn(theta.data_ptr(), sf.data_ptr(), vf.data_ptr(),
                tsf.data_ptr(), tvf.data_ptr(), b, ns, nv, int(upwind),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"tangent_rows kernel launch failed: CUDA error "
                           f"{rc}")
    tangent_rows.launches += 1
    return tsf, tvf


tangent_rows.launches = 0


def _tangent_rows_plain(theta, vecs, vfl, upwind: bool):
    """Plain version of tangent_rows_kernel from each lane's s-grid vecs
    [B, ns] and v-grid vfl [B, nv]: the JVP of `assembly.assemble`'s sfac
    and A2 bands (`operators.build_a2_bands`) along (kappa, eta, sigma,
    rho) written out, operation for operation as the host's JVP rounds
    it. temp = kappa (eta - v) moves by eta - v along kappa and by kappa
    along eta, temp2 = sigma^2 v / 2 by sigma v along sigma (the sum of
    its two halves, exact); each band's weights stay put."""
    kappa, eta, sigma, rho = theta[:JAC_TANGENTS].unbind()
    b, ns = vecs.shape
    nv = vfl.shape[1]
    m2 = nv - 1
    tsf = vecs.new_zeros(b, JAC_TANGENTS, ns)
    tsf[:, 2, 1:ns - 1] = rho * vecs[:, 1:ns - 1]
    tsf[:, 3, 1:ns - 1] = sigma * vecs[:, 1:ns - 1]
    tvf = vfl.new_zeros(b, JAC_TANGENTS, _ROWS_TANGENT_V, nv)
    l2, l1, u1, u2 = (tvf[:, :, _KERNEL_TV_KEYS.index(k)]
                      for k in ("al2", "al1", "au1", "au2"))

    def dtemps(v):
        """The tangents [B, K, n] of temp and temp2 at the nodes v
        [B, n]."""
        z = torch.zeros_like(v)
        return (torch.stack([eta - v, kappa.expand_as(v), z, z], 1),
                torch.stack([z, z, sigma * v, z], 1))

    dv = vfl[:, 1:] - vfl[:, :-1]
    _, g1, g2 = coeff.w_gamma(dv[:, 1:2], dv[:, 2:3])
    dt0, _ = dtemps(vfl[:, :1])
    u1[:, :, :1] += dt0 * g1[:, None]
    u2[:, :, :1] += dt0 * g2[:, None]
    h0, h1 = dv[:, :m2 - 2], dv[:, 1:m2 - 1]
    dm, _, dp = (w[:, None] for w in coeff.w_delta(h0, h1))
    bm, _, bp = (w[:, None] for w in coeff.w_beta(h0, h1))
    dt, dt2 = dtemps(vfl[:, 1:m2 - 1])
    l1[:, :, 1:m2 - 1] += dt * bm + dt2 * dm
    u1[:, :, 1:m2 - 1] += dt * bp + dt2 * dp
    if upwind:
        am, a1, _ = (w[:, None] for w in coeff.w_alpha(h0, h1))
        mask = (vfl[:, None, 1:m2 - 1] > 1.0).to(vfl.dtype)
        l2[:, :, 2:m2] += mask * dt * am
        l1[:, :, 2:m2] += mask * (dt * a1 + dt2 * dm)
        u1[:, :, 2:m2] += mask * dt2 * dp
    return tsf, tvf


@scope("linearize")
def _linearized_assemble(spec, solver, strikes, s0, theta_vec, r_d, r_f,
                         nsteps=None, option_type="call",
                         v0_mode="stencil"):
    """The assembly at theta_vec = (kappa, eta, sigma, rho, v0) and its
    JVP along the basis directions of (kappa, eta, sigma, rho) at fixed
    v0 (v0_mode "stencil", JAC_TANGENTS directions) or of all five ("ad":
    the v0 direction moves the v-grid through the v0 node's insertion,
    ops.grid.make_v_nodes) — the counterpart of the JAX package's
    `jax.linearize` over `assemble` (fused_theta_jacobian,
    heston_tpu/pallas/fused_do.py:2039-2074). `nsteps`: optional
    per-option step counts (parameter-free); `option_type`: the payoff.

    One pass: `torch.func.vmap` over `torch.func.jvp` pushes the basis
    tangents through the assembly together; the primal fields come back
    as the (unbatched) aux output, equal to `assemble`'s.
    Returns (fields, tangents, vec_s, idx_s, idx_v) with tangents a list
    of K dicts of the `_TANGENT_KEYS` fields."""
    n_tg = _n_tangents(v0_mode)

    def prep(tv):
        full = torch.cat([tv, theta_vec[n_tg:]])
        f, vec_s, idx_s, idx_v, _ = assemble(
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


@scope("jacobian")
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
    forward-mode AD: the tangent rows of the assembly, then the
    forward-mode time loop carries the primal and the tangent surfaces
    through one launch per phase of `phase_plan` (two with Rannacher
    start-up damping: the state u, lam and the tangents du_k, dlam_k
    handed from the damp launch to the main one; the CUDA kernel for a
    CUDA `strikes`, the plain version for a CPU one). Counterpart of
    heston_tpu.pallas.fused_do.fused_theta_jacobian; device and dtype
    come from `strikes`.

    Two routes to the same numbers, chosen by what the call shows: CUDA
    strikes under v0_mode "stencil" take the card plan
    (`packed_jacobian`: the book's plan kernel, the tangent-rows kernel
    and kernel 1's forward mode straight from their packed buffers, no
    host assembly); CPU strikes and v0_mode "ad" take the host's
    linearized assembly (`linearized_jacobian`). Curve books and the
    eager engines never reach here (their Jacobian linearizes the eager
    loop, `calibration.jacobian_and_prices_ad`).

    v0_mode: "stencil" carries the JAC_TANGENTS directions (kappa, eta,
    sigma, rho) and reads the v0 column off the primal surface with the
    discretization's v-stencil (`_v0_stencil_col`); "ad" carries all five,
    the v0 column the grid-motion tangent (heston_tpu/pallas/fused_do.py:
    2039-2074; far worse conditioned in float32).
    n_steps_per: optional per-option step counts — a whole mixed-maturity
    Jacobian, primal and tangents, in one launch per phase (see
    fused_price_batch)."""
    _n_tangents(v0_mode)             # ValueError for an unknown mode
    theta_vec = torch.as_tensor(theta_vec, dtype=strikes.dtype,
                                device=strikes.device)
    if v0_mode == "stencil" and on_card(strikes, "fused_theta_jacobian"):
        return packed_jacobian(spec, solver, strikes, s0, theta_vec, r_d,
                               r_f, american, dividends, option_type,
                               n_steps_per)
    return linearized_jacobian(spec, solver, strikes, s0, theta_vec, r_d,
                               r_f, american, dividends, option_type,
                               n_steps_per, v0_mode)


def linearized_jacobian(spec, solver, strikes, s0, theta_vec, r_d, r_f,
                        american=False, dividends=None, option_type="call",
                        n_steps_per=None, v0_mode="stencil"):
    """`fused_theta_jacobian` by the host's linearized assembly
    (`_linearized_assemble`: the primal fields and the tangent fields as
    dicts), the remaps of `book_phases` and one forward-mode launch a
    phase from the dicts (`run_phases`); theta_vec a tensor of the
    strikes' dtype on their device. Either device and either v0_mode."""
    nst = check_slice(spec, solver, option_type, n_steps_per,
                      strikes=strikes)
    nst = None if nst is None else nst.to(strikes.device)
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


def packed_jacobian(spec, solver, strikes, s0, theta_vec, r_d, r_f,
                    american=False, dividends=None, option_type="call",
                    n_steps_per=None):
    """`fused_theta_jacobian` of a flat-rate book under v0_mode "stencil"
    from its packed plan: the primal plan (`device_book_plan` at
    theta_vec, on the card the book's plan kernel), the forward mode's
    rows (`tangent_rows`, on the card one launch), one forward-mode launch
    of kernel 1 a phase straight from both (`run_book_plan`), and the
    Jacobian read off the terminal surfaces at the plan's nodes as
    `_read_jacobian` reads it. The same prices and Jacobian as the host
    route's linearized assembly, with nothing assembled or read back on
    the host. Either device (the CPU runs the plain versions);
    `fused_theta_jacobian` takes it for CUDA strikes."""
    plan = device_book_plan(spec, solver, strikes, s0, *theta_vec.unbind(),
                            r_d, r_f, american, dividends, option_type,
                            n_steps_per)
    u, _, du, _ = run_book_plan(
        plan, tangent_rows(plan, theta_vec, solver.a2_variant))
    b, ns, nv = u.shape
    node = plan.at - torch.arange(b, device=u.device) * (ns * nv)
    return _read_jacobian(spec, u, du.unbind(1),
                          plan.vf[:, KERNEL_V_KEYS.index("vfl")],
                          node // nv, node % nv, theta_vec[4])


# ---------------------------------------------------------------------------
# the time loop: plain version
# ---------------------------------------------------------------------------

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
    identity rows for such lanes (`build_remap_fields`).

    The state enters as fields["u"] and fields["lam"]. The LCP multiplier
    crosses launches unscaled and is carried dt-scaled inside one: dt*lam
    on entry, lam_carry/dt on exit (the JAX kernel's convention,
    heston_tpu/pallas/fused_do.py:1159, :1248), so a phase at delta_t/2
    hands the next one the same multiplier. A European loop never
    touches it and hands fields["lam"] back.

    ev_steps: the local step of each dividend event (applied before that
    step); remaps: the matching (i0, w0, i1, w1) fields of
    build_remap_fields. rf: the boundary growth rate
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
    check_scheme(scheme)
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
    # pentadiagonal factorization of I - td*A2 along v, [B, nv] each
    pm, pgm, phm, pc, pc2 = (torch.stack(x, 1) for x in penta_factors(f, td))

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
                u, e2 = two_sum(wsum * u, remap_acc(u))
                comp = comp_r + e2
            else:
                # fold the compensation into u, remap in difference
                # form, and restart the compensation from the remap's own
                # rounding
                src = u + comp
                u, comp = two_sum(wsum * src, remap_acc(src))
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
    for name in ("book_plan_f32", "book_plan_f64"):
        fn = getattr(lib, name)
        # PlanArgs*, PlanEvents*, PlanPhases*; market (float64 [8] or
        # null), strikes, nst_in (int32 [B] or null), u0, lam0, sf, vf, sc,
        # ev_step, ev_idx, ev_w, nst_out, at; B; stream
        fn.argtypes = [p] * 16 + [i, p]
        fn.restype = ctypes.c_int
    for name in ("tangent_rows_f32", "tangent_rows_f64"):
        fn = getattr(lib, name)
        # theta, sf, vf, tsf, tvf; B, ns, nv, upwind; stream
        fn.argtypes = [p] * 5 + [i] * 4 + [p]
        fn.restype = ctypes.c_int
    return lib


_library.loads = 0


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


def bounded_kernel(dtype: torch.dtype, scheme: str, threads: int,
                   k: int = 0) -> bool:
    """Whether a launch takes the kernel compiled for PRIMAL_BLOCKS_PER_SM
    resident blocks of PRIMAL_THREADS (at most 128 registers a thread), as
    csrc/fused_do.cu's kernel_for chooses from the launch's dtype, scheme,
    threads and tangents: a corrector's primal loop, and float64 Douglas's
    primal at PRIMAL_THREADS (the compiler's own choice, 131 registers,
    keeps it at 3 blocks an SM); float32 Douglas, the 256-thread launches
    and the forward mode are unbounded."""
    return not k and (scheme != "do" or (dtype == torch.float64
                                         and threads == PRIMAL_THREADS))


def _occupancy_query(fmad: bool, dtype: torch.dtype, ns: int, nv: int,
                     american: bool, scheme: str, payoff: int, apart: bool,
                     k: int, plan: LaunchPlan):
    """(resident blocks an SM, registers a thread, dynamic shared bytes a
    block) of the kernel a launch takes on the current card, from the
    build `fmad`'s fused_do_occupancy."""
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()]
    rc = _library(fmad).fused_do_occupancy(
        int(dtype == torch.float64), int(k > 0), ns, nv, int(american),
        SCHEMES.index(scheme), payoff, int(apart), k, plan.groups,
        plan.fmask, plan.threads, *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"fused_do_occupancy failed: CUDA error {rc}")
    return tuple(x.value for x in out)


def occupancy(dtype: torch.dtype, ns: int, nv: int, scheme: str,
              american: bool, plan: LaunchPlan, k: int = 0,
              option_type: str = "call", knocked=()) -> dict:
    """The resources of the kernel a launch with `plan` takes on the
    current card (CUDA only, the launch's own build): registers a thread,
    dynamic shared memory a block (the kernel's own count, equal to the
    plan's), resident blocks an SM of plan.threads threads
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the attributes the
    launch sets) and whether the kernel is the bounded one
    (`bounded_kernel`); k tangents, G = plan.groups."""
    blocks, regs, smem = _occupancy_query(
        use_fmad(dtype, None, k > 0), dtype, ns, nv, american, scheme,
        launch_flags(option_type, knocked, ns, nv)[0],
        remaps_apart(option_type, knocked), k, plan)
    return {"blocks_per_sm": blocks, "registers": regs,
            "threads": plan.threads,
            "smem_bytes": smem, "groups": plan.groups,
            "smem_fields": list(plan.smem_fields),
            "bounded": bounded_kernel(dtype, scheme, plan.threads, k)}


@functools.cache
def resident_blocks(fmad: bool, dtype: torch.dtype, ns: int, nv: int,
                    american: bool, scheme: str, payoff: int, apart: bool,
                    plan: LaunchPlan) -> int:
    """Resident blocks an SM of the primal kernel a launch with `plan`
    takes (`_occupancy_query`), once per build, kernel and plan:
    `resident_blocks.queries` counts the cache's misses, so that a launch
    of a shape seen before queries nothing."""
    resident_blocks.queries += 1
    return _occupancy_query(fmad, dtype, ns, nv, american, scheme, payoff,
                            apart, 0, plan)[0]


resident_blocks.queries = 0


def _pack_tangents(fields, tangents, american):
    """`_launch_packed`'s `tangent` of a field dict: its tangents' rows and
    its state fields["du"], fields["dlam"] (dlam for American loops)."""
    tsf = torch.stack([t["sfac"] for t in tangents], 1).contiguous()
    tvf = torch.stack([torch.stack([t[k] for k in _KERNEL_TV_KEYS], 1)
                       for t in tangents], 1).contiguous()
    state_in = [torch.stack(list(fields[key]), 1).contiguous()
                if fields.get(key) is not None
                and (key == "du" or american) else None
                for key in ("du", "dlam")]
    return (tsf, tvf, *state_in)


def _launch(fields, ev_steps, remaps, *, n_steps, american, tangents=None,
            first_step=1, nst=None, scheme="do", segment=None, **kw):
    check_scheme(scheme)
    if segment is not None:
        fields = {**fields, **segment}
    u = fields["u"]
    dtype, dev = u.dtype, u.device
    if u.dim() != 3:
        raise ValueError(f"u must be [B, ns, nv], got {tuple(u.shape)}")
    b, ns, nv = u.shape
    check_fields(fields, (b,), ns, nv, "fused_do kernel")
    if tangents is not None:
        if not tangents:
            raise ValueError("tangents: want at least one direction")
        for t in tangents:
            for k in _TANGENT_KEYS:
                check_field(f"tangent {k}", t[k],
                            (b, ns) if k in _TANGENT_S_KEYS else (b, nv),
                            dtype, dev)
        for key in ("du", "dlam"):
            state = fields.get(key)
            if state is not None and len(state) != len(tangents):
                raise ValueError(f"{key}: want one surface per tangent "
                                 f"({len(tangents)}), got {len(state)}")
            for x in state or ():
                check_field(key, x, (b, ns, nv), dtype, dev)
    steps = check_events(ev_steps, remaps, first_step, n_steps, (b, ns),
                         dtype, dev)
    if nst is not None and (nst.device != dev or nst.is_floating_point()
                            or tuple(nst.shape) != (b,)):
        raise ValueError(f"nst must be ({b},) integers on {dev}, got "
                         f"{tuple(nst.shape)} {nst.dtype} on {nst.device}")
    got = _launch_packed(
        *_pack(fields, steps, remaps, nst), n_steps=n_steps,
        american=american, first_step=first_step, scheme=scheme, **kw,
        tangent=None if tangents is None
        else _pack_tangents(fields, tangents, american))
    if tangents is None:
        return got
    out, lam, du, dlam = got
    dlams = (dlam.unbind(1) if american
             else _tangent_state(fields, len(tangents), u)[1].unbind(0))
    return out, lam, list(du.unbind(1)), list(dlams)


def _launch_packed(u0, lam0, sf, vf, sc, ev_step, ev_idx, ev_w, nst=None, *,
                   theta, delta_t, n_steps, rf, american, first_step=1,
                   scheme="do", option_type="call", knocked=(), fmad=None,
                   plan: Optional[LaunchPlan] = None, tangent=None):
    """One launch of kernel 1 on packed buffers (`_pack`'s, or a
    `BookPlan`'s): contiguous CUDA tensors of the launch's dtype, u0 and
    lam0 [B, ns, nv], sf [B, 11, ns], vf [B, 9, nv], sc [B, 2], the
    events' steps int32 [n_ev] on the card, ev_idx int32 and ev_w
    [B, n_ev, 2, ns], nst int32 [B] or None. `tangent` (the forward mode):
    (tsf [B, K, ns], tvf [B, K, 8, nv], du0, dlam0 [B, K, ns, nv] or None
    for zero). `fmad`: the build (`use_fmad`); `plan`: the launch plan
    (`launch_plan` for this card when None). Counts the launch in
    `fused_do_loop.launches` (`.tangent_launches`), a primal launch's
    resident blocks an SM (`resident_blocks`) in
    `fused_do_loop.resident_blocks`, and returns (u, lam), with `tangent`
    (u, lam, du [B, K, ns, nv], dlam or None); a European launch hands
    lam0 back."""
    dtype, dev = u0.dtype, u0.device
    b, ns, nv = u0.shape
    out = torch.empty_like(u0)
    lam_out = torch.empty_like(u0)
    n_tan = 0 if tangent is None else tangent[0].shape[1]
    if plan is None:
        plan = launch_plan(b, ns, nv, u0.element_size(), scheme, american,
                           n_tan, n_sm=_sm_count(
                               dev.index if dev.index is not None
                               else torch.cuda.current_device()))
    # the fields the plan leaves out of shared memory, per block
    work = torch.empty(b * plan.groups * plan.scratch_elems, dtype=dtype,
                       device=dev)
    ptrs = [t.data_ptr() for t in (u0, lam0, out, lam_out, work, sf, vf, sc,
                                   ev_step, ev_idx, ev_w)]
    ptrs.append(0 if nst is None else nst.data_ptr())
    if tangent is not None:
        du = torch.empty(b, n_tan, ns, nv, dtype=dtype, device=dev)
        dlam = torch.empty_like(du) if american else None
        ptrs += [0 if t is None else t.data_ptr()
                 for t in (*tangent, du, dlam)]

    flags = launch_flags(option_type, knocked, ns, nv)
    apart = remaps_apart(option_type, knocked)
    fmad = use_fmad(dtype, fmad, tangent is not None)
    name = "fused_do_tangent_" if tangent is not None else "fused_do_"
    fn = getattr(_library(fmad),
                 name + ("f32" if dtype == torch.float32 else "f64"))
    ints = [b, ns, nv, first_step, n_steps, int(american),
            ev_step.shape[0], SCHEMES.index(scheme), *flags, int(apart)]
    if tangent is not None:
        ints += [n_tan, plan.groups]
    with torch.cuda.device(dev):
        blocks = (None if tangent is not None else resident_blocks(
            fmad, dtype, ns, nv, american, scheme, flags[0], apart, plan))
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*ptrs, *ints, plan.fmask, plan.threads, plan.scratch_elems,
                float(delta_t), float(theta * delta_t), float(rf),
                float((0.5 - theta) * delta_t), stream)
    if rc != 0:
        raise RuntimeError(f"{name}kernel launch failed: CUDA error {rc}")
    lam = lam_out if american else lam0
    if tangent is not None:
        fused_do_loop.tangent_launches += 1
        return out, lam, du, dlam
    fused_do_loop.launches += 1
    fused_do_loop.resident_blocks += blocks
    return out, lam


@scope("loop")
def fused_do_loop(fields, ev_steps, remaps, *, theta: float, delta_t: float,
                  n_steps: int, rf, american: bool, tangents=None,
                  first_step: int = 1, nst=None, scheme: str = "do",
                  option_type: str = "call", knocked=(), segment=None):
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
    `fields`' own (see fused_do_reference). Launches csrc/fused_do.cu for
    CUDA tensors (one launch, every dividend event of the phase included,
    on the build and the launch plan `_launch_packed` chooses) and counts
    the launch in `fused_do_loop.launches` (primal; its resident blocks an
    SM in `fused_do_loop.resident_blocks`) or
    `fused_do_loop.tangent_launches` (forward mode); runs
    fused_do_reference for CPU tensors; raises for any other device."""
    kw = dict(theta=theta, delta_t=delta_t, n_steps=n_steps, rf=rf,
              american=american, tangents=tangents, first_step=first_step,
              nst=nst, scheme=scheme, option_type=option_type,
              knocked=knocked, segment=segment)
    if on_card(fields["u"], "fused_do"):
        return _launch(fields, ev_steps, remaps, **kw)
    return fused_do_reference(fields, ev_steps, remaps, **kw)


fused_do_loop.launches = 0
fused_do_loop.tangent_launches = 0
fused_do_loop.resident_blocks = 0

"""Kernel 2, the single-option ADI time loop (the latency kernel of a
batch of one): its plan, the CUDA kernel's wrapper and its plain
PyTorch version.

PyTorch counterpart of `heston_tpu.pallas.fused_single` for the four
schemes of `SolverConfig.scheme` (Douglas, Craig-Sneyd, modified
Craig-Sneyd, Hundsdorfer-Verwer) with calls, puts and cash-or-nothing
digitals, with or without a knock-out barrier, European or American,
with or without discrete dividends, at flat rates, with or without
Rannacher start-up damping (its damp phase always Douglas). The payoff
enters a launch as in kernel 1: the rebuilt American floor, the reaction
rows and the American digital's projection
(heston_tpu/pallas/fused_single.py:177-221, :402-414); the dividend
remap is already the separate one of u and the compensation.
`price_batch` sends every batch of one here (`use_single`), as the JAX
package's `douglas._price_batch_impl` does (the layers:
`kernels.assembly`).

One option in a 2-D layout [nv, ns] (v rows, s columns): the tridiagonal
solve along s runs as parallel cyclic reduction (PCR) with the level
factors built once a launch, the pentadiagonal solve along v as the
sequential recurrence, each dividend event as a 2-point remap of u and of
the compensation; a corrector scheme runs both solves a second time. One
launch of `csrc/fused_single.cu` (one thread-block cluster of C blocks,
the option's v rows split between them, its working fields in their
shared memory: `launch_plan`) runs one phase of `assembly.phase_plan`.
`fused_single_reference` computes the same algebra in the TPU kernel's
own order of arithmetic, which is not kernel 1's plain version's: the
two kernels agree to rounding, not bitwise.

Field layout of one launch:
  state        u, lam [nv, ns]
  s-rows       [ns]   (assembly.KERNEL_S_KEYS)
  v-columns    [nv]   (assembly.KERNEL_V_KEYS)
  scalars      b1v, kk: 0-d

The plan of one option comes two ways. `single_plan` assembles it on the
host with PyTorch operations (assembly.assemble and the remaps: a few
hundred small kernels on the card), as a field dict; `device_plan` packs
it in the kernel's own layout (`DevicePlan`), and for a CUDA strike
builds it on the card in one launch of `single_plan_kernel`
(csrc/fused_single.cu; the arithmetic of csrc/plan.cuh, which the book's
plan kernel shares), the host plan's arithmetic operation for operation,
with nothing read back to the host. `fused_price_single` runs
`device_plan` on either device: the plan kernel on the card, the host
plan packed on the CPU. One launch path: `_launch` checks and packs a
field dict (`_pack`, which `pack_plan` uses) for `_launch_packed`, which
alone takes a build (`fmad`) or a launch plan (`plan`).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional

import torch

from heston_tpu_torch.config import DividendSchedule, GridSpec, SolverConfig
from heston_tpu_torch.kernels.assembly import (
    KERNEL_S_KEYS, KERNEL_V_KEYS, SCALAR_KEYS, SCHEMES, assemble,
    barrier_positions, build_remap_fields, check_scheme, check_slice,
    exercise_floor, loop_kwargs, market_buffer, n_react, penta_factors,
    phase_plan, plan_args, plan_phases, run_plan_kernel, two_sum)
from heston_tpu_torch.kernels.cuda_build import (
    build, check_dtype, check_events, check_fields, launch_flags, on_card,
    use_fmad)
from heston_tpu_torch.ops import operators
from heston_tpu_torch.utils.profiling import scope

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "fused_single.cu"
# shared memory a block can use on an H100 (227 KB)
SMEM_LIMIT = 232448
_N_PENTA = 5           # penta factor columns [nv]
# cluster sizes of a launch: up to 8 blocks portable, 16 with the
# non-portable attribute where the card can schedule such a cluster
CLUSTERS = (1, 2, 4, 8, 16)
PORTABLE_CLUSTER = 8
HALO_ROWS = 2          # halo rows each side of a block (A2's +-2 rows)
# threads a block at most (the kernel's launch bounds: 128 registers a
# thread)
MAX_THREADS = 512
# the working fields with halo rows (csrc/fused_single.cu Layout)
_HALO_FIELDS = ("b0", "b1", "u", "comp", "lam", "z2w")
# a block's two mbarriers, at the head of its shared memory
_MBAR_BYTES = 16


def pcr_levels(ns: int) -> int:
    """ceil(log2(ns)): the PCR levels that make an ns-row system
    diagonal."""
    lev = 0
    while (1 << lev) < ns:
        lev += 1
    return lev


def smem_bytes(ns: int, nv: int, itemsize: int) -> int:
    """The routing rule's measure of a grid (`use_single`): the coefficient
    rows and the American floor row, the columns, the penta factor columns
    and two [nv, ns] fields, at `itemsize` bytes a value (a one-block
    launch holding only its ping-pong buffers). The rule keeps this
    measure so that the grids it routes do not depend on the launch plan;
    a launch's own shared memory is `launch_plan`'s."""
    return itemsize * ((len(KERNEL_S_KEYS) + 1) * ns
                       + (len(KERNEL_V_KEYS) + _N_PENTA) * nv
                       + 2 * ns * nv)


def use_single(spec: GridSpec, solver: SolverConfig, batch: int) -> bool:
    """Dispatch predicate of the latency kernel: one option on the
    "pallas" engine. The scheme and the product are left to
    `check_slice`, which both routes call alike.

    Capacity rule: a grid goes here when `smem_bytes(ns, nv, 8)` fits the
    227 KB a block can use (the 101 x 76 golden grid measures 140 KB, a
    121 x 101 grid 218 KB, a 150 x 140 grid would need 355 KB), in both
    types alike, so both take the same route. Every grid it admits gets
    a launch plan (`launch_plan`): the fields that no cluster's shared
    memory holds go to global scratch and set no limit."""
    return (batch == 1 and solver.solver_engine == "pallas"
            and smem_bytes(spec.m1 + 1, spec.m2 + 1, 8) <= SMEM_LIMIT)


def fields(scheme: str, levels: int) -> tuple:
    """The working fields of a launch, in the kernel's placement order
    (csrc/fused_single.cu Field): the PCR ping-pong buffers b0 and b1, u,
    the compensation, the multiplier, a corrector's L u (luw) and HV's
    increment z2 (z2w), then the PCR factors alpha_l and gamma_l of each
    of the `levels` levels and 1/b (binv). The fields in shared memory are
    a prefix of this order."""
    pre = ("b0", "b1", "u", "comp", "lam")
    pre += ("luw",) if scheme != "do" else ()
    pre += ("z2w",) if scheme == "hv" else ()
    fac = tuple(f"{x}{lev}" for lev in range(levels)
                for x in ("alpha", "gamma"))
    return pre + fac + ("binv",)


def state_fields(scheme: str) -> int:
    """How many fields of `fields` come before the PCR factors."""
    return 5 + (scheme != "do") + (scheme == "hv")


class SinglePlan(NamedTuple):
    cluster: int          # C: blocks of the thread-block cluster
    rows: int             # R: v rows a block (the last block may own fewer)
    threads: int          # threads a block
    smem_fields: tuple    # the fields in shared memory, a prefix of fields()
    smem_bytes: int       # dynamic shared memory a block
    scratch_elems: int    # values of global scratch (every block's fields)


def _plan(ns: int, nv: int, itemsize: int, scheme: str, cluster: int,
          cap: Optional[int] = None) -> Optional[SinglePlan]:
    """The plan with `cluster` blocks, as many fields in shared memory as
    fit (at most `cap`) and one thread a point of a block's rows (at most
    MAX_THREADS); None when the rows alone do not fit a block, or a
    cluster would not hold both ping-pong buffers there (its blocks
    exchange the penta solution into them)."""
    rows = -(-nv // cluster)
    halo = HALO_ROWS if cluster > 1 else 0
    names = fields(scheme, pcr_levels(ns))
    sizes = [(rows + 2 * halo if f in _HALO_FIELDS else rows) * ns
             for f in names]
    # coefficient rows, floor row, penta factor columns; the column buffer
    # of the sweep (C > 1): ceil(ns/C) columns of nv | 1 values
    used = ((len(KERNEL_S_KEYS) + 1) * ns
            + (len(KERNEL_V_KEYS) + _N_PENTA) * nv
            + (-(-ns // cluster) * (nv | 1) if cluster > 1 else 0))
    limit = (SMEM_LIMIT - _MBAR_BYTES) // itemsize
    n_smem = 0
    while (n_smem < len(names) and (cap is None or n_smem < cap)
           and used + sum(sizes[:n_smem + 1]) <= limit):
        n_smem += 1
    if used > limit or (cluster > 1 and n_smem < 2):
        return None
    threads = min(MAX_THREADS, 32 * -(-rows * ns // 32))
    return SinglePlan(cluster, rows, threads, names[:n_smem],
                      _MBAR_BYTES + itemsize * (used + sum(sizes[:n_smem])),
                      cluster * sum(sizes[n_smem:]))


def launch_plan(ns: int, nv: int, itemsize: int, scheme: str, *,
                cluster: Optional[int] = None, factors: bool = True,
                cluster16: bool = True) -> SinglePlan:
    """Where one launch of the kernel keeps its working fields, decided
    from sizes before the launch: an [nv, ns] grid at `itemsize` bytes a
    value under `scheme`. The fields of `fields` go into a block's shared
    memory in that order as far as they fit, the rest (the last PCR
    factors first) into global scratch; the rule takes, of the clusters C
    of CLUSTERS (16 only with `cluster16`, where the card can schedule
    it: see `default_plan`) that leave each block R = ceil(nv/C) >= 2
    rows, the one that holds the most fields, the largest of equals: on
    an H100 a larger C ran faster at every grid measured (PERF.md,
    Findings), so the smallest C that holds them all is not taken.
    Threads: one a point of the block's rows, at most MAX_THREADS.

    A forced plan (tests and measurements hand it to `_launch_packed`):
    `cluster` and `factors=False` (the PCR factors in global scratch, the
    fields before them in shared memory as far as they fit). Raises
    ValueError for a cluster that is not in CLUSTERS or leaves a block
    fewer than 2 rows, and for a plan that does not fit (the rows, or a
    cluster's two ping-pong buffers)."""
    check_scheme(scheme)
    if itemsize not in (4, 8):
        raise ValueError(f"itemsize must be 4 or 8, got {itemsize}")
    valid = [c for c in CLUSTERS if (c == 1 or -(-nv // c) >= 2)
             and (cluster16 or c <= PORTABLE_CLUSTER)]
    if cluster is not None:
        if cluster not in valid:
            raise ValueError(f"a cluster of {cluster} blocks does not fit "
                             f"{nv} v rows (want one of {valid}, >= 2 rows "
                             f"a block)")
        valid = [cluster]
    cap = None if factors else state_fields(scheme)
    plans = [pl for c in valid
             if (pl := _plan(ns, nv, itemsize, scheme, c, cap=cap))
             is not None]
    if not plans:
        raise ValueError(f"no plan of {valid} blocks fits a {ns} x {nv} "
                         f"grid (itemsize {itemsize}, scheme {scheme!r})")
    return max(plans, key=lambda pl: (len(pl.smem_fields), pl.cluster))


@scope("single_plan")
def single_plan(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
):
    """The launches of ONE option (`strikes` [1]) on the latency kernel:
    (fields, phases, (idx_v, idx_s)). fields: the batched kernel's
    assembly at B = 1 in this kernel's layout (u and lam [nv, ns], s-rows
    [ns], v-columns [nv], 0-d scalars); phases: per phase of
    `phase_plan`, (event steps, remaps [ns], keyword arguments of the
    loop, `loop_kwargs`); (idx_v, idx_s): the node of the price
    (heston_tpu/pallas/fused_single.py:536-648)."""
    check_slice(spec, solver, option_type)
    f, vec_s, idx_s, idx_v, _ = assemble(
        spec, solver, strikes.reshape(1), s0, kappa, eta, sigma, rho, v0,
        r_d, r_f, option_type=option_type)
    fields = {k: f[k][0].transpose(0, 1).contiguous() for k in ("u", "lam")}
    for k in (*KERNEL_S_KEYS, *KERNEL_V_KEYS, *SCALAR_KEYS):
        fields[k] = f[k][0]
    rf = operators.boundary_rate(r_d, r_f, option_type)
    knocked = barrier_positions(spec)
    phases = []
    for ph in phase_plan(solver, dividends):
        remaps = [tuple(x[0] for x in rm)
                  for rm in build_remap_fields(
                      vec_s, ph["events"], option_type=option_type,
                      knocked=knocked)]
        phases.append(([e[0] for e in ph["events"]], remaps, loop_kwargs(
            ph, rf, american, option_type, knocked)))
    return fields, phases, (idx_v[0], idx_s[0])


class DevicePlan(NamedTuple):
    """The launches of one option in kernel 2's packed layout: what
    `_launch_packed` reads, every phase's events in one set of buffers."""

    u: torch.Tensor        # [nv, ns] the payoff on every v row
    lam: torch.Tensor      # [nv, ns] zeros
    sf: torch.Tensor       # [11, ns] s-rows, KERNEL_S_KEYS order
    vf: torch.Tensor       # [9, nv] v-columns, KERNEL_V_KEYS order
    sc: torch.Tensor       # [2] b1v, kk
    ev_step: torch.Tensor  # int32 [n_ev] each event's local step
    ev_idx: torch.Tensor   # int32 [n_ev, 2, ns] source columns i0, i1
    ev_w: torch.Tensor     # [n_ev, 2, ns] weights w0, w1
    at: torch.Tensor       # int64 [1] the price's flat node idx_v*ns + idx_s
    phases: list           # per phase: (first event, events, loop kwargs)


def _pack(fields, ev_steps, remaps):
    """A field dict and its events in kernel 2's packed layout: (u, lam,
    sf, vf, sc, ev_step, ev_idx, ev_w)."""
    dev = fields["u"].device
    ns = fields["vecs"].shape[0]
    sf = torch.stack([fields[k] for k in KERNEL_S_KEYS]).contiguous()
    vf = torch.stack([fields[k] for k in KERNEL_V_KEYS]).contiguous()
    sc = torch.stack([fields[k] for k in SCALAR_KEYS]).contiguous()
    ev_step = torch.tensor(list(ev_steps), dtype=torch.int32, device=dev)
    if remaps:
        ev_idx = torch.stack([torch.stack([rm[0], rm[2]])
                              for rm in remaps]).to(torch.int32)
        ev_w = torch.stack([torch.stack([rm[1], rm[3]]) for rm in remaps])
    else:
        ev_idx = torch.empty(0, 2, ns, dtype=torch.int32, device=dev)
        ev_w = torch.empty(0, 2, ns, dtype=sf.dtype, device=dev)
    return (fields["u"].contiguous(), fields["lam"].contiguous(), sf, vf, sc,
            ev_step, ev_idx.contiguous(), ev_w.contiguous())


def pack_plan(fields, phases, at) -> DevicePlan:
    """`single_plan`'s (fields, phases, at) as a DevicePlan: the events
    of every phase in processing order, the node as a flat index."""
    steps = [s for ph_steps, _, _ in phases for s in ph_steps]
    remaps = [rm for _, ph_remaps, _ in phases for rm in ph_remaps]
    packed = _pack(fields, steps, remaps)
    ns = fields["vecs"].shape[0]
    flat = (at[0] * ns + at[1]).reshape(1).to(torch.int64)
    out, first = [], 0
    for ph_steps, _, kw in phases:
        out.append((first, len(ph_steps), kw))
        first += len(ph_steps)
    return DevicePlan(*packed, flat, out)


def device_plan(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
) -> DevicePlan:
    """The launches of ONE option (`strikes` [1]) on the latency kernel,
    packed (`DevicePlan`). A CUDA strike: built on the card by the plan
    kernel (one launch for up to assembly.PLAN_EVENTS dividend events, one
    more for each PLAN_EVENTS after them), on the current stream, with nothing
    read back to the host; the market as numbers (by value) or tensors
    (`market_buffer`, read on the card), taken in float64 either way.
    Counts each launch in `device_plan.launches`. A CPU strike:
    `single_plan` packed (`pack_plan`), its plain version."""
    args = (spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f)
    kw = dict(american=american, dividends=dividends,
              option_type=option_type)
    if tuple(strikes.shape) != (1,):
        raise ValueError(f"device_plan prices one option: strikes [1], got "
                         f"{tuple(strikes.shape)}")
    if on_card(strikes, "device_plan"):
        return _device_plan(*args, **kw)
    return pack_plan(*single_plan(*args, **kw))


@scope("single_plan")
def _device_plan(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
                 r_d, r_f, american, dividends, option_type) -> DevicePlan:
    check_slice(spec, solver, option_type)
    dtype, dev = strikes.dtype, strikes.device
    check_dtype(dtype, "the plan kernel")
    ns, nv = spec.m1 + 1, spec.m2 + 1
    events, phases = plan_phases(spec, solver, dividends, american,
                                 option_type, r_d, r_f)
    n_ev = len(events)
    out = DevicePlan(
        torch.empty(nv, ns, dtype=dtype, device=dev),
        torch.empty(nv, ns, dtype=dtype, device=dev),
        torch.empty(len(KERNEL_S_KEYS), ns, dtype=dtype, device=dev),
        torch.empty(len(KERNEL_V_KEYS), nv, dtype=dtype, device=dev),
        torch.empty(len(SCALAR_KEYS), dtype=dtype, device=dev),
        torch.empty(n_ev, dtype=torch.int32, device=dev),
        torch.empty(n_ev, 2, ns, dtype=torch.int32, device=dev),
        torch.empty(n_ev, 2, ns, dtype=dtype, device=dev),
        torch.empty(1, dtype=torch.int64, device=dev), phases)
    market = (s0, kappa, eta, sigma, rho, v0, r_d, r_f)
    buf = market_buffer(market, dev)
    lib = _library(use_fmad(dtype))
    fn = lib.single_plan_f32 if dtype == torch.float32 else lib.single_plan_f64
    ptrs = [None if buf is None else buf.data_ptr(),
            *(t.data_ptr() for t in (strikes, *out[:-1]))]
    device_plan.launches += run_plan_kernel(
        fn, "single_plan", plan_args(spec, solver, market, buf, option_type),
        events, (), ptrs, (), dev)
    return out


device_plan.launches = 0


def run_plan(plan: DevicePlan):
    """(u, lam) after every phase of a packed plan, one launch of kernel 2
    a phase: on the card straight from the packed buffers
    (`_launch_packed`, in the `loop` span), on the CPU through
    `fused_single_loop`'s field dict (its plain version)."""
    u, lam = plan.u, plan.lam
    for first, count, kw in plan.phases:
        ev = slice(first, first + count)
        if u.device.type == "cpu":
            fields = {"u": u, "lam": lam,
                      **dict(zip(KERNEL_S_KEYS, plan.sf)),
                      **dict(zip(KERNEL_V_KEYS, plan.vf)),
                      **dict(zip(SCALAR_KEYS, plan.sc))}
            remaps = [(i[0].long(), w[0], i[1].long(), w[1])
                      for i, w in zip(plan.ev_idx[ev], plan.ev_w[ev])]
            u, lam = fused_single_loop(fields, plan.ev_step[ev].tolist(),
                                       remaps, **kw)
        else:
            with scope("loop"):
                u, lam = _launch_packed(u, lam, plan.sf, plan.vf, plan.sc,
                                        plan.ev_step[ev], plan.ev_idx[ev],
                                        plan.ev_w[ev], **kw)
    return u, lam


def fused_price_single(
    spec: GridSpec,
    solver: SolverConfig,
    strikes: torch.Tensor,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
) -> torch.Tensor:
    """Price [1] of ONE option (`strikes` [1]) through the latency kernel:
    its plan (`device_plan`), one launch a phase on the packed buffers
    (`run_plan`) and the price gathered at the plan's node. A CUDA
    `strikes` tensor: the plan kernel and kernel 2, with no blocking call
    before the caller's own read. A CPU one: the host plan and the
    kernel's plain version."""
    plan = device_plan(spec, solver, strikes, s0, kappa, eta, sigma, rho,
                       v0, r_d, r_f, american=american, dividends=dividends,
                       option_type=option_type)
    u, _ = run_plan(plan)
    return torch.take(u, plan.at)


# ---------------------------------------------------------------------------
# the time loop: plain version
# ---------------------------------------------------------------------------

def _shift_s(x, k: int, fill: float = 0.0):
    """result[:, i] = x[:, i + k] along s (the last axis), `fill`
    outside."""
    n = x.shape[-1]
    pad = torch.full_like(x[..., : abs(k)], fill)
    if k > 0:
        return torch.cat([x[..., k:], pad], dim=-1)
    return torch.cat([pad, x[..., : n + k]], dim=-1)


def _shift_v(x, k: int):
    """result[j, :] = x[j + k, :] along v (the first axis), zero
    outside."""
    return operators.shift(x, k, 0)


def fused_single_reference(fields, ev_steps, remaps, *, theta: float,
                           delta_t: float, n_steps: int, rf,
                           american: bool, first_step: int = 1,
                           scheme: str = "do", option_type: str = "call",
                           knocked=()):
    """Plain PyTorch version of the kernel: the ADI time loop of one
    option on [nv, ns] tensors over the local steps first_step..n_steps,
    in the TPU kernel's order of arithmetic
    (heston_tpu/pallas/fused_single.py:110-478). Returns (u + comp, lam),
    each [nv, ns].

    scheme: one of SCHEMES; a corrector ("cs", "mcs", "hv") reuses the
    predictor's L u (+ lam) and solves again
    (heston_tpu/pallas/fused_single.py:346-397), in that kernel's order:
    lambda joins L u before the dt scaling, HV scales b1 and b2
    separately.

    The multiplier is carried unscaled, as that kernel carries it: the
    right-hand side takes dt*(L u + lam), the update (z2 - dt*lam) + comp
    and lam' = max(0, ((floor - q) - err)/dt), the s_max column masked.
    ev_steps: the local step of each dividend event (applied before that
    step); remaps: the matching (i0, w0, i1, w1), each [ns]. rf: the
    boundary growth rate (operators.boundary_rate). option_type, knocked:
    the payoff and a barrier's knocked s columns, as in kernel 1's plain
    version (the floor, the reaction rows, and an
    American digital's static-pin + box projection, the multiplier
    carried unchanged: heston_tpu/pallas/fused_single.py:402-414)."""
    check_scheme(scheme)
    f = fields
    u = f["u"]
    nv, ns = u.shape
    dtype, dev = u.dtype, u.device
    dt = delta_t
    td = theta * delta_t

    def row(k):
        return f[k][None, :]

    def col(k):
        return f[k][:, None]

    vfl = col("vfl")
    a1l = vfl * row("a1pl") + row("a1ql")
    a1d = vfl * row("a1pd") + row("a1qd")
    a1u = vfl * row("a1pu") + row("a1qu")
    qd = f["a1qd"]
    s_ids = torch.arange(ns, device=dev)
    v_ids = torch.arange(nv, device=dev)
    react_s = torch.where(s_ids == 0, qd[0], qd[ns - 1])[None, :]
    react_v = torch.where(
        v_ids < n_react(option_type, knocked, ns, nv), qd[ns - 1],
        torch.zeros_like(qd[0]))[:, None]
    b1m = operators.b1_mask(ns, nv, dtype, dev).transpose(0, 1)
    bottom = ((v_ids[:, None] == nv - 1) & (s_ids[None, :] >= 1)).to(dtype)
    smax_mask = (s_ids != ns - 1).to(dtype)[None, :]
    u0 = exercise_floor(f["vecs"], f["kk"], option_type,
                                 knocked)[None, :] * torch.ones(
        nv, 1, dtype=dtype, device=dev)
    digital = american and operators.is_digital(option_type)
    bsm, bsp = row("bsm"), row("bsp")
    bvm, bvp = col("bvm"), col("bvp")
    l2b, l1b, u1b, u2b = col("al2"), col("al1"), col("au1"), col("au2")
    b2r = row("b2r")
    c_a0 = row("sfac") * col("vfac")

    def ds_of(x):
        return bsm * (_shift_s(x, -1) - x) + bsp * (_shift_s(x, 1) - x)

    def dv_of(x):
        return bvm * (_shift_v(x, -1) - x) + bvp * (_shift_v(x, 1) - x)

    def a1mul(x):
        return (a1l * (_shift_s(x, -1) - x) + a1u * (_shift_s(x, 1) - x)
                + react_s * x)

    def a2mul(x):
        return (l2b * (_shift_v(x, -2) - x) + l1b * (_shift_v(x, -1) - x)
                + u1b * (_shift_v(x, 1) - x) + u2b * (_shift_v(x, 2) - x)
                + react_v * x)

    def pcr(d):
        """T1^-1 d along s through the PCR cascade."""
        for s, alpha, gamma in pcr_fac:
            d = d + alpha * _shift_s(d, -s) + gamma * _shift_s(d, s)
        return d * pcr_binv

    # PCR cascade of I - td*A1 along s, once per launch: level l
    # eliminates the couplings at stride 2^l; off-grid neighbours are
    # identity rows (b = 1, a = c = 0)
    a = -td * a1l
    b = 1.0 - td * a1d
    c = -td * a1u
    pcr_fac = []
    for lev in range(pcr_levels(ns)):
        s = 1 << lev
        alpha = -a / _shift_s(b, -s, 1.0)
        gamma = -c / _shift_s(b, s, 1.0)
        b = b + alpha * _shift_s(c, -s) + gamma * _shift_s(a, s)
        a = alpha * _shift_s(a, -s)
        c = gamma * _shift_s(c, s)
        pcr_fac.append((s, alpha, gamma))
    pcr_binv = 1.0 / b

    # pentadiagonal factorization of I - td*A2 along v (1-D)
    pm, pgm, phm, pc, pc2 = penta_factors(f, td)

    def penta(e):
        """T2^-1 e along v, row by row (each row one [ns] vector)."""
        rows = list(e.unbind(0))
        dp1 = pm[0] * rows[0]
        rows[0] = dp1
        dp2 = torch.zeros_like(dp1)
        for j in range(1, nv):
            dpj = pm[j] * rows[j] - pgm[j] * dp1 - phm[j] * dp2
            rows[j] = dpj
            dp2, dp1 = dp1, dpj
        x1 = rows[nv - 1]
        x2 = torch.zeros_like(x1)
        for j in range(nv - 2, -1, -1):
            xj = rows[j] - pc[j] * x1 - pc2[j] * x2
            rows[j] = xj
            x2, x1 = x1, xj
        return torch.stack(rows)

    def remap(x, i0, w0, i1, w1):
        """(value, rounding) of the 2-point difference-form remap of x
        along s: the TPU kernel's one-hot contraction, whose only nonzero
        terms are the source columns i0 and i1 in ascending order (one
        term of weight w0 + w1 where they coincide), then 2Sum."""
        wsum = torch.where(w0 + w1 > 0.5, torch.ones_like(w0),
                           torch.zeros_like(w0))
        x0 = x[:, i0]
        x1 = x[:, i1]
        acc = torch.where(i0 == i1, (w0 + w1) * (x0 - x),
                          w0 * (x0 - x) + w1 * (x1 - x))
        return two_sum(wsum * x, acc)

    rf_t = torch.as_tensor(rf, dtype=dtype, device=dev)
    comp = torch.zeros_like(u)
    lam = f["lam"]
    events = list(zip(ev_steps, remaps))
    for n in range(first_step, n_steps + 1):
        while events and events[0][0] == n:
            _, rm = events.pop(0)
            # u and the compensation remapped separately; u's captured
            # rounding joins the remapped compensation
            u, e2 = remap(u, *rm)
            comp = remap(comp, *rm)[0] + e2

        e0 = torch.exp(rf_t * dt * (n - 1.0))
        e1 = torch.exp(rf_t * dt * float(n))
        kb1 = dt * e0 + td * (e1 - e0)
        kb2a = dt * e0
        kb2b = td * (e1 - e0)

        bnd1 = (kb1 * f["b1v"]) * b1m + kb2a * bottom * b2r
        lu = c_a0 * dv_of(ds_of(u)) + a1mul(u) + a2mul(u)
        if american:
            lu = lu + lam
        z2 = penta(pcr(dt * lu + bnd1) + kb2b * bottom * b2r)

        if scheme != "do":
            # the corrector from the predictor's lu and increment z2
            a0z2 = c_a0 * dv_of(ds_of(z2))
            if scheme == "cs":
                d = dt * lu + (0.5 * dt) * a0z2 + bnd1
            elif scheme == "mcs":
                kmc = (0.5 - theta) * dt * (e1 - e0)
                d = (dt * lu + td * a0z2
                     + ((0.5 - theta) * dt) * (a0z2 + a1mul(z2) + a2mul(z2))
                     + ((kb1 + kmc) * f["b1v"]) * b1m
                     + (kb2a + kmc) * bottom * b2r)
            else:
                khv = 0.5 * dt * (e1 - e0)
                d = (dt * lu + (0.5 * dt) * (a0z2 + a1mul(z2) + a2mul(z2))
                     - z2 + ((dt * e0 + khv) * f["b1v"]) * b1m
                     + (dt * e0 + khv) * bottom * b2r)
            d = pcr(d)
            z2 = (z2 + penta(d) if scheme == "hv"
                  else penta(d + kb2b * bottom * b2r))

        if digital:
            # static-pin + box projection onto [floor, 1], lam unchanged
            q, err = two_sum(u, z2 + comp)
            pin = u0 == 1.0
            qm = torch.maximum(q, u0)
            u = torch.where(pin, u0, torch.clamp(qm, max=1.0))
            comp = torch.where((q > u0) & (qm < 1.0) & ~pin, err,
                               torch.zeros_like(err))
        elif american:
            t_inc = (z2 - dt * lam) + comp
            q, err = two_sum(u, t_inc)
            u = torch.maximum(q, u0)
            comp = torch.where(q > u0, err, torch.zeros_like(err))
            lam = torch.clamp(((u0 - q) - err) / dt, min=0.0) * smax_mask
        else:
            u, comp = two_sum(u, z2 + comp)
    return u + comp, lam


# ---------------------------------------------------------------------------
# the time loop: CUDA kernel
# ---------------------------------------------------------------------------

@functools.cache
def _library(fmad: bool = False) -> ctypes.CDLL:
    # `_library.loads` counts the cache's misses
    _library.loads += 1
    lib = ctypes.CDLL(str(build(SOURCE, fmad)))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("fused_single_f32", "fused_single_f64"):
        fn = getattr(lib, name)
        # u0, lam0, u_out, lam_out, scratch, sfields, vfields, scalars,
        # ev_step, ev_idx, ev_w; ns, nv, levels, first_step, n_steps,
        # american, n_events, scheme, payoff, n_react, knock0, knock1;
        # the plan (cluster, threads, fields in shared memory, scratch
        # values); dt, td, rf, (1/2 - theta)*dt; stream
        fn.argtypes = ([p] * 11 + [i] * 15 + [ctypes.c_longlong] + [d] * 4
                       + [p])
        fn.restype = ctypes.c_int
    # f64, scheme, ns, nv, levels, cluster, threads, fields in shared
    # memory; out: clusters at once, registers, local bytes, shared bytes
    lib.fused_single_occupancy.argtypes = [i] * 8 + [p] * 4
    lib.fused_single_occupancy.restype = ctypes.c_int
    for name in ("single_plan_f32", "single_plan_f64"):
        fn = getattr(lib, name)
        # PlanArgs*, PlanEvents*; market (float64 [8] or null), strike,
        # u0, lam0, sf, vf, sc, ev_step, ev_idx, ev_w, at; stream
        fn.argtypes = [p] * 14
        fn.restype = ctypes.c_int
    return lib


_library.loads = 0


def occupancy(dtype: torch.dtype, ns: int, nv: int, scheme: str,
              plan: SinglePlan) -> dict:
    """The resources of the kernel a launch with `plan` takes on the
    current card (CUDA only, the launch's own build): the clusters of
    plan.cluster blocks the card can hold at once
    (cudaOccupancyMaxActiveClusters, with the attributes the launch sets;
    0: it cannot be scheduled), registers and local (spill) bytes a
    thread, and the block's shared bytes (the kernel's own count, equal to
    the plan's)."""
    lib = _library(use_fmad(dtype))
    out = [ctypes.c_int(), ctypes.c_int(), ctypes.c_int(),
           ctypes.c_longlong()]
    rc = lib.fused_single_occupancy(
        int(dtype == torch.float64), SCHEMES.index(scheme), ns, nv,
        pcr_levels(ns), plan.cluster, plan.threads, len(plan.smem_fields),
        *(ctypes.byref(x) for x in out))
    if rc != 0:
        raise RuntimeError(f"fused_single_occupancy failed: CUDA error {rc}")
    clusters, regs, local, smem = (x.value for x in out)
    return {"cluster": plan.cluster, "rows": plan.rows,
            "threads": plan.threads, "smem_bytes": smem,
            "smem_fields": list(plan.smem_fields),
            "global_fields": len(fields(scheme, pcr_levels(ns)))
            - len(plan.smem_fields),
            "registers": regs, "local_bytes": local,
            "max_active_clusters": clusters}


def default_plan(dtype: torch.dtype, ns: int, nv: int,
                 scheme: str) -> SinglePlan:
    """The plan a launch takes when none is forced: `launch_plan`, whose
    16-block cluster is kept only where the card can schedule it (the
    occupancy query on the current card), else the plan of at most 8
    blocks. Raises ValueError where no plan fits (see launch_plan)."""
    return _default_plan(dtype, ns, nv, scheme, SMEM_LIMIT)


@functools.cache
def _default_plan(dtype, ns, nv, scheme, limit):
    # `limit`, SMEM_LIMIT at the call, keys the cache: launch_plan reads
    # it; `_default_plan.queries` counts the cache's misses
    _default_plan.queries += 1
    itemsize = torch.empty((), dtype=dtype).element_size()
    plan = launch_plan(ns, nv, itemsize, scheme)
    if (plan.cluster > PORTABLE_CLUSTER
            and occupancy(dtype, ns, nv, scheme, plan)[
                "max_active_clusters"] < 1):
        plan = launch_plan(ns, nv, itemsize, scheme, cluster16=False)
    return plan


_default_plan.queries = 0


def _launch(fields, ev_steps, remaps, *, n_steps, first_step=1,
            scheme="do", **kw):
    check_scheme(scheme)
    u = fields["u"]
    if u.dim() != 2:
        raise ValueError(f"u must be [nv, ns], got {tuple(u.shape)}")
    nv, ns = u.shape
    check_fields(fields, (), ns, nv, "fused_single kernel")
    steps = check_events(ev_steps, remaps, first_step, n_steps, (ns,),
                         u.dtype, u.device)
    return _launch_packed(*_pack(fields, steps, remaps), n_steps=n_steps,
                          first_step=first_step, scheme=scheme, **kw)


def _launch_packed(u, lam, sf, vf, sc, ev_step, ev_idx, ev_w, *, theta,
                   delta_t, n_steps, rf, american, first_step=1,
                   scheme="do", option_type="call", knocked=(), fmad=None,
                   plan: Optional[SinglePlan] = None):
    """One launch of kernel 2 on packed buffers (`_pack`, `DevicePlan`):
    contiguous CUDA tensors of the launch's dtype, the events' steps
    already on the card. `fmad`: the build (`use_fmad`); `plan`: the
    launch plan (default_plan when None)."""
    dtype, dev = u.dtype, u.device
    nv, ns = u.shape
    if plan is None:
        plan = default_plan(dtype, ns, nv, scheme)
    flags = launch_flags(option_type, knocked, ns, nv)
    out = torch.empty_like(u)
    lam_out = torch.empty_like(u)
    scratch = torch.empty(max(1, plan.scratch_elems), dtype=dtype,
                          device=dev)
    args = [u, lam, out, lam_out, scratch, sf, vf, sc, ev_step, ev_idx,
            ev_w]

    fn = getattr(_library(use_fmad(dtype, fmad)), "fused_single_"
                 + ("f32" if dtype == torch.float32 else "f64"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*[t.data_ptr() for t in args], ns, nv, pcr_levels(ns),
                first_step, n_steps, int(american), ev_step.shape[0],
                SCHEMES.index(scheme), *flags, plan.cluster,
                plan.threads, len(plan.smem_fields), plan.scratch_elems,
                float(delta_t), float(theta * delta_t), float(rf),
                float((0.5 - theta) * delta_t), stream)
    if rc != 0:
        raise RuntimeError(f"fused_single kernel launch failed: CUDA error "
                           f"{rc}")
    fused_single_loop.launches += 1
    return out, (lam_out if american else lam)


@scope("loop")
def fused_single_loop(fields, ev_steps, remaps, *, theta: float,
                      delta_t: float, n_steps: int, rf, american: bool,
                      first_step: int = 1, scheme: str = "do",
                      option_type: str = "call", knocked=()):
    """The ADI time loop of one option over the local steps
    first_step..n_steps (one phase of `assembly.phase_plan`) under
    `scheme` (one of SCHEMES), for the payoff `option_type` and a
    barrier's `knocked` s columns: (u, lam), each [nv, ns], lam unscaled
    for the next phase. Launches csrc/fused_single.cu for CUDA tensors
    (one thread-block cluster, every dividend event of the phase
    included, on the build and the launch plan `_launch_packed` chooses)
    and counts the launch in `fused_single_loop.launches`; runs
    fused_single_reference for CPU tensors; raises for any other
    device."""
    kw = dict(theta=theta, delta_t=delta_t, n_steps=n_steps, rf=rf,
              american=american, first_step=first_step, scheme=scheme,
              option_type=option_type, knocked=knocked)
    if on_card(fields["u"], "fused_single"):
        return _launch(fields, ev_steps, remaps, **kw)
    return fused_single_reference(fields, ev_steps, remaps, **kw)


fused_single_loop.launches = 0

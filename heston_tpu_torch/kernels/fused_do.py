"""Batched Douglas ADI time loop: host-side assembly, the CUDA kernel's
wrapper and its plain PyTorch version.

PyTorch counterpart of `heston_tpu.pallas.fused_do` for the Douglas scheme
with vanilla calls, European or American, with or without discrete
dividends, at flat rates. The whole time loop of a book runs in ONE launch
of `csrc/fused_do.cu` (one thread block per option; every dividend event
of the schedule inside the same launch). `fused_do_reference` computes the
same algebra with tensor ops and Python loops over steps and sweep rows;
the wrapper `fused_do_loop` takes it only for tensors on the CPU.

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
dividend remap with the compensation folded into u by 2Sum.
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
from typing import Optional

import torch

from heston_tpu.config import DividendSchedule, GridSpec, SolverConfig
from heston_tpu_torch.ops import coeff
from heston_tpu_torch.ops import grid as gridmod
from heston_tpu_torch.ops import operators

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
_N_WORK = 5            # comp, lam, d, Thomas w, Thomas 1/temp

_PKG_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PKG_DIR / "csrc" / "fused_do.cu"
BUILD_DIR = _PKG_DIR.parent / "build" / "heston_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")


# ---------------------------------------------------------------------------
# host-side assembly
# ---------------------------------------------------------------------------

def _check_slice(spec: GridSpec, solver: SolverConfig, option_type: str,
                 n_steps_per=None, rate_schedule=None) -> None:
    """Raise NotImplementedError for every option the port does not cover
    yet, naming the ROADMAP item that will."""
    if spec.barrier is not None:
        raise NotImplementedError(
            "knock-out barriers are not ported yet (ROADMAP A12, B1g)")
    if solver.scheme != "do":
        raise NotImplementedError(
            f"scheme {solver.scheme!r} is not ported yet; only 'do' "
            f"(ROADMAP A12, B1f)")
    if solver.rannacher_steps:
        raise NotImplementedError(
            "Rannacher start-up damping is not ported yet (ROADMAP A12, "
            "B1g)")
    if operators.is_injection_free(option_type):   # also validates the name
        raise NotImplementedError(
            f"option_type {option_type!r} is not ported yet; only 'call' "
            f"(ROADMAP A12, B1g)")
    if rate_schedule is not None:
        raise NotImplementedError(
            "rate schedules are not ported yet (ROADMAP A12)")
    if n_steps_per is not None:
        raise NotImplementedError(
            "per-lane step counts (mixed-maturity books) are not ported "
            "yet (ROADMAP A12, B1e)")


def _prepare_batched(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
                     r_d, r_f):
    """Grid and operator assembly of a book of calls, batched over
    `strikes` [B].

    Returns (u0 [B, ns], (a1pl, a1ql, a1pd, a1qd, a1pu, a1qu) [B, ns],
    scol [B, ns], vrow [nv], b1val [B], b2row [B, ns], grid, ops,
    idx_s [B], idx_v []) — the counterpart of the vmapped `one` of
    heston_tpu.pallas.fused_do._prepare_batched for flat-rate books."""
    g = gridmod.make_grid(spec, s0, strikes, v0)
    ops = operators.build_operators(g, kappa, eta, sigma, r_d,
                                    solver.a2_variant)
    u0 = operators.grid_payoff(g.vec_s, strikes[:, None], "call")
    # separable A0 coefficient rho*sigma*s (cols 1..m1-1) x v (rows
    # 1..m2-1)
    scol = rho * sigma * g.vec_s
    scol[:, 0] = 0.0
    scol[:, -1] = 0.0
    vrow = g.vec_v.clone()
    vrow[0] = 0.0
    vrow[-1] = 0.0
    # rank-2 form of the explicit A1 bands: A1[i, j] = v_j * P[i] + Q[i];
    # row 0 zero (calls), row m1 only the -r_d/2 reaction
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

    a1pq = (cat(0.0, a * dm, 0.0), cat(0.0, bb * bm, 0.0),
            cat(0.0, a * d0, 0.0),
            cat(0.0, bb * b0 - 0.5 * r_d, -0.5 * r_d),
            cat(0.0, a * dp, 0.0), cat(0.0, bb * bp, 0.0))
    # boundary data: b1 scalar + top-v-row values, scaled through time at
    # the calls' boundary rate r_f
    rate = operators.boundary_rate(r_d, r_f, "call")
    nsf = torch.full_like(strikes, float(solver.n_steps))
    efac = torch.exp(-rate * solver.delta_t * (nsf - 1.0))
    b1val = (r_d - r_f) * g.vec_s[:, -1] * efac
    b2row = -0.5 * r_d * g.vec_s * efac[:, None]
    b2row[:, 0] = 0.0
    idx_s = gridmod.find_node(g.vec_s, s0)
    idx_v = gridmod.find_node(g.vec_v, v0)
    return u0, a1pq, scol, vrow, b1val, b2row, g, ops, idx_s, idx_v


def _assemble(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d,
              r_f):
    """Every time-loop input field of a book of calls (batch first, see
    the module docstring) plus the grids and the extraction indices.

    Returns (fields, vec_s [B, ns], idx_s [B], idx_v [B])."""
    (u0, a1pq, scol, vrow, b1val, b2row, g, ops, idx_s, idx_v
     ) = _prepare_batched(spec, solver, strikes, s0, kappa, eta, sigma,
                          rho, v0, r_d, r_f)
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
    return fields, g.vec_s, idx_s, idx_v.expand(b)


def dividend_plan(solver: SolverConfig,
                  dividends: Optional[DividendSchedule]):
    """(step, amount, pct) for every dividend event, in processing order:
    the events of step n (1-based; window n*dt <= date < (n+1)*dt,
    DividendSchedule.events_for_step) are applied before step n runs."""
    if dividends is None:
        return []
    return [(n, amount, pct)
            for n in range(1, solver.n_steps + 1)
            for amount, pct in dividends.events_for_step(n, solver.delta_t)]


def _build_remap_fields(vec_s, events):
    """Per event, the 2-point interpolation remap of the s axis of a book
    of calls as
    (i0, w0, i1, w1), each [B, ns]: U_new[:, i] = w0[i]*U[:, i0[i]] +
    w1[i]*U[:, i1[i]] (ref: src/solver.hpp:382-425). i0/i1 are int64.

    The first strictly-greater node comes from searchsorted(right=True);
    an index past the top node maps to 0, and index 0 (left
    extrapolation) copies column 0. Calls zero the columns whose shifted
    spot new_s <= 0. The weight pair is derived from whichever weight is
    >= 0.5, so 1 - w is exact (Sterbenz) and the pair sums to exactly 1
    — the kernel's difference-form remap weights the column's own value
    implicitly by 1 - w0 - w1."""
    m1 = vec_s.shape[1] - 1
    fields = []
    for _step, amount, pct in events:
        new_s = vec_s * (1.0 - pct) - amount
        idx = torch.searchsorted(vec_s, new_s, right=True)
        idx = torch.where(idx > m1, 0, idx)
        lo = torch.clamp(idx - 1, min=0)
        s_lo = torch.gather(vec_s, 1, lo)
        s_hi = torch.gather(vec_s, 1, idx)
        w = (new_s - s_lo) / torch.where(s_hi == s_lo,
                                         torch.ones_like(s_hi), s_hi - s_lo)
        valid = (new_s > 0.0).to(vec_s.dtype)
        is_left = idx == 0
        i0 = torch.where(is_left, 0, lo)
        i1 = torch.where(is_left, 0, idx)
        w0i = 1.0 - w
        w1i = torch.where(w >= 0.5, w, 1.0 - w0i)
        w0 = valid * torch.where(is_left, torch.ones_like(w), w0i)
        w1 = valid * torch.where(is_left, torch.zeros_like(w), w1i)
        fields.append((i0, w0, i1, w1))
    return fields


def _extract(u, idx_s, idx_v):
    """Price U[idx_s, idx_v] per option of u [B, ns, nv]."""
    return u[torch.arange(u.shape[0], device=u.device), idx_s, idx_v]


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
    """Prices [B] of a book of strikes through the batched Douglas time
    loop: the CUDA kernel for a CUDA `strikes` tensor, its plain version
    for a CPU one. Device and dtype come from `strikes`."""
    _check_slice(spec, solver, option_type, n_steps_per, rate_schedule)
    fields, vec_s, idx_s, idx_v = _assemble(
        spec, solver, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f)
    events = dividend_plan(solver, dividends)
    remaps = _build_remap_fields(vec_s, events)
    u = fused_do_loop(
        fields, [e[0] for e in events], remaps, theta=solver.theta,
        delta_t=solver.delta_t, n_steps=solver.n_steps,
        rf=operators.boundary_rate(r_d, r_f, option_type),
        american=american)
    return _extract(u, idx_s, idx_v)


# ---------------------------------------------------------------------------
# the time loop: plain version
# ---------------------------------------------------------------------------

def b1_mask(ns: int, nv: int, dtype=torch.float64, device=None):
    """[ns, nv] 0/1 mask of the b1 injection: the reference places b1 at
    the v-major flat indices m1*(j+1), j = 0..m2 — (row v, column s) =
    divmod(m1*(j+1), ns), NOT the s_max column for j >= 1
    (ref: src/BoundaryConditions.hpp:70-80)."""
    m1 = ns - 1
    mask = torch.zeros(ns, nv, dtype=dtype, device=device)
    for j in range(nv):
        row, col = divmod(m1 * (j + 1), ns)
        if row < nv:
            mask[col, row] = 1.0
    return mask


def _shift(x, k: int, dim: int):
    """result[.., i, ..] = x[.., i + k, ..] along `dim`, zero outside."""
    n = x.shape[dim]
    pad = torch.zeros_like(x.narrow(dim, 0, abs(k)))
    if k > 0:
        return torch.cat([x.narrow(dim, k, n - k), pad], dim=dim)
    return torch.cat([pad, x.narrow(dim, 0, n + k)], dim=dim)


def _two_sum(a, b):
    """Knuth 2Sum: s = fl(a + b) and err = a + b - s exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fused_do_reference(fields, ev_steps, remaps, *, theta: float,
                       delta_t: float, n_steps: int, rf,
                       american: bool) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the whole Douglas time loop of
    a book on [B, ns, nv] tensors. Returns the terminal surfaces
    [B, ns, nv] (u + compensation).

    ev_steps: the step of each dividend event (applied before that step);
    remaps: the matching (i0, w0, i1, w1) fields of _build_remap_fields.
    rf: the boundary growth rate (operators.boundary_rate)."""
    f = fields
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

    c_a0 = s_("sfac") * v_("vfac")
    b1f = b1_mask(ns, nv, dtype, dev) * f["b1v"][:, None, None]
    bottom = torch.zeros(ns, nv, dtype=dtype, device=dev)
    bottom[1:, nv - 1] = 1.0
    b2f = bottom * s_("b2r")
    # analytic reaction rows: A1 row 0 carries a1qd[0], every other row
    # -r_d/2 = a1qd[m1]; A2 rows 0..m2-2 carry -r_d/2 (calls)
    react_row = f["a1qd"][:, ns - 1]
    react_s = torch.where(torch.arange(ns, device=dev)[None, :] == 0,
                          f["a1qd"][:, :1], react_row[:, None])[:, :, None]
    react_v = torch.where(torch.arange(nv, device=dev)[None, :] < nv - 2,
                          react_row[:, None],
                          torch.zeros_like(react_row)[:, None])[:, None, :]
    u0 = torch.clamp(f["vecs"] - f["kk"][:, None], min=0.0)[:, :, None]
    smax_mask = (torch.arange(ns, device=dev) != ns - 1).to(dtype)
    smax_mask = smax_mask[None, :, None]
    rf_t = torch.as_tensor(rf, dtype=dtype, device=dev)

    comp = torch.zeros_like(u)
    lam = dt * f["lam"]            # dt-scaled LCP multiplier carry
    bsm, bsp = s_("bsm"), s_("bsp")
    bvm, bvp = v_("bvm"), v_("bvp")
    pl, ql, pu, qu = s_("a1pl"), s_("a1ql"), s_("a1pu"), s_("a1qu")
    al2, al1, au1, au2 = v_("al2"), v_("al1"), v_("au1"), v_("au2")
    events = list(zip(ev_steps, remaps))

    for n in range(1, n_steps + 1):
        while events and events[0][0] == n:
            _, (i0, w0, i1, w1) = events.pop(0)
            # fold the compensation into u, remap in difference form,
            # and restart the compensation from the remap's own rounding
            src = u + comp
            g0 = torch.gather(src, 1, i0[:, :, None].expand(b, ns, nv))
            g1 = torch.gather(src, 1, i1[:, :, None].expand(b, ns, nv))
            acc = w0[:, :, None] * (g0 - src) + w1[:, :, None] * (g1 - src)
            wsum = torch.where(w0 + w1 > 0.5, torch.ones_like(w0),
                               torch.zeros_like(w0))[:, :, None]
            u, comp = _two_sum(wsum * src, acc)

        e0 = torch.exp(rf_t * dt * (n - 1.0))
        e1 = torch.exp(rf_t * dt * float(n))
        kb1 = dt * e0 + td * (e1 - e0)
        kb2a = dt * e0
        kb2b = td * (e1 - e0)

        # explicit (A0 + A1 + A2) u in difference form
        dlo = _shift(u, -1, 1) - u
        dhi = _shift(u, 1, 1) - u
        dsu = bsm * dlo + bsp * dhi
        a2r = (al2 * (_shift(u, -2, 2) - u) + al1 * (_shift(u, -1, 2) - u)
               + au1 * (_shift(u, 1, 2) - u) + au2 * (_shift(u, 2, 2) - u)
               + react_v * u)
        bnd1 = kb1 * b1f + kb2a * b2f
        dv = (bvm * (_shift(dsu, -1, 2) - dsu)
              + bvp * (_shift(dsu, 1, 2) - dsu))
        a1 = (vfl * (pl * dlo + pu * dhi) + (ql * dlo + qu * dhi)
              + react_s * u)
        lu = c_a0 * dv + a1 + a2r
        d = dt * lu + bnd1
        if american:
            d = d + lam

        # Thomas solve along s (in place on d)
        for i in range(1, ns):
            d[:, i] = d[:, i] - tw[:, i] * d[:, i - 1]
        d[:, ns - 1] = d[:, ns - 1] * ti[:, ns - 1]
        for i in range(ns - 2, -1, -1):
            d[:, i] = (d[:, i] - iu[:, i] * d[:, i + 1]) * ti[:, i]

        # b2 injection on the top v-row, then the penta solve along v
        d[:, :, nv - 1] = d[:, :, nv - 1] + kb2b * f["b2r"]
        zrow = torch.zeros_like(d[:, :, 0])
        d[:, :, 0] = pm[:, :1] * d[:, :, 0]
        for j in range(1, nv):
            dp2 = d[:, :, j - 2] if j >= 2 else zrow
            d[:, :, j] = (pm[:, j:j + 1] * d[:, :, j]
                          - pgm[:, j:j + 1] * d[:, :, j - 1]
                          - phm[:, j:j + 1] * dp2)
        for j in range(nv - 2, -1, -1):
            x2 = d[:, :, j + 2] if j + 2 < nv else zrow
            d[:, :, j] = (d[:, :, j] - pc[:, j:j + 1] * d[:, :, j + 1]
                          - pc2[:, j:j + 1] * x2)

        # compensated update u' = u + z2 (Fast2Sum), American floor
        if american:
            t_inc = (d - lam) + comp
            q = u + t_inc
            err = t_inc - (q - u)
            u = torch.maximum(q, u0)
            comp = torch.where(q > u0, err, torch.zeros_like(err))
            lam = torch.clamp((u0 - q) - err, min=0.0) * smax_mask
        else:
            t_inc = d + comp
            q = u + t_inc
            comp = t_inc - (q - u)
            u = q
    return u + comp


# ---------------------------------------------------------------------------
# the time loop: CUDA kernel
# ---------------------------------------------------------------------------

def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home} or on PATH: the fused_do "
            f"kernel is built from {SOURCE} at first use")
    return found


def build() -> Path:
    """Compile csrc/fused_do.cu into build/heston_tpu_torch/ (once per
    source content) and return the shared library's path."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"fused_do_{tag[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    p, i, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    for name in ("fused_do_f32", "fused_do_f64"):
        fn = getattr(lib, name)
        # u0, u_out, work, sfields, vfields, scalars, ev_step, ev_idx,
        # ev_w, B, ns, nv, n_steps, american, n_events, dt, td, rf, stream
        fn.argtypes = [p] * 9 + [i] * 6 + [d] * 3 + [p]
        fn.restype = ctypes.c_int
    return lib


def _launch(fields, ev_steps, remaps, *, theta, delta_t, n_steps, rf,
            american) -> torch.Tensor:
    u = fields["u"]
    dtype, dev = u.dtype, u.device
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"fused_do kernel takes float32/float64, got {dtype}")
    if u.dim() != 3:
        raise ValueError(f"u must be [B, ns, nv], got {tuple(u.shape)}")
    b, ns, nv = u.shape
    shapes = {**{k: (b, ns) for k in _KERNEL_S_KEYS},
              **{k: (b, nv) for k in _KERNEL_V_KEYS},
              **{k: (b,) for k in SCALAR_KEYS}}
    for k, shape in shapes.items():
        t = fields[k]
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"field {k!r}: want {shape} {dtype} on {dev}, got "
                f"{tuple(t.shape)} {t.dtype} on {t.device}")
    steps = list(ev_steps)
    if len(steps) != len(remaps):
        raise ValueError("one remap per event step")
    if steps != sorted(steps) or any(not 1 <= s <= n_steps for s in steps):
        raise ValueError(f"event steps must ascend within 1..{n_steps}: "
                         f"{steps}")
    for rm in remaps:
        for t, want in zip(rm, (torch.int64, dtype, torch.int64, dtype)):
            if t.device != dev or t.dtype != want or tuple(t.shape) != (b, ns):
                raise ValueError("remap fields must be [B, ns] on the "
                                 "state's device (int64 indices)")

    u0 = u.contiguous()
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
    work = torch.empty(b, _N_WORK, ns * nv, dtype=dtype, device=dev)

    lib = _library()
    fn = lib.fused_do_f32 if dtype == torch.float32 else lib.fused_do_f64
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(u0.data_ptr(), out.data_ptr(), work.data_ptr(),
                sf.data_ptr(), vf.data_ptr(), sc.data_ptr(),
                ev_step.data_ptr(), ev_idx.data_ptr(), ev_w.data_ptr(),
                b, ns, nv, n_steps, int(american), n_ev,
                float(delta_t), float(theta * delta_t), float(rf), stream)
    if rc != 0:
        raise RuntimeError(f"fused_do kernel launch failed: CUDA error {rc}")
    fused_do_loop.launches += 1
    return out


def fused_do_loop(fields, ev_steps, remaps, *, theta: float, delta_t: float,
                  n_steps: int, rf, american: bool) -> torch.Tensor:
    """The whole Douglas time loop of a book: terminal surfaces
    [B, ns, nv]. Launches csrc/fused_do.cu (one launch, every dividend
    event included) for CUDA tensors and counts the launch in
    `fused_do_loop.launches`; runs fused_do_reference for CPU tensors;
    raises for any other device."""
    dev = fields["u"].device
    kw = dict(theta=theta, delta_t=delta_t, n_steps=n_steps, rf=rf,
              american=american)
    if dev.type == "cpu":
        return fused_do_reference(fields, ev_steps, remaps, **kw)
    if dev.type != "cuda":
        raise ValueError(f"fused_do runs on cuda or cpu tensors, got {dev}")
    return _launch(fields, ev_steps, remaps, **kw)


fused_do_loop.launches = 0

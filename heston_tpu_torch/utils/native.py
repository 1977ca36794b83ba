"""ctypes bindings to the native CPU engine (csrc/heston_cpu.cpp).

Counterpart of `heston_tpu.utils.native`: independent C++
implementations of the Thomas and pentadiagonal solves, the dividend
re-map and the full ADI time loop (all four schemes, Rannacher start-up,
American exercise, per-option step counts), run one option per OpenMP
thread — the reference's OpenMP performance-test build (ref:
src/perfomance_test.cpp:507-534) and an oracle independent of both the
eager loop and the CUDA kernels. It is a CPU engine by definition: it
takes and returns numpy arrays in float64.

The library is built from the repository's `csrc/heston_cpu.cpp`
(unchanged) with g++ into `build/heston_tpu_torch/`, once per content of
the source and the flags (OpenMP and -march=native where the compiler
takes them, as `csrc/Makefile` probes). Field assembly comes from the
port's own `models.douglas.prepare_instance` in float64 on the CPU.

Layout: the C++ surfaces are v-major, [nv, ns] per option (row j of
length ns, heston_cpu.cpp:14-16), the port's s-major [ns, nv]; the C++
reads the beta_v weights and the A2 bands per option ([b, nv]), the port
keeps one [nv] row for the book. `price_batch_cpu` converts both ways.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from heston_tpu_torch.models import douglas
from heston_tpu_torch.ops import operators

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "csrc" / "heston_cpu.cpp"
BUILD_DIR = _REPO / "build" / "heston_tpu_torch"
# g++ by name, not the environment's CXX, which may name a compiler
# without OpenMP (the engine then runs on one thread)
CXX = "g++"

_D = ctypes.POINTER(ctypes.c_double)
_L = ctypes.POINTER(ctypes.c_int64)
_I = ctypes.c_int64

# Scheme enum shared with csrc/heston_cpu.cpp (enum Scheme).
_SCHEME_IDS = {"do": 0, "cs": 1, "mcs": 2, "hv": 3}


def _accepts(flags) -> bool:
    """True when the compiler builds an empty program with `flags`."""
    proc = subprocess.run(
        [CXX, *flags, "-x", "c++", "-", "-o", os.devnull],
        input="int main(){return 0;}", capture_output=True, text=True)
    return proc.returncode == 0


@functools.cache
def cxx_flags() -> tuple:
    """The build's flags: csrc/Makefile's, with -march=native and -fopenmp
    where the compiler takes them."""
    flags = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
    if _accepts(["-march=native"]):
        flags.append("-march=native")
    if _accepts(["-fopenmp"]):
        flags.append("-fopenmp")
    return tuple(flags)


def _target_key(flags) -> bytes:
    """What -march=native resolves to on this host (the build's hash
    covers it, so a library built on another CPU is never loaded)."""
    if "-march=native" not in flags:
        return b""
    return subprocess.run([CXX, "-march=native", "-Q", "--help=target"],
                          capture_output=True).stdout


def build() -> Path:
    """Compile csrc/heston_cpu.cpp into build/heston_tpu_torch/, once per
    content of the source, the flags and the host's target, and return
    the shared library's path."""
    flags = cxx_flags()
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(flags).encode()
                         + _target_key(flags)).hexdigest()
    out = BUILD_DIR / f"{SOURCE.stem}_{tag[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [CXX, *flags, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): "
                           f"{' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """The native library (built on first use)."""
    lib = ctypes.CDLL(str(build()))
    d = ctypes.c_double
    lib.ht_tridiag_solve.argtypes = [_D] * 5 + [_I]
    lib.ht_tridiag_solve.restype = None
    lib.ht_penta_solve.argtypes = [_D] * 7 + [_I]
    lib.ht_penta_solve.restype = None
    lib.ht_do_solve.argtypes = ([_I, _I, _I, d, d, _I, _I, d] + [_D] * 17
                                + [_I, _D, _D, _D])
    lib.ht_do_solve.restype = None
    lib.ht_omp_threads.argtypes = []
    lib.ht_omp_threads.restype = ctypes.c_int64
    lib.ht_apply_dividend.argtypes = [_D, _D, d, d, _I, _I, _I, _I]
    lib.ht_apply_dividend.restype = None
    lib.ht_do_solve_batch.argtypes = (
        [_I, _I, _I, _I, d, d, _I, _I, d] + [_D] * 17 + [_I, _D]
        + [_I, _L, _D, _D, _D, _I] + [_D, _D, _L, _I])
    lib.ht_do_solve_batch.restype = None
    return lib


def _scheme_id(scheme: str) -> int:
    try:
        return _SCHEME_IDS[scheme]
    except KeyError:
        raise ValueError(
            f"the native CPU engine does not implement scheme "
            f"{scheme!r} (supported: {sorted(_SCHEME_IDS)})") from None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_D)


def _f64(a) -> np.ndarray:
    """A C-contiguous float64 numpy copy or view of an array or tensor."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=np.float64)


def tridiag_solve(ml, md, mu, rhs) -> np.ndarray:
    """Thomas solve of tridiag(ml, md, mu) x = rhs (row-aligned bands:
    ml[0] and mu[n-1] are not read)."""
    lib = load()
    ml, md, mu, rhs = map(_f64, (ml, md, mu, rhs))
    x = np.empty_like(rhs)
    lib.ht_tridiag_solve(_ptr(ml), _ptr(md), _ptr(mu), _ptr(rhs), _ptr(x),
                         rhs.shape[0])
    return x


def penta_solve(l2, l1, d, u1, u2, rhs) -> np.ndarray:
    """Solve of the pentadiagonal system with row-aligned bands."""
    lib = load()
    l2, l1, d, u1, u2, rhs = map(_f64, (l2, l1, d, u1, u2, rhs))
    x = np.empty_like(rhs)
    lib.ht_penta_solve(_ptr(l2), _ptr(l1), _ptr(d), _ptr(u1), _ptr(u2),
                       _ptr(rhs), _ptr(x), rhs.shape[0])
    return x


def omp_threads() -> int:
    """The OpenMP thread count of the batch engine (honours
    OMP_NUM_THREADS; 1 when built without OpenMP): the label of a CPU
    timing."""
    return int(load().ht_omp_threads())


def apply_dividend(u, vec_s, amount: float, pct: float, put: bool = False,
                   knock_top: bool = False) -> np.ndarray:
    """Native dividend re-map of one surface u [nv, ns] (v-major, the C++
    layout) on the s-nodes vec_s [ns]: the oracle of
    `douglas.apply_dividend`; knock_top re-knocks a top-knocked barrier's
    column ns-1."""
    lib = load()
    u = _f64(u).copy()
    vec_s = _f64(vec_s)
    nv, ns = u.shape
    lib.ht_apply_dividend(_ptr(u), _ptr(vec_s), amount, pct,
                          1 if put else 0, 1 if knock_top else 0, nv, ns)
    return u


def _v_major(x: torch.Tensor) -> np.ndarray:
    """Surfaces [B, ns, nv] (the port's layout) as contiguous [B, nv, ns]."""
    return _f64(x.transpose(-1, -2))


def _per_option(row: torch.Tensor, b: int) -> np.ndarray:
    """One [nv] row of the book as contiguous [b, nv] (the C++ reads the
    beta_v weights and A2 bands per option)."""
    return _f64(row.expand(b, -1))


def _fields(inst: douglas.PreparedInstance) -> list:
    """The 17 operator arrays of ht_do_solve(_batch), in its argument
    order, in the C++ layout."""
    ops = inst.ops
    b = inst.u0.shape[0]
    return ([_v_major(ops.a0_c)]
            + [_f64(x) for x in (ops.bs_wm, ops.bs_w0, ops.bs_wp)]
            + [_per_option(x, b) for x in (ops.bv_wm, ops.bv_w0, ops.bv_wp)]
            + [_v_major(x) for x in (ops.a1_ml, ops.a1_md, ops.a1_mu)]
            + [_per_option(x, b) for x in (ops.a2_l2, ops.a2_l1, ops.a2_d,
                                           ops.a2_u1, ops.a2_u2)]
            + [_v_major(inst.b1), _v_major(inst.b2)])


def price_batch_cpu(spec, solver, strikes, s0, kappa, eta, sigma, rho, v0,
                    r_d, r_f, american: bool = False, dividends=None,
                    option_type: str = "call",
                    group_steps=()) -> np.ndarray:
    """Prices [B] (numpy, float64) of a book on the native OpenMP engine
    (csrc/heston_cpu.cpp::ht_do_solve_batch, one option per thread; the
    JAX package's heston_tpu/utils/native.py:144-254). The fields come
    from `douglas.prepare_instance` in float64 on the CPU; every scheme
    and Rannacher start-up run natively.

    group_steps: optional (start, end, n_steps) maturity-ladder slices
    (shared dt; solver.n_steps the largest): each group's fields are
    assembled at its own step count, and each option stops at its own."""
    from heston_tpu_torch.models.calibration import validate_group_steps

    scheme_id = _scheme_id(solver.scheme)   # raises on unknown schemes
    lib = load()
    ks = torch.as_tensor(np.asarray(strikes, dtype=np.float64))
    b = int(ks.shape[0])
    validate_group_steps(group_steps, b, n_steps=solver.n_steps)
    groups = group_steps or ((0, b, solver.n_steps),)
    douglas._validate_barrier_book(spec, s0, ks)
    parts = [douglas.prepare_instance(
        spec, dataclasses.replace(solver, n_steps=g,
                                  maturity=g * solver.delta_t),
        ks[a:e], float(s0), kappa, eta, sigma, rho, v0, r_d, r_f,
        option_type) for a, e, g in groups]
    fields = [np.concatenate(cols) for cols in zip(*map(_fields, parts))]
    u0 = np.concatenate([_v_major(inst.u0) for inst in parts])
    vec_s = np.concatenate([_f64(inst.grid.vec_s) for inst in parts])
    idx_s = np.concatenate([inst.idx_s.numpy() for inst in parts])
    idx_v = int(parts[0].idx_v)
    u = u0.copy()
    lam = np.zeros_like(u)

    ev = []
    if dividends is not None and len(dividends) > 0:
        for n in range(1, solver.n_steps + 1):
            for amt, pct in dividends.events_for_step(n, solver.delta_t):
                ev.append((n, amt, pct))
    ev_step = np.ascontiguousarray([e[0] for e in ev], dtype=np.int64)
    ev_amt = _f64([e[1] for e in ev])
    ev_pct = _f64([e[2] for e in ev])
    nst = (np.ascontiguousarray(np.concatenate(
        [np.full(e - a, g) for a, e, g in groups]), dtype=np.int64)
        if group_steps else None)
    b_rate = float(operators.boundary_rate(r_d, r_f, option_type))
    nv, ns = spec.m2 + 1, spec.m1 + 1
    lib.ht_do_solve_batch(
        b, nv, ns, solver.n_steps, solver.delta_t, solver.theta, scheme_id,
        int(solver.rannacher_steps), b_rate, *map(_ptr, fields),
        # American mode: 2 = the digital's static pin + box projection,
        # 1 = Ikonen-Toivanen (douglas._do_step)
        ((2 if operators.is_digital(option_type) else 1)
         if american else 0), _ptr(u0),
        len(ev), ev_step.ctypes.data_as(_L), _ptr(ev_amt), _ptr(ev_pct),
        _ptr(vec_s), 1 if operators.is_put(option_type) else 0, _ptr(u),
        _ptr(lam), nst.ctypes.data_as(_L) if nst is not None else None,
        1 if (spec.barrier is not None and spec.barrier.knock_top) else 0)
    return u[np.arange(b), idx_v, idx_s]


def do_solve(inst: douglas.PreparedInstance, solver, b_rate,
             american: bool = False) -> np.ndarray:
    """The whole ADI loop of one option natively (ht_do_solve; no
    dividends): `inst` a `douglas.prepare_instance` of one strike, the
    scheme and Rannacher steps `solver`'s, `b_rate` the boundary growth
    rate (operators.boundary_rate). Returns the terminal surface [ns, nv]
    in the port's layout, the counterpart of `douglas.run_time_loop`."""
    if inst.u0.shape[0] != 1:
        raise ValueError(f"do_solve prices one option; the instance holds "
                         f"{inst.u0.shape[0]}")
    lib = load()
    u0 = _v_major(inst.u0)[0]
    nv, ns = u0.shape
    u = u0.copy()
    lam = np.zeros_like(u)
    lib.ht_do_solve(
        nv, ns, solver.n_steps, solver.delta_t, solver.theta,
        _scheme_id(solver.scheme), int(solver.rannacher_steps),
        float(b_rate), *map(_ptr, _fields(inst)), 1 if american else 0,
        _ptr(u0), _ptr(u), _ptr(lam))
    return u.T

"""Batched tridiagonal / pentadiagonal solvers of the eager ADI engine.

PyTorch counterpart of `heston_tpu.ops.banded` (ref: src/hes_a1_kernels.hpp:
137-161, src/hes_a2_shuffled_kernels.hpp:241-299). The implicit matrices
(I - theta*dt*A) do not change over the time loop, so their coefficient
sweeps are factored once (`tridiag_factor`, `penta_factor`) and each step
runs only the substitutions, which are first- and second-order affine
recurrences along the solve axis, under one of two engines:

  "scan": a Python loop over the rows in the reference's order, every
          other axis (options x grid lines) vectorised — the same
          arithmetic, row for row, as the JAX package's `lax.scan`;
  "pcr":  log-depth: the recurrence as a prefix composition of affine
          maps by Hillis–Steele doubling (ceil(log2 n) passes over the
          whole line). Its rounding order differs from the scan's and
          from `lax.associative_scan`'s.

Conventions as in the JAX package: bands are row-aligned (l1[r] =
A[r][r-1], u1[r] = A[r][r+1], ...); tridiagonal systems solve along the
LAST axis, pentadiagonal ones along axis -2 with bands (..., n)
broadcast over the trailing axis. Every function is out-of-place, so
`torch.func.jvp` and `torch.func.vmap` run through it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

ENGINES = ("scan", "pcr")


# ---------------------------------------------------------------------------
# affine recurrences along axis 0
# ---------------------------------------------------------------------------

def _affine1_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """s_j = a_j * s_{j-1} + b_j (s_{-1} = 0), sequentially over axis 0."""
    s = torch.zeros_like(b[0])
    out = []
    for j in range(b.shape[0]):
        s = a[j] * s + b[j]
        out.append(s)
    return torch.stack(out)


def _shifted(x: torch.Tensor, d: int, fill: float) -> torch.Tensor:
    """x[j - d] along axis 0, `fill` for j < d."""
    return torch.cat([torch.full_like(x[:d], fill), x[:-d]])


def _affine1_pcr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The same recurrence by doubling: after the pass at distance d,
    (A_j, B_j) is the composition of the maps j-2d+1..j, so s_j = B_j
    once d reaches n (the identity map (1, 0) pads j < d)."""
    a, b = torch.broadcast_tensors(a, b)
    d = 1
    while d < b.shape[0]:
        a, b = a * _shifted(a, d, 1.0), a * _shifted(b, d, 0.0) + b
        d *= 2
    return b


def _affine2_scan(g: torch.Tensor, h: torch.Tensor,
                  r: torch.Tensor) -> torch.Tensor:
    """d_j = r_j - g_j * d_{j-1} - h_j * d_{j-2} (d_{-1} = d_{-2} = 0)."""
    d1 = d2 = torch.zeros_like(r[0])
    out = []
    for j in range(r.shape[0]):
        d1, d2 = r[j] - g[j] * d1 - h[j] * d2, d1
        out.append(d1)
    return torch.stack(out)


def _affine2_pcr(g: torch.Tensor, h: torch.Tensor,
                 r: torch.Tensor) -> torch.Tensor:
    """The second-order recurrence as a prefix of 2x2 affine maps: state
    y_j = (d_j, d_{j-1}), y_j = M_j y_{j-1} + t_j with M_j = [[-g_j, -h_j],
    [1, 0]], t_j = (r_j, 0); composed by doubling (identity padding)."""
    g, h, r = torch.broadcast_tensors(g, h, r)
    zeros = torch.zeros_like(r)
    m = [-g, -h, torch.ones_like(r), zeros, r, zeros]
    ident = (1.0, 0.0, 0.0, 1.0, 0.0, 0.0)
    n = r.shape[0]
    d = 1
    while d < n:
        a11, a12, a21, a22, u1, u2 = (_shifted(x, d, f)
                                      for x, f in zip(m, ident))
        b11, b12, b21, b22, v1, v2 = m
        # compose (B, v) o (A, u) = (B A, B u + v): A the earlier maps
        m = [b11 * a11 + b12 * a21, b11 * a12 + b12 * a22,
             b21 * a11 + b22 * a21, b21 * a12 + b22 * a22,
             b11 * u1 + b12 * u2 + v1, b21 * u1 + b22 * u2 + v2]
        d *= 2
    return m[4]


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown banded-solver engine {engine!r}; 'pallas' is handled "
            "at the price_batch level, not inside the banded solvers")


def _affine1(a, b, engine):
    _check_engine(engine)
    return _affine1_pcr(a, b) if engine == "pcr" else _affine1_scan(a, b)


def _affine2(g, h, r, engine):
    _check_engine(engine)
    return (_affine2_pcr(g, h, r) if engine == "pcr"
            else _affine2_scan(g, h, r))


def _flip(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(x, dims=(0,))


def _rows(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.movedim(x, axis, 0)


# ---------------------------------------------------------------------------
# tridiagonal (A1, along the last axis)
# ---------------------------------------------------------------------------

class TridiagFactor(NamedTuple):
    """Thomas forward coefficients w[i] = ml[i] / temp[i-1], temp[i] =
    md[i] - w[i] * mu[i-1] (ref: src/hes_a1_kernels.hpp:145-151), 1/temp,
    and the back-substitution coefficient alpha = -mu / temp."""

    w: torch.Tensor
    inv_temp: torch.Tensor
    alpha_back: torch.Tensor


def tridiag_factor(ml: torch.Tensor, md: torch.Tensor,
                   mu: torch.Tensor) -> TridiagFactor:
    """Factor row-aligned tridiagonal bands (..., n) (ml[..., 0] = 0)."""
    ml_t, md_t, mu_t = (_rows(x, -1) for x in (ml, md, mu))
    temp_prev = torch.ones_like(md_t[0])
    mu_prev = torch.zeros_like(md_t[0])
    ws, temps = [], []
    for i in range(md_t.shape[0]):
        w = ml_t[i] / temp_prev
        temp_prev = md_t[i] - w * mu_prev
        mu_prev = mu_t[i]
        ws.append(w)
        temps.append(temp_prev)
    inv_temp_t = 1.0 / torch.stack(temps)
    alpha_t = -mu_t * inv_temp_t
    return TridiagFactor(*(torch.movedim(x, 0, -1)
                           for x in (torch.stack(ws), inv_temp_t, alpha_t)))


def tridiag_solve(fac: TridiagFactor, rhs: torch.Tensor,
                  engine: str = "scan") -> torch.Tensor:
    """Solve along the last axis given a factorization:
    forward d_i = rhs_i - w_i d_{i-1}, backward x_i = (d_i - mu_i x_{i+1})
    / temp_i (ref: src/hes_a1_kernels.hpp:141-160; "scan" is the same
    arithmetic)."""
    d_t = _affine1(-_rows(fac.w, -1), _rows(rhs, -1), engine)
    x_rev = _affine1(_flip(_rows(fac.alpha_back, -1)),
                     _flip(d_t * _rows(fac.inv_temp, -1)), engine)
    return torch.movedim(_flip(x_rev), 0, -1)


# ---------------------------------------------------------------------------
# pentadiagonal (A2, along axis -2, bands broadcast over the last axis)
# ---------------------------------------------------------------------------

class PentaFactor(NamedTuple):
    """Pentadiagonal LU sweep coefficients in the reference's recurrence
    (ref: src/hes_a2_shuffled_kernels.hpp:241-299): L_j = l1_j - l2_j
    c_{j-2}, m_j = 1 / (d_j - L_j c_{j-1} - l2_j c2_{j-2}), c_j = (u1_j -
    L_j c2_{j-1}) m_j, c2_j = u2_j m_j; rows 0 and 1 start from zero
    carries (l1_0 = l2_0 = l2_1 = 0 for row-aligned bands)."""

    c: torch.Tensor      # (..., n)
    c2: torch.Tensor
    gm: torch.Tensor     # L_j * m_j, forward coefficient on d_{j-1}
    hm: torch.Tensor     # l2_j * m_j, forward coefficient on d_{j-2}
    m: torch.Tensor      # 1 / den


def penta_factor(l2, l1, d, u1, u2) -> PentaFactor:
    """Factor row-aligned pentadiagonal bands of shape (..., n)."""
    l2_t, l1_t, d_t, u1_t, u2_t = (_rows(x, -1) for x in (l2, l1, d, u1, u2))
    z = torch.zeros_like(d_t[0])
    c1p = c2p = cc1p = cc2p = z    # c_{j-1}, c_{j-2}, c2_{j-1}, c2_{j-2}
    outs = []
    for j in range(d_t.shape[0]):
        big_l = l1_t[j] - l2_t[j] * c2p
        den = d_t[j] - big_l * c1p - l2_t[j] * cc2p
        m = 1.0 / den
        c = (u1_t[j] - big_l * cc1p) * m
        c2 = u2_t[j] * m
        outs.append((c, c2, big_l * m, l2_t[j] * m, m))
        c1p, c2p, cc1p, cc2p = c, c1p, c2, cc1p
    return PentaFactor(*(torch.movedim(torch.stack(col), 0, -1)
                         for col in zip(*outs)))


def penta_solve(fac: PentaFactor, rhs: torch.Tensor,
                engine: str = "scan") -> torch.Tensor:
    """Solve along axis -2 of rhs; the factor arrays (..., n) broadcast
    over the last axis: forward d'_j = m_j rhs_j - gm_j d'_{j-1} - hm_j
    d'_{j-2}, backward x_j = d'_j - c_j x_{j+1} - c2_j x_{j+2}
    (ref: src/hes_a2_shuffled_kernels.hpp:278-296)."""

    def bcast(band):            # (..., n) -> (n, ..., 1)
        return _rows(band, -1)[..., None]

    rhs_t = _rows(rhs, -2)
    dprime = _affine2(bcast(fac.gm), bcast(fac.hm), bcast(fac.m) * rhs_t,
                      engine)
    x_rev = _affine2(_flip(bcast(fac.c)), _flip(bcast(fac.c2)),
                     _flip(dprime), engine)
    return torch.movedim(_flip(x_rev), 0, -2)

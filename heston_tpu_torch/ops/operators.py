"""Heston ADI operator bands, payoffs and boundary rates.

PyTorch counterpart of the parts of `heston_tpu.ops.operators` that the
batched Douglas kernel reads (ref: src/hes_mat_fac.cpp,
src/hes_A2_mat.cpp): the A1 tridiagonal bands along s, the A2
pentadiagonal bands along v (central and upwind), the beta weights of the
separable A0 mixed stencil, the payoffs and the boundary-scaling rate.

Layout: s-direction quantities are [B, m1+1] (one row per option), the
v-direction bands are [m2+1] and shared by the book (they depend on the
shared v-grid and the model parameters only). Bands are row-aligned:
l2[r] = A[r][r-2], l1[r] = A[r][r-1], d[r] = A[r][r], u1[r] = A[r][r+1],
u2[r] = A[r][r+2].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from heston_tpu_torch.ops import coeff
from heston_tpu_torch.ops.grid import Grid

OPTION_TYPES = ("call", "put", "digital_call", "digital_put")


def _validate_option_type(option_type: str) -> str:
    if option_type not in OPTION_TYPES:
        raise ValueError(f"unknown option_type: {option_type!r}; "
                         f"expected one of {OPTION_TYPES}")
    return option_type


def is_put(option_type: str) -> bool:
    """True for payoffs in the money below the strike (put, digital_put)."""
    return _validate_option_type(option_type) in ("put", "digital_put")


def is_digital(option_type: str) -> bool:
    """Cash-or-nothing payoff (digital_call, digital_put)."""
    return _validate_option_type(option_type).startswith("digital")


def is_injection_free(option_type: str) -> bool:
    """True when the scheme needs no boundary injection vectors: every
    payoff except the vanilla call."""
    return _validate_option_type(option_type) != "call"


def boundary_rate(r_d, r_f, option_type: str = "call"):
    """Growth rate of the boundary time scaling e^{rate*dt*n}
    (ref: src/solver.hpp:65-68): r_f for calls, r_d (unused) otherwise."""
    return r_d if is_injection_free(option_type) else r_f


def _shift_last(x: torch.Tensor, k: int) -> torch.Tensor:
    """result[..., i] = x[..., i + k], zero outside (|k| = 1)."""
    z = torch.zeros_like(x[..., :1])
    if k > 0:
        return torch.cat([x[..., 1:], z], dim=-1)
    return torch.cat([z, x[..., :-1]], dim=-1)


def grid_payoff(vec_s, strike, option_type: str):
    """Terminal payoff at the grid nodes (s along the last axis; `strike`
    broadcasts against vec_s). Vanillas: max(±(s - K), 0). Digitals: the
    cell-averaged indicator clip((s_{i+1/2} - K)/(s_{i+1/2} - s_{i-1/2}),
    0, 1) (calls; puts mirror it)."""
    if not is_digital(option_type):
        intrinsic = strike - vec_s if is_put(option_type) else vec_s - strike
        return torch.clamp(intrinsic, min=0.0)
    n = vec_s.shape[-1]
    ids = torch.arange(n, device=vec_s.device)
    hi = torch.where(ids == n - 1, vec_s, 0.5 * (vec_s + _shift_last(vec_s, 1)))
    lo = torch.where(ids == 0, vec_s, 0.5 * (vec_s + _shift_last(vec_s, -1)))
    den = torch.where(hi == lo, torch.ones_like(hi), hi - lo)
    num = (strike - lo) if is_put(option_type) else (hi - strike)
    return torch.clamp(num / den, 0.0, 1.0)


def build_a1_bands(grid: Grid, r_d, r_f, option_type: str = "call"):
    """S-direction tridiagonal bands (ml, md, mu), each [B, m2+1, m1+1]
    (ref: src/hes_mat_fac.cpp:61-91). Interior rows get
    0.5*s^2*v*delta + (r_d-r_f)*s*beta - r_d/2; row m1 only -r_d/2 on the
    diagonal; row 0 is zero for calls and -r_d/2 for puts."""
    s, v = grid.vec_s, grid.vec_v
    m1 = s.shape[-1] - 1
    h0 = grid.dels[:, : m1 - 1]
    h1 = grid.dels[:, 1:m1]
    dm, d0, dp = coeff.w_delta(h0, h1)
    bm, b0, bp = coeff.w_beta(h0, h1)

    a = 0.5 * v[None, :, None] * (s[:, 1:m1] ** 2)[:, None, :]
    bb = ((r_d - r_f) * s[:, 1:m1])[:, None, :]
    ml_int = a * dm[:, None, :] + bb * bm[:, None, :]
    md_int = a * d0[:, None, :] + bb * b0[:, None, :] - 0.5 * r_d
    mu_int = a * dp[:, None, :] + bb * bp[:, None, :]

    zcol = torch.zeros_like(ml_int[..., :1])
    d_left = -0.5 * r_d if is_put(option_type) else 0.0
    ml = torch.cat([zcol, ml_int, zcol], dim=-1)
    md = torch.cat([zcol + d_left, md_int, zcol - 0.5 * r_d], dim=-1)
    mu = torch.cat([zcol, mu_int, zcol], dim=-1)
    return ml, md, mu


def build_a2_bands(grid: Grid, r_d, kappa, eta, sigma, variant: str,
                   option_type: str = "call"):
    """V-direction pentadiagonal bands (l2, l1, d, u1, u2), each [m2+1]
    (ref: src/hes_A2_mat.cpp:37-109 central, :410-421 upwind).

    Row 0: one-sided gamma stencil on Delta_v[1], Delta_v[2] (reference
    quirk). Rows 1..m2-2: central beta/delta stencil. Reaction -r_d/2 on
    rows 0..m2-2 for calls, on every row for injection-free payoffs.
    "upwind" adds backward-upwind convection and a repeated diffusion term
    ONE ROW BELOW each node with v > 1 (row j+1 — a reproduced quirk)."""
    v, dv = grid.vec_v, grid.delv
    m2 = v.shape[-1] - 1
    zero = torch.zeros_like(v)
    l2, l1, d, u1, u2 = (zero.clone() for _ in range(5))

    n_react = m2 + 1 if is_injection_free(option_type) else m2 - 1
    d[:n_react] += -0.5 * r_d

    temp0 = kappa * (eta - v[0])
    g0, g1, g2 = coeff.w_gamma(dv[1], dv[2])
    d[0] += temp0 * g0
    u1[0] += temp0 * g1
    u2[0] += temp0 * g2

    h0 = dv[: m2 - 2]
    h1 = dv[1: m2 - 1]
    dm, d0, dp = coeff.w_delta(h0, h1)
    bm, b0, bp = coeff.w_beta(h0, h1)
    vj = v[1: m2 - 1]
    temp = kappa * (eta - vj)
    temp2 = 0.5 * sigma * sigma * vj
    rows = slice(1, m2 - 1)
    l1[rows] += temp * bm + temp2 * dm
    d[rows] += temp * b0 + temp2 * d0
    u1[rows] += temp * bp + temp2 * dp

    if variant == "upwind":
        am, a1_, a0_ = coeff.w_alpha(h0, h1)
        mask = (vj > 1.0).to(v.dtype)
        below = slice(2, m2)
        l2[below] += mask * temp * am
        l1[below] += mask * (temp * a1_ + temp2 * dm)
        d[below] += mask * (temp * a0_ + temp2 * d0)
        u1[below] += mask * temp2 * dp
    elif variant != "central":
        raise ValueError(f"unknown A2 variant: {variant!r}")
    return l2, l1, d, u1, u2


class KernelOperators(NamedTuple):
    """The operator data the batched Douglas kernel reads."""

    bs_wm: torch.Tensor   # [B, m1+1] beta_s weights (0 on the boundary)
    bs_w0: torch.Tensor
    bs_wp: torch.Tensor
    bv_wm: torch.Tensor   # [m2+1] beta_v weights (0 on the boundary)
    bv_w0: torch.Tensor
    bv_wp: torch.Tensor
    a2_l2: torch.Tensor   # [m2+1] explicit A2 bands
    a2_l1: torch.Tensor
    a2_d: torch.Tensor
    a2_u1: torch.Tensor
    a2_u2: torch.Tensor


def build_operators(grid: Grid, kappa, eta, sigma, r_d,
                    a2_variant: str = "upwind",
                    option_type: str = "call") -> KernelOperators:
    """The A0 beta weights and the explicit A2 bands of a book — the
    fields of `heston_tpu.ops.operators.build_operators` that the kernel
    path reads (the A1 bands reach it in rank-2 form, see
    kernels.fused_do._prepare_batched)."""
    m1 = grid.vec_s.shape[-1] - 1
    m2 = grid.vec_v.shape[-1] - 1
    bs = coeff.w_beta(grid.dels[:, : m1 - 1], grid.dels[:, 1:m1])
    bv = coeff.w_beta(grid.delv[: m2 - 1], grid.delv[1:m2])
    pad = torch.nn.functional.pad
    bs = [pad(x, (1, 1)) for x in bs]
    bv = [pad(x, (1, 1)) for x in bv]
    a2 = build_a2_bands(grid, r_d, kappa, eta, sigma, a2_variant,
                        option_type)
    return KernelOperators(*bs, *bv, *a2)

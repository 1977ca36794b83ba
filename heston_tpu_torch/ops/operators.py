"""Heston ADI operator bands, boundary vectors, payoffs and boundary rates.

PyTorch counterpart of `heston_tpu.ops.operators` for the batched Douglas
kernel and the theta epilogue of book risk (ref: src/hes_mat_fac.cpp,
src/hes_A2_mat.cpp, src/BoundaryConditions.hpp): the A1 tridiagonal bands
along s, the A2 pentadiagonal bands along v (central and upwind), the
beta weights and coefficient of the separable A0 mixed stencil, the
boundary vector b, the three explicit multiplies, the payoffs (calls,
puts and cash-or-nothing digitals), the boundary-scaling rate and the
segments of a rate curve (`rate_segment_structure`). A
knock-out barrier (`GridSpec.barrier`) enters through the A2 reaction
rows and the boundary data; its knocked columns start at zero (the
payoff is masked) and every operator keeps them there. The implicit bands are not built: the kernel
derives them.

Layout: surfaces are s-major, [B, m1+1, m2+1] (one per option: the
port's layout, where the JAX package keeps [m2+1, m1+1] per option);
s-direction rows are [B, m1+1], the v-direction bands [m2+1], shared by
the book (they depend on the shared v-grid and the model parameters
only). Bands are row-aligned: l2[r] = A[r][r-2], l1[r] = A[r][r-1],
d[r] = A[r][r], u1[r] = A[r][r+1], u2[r] = A[r][r+2].
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

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


def rate_segment_structure(n_steps: int, delta_t: float, maturity: float,
                           rate_schedule, option_type: str = "call"):
    """The segments of a `config.RateSchedule` on the step axis
    (heston_tpu/ops/operators.py:332-357): a tuple of (n_lo, n_hi, r_d,
    r_f, b_rate, anchor), 1-based inclusive main-step ranges ascending
    over 1..n_steps, plain Python floats.

    anchor_k = exp(-b_rate_k*dt*min(n_hi_k, N-1) - tail_k), tail_k the
    integral of the step-piecewise boundary rate over the later segments'
    steps up to N-1, replaces the flat e^{-rate*dt*(N-1)} of the boundary
    data, so that the stepper's in-segment e^{b_rate_k*dt*n} lands every
    step on exp(-[I((N-1)dt) - I(tau)]); one segment gives the flat
    factor."""
    per = rate_schedule.step_rates(n_steps, delta_t, maturity)
    brate = [boundary_rate(rd, rf, option_type) for rd, rf in per]
    out = []
    for n_lo, n_hi, rd, rf in rate_schedule.step_segments(n_steps, delta_t,
                                                          maturity):
        br = boundary_rate(rd, rf, option_type)
        tail = delta_t * sum(brate[m - 1] for m in range(n_hi + 1, n_steps))
        anchor = math.exp(-br * delta_t * min(n_hi, n_steps - 1) - tail)
        out.append((n_lo, n_hi, rd, rf, br, anchor))
    return tuple(out)


def shift(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """result[.., i, ..] = x[.., i + k, ..] along `dim`, zero outside."""
    n = x.shape[dim]
    pad = torch.zeros_like(x.narrow(dim, 0, abs(k)))
    if k > 0:
        return torch.cat([x.narrow(dim, k, n - k), pad], dim=dim)
    return torch.cat([pad, x.narrow(dim, 0, n + k)], dim=dim)


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


def intrinsic_value(vec_s, strike, option_type: str):
    """Signed intrinsic value, not floored: s - K for calls, K - s for
    puts. Vanilla payoffs only (digitals raise ValueError; see
    payoff_value)."""
    if is_digital(option_type):
        raise ValueError("intrinsic_value is vanilla-only; "
                         "use payoff_value for digitals")
    return strike - vec_s if is_put(option_type) else vec_s - strike


def payoff_value(vec_s, strike, option_type: str):
    """Floored payoff at arbitrary spots: max(±(s - K), 0) for vanillas,
    the 0/1 cash-or-nothing indicator for digitals (call 1{s > K}, put
    1{s < K}, strict). Pointwise; PDE grids use grid_payoff."""
    if is_digital(option_type):
        ind = (vec_s < strike) if is_put(option_type) else (vec_s > strike)
        return ind.to(vec_s.dtype)
    return torch.clamp(intrinsic_value(vec_s, strike, option_type), min=0.0)


def grid_payoff(vec_s, strike, option_type: str):
    """Terminal payoff at the grid nodes (s along the last axis; `strike`
    broadcasts against vec_s). Vanillas: max(±(s - K), 0). Digitals: the
    cell-averaged indicator clip((s_{i+1/2} - K)/(s_{i+1/2} - s_{i-1/2}),
    0, 1) (calls; puts mirror it). Differentiable in the spot as the JAX
    package's is: at the kink of an at-the-money option's spot node the
    derivative is 1/2 (`torch.maximum`, not `torch.clamp`)."""
    if not is_digital(option_type):
        intrinsic = strike - vec_s if is_put(option_type) else vec_s - strike
        return torch.maximum(intrinsic, torch.zeros_like(intrinsic))
    n = vec_s.shape[-1]
    ids = torch.arange(n, device=vec_s.device)
    hi = torch.where(ids == n - 1, vec_s, 0.5 * (vec_s + shift(vec_s, 1, -1)))
    lo = torch.where(ids == 0, vec_s, 0.5 * (vec_s + shift(vec_s, -1, -1)))
    den = torch.where(hi == lo, torch.ones_like(hi), hi - lo)
    num = (strike - lo) if is_put(option_type) else (hi - strike)
    return clip01(num / den)


def clip01(x: torch.Tensor) -> torch.Tensor:
    """x clipped to [0, 1] by maximum and minimum, whose forward-mode
    derivative splits evenly at a tie, as jnp.clip's does (torch.clamp
    passes the whole tangent); the values are clamp's."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)),
                         torch.ones_like(x))


def build_a1_bands(grid: Grid, r_d, r_f, option_type: str = "call"):
    """S-direction tridiagonal bands (ml, md, mu), each [B, m1+1, m2+1]
    (ref: src/hes_mat_fac.cpp:61-91). Interior rows get
    0.5*s^2*v*delta + (r_d-r_f)*s*beta - r_d/2; row m1 only -r_d/2 on the
    diagonal; row 0 is zero for calls and -r_d/2 for puts."""
    s, v = grid.vec_s, grid.vec_v
    m1 = s.shape[-1] - 1
    h0 = grid.dels[:, : m1 - 1]
    h1 = grid.dels[:, 1:m1]
    dm, d0, dp = coeff.w_delta(h0, h1)
    bm, b0, bp = coeff.w_beta(h0, h1)

    a = 0.5 * v[None, None, :] * (s[:, 1:m1] ** 2)[:, :, None]
    bb = ((r_d - r_f) * s[:, 1:m1])[:, :, None]
    ml_int = a * dm[:, :, None] + bb * bm[:, :, None]
    md_int = a * d0[:, :, None] + bb * b0[:, :, None] - 0.5 * r_d
    mu_int = a * dp[:, :, None] + bb * bp[:, :, None]

    zrow = torch.zeros_like(ml_int[:, :1])
    d_left = -0.5 * r_d if is_put(option_type) else 0.0
    ml = torch.cat([zrow, ml_int, zrow], dim=1)
    md = torch.cat([zrow + d_left, md_int, zrow - 0.5 * r_d], dim=1)
    mu = torch.cat([zrow, mu_int, zrow], dim=1)
    return ml, md, mu


def full_reaction(option_type: str, knock_top: bool = False) -> bool:
    """True when every A2 row carries the -r_d/2 reaction and no boundary
    data is injected: the injection-free payoffs and top-knocked barriers
    (up-out, double-out: `knock_top`), whose far fields emerge from the
    full -r_d decay. The one rule behind the A2 bands, the boundary data
    and both kernels' reaction rows (`n_react`)."""
    return is_injection_free(option_type) or knock_top


def n_react(option_type: str, knock_top: bool, nv: int) -> int:
    """The A2 rows 0..n_react-1 that carry the -r_d/2 reaction: all nv
    under `full_reaction`, nv - 2 for calls
    (heston_tpu/pallas/fused_do.py:592-598)."""
    return nv if full_reaction(option_type, knock_top) else nv - 2


def build_a2_bands(grid: Grid, r_d, kappa, eta, sigma, variant: str,
                   option_type: str = "call", barrier=None):
    """V-direction pentadiagonal bands (l2, l1, d, u1, u2), each [m2+1]
    (ref: src/hes_A2_mat.cpp:37-109 central, :410-421 upwind).

    Row 0: one-sided gamma stencil on Delta_v[1], Delta_v[2] (reference
    quirk). Rows 1..m2-2: central beta/delta stencil. Reaction -r_d/2 on
    rows 0..m2-2 for calls, on every row for injection-free payoffs and
    top-knocked barriers (`full_reaction`).
    "upwind" adds backward-upwind convection and a repeated diffusion term
    ONE ROW BELOW each node with v > 1 (row j+1 — a reproduced quirk)."""
    v, dv = grid.vec_v, grid.delv
    m2 = v.shape[-1] - 1
    zero = torch.zeros_like(v)
    l2, l1, d, u1, u2 = (zero.clone() for _ in range(5))

    knock_top = barrier is not None and barrier.knock_top
    d[:n_react(option_type, knock_top, m2 + 1)] += -0.5 * r_d

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


def boundary_data(grid: Grid, r_d, r_f, delta_t: float, nsf,
                  option_type: str = "call", barrier=None, anchor=None):
    """(b1 value [B], b2 row [B, m1+1]) of a book: the injection data
    scaled by each option's own e^{-rate dt (n_i - 1)} (`nsf` [B], the
    options' step counts; rate = `boundary_rate`), or by `anchor` (a rate
    segment's, `rate_segment_structure`) when given. Calls only; every
    injection-free payoff and every top-knocked barrier, whose far s
    boundary is the Dirichlet-0 barrier, gets zeros
    (ref: src/BoundaryConditions.hpp; heston_tpu/pallas/fused_do.py:
    1427-1438)."""
    vec_s = grid.vec_s
    if full_reaction(option_type, barrier is not None and barrier.knock_top):
        return torch.zeros_like(vec_s[:, 0]), torch.zeros_like(vec_s)
    if anchor is None:
        rate = boundary_rate(r_d, r_f, option_type)
        efac = torch.exp(-rate * delta_t * (nsf - 1.0))
    else:
        efac = torch.full_like(vec_s[:, 0], anchor)
    b1val = (r_d - r_f) * vec_s[:, -1] * efac
    b2row = -0.5 * r_d * vec_s * efac[:, None]
    b2row[:, 0] = 0.0
    return b1val, b2row


def boundary_vectors(grid: Grid, r_d, r_f, delta_t: float, nsf,
                     option_type: str = "call", barrier=None, anchor=None):
    """The boundary vectors (b1, b2) of a book, each [B, m1+1, m2+1]
    (ref: src/BoundaryConditions.hpp:70-80): b1 at the reference's
    flat-index placement (`b1_mask`), b2 on the top v-row at s-nodes
    1..m1, each option at its own step count `nsf` [B]. A down-out
    barrier's column 0 takes no b1 (the placement reaches it when
    m2 >= m1; heston_tpu/ops/operators.py:425-431). `anchor`: a rate
    segment's time-scaling anchor (`boundary_data`). The eager engine
    scales the two through time separately."""
    b1val, b2row = boundary_data(grid, r_d, r_f, delta_t, nsf, option_type,
                                 barrier, anchor)
    b, ns = b2row.shape
    nv = grid.vec_v.shape[-1]
    mask = b1_mask(ns, nv, b2row.dtype, b2row.device)
    if barrier is not None and barrier.knock_bottom:
        mask[0] = 0.0
    b1 = mask * b1val[:, None, None]
    b2 = torch.cat([torch.zeros(b, ns, nv - 1, dtype=b2row.dtype,
                                device=b2row.device), b2row[:, :, None]], 2)
    return b1, b2


def build_boundary_vectors(grid: Grid, r_d, r_f, delta_t: float, nsf,
                           option_type: str = "call", barrier=None,
                           anchor=None) -> torch.Tensor:
    """The boundary vector b = b1 + b2 of a book, [B, m1+1, m2+1]
    (`boundary_vectors`)."""
    b1, b2 = boundary_vectors(grid, r_d, r_f, delta_t, nsf, option_type,
                              barrier, anchor)
    return b1 + b2


class HestonOperators(NamedTuple):
    """The operator set of a book (`build_operators`). The kernel reads
    the beta weights and the A2 bands; the theta epilogue of book risk
    also reads a0_c, the A1 bands and b (None unless asked for)."""

    a0_c: Optional[torch.Tensor]   # [B, m1+1, m2+1] rho*sigma*s*v, interior
    bs_wm: torch.Tensor            # [B, m1+1] beta_s weights (0 on the
    bs_w0: torch.Tensor            # boundary)
    bs_wp: torch.Tensor
    bv_wm: torch.Tensor            # [m2+1] beta_v weights (0 on the
    bv_w0: torch.Tensor            # boundary)
    bv_wp: torch.Tensor
    a1_ml: Optional[torch.Tensor]  # [B, m1+1, m2+1] explicit A1 bands
    a1_md: Optional[torch.Tensor]
    a1_mu: Optional[torch.Tensor]
    a2_l2: torch.Tensor            # [m2+1] explicit A2 bands
    a2_l1: torch.Tensor
    a2_d: torch.Tensor
    a2_u1: torch.Tensor
    a2_u2: torch.Tensor
    b: Optional[torch.Tensor]      # [B, m1+1, m2+1] b1 + b2


def build_operators(grid: Grid, kappa, eta, sigma, rho, r_d, r_f,
                    delta_t: float, nsf, a2_variant: str = "upwind",
                    option_type: str = "call",
                    epilogue: bool = True, barrier=None,
                    anchor=None) -> HestonOperators:
    """The operator set of a book: the counterpart of
    `heston_tpu.ops.operators.build_operators` vmapped over the strikes,
    without the implicit bands. `nsf` [B]: each option's step count (the
    scaling of b). epilogue=False leaves out the dense [B, m1+1, m2+1]
    fields that only the theta epilogue reads (a0_c, the A1 bands, b):
    the pricing path builds none of them (the A1 bands reach the kernel
    in rank-2 form, see kernels.assembly.prepare_batched). `barrier`:
    the spec's knock-out barrier, which sets the A2 reaction rows and the
    boundary vector; `anchor`: a rate segment's boundary anchor
    (`boundary_data`)."""
    m1 = grid.vec_s.shape[-1] - 1
    m2 = grid.vec_v.shape[-1] - 1
    bs = coeff.w_beta(grid.dels[:, : m1 - 1], grid.dels[:, 1:m1])
    bv = coeff.w_beta(grid.delv[: m2 - 1], grid.delv[1:m2])
    pad = torch.nn.functional.pad
    bs = [pad(x, (1, 1)) for x in bs]
    bv = [pad(x, (1, 1)) for x in bv]
    a2 = build_a2_bands(grid, r_d, kappa, eta, sigma, a2_variant,
                        option_type, barrier)
    a0_c = b = None
    a1 = (None, None, None)
    if epilogue:
        s, v = grid.vec_s, grid.vec_v
        interior = torch.zeros(m1 + 1, m2 + 1, dtype=s.dtype,
                               device=s.device)
        interior[1:m1, 1:m2] = 1.0
        a0_c = rho * sigma * interior * v[None, None, :] * s[:, :, None]
        a1 = build_a1_bands(grid, r_d, r_f, option_type)
        b = build_boundary_vectors(grid, r_d, r_f, delta_t, nsf,
                                   option_type, barrier, anchor)
    return HestonOperators(a0_c, *bs, *bv, *a1, *a2, b)


# ---------------------------------------------------------------------------
# explicit multiplies on surfaces u [B, m1+1, m2+1]
# ---------------------------------------------------------------------------

def a0_multiply(ops: HestonOperators, u: torch.Tensor) -> torch.Tensor:
    """A0 U = c .* Dv(Ds(U)), the reference's 9-point mixed stencil
    (ref: src/hes_mat_fac.hpp:90-120)."""
    ds = (ops.bs_wm[:, :, None] * shift(u, -1, -2)
          + ops.bs_w0[:, :, None] * u
          + ops.bs_wp[:, :, None] * shift(u, 1, -2))
    dv = (ops.bv_wm * shift(ds, -1, -1) + ops.bv_w0 * ds
          + ops.bv_wp * shift(ds, 1, -1))
    return ops.a0_c * dv


def a1_multiply(ops: HestonOperators, u: torch.Tensor) -> torch.Tensor:
    """Tridiagonal multiply along s (ref: src/hes_a1_kernels.hpp:109-135)."""
    return (ops.a1_ml * shift(u, -1, -2) + ops.a1_md * u
            + ops.a1_mu * shift(u, 1, -2))


def a2_multiply(ops: HestonOperators, u: torch.Tensor) -> torch.Tensor:
    """Pentadiagonal multiply along v
    (ref: src/hes_a2_shuffled_kernels.hpp:178-239)."""
    return (ops.a2_l2 * shift(u, -2, -1) + ops.a2_l1 * shift(u, -1, -1)
            + ops.a2_d * u + ops.a2_u1 * shift(u, 1, -1)
            + ops.a2_u2 * shift(u, 2, -1))

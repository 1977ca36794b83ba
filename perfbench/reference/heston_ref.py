"""The plain reference of the benchmark: the Heston ADI discretization that
heston_tpu_torch solves, written out once more with plain tensor ops.

It follows the port's eager ADI loop (grids, operators, Douglas step,
Ikonen-Toivanen American update, dividend remap, the v0 stencil of the
Jacobian), cut to what the benchmark's configurations use: vanilla
calls, the Douglas scheme, flat rates, no barrier, no Rannacher
start-up. It imports nothing of the program: the grids, the operator
bands, the boundary vectors and the factorizations are all worked out
here again from the configuration and the request.

The implicit systems (I - theta dt A1) along s and (I - theta dt A2)
along v do not change over the time loop, so each is inverted once as a
dense matrix per grid line, and every step applies the inverses. The
inverses and every other operation run in the tensors' dtype: float64
for the reference, a lower precision for the control.

The discretization's quirks are the program's, and kept: the strike- and
spot-concentrated sinh s-grid with S0 inserted and the largest node
dropped; the v0-inserted sinh v-grid; the b1 boundary vector at the flat
indices m1*(j+1) of the v-major layout; the one-sided row 0 of A2; the
"upwind" A2 terms one row below each node with v > 1; the dividend remap
that copies column 0 where no node lies above the shifted spot.

Per-option step counts (a mixed-maturity book, T_i = n_i dt) are priced
group by group at the book's dt: each group runs its own n_i steps, its
boundary data scaled by e^{-r_f dt (n_i - 1)}, and its dividends the
events of steps 1..n_i.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

Dividends = Sequence[Tuple[float, float, float]]   # (date, amount, pct)

# the golden dividend schedule (ref: src/solver.cpp:788-790): dates,
# amounts, percentages
GOLDEN_DIVIDENDS = ((0.2, 0.5, 0.02), (0.4, 0.3, 0.02), (0.6, 0.2, 0.02),
                    (0.8, 0.1, 0.02))


class Spec(NamedTuple):
    """A deployment's grid and scheme (a configuration file's `grid` and
    `scheme`)."""

    m1: int
    m2: int
    s_max_mult: float
    c_mult: float
    v_max: float
    d_div: float
    theta: float
    a2_variant: str

    @classmethod
    def from_config(cls, cfg: dict) -> "Spec":
        g, s = cfg["grid"], cfg["scheme"]
        if s["name"] != "douglas":
            raise ValueError(f"the reference runs the Douglas scheme only, "
                             f"not {s['name']!r}")
        return cls(g["m1"], g["m2"], g["s_max_mult"], g["c_mult"],
                   g["v_max"], g["d_div"], s["theta"], s["a2_variant"])


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------

def insert_and_crop(nodes: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Insert `value` (broadcast against nodes[..., 0]) into the ascending
    nodes of the last axis and drop the largest node; a value within
    1e-12 relative of a node leaves the nodes as they are."""
    value = value.unsqueeze(-1)
    n = nodes.shape[-1]
    idx = (nodes <= value).sum(-1, keepdim=True)
    i = torch.arange(n, device=nodes.device)
    shifted = torch.cat([nodes[..., :1], nodes[..., :-1]], dim=-1)
    inserted = torch.where(i < idx, nodes,
                           torch.where(i == idx, value, shifted))
    dup = ((nodes - value).abs()
           <= 1e-12 * torch.clamp(value.abs(), min=1.0)).any(-1, keepdim=True)
    return torch.where(dup, nodes, inserted)


def s_nodes(spec: Spec, strikes: torch.Tensor, s0: float) -> torch.Tensor:
    """[B, m1+1]: sinh nodes on [0, s_max_mult K] around each strike K
    (c = c_mult K), S0 inserted."""
    k = strikes[:, None]
    c = spec.c_mult * k
    lo = torch.asinh(-k / c)
    hi = torch.asinh((spec.s_max_mult * k - k) / c)
    dxi = (hi - lo) / spec.m1
    i = torch.arange(spec.m1 + 1, dtype=strikes.dtype, device=strikes.device)
    nodes = k + c * torch.sinh(lo + i * dxi)
    return insert_and_crop(nodes, torch.full_like(strikes, s0))


def v_nodes(spec: Spec, v0, dtype, device) -> torch.Tensor:
    """[m2+1]: sinh nodes on [0, v_max] (d = v_max / d_div), v0 inserted."""
    d = spec.v_max / spec.d_div
    deta = torch.asinh(torch.tensor(spec.v_max, dtype=dtype, device=device)
                       / d) / spec.m2
    j = torch.arange(spec.m2 + 1, dtype=dtype, device=device)
    nodes = d * torch.sinh(j * deta)
    return insert_and_crop(nodes, torch.as_tensor(v0, dtype=dtype,
                                                  device=device))


def find_node(nodes: torch.Tensor, value) -> torch.Tensor:
    """Index of the node equal to `value` (within 1e-10); 0 if none."""
    hit = ((nodes - value).abs() < 1e-10).to(torch.int8)
    return torch.argmax(hit, dim=-1)


# ---------------------------------------------------------------------------
# stencil weights on non-uniform grids
# ---------------------------------------------------------------------------

def w_delta(h0, h1):
    """Central second derivative at (-1, 0, +1)."""
    s = h0 + h1
    return 2.0 / (h0 * s), -2.0 / (h0 * h1), 2.0 / (h1 * s)


def w_beta(h0, h1):
    """Central first derivative at (-1, 0, +1)."""
    s = h0 + h1
    return -h1 / (h0 * s), (h1 - h0) / (h0 * h1), h0 / (h1 * s)


def w_alpha(hm, h0):
    """Backward first derivative at (-2, -1, 0)."""
    s = hm + h0
    return h0 / (hm * s), (-hm - h0) / (hm * h0), (hm + 2.0 * h0) / (h0 * s)


def w_gamma(h1, h2):
    """Forward one-sided first derivative at (0, +1, +2)."""
    s = h1 + h2
    return (-2.0 * h1 - h2) / (h1 * s), s / (h1 * h2), -h1 / (h2 * s)


def pad1(x: torch.Tensor) -> torch.Tensor:
    """Zero on both ends of the last axis."""
    return torch.nn.functional.pad(x, (1, 1))


def shift(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """result[.., i, ..] = x[.., i + k, ..] along `dim`, zero outside."""
    n = x.shape[dim]
    pad = torch.zeros_like(x.narrow(dim, 0, abs(k)))
    if k > 0:
        return torch.cat([x.narrow(dim, k, n - k), pad], dim=dim)
    return torch.cat([pad, x.narrow(dim, 0, n + k)], dim=dim)


# ---------------------------------------------------------------------------
# operators
# ---------------------------------------------------------------------------

class Book(NamedTuple):
    """Everything the time loop of a book of calls needs."""

    vec_s: torch.Tensor     # [B, ns]
    vec_v: torch.Tensor     # [nv]
    a0_c: torch.Tensor      # [B, ns, nv]
    bs: tuple               # 3 x [B, ns] beta weights along s
    bv: tuple               # 3 x [nv] beta weights along v
    a1: tuple               # 3 x [B, ns, nv] A1 bands (l, d, u)
    a2: tuple               # 5 x [nv] A2 bands (l2, l1, d, u1, u2)
    b1: torch.Tensor        # [B, ns, nv]
    b2: torch.Tensor
    inv_s: torch.Tensor     # [B, nv, ns, ns] (I - theta dt A1)^-1
    inv_v: torch.Tensor     # [nv, nv] (I - theta dt A2)^-1
    u0: torch.Tensor        # [B, ns, nv] payoff
    idx_s: torch.Tensor     # [B]
    idx_v: torch.Tensor     # []


def a2_bands(vec_v, r_d, kappa, eta, sigma, variant: str):
    """(l2, l1, d, u1, u2), each [nv], of a call book: row 0 the one-sided
    gamma stencil on Delta_v[1], Delta_v[2]; rows 1..m2-2 the central
    stencils; the -r_d/2 reaction on rows 0..m2-2; "upwind" adds the
    backward convection and a repeated diffusion term one row below each
    node with v > 1 (rows 2..m2-1)."""
    v = vec_v
    dv = torch.diff(v)
    m2 = v.shape[0] - 1
    z = torch.zeros_like(v)
    react = torch.cat([torch.full_like(v[:m2 - 1], -0.5 * r_d),
                       z[:2]])
    temp0 = kappa * (eta - v[0])
    g0, g1, g2 = w_gamma(dv[1], dv[2])
    h0, h1 = dv[:m2 - 2], dv[1:m2 - 1]
    dm, d0, dp = w_delta(h0, h1)
    bm, b0, bp = w_beta(h0, h1)
    vj = v[1:m2 - 1]
    temp = kappa * (eta - vj)
    temp2 = 0.5 * sigma * sigma * vj

    def rows(first, interior):
        """[nv]: row 0, rows 1..m2-2, zeros at m2-1 and m2."""
        return torch.cat([first.reshape(1), interior, z[:2]])

    zero0 = z[:1]
    l2 = torch.zeros_like(v)
    l1 = rows(zero0, temp * bm + temp2 * dm)
    d = rows(temp0 * g0, temp * b0 + temp2 * d0) + react
    u1 = rows(temp0 * g1, temp * bp + temp2 * dp)
    u2 = rows(temp0 * g2, torch.zeros_like(vj))
    if variant == "upwind":
        am, a1_, a0_ = w_alpha(h0, h1)
        mask = (vj > 1.0).to(v.dtype)

        def below(x):           # rows 2..m2-1
            return torch.cat([z[:2], x, z[:1]])

        l2 = l2 + below(mask * temp * am)
        l1 = l1 + below(mask * (temp * a1_ + temp2 * dm))
        d = d + below(mask * (temp * a0_ + temp2 * d0))
        u1 = u1 + below(mask * temp2 * dp)
    elif variant != "central":
        raise ValueError(f"unknown A2 variant: {variant!r}")
    return l2, l1, d, u1, u2


def a1_bands(vec_s, vec_v, r_d, r_f):
    """(l, d, u), each [B, ns, nv]: 0.5 s^2 v delta + (r_d - r_f) s beta
    - r_d/2 on the interior rows, -r_d/2 alone on the top row, zero on
    row 0 (calls)."""
    m1 = vec_s.shape[1] - 1
    dels = torch.diff(vec_s)
    h0, h1 = dels[:, :m1 - 1], dels[:, 1:m1]
    dm, d0, dp = w_delta(h0, h1)
    bm, b0, bp = w_beta(h0, h1)
    s = vec_s[:, 1:m1]
    a = 0.5 * vec_v[None, None, :] * (s * s)[:, :, None]
    bb = ((r_d - r_f) * s)[:, :, None]
    zrow = torch.zeros_like(a[:, :1])
    lo = torch.cat([zrow, a * dm[:, :, None] + bb * bm[:, :, None], zrow], 1)
    di = torch.cat([zrow, a * d0[:, :, None] + bb * b0[:, :, None]
                    - 0.5 * r_d, zrow - 0.5 * r_d], 1)
    up = torch.cat([zrow, a * dp[:, :, None] + bb * bp[:, :, None], zrow], 1)
    return lo, di, up


def boundary(vec_s, nv: int, r_d, r_f, dt: float, n_steps: int):
    """(b1, b2), each [B, ns, nv], scaled by e^{-r_f dt (n - 1)}: b1 =
    (r_d - r_f) s_max at the v-major flat indices m1*(j+1) (row, col =
    divmod(m1*(j+1), ns)); b2 = -r_d/2 s on the top v-row, s-nodes
    1..m1."""
    b, ns = vec_s.shape
    efac = math.exp(-r_f * dt * (n_steps - 1.0))
    mask = torch.zeros(ns, nv, dtype=vec_s.dtype, device=vec_s.device)
    for j in range(nv):
        row, col = divmod((ns - 1) * (j + 1), ns)
        if row < nv:
            mask[col, row] = 1.0
    b1 = mask * ((r_d - r_f) * vec_s[:, -1] * efac)[:, None, None]
    top = -0.5 * r_d * vec_s * efac
    top = torch.cat([torch.zeros_like(top[:, :1]), top[:, 1:]], 1)
    b2 = torch.cat([torch.zeros(b, ns, nv - 1, dtype=vec_s.dtype,
                                device=vec_s.device), top[:, :, None]], 2)
    return b1, b2


def banded_matrix(bands: Sequence[torch.Tensor], offsets: Sequence[int]):
    """Dense [..., n, n] from row-aligned bands (..., n): A[r, r + k] =
    band_k[r]."""
    n = bands[0].shape[-1]
    out = torch.zeros(*bands[0].shape, n, dtype=bands[0].dtype,
                      device=bands[0].device)
    for band, k in zip(bands, offsets):
        out = out + torch.diag_embed(band[..., max(0, -k):n - max(0, k)], k)
    return out


def inverse(m: torch.Tensor) -> torch.Tensor:
    """The inverse of m in m's dtype; below float32 (which linalg.inv
    does not take) inverted in float32 and rounded."""
    if m.dtype in (torch.float64, torch.float32):
        return torch.linalg.inv(m)
    return torch.linalg.inv(m.float()).to(m.dtype)


def prepare(spec: Spec, strikes: torch.Tensor, s0: float, kappa, eta, sigma,
            rho, v0, r_d: float, r_f: float, dt: float,
            n_steps: int) -> Book:
    """The grids, operators, boundary vectors and inverted implicit
    systems of a book of calls at `strikes` [B] that runs `n_steps` steps
    of `dt`; the model parameters may be 0-d tensors (forward-mode AD)."""
    dtype, dev = strikes.dtype, strikes.device
    vec_s = s_nodes(spec, strikes, s0)
    vec_v = v_nodes(spec, v0, dtype, dev)
    m1, m2 = spec.m1, spec.m2
    dels, delv = torch.diff(vec_s), torch.diff(vec_v)
    bs = tuple(pad1(w) for w in w_beta(dels[:, :m1 - 1], dels[:, 1:m1]))
    bv = tuple(pad1(w) for w in w_beta(delv[:m2 - 1], delv[1:m2]))
    interior = torch.zeros(m1 + 1, m2 + 1, dtype=dtype, device=dev)
    interior[1:m1, 1:m2] = 1.0
    a0_c = rho * sigma * interior * vec_v[None, None, :] * vec_s[:, :, None]
    a1 = a1_bands(vec_s, vec_v, r_d, r_f)
    a2 = a2_bands(vec_v, r_d, kappa, eta, sigma, spec.a2_variant)
    b1, b2 = boundary(vec_s, m2 + 1, r_d, r_f, dt, n_steps)
    td = spec.theta * dt
    eye_s = torch.eye(m1 + 1, dtype=dtype, device=dev)
    eye_v = torch.eye(m2 + 1, dtype=dtype, device=dev)
    lo, di, up = (x.transpose(1, 2) for x in a1)            # [B, nv, ns]
    inv_s = inverse(eye_s - td * banded_matrix((lo, di, up), (-1, 0, 1)))
    inv_v = inverse(eye_v - td * banded_matrix(a2, (-2, -1, 0, 1, 2)))
    payoff = torch.clamp(vec_s - strikes[:, None], min=0.0)
    u0 = payoff[:, :, None].expand(-1, -1, m2 + 1)
    return Book(vec_s, vec_v, a0_c, bs, bv, a1, a2, b1, b2, inv_s, inv_v, u0,
                find_node(vec_s, s0), find_node(vec_v, v0))


def a0_mul(bk: Book, u):
    ds = (bk.bs[0][:, :, None] * shift(u, -1, 1) + bk.bs[1][:, :, None] * u
          + bk.bs[2][:, :, None] * shift(u, 1, 1))
    dv = bk.bv[0] * shift(ds, -1, 2) + bk.bv[1] * ds + bk.bv[2] * shift(ds, 1,
                                                                       2)
    return bk.a0_c * dv


def a1_mul(bk: Book, u):
    return bk.a1[0] * shift(u, -1, 1) + bk.a1[1] * u + bk.a1[2] * shift(u, 1,
                                                                       1)


def a2_mul(bk: Book, u):
    l2, l1, d, u1, u2 = bk.a2
    return (l2 * shift(u, -2, 2) + l1 * shift(u, -1, 2) + d * u
            + u1 * shift(u, 1, 2) + u2 * shift(u, 2, 2))


def dividend_events(dividends: Optional[Dividends], n: int, dt: float):
    """(amount, pct) of the dividends applied before step n (1-based):
    n dt <= date < (n + 1) dt, in date order."""
    return [(amount, pct) for date, amount, pct in (dividends or ())
            if n * dt <= date < (n + 1) * dt]


def remap(u, vec_s, amount: float, pct: float):
    """The surface after one dividend: each node's new_s = s (1 - pct) -
    amount, u interpolated linearly there along s; index 0 (no node above
    new_s, or new_s below every node) copies column 0; a call is 0 where
    new_s <= 0."""
    m1 = vec_s.shape[-1] - 1
    new_s = vec_s * (1.0 - pct) - amount
    idx = (vec_s[:, :, None] <= new_s[:, None, :]).sum(1)
    idx = torch.where(idx > m1, 0, idx)
    lo = torch.clamp(idx - 1, min=0)
    s_lo, s_hi = torch.gather(vec_s, 1, lo), torch.gather(vec_s, 1, idx)
    w = ((new_s - s_lo) / torch.where(s_hi == s_lo, torch.ones_like(s_hi),
                                      s_hi - s_lo))[:, :, None]
    nv = u.shape[-1]
    u_lo = torch.gather(u, 1, lo[:, :, None].expand(-1, -1, nv))
    u_hi = torch.gather(u, 1, idx[:, :, None].expand(-1, -1, nv))
    out = torch.where((idx == 0)[:, :, None], u[:, 0:1, :].expand_as(u),
                      (1.0 - w) * u_lo + w * u_hi)
    return torch.where((new_s > 0.0)[:, :, None], out, torch.zeros_like(out))


def step(bk: Book, u, lam, n: int, dt: float, theta: float, r_f: float,
         american: bool):
    """One Douglas step n (1-based): explicit predictor, the implicit
    corrections along s then v; American: the Ikonen-Toivanen update of
    u and the multiplier (lambda(s_max) = 0)."""
    e_nm1, e_n = math.exp(r_f * dt * (n - 1.0)), math.exp(r_f * dt * n)
    a1r, a2r = a1_mul(bk, u), a2_mul(bk, u)
    y0 = u + dt * (a0_mul(bk, u) + a1r + a2r + (bk.b1 + bk.b2) * e_nm1)
    if american:
        y0 = y0 + dt * lam
    rhs1 = y0 + theta * dt * (bk.b1 * e_n - (a1r + bk.b1 * e_nm1))
    y1 = (bk.inv_s @ rhs1.transpose(1, 2)[..., None])[..., 0].transpose(1, 2)
    rhs2 = y1 + theta * dt * (bk.b2 * e_n - (a2r + bk.b2 * e_nm1))
    y2 = (bk.inv_v @ rhs2[..., None])[..., 0]
    if not american:
        return y2, lam
    u_new = torch.maximum(y2 - dt * lam, bk.u0)
    lam_new = torch.clamp(lam + (bk.u0 - y2) / dt, min=0.0)
    lam_new = torch.cat([lam_new[:, :-1], torch.zeros_like(lam_new[:, -1:])],
                        1)
    return u_new, lam_new


def solve(spec: Spec, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
          dt: float, n_steps: int, american: bool = False,
          dividends: Optional[Dividends] = None):
    """(u, lam, book): the terminal surfaces [B, ns, nv] and multipliers of
    a book of calls after `n_steps` steps of `dt`."""
    bk = prepare(spec, strikes, s0, kappa, eta, sigma, rho, v0, r_d, r_f, dt,
                 n_steps)
    u, lam = bk.u0, torch.zeros_like(bk.u0)
    for n in range(1, n_steps + 1):
        for amount, pct in dividend_events(dividends, n, dt):
            u = remap(u, bk.vec_s, amount, pct)
        u, lam = step(bk, u, lam, n, dt, spec.theta, r_f, american)
    return u, lam, bk


def at_node(u, bk: Book):
    """u [B, ns, nv] at each option's (S0, v0) node."""
    return u[torch.arange(u.shape[0], device=u.device), bk.idx_s, bk.idx_v]


def prices(spec: Spec, strikes, s0, params, r_d, r_f, dt, n_steps,
           american=False, dividends=None):
    """Prices [B] of a book of calls; params = (kappa, eta, sigma, rho,
    v0)."""
    u, _, bk = solve(spec, strikes, s0, *params, r_d, r_f, dt, n_steps,
                     american, dividends)
    return at_node(u, bk)


def v0_column(spec: Spec, u, bk: Book, v0):
    """dPrice/dv0 [B]: the 3-point v-stencil of the surface at the v0
    node, centred on the clipped interior node and evaluated at v0 (v0
    moves the discrete price only through the grid)."""
    rows = torch.arange(u.shape[0], device=u.device)
    j = torch.clamp(bk.idx_v, 1, spec.m2 - 1)
    vv = bk.vec_v
    h0, h1 = vv[j] - vv[j - 1], vv[j + 1] - vv[j]
    bm, b0, bp = w_beta(h0, h1)
    dm, d0, dp = w_delta(h0, h1)
    col = [u[rows, bk.idx_s, jj] for jj in (j - 1, j, j + 1)]
    first = bm * col[0] + b0 * col[1] + bp * col[2]
    second = dm * col[0] + d0 * col[1] + dp * col[2]
    return first + second * (v0 - vv[j])


def jacobian(spec: Spec, strikes, s0, params, r_d, r_f, dt, n_steps,
             american=False, dividends=None):
    """(prices [B], J [B, 5]) in (kappa, eta, sigma, rho, v0): the first
    four columns by forward-mode AD through the time loop, the v0 column
    the surface stencil (`v0_column`)."""
    dtype, dev = strikes.dtype, strikes.device
    tv = torch.tensor([float(p) for p in params[:4]], dtype=dtype,
                      device=dev)
    v0 = float(params[4])

    def fn(x):
        u, _, bk = solve(spec, strikes, s0, x[0], x[1], x[2], x[3], v0, r_d,
                         r_f, dt, n_steps, american, dividends)
        return u

    bk = prepare(spec, strikes, s0, *params[:4], v0, r_d, r_f, dt, n_steps)
    cols = []
    for direction in torch.eye(4, dtype=dtype, device=dev):
        u, du = torch.func.jvp(fn, (tv,), (direction,))
        cols.append(at_node(du, bk))
    cols.append(v0_column(spec, u, bk, v0))
    return at_node(u, bk), torch.stack(cols, dim=1)

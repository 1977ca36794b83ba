"""Sinh-stretched non-uniform grids with spot/variance-node insertion.

PyTorch counterpart of `heston_tpu.ops.grid` (ref: src/grid.cpp:16-96),
batched over a strike vector: every function takes the strikes as a
tensor and builds one s-grid per strike along a leading batch dimension.
The v-grid depends on v0 only, so it is built once and shared by the book.
A knock-out barrier (`GridSpec.barrier`) truncates the s domain at its
level(s), which become pinned nodes (`make_barrier_s_nodes`);
`validate_book` rejects the books such a grid cannot hold. The eager
engine's extras: `make_uniform_grid` (the reference's validation grid),
`rebuild_variance` (a new v0) and `interp_at` (bilinear extraction).

  S-grid:  xi_i = asinh(-K/c) + i * dxi,  s_i = K + c*sinh(xi_i), then S_0
           is inserted and the LARGEST node dropped (ref: src/grid.cpp:34-37).
  V-grid:  v_j = d*sinh(j * asinh(V/d)/m2), then V_0 inserted the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from heston_tpu_torch.config import GridSpec


class Grid(NamedTuple):
    """Grid node vectors and spacings of a book.

    vec_s: [B, m1+1] stock nodes per option, ascending.
    vec_v: [m2+1] variance nodes shared by the book, ascending.
    dels:  [B, m1] forward differences of vec_s.
    delv:  [m2] forward differences of vec_v.
    """

    vec_s: torch.Tensor
    vec_v: torch.Tensor
    dels: torch.Tensor
    delv: torch.Tensor


def _insert_and_crop(nodes: torch.Tensor, value) -> torch.Tensor:
    """Insert `value` into the ascending `nodes` (last axis) and drop the
    largest node: the reference's push_back / sort / pop_back.

    `value` broadcasts against `nodes[..., 0]`. The insertion point is
    count(nodes <= value), where a stable sort would put it; a value above
    every node is itself dropped (the S_max-discarding quirk). A value
    within 1e-12 relative of an existing node leaves the nodes unchanged
    instead of creating a (near-)zero spacing."""
    value = torch.as_tensor(value, dtype=nodes.dtype, device=nodes.device)
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


def _sinh_s_nodes(m1: int, s_lo, s_max, strike, c):
    """Raw sinh-spaced nodes on [s_lo, s_max] concentrated at `strike`
    (no insertion). `strike`, `s_max`, `c`: [B] tensors; returns [B, m1+1]."""
    strike, s_max, c = strike[:, None], s_max[:, None], c[:, None]
    lo = torch.asinh((s_lo - strike) / c)
    hi = torch.asinh((s_max - strike) / c)
    dxi = (hi - lo) / m1
    i = torch.arange(m1 + 1, dtype=strike.dtype, device=strike.device)
    return strike + c * torch.sinh(lo + i * dxi)


def make_s_nodes(m1: int, s_max, s0, strike, c) -> torch.Tensor:
    """Stock-direction sinh nodes with S_0 inserted, one row per strike."""
    nodes = _sinh_s_nodes(m1, 0.0, s_max, strike, c)
    return _insert_and_crop(nodes, s0)


def make_barrier_s_nodes(m1: int, barrier, s_max, s0, strike,
                         c) -> torch.Tensor:
    """Stock-direction sinh nodes of a knock-out domain, S_0 inserted, one
    row per strike (heston_tpu/ops/grid.py:108-135). The alive domain is
    [barrier.lo, barrier.hi(s_max)]; both ends are pinned exactly after
    the sinh round trip (node 0 is 0 or the lower barrier). When the top
    node is a barrier (up-out, double-out), S_0 goes in among the lower
    m1 nodes only, so the barrier node stays where it is. `s_max`,
    `strike`, `c`: [B] tensors."""
    lo = barrier.lo
    hi = torch.as_tensor(barrier.hi(s_max), dtype=strike.dtype,
                         device=strike.device).expand_as(strike)
    nodes = _sinh_s_nodes(m1, lo, hi, strike, c)
    nodes = torch.cat([torch.full_like(nodes[:, :1], lo), nodes[:, 1:]], 1)
    if barrier.knock_top:
        top = torch.full_like(nodes[:, :1], barrier.hi(None))
        return torch.cat([_insert_and_crop(nodes[:, :-1], s0), top], 1)
    return _insert_and_crop(nodes, s0)


def make_v_nodes(m2: int, v_max, v0, d, dtype, device) -> torch.Tensor:
    """Variance-direction sinh nodes with V_0 inserted."""
    deta = torch.asinh(torch.tensor(v_max, dtype=dtype, device=device)
                       / d) / m2
    j = torch.arange(m2 + 1, dtype=dtype, device=device)
    nodes = d * torch.sinh(j * deta)
    return _insert_and_crop(nodes, v0)


def make_grid(spec: GridSpec, s0, strikes: torch.Tensor, v0) -> Grid:
    """The pricing grids of a book: one s-grid per strike [B], one shared
    v-grid. Mirrors Grid::Grid (ref: src/grid.cpp:16-61); a barrier spec
    takes the knock-out domain (`make_barrier_s_nodes`)."""
    if spec.barrier is not None:
        vec_s = make_barrier_s_nodes(spec.m1, spec.barrier,
                                     spec.s_max_mult * strikes, s0, strikes,
                                     spec.c_mult * strikes)
    else:
        vec_s = make_s_nodes(spec.m1, spec.s_max_mult * strikes, s0, strikes,
                             spec.c_mult * strikes)
    vec_v = make_v_nodes(spec.m2, spec.v_max, v0, spec.v_max / spec.d_div,
                         strikes.dtype, strikes.device)
    return Grid(vec_s=vec_s, vec_v=vec_v, dels=torch.diff(vec_s),
                delv=torch.diff(vec_v))


def make_uniform_grid(m1: int, m2: int, s0, v0, s_min, s_max, v_min,
                      v_max, dtype=torch.float64, device=None) -> Grid:
    """Uniformly spaced grid with the sinh grids' S_0/V_0 insert-and-crop
    semantics, so the largest nominal node of each axis is dropped — the
    reference's debug/validation grid (ref: src/grid.cpp:112-164;
    heston_tpu/ops/grid.py:173-188). A book of one: vec_s [1, m1+1]."""
    i = torch.arange(m1 + 1, dtype=dtype, device=device)
    j = torch.arange(m2 + 1, dtype=dtype, device=device)
    ds = (torch.as_tensor(s_max, dtype=dtype, device=device) - s_min) / m1
    dv = (torch.as_tensor(v_max, dtype=dtype, device=device) - v_min) / m2
    vec_s = _insert_and_crop(s_min + i * ds, s0)[None]
    vec_v = _insert_and_crop(v_min + j * dv, v0)
    return Grid(vec_s=vec_s, vec_v=vec_v, dels=torch.diff(vec_s),
                delv=torch.diff(vec_v))


def rebuild_variance(spec: GridSpec, grid: Grid, v0_new) -> Grid:
    """The grid with only its variance direction rebuilt for a new v0
    (ref: src/grid_pod.hpp:25-73; heston_tpu/ops/grid.py:191-200)."""
    vec_v = make_v_nodes(spec.m2, spec.v_max, v0_new,
                         spec.v_max / spec.d_div, grid.vec_v.dtype,
                         grid.vec_v.device)
    return Grid(vec_s=grid.vec_s, vec_v=vec_v, dels=grid.dels,
                delv=torch.diff(vec_v))


def interp_at(grid: Grid, u: torch.Tensor, s, v) -> torch.Tensor:
    """Bilinear interpolation [B] of each option's surface u [B, ns, nv]
    at its (s, v) (scalars or [B]): the reference's interpolated
    extraction for rebuilt grids (ref: src/device_solver.cpp:1725-1758;
    heston_tpu/ops/grid.py:203-219), robust off the nodes."""
    b, ns, nv = u.shape
    s, v = (torch.as_tensor(x, dtype=u.dtype, device=u.device).expand(b)
            .contiguous() for x in (s, v))
    vec_s = grid.vec_s.expand(b, ns).contiguous()
    i = torch.clamp(torch.searchsorted(vec_s, s[:, None], right=True)[:, 0]
                    - 1, 0, ns - 2)
    j = torch.clamp(torch.searchsorted(grid.vec_v, v, right=True) - 1,
                    0, nv - 2)
    rows = torch.arange(b, device=u.device)
    s0n, s1n = vec_s[rows, i], vec_s[rows, i + 1]
    v0n, v1n = grid.vec_v[j], grid.vec_v[j + 1]
    one = torch.ones_like(s)
    ws = (s - s0n) / torch.where(s1n == s0n, one, s1n - s0n)
    wv = (v - v0n) / torch.where(v1n == v0n, one, v1n - v0n)
    return ((1 - wv) * ((1 - ws) * u[rows, i, j] + ws * u[rows, i + 1, j])
            + wv * ((1 - ws) * u[rows, i, j + 1]
                    + ws * u[rows, i + 1, j + 1]))


def validate_book(spec: GridSpec, s0: float, strikes) -> None:
    """Raise ValueError for a book the discretization cannot represent
    (heston_tpu/ops/grid.py:222-273): a spot at or past s_max_mult * K
    (the insertion drops the spot node); with a barrier, a spot at or
    past a knocked boundary (the option is already knocked out), and on
    a top-knocked grid a spot in the last raw cell below the barrier,
    which could not be inserted without moving the barrier. Host-side;
    `strikes` is anything numpy takes (a tensor is copied to the host)."""
    if isinstance(strikes, torch.Tensor):
        strikes = strikes.detach().cpu().numpy()
    ks = np.atleast_1d(np.asarray(strikes, dtype=float))
    bad = ks[s0 >= spec.s_max_mult * ks]
    if bad.size:
        raise ValueError(
            f"spot {s0} falls outside the S-grid (>= {spec.s_max_mult}*K) "
            f"for strikes {bad.tolist()}; these options cannot be priced "
            f"on this grid family")
    b = spec.barrier
    if b is None:
        return
    if b.knock_top and s0 >= b.hi(None):
        raise ValueError(
            f"spot {s0} is at or above the {b.kind} barrier "
            f"{b.hi(None)}; the option is knocked out (price 0)")
    if b.knock_bottom and s0 <= b.level:
        raise ValueError(
            f"spot {s0} is at or below the {b.kind} barrier "
            f"{b.level}; the option is knocked out (price 0)")
    if b.knock_top:
        hi = b.hi(None)
        cs = spec.c_mult * ks
        lo_xi = np.arcsinh((b.lo - ks) / cs)
        hi_xi = np.arcsinh((hi - ks) / cs)
        top_inner = ks + cs * np.sinh(
            lo_xi + (spec.m1 - 1) * (hi_xi - lo_xi) / spec.m1)
        bad = ks[s0 > top_inner]
        if bad.size:
            raise ValueError(
                f"spot {s0} falls between the highest interior "
                f"s-node and the {b.kind} barrier {hi} for strikes "
                f"{bad.tolist()}: the spot node cannot be inserted "
                f"without moving the barrier. Increase m1 (finer "
                f"grid resolves the last cell) or move the barrier.")


def find_node(nodes: torch.Tensor, value, tol: float = 1e-10) -> torch.Tensor:
    """Index (last axis) of the node equal to `value` within `tol`; 0 if
    absent — the reference's equality search with its fall-back to index 0
    (ref: src/grid_pod.hpp:75-87)."""
    hit = ((nodes - value).abs() < tol).to(torch.int8)
    return torch.argmax(hit, dim=-1)

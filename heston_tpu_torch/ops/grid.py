"""Sinh-stretched non-uniform grids with spot/variance-node insertion.

PyTorch counterpart of `heston_tpu.ops.grid` (ref: src/grid.cpp:16-96),
batched over a strike vector: every function takes the strikes as a
tensor and builds one s-grid per strike along a leading batch dimension.
The v-grid depends on v0 only, so it is built once and shared by the book.

  S-grid:  xi_i = asinh(-K/c) + i * dxi,  s_i = K + c*sinh(xi_i), then S_0
           is inserted and the LARGEST node dropped (ref: src/grid.cpp:34-37).
  V-grid:  v_j = d*sinh(j * asinh(V/d)/m2), then V_0 inserted the same way.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from heston_tpu.config import GridSpec


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


def make_v_nodes(m2: int, v_max, v0, d, dtype, device) -> torch.Tensor:
    """Variance-direction sinh nodes with V_0 inserted."""
    deta = torch.asinh(torch.tensor(v_max, dtype=dtype, device=device)
                       / d) / m2
    j = torch.arange(m2 + 1, dtype=dtype, device=device)
    nodes = d * torch.sinh(j * deta)
    return _insert_and_crop(nodes, v0)


def make_grid(spec: GridSpec, s0, strikes: torch.Tensor, v0) -> Grid:
    """The pricing grids of a book: one s-grid per strike [B], one shared
    v-grid. Mirrors Grid::Grid (ref: src/grid.cpp:16-61)."""
    if spec.barrier is not None:
        raise NotImplementedError(
            "barrier grids are not ported yet (ROADMAP A12)")
    vec_s = make_s_nodes(spec.m1, spec.s_max_mult * strikes, s0, strikes,
                         spec.c_mult * strikes)
    vec_v = make_v_nodes(spec.m2, spec.v_max, v0, spec.v_max / spec.d_div,
                         strikes.dtype, strikes.device)
    return Grid(vec_s=vec_s, vec_v=vec_v, dels=torch.diff(vec_s),
                delv=torch.diff(vec_v))


def find_node(nodes: torch.Tensor, value, tol: float = 1e-10) -> torch.Tensor:
    """Index (last axis) of the node equal to `value` within `tol`; 0 if
    absent — the reference's equality search with its fall-back to index 0
    (ref: src/grid_pod.hpp:75-87)."""
    hit = ((nodes - value).abs() < tol).to(torch.int8)
    return torch.argmax(hit, dim=-1)

"""heston_tpu_torch.ops against heston_tpu.ops: stencil weights, grids and
operator bands, float64 at rtol/atol 1e-12."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import GridSpec
from heston_tpu.ops import coeff as jcoeff
from heston_tpu.ops import grid as jgrid
from heston_tpu.ops import operators as jops
from heston_tpu_torch.ops import coeff, grid, operators

from torch_parity import assert_close, t64

SEED = 20261016


@pytest.mark.parametrize("name", ["w_delta", "w_beta", "w_alpha", "w_gamma"])
def test_coeff_weights_match_jax(name):
    rng = np.random.default_rng(SEED)
    h0 = rng.uniform(1e-3, 2.0, 64)
    h1 = rng.uniform(1e-3, 2.0, 64)
    got = getattr(coeff, name)(t64(h0), t64(h1))
    want = getattr(jcoeff, name)(jnp.asarray(h0), jnp.asarray(h1))
    for g, w in zip(got, want):
        assert_close(g, w)


def test_insert_and_crop_matches_jax():
    """Random inserts, plus the edge cases: a value above every node (it
    is itself dropped), below every node, and within 1e-12 of a node (the
    duplicate guard leaves the nodes unchanged)."""
    rng = np.random.default_rng(SEED)
    nodes = np.sort(rng.uniform(0.0, 10.0, (6, 9)), axis=1)
    values = rng.uniform(0.0, 10.0, 6)
    values[1] = 11.0
    values[2] = -1.0
    values[3] = nodes[3, 4] * (1.0 + 1e-13)
    values[4] = nodes[4, 0]
    got = grid._insert_and_crop(t64(nodes), t64(values))
    for r in range(nodes.shape[0]):
        want = jgrid._insert_and_crop(jnp.asarray(nodes[r]), values[r])
        assert_close(got[r], want, rtol=0, atol=0)
    # a scalar value broadcasts over the rows
    got = grid._insert_and_crop(t64(nodes), 5.0)
    for r in range(nodes.shape[0]):
        assert_close(got[r], jgrid._insert_and_crop(jnp.asarray(nodes[r]),
                                                     5.0), rtol=0, atol=0)


@pytest.mark.parametrize("m1,m2", [(10, 8), (50, 25)])
def test_make_grid_and_find_node_match_jax(m1, m2):
    """Per-strike s-grids, the shared v-grid and the node indices. K = 10
    at S0 = 100 has s_max = 8K < S0: the spot is inserted past the top,
    dropped with it (the reference quirk), and find_node falls back to
    index 0."""
    spec = GridSpec(m1=m1, m2=m2)
    rng = np.random.default_rng(SEED)
    strikes = np.concatenate([[10.0, 100.0], rng.uniform(60.0, 140.0, 6)])
    s0, v0 = 100.0, 0.04
    g = grid.make_grid(spec, s0, t64(strikes), v0)
    idx_s = grid.find_node(g.vec_s, s0)
    idx_v = grid.find_node(g.vec_v, v0)
    for b, k in enumerate(strikes):
        jg = jgrid.make_grid(spec, s0, k, v0)
        assert_close(g.vec_s[b], jg.vec_s)
        assert_close(g.dels[b], jg.dels)
        assert int(idx_s[b]) == int(jgrid.find_node(jg.vec_s, s0))
        assert_close(g.vec_v, jg.vec_v)
        assert_close(g.delv, jg.delv)
        assert int(idx_v) == int(jgrid.find_node(jg.vec_v, v0))
    assert int(idx_s[0]) == 0
    assert float(g.vec_s[0].max()) < s0


def test_find_node_fallback_to_zero():
    nodes = t64([0.0, 1.0, 2.0, 3.0])
    assert int(grid.find_node(nodes, 2.0)) == 2
    assert int(grid.find_node(nodes, 2.5)) == 0
    assert int(grid.find_node(nodes, 2.5)) == int(
        jgrid.find_node(jnp.asarray([0.0, 1.0, 2.0, 3.0]), 2.5))


def test_barrier_grid_not_ported():
    from heston_tpu.config import Barrier

    spec = GridSpec(m1=10, m2=8, barrier=Barrier("up-out", 150.0))
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        grid.make_grid(spec, 100.0, t64([100.0]), 0.04)


def _grids(spec, strikes, v0=0.04, s0=100.0):
    g = grid.make_grid(spec, s0, t64(strikes), v0)
    jgs = [jgrid.make_grid(spec, s0, k, v0) for k in strikes]
    return g, jgs


@pytest.mark.parametrize("option_type", ["call", "put"])
def test_build_a1_bands_match_jax(params, option_type):
    p = params
    spec = GridSpec(m1=12, m2=9)
    strikes = np.array([80.0, 100.0, 125.0])
    g, jgs = _grids(spec, strikes)
    got = operators.build_a1_bands(g, p.r_d, 0.01, option_type)
    for b, jg in enumerate(jgs):
        want = jops.build_a1_bands(jg, p.r_d, 0.01, option_type)
        for x, y in zip(got, want):
            assert_close(x[b], y)


@pytest.mark.parametrize("variant", ["central", "upwind"])
@pytest.mark.parametrize("option_type", ["call", "put"])
def test_build_a2_bands_match_jax(params, variant, option_type):
    """Upwind rows land one row below each node with v > 1 (the default
    v_max = 5 grid has several), and the reaction covers rows 0..m2-2
    for calls, every row for puts."""
    p = params
    spec = GridSpec(m1=12, m2=9)
    g, jgs = _grids(spec, np.array([100.0]))
    assert float(g.vec_v.max()) > 1.0
    got = operators.build_a2_bands(g, p.r_d, p.kappa, p.eta, p.sigma,
                                   variant, option_type)
    want = jops.build_a2_bands(jgs[0], p.r_d, p.kappa, p.eta, p.sigma,
                               variant, option_type)
    for x, y in zip(got, want):
        assert_close(x, y)


def test_build_operators_matches_jax(params):
    p = params
    spec = GridSpec(m1=12, m2=9)
    strikes = np.array([90.0, 110.0])
    g, jgs = _grids(spec, strikes)
    ops = operators.build_operators(g, p.kappa, p.eta, p.sigma, p.r_d,
                                    "upwind")
    for b, jg in enumerate(jgs):
        jo = jops.build_operators(jg, p.kappa, p.eta, p.sigma, p.rho, p.r_d,
                                  p.r_f, 0.8, 0.05, 20, "upwind")
        for name in ("bs_wm", "bs_w0", "bs_wp"):
            assert_close(getattr(ops, name)[b], getattr(jo, name))
        for name in ("bv_wm", "bv_w0", "bv_wp", "a2_l2", "a2_l1", "a2_d",
                     "a2_u1", "a2_u2"):
            assert_close(getattr(ops, name), getattr(jo, name))


@pytest.mark.parametrize("option_type", list(operators.OPTION_TYPES))
def test_grid_payoff_and_predicates_match_jax(option_type):
    spec = GridSpec(m1=12, m2=9)
    strikes = np.array([80.0, 100.0, 120.0])
    g, jgs = _grids(spec, strikes)
    got = operators.grid_payoff(g.vec_s, t64(strikes)[:, None], option_type)
    for b, jg in enumerate(jgs):
        assert_close(got[b], jops.grid_payoff(jg.vec_s, strikes[b],
                                              option_type))
    assert operators.is_put(option_type) == jops.is_put(option_type)
    assert operators.is_digital(option_type) == jops.is_digital(option_type)
    assert (operators.is_injection_free(option_type)
            == jops.is_injection_free(option_type))
    assert (operators.boundary_rate(0.025, 0.01, option_type)
            == jops.boundary_rate(0.025, 0.01, option_type))


def test_unknown_option_type_raises():
    with pytest.raises(ValueError, match="unknown option_type"):
        operators.is_put("straddle")


def test_a1_rank2_form_reconstructs_bands(params):
    """The kernel's rank-2 A1 fields v_j*P[i] + Q[i] equal the dense bands
    of build_a1_bands."""
    from heston_tpu.config import SolverConfig
    from heston_tpu_torch.kernels import fused_do

    p = params
    spec = GridSpec(m1=12, m2=9)
    strikes = t64([85.0, 100.0, 115.0])
    out = fused_do._prepare_batched(
        spec, SolverConfig(), strikes, 100.0, p.kappa, p.eta, p.sigma,
        p.rho, p.v0, p.r_d, 0.01)
    a1pq, g = out[1], out[6]
    bands = operators.build_a1_bands(g, p.r_d, 0.01)
    v = g.vec_v[None, :, None]
    for k, band in enumerate(bands):
        rebuilt = v * a1pq[2 * k][:, None, :] + a1pq[2 * k + 1][:, None, :]
        torch.testing.assert_close(rebuilt, band, rtol=1e-12, atol=1e-12)

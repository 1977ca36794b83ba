"""heston_tpu_torch.ops against heston_tpu.ops: stencil weights, grids,
operator bands, the operator set with its boundary vector and the three
explicit multiplies, float64 at rtol/atol 1e-12. The port's surfaces are
s-major [B, m1+1, m2+1]; the JAX package's are [m2+1, m1+1] per option."""

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

from torch_parity import assert_close, port_cfg, t64

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
    g = grid.make_grid(port_cfg(spec), s0, t64(strikes), v0)
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
    """Barrier specs (whose grids once raised NotImplementedError) build
    the JAX package's knock-out grids: each kind's s-grid per strike,
    the barrier levels pinned exactly at the knocked ends, at 1e-12."""
    from heston_tpu.config import Barrier

    strikes = np.array([85.0, 100.0, 118.0])
    for barrier in (Barrier("up-out", 150.0), Barrier("down-out", 80.0),
                    Barrier("double-out", 80.0, level_hi=150.0)):
        spec = GridSpec(m1=10, m2=8, barrier=barrier)
        g, jgs = _grids(spec, strikes)
        for b, jg in enumerate(jgs):
            assert_close(g.vec_s[b], jg.vec_s)
            assert_close(g.dels[b], jg.dels)
        if barrier.knock_top:
            assert bool((g.vec_s[:, -1] == 150.0).all())
        if barrier.knock_bottom:
            assert bool((g.vec_s[:, 0] == 80.0).all())


def _grids(spec, strikes, v0=0.04, s0=100.0):
    g = grid.make_grid(port_cfg(spec), s0, t64(strikes), v0)
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
            assert_close(x[b], np.asarray(y).T)


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


SURFACE_OPS = ("a0_c", "a1_ml", "a1_md", "a1_mu", "b")
ROW_OPS = ("bs_wm", "bs_w0", "bs_wp")
SHARED_OPS = ("bv_wm", "bv_w0", "bv_wp", "a2_l2", "a2_l1", "a2_d", "a2_u1",
              "a2_u2")


def _operator_sets(p, spec, strikes, nsteps, r_f=0.01):
    """The port's operator set of a book at per-option step counts, and
    the JAX package's per option (delta_t 0.05)."""
    g, jgs = _grids(spec, strikes)
    ops = operators.build_operators(g, p.kappa, p.eta, p.sigma, p.rho,
                                    p.r_d, r_f, 0.05, t64(nsteps), "upwind")
    jos = [jops.build_operators(jg, p.kappa, p.eta, p.sigma, p.rho, p.r_d,
                                r_f, 0.8, 0.05, float(n), "upwind")
           for jg, n in zip(jgs, nsteps)]
    return ops, jos


def test_build_operators_matches_jax(params):
    """Every field of the operator set (the implicit bands are not built),
    each option at its own step count: b = b1 + b2 carries each option's
    e^{-r_f dt (n_i - 1)} and the flat-index b1 placement. With
    epilogue=False the dense fields are left out."""
    spec = GridSpec(m1=12, m2=9)
    nsteps = [20, 7, 1]
    ops, jos = _operator_sets(params, spec, np.array([90.0, 110.0, 100.0]),
                              nsteps)
    assert set(ops._fields) == {*SURFACE_OPS, *ROW_OPS, *SHARED_OPS}
    for b, jo in enumerate(jos):
        for name in SURFACE_OPS:
            assert_close(getattr(ops, name)[b],
                         np.asarray(getattr(jo, name)).T, err_msg=name)
        for name in ROW_OPS:
            assert_close(getattr(ops, name)[b], getattr(jo, name))
        for name in SHARED_OPS:
            assert_close(getattr(ops, name), getattr(jo, name))
    assert float(ops.b.abs().max()) > 0.0
    g, _ = _grids(spec, np.array([90.0]))
    lean = operators.build_operators(g, params.kappa, params.eta,
                                     params.sigma, params.rho, params.r_d,
                                     0.01, 0.05, t64([20]), epilogue=False)
    assert all(getattr(lean, k) is None for k in SURFACE_OPS)


@pytest.mark.parametrize("name", ["a0_multiply", "a1_multiply",
                                  "a2_multiply"])
def test_multiplies_match_jax(params, name):
    """The three explicit multiplies on random surfaces, per option."""
    spec = GridSpec(m1=12, m2=9)
    ops, jos = _operator_sets(params, spec, np.array([85.0, 120.0]),
                              [20, 20])
    u = np.random.default_rng(SEED).normal(size=(2, 13, 10))
    got = getattr(operators, name)(ops, t64(u))
    for b, jo in enumerate(jos):
        want = getattr(jops, name)(jo, jnp.asarray(u[b].T))
        assert_close(got[b], np.asarray(want).T)


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
        port_cfg(spec), port_cfg(SolverConfig()), strikes, 100.0, p.kappa,
        p.eta, p.sigma, p.rho, p.v0, p.r_d, 0.01)
    a1pq, g = out[1], out[6]
    bands = operators.build_a1_bands(g, p.r_d, 0.01)
    v = g.vec_v[None, None, :]
    for k, band in enumerate(bands):
        rebuilt = v * a1pq[2 * k][:, :, None] + a1pq[2 * k + 1][:, :, None]
        torch.testing.assert_close(rebuilt, band, rtol=1e-12, atol=1e-12)

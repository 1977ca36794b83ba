"""Puts, cash-or-nothing digitals and knock-out barriers on the
single-option route of heston_tpu_torch (a batch of one: kernel 2's plain
version, `fused_single_reference`) against heston_tpu, float64 on the
CPU; and the host pieces these payoffs bring: knock-in prices by in–out
parity, `bs.digital_price`, `grid.validate_book`, the knock-out s-grid
(`make_barrier_s_nodes`) and the payoff and barrier branches of
`ops.operators`.

Prices are held against the JAX package's `solver_engine="scan"` path at
1e-10 (its own tests hold that path equal to its Pallas kernels at 1e-11,
tests/test_barrier.py:195-227, tests/test_puts.py:126,
tests/test_digital.py:120), and once per payoff family against its
single-option Pallas kernel in interpret mode (a put, an American
digital)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, Barrier, GridSpec,
                               HestonParams, SolverConfig)
from heston_tpu.models import bs as jbs
from heston_tpu.models import douglas as jdouglas
from heston_tpu.ops import grid as jgrid
from heston_tpu.ops import operators as jops
from heston_tpu.pallas import fused_single as jfs
import heston_tpu_torch
from heston_tpu_torch.kernels import assembly, cuda_build, fused_single
from heston_tpu_torch.models import bs
from heston_tpu_torch.ops import grid, operators

from torch_parity import CPU, assert_close, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

SEED = 6
P = HestonParams()
SPEC = GridSpec(m1=12, m2=8)
SCAN = SolverConfig(n_steps=6, a2_variant="upwind", solver_engine="scan")
PALLAS = dataclasses.replace(SCAN, solver_engine="pallas")
R_F = 0.01
ARMS = {"euro": dict(american=False, dividends=None),
        "amer": dict(american=True, dividends=None),
        "div": dict(american=False, dividends=GOLDEN_DIVIDENDS),
        "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS)}
# name -> (option_type, barrier, strike)
PAYOFFS = {
    "put": ("put", None, 104.0),
    "digital_call": ("digital_call", None, 96.0),
    "digital_put": ("digital_put", None, 104.0),
    "up_out_call": ("call", Barrier("up-out", 150.0), 96.0),
    "down_out_put": ("put", Barrier("down-out", 80.0), 104.0),
    "double_out_digital_put": ("digital_put",
                               Barrier("double-out", 80.0, level_hi=150.0),
                               104.0),
}
CASES = [(p, a) for p in ("put", "digital_call", "up_out_call")
         for a in ARMS] + [(p, a) for p in ("digital_put", "down_out_put",
                                            "double_out_digital_put")
                           for a in ("euro", "amer_div")]
PRICE_TOL = 1e-10     # f64 prices against the JAX package
BARRIERS = {"up-out": Barrier("up-out", 150.0),
            "down-out": Barrier("down-out", 80.0),
            "double-out": Barrier("double-out", 80.0, level_hi=150.0)}


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


def _single(payoff, arm, solver=SCAN):
    """(JAX price, the port's price_batch of one strike on the CPU)."""
    option_type, barrier, strike = PAYOFFS[payoff]
    spec = dataclasses.replace(SPEC, barrier=barrier)
    want = jdouglas.price_batch(spec, solver, jnp.asarray([strike]), 100.0,
                                *param_args(P, R_F), option_type=option_type,
                                **ARMS[arm])
    got = heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(dataclasses.replace(
            solver, solver_engine="pallas")), t64([strike]), 100.0,
        *param_args(P, R_F), option_type=option_type,
        **_port_kw(ARMS[arm]), device=CPU)
    return np.asarray(want), got


@pytest.mark.parametrize("payoff,arm", CASES)
def test_single_matches_jax_scan(payoff, arm, monkeypatch):
    """One strike through price_batch: the single-option route (its plain
    version runs, the batched loop does not), the price at 1e-10 against
    the JAX package's scan engine."""
    from heston_tpu_torch.kernels import fused_do

    def no_batched(*a, **k):
        raise AssertionError("a batch of one took the batched loop")

    monkeypatch.setattr(fused_do, "fused_do_reference", no_batched)
    want, got = _single(payoff, arm)
    assert got.shape == (1,)
    assert_close(got, want, rtol=0, atol=PRICE_TOL)


def test_single_under_hv_with_rannacher_matches_jax_scan():
    """An American put with the golden dividends under HV after two
    Rannacher damp steps (a Douglas launch, then the scheme's)."""
    solver = dataclasses.replace(SCAN, scheme="hv", rannacher_steps=2)
    want, got = _single("put", "amer_div", solver)
    assert_close(got, want, rtol=0, atol=PRICE_TOL)


@pytest.mark.parametrize("payoff,arm", [("put", "amer_div"),
                                        ("digital_call", "amer")])
def test_single_matches_jax_kernel(payoff, arm):
    """The plain single-option loop against the JAX package's
    single-option Pallas kernel in interpret mode (PCR along s; its
    floor, reaction rows and, for the American digital, its projection),
    price at 1e-10."""
    option_type, _, strike = PAYOFFS[payoff]
    want = jfs.fused_price_single(SPEC, PALLAS, strike, 100.0,
                                  *param_args(P, R_F),
                                  option_type=option_type, **ARMS[arm])
    got = fused_single.fused_price_single(
        port_cfg(SPEC), port_cfg(PALLAS), t64([strike]), 100.0,
        *param_args(P, R_F), option_type=option_type, **_port_kw(ARMS[arm]))
    assert_close(got, np.atleast_1d(np.asarray(want)), rtol=0,
                 atol=PRICE_TOL)


@pytest.mark.parametrize("kind", sorted(BARRIERS))
@pytest.mark.parametrize("option_type", ["call", "put"])
def test_price_knock_in_matches_jax(kind, option_type):
    """price_knock_in (vanilla minus knock-out, European, golden
    dividends) against the JAX package's, a book of three at 1e-10; with
    the knock-out it sums to the vanilla (the two legs run on their own
    grids, so on this coarse grid a knock-in can dip below 0)."""
    spec = dataclasses.replace(SPEC, barrier=BARRIERS[kind])
    ks = np.array([92.0, 100.0, 108.0])
    want = jdouglas.price_knock_in(spec, SCAN, jnp.asarray(ks), 100.0,
                                   *param_args(P, R_F),
                                   dividends=GOLDEN_DIVIDENDS,
                                   option_type=option_type)
    got = heston_tpu_torch.price_knock_in(
        port_cfg(spec), port_cfg(PALLAS), t64(ks), 100.0,
        *param_args(P, R_F), dividends=port_cfg(GOLDEN_DIVIDENDS),
        option_type=option_type, device=CPU)
    assert_close(got, np.asarray(want), rtol=0, atol=PRICE_TOL)
    vanilla = heston_tpu_torch.price_batch(
        port_cfg(SPEC), port_cfg(PALLAS), t64(ks), 100.0,
        *param_args(P, R_F), dividends=port_cfg(GOLDEN_DIVIDENDS),
        option_type=option_type, device=CPU)
    out = heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(PALLAS), t64(ks), 100.0,
        *param_args(P, R_F), dividends=port_cfg(GOLDEN_DIVIDENDS),
        option_type=option_type, device=CPU)
    assert_close(got + out, vanilla, rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="spec.barrier"):
        heston_tpu_torch.price_knock_in(
            port_cfg(SPEC), port_cfg(PALLAS), t64(ks), 100.0,
            *param_args(P, R_F), device=CPU)


@pytest.mark.parametrize("option_type", ["digital_call", "digital_put"])
def test_digital_price_matches_jax(option_type):
    """bs.digital_price at scalar and per-quote inputs against the JAX
    package's closed form, 1e-12; the PDE digital on a fine grid lies
    within 1e-2 of the Black–Scholes limit at sigma -> 0 vol-of-vol
    (flat variance v0 = eta = 0.04, vol 0.2)."""
    rng = np.random.default_rng(SEED)
    ks = rng.uniform(70.0, 130.0, 16)
    vols = rng.uniform(0.1, 0.5, 16)
    got = bs.digital_price(100.0, t64(ks), 0.025, t64(vols), 0.75,
                           option_type)
    want = jbs.digital_price(100.0, jnp.asarray(ks), 0.025,
                             jnp.asarray(vols), 0.75, option_type)
    assert_close(got, want)
    assert_close(bs.digital_price(100.0, 100.0, 0.025, 0.2, 1.0, option_type),
                 jbs.digital_price(100.0, 100.0, 0.025, 0.2, 1.0,
                                   option_type))
    pde = heston_tpu_torch.price_batch(
        port_cfg(GridSpec(m1=60, m2=20)), port_cfg(dataclasses.replace(
            PALLAS, n_steps=40)), t64([100.0]), 100.0, 1.5, 0.04, 1e-4,
        0.0, 0.04, 0.025, 0.0, option_type=option_type, device=CPU)
    limit = bs.digital_price(100.0, t64([100.0]), 0.025, 0.2, 1.0,
                             option_type)
    assert abs(float(pde[0] - limit[0])) < 1e-2


@pytest.mark.parametrize("case", ["spot_past_smax", "up_knocked",
                                  "down_knocked", "double_top_knocked",
                                  "last_cell", "valid"])
def test_validate_book_matches_jax(case):
    """grid.validate_book raises the JAX package's ValueError (the same
    message) for each book a knock-out grid cannot hold, and price_batch
    raises it before anything runs; a valid book passes both."""
    spec, s0, ks = {
        "spot_past_smax": (SPEC, 100.0, [10.0, 100.0]),
        "up_knocked": (dataclasses.replace(SPEC, barrier=BARRIERS["up-out"]),
                       150.0, [100.0]),
        "down_knocked": (dataclasses.replace(
            SPEC, barrier=BARRIERS["down-out"]), 80.0, [100.0]),
        "double_top_knocked": (dataclasses.replace(
            SPEC, barrier=BARRIERS["double-out"]), 151.0, [100.0]),
        "last_cell": (GridSpec(m1=6, m2=8, barrier=Barrier("up-out", 110.0)),
                      108.0, [60.0, 100.0]),
        "valid": (dataclasses.replace(SPEC, barrier=BARRIERS["double-out"]),
                  100.0, [90.0, 110.0]),
    }[case]
    try:
        jgrid.validate_book(spec, s0, np.asarray(ks))
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        grid.validate_book(port_cfg(spec), s0, t64(ks))
        assert case == "valid"
        return
    with pytest.raises(ValueError) as got:
        grid.validate_book(port_cfg(spec), s0, t64(ks))
    assert str(got.value) == want
    if spec.barrier is not None:
        with pytest.raises(ValueError):
            heston_tpu_torch.price_batch(
                port_cfg(spec), port_cfg(PALLAS), t64(ks), s0,
                *param_args(P), device=CPU)


@pytest.mark.parametrize("m1", [6, 12, 40])
@pytest.mark.parametrize("kind", sorted(BARRIERS))
def test_barrier_s_nodes_match_jax(kind, m1):
    """make_barrier_s_nodes per strike against the JAX package's, 1e-12;
    the knocked ends are the barrier levels exactly, S0 is a node, and
    the nodes ascend."""
    b = BARRIERS[kind]
    ks = np.array([85.0, 100.0, 121.0])
    got = grid.make_barrier_s_nodes(m1, port_cfg(b), t64(8.0 * ks), 100.0,
                                    t64(ks), t64(0.2 * ks))
    assert got.shape == (3, m1 + 1)
    for r, k in enumerate(ks):
        want = jgrid.make_barrier_s_nodes(m1, b, 8.0 * k, 100.0, k, 0.2 * k)
        assert_close(got[r], want)
    if b.knock_top:
        assert bool((got[:, -1] == b.hi(None)).all())
    if b.knock_bottom:
        assert bool((got[:, 0] == b.level).all())
    assert bool(((got - 100.0).abs().min(dim=1).values < 1e-12).all())
    assert bool((torch.diff(got, dim=1) > 0).all())


@pytest.mark.parametrize("option_type", list(operators.OPTION_TYPES))
def test_payoff_value_and_intrinsic_match_jax(option_type):
    """operators.payoff_value (the strict indicator for digitals, the
    floored intrinsic for vanillas) and intrinsic_value (vanillas; a
    ValueError for digitals) against the JAX package's, at random spots
    with a few exactly at the strike."""
    rng = np.random.default_rng(SEED)
    s = np.concatenate([rng.uniform(50.0, 150.0, 20), [100.0, 100.0]])
    assert_close(operators.payoff_value(t64(s), 100.0, option_type),
                 jops.payoff_value(jnp.asarray(s), 100.0, option_type),
                 rtol=0, atol=0)
    if operators.is_digital(option_type):
        with pytest.raises(ValueError, match="vanilla"):
            operators.intrinsic_value(t64(s), 100.0, option_type)
    else:
        assert_close(operators.intrinsic_value(t64(s), 100.0, option_type),
                     jops.intrinsic_value(jnp.asarray(s), 100.0,
                                          option_type), rtol=0, atol=0)


@pytest.mark.parametrize("kind", sorted(BARRIERS))
@pytest.mark.parametrize("option_type", ["call", "put", "digital_call"])
def test_barrier_operators_match_jax(kind, option_type):
    """The barrier branches of the operators against the JAX package's,
    per strike at 1e-12: the A2 reaction on every row for a top knock,
    the boundary vector (no injection under a top knock, no b1 on a
    down-out's column 0) and the full operator set."""
    b = BARRIERS[kind]
    spec = dataclasses.replace(SPEC, m2=14, barrier=b)
    ks = np.array([92.0, 108.0])
    g = grid.make_grid(port_cfg(spec), 100.0, t64(ks), 0.04)
    a2 = operators.build_a2_bands(g, P.r_d, P.kappa, P.eta, P.sigma,
                                  "upwind", option_type, port_cfg(b))
    ops = operators.build_operators(g, P.kappa, P.eta, P.sigma, P.rho,
                                    P.r_d, R_F, 0.05, t64([20, 20]),
                                    "upwind", option_type,
                                    barrier=port_cfg(b))
    for r, k in enumerate(ks):
        jg = jgrid.make_grid(spec, 100.0, k, 0.04)
        for x, y in zip(a2, jops.build_a2_bands(jg, P.r_d, P.kappa, P.eta,
                                                P.sigma, "upwind",
                                                option_type, b)):
            assert_close(x, y)
        jo = jops.build_operators(jg, P.kappa, P.eta, P.sigma, P.rho, P.r_d,
                                  R_F, 0.8, 0.05, 20.0, "upwind",
                                  option_type, strike=k, barrier=b)
        for name in ("a0_c", "a1_ml", "a1_md", "a1_mu", "b"):
            assert_close(getattr(ops, name)[r],
                         np.asarray(getattr(jo, name)).T, err_msg=name)
        if b.knock_top or operators.is_injection_free(option_type):
            assert float(ops.b[r].abs().max()) == 0.0
        elif b.knock_bottom:
            assert float(ops.b[r, 0].abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["none", *sorted(BARRIERS)])
@pytest.mark.parametrize("option_type", list(operators.OPTION_TYPES))
def test_launch_flags_follow_the_operators(kind, option_type):
    """The kernels' payoff launch ints read the operators' own rules: the
    reaction rows `n_react` (cuda_build.launch_flags) are the A2 rows that
    build_a2_bands gives -r_d/2 (with kappa = sigma = 0 the reaction is
    all the diagonal holds), the boundary data vanish exactly when every
    row reacts, and a dividend remaps the compensation apart for puts and
    barriers only (assembly.remaps_apart)."""
    spec = port_cfg(dataclasses.replace(SPEC, barrier=BARRIERS.get(kind)))
    ns, nv = spec.m1 + 1, spec.m2 + 1
    knocked = assembly.barrier_positions(spec)
    _, n_react, *knocks = cuda_build.launch_flags(option_type, knocked, ns, nv)
    g = grid.make_grid(spec, 100.0, t64([100.0]), 0.04)
    d = operators.build_a2_bands(g, 0.05, 0.0, P.eta, 0.0, "central",
                                 option_type, spec.barrier)[2]
    assert n_react == int((d != 0.0).sum())
    b1, b2 = operators.boundary_data(g, 0.05, 0.0, 0.05, t64([20.0]),
                                     option_type, spec.barrier)
    assert (n_react == nv) == (float(b1.abs().max()) == 0.0
                               and float(b2.abs().max()) == 0.0)
    assert knocks == sorted(knocked) + [-1] * (2 - len(knocked))
    assert assembly.remaps_apart(option_type, knocked) == (
        option_type in ("put", "digital_put") or kind != "none")

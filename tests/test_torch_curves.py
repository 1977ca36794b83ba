"""Rate-curve books, the damped Jacobian and v0_mode "ad" of
heston_tpu_torch against heston_tpu, in float64 on the CPU (the plain
versions of the kernels).

A curve book (`config.RateSchedule`) runs one launch of the batched
kernel per phase and rate-segment piece; the references are the JAX
package's XLA scan engine (which its own tests hold equal to its
interpret-mode kernel at 1e-10, tests/test_rate_schedule.py:255-281) and
`jax.jacfwd` of that engine for the Jacobians
(tests/test_rannacher.py:172-201, tests/test_pallas.py:78-105). Each JAX
reference is computed once per module (`functools.cache`). The CUDA
kernel itself is held against the plain version on the card in
tests/test_torch_cuda.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, GridSpec, HestonParams,
                               RateSchedule, SolverConfig)
from heston_tpu.models import douglas as jdouglas
from heston_tpu.models import greeks as jgreeks
import heston_tpu_torch
from heston_tpu_torch.kernels import assembly, fused_do, fused_single
from heston_tpu_torch.models import calibration

from torch_parity import CPU, assert_close, npy, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

P = HestonParams()
SPEC = GridSpec(m1=12, m2=8)
# N = 4 puts the curve's segments at main steps 1 | 2-3 | 4: with R = 2
# the damp phase is cut too (damp-local steps 1-2 | 3-4) and the main
# phase starts inside segment 1; the golden dividends fall before main
# steps 1, 2 and 3, two of them at a piece's first step
SOLVER = SolverConfig(n_steps=4, a2_variant="upwind", solver_engine="pallas")
# tests/test_rate_schedule.py:139-140
RS = RateSchedule(times=(1.0 / 3.0, 2.0 / 3.0), r_d=(0.02, 0.035, 0.025),
                  r_f=(0.0, 0.01, 0.004))
STRIKES = np.linspace(80.0, 120.0, 5)
# the arms of tests/test_rate_schedule.py:268-271
ARMS = {"euro": {}, "amer": dict(american=True),
        "div": dict(dividends=GOLDEN_DIVIDENDS),
        "amer_put": dict(american=True, option_type="put")}
CURVE_CASES = [(arm, rann) for arm in sorted(ARMS) for rann in (0, 2)]
# the scalar rates are not read under a curve
ZERO_RATES = (0.0, 0.0)


def _args():
    return (100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, *ZERO_RATES)


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


def _solver(rann=0, **kw):
    return dataclasses.replace(SOLVER, rannacher_steps=rann, **kw)


@functools.cache
def _jax_curve():
    """The JAX scan engine's terminal surfaces (u, lam) of the curve book,
    each [B, ns, nv] (the port's layout), keyed by CURVE_CASES: one
    jitted vmap over the strikes computes every case
    (heston_tpu/models/douglas.py:155-200, :532-560)."""
    def one(k):
        out = []
        for arm, rann in CURVE_CASES:
            kw = ARMS[arm]
            option_type = kw.get("option_type", "call")
            solver = _solver(rann, solver_engine="scan")
            inst = jdouglas.prepare_instance(
                SPEC, solver, k, *_args(), option_type, rate_schedule=RS)
            out.append(jdouglas.run_time_loop(
                inst, solver, 0.0, kw.get("american", False),
                kw.get("dividends"), option_type, with_lambda=True,
                rate_schedule=RS))
        return out

    runs = jax.jit(jax.vmap(one))(jnp.asarray(STRIKES))
    return {case: tuple(np.asarray(x).transpose(0, 2, 1) for x in run)
            for case, run in zip(CURVE_CASES, runs)}


@pytest.mark.parametrize("arm,rann", CURVE_CASES)
def test_curve_book_matches_jax(arm, rann):
    """fused_surface_batch and price_batch of a curve book against the
    JAX scan engine: the terminal surfaces (and the American multiplier)
    on every grid point and the prices at 1e-10, one launch per phase and
    segment piece."""
    want_u, want_lam = _jax_curve()[arm, rann]
    kw = _port_kw(ARMS[arm])
    solver = port_cfg(_solver(rann))
    args = (port_cfg(SPEC), solver, t64(STRIKES), *_args())
    u, lam, _, _, idx_s, idx_v = fused_do.fused_surface_batch(
        *args, rate_schedule=port_cfg(RS), **kw)
    assert_close(u, want_u, rtol=0, atol=1e-10)
    if kw.get("american"):
        assert_close(lam, want_lam, rtol=0, atol=1e-10)
    want = want_u[np.arange(len(STRIKES)), npy(idx_s), npy(idx_v)]
    got = heston_tpu_torch.price_batch(*args, rate_schedule=port_cfg(RS),
                                       device=CPU, **kw)
    assert_close(got, want, rtol=0, atol=1e-10)
    segments = len(RS.step_segments(SOLVER.n_steps, SOLVER.delta_t,
                                    SOLVER.maturity))
    _, phases, _, _, _ = fused_do.book_plan(
        *args, rate_schedule=port_cfg(RS), **kw)
    assert len(phases) == segments + (1 if rann else 0)


def test_curve_book_of_one_takes_the_batched_kernel(monkeypatch):
    """A curve book of one strike goes to the batched kernel, not the
    single-option one (heston_tpu/models/douglas.py:871-878), and prices
    as the same strike in the book."""
    def refuse(*a, **k):
        raise AssertionError("a curve book of one took kernel 2")

    monkeypatch.setattr(fused_single, "fused_price_single", refuse)
    kw = _port_kw(ARMS["amer"])
    got = heston_tpu_torch.price_batch(
        port_cfg(SPEC), port_cfg(_solver(2)), t64(STRIKES[2:3]), *_args(),
        rate_schedule=port_cfg(RS), device=CPU, **kw)
    book = heston_tpu_torch.price_batch(
        port_cfg(SPEC), port_cfg(_solver(2)), t64(STRIKES), *_args(),
        rate_schedule=port_cfg(RS), device=CPU, **kw)
    assert torch.equal(got, book[2:3])


def test_curve_batch_greeks_matches_jax():
    """batch_greeks of an American curve book with the golden dividends
    (tests/test_rate_schedule.py:293-335, the risk columns) against the
    JAX scan engine's: every column at 1e-9; theta takes the last
    segment's operators and boundary rate."""
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    want = jgreeks.batch_greeks(
        SPEC, _solver(solver_engine="scan"), jnp.asarray(STRIKES),
        *_args(), rate_schedule=RS, **kw)
    got = heston_tpu_torch.batch_greeks(
        port_cfg(SPEC), port_cfg(SOLVER), t64(STRIKES), *_args(),
        rate_schedule=port_cfg(RS), device=CPU, **_port_kw(kw))
    assert set(got) == set(want)
    for k, w in want.items():
        assert_close(got[k], w, rtol=0, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("rann", [0, 2])
@pytest.mark.parametrize("arm", ["amer", "amer_put"])
def test_constant_curve_equals_flat(arm, rann):
    """A curve whose segments carry equal rates prices and risks as the
    flat scalars, and a flat book's phases cut into pieces at equal
    segments (main steps 1 | 2-3 | 4) run as the uncut phases: 1e-11
    (tests/test_rate_schedule.py:159-172; each cut folds the compensation
    into u and round-trips lambda through lambda/dt)."""
    kw = _port_kw(dict(ARMS[arm], dividends=GOLDEN_DIVIDENDS))
    flat = port_cfg(RateSchedule(times=(0.3, 0.6), r_d=(P.r_d,) * 3,
                                 r_f=(P.r_f,) * 3))
    args = (port_cfg(SPEC), port_cfg(_solver(rann)), t64(STRIKES), 100.0,
            *param_args(P))
    want = heston_tpu_torch.batch_greeks(*args, device=CPU, **kw)
    got = heston_tpu_torch.batch_greeks(*args, rate_schedule=flat,
                                        device=CPU, **kw)
    for k in heston_tpu_torch.RISK_KEYS:
        assert_close(got[k], want[k], rtol=0, atol=1e-11, err_msg=k)
    fields, whole, at, _, vec_s = fused_do.book_plan(*args, **kw)
    option_type = kw.get("option_type", "call")
    rf = fused_do.operators.boundary_rate(P.r_d, P.r_f, option_type)
    cut = fused_do.book_phases(
        args[1], kw["dividends"], vec_s, None, True, None, option_type, (),
        [(1, 1, rf, fields), (2, 3, rf, fields), (4, 4, rf, fields)])
    assert len(cut) == len(whole) + 2
    for g, w in zip(assembly.run_phases(fused_do.fused_do_loop, fields, cut),
                    assembly.run_phases(fused_do.fused_do_loop, fields,
                                        whole)):
        assert_close(g, w, rtol=0, atol=1e-11)


def test_rate_segment_structure_matches_jax():
    """The segments, boundary rates and anchors of a curve, for calls and
    puts, against the JAX package's (plain floats, bitwise)."""
    from heston_tpu.ops import operators as jops

    for option_type in ("call", "put"):
        for n in (6, 20):
            want = jops.rate_segment_structure(n, 1.0 / n, 1.0, RS,
                                               option_type)
            got = fused_do.operators.rate_segment_structure(
                n, 1.0 / n, 1.0, port_cfg(RS), option_type)
            assert got == want


# ---------------------------------------------------------------------------
# the damped Jacobian and v0_mode "ad"
# ---------------------------------------------------------------------------

JAC_SPEC = GridSpec(m1=16, m2=8)         # tests/test_rannacher.py:178-181
JAC_STRIKES = np.linspace(90.0, 110.0, 3)


def _theta():
    return np.array([P.kappa, P.eta, P.sigma, P.rho, P.v0])


@functools.cache
def _jax_jacfwd(rann, arm):
    """(prices [B], jax.jacfwd [B, 5]) of the JAX scan engine's book
    prices (the XLA path: every column AD, the v0 one through the grid)."""
    solver = _solver(rann, n_steps=4, solver_engine="scan")
    kw = dict(american=True) if arm == "amer" else dict(
        american=True, dividends=GOLDEN_DIVIDENDS)

    def prices(t):
        return jdouglas.price_batch(JAC_SPEC, solver,
                                    jnp.asarray(JAC_STRIKES), 100.0, t[0],
                                    t[1], t[2], t[3], t[4], P.r_d, P.r_f,
                                    **kw)

    base, jac = jax.jit(lambda t: (prices(t), jax.jacfwd(prices)(t)))(
        jnp.asarray(_theta()))
    return np.asarray(base), np.asarray(jac)


@pytest.mark.parametrize("v0_mode", ["stencil", "ad"])
def test_jacobian_matches_jax_jacfwd(v0_mode):
    """fused_theta_jacobian of the damped Jacobian (tests/test_rannacher.py:
    172-201) on the American-dividend book of tests/test_pallas.py:78-105
    (the linearized assembly, one forward-mode launch per phase, the
    tangent state carried from the damp launch to the main one) against
    jax.jacfwd of the JAX package's XLA path: the base prices at 1e-11;
    the four AD columns at 1e-9, and under v0_mode "ad" (five tangents,
    the v0 one the v-grid's motion) the v0 column too. The stencil's v0
    column is the discretization's v-derivative, not the grid motion's,
    and is not compared here; the undamped five-tangent Jacobian is held
    against the JAX kernel in tests/test_torch_fused_do.py."""
    rann, arm = 2, "amer_div"
    want, want_jac = _jax_jacfwd(rann, arm)
    kw = dict(american=True) if arm == "amer" else dict(
        american=True, dividends=port_cfg(GOLDEN_DIVIDENDS))
    base, jac = fused_do.fused_theta_jacobian(
        port_cfg(JAC_SPEC), port_cfg(_solver(rann, n_steps=4)),
        t64(JAC_STRIKES), 100.0, t64(_theta()), P.r_d, P.r_f,
        v0_mode=v0_mode, **kw)
    assert_close(base, want, rtol=0, atol=1e-11)
    cols = 5 if v0_mode == "ad" else 4
    assert_close(jac[:, :cols], want_jac[:, :cols], rtol=0, atol=1e-9)


def test_damped_ladder_jacobian_matches_group_launches():
    """A damped mixed-maturity ladder's Jacobian in one launch per phase
    (each lane damps 2*min(n_i, R) sub-steps, heston_tpu/pallas/
    fused_do.py:1706-1715) against one damped Jacobian per maturity group
    at the same dt: 1e-12 relative (the matured lanes' identity events
    fold their compensation, ROADMAP C2); its base prices are the
    per-lane primal launches', bitwise."""
    nst = [1, 4, 2, 4, 3, 2]
    strikes = np.linspace(88.0, 112.0, 6)
    kw = dict(american=True, dividends=port_cfg(GOLDEN_DIVIDENDS))
    solver = port_cfg(_solver(2, n_steps=4))
    args = (port_cfg(JAC_SPEC), solver)
    base, jac = fused_do.fused_theta_jacobian(
        *args, t64(strikes), 100.0, t64(_theta()), P.r_d, P.r_f,
        n_steps_per=nst, **kw)
    assert torch.equal(base, fused_do.fused_price_batch(
        *args, t64(strikes), 100.0, *param_args(P), n_steps_per=nst, **kw))
    for n in sorted(set(nst)):
        lanes = [i for i, m in enumerate(nst) if m == n]
        gb, gj = fused_do.fused_theta_jacobian(
            args[0], calibration._group_solver(solver, n), t64(strikes[lanes]),
            100.0, t64(_theta()), P.r_d, P.r_f, **kw)
        assert_close(base[lanes], gb, rtol=1e-12, atol=0)
        assert_close(jac[lanes], gj, rtol=1e-12, atol=1e-13)


def test_damped_calibration_runs_two_launches_per_pass(monkeypatch):
    """calibrate_device with Rannacher start-up: each iteration one damp
    and one main launch of the forward-mode loop and of the primal loop,
    and the fit's first Jacobian is fused_theta_jacobian's."""
    calls = []
    loop = fused_do.fused_do_loop

    def spy(*a, **kw):
        calls.append((kw.get("tangents") is not None, kw["delta_t"]))
        return loop(*a, **kw)

    monkeypatch.setattr(fused_do, "fused_do_loop", spy)
    solver = port_cfg(_solver(2, n_steps=4))
    strikes = t64(np.linspace(85.0, 115.0, 6))
    market = heston_tpu_torch.models.bs.generate_market_data(
        100.0, 1.0, P.r_d, strikes)
    cfg = heston_tpu_torch.CalibrationConfig(max_iter=2, tol=1e-12,
                                             jacobian_mode="ad")
    tv, info = heston_tpu_torch.calibrate_device(
        port_cfg(JAC_SPEC), solver, strikes, market, 100.0,
        t64([1.2, 0.05, 0.4, -0.5, 0.05]), P.r_d, P.r_f, cfg=cfg,
        american=True, device=CPU)
    assert info["iterations"] == 2
    dt = solver.delta_t
    assert calls == [(True, dt / 2), (True, dt), (False, dt / 2),
                     (False, dt)] * 2
    assert bool(torch.isfinite(tv).all())

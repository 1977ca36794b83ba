"""The eager ADI engine of heston_tpu_torch.models.douglas against the JAX
package's XLA time loop (heston_tpu.models.douglas under "scan"/"pcr"):
price_option over a covering set of schemes x exercise x payoffs x rate
curves x Rannacher damping, price_and_v0_stencil, solve_with_tracking,
price_surface, apply_dividend, the phase plan, the grid extras and
price_batch under both engines; float64 on the CPU. "scan" runs the JAX
package's arithmetic (atol 1e-12; the grids' sinh nodes differ by ulps
between XLA and PyTorch); "pcr" composes its recurrences in another order
(1e-9, tests/test_banded.py:122-129). Each JAX reference runs once per
module (`functools.cache`)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, Barrier, DividendSchedule,
                               GridSpec, HestonParams, RateSchedule,
                               SolverConfig)
from heston_tpu.models import douglas as jdouglas
from heston_tpu.ops import grid as jgrid
from heston_tpu.ops import operators as jops
import heston_tpu_torch
from heston_tpu_torch.models import douglas
from heston_tpu_torch.ops import grid

from torch_parity import CPU, assert_close, npy, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

P = HestonParams()
SPEC = GridSpec(m1=14, m2=8)
UP_OUT = GridSpec(m1=14, m2=8, barrier=Barrier("up-out", 160.0))
STRIKES = np.array([85.0, 100.0, 115.0])
# N = 6: the curve's segments are main steps 1-3 | 4-6, so R = 2 damps
# inside the first; the golden dividends fall before steps 1, 2, 3, 4
CURVE = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.01))
EXERCISE = {"euro": {}, "amer": dict(american=True),
            "div": dict(dividends=GOLDEN_DIVIDENDS),
            "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS)}
# (scheme, exercise, option type, barrier, curve, rannacher_steps): every
# value of every axis, no two cases alike
CASES = {
    "do_euro_call": ("do", "euro", "call", False, False, 0),
    "do_amer_div_call_curve_rann": ("do", "amer_div", "call", False, True, 2),
    "cs_amer_put_rann": ("cs", "amer", "put", False, False, 2),
    "cs_div_digital_curve": ("cs", "div", "digital_call", False, True, 0),
    "mcs_amer_div_up_out": ("mcs", "amer_div", "call", True, False, 0),
    "hv_amer_digital": ("hv", "amer", "digital_call", False, False, 0),
    "hv_amer_div_up_out_curve_rann": ("hv", "amer_div", "call", True, True,
                                      2),
}


def _case(name, engine="scan"):
    scheme, ex, ot, barrier, curve, rann = CASES[name]
    solver = SolverConfig(n_steps=6, scheme=scheme, solver_engine=engine,
                          rannacher_steps=rann)
    kw = dict(EXERCISE[ex], option_type=ot,
              rate_schedule=CURVE if curve else None)
    return (UP_OUT if barrier else SPEC), solver, kw


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


@functools.cache
def _jax_prices(name, engine="scan"):
    spec, solver, kw = _case(name, engine)
    return np.asarray(jdouglas.price_batch(
        spec, solver, jnp.asarray(STRIKES), 100.0, *param_args(P), **kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_price_option_matches_jax(case):
    """The book batched over its strikes, lane for lane the JAX package's
    vmapped price_option (its scan engine)."""
    spec, solver, kw = _case(case)
    got = heston_tpu_torch.price_option(
        port_cfg(spec), port_cfg(solver), t64(STRIKES), 100.0,
        *param_args(P), **_port_kw(kw), device=CPU)
    assert got.shape == STRIKES.shape and got.dtype == torch.float64
    assert_close(got, _jax_prices(case), rtol=0, atol=1e-12)


def test_price_option_of_one_strike_is_a_scalar():
    spec, solver, kw = _case("do_euro_call")
    got = douglas.price_option(port_cfg(spec), port_cfg(solver),
                               t64(STRIKES[1]), 100.0, *param_args(P),
                               device=CPU)
    assert got.dim() == 0
    assert_close(got, _jax_prices("do_euro_call")[1], rtol=0, atol=1e-12)


@pytest.mark.parametrize("case,engine", [
    ("do_amer_div_call_curve_rann", "scan"), ("hv_amer_digital", "scan"),
    ("do_amer_div_call_curve_rann", "pcr")])
def test_price_batch_engines_match_jax(case, engine):
    """price_batch under "scan" and "pcr" runs the eager loop over the
    book, as the JAX package vmaps price_option (heston_tpu/models/
    douglas.py:891-898)."""
    spec, solver, kw = _case(case, engine)
    got = heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(solver), t64(STRIKES), 100.0,
        *param_args(P), **_port_kw(kw), device=CPU)
    assert_close(got, _jax_prices(case, engine), rtol=0,
                 atol=1e-12 if engine == "scan" else 1e-9)


def test_pallas_price_batch_never_runs_the_eager_loop(monkeypatch):
    """Under "pallas" every book goes to a kernel (or its plain version on
    the CPU): the eager loop raising changes nothing."""
    spec, solver, kw = _case("do_amer_div_call_curve_rann", "pallas")

    def boom(*a, **k):
        raise AssertionError("the eager loop ran")

    want = heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(solver), t64(STRIKES), 100.0,
        *param_args(P), **_port_kw(kw), device=CPU)
    monkeypatch.setattr(douglas, "_run", boom)
    for ks in (STRIKES, STRIKES[:1]):
        heston_tpu_torch.price_batch(
            port_cfg(spec), port_cfg(solver), t64(ks), 100.0,
            *param_args(P), **_port_kw(kw), device=CPU)
    with pytest.raises(AssertionError, match="eager loop"):
        heston_tpu_torch.price_batch(
            port_cfg(spec), port_cfg(dataclasses.replace(
                solver, solver_engine="scan")), t64(STRIKES), 100.0,
            *param_args(P), **_port_kw(kw), device=CPU)
    # the kernel and the eager loop price the same book
    assert_close(want, _jax_prices("do_amer_div_call_curve_rann"), rtol=0,
                 atol=1e-10)


@functools.cache
def _jax_stencil():
    spec, solver, kw = _case("hv_amer_div_up_out_curve_rann")
    fn = jax.jit(jax.vmap(lambda k: jdouglas.price_and_v0_stencil(
        spec, solver, k, 100.0, *param_args(P), **kw)))
    return tuple(np.asarray(x) for x in fn(jnp.asarray(STRIKES)))


def test_price_and_v0_stencil_matches_jax():
    spec, solver, kw = _case("hv_amer_div_up_out_curve_rann")
    price, dv = douglas.price_and_v0_stencil(
        port_cfg(spec), port_cfg(solver), t64(STRIKES), 100.0,
        *param_args(P), **_port_kw(kw), device=CPU)
    want_p, want_dv = _jax_stencil()
    assert_close(price, want_p, rtol=0, atol=1e-12)
    assert_close(dv, want_dv, rtol=0, atol=1e-10)


@functools.cache
def _jax_tracking(name):
    spec, solver, kw = _case(name)
    rs = kw.pop("rate_schedule")
    american = kw.pop("american", False)
    dividends = kw.pop("dividends", None)

    def one(k):
        inst = jdouglas.prepare_instance(spec, solver, k, 100.0,
                                         *param_args(P), rate_schedule=rs,
                                         **kw)
        return jdouglas.solve_with_tracking(
            inst, solver, jops.boundary_rate(P.r_d, P.r_f, kw["option_type"]),
            american, dividends, kw["option_type"], rate_schedule=rs)

    return tuple(np.asarray(x) for x in jax.jit(jax.vmap(one))(
        jnp.asarray(STRIKES)))


@pytest.mark.parametrize("case", ["do_amer_div_call_curve_rann"])
def test_solve_with_tracking_matches_jax(case):
    """Every full-dt surface and multiplier, N+1 of them with a damped
    start (every second sub-step)."""
    spec, solver, kw = _case(case)
    pkw = _port_kw(kw)
    rs = pkw.pop("rate_schedule")
    american = pkw.pop("american", False)
    dividends = pkw.pop("dividends", None)
    inst = douglas.prepare_instance(port_cfg(spec), port_cfg(solver),
                                    t64(STRIKES), 100.0, *param_args(P),
                                    rate_schedule=rs, **pkw)
    surfaces, lambdas = douglas.solve_with_tracking(
        inst, port_cfg(solver),
        heston_tpu_torch.ops.operators.boundary_rate(P.r_d, P.r_f,
                                                     pkw["option_type"]),
        american, dividends, pkw["option_type"], rate_schedule=rs)
    want_u, want_lam = _jax_tracking(case)
    assert surfaces.shape == (3, solver.n_steps + 1, 15, 9)
    # the port's surfaces are [B, N+1, ns, nv], the JAX package's
    # [B, N+1, nv, ns]
    assert_close(surfaces.transpose(-1, -2), want_u, rtol=0, atol=1e-10)
    assert_close(lambdas.transpose(-1, -2), want_lam, rtol=0, atol=1e-8)
    assert float(lambdas.abs().max()) > 0.0


def test_price_surface_matches_jax():
    spec, solver, kw = _case("hv_amer_digital")
    kw.pop("rate_schedule")
    params = dataclasses.replace(P, r_f=0.01)
    u, g = douglas.price_surface(port_cfg(spec), port_cfg(solver),
                                 t64(STRIKES[:1]), 100.0, port_cfg(params),
                                 **_port_kw(kw), device=CPU)
    want_u, want_g = jax.jit(lambda k: jdouglas.price_surface(
        spec, solver, k, 100.0, params, **kw))(STRIKES[0])
    assert_close(u[0].T, want_u, rtol=0, atol=1e-10)
    assert_close(g.vec_s[0], want_g.vec_s)
    assert_close(g.vec_v, want_g.vec_v)


@pytest.mark.parametrize("option_type,barrier", [
    ("call", None), ("put", None), ("call", Barrier("up-out", 160.0)),
    ("call", Barrier("down-out", 70.0))])
def test_apply_dividend_matches_jax(option_type, barrier):
    """The re-map of random surfaces on grids whose shifted nodes fall
    below zero (a large cash dividend), off the grid's top and on nodes;
    the put's left-column copy and the up-out's re-knock included."""
    spec = GridSpec(m1=14, m2=8, barrier=barrier)
    g = grid.make_grid(port_cfg(spec), 100.0, t64([90.0, 110.0]), 0.04)
    u = np.random.default_rng(7).normal(size=(2, 15, 9))
    for amount, pct in ((0.5, 0.02), (30.0, 0.0), (0.0, 0.1)):
        got = douglas.apply_dividend(t64(u), g.vec_s, amount, pct,
                                     option_type, port_cfg(barrier))
        for b in range(2):
            want = jdouglas.apply_dividend(
                jnp.asarray(u[b].T), jnp.asarray(npy(g.vec_s[b])), amount,
                pct, option_type, barrier)
            assert_close(got[b].T, want, rtol=0, atol=1e-13)


def _jax_schedule(acts):
    """JAX's plan (_phase_plan, or _loop_views' with keys (phase,
    segment)) expanded into the port's `_schedule` actions."""
    out = []
    for act in acts:
        if act[0] != "run":
            out.append(act)
            continue
        _, key, n0, n1 = act
        phase, si = key if isinstance(key, tuple) else (key, 0)
        out.extend(("step", phase == "damp", si, k) for k in range(n0, n1))
    return out


@pytest.mark.parametrize("n_steps,rann,dates", [
    (6, 0, GOLDEN_DIVIDENDS.dates), (6, 2, GOLDEN_DIVIDENDS.dates),
    (4, 9, (0.0, 0.25, 0.26, 0.99)), (5, 1, ())])
def test_phase_plan_matches_jax(n_steps, rann, dates):
    """The static plan (steps and re-maps in order), flat and split at a
    curve's segments, as the JAX package builds it."""
    div = DividendSchedule(dates=dates, amounts=(0.5,) * len(dates),
                           percentages=(0.01,) * len(dates))
    solver = SolverConfig(n_steps=n_steps, rannacher_steps=rann)
    assert (list(douglas._schedule(port_cfg(solver), port_cfg(div)))
            == _jax_schedule(jdouglas._phase_plan(solver, div)))
    inst = douglas.prepare_instance(port_cfg(SPEC), port_cfg(solver),
                                    t64([100.0]), 100.0, *param_args(P),
                                    rate_schedule=port_cfg(CURVE))
    # the JAX plan reads only the segment count and which segments carry
    # a damp set: an instance of placeholders with that structure
    r = min(rann, n_steps)
    jinst = jdouglas.PreparedInstance(
        *(None,) * 7, damp=None, rate_segments=tuple(
            jdouglas.SegmentOps(None, None, None, damp=(
                jdouglas.DampOps(None, None, None) if r and st[0] <= r
                else None))
            for st in jdouglas._segment_structure(solver, CURVE, "call")))
    jinst = jinst._replace(damp=jinst.rate_segments[0].damp)
    spans, views = douglas._loop_views(inst, port_cfg(solver), P.r_f,
                                       "call", port_cfg(CURVE))
    jacts, jviews = jdouglas._loop_views(jinst, solver, P.r_f, div, "call",
                                         CURVE)
    assert (list(douglas._schedule(port_cfg(solver), port_cfg(div), spans))
            == _jax_schedule(jacts))
    assert {k: v[2] for k, v in views.items()} == {
        (ph == "damp", si): v[2] for (ph, si), v in jviews.items()}


def test_prepare_instance_matches_jax():
    """Grids, payoff, extraction nodes and the operators' factorizations
    of a damped curve book: per segment, main and damp."""
    spec, solver, kw = _case("hv_amer_div_up_out_curve_rann")
    inst = douglas.prepare_instance(
        port_cfg(spec), port_cfg(solver), t64(STRIKES), 100.0,
        *param_args(P), option_type="call",
        rate_schedule=port_cfg(CURVE))
    assert len(inst.rate_segments) == 2
    assert inst.rate_segments[0].damp is not None
    assert inst.rate_segments[1].damp is None
    for b, k in enumerate(STRIKES):
        j = jdouglas.prepare_instance(spec, solver, k, 100.0,
                                      *param_args(P), rate_schedule=CURVE)
        assert int(inst.idx_s[b]) == int(j.idx_s)
        assert int(inst.idx_v) == int(j.idx_v)
        assert_close(inst.u0[b].T, j.u0)
        for seg, jseg in zip(inst.rate_segments, j.rate_segments):
            for fac, jfac in ((seg.a1_fac, jseg.a1_fac),
                              (seg.damp and seg.damp.a1_fac,
                               jseg.damp and jseg.damp.a1_fac)):
                if fac is None:
                    assert jfac is None
                    continue
                for name in fac._fields:
                    assert_close(getattr(fac, name)[b], getattr(jfac, name),
                                 rtol=1e-11, atol=1e-13, err_msg=name)
            for name in seg.a2_fac._fields:
                assert_close(getattr(seg.a2_fac, name)[b],
                             getattr(jseg.a2_fac, name), rtol=1e-12,
                             atol=1e-13, err_msg=name)
            assert_close(seg.b1[b].T, jseg.ops.b1, atol=1e-11)
            assert_close(seg.b2[b].T, jseg.ops.b2, atol=1e-11)


def test_a_solver_of_another_plan_raises():
    """Views for a damped plan need the damp set; a curve plan needs its
    segments — each mismatch raises ValueError, as in the JAX package."""
    inst = douglas.prepare_instance(port_cfg(SPEC), port_cfg(SolverConfig(
        n_steps=6)), t64(STRIKES), 100.0, *param_args(P))
    with pytest.raises(ValueError, match="damping"):
        douglas.run_time_loop(inst, port_cfg(SolverConfig(
            n_steps=6, rannacher_steps=2)), P.r_f)
    with pytest.raises(ValueError, match="rate schedule"):
        douglas.run_time_loop(inst, port_cfg(SolverConfig(n_steps=6)),
                              P.r_f, rate_schedule=port_cfg(CURVE))
    with pytest.raises(ValueError, match="engine"):
        douglas.price_option(port_cfg(SPEC), port_cfg(SolverConfig(
            n_steps=6, solver_engine="qr")), t64(STRIKES), 100.0,
            *param_args(P), device=CPU)


def test_barrier_book_is_validated_first():
    """A spot at the barrier raises before the loop, on every engine."""
    spec = port_cfg(GridSpec(m1=14, m2=8, barrier=Barrier("up-out", 100.0)))
    for engine in ("scan", "pallas"):
        with pytest.raises(ValueError, match="knocked out"):
            heston_tpu_torch.price_batch(
                spec, port_cfg(SolverConfig(n_steps=6, solver_engine=engine)),
                t64(STRIKES), 100.0, *param_args(P), device=CPU)


def test_uniform_grid_matches_jax():
    got = grid.make_uniform_grid(12, 7, 100.0, 0.04, 0.0, 300.0, 0.0, 2.0)
    want = jgrid.make_uniform_grid(12, 7, 100.0, 0.04, 0.0, 300.0, 0.0, 2.0)
    assert_close(got.vec_s[0], want.vec_s)
    assert_close(got.vec_v, want.vec_v)
    assert_close(got.dels[0], want.dels)
    assert_close(got.delv, want.delv)


def test_rebuild_variance_and_interp_match_jax():
    """The v-direction rebuilt at another v0, and bilinear interpolation
    of random surfaces on and off the nodes."""
    spec = GridSpec(m1=14, m2=8)
    g = grid.make_grid(port_cfg(spec), 100.0, t64([90.0, 110.0]), 0.04)
    jg = [jgrid.make_grid(spec, 100.0, k, 0.04) for k in (90.0, 110.0)]
    g2 = grid.rebuild_variance(port_cfg(spec), g, 0.07)
    jg2 = jgrid.rebuild_variance(spec, jg[0], 0.07)
    assert_close(g2.vec_v, jg2.vec_v)
    assert_close(g2.delv, jg2.delv)
    assert g2.vec_s is g.vec_s
    u = np.random.default_rng(3).normal(size=(2, 15, 9))
    for s, v in ((100.0, 0.04), (97.3, 0.031), (0.0, 0.0), (900.0, 6.0)):
        got = grid.interp_at(g, t64(u), s, v)
        for b in range(2):
            want = jgrid.interp_at(jg[b], jnp.asarray(u[b].T), s, v)
            assert_close(got[b], want, rtol=0, atol=1e-13)


def test_engine_is_transformable():
    """torch.func.jvp through price_option in the spot, a rate and v0:
    the directional derivative equals a central difference of the
    eager prices (the spot moves the s-grid, v0 the v-grid)."""
    spec, solver, _ = _case("cs_amer_put_rann")
    spec, solver, ks = port_cfg(spec), port_cfg(solver), t64(STRIKES)

    def price(x):
        return douglas._price(spec, solver, ks, x[0], P.kappa, P.eta,
                              P.sigma, P.rho, x[2], P.r_d, x[1], False,
                              port_cfg(GOLDEN_DIVIDENDS), "call", None)

    x = t64([100.0, 0.01, 0.04])
    d = t64([1.0, 0.5, 0.01])
    _, tangent = torch.func.jvp(price, (x,), (d,))
    h = 1e-6
    fd = (price(x + h * d) - price(x - h * d)) / (2 * h)
    assert_close(tangent, fd, rtol=1e-5, atol=1e-6)

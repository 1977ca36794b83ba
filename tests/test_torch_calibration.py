"""heston_tpu_torch.calibrate_device against heston_tpu's
calibrate_device(solver_engine="pallas") — the JAX package's fused
Jacobian and trial pricing in interpret mode — on the American case of
tests/test_pallas.py:198-225 (m1=12, m2=8, N=6, 8 strikes), plus a
two-group ladder, the finite-difference Jacobian and a weighted
objective; and the pieces of the LM step. float64 on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import CalibrationConfig, GridSpec, SolverConfig
from heston_tpu.models import bs as jbs
from heston_tpu.models import calibration as jcal
import heston_tpu_torch
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import calibration as cal

from torch_parity import CPU, assert_close, npy, port_cfg, t64

SEED = 41
SPEC = GridSpec(m1=12, m2=8)
SOLVER = SolverConfig(n_steps=6, a2_variant="upwind", solver_engine="pallas")
STRIKES = np.linspace(85.0, 115.0, 8)
INIT = np.array([1.2, 0.05, 0.4, -0.5, 0.05])


def _market(p):
    return np.asarray(jbs.generate_market_data(100.0, 1.0, p.r_d,
                                               jnp.asarray(STRIKES)))


def _both(p, cfg, **kw):
    """(JAX (theta, info), port (theta, info)) of the same calibration."""
    market = _market(p)
    jkw = dict(kw)
    if jkw.get("weights") is not None:
        jkw["weights"] = jnp.asarray(jkw["weights"])
    want = jcal.calibrate_device(
        SPEC, SOLVER, jnp.asarray(STRIKES), jnp.asarray(market), 100.0,
        jnp.asarray(INIT), p.r_d, p.r_f, cfg=cfg, **jkw)
    got = heston_tpu_torch.calibrate_device(
        port_cfg(SPEC), port_cfg(SOLVER), t64(STRIKES), t64(market), 100.0,
        t64(INIT), p.r_d, p.r_f, cfg=port_cfg(cfg), **kw, device=CPU)
    return want, got


def _check_info(want, got, rtol, atol):
    (wtv, winfo), (gtv, ginfo) = want, got
    assert gtv.dtype == torch.float64 and gtv.shape == (5,)
    np.testing.assert_allclose(npy(gtv), np.asarray(wtv), rtol=rtol,
                               atol=atol)
    assert ginfo["iterations"] == int(winfo["iterations"])
    assert bool(ginfo["converged"]) == bool(winfo["converged"])
    for k in ("error", "lam", "params"):
        np.testing.assert_allclose(npy(ginfo["history"][k]),
                                   np.asarray(winfo["history"][k]),
                                   rtol=rtol, atol=atol, err_msg=k)
    np.testing.assert_array_equal(npy(ginfo["history"]["accepted"]),
                                  np.asarray(winfo["history"]["accepted"]))
    np.testing.assert_allclose(npy(ginfo["fitted_prices"]),
                               np.asarray(winfo["fitted_prices"]),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(ginfo["final_error"]),
                               float(winfo["final_error"]), rtol=rtol,
                               atol=atol)


AD = CalibrationConfig(max_iter=6, tol=1e-10, jacobian_mode="ad")


@pytest.mark.parametrize("case", ["one_group", "two_groups", "weights"])
def test_calibrate_device_matches_jax(params, case, monkeypatch):
    """The AD calibration (forward-mode Jacobian through the time-loop
    kernel, six LM iterations) at the bar of tests/test_pallas.py:224:
    rtol 1e-9, atol 1e-10 on the parameters and the whole history. The
    two-group ladder prices K 85..100 with 3 steps and K 104..115 with 6;
    both packages run it as one launch per pass with per-option step
    counts: one forward-mode loop call per Jacobian pass and one primal
    call per trial pricing (a spy on fused_do.fused_do_loop)."""
    kw = dict(american=True)
    if case == "two_groups":
        kw["group_steps"] = ((0, 4, 3), (4, 8, 6))
    elif case == "weights":
        kw["weights"] = np.random.default_rng(SEED).uniform(0.5, 1.5, 8)
    calls = []
    loop = fused_do.fused_do_loop

    def spy(*args, **loop_kw):
        calls.append(loop_kw.get("tangents") is not None)
        return loop(*args, **loop_kw)

    monkeypatch.setattr(fused_do, "fused_do_loop", spy)
    want, got = _both(params, AD, **kw)
    _check_info(want, got, rtol=1e-9, atol=1e-10)
    iters = got[1]["iterations"]
    assert (calls.count(True), calls.count(False)) == (iters, iters)


def test_calibrate_device_fd_matches_jax(params):
    """The finite-difference Jacobian (six sequential pricing passes per
    iteration). The iterates are held to rtol 1e-5: the 1e-6 bump
    divides the two implementations' ~1e-13 price differences into
    ~1e-7 relative Jacobian differences, which the LM steps carry into
    the parameters. The first residual, priced before any step, agrees at
    1e-12, and the iteration count and accept/reject pattern exactly."""
    cfg = dataclasses.replace(AD, jacobian_mode="fd")
    want, got = _both(params, cfg, american=True)
    _check_info(want, got, rtol=1e-5, atol=1e-8)
    assert_close(got[1]["history"]["error"][0],
                 np.asarray(want[1]["history"]["error"])[0])


def test_calibrate_device_stops_on_convergence(params):
    """A loose tolerance stops the loop at the first iteration whose
    step or error is under it (SSE 0.90 < 1 at the fifth on this coarse
    grid); rows past `iterations` stay NaN."""
    cfg = port_cfg(CalibrationConfig(max_iter=8, tol=1.0,
                                     jacobian_mode="ad"))
    tv, info = heston_tpu_torch.calibrate_device(
        port_cfg(SPEC), port_cfg(SOLVER), t64(STRIKES), t64(_market(params)),
        100.0, t64(INIT), params.r_d, params.r_f, cfg=cfg, device=CPU)
    it = info["iterations"]
    assert bool(info["converged"]) and 1 <= it < cfg.max_iter
    hist = info["history"]
    assert torch.isfinite(hist["error"][:it]).all()
    assert torch.isnan(hist["error"][it:]).all()
    assert torch.equal(hist["params"][it - 1], tv)
    assert torch.isfinite(tv).all()


def test_jacobian_and_prices_ad_matches_jax(params):
    """The fused branch of jacobian_and_prices_ad: (J, base) in the JAX
    package's order, at the bar of tests/test_pallas.py:165-167."""
    tv = np.array([1.3, 0.05, 0.35, -0.7, 0.045])
    wj, wb = jcal.jacobian_and_prices_ad(
        SPEC, SOLVER, jnp.asarray(STRIKES), 100.0, jnp.asarray(tv),
        params.r_d, params.r_f, american=True)
    gj, gb = cal.jacobian_and_prices_ad(
        port_cfg(SPEC), port_cfg(SOLVER), t64(STRIKES), 100.0, t64(tv),
        params.r_d, params.r_f, american=True, device=CPU)
    assert_close(gb, wb, rtol=0, atol=1e-11)
    assert_close(gj, wj, rtol=0, atol=1e-9)


@pytest.mark.parametrize("v0_mode", ["stencil", "ad"])
def test_jacobian_and_prices_ad_runs_the_fused_jacobian(params, v0_mode):
    """jacobian_and_prices_ad is fused_theta_jacobian in the JAX package's
    order (J, base), bitwise, for either v0_mode, a damped solver
    included (the tangent state handed from the damp launch to the main
    one; the JAX Jacobians themselves are held in
    tests/test_torch_curves.py and tests/test_torch_fused_do.py)."""
    tv = t64([1.3, 0.05, 0.35, -0.7, 0.045])
    solver = port_cfg(dataclasses.replace(SOLVER, n_steps=3,
                                          rannacher_steps=2))
    args = (port_cfg(GridSpec(m1=8, m2=6)), solver, t64(STRIKES[:3]), 100.0,
            tv, params.r_d, params.r_f)
    gj, gb = cal.jacobian_and_prices_ad(*args, american=True,
                                        v0_mode=v0_mode, device=CPU)
    base, jac = fused_do.fused_theta_jacobian(*args, american=True,
                                              v0_mode=v0_mode)
    assert torch.equal(gb, base) and torch.equal(gj, jac)


def test_lm_update_and_clamps_match_jax():
    rng = np.random.default_rng(SEED)
    jac = rng.normal(size=(12, 5))
    res = rng.normal(size=12)
    w = rng.uniform(0.5, 2.0, 12)
    for weights in (None, w):
        got = cal.lm_update(t64(jac), t64(res), 0.01,
                            None if weights is None else t64(weights))
        want = jcal.lm_update(jnp.asarray(jac), jnp.asarray(res), 0.01,
                              None if weights is None
                              else jnp.asarray(weights))
        assert_close(got, want)
    cfg = CalibrationConfig()
    vec = np.array([-1.0, 0.001, 0.5, -1.7, 0.0])
    want = jcal.clamp_params(vec, cfg)
    np.testing.assert_array_equal(cal.clamp_params(vec, port_cfg(cfg)),
                                  want)
    np.testing.assert_array_equal(
        npy(cal.clamp_params_tensor(t64(vec), port_cfg(cfg))), want)
    np.testing.assert_array_equal(
        np.asarray(jcal._clamp_vec_traced(jnp.asarray(vec), cfg)), want)


@pytest.mark.parametrize("groups,n,n_steps,ok", [
    ((), 5, None, True),
    (((0, 2, 3), (2, 5, 6)), 5, 6, True),
    (((0, 2, 3), (3, 5, 6)), 5, None, False),     # gap
    (((0, 2, 3), (2, 4, 6)), 5, None, False),     # short
    (((0, 2, 3), (2, 5, 6)), 5, 5, False),        # n_steps != max
])
def test_validate_group_steps_matches_jax(groups, n, n_steps, ok):
    for fn in (jcal.validate_group_steps, cal.validate_group_steps):
        if ok:
            fn(groups, n, n_steps)
        else:
            with pytest.raises(ValueError):
                fn(groups, n, n_steps)


@pytest.mark.parametrize("option_type,dividends", [
    ("call", False), ("put", True)])
def test_vega_weights_and_groups_match_jax(params, option_type, dividends):
    """1/vega^2 weights of a two-maturity chain (puts through parity, the
    escrowed-dividend spot) at 1e-10, and the maturity groups."""
    from heston_tpu.config import GOLDEN_DIVIDENDS

    ks = np.tile(np.linspace(80.0, 120.0, 5), 2)
    ts = np.repeat([0.5, 1.0], 5)
    div = GOLDEN_DIVIDENDS if dividends else None
    prices = np.concatenate([
        np.asarray(jbs.generate_market_data(100.0, t, params.r_d,
                                            jnp.asarray(ks[:5]), vol=0.25,
                                            option_type=option_type))
        for t in (0.5, 1.0)])
    base = dict(strikes=ks, maturities=ts, prices=prices, s0=100.0,
                r_d=params.r_d, option_type=option_type)
    want = jcal.vega_weights(jcal.CalibrationTargets(**base, dividends=div))
    targets = cal.CalibrationTargets(**base, dividends=port_cfg(div))
    np.testing.assert_allclose(cal.vega_weights(targets), want, rtol=1e-10,
                               atol=1e-10)
    wg = jcal.CalibrationTargets(**base).groups()
    gg = targets.groups()
    assert [t for t, _ in gg] == [t for t, _ in wg]
    for (_, gi), (_, wi) in zip(gg, wg):
        np.testing.assert_array_equal(gi, wi)


@pytest.mark.parametrize("kw,err,match", [
    (dict(pricer="cf"), NotImplementedError, "ROADMAP A7"),
    (dict(pricer="mc"), ValueError, "pricer"),
    (dict(engine="scan"), None, None),
    (dict(weights=np.ones(3)), ValueError, "weights"),
])
def test_calibrate_device_out_of_slice(params, kw, err, match):
    """Raises where the JAX package raises. The "scan" engine runs the
    eager loop (the Jacobian linearized per maturity group, the trial
    prices eager) and equals the JAX package's at 1e-8, a two-group
    ladder with the FD Jacobian."""
    engine = kw.pop("engine", "pallas")
    solver = dataclasses.replace(SOLVER, solver_engine=engine)
    if err is not None:
        with pytest.raises(err, match=match):
            heston_tpu_torch.calibrate_device(
                port_cfg(SPEC), port_cfg(solver), t64(STRIKES),
                t64(_market(params)), 100.0, t64(INIT), params.r_d,
                params.r_f, cfg=port_cfg(AD), **kw, device=CPU)
        return
    market = _market(params)
    out = []
    for cfg, groups in ((dataclasses.replace(AD, max_iter=3), ()),
                        (CalibrationConfig(max_iter=3, tol=1e-10, eps=1e-3,
                                           jacobian_mode="fd"),
                         ((0, 4, 3), (4, 8, 6)))):
        want = jcal.calibrate_device(
            SPEC, solver, jnp.asarray(STRIKES), jnp.asarray(market), 100.0,
            jnp.asarray(INIT), params.r_d, params.r_f, cfg=cfg,
            group_steps=groups)
        got = heston_tpu_torch.calibrate_device(
            port_cfg(SPEC), port_cfg(solver), t64(STRIKES), t64(market),
            100.0, t64(INIT), params.r_d, params.r_f, cfg=port_cfg(cfg),
            group_steps=groups, device=CPU)
        _check_info(want, got, rtol=1e-8, atol=1e-8)
        out.append(got)
    assert all(g[1]["iterations"] == 3 for g in out)

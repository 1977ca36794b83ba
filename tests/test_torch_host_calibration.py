"""The Jacobians, greeks and the host calibration loop of heston_tpu_torch
on the eager ADI loop, against the JAX package, in float64 on the CPU:
jacobian_and_prices_ad's XLA path (both v0 modes, curve books, "scan" and
"pcr") at atol 1e-9 (tests/test_pallas.py:103), the FD Jacobian and the
base prices, price_and_greeks on the linearized eager loop (its "pallas"
branch is held in tests/test_torch_greeks.py) and batch_greeks on the
eager loop at rtol 1e-9 / atol 1e-10 (tests/test_greeks.py:50-63), and
`calibrate` — the same iterations, the same accepted and rejected steps,
parameters within 1e-8 — with its checkpoints, which resume across the
two packages. The FD cases take eps = 1e-3: the FD quotient scales the
engines' 1e-13 price agreement (the grids' sinh nodes differ by ulps
between XLA and PyTorch) by 1/eps, which the default 1e-6 would lift to
1e-7. Each JAX reference runs once per
module (`functools.cache`)."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, CalibrationConfig, GridSpec,
                               HestonParams, RateSchedule, SolverConfig)
from heston_tpu.models import bs as jbs
from heston_tpu.models import calibration as jcal
from heston_tpu.models import greeks as jgreeks
from heston_tpu.utils import checkpoint as jcheckpoint
import heston_tpu_torch
from heston_tpu_torch.models import calibration as cal
from heston_tpu_torch.models import greeks
from heston_tpu_torch.utils import checkpoint

from torch_parity import CPU, assert_close, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

P = HestonParams()
SPEC = GridSpec(m1=10, m2=6)
STRIKES = np.linspace(85.0, 115.0, 6)
THETA = np.array([1.5, 0.04, 0.3, -0.9, 0.04])
CURVE = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.01))
AMER_DIV = dict(american=True, dividends=GOLDEN_DIVIDENDS)
INIT = HestonParams(kappa=1.0, eta=0.05, sigma=0.4, rho=-0.5, v0=0.05)


def _solver(engine="scan", n=4, **kw):
    return SolverConfig(n_steps=n, solver_engine=engine, **kw)


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


# ---------------------------------------------------------------------------
# Jacobians
# ---------------------------------------------------------------------------

# (engine, v0_mode, keywords, rannacher_steps)
JAC_CASES = {
    "scan_stencil_amer_div_curve_rann": (
        "scan", "stencil", dict(AMER_DIV, rate_schedule=CURVE), 2),
    "pcr_ad_put": ("pcr", "ad", dict(option_type="put"), 0),
}


@functools.cache
def _jax_jacobian(case):
    engine, mode, kw, rann = JAC_CASES[case]
    jac, base = jcal.jacobian_and_prices_ad(
        SPEC, _solver(engine, rannacher_steps=rann), jnp.asarray(STRIKES),
        100.0, jnp.asarray(THETA), P.r_d, P.r_f, v0_mode=mode, **kw)
    return np.asarray(jac), np.asarray(base)


@pytest.mark.parametrize("case", sorted(JAC_CASES))
def test_jacobian_and_prices_ad_eager_matches_jax(case):
    """The eager loop linearized (torch.func.jvp under vmap over the
    directions): a damped curve book and a put book. A curve book under
    "pallas" takes the same path (tests/test_torch_price_batch.py)."""
    engine, mode, kw, rann = JAC_CASES[case]
    jac, base = cal.jacobian_and_prices_ad(
        port_cfg(SPEC), port_cfg(_solver(engine, rannacher_steps=rann)),
        t64(STRIKES), 100.0, t64(THETA), P.r_d, P.r_f, v0_mode=mode,
        **_port_kw(kw), device=CPU)
    want_jac, want_base = _jax_jacobian(case)
    assert jac.shape == (len(STRIKES), 5)
    assert_close(base, want_base, rtol=0, atol=1e-12)
    assert_close(jac, want_jac, rtol=0, atol=1e-9)


@functools.cache
def _jax_fd():
    jac, base = jcal.jacobian_and_prices(
        SPEC, _solver(), jnp.asarray(STRIKES), 100.0, jnp.asarray(THETA),
        P.r_d, P.r_f, eps=1e-3, **AMER_DIV)
    prices = jcal.base_prices(SPEC, _solver(), jnp.asarray(STRIKES), 100.0,
                              jnp.asarray(THETA), P.r_d, P.r_f, **AMER_DIV)
    return np.asarray(jac), np.asarray(base), np.asarray(prices)


def test_fd_jacobian_and_base_prices_match_jax():
    """Six pricing passes of the eager loop (base and the five bumps),
    lane for lane the JAX package's vmap over bumps and strikes."""
    jac, base = cal.jacobian_and_prices(
        port_cfg(SPEC), port_cfg(_solver()), t64(STRIKES), 100.0,
        t64(THETA), P.r_d, P.r_f, eps=1e-3, **_port_kw(AMER_DIV),
        device=CPU)
    prices = cal.base_prices(port_cfg(SPEC), port_cfg(_solver()),
                             t64(STRIKES), 100.0, t64(THETA), P.r_d, P.r_f,
                             **_port_kw(AMER_DIV), device=CPU)
    want_jac, want_base, want_prices = _jax_fd()
    assert_close(base, want_base, rtol=0, atol=1e-12)
    assert_close(prices, want_prices, rtol=0, atol=1e-12)
    assert_close(jac, want_jac, rtol=0, atol=1e-9)
    assert_close(cal._bumped_param_matrix(t64(THETA), 1e-3),
                 jcal._bumped_param_matrix(jnp.asarray(THETA), 1e-3))


# ---------------------------------------------------------------------------
# greeks
# ---------------------------------------------------------------------------

# (engine, keywords): the linearized eager loop; the "pallas" branch is
# held against the JAX package's "scan" branch in tests/test_torch_greeks.py
PAG_CASES = {
    "scan_amer_div": ("scan", AMER_DIV),
    "scan_amer_div_curve": ("scan", dict(AMER_DIV, rate_schedule=CURVE)),
}


@functools.cache
def _jax_price_and_greeks(case):
    engine, kw = PAG_CASES[case]
    out = jgreeks.price_and_greeks(SPEC, _solver(engine), 100.0, 100.0,
                                   *param_args(P), **kw)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("case", sorted(PAG_CASES))
def test_price_and_greeks_matches_jax(case):
    """Every key, the at-the-money spot node's kink included (delta
    splits it as jnp.maximum does); a curve book has no rate rhos."""
    engine, kw = PAG_CASES[case]
    got = greeks.price_and_greeks(
        port_cfg(SPEC), port_cfg(_solver(engine)), t64(100.0), 100.0,
        *param_args(P), **_port_kw(kw), device=CPU)
    want = _jax_price_and_greeks(case)
    assert set(got) == set(want)
    assert ("rho_rd" in got) == ("rate_schedule" not in kw)
    for k in want:
        assert got[k].dim() == 0, k
        assert_close(got[k], want[k], rtol=1e-9, atol=1e-10, err_msg=k)


@functools.cache
def _jax_curve_risk():
    out = jgreeks.batch_greeks(SPEC, _solver(), jnp.asarray(STRIKES), 100.0,
                               *param_args(P), american=True,
                               rate_schedule=CURVE, param_jacobian=True)
    return {k: np.asarray(v) for k, v in out.items()}


def test_batch_greeks_scan_curve_book_matches_jax():
    """Book risk off the eager loop's surfaces and multipliers, with the
    curve book's parameter Jacobian (the eager loop linearized)."""
    got = heston_tpu_torch.batch_greeks(
        port_cfg(SPEC), port_cfg(_solver()), t64(STRIKES), 100.0,
        *param_args(P), american=True, rate_schedule=port_cfg(CURVE),
        param_jacobian=True, device=CPU)
    want = _jax_curve_risk()
    assert set(got) == set(want)
    for k in want:
        assert_close(got[k], want[k], rtol=1e-9, atol=1e-10, err_msg=k)


# ---------------------------------------------------------------------------
# the host LM loop
# ---------------------------------------------------------------------------

def _chain(multi: bool, weights: bool):
    """A BS-priced chain at 6 strikes, one maturity (American with the
    golden dividends, the FD Jacobian test's book) or two (European)."""
    ts = np.repeat([0.5, 1.0], 3) if multi else np.ones(6)
    prices = np.concatenate([np.asarray(jbs.generate_market_data(
        100.0, t, P.r_d, jnp.asarray(STRIKES[ts == t]), vol=0.25))
        for t in sorted(set(ts))])
    w = np.linspace(0.5, 1.5, 6) if weights else None
    kw = {} if multi else AMER_DIV
    return dict(strikes=STRIKES, maturities=ts, prices=prices, s0=100.0,
                r_d=P.r_d, r_f=P.r_f, weights=w, **kw)


# (engine, jacobian_mode, multi-maturity, weights, max_iter)
CAL_CASES = {
    "fd_single": ("scan", "fd", False, False, 4),
    "fd_multi_weights": ("pcr", "fd", True, True, 3),
    "ad_pallas_multi_weights": ("pallas", "ad", True, True, 2),
}


def _cal_cfg(mode, max_iter):
    return CalibrationConfig(max_iter=max_iter, tol=1e-10, eps=1e-3,
                             jacobian_mode=mode)


@functools.cache
def _jax_calibrate(case):
    engine, mode, multi, weights, max_iter = CAL_CASES[case]
    return jcal.calibrate(
        jcal.CalibrationTargets(**_chain(multi, weights)), SPEC,
        _solver(engine), INIT, _cal_cfg(mode, max_iter),
        )


def _port_calibrate(case, max_iter=None, **kw):
    engine, mode, multi, weights, n_it = CAL_CASES[case]
    return heston_tpu_torch.calibrate(
        cal.CalibrationTargets(**_chain(multi, weights)), port_cfg(SPEC),
        port_cfg(_solver(engine)), port_cfg(INIT),
        port_cfg(_cal_cfg(mode, max_iter or n_it)), device=CPU, **kw)


def _check_run(got, want, atol=1e-8):
    assert got.iterations == want.iterations
    assert got.converged == want.converged
    assert ([h["accepted"] for h in got.history]
            == [h["accepted"] for h in want.history])
    np.testing.assert_allclose(np.array(got.params.bumpable()),
                               np.array(want.params.bumpable()), rtol=0,
                               atol=atol)
    np.testing.assert_allclose(got.final_error, want.final_error,
                               rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(got.fitted_prices, want.fitted_prices,
                               rtol=1e-8, atol=1e-10)
    assert got.total_pde_solves == want.total_pde_solves


@pytest.mark.parametrize("case", sorted(CAL_CASES))
def test_calibrate_matches_jax(case):
    got = _port_calibrate(case)
    want = _jax_calibrate(case)
    _check_run(got, want)
    assert isinstance(got.params, heston_tpu_torch.HestonParams)
    assert any(not h["accepted"] for h in got.history) or got.converged \
        or got.iterations == CAL_CASES[case][4]


def test_calibrate_uses_the_eager_loop_for_trial_prices(monkeypatch):
    """Under "pallas" with "ad": the Jacobian through the forward-mode
    kernel once per pass and maturity group, the trial prices through the
    eager loop, as the JAX package runs them."""
    from heston_tpu_torch.kernels import fused_do
    from heston_tpu_torch.models import douglas

    calls = {"jac": 0, "eager": 0}
    jac, run = fused_do.fused_theta_jacobian, douglas._run

    def count_jac(*a, **k):
        calls["jac"] += 1
        return jac(*a, **k)

    def count_eager(*a, **k):
        calls["eager"] += 1
        return run(*a, **k)

    monkeypatch.setattr(fused_do, "fused_theta_jacobian", count_jac)
    monkeypatch.setattr(douglas, "_run", count_eager)
    res = _port_calibrate("ad_pallas_multi_weights")
    assert calls["jac"] == 2 * res.iterations      # two maturity groups
    assert calls["eager"] == 2 * sum(1 for h in res.history
                                     if "new_sse" in h)


def test_lm_host_loop_with_a_stub_step():
    """The accept/reject schedule on a linear least-squares problem: the
    first step lands on the optimum (accepted, lambda down), the next
    one's error is zero (converged); the trial error is weighted."""
    target = np.array([1.0, 0.1, 0.3, -0.4, 0.05])

    def eval_step(tv, lam):
        resid = target - tv
        return resid, tv.copy(), float(resid @ resid)

    def eval_prices(tv):
        return tv.copy()

    cfg = port_cfg(CalibrationConfig(max_iter=5, tol=1e-12))
    state = checkpoint.LMState.fresh(port_cfg(INIT), cfg.lambda_init)
    tv, lam, iters, err, conv, hist, fitted = cal.lm_host_loop(
        target, cfg, state, eval_step, eval_prices, weights=np.full(5, 2.0))
    np.testing.assert_allclose(tv, target)
    assert (iters, conv) == (2, True)
    assert [h["accepted"] for h in hist] == [True, True]
    assert lam == cfg.lambda_init * cfg.lambda_down
    assert hist[0]["new_sse"] == 0.0 and err == 0.0
    np.testing.assert_allclose(fitted, target)


def test_checkpoint_round_trip(tmp_path):
    st = checkpoint.LMState.fresh(heston_tpu_torch.HestonParams(), 0.01)
    st.history.append({"iter": 1, "sse": 2.0})
    st.iteration = 1
    st2 = checkpoint.LMState.load(st.save(tmp_path / "ck.json"))
    np.testing.assert_array_equal(st2.theta_vec, st.theta_vec)
    assert st2.iteration == 1 and st2.history == st.history
    assert checkpoint.LMState.load(jcheckpoint.LMState.fresh(
        P, 0.01).save(tmp_path / "j.json")).lam == 0.01


def test_resume_reproduces_the_uninterrupted_run(tmp_path):
    """Two iterations with a checkpoint, then a resume to four, equal the
    four-iteration run; a finished checkpoint reprices its parameters."""
    ck = tmp_path / "lm.json"
    full = _port_calibrate("fd_single")
    _port_calibrate("fd_single", max_iter=2, checkpoint_path=str(ck))
    assert json.loads(ck.read_text())["iteration"] == 2
    resumed = _port_calibrate("fd_single", checkpoint_path=str(ck))
    _check_run(resumed, full, atol=1e-12)
    again = _port_calibrate("fd_single", checkpoint_path=str(ck))
    assert again.iterations == full.iterations
    np.testing.assert_allclose(again.fitted_prices, full.fitted_prices,
                               atol=1e-12)


def test_checkpoint_rejects_a_foreign_problem(tmp_path):
    ck = str(tmp_path / "lm.json")
    _port_calibrate("fd_single", max_iter=1, checkpoint_path=ck)
    engine, mode, _, _, _ = CAL_CASES["fd_single"]
    other = dict(_chain(False, False), strikes=STRIKES + 1.0)
    with pytest.raises(ValueError, match="different"):
        heston_tpu_torch.calibrate(
            cal.CalibrationTargets(**other), port_cfg(SPEC),
            port_cfg(_solver(engine)), port_cfg(INIT),
            port_cfg(_cal_cfg(mode, 4)), checkpoint_path=ck, device=CPU)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's calibrate writes two iterations; the port's
    resumes them to four and lands on the JAX package's four-iteration
    run. The problem keys are equal: tensors and arrays enter by value,
    the configurations by their repr."""
    ck = str(tmp_path / "lm.json")
    engine, mode, multi, weights, _ = CAL_CASES["fd_single"]
    jcal.calibrate(jcal.CalibrationTargets(**_chain(multi, weights)), SPEC,
                   _solver(engine), INIT, _cal_cfg(mode, 2),
                   checkpoint_path=ck)
    stored = json.loads(open(ck).read())
    c = _chain(multi, weights)
    parts = (c["strikes"], c["prices"], c["maturities"], c["s0"], c["r_d"],
             c["r_f"], True, "call")
    assert stored["key"] == checkpoint.problem_key(
        t64(c["strikes"]), *parts[1:], port_cfg(SPEC),
        port_cfg(_solver(engine)), 4, None)
    assert stored["key"] == jcheckpoint.problem_key(
        *parts, SPEC, _solver(engine), 4, None)
    resumed = _port_calibrate("fd_single", checkpoint_path=ck)
    _check_run(resumed, _jax_calibrate("fd_single"))


def test_calibrate_validates_weights():
    bad = dict(_chain(False, False), weights=-np.ones(6))
    with pytest.raises(ValueError, match="weights"):
        heston_tpu_torch.calibrate(
            cal.CalibrationTargets(**bad), port_cfg(SPEC),
            port_cfg(_solver()), port_cfg(INIT), device=CPU)


def test_calibrate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        heston_tpu_torch.calibrate(
            cal.CalibrationTargets(**_chain(False, False)), port_cfg(SPEC),
            port_cfg(_solver()), port_cfg(INIT))

"""heston_tpu_torch.price_batch against heston_tpu: whole-slice parity in
float64, the scheme pins, the float32 accuracy of the plain path, the
options outside the slice, the device default, and an import that loads
neither JAX nor the JAX package."""

import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, Barrier, GridSpec,
                               RateSchedule, SolverConfig)
from heston_tpu.models import douglas as jdouglas
from heston_tpu.pallas import fused_do as jfd
import heston_tpu_torch
from heston_tpu_torch.convert import params_from_jax
from heston_tpu_torch.kernels import fused_do, fused_single

from torch_parity import CPU, npy, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


def port_kw(kw):
    """Keyword arguments with the JAX package's config objects swapped for
    the port's."""
    return {k: port_cfg(v) for k, v in kw.items()}
FLAGSHIP_SPEC = GridSpec(m1=50, m2=25)
FLAGSHIP = SolverConfig(n_steps=20, theta=0.8, maturity=1.0,
                        a2_variant="upwind", solver_engine="pallas")
ARMS = {
    "euro": {},
    "amer": dict(american=True),
    "div": dict(dividends=GOLDEN_DIVIDENDS),
    "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS),
}
# the JAX package's own interpret-mode float32 budgets per arm
# (tests/test_precision.py ARM_BUDGETS)
F32_BUDGETS = {"euro": 2.5e-5, "amer": 5e-5, "div": 2.5e-5,
               "amer_div": 6e-5}


# the setup of tests/test_precision.py: 16 strikes in [75, 125]
FLAGSHIP_STRIKES = np.linspace(75.0, 125.0, 16)


def _jax_fused(spec, solver, strikes, p, **kw):
    """The fused kernel's prices in interpret mode."""
    return np.asarray(jax.jit(lambda k: jfd.fused_price_batch(
        spec, solver, k, 100.0, *param_args(p), interpret=True, **kw))(
            jnp.asarray(strikes)))


def _jax_scan(spec, solver, strikes, p, **kw):
    """The XLA scan engine's prices."""
    return np.asarray(jdouglas.price_batch(
        spec, dataclasses.replace(solver, solver_engine="scan"),
        jnp.asarray(strikes), 100.0, *param_args(p), **kw))


def _jax_prices(spec, solver, strikes, p, **kw):
    """(fused kernel in interpret mode, XLA scan engine) prices."""
    return (_jax_fused(spec, solver, strikes, p, **kw),
            _jax_scan(spec, solver, strikes, p, **kw))


@functools.cache
def _flagship_scan(arm, p):
    """The scan engine's float64 prices of the flagship setup at
    FLAGSHIP_STRIKES, shared by the flagship parity test and the float32
    budget tests."""
    return _jax_scan(FLAGSHIP_SPEC, FLAGSHIP, FLAGSHIP_STRIKES, p,
                     **ARMS[arm])


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_price_batch_matches_jax_small_grid(params, arm):
    spec = GridSpec(m1=10, m2=8)
    solver = SolverConfig(n_steps=4, a2_variant="upwind",
                          solver_engine="pallas")
    strikes = np.random.default_rng(11).uniform(75.0, 125.0, 6)
    got = npy(heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(solver), t64(strikes), 100.0,
        *param_args(params), **port_kw(ARMS[arm]), device=CPU))
    fused, scan = _jax_prices(spec, solver, strikes, params, **ARMS[arm])
    np.testing.assert_allclose(got, fused, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, scan, rtol=0, atol=1e-10)


def test_price_batch_matches_jax_flagship(params):
    """The flagship call (__graft_entry__.py: American calls, golden
    dividends, 50 x 25 x 20, theta 0.8, upwind A2) at B = 16
    (FLAGSHIP_STRIKES)."""
    kw = ARMS["amer_div"]
    got = npy(heston_tpu_torch.price_batch(
        port_cfg(FLAGSHIP_SPEC), port_cfg(FLAGSHIP), t64(FLAGSHIP_STRIKES),
        100.0, *param_args(params), **port_kw(kw), device=CPU))
    fused = _jax_fused(FLAGSHIP_SPEC, FLAGSHIP, FLAGSHIP_STRIKES, params,
                       **kw)
    scan = _flagship_scan("amer_div", params)
    np.testing.assert_allclose(got, fused, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, scan, rtol=0, atol=1e-10)


@pytest.mark.parametrize("strike,kw,pin", [
    (95.0, dict(american=True, dividends=GOLDEN_DIVIDENDS),
     8.510573074266677),                 # tests/test_douglas.py:52
    (100.0, dict(dividends=GOLDEN_DIVIDENDS), 3.85096222593301),   # :51
])
def test_scheme_pins(params, strike, kw, pin):
    got = heston_tpu_torch.price_batch_params(
        port_cfg(FLAGSHIP_SPEC), port_cfg(FLAGSHIP), t64([strike]), 100.0,
        port_cfg(params), **port_kw(kw), device=CPU)
    assert abs(float(got[0]) - pin) < 1e-10


@pytest.mark.parametrize("arm", sorted(F32_BUDGETS))
def test_plain_f32_rmse_within_jax_budget(params, arm):
    """The plain float32 path against JAX float64, on the setup of
    tests/test_precision.py (50 x 25 x 20, 16 strikes in [75, 125]), held
    to the JAX package's interpret-mode float32 budget of each arm. It
    shows the delta form and the compensated update were carried over."""
    kw = ARMS[arm]
    want = _flagship_scan(arm, params)
    got = heston_tpu_torch.price_batch(
        port_cfg(FLAGSHIP_SPEC), port_cfg(FLAGSHIP),
        torch.tensor(FLAGSHIP_STRIKES, dtype=torch.float32), 100.0,
        *param_args(params), **port_kw(kw), device=CPU)
    assert got.dtype == torch.float32
    rmse = float(np.sqrt(np.mean((npy(got).astype(np.float64) - want) ** 2)))
    assert rmse < F32_BUDGETS[arm], (arm, rmse)


def test_batch_of_one_goes_through_the_batched_path(params):
    """It does not: a batch of one goes through the single-option kernel's
    plain version (PCR along s, its own order of arithmetic), so its price
    is not the book's bit for bit, but equals the same strike inside a
    book on the batched kernel's plain version within 1e-10 (the JAX
    package's bar, tests/test_pallas.py:410)."""
    kw = port_kw(ARMS["amer_div"])
    args = (port_cfg(FLAGSHIP_SPEC), port_cfg(FLAGSHIP))
    book = heston_tpu_torch.price_batch(
        *args, t64([90.0, 100.0, 110.0]), 100.0, *param_args(params), **kw,
        device=CPU)
    one = heston_tpu_torch.price_batch(
        *args, t64([100.0]), 100.0, *param_args(params), **kw, device=CPU)
    single = fused_single.fused_price_single(
        *args, t64([100.0]), 100.0, *param_args(params), **kw)
    assert one.shape == (1,)
    assert torch.equal(one, single)
    assert not torch.equal(one[0], book[1])
    np.testing.assert_allclose(npy(one[0]), npy(book[1]), rtol=1e-10)


RANNACHER_ARMS = {
    "rann": dict(rannacher_steps=2),
    "rann_amer_div": dict(rannacher_steps=2, american=True,
                          dividends=GOLDEN_DIVIDENDS),
    "rann_past_maturity": dict(rannacher_steps=9, american=True),
}


@pytest.mark.parametrize("arm", sorted(RANNACHER_ARMS))
def test_rannacher_book_matches_jax(params, arm):
    """A book with Rannacher start-up damping on the batched route (a damp
    launch at theta = 1 and delta_t/2, then the main launch, lambda
    carried across) against JAX's fused kernel in interpret mode and its
    scan engine, at 1e-10. rannacher_steps past n_steps damps the whole
    horizon in one launch."""
    kw = dict(RANNACHER_ARMS[arm])
    spec = GridSpec(m1=10, m2=8)
    solver = SolverConfig(n_steps=6, a2_variant="upwind",
                          solver_engine="pallas",
                          rannacher_steps=kw.pop("rannacher_steps"))
    strikes = np.random.default_rng(5).uniform(80.0, 120.0, 4)
    got = npy(heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(solver), t64(strikes), 100.0,
        *param_args(params), **port_kw(kw), device=CPU))
    fused, scan = _jax_prices(spec, solver, strikes, params, **kw)
    np.testing.assert_allclose(got, fused, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, scan, rtol=0, atol=1e-10)


def test_params_from_jax(params):
    """The JAX theta_vec convention (kappa, eta, sigma, rho, v0) + rates
    as tensors; pricing with them equals pricing with the floats."""
    tv = np.array([params.kappa, params.eta, params.sigma, params.rho,
                   params.v0])
    pt = params_from_jax(tv, params.r_d, params.r_f)
    assert [float(pt[k]) for k in ("kappa", "eta", "sigma", "rho", "v0",
                                   "r_d", "r_f")] == list(param_args(params))
    assert all(t.dtype == torch.float64 and t.dim() == 0
               for t in pt.values())
    spec = heston_tpu_torch.GridSpec(m1=10, m2=8)
    solver = heston_tpu_torch.SolverConfig(n_steps=4, solver_engine="pallas")
    ks = t64([90.0, 110.0])
    kw = port_kw(ARMS["amer_div"])
    got = heston_tpu_torch.price_batch(spec, solver, ks, 100.0, **pt, **kw,
                                       device=CPU)
    want = heston_tpu_torch.price_batch(spec, solver, ks, 100.0,
                                        *param_args(params), **kw,
                                        device=CPU)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)
    with pytest.raises(ValueError):
        params_from_jax(tv[:4], 0.025, 0.0)


JCURVE = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.0))
CURVE = port_cfg(JCURVE)
# What the JAX package runs off the fused kernels — another engine, the AD
# Jacobian of a curve book (its XLA linearize path) — runs on the port's
# eager loop and equals the JAX package's; a curve with per-lane step
# counts raises ValueError, as in JAX (heston_tpu/pallas/fused_do.py:
# 1807-1810). Each case: (entry point, solver keywords, keywords, the
# exception and its match, or None for a parity case). Rannacher, puts,
# digitals, barriers and curves also price on the kernels, and the
# damped Jacobian runs (tests/test_torch_curves.py)
OUT_OF_SLICE = {
    "engine_scan": ("price", dict(solver_engine="scan"), {}, None),
    "engine_pcr": ("price", dict(solver_engine="pcr"), {}, None),
    "rannacher": ("calibrate", dict(rannacher_steps=2, solver_engine="pcr"),
                  {}, None),
    "put": ("per_lane", {}, dict(option_type="put", rate_schedule=JCURVE),
            (ValueError, "per-lane")),
    "digital_call": ("jacobian", dict(rannacher_steps=2),
                     dict(option_type="digital_call", rate_schedule=JCURVE),
                     None),
    "digital_put": ("price", dict(solver_engine="scan"),
                    dict(option_type="digital_put"), None),
    "rate_schedule": ("jacobian", {}, dict(rate_schedule=JCURVE), None),
    "barrier": ("price", dict(solver_engine="scan"),
                dict(barrier=Barrier("up-out", 150.0), rate_schedule=JCURVE),
                None),
}
OUT_OF_SLICE_THETA = np.array([1.2, 0.05, 0.4, -0.5, 0.05])
OUT_OF_SLICE_CFG = dict(max_iter=3, jacobian_mode="ad")


def _out_of_slice_run(case, params, jax_side: bool):
    """The case's entry point on the JAX package or on the port (float64,
    the CPU): prices [B], (J, base) or (theta, info)."""
    call, solver_kw, kw, _ = OUT_OF_SLICE[case]
    kw = dict(kw)
    solver = dataclasses.replace(FLAGSHIP, **solver_kw)
    spec = GridSpec(m1=10, m2=8, barrier=kw.pop("barrier", None))
    ks = [95.0, 105.0]
    if jax_side:
        from heston_tpu.config import CalibrationConfig
        from heston_tpu.models import calibration as jcal

        ks = jnp.asarray(ks)
        theta = jnp.asarray(OUT_OF_SLICE_THETA)
        if call == "calibrate":
            return jcal.calibrate_device(
                spec, solver, ks, jnp.asarray([8.0, 3.0]), 100.0, theta,
                0.025, 0.0, cfg=CalibrationConfig(**OUT_OF_SLICE_CFG), **kw)
        if call == "jacobian":
            return jcal.jacobian_and_prices_ad(spec, solver, ks, 100.0, theta,
                                               0.025, 0.0, **kw)
        return jdouglas.price_batch(spec, solver, ks[:1], 100.0,
                                    *param_args(params), **kw)
    spec, solver, kw = port_cfg(spec), port_cfg(solver), port_kw(kw)
    theta = t64(OUT_OF_SLICE_THETA)
    if call == "calibrate":
        return heston_tpu_torch.calibrate_device(
            spec, solver, t64(ks), t64([8.0, 3.0]), 100.0, theta, 0.025, 0.0,
            cfg=heston_tpu_torch.CalibrationConfig(**OUT_OF_SLICE_CFG),
            device=CPU, **kw)
    if call == "jacobian":
        return heston_tpu_torch.models.calibration.jacobian_and_prices_ad(
            spec, solver, t64(ks), 100.0, theta, 0.025, 0.0, device=CPU,
            **kw)
    if call == "per_lane":
        return fused_do.fused_price_batch(
            spec, solver, t64(ks), 100.0, *param_args(params),
            n_steps_per=[10, 20], **kw)
    return heston_tpu_torch.price_batch(spec, solver, t64(ks[:1]), 100.0,
                                        *param_args(params), **kw,
                                        device=CPU)


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_out_of_slice_raises(params, case):
    """Each case raises only where the JAX package raises; the others
    equal the JAX package: prices at 1e-12 ("pcr" at 1e-9, its
    recurrences in another order), Jacobians at 1e-9
    (tests/test_pallas.py:103), a calibration's parameters at 1e-8."""
    call, _, _, raises = OUT_OF_SLICE[case]
    if raises is not None:
        with pytest.raises(raises[0], match=raises[1]):
            _out_of_slice_run(case, params, jax_side=False)
        return
    got = _out_of_slice_run(case, params, jax_side=False)
    want = _out_of_slice_run(case, params, jax_side=True)
    if call == "calibrate":
        np.testing.assert_allclose(npy(got[0]), np.asarray(want[0]),
                                   rtol=0, atol=1e-8)
        assert int(got[1]["iterations"]) == int(want[1]["iterations"])
        np.testing.assert_array_equal(npy(got[1]["history"]["accepted"]),
                                      np.asarray(want[1]["history"][
                                          "accepted"]))
    elif call == "jacobian":
        for g, w in zip(got, want):
            np.testing.assert_allclose(npy(g), np.asarray(w), rtol=0,
                                       atol=1e-9)
    else:
        engine = OUT_OF_SLICE[case][1].get("solver_engine")
        np.testing.assert_allclose(npy(got), np.asarray(want), rtol=0,
                                   atol=1e-9 if engine == "pcr" else 1e-12)


@pytest.mark.parametrize("n_steps_per,match", [
    ([10, 20, 5], "one step count per option"),     # B = 2
    ([[10, 20]], "one step count per option"),
    ([10.0, 19.5], "integers"),
    ([0, 20], "1..solver.n_steps"),
    ([10, 21], "1..solver.n_steps"),
])
def test_per_lane_steps_raise(params, n_steps_per, match):
    """Per-option step counts must be one integer per option in
    1..solver.n_steps (ValueError); with a rate schedule they raise
    ValueError naming "per-lane", as in the JAX package
    (heston_tpu/pallas/fused_do.py:1807-1810)."""
    args = (port_cfg(GridSpec(m1=10, m2=8)), port_cfg(FLAGSHIP),
            t64([100.0, 110.0]), 100.0, *param_args(params))
    with pytest.raises(ValueError, match=match):
        fused_do.fused_price_batch(*args, n_steps_per=np.array(n_steps_per))
    with pytest.raises(ValueError, match="per-lane"):
        fused_do.fused_price_batch(*args, n_steps_per=np.array([10, 20]),
                                   rate_schedule=port_cfg(RateSchedule(
                                       times=(0.5,), r_d=(0.02, 0.03),
                                       r_f=(0.0, 0.0))))


def test_per_lane_steps_below_the_launch_count(params):
    """A book whose counts all lie below solver.n_steps (a rank's slice
    of a mixed book holding only its shorter maturities) runs, each
    option stopping at its own count: the same options' prices as in a
    book that reaches solver.n_steps (to the ulps by which the plain
    version's batched operations round books of 2 and 3 options apart,
    measured 1.1e-16)."""
    args = (port_cfg(GridSpec(m1=10, m2=8)), port_cfg(FLAGSHIP))
    rest = (100.0, *param_args(params))
    kw = dict(american=True, dividends=port_cfg(GOLDEN_DIVIDENDS))
    short = fused_do.fused_price_batch(*args, t64([100.0, 110.0]), *rest,
                                       n_steps_per=np.array([10, 12]), **kw)
    full = fused_do.fused_price_batch(*args, t64([100.0, 110.0, 120.0]),
                                      *rest,
                                      n_steps_per=np.array([10, 12, 20]),
                                      **kw)
    assert float((short - full[:2]).abs().max()) <= 1e-14


def test_unknown_option_type_is_a_value_error(params):
    with pytest.raises(ValueError, match="unknown option_type"):
        heston_tpu_torch.price_batch(
            port_cfg(GridSpec(m1=10, m2=8)), port_cfg(FLAGSHIP),
            t64([100.0]), 100.0, *param_args(params), option_type="straddle",
            device=CPU)


def test_import_loads_no_jax():
    """Importing every module of the port loads neither JAX nor any module
    of the JAX package (heston_tpu, heston_tpu.*)."""
    modules = sorted(
        "heston_tpu_torch." + ".".join(
            path.relative_to(REPO / "heston_tpu_torch").with_suffix("").parts)
        for path in (REPO / "heston_tpu_torch").rglob("*.py")
        if path.name != "__init__.py")
    assert "heston_tpu_torch.models.calibration" in modules
    assert "heston_tpu_torch.models.greeks" in modules
    assert "heston_tpu_torch.kernels.fused_single" in modules
    code = ("import importlib, sys\n"
            f"for m in {['heston_tpu_torch', *modules]!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'heston_tpu' or "
            "m.startswith('heston_tpu.'))\n"
            "assert not bad, bad\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("entry", ["price_batch", "calibrate_device"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without device="cpu", an entry point asks for the card, and
    without one it raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = heston_tpu_torch.GridSpec(m1=10, m2=8)
    solver = heston_tpu_torch.SolverConfig(n_steps=4, solver_engine="pallas")
    ks = t64([95.0, 105.0])
    if entry == "price_batch":
        call = (heston_tpu_torch.price_batch, spec, solver, ks, 100.0,
                1.5, 0.04, 0.3, -0.9, 0.04, 0.025, 0.0)
    else:
        call = (heston_tpu_torch.calibrate_device, spec, solver, ks,
                t64([8.0, 3.0]), 100.0, t64([1.2, 0.05, 0.4, -0.5, 0.05]),
                0.025, 0.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[0](*call[1:])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call[0](*call[1:], device="cuda")


def test_device_cpu_runs_a_list_of_strikes(params):
    """device="cpu" takes plain Python strikes and runs the plain version
    of the kernel; the result equals the float64-tensor call when the
    strikes are given as float64."""
    spec = heston_tpu_torch.GridSpec(m1=10, m2=8)
    solver = heston_tpu_torch.SolverConfig(n_steps=4, solver_engine="pallas")
    got = heston_tpu_torch.price_batch(spec, solver, [95.0, 105.0], 100.0,
                                       *param_args(params), device=CPU)
    assert got.device.type == "cpu" and got.dtype == torch.float32
    want = heston_tpu_torch.price_batch(spec, solver, t64([95.0, 105.0]),
                                        100.0, *param_args(params),
                                        device=torch.device("cpu"))
    np.testing.assert_allclose(npy(got), npy(want), rtol=1e-4)

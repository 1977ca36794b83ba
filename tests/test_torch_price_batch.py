"""heston_tpu_torch.price_batch against heston_tpu: whole-slice parity in
float64, the scheme pins, the float32 accuracy of the plain path, the
options outside the slice, and an import that loads no JAX."""

import dataclasses
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
from heston_tpu_torch.kernels import fused_do

from torch_parity import npy, param_args, t64

REPO = Path(__file__).resolve().parent.parent
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


def _jax_prices(spec, solver, strikes, p, **kw):
    """(fused kernel in interpret mode, XLA scan engine) prices."""
    args = (100.0, *param_args(p))
    ks = jnp.asarray(strikes)
    fused = jax.jit(lambda k: jfd.fused_price_batch(
        spec, solver, k, *args, interpret=True, **kw))(ks)
    scan = jdouglas.price_batch(
        spec, dataclasses.replace(solver, solver_engine="scan"), ks, *args,
        **kw)
    return np.asarray(fused), np.asarray(scan)


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_price_batch_matches_jax_small_grid(params, arm):
    spec = GridSpec(m1=10, m2=8)
    solver = SolverConfig(n_steps=4, a2_variant="upwind",
                          solver_engine="pallas")
    strikes = np.random.default_rng(11).uniform(75.0, 125.0, 6)
    got = npy(heston_tpu_torch.price_batch(
        spec, solver, t64(strikes), 100.0, *param_args(params),
        **ARMS[arm]))
    fused, scan = _jax_prices(spec, solver, strikes, params, **ARMS[arm])
    np.testing.assert_allclose(got, fused, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, scan, rtol=0, atol=1e-10)


def test_price_batch_matches_jax_flagship(params):
    """The flagship call (__graft_entry__.py: American calls, golden
    dividends, 50 x 25 x 20, theta 0.8, upwind A2) at B = 8."""
    kw = ARMS["amer_div"]
    strikes = np.linspace(80.0, 120.0, 8)
    got = npy(heston_tpu_torch.price_batch(
        FLAGSHIP_SPEC, FLAGSHIP, t64(strikes), 100.0, *param_args(params),
        **kw))
    fused, scan = _jax_prices(FLAGSHIP_SPEC, FLAGSHIP, strikes, params, **kw)
    np.testing.assert_allclose(got, fused, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, scan, rtol=0, atol=1e-10)


@pytest.mark.parametrize("strike,kw,pin", [
    (95.0, dict(american=True, dividends=GOLDEN_DIVIDENDS),
     8.510573074266677),                 # tests/test_douglas.py:52
    (100.0, dict(dividends=GOLDEN_DIVIDENDS), 3.85096222593301),   # :51
])
def test_scheme_pins(params, strike, kw, pin):
    got = heston_tpu_torch.price_batch_params(
        FLAGSHIP_SPEC, FLAGSHIP, t64([strike]), 100.0, params, **kw)
    assert abs(float(got[0]) - pin) < 1e-10


@pytest.mark.parametrize("arm", sorted(F32_BUDGETS))
def test_plain_f32_rmse_within_jax_budget(params, arm):
    """The plain float32 path against JAX float64, on the setup of
    tests/test_precision.py (50 x 25 x 20, 16 strikes in [75, 125]), held
    to the JAX package's interpret-mode float32 budget of each arm. It
    shows the delta form and the compensated update were carried over."""
    kw = ARMS[arm]
    ks64 = np.linspace(75.0, 125.0, 16)
    want = np.asarray(jdouglas.price_batch(
        FLAGSHIP_SPEC, dataclasses.replace(FLAGSHIP, solver_engine="scan"),
        jnp.asarray(ks64), 100.0, *param_args(params), **kw))
    got = heston_tpu_torch.price_batch(
        FLAGSHIP_SPEC, FLAGSHIP, torch.tensor(ks64, dtype=torch.float32),
        100.0, *param_args(params), **kw)
    assert got.dtype == torch.float32
    rmse = float(np.sqrt(np.mean((npy(got).astype(np.float64) - want) ** 2)))
    assert rmse < F32_BUDGETS[arm], (arm, rmse)


def test_batch_of_one_goes_through_the_batched_path(params):
    """A batch of one prices like the same strike inside a larger book
    (the single-option kernel of the JAX package is not ported yet)."""
    kw = ARMS["amer_div"]
    book = heston_tpu_torch.price_batch(
        FLAGSHIP_SPEC, FLAGSHIP, t64([90.0, 100.0, 110.0]), 100.0,
        *param_args(params), **kw)
    one = heston_tpu_torch.price_batch(
        FLAGSHIP_SPEC, FLAGSHIP, t64([100.0]), 100.0, *param_args(params),
        **kw)
    assert one.shape == (1,)
    assert torch.equal(one[0], book[1])


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
    spec = GridSpec(m1=10, m2=8)
    solver = SolverConfig(n_steps=4, solver_engine="pallas")
    ks = t64([90.0, 110.0])
    kw = ARMS["amer_div"]
    got = heston_tpu_torch.price_batch(spec, solver, ks, 100.0, **pt, **kw)
    want = heston_tpu_torch.price_batch(spec, solver, ks, 100.0,
                                        *param_args(params), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-13)
    with pytest.raises(ValueError):
        params_from_jax(tv[:4], 0.025, 0.0)


OUT_OF_SLICE = {
    "engine_scan": (dict(solver_engine="scan"), {}, "ROADMAP A4"),
    "engine_pcr": (dict(solver_engine="pcr"), {}, "ROADMAP A4"),
    "scheme_cs": (dict(scheme="cs"), {}, "ROADMAP A12"),
    "scheme_mcs": (dict(scheme="mcs"), {}, "ROADMAP A12"),
    "scheme_hv": (dict(scheme="hv"), {}, "ROADMAP A12"),
    "rannacher": (dict(rannacher_steps=2), {}, "ROADMAP A12"),
    "put": ({}, dict(option_type="put"), "ROADMAP A12"),
    "digital_call": ({}, dict(option_type="digital_call"), "ROADMAP A12"),
    "digital_put": ({}, dict(option_type="digital_put"), "ROADMAP A12"),
    "rate_schedule": ({}, dict(rate_schedule=RateSchedule(
        times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.0))), "ROADMAP A12"),
    "barrier": ({}, dict(barrier=Barrier("up-out", 150.0)), "ROADMAP A12"),
}


@pytest.mark.parametrize("case", sorted(OUT_OF_SLICE))
def test_out_of_slice_raises(params, case):
    solver_kw, kw, item = OUT_OF_SLICE[case]
    solver = dataclasses.replace(FLAGSHIP, **solver_kw)
    spec = GridSpec(m1=10, m2=8, barrier=kw.pop("barrier", None))
    with pytest.raises(NotImplementedError, match=item):
        heston_tpu_torch.price_batch(spec, solver, t64([100.0]), 100.0,
                                     *param_args(params), **kw)


def test_per_lane_steps_raise(params):
    with pytest.raises(NotImplementedError, match="ROADMAP A12"):
        fused_do.fused_price_batch(
            GridSpec(m1=10, m2=8), FLAGSHIP, t64([100.0, 110.0]), 100.0,
            *param_args(params), n_steps_per=np.array([10, 20]))


def test_unknown_option_type_is_a_value_error(params):
    with pytest.raises(ValueError, match="unknown option_type"):
        heston_tpu_torch.price_batch(
            GridSpec(m1=10, m2=8), FLAGSHIP, t64([100.0]), 100.0,
            *param_args(params), option_type="straddle")


def test_import_loads_no_jax():
    code = ("import sys, heston_tpu_torch, heston_tpu_torch.convert; "
            "assert 'jax' not in sys.modules, 'jax imported'; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"

"""heston_tpu_torch.scenarios against heston_tpu.scenarios: every preset
shrunk as tests/test_scenarios.py:18-25 does (14 x 8 x 4, 5 strikes, one
LM iteration), both LM loops, float64 on the CPU."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from heston_tpu import scenarios as jscen
from heston_tpu.config import GridSpec, SolverConfig
from heston_tpu_torch import scenarios

from torch_parity import CPU, port_cfg
from torch_parity import release_jax_executables  # noqa: F401

SPEC = GridSpec(m1=14, m2=8)
SOLVER = SolverConfig(n_steps=4)
# the JAX package's run_scenario fits float64 targets with the FD
# Jacobian's 1e-6 bumps, which turn the packages' ~1e-14 price gap into
# ~1e-6 in the fitted prices (measured on these presets); both packages'
# scenarios take the exact AD Jacobian here, so that the fits compare
AD = dict(jacobian_mode="ad")
# each preset through one loop, the two loops alternating
LOOPS = {name: i % 2 == 1 for i, name in enumerate(jscen.SCENARIOS)}


def _shrunk(base, multi_tail=False):
    kw = dict(num_strikes=5, max_iter=1, tol=1e-9)
    if len(base.maturities) > 1:
        kw["strikes_per_maturity"] = 3
        # with 4 steps a year the first two maturities (0.1, 0.2) of
        # european_multi both round to one step, which the device loop
        # prices at T = 1/4: the rho column of the Jacobian is then zero
        # to rounding (~2e-15) and the LM step along rho is rounding in
        # either package; the parity cases take the last two maturities
        kw["maturities"] = (base.maturities[-2:] if multi_tail
                            else base.maturities[:2])
    return dataclasses.replace(base, **kw)


@functools.cache
def _jax_result(name):
    """The JAX package's run_scenario on the shrunk preset `name`, once
    per process."""
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jscen, "CalibrationConfig",
                   functools.partial(jscen.CalibrationConfig, **AD))
        mp.setitem(jscen.SCENARIOS, name,
                   _shrunk(jscen.SCENARIOS[name], True))
        return jscen.run_scenario(
            name, spec=SPEC, solver=SOLVER, steps_per_year=4,
            verbose=False, device_loop=LOOPS[name])[0]
    finally:
        mp.undo()


@pytest.mark.parametrize("name", list(jscen.SCENARIOS))
def test_scenario_matches_jax(monkeypatch, name):
    """The same iterations and market, fitted prices within 1e-9, the SSE
    within 1e-9 relative, the parameters within 1e-9."""
    monkeypatch.setattr(scenarios, "CalibrationConfig",
                        functools.partial(scenarios.CalibrationConfig, **AD))
    monkeypatch.setitem(scenarios.SCENARIOS, name,
                        _shrunk(scenarios.SCENARIOS[name], True))
    got, wall = scenarios.run_scenario(
        name, spec=port_cfg(SPEC), solver=port_cfg(SOLVER),
        steps_per_year=4, verbose=False, device_loop=LOOPS[name],
        dtype=torch.float64, device=CPU)
    want = _jax_result(name)
    assert wall > 0 and got.iterations == want.iterations == 1
    np.testing.assert_allclose(got.market_prices, want.market_prices,
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.fitted_prices, want.fitted_prices,
                               rtol=0, atol=1e-9)
    np.testing.assert_allclose(got.final_error, want.final_error, rtol=1e-9)
    np.testing.assert_allclose(got.params.bumpable(),
                               want.params.bumpable(), rtol=0, atol=1e-9)
    assert got.total_pde_solves == want.total_pde_solves


@pytest.mark.parametrize("device_loop", [False, True])
def test_scenario_presets_run(monkeypatch, device_loop):
    """Every preset as tests/test_scenarios.py shrinks it runs one
    iteration on the port, float32 by default (the AD Jacobian), to a
    finite fit."""
    for name in scenarios.SCENARIOS:
        monkeypatch.setitem(scenarios.SCENARIOS, name,
                            _shrunk(scenarios.SCENARIOS[name]))
        result, _ = scenarios.run_scenario(
            name, spec=port_cfg(SPEC), solver=port_cfg(SOLVER),
            steps_per_year=4, verbose=False, device_loop=device_loop,
            device=CPU)
        assert result.iterations == 1, name
        assert np.isfinite(result.final_error), name
        assert len(result.market_prices) == len(result.fitted_prices)
        assert result.strikes.dtype == np.float32


def test_scenario_market_data_variants():
    """Dividend scenarios generate cheaper synthetic chains than plain ones
    (escrowed-dividend adjustment, ref: src/bs.hpp:78-114); the chains
    equal the JAX package's."""
    plain = scenarios.SCENARIOS["european"].build_targets()
    div = dataclasses.replace(
        scenarios.SCENARIOS["dividends"], num_strikes=60).build_targets()
    assert np.all(div.prices < plain.prices)
    multi = scenarios.SCENARIOS["european_multi"].build_targets()
    assert len(set(multi.maturities.tolist())) == 10
    assert len(multi.strikes) == 200   # reference: 10 maturities x 20 strikes
    for name, got in (("european", plain), ("european_multi", multi)):
        want = jscen.SCENARIOS[name].build_targets()
        np.testing.assert_allclose(got.prices, want.prices, rtol=0,
                                   atol=1e-12)
        np.testing.assert_array_equal(got.strikes, want.strikes)
        np.testing.assert_array_equal(got.maturities, want.maturities)


def test_group_steps_match_jax():
    targets = jscen.SCENARIOS["american_dividends_multi"].build_targets()
    assert (scenarios._group_steps(targets, 20)
            == jscen._group_steps(targets, 20))

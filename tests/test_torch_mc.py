"""heston_tpu_torch.models.mc (the Monte Carlo oracle) against
heston_tpu.models.mc, float64 on the CPU.

The host-side helpers and the estimator agree exactly. The simulations
draw from different generators (a torch.Generator against a jax.random
key split per step), so the prices agree in distribution: each package
within its own 95% half-width of the characteristic-function price plus
the scheme's time-discretization bias, and the two packages within their
combined half-widths of each other.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import GOLDEN_DIVIDENDS, Barrier, HestonParams
from heston_tpu.models import heston_cf as jcf
from heston_tpu.models import mc as jmc
from heston_tpu_torch.models import mc

from torch_parity import CPU, F64, port_cfg
from torch_parity import release_jax_executables  # noqa: F401

P = HestonParams()
MARGS = (100.0, P.v0, 100.0, P.r_d, P.r_f, P.kappa, P.eta, P.sigma, P.rho,
         1.0)
PATHS = 20_000
# |bias| of each scheme's price against the CF price at its step count
# (50 Euler steps, 16 QE steps), measured with 2,000,000 antithetic
# paths (scripts/torch_mc_bias.py bias): truncation -0.0055 (call) /
# -0.0036 (put), reflection +0.0054 / -0.0011, QE +0.0016 / -0.0013,
# each +-0.008 (calls) / +-0.013 (puts) at 95%; stated at 0.02, below a
# 20,000-path half-width (~0.14)
BIAS = 0.02
# (scheme, steps, option type, extra keywords) of the statistical cases
CASES = {
    "truncation_call": ("truncation", 50, "call", {}),
    "reflection_put": ("reflection", 50, "put", {}),
    "qe_call": ("qe", 16, "call", {}),
    "qe_put_antithetic": ("qe", 16, "put", dict(antithetic=True)),
    "dividends": ("truncation", 50, "call",
                  dict(dividends=GOLDEN_DIVIDENDS)),
    "up_out_130": ("truncation", 50, "call",
                   dict(barrier=Barrier("up-out", 130.0))),
    "down_out_80_digital": ("truncation", 50, "digital_call",
                            dict(barrier=Barrier("down-out", 80.0))),
}


def port_margs(strike=100.0):
    return (*MARGS[:2], torch.tensor(strike, dtype=F64), *MARGS[3:])


def gen(seed):
    return torch.Generator(device=CPU).manual_seed(seed)


@functools.cache
def cf_price(option_type):
    return float(jcf.price_chain(100.0, jnp.array([100.0]), P.v0, P.kappa,
                                 P.eta, P.sigma, P.rho, P.r_d, 1.0,
                                 option_type=option_type)[0])


@functools.cache
def jax_euro(case):
    scheme, n, option_type, kw = CASES[case]
    price, half = jmc.price_european_call_mc(
        jax.random.PRNGKey(7), *MARGS, num_paths=PATHS, n_steps=n,
        scheme=scheme, option_type=option_type, **kw)
    return float(price), float(half)


def port_euro(case, seed=7):
    scheme, n, option_type, kw = CASES[case]
    kw = {k: port_cfg(v) for k, v in kw.items()}
    price, half = mc.price_european_call_mc(
        gen(seed), *port_margs(), num_paths=PATHS, n_steps=n,
        scheme=scheme, option_type=option_type, device=CPU, **kw)
    assert price.dtype == F64 and price.shape == ()
    return float(price), float(half)


@pytest.mark.parametrize("kappa,eta,sigma", [(1.5, 0.04, 0.3),
                                             (1.5, 0.04, 3.0),
                                             (0.5, 0.02, 0.15)])
def test_feller_and_scheme_dispatch_match_jax(kappa, eta, sigma):
    assert mc.feller_condition(kappa, eta, sigma) \
        == jmc.feller_condition(kappa, eta, sigma)
    assert mc.select_scheme(kappa, eta, sigma) \
        == jmc.select_scheme(kappa, eta, sigma)
    assert mc.select_scheme(torch.tensor(kappa), eta, sigma) \
        == jmc.select_scheme(kappa, eta, sigma)


@pytest.mark.parametrize("t,n_steps", [(1.0, 350), (1.0, 50), (1.0, 100),
                                       (0.6, 12), (0.3, 7)])
def test_dividend_jumps_bitwise(t, n_steps):
    got = mc._dividend_jumps(port_cfg(GOLDEN_DIVIDENDS), t, n_steps)
    want = jmc._dividend_jumps(GOLDEN_DIVIDENDS, t, n_steps)
    assert any(got[2])
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g, np.asarray(w))
    none = mc._dividend_jumps(None, t, n_steps)
    assert not none[2].any() and (none[0] == 1.0).all()


@pytest.mark.parametrize("antithetic", [False, True])
def test_mean_ci_matches_jax(antithetic):
    payoff = np.random.default_rng(3).lognormal(1.5, 0.8, 4096)
    got = mc._mc_mean_ci(torch.as_tensor(payoff), 4096, antithetic)
    want = jmc._mc_mean_ci(jnp.asarray(payoff), 4096, antithetic)
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-15, atol=0)


@pytest.mark.parametrize("case", list(CASES))
def test_european_statistically_matches_jax(case):
    price, half = port_euro(case)
    jprice, jhalf = jax_euro(case)
    assert 0.0 < half < 0.3 and 0.0 < jhalf < 0.3
    assert abs(price - jprice) <= 2.0 * np.hypot(half, jhalf), (
        price, half, jprice, jhalf)
    kw = CASES[case][3]
    if not kw.get("dividends") and not kw.get("barrier"):
        truth = cf_price(CASES[case][2])
        for p_, h_ in ((price, half), (jprice, jhalf)):
            assert abs(p_ - truth) <= 2.0 * h_ + BIAS, (p_, h_, truth)


@functools.cache
def jax_lsmc(option_type, strike):
    price, half = jmc.price_american_lsmc(
        jax.random.PRNGKey(0), *MARGS[:2], strike, *MARGS[3:],
        num_paths=PATHS, n_steps=50, option_type=option_type)
    return float(price), float(half)


@pytest.mark.parametrize("option_type", ["put", "call"])
def test_lsmc_statistically_matches_jax(option_type):
    price, half = mc.price_american_lsmc(
        gen(0), *port_margs(), num_paths=PATHS, n_steps=50,
        option_type=option_type, device=CPU)
    jprice, jhalf = jax_lsmc(option_type, 100.0)
    assert abs(float(price) - jprice) <= 2.0 * np.hypot(float(half), jhalf)
    if option_type == "call":
        # no dividends, r_f = 0: early exercise of a call never pays, so
        # the American call is the European one (policy bias is low)
        assert abs(float(price) - cf_price("call")) \
            <= 2.0 * float(half) + 0.15


def test_lsmc_deep_itm_put_is_intrinsic():
    price, half = mc.price_american_lsmc(
        gen(2), *port_margs(130.0), num_paths=PATHS, n_steps=50,
        device=CPU)
    assert float(price) == 30.0 and float(half) == 0.0
    jprice, _ = jax_lsmc("put", 130.0)
    assert jprice == 30.0


def test_knock_in_plus_knock_out_is_vanilla():
    """The same paths price both legs from one survival tensor, so the
    in-out parity holds estimator-wise at one seed."""
    kw = dict(num_paths=PATHS, n_steps=50, scheme="truncation", device=CPU)
    b = port_cfg(Barrier("up-out", 130.0))
    ko, _ = mc.price_european_call_mc(gen(5), *port_margs(), barrier=b, **kw)
    ki, _ = mc.price_european_call_mc(gen(5), *port_margs(), barrier=b,
                                      knock_in=True, **kw)
    van, _ = mc.price_european_call_mc(gen(5), *port_margs(), **kw)
    assert 0.5 < float(ki) < float(van)
    assert abs(float(ki) + float(ko) - float(van)) <= 1e-12


def test_auto_scheme_is_the_feller_choice_bitwise():
    kw = dict(num_paths=2_000, n_steps=20, device=CPU)
    auto = mc.price_european_call_mc(gen(1), *port_margs(), **kw)
    expl = mc.price_european_call_mc(gen(1), *port_margs(),
                                     scheme="truncation", **kw)
    assert [float(x) for x in auto] == [float(x) for x in expl]


def test_dtype_follows_the_strike():
    price, half = mc.price_european_call_mc(
        gen(1), *MARGS, num_paths=2_000, n_steps=10, device=CPU)
    assert price.dtype == torch.get_default_dtype() == half.dtype


def test_invalid_inputs_raise(monkeypatch):
    kw = dict(num_paths=2_001, n_steps=10, device=CPU)
    with pytest.raises(ValueError, match="even num_paths"):
        mc.price_european_call_mc(gen(1), *port_margs(), antithetic=True,
                                  **kw)
    with pytest.raises(ValueError, match="even num_paths"):
        mc.price_american_lsmc(gen(1), *port_margs(), antithetic=True, **kw)
    with pytest.raises(ValueError, match="knock_in"):
        mc.price_european_call_mc(gen(1), *port_margs(), knock_in=True, **kw)
    with pytest.raises(ValueError, match="unknown MC scheme"):
        mc.price_european_call_mc(gen(1), *port_margs(), scheme="milstein",
                                  **kw)
    # the card by default: without one, both entry points raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (mc.price_european_call_mc, mc.price_american_lsmc):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(gen(1), *port_margs(), num_paths=10, n_steps=2)

"""heston_tpu_torch.models.bs against heston_tpu.models.bs: the closed
forms and market generators at 1e-12, implied vols of a chain at 1e-10
(Newton and its bisection fallback), float64 on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import GOLDEN_DIVIDENDS
from heston_tpu.models import bs as jbs
from heston_tpu_torch.models import bs

from torch_parity import assert_close, npy, t64
from torch_parity import release_jax_executables  # noqa: F401

SEED = 2026
DIV = (GOLDEN_DIVIDENDS.dates, GOLDEN_DIVIDENDS.amounts,
       GOLDEN_DIVIDENDS.percentages)


def _chain(n=40):
    rng = np.random.default_rng(SEED)
    return (rng.uniform(60.0, 140.0, n), rng.uniform(0.05, 0.8, n),
            rng.uniform(0.1, 3.0, n))


@pytest.mark.parametrize("name", ["call_price", "put_price", "call_vega"])
def test_closed_forms_match_jax(name):
    """Per-quote strike, vol and maturity arrays, spot and rate scalars."""
    ks, vols, ts = _chain()
    got = getattr(bs, name)(100.0, t64(ks), 0.025, t64(vols), t64(ts))
    want = getattr(jbs, name)(100.0, jnp.asarray(ks), 0.025,
                              jnp.asarray(vols), jnp.asarray(ts))
    assert got.dtype == torch.float64
    assert_close(got, want)


def test_parity_and_market_generators_match_jax():
    ks, _, _ = _chain()
    kt, kj = t64(ks), jnp.asarray(ks)
    for option_type in ("call", "put"):
        assert_close(bs.generate_market_data(100.0, 0.7, 0.025, kt,
                                             option_type=option_type),
                     jbs.generate_market_data(100.0, 0.7, 0.025, kj,
                                              option_type=option_type))
        assert_close(
            bs.generate_market_data_with_dividends(
                100.0, 0.7, 0.025, kt, *DIV, option_type=option_type),
            jbs.generate_market_data_with_dividends(
                100.0, 0.7, 0.025, kj, *DIV, option_type=option_type))
    puts = npy(bs.put_price(100.0, kt, 0.025, 0.3, 1.5))
    assert_close(bs.put_to_call_parity(t64(puts), 100.0, kt, 0.025, 1.5),
                 jbs.put_to_call_parity(jnp.asarray(puts), 100.0, kj, 0.025,
                                        1.5))
    for t in (0.1, 0.5, 0.9, 2.0):   # 0, 2, 4 and all 4 events before t
        assert_close(bs.escrowed_spot(100.0, t, 0.025, *DIV),
                     jbs.escrowed_spot(100.0, t, 0.025, *DIV))


@pytest.mark.parametrize("max_newton", [100, 3])
def test_implied_vol_chain_matches_jax(max_newton):
    """Quotes at random strikes and vols, one maturity, inverted by
    Newton (max_newton = 100, the default) and by the bisection fallback
    (max_newton = 3: Newton gives up and bisection takes over for every
    quote), against the JAX package's vmapped inversion."""
    rng = np.random.default_rng(SEED)
    ks = rng.uniform(75.0, 125.0, 32)
    vols = rng.uniform(0.1, 0.6, 32)
    prices = jbs.call_price(100.0, jnp.asarray(ks), 0.025,
                            jnp.asarray(vols), 0.8)
    want = np.asarray(jax.vmap(
        functools.partial(jbs.implied_vol, max_newton=max_newton),
        in_axes=(0, None, 0, None, None))(prices, 100.0, jnp.asarray(ks),
                                          0.025, 0.8))
    got = bs.implied_vol(t64(prices), 100.0, t64(ks), 0.025, 0.8,
                         max_newton=max_newton)
    assert_close(got, want, rtol=0, atol=1e-10)
    # the quotes are reproduced: the inversion converged everywhere
    assert_close(got, vols, rtol=0, atol=1e-6)
    if max_newton == 100:
        assert_close(bs.implied_vol_chain(t64(prices), 100.0, t64(ks), 0.025,
                                          0.8), got, rtol=0, atol=0)
        # the scalar form agrees with the chain, quote by quote
        for i in (0, 7):
            assert_close(bs.implied_vol(t64(prices[i]), 100.0, ks[i], 0.025,
                                        0.8), want[i], rtol=0, atol=1e-10)


def test_digital_price_not_ported():
    """bs.digital_price (once NotImplementedError) equals the JAX
    package's cash-or-nothing closed form, call and put, at 1e-12; the
    pair sums to the discount factor."""
    ks, vols, ts = _chain()
    for option_type in ("digital_call", "digital_put"):
        got = bs.digital_price(100.0, t64(ks), 0.025, t64(vols), t64(ts),
                               option_type)
        want = jbs.digital_price(100.0, jnp.asarray(ks), 0.025,
                                 jnp.asarray(vols), jnp.asarray(ts),
                                 option_type)
        assert got.dtype == torch.float64
        assert_close(got, want)
    pair = (bs.digital_price(100.0, t64(ks), 0.025, 0.3, 1.5)
            + bs.digital_price(100.0, t64(ks), 0.025, 0.3, 1.5,
                               "digital_put"))
    assert_close(pair, np.full(len(ks), np.exp(-0.025 * 1.5)))

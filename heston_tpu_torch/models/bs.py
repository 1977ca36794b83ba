"""Black–Scholes closed forms and implied-vol inversion (PyTorch).

Counterpart of `heston_tpu.models.bs` (ref: src/bs.hpp): the closed-form
call via erfc, vega, synthetic market chains at flat vol 0.2, and implied
vol by Newton with a bisection fallback. The JAX package inverts one
quote per `lax.while_loop` and vmaps it over a chain; here `implied_vol`
is elementwise over tensors: a batched loop whose per-element active
masks stop each element exactly where the scalar loop stops it.
"""

from __future__ import annotations

import math

import torch

from heston_tpu_torch.ops.operators import is_put

MARKET_VOL = 0.2  # flat vol used for synthetic chains (ref: src/bs.hpp:65)


def _t(x, like=None):
    """x as a float tensor (float64 unless `like` or x says otherwise)."""
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float64)


def call_price(s, k, r, vol, t):
    """European call, erfc form (ref: src/bs.hpp:44-54)."""
    k = _t(k)
    sqrt_t = torch.sqrt(_t(t, k))
    d1 = (torch.log(s / k) + (r + 0.5 * vol * vol) * t) / (vol * sqrt_t)
    d2 = d1 - vol * sqrt_t
    inv_sqrt2 = 1.0 / math.sqrt(2.0)
    return (s * torch.special.erfc(-d1 * inv_sqrt2) / 2.0
            - k * torch.exp(_t(-r * t, k))
            * torch.special.erfc(-d2 * inv_sqrt2) / 2.0)


def put_price(s, k, r, vol, t):
    """European put via put-call parity."""
    k = _t(k)
    return call_price(s, k, r, vol, t) - s + k * torch.exp(_t(-r * t, k))


def call_vega(s, k, r, vol, t):
    """dPrice/dVol (ref: src/bs.hpp:124-127)."""
    k = _t(k)
    d1 = ((torch.log(s / k) + (r + 0.5 * vol * vol) * t)
          / (vol * torch.sqrt(_t(t, k))))
    return s * torch.exp(-0.5 * d1 * d1) * torch.sqrt(
        _t(t / (2.0 * math.pi), k))


def digital_price(s, k, r, vol, t, option_type: str = "digital_call"):
    """European cash-or-nothing digital: call e^{-rT} N(d2), put
    e^{-rT} N(-d2) (heston_tpu/models/bs.py:48-59), the Black–Scholes
    limit of the PDE digitals."""
    k = _t(k)
    sqrt_t = torch.sqrt(_t(t, k))
    d1 = (torch.log(s / k) + (r + 0.5 * vol * vol) * t) / (vol * sqrt_t)
    d2 = d1 - vol * sqrt_t
    n_d2 = torch.special.erfc(-d2 * (1.0 / math.sqrt(2.0))) / 2.0
    prob = 1.0 - n_d2 if is_put(option_type) else n_d2
    return torch.exp(_t(-r * t, k)) * prob


def put_to_call_parity(p, s, k, r, t):
    """European put price -> parity-equivalent call price
    C = P + S - K e^{-rT}."""
    k = _t(k)
    return p + s - k * torch.exp(_t(-r * t, k))


def generate_market_data(s0, t, r_d, strikes, vol=MARKET_VOL,
                         option_type: str = "call"):
    """Synthetic market chain at flat vol (ref: src/bs.hpp:57-76)."""
    fn = put_price if is_put(option_type) else call_price
    return fn(s0, strikes, r_d, vol, t)


def escrowed_spot(s0, t, r_d, dates, amounts, percentages):
    """s0 minus the PV of cash dividends and of s0*pct proportional
    dividends paid before maturity t (ref: src/bs.hpp:93-104)."""
    s_adj = s0
    for date, amt, pct in zip(dates, amounts, percentages):
        if date < t:
            disc = math.exp(-r_d * float(date))
            s_adj = s_adj - amt * disc
            s_adj = s_adj - (s0 * pct) * disc
    return s_adj


def generate_market_data_with_dividends(s0, t, r_d, strikes, dates, amounts,
                                        percentages, vol=MARKET_VOL,
                                        option_type: str = "call"):
    """Escrowed-dividend-adjusted synthetic chain (ref: src/bs.hpp:78-114)."""
    fn = put_price if is_put(option_type) else call_price
    return fn(escrowed_spot(s0, t, r_d, dates, amounts, percentages),
              strikes, r_d, vol, t)


def implied_vol(price_target, s, k, r, t, v_init=0.5, epsilon=1e-8,
                max_newton: int = 100, max_bisect: int = 200):
    """Implied vol of call quotes, elementwise over `price_target` and
    `k` (ref: src/bs.hpp:164-192): Newton from v_init, and where Newton
    fails (a vega below 1e-10, a step to a non-positive or non-finite
    vol, or max_newton steps) bisection on [0.001, 1]. float64 unless the
    target is a tensor of another float type."""
    target = _t(price_target)
    k = _t(k, target)
    shape = torch.broadcast_shapes(target.shape, k.shape)
    target = target.expand(shape)
    x = torch.full(shape, float(v_init), dtype=target.dtype,
                   device=target.device)
    it = torch.zeros(shape, dtype=torch.int64, device=target.device)
    fail = torch.zeros(shape, dtype=torch.bool, device=target.device)

    def far(vol):
        return (call_price(s, k, r, vol, t) - target).abs() > epsilon

    active = far(x) & (it < max_newton) & ~fail
    while bool(active.any()):
        c = call_price(s, k, r, x, t)
        v = call_vega(s, k, r, x, t)
        bad = v.abs() < 1e-10
        x_new = torch.where(bad, x, x - (c - target) / v)
        bad = bad | (x_new <= 0.0) | ~torch.isfinite(x_new)
        x = torch.where(active, torch.where(bad, x, x_new), x)
        it = torch.where(active, it + 1, it)
        fail = torch.where(active, bad, fail)
        active = far(x) & (it < max_newton) & ~fail
    fail = fail | (it >= max_newton)

    a = torch.full_like(x, 0.001)
    b = torch.full_like(x, 1.0)
    xb = 0.5 * (a + b)
    it = torch.zeros_like(it)
    active = far(xb) & (it < max_bisect)
    while bool(active.any()):
        hi = call_price(s, k, r, xb, t) > target
        a = torch.where(active & ~hi, xb, a)
        b = torch.where(active & hi, xb, b)
        xb = torch.where(active, 0.5 * (a + b), xb)
        it = torch.where(active, it + 1, it)
        active = far(xb) & (it < max_bisect)
    return torch.where(fail, xb, x)


def implied_vol_chain(prices, s, strikes, r, t):
    """Implied vols of a chain of call quotes at one spot and maturity
    (the JAX package's vmap of implied_vol over (price, strike))."""
    return implied_vol(prices, s, strikes, r, t)

"""Semi-analytic Heston pricing via the characteristic function (PyTorch).

Counterpart of `heston_tpu.models.heston_cf`: the Heston (1993) price of
European calls, puts (by parity) and cash-or-nothing digitals from the
Albrecher et al. "little Heston trap" characteristic function, with the
two risk-neutral probabilities integrated by Gauss–Legendre quadrature on
(0, u_max). An independent oracle for the PDE solver's converged prices,
and the pricer of `calibrate_device(pricer="cf")`.

Plain torch on tensors, in complex128 for a float64 chain and complex64
for a float32 one. The quadrature nodes are a [n_quad] vector broadcast
against the chain's [B] strike axis (the JAX package vmaps over strikes).
The parameters may be Python floats or 0-d tensors, so `torch.func.jvp`
runs through the pricer (the calibration's exact Jacobian). No kernel:
the JAX package's CF is plain XLA.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from heston_tpu_torch.models import douglas
from heston_tpu_torch.ops.operators import is_digital, is_put


@functools.lru_cache(maxsize=None)
def _gl_nodes(n: int, u_max: float):
    """Gauss-Legendre nodes/weights on (0, u_max) (host-side, cached)."""
    x, w = np.polynomial.legendre.leggauss(n)
    return (0.5 * u_max * (x + 1.0)), (0.5 * u_max * w)


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _cf(phi, t, s0, v0, kappa, eta, sigma, rho, r):
    """'Little trap' Heston characteristic function of log(S_t), in the
    JAX package's order of operations (heston_tpu/models/heston_cf.py:
    33-47)."""
    a = kappa * eta
    b = kappa
    z = rho * sigma * 1j * phi - b
    d = torch.sqrt(z * z + sigma**2 * (1j * phi + phi * phi))
    g = (b - rho * sigma * 1j * phi - d) / (b - rho * sigma * 1j * phi + d)
    exp_dt = torch.exp(-d * t)
    cc = (1j * phi * r * t
          + a / sigma**2 * (
              (b - rho * sigma * 1j * phi - d) * t
              - 2.0 * torch.log((1.0 - g * exp_dt) / (1.0 - g))))
    dd = ((b - rho * sigma * 1j * phi - d) / sigma**2
          * (1.0 - exp_dt) / (1.0 - g * exp_dt))
    log_s0 = torch.log(s0) if isinstance(s0, torch.Tensor) else math.log(s0)
    return torch.exp(cc + dd * v0 + 1j * phi * log_s0)


def _strikes(strike) -> torch.Tensor:
    """A strike or a chain as a float tensor: a float tensor keeps its
    dtype, anything else becomes float64."""
    if isinstance(strike, torch.Tensor) and strike.is_floating_point():
        return strike
    return torch.as_tensor(strike, dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _nodes_on(n: int, u_max: float, dtype: torch.dtype,
              device: torch.device):
    """The nodes and weights as tensors on a device (cached: a copy to the
    card per call would cost more than the chain's arithmetic)."""
    u, w = _gl_nodes(n, u_max)
    return (torch.as_tensor(u, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def _quadrature(strike: torch.Tensor, n_quad: int, u_max: float):
    return _nodes_on(n_quad, float(u_max), strike.dtype, strike.device)


def _probability(cf, u, w, k_log):
    """0.5 + (1/pi) int_0^u_max Re(e^{-iu log K} cf(u) / (iu)) du per
    strike: k_log [...], cf and u [n_quad]."""
    integ = torch.real(torch.exp(-1j * u * k_log[..., None]) * cf
                       / (1j * u))
    return 0.5 + (integ @ w) / math.pi


def call_price(s0, strike, v0, kappa, eta, sigma, rho, r, t,
               n_quad: int = 256, u_max: float = 200.0) -> torch.Tensor:
    """European call under Heston: S0*P1 - K*exp(-rT)*P2, for a strike
    or a chain of them (any shape)."""
    strike = _strikes(strike)
    u, w = _quadrature(strike, n_quad, u_max)
    k_log = torch.log(strike)
    cf2 = _cf(u, t, s0, v0, kappa, eta, sigma, rho, r)
    cf1 = (_cf(u - 1j, t, s0, v0, kappa, eta, sigma, rho, r)
           / _cf(-1j * torch.ones_like(u), t, s0, v0, kappa, eta, sigma,
                 rho, r))
    p1 = _probability(cf1, u, w, k_log)
    p2 = _probability(cf2, u, w, k_log)
    return s0 * p1 - strike * _exp(-r * t) * p2


def put_price(s0, strike, v0, kappa, eta, sigma, rho, r, t,
              n_quad: int = 256, u_max: float = 200.0) -> torch.Tensor:
    """European put via put-call parity: P = C - S0 + K*exp(-rT)."""
    strike = _strikes(strike)
    c = call_price(s0, strike, v0, kappa, eta, sigma, rho, r, t,
                   n_quad=n_quad, u_max=u_max)
    return c - s0 + strike * _exp(-r * t)


def digital_price(s0, strike, v0, kappa, eta, sigma, rho, r, t,
                  n_quad: int = 256, u_max: float = 200.0,
                  option_type: str = "digital_call") -> torch.Tensor:
    """European cash-or-nothing digital: the digital call paying
    1{S_T > K} is e^{-rT} * P2 (the exercise probability of the vanilla
    decomposition), the digital put e^{-rT} * (1 - P2)."""
    strike = _strikes(strike)
    u, w = _quadrature(strike, n_quad, u_max)
    cf2 = _cf(u, t, s0, v0, kappa, eta, sigma, rho, r)
    p2 = _probability(cf2, u, w, torch.log(strike))
    if is_put(option_type):
        p2 = 1.0 - p2
    return _exp(-r * t) * p2


def price_chain(s0, strikes, v0, kappa, eta, sigma, rho, r, t,
                n_quad: int = 256, option_type: str = "call",
                device=None) -> torch.Tensor:
    """Prices [B] of a chain of European vanillas or digitals. The
    strikes go to `device` (None: the card; "cpu" runs on the CPU); their
    float dtype is the chain's."""
    strikes = douglas.as_strikes(strikes, douglas.resolve_device(device))
    if is_digital(option_type):
        base = functools.partial(digital_price, option_type=option_type)
    elif is_put(option_type):
        base = put_price
    else:
        base = call_price
    return base(s0, strikes, v0, kappa, eta, sigma, rho, r, t,
                n_quad=n_quad)

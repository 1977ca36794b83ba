"""Market data of the fit traffic, and the Levenberg-Marquardt step, in
plain float64 (numpy and torch).

The fit's market is the Heston (1993) price of European calls at the
request's market state: the "little Heston trap" characteristic function
of Albrecher et al. (2007), its two probabilities integrated by
Gauss-Legendre quadrature on (0, u_max). A frozen copy of the formula of
`heston_tpu_torch/models/heston_cf.py`, in numpy and complex128.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _nodes(n: int, u_max: float):
    x, w = np.polynomial.legendre.leggauss(n)
    return 0.5 * u_max * (x + 1.0), 0.5 * u_max * w


def _cf(u, t, s0, r, kappa, eta, sigma, rho, v0):
    """The characteristic function of log S_t at u (t [m, 1], u [n]:
    complex [m, n])."""
    b = kappa - rho * sigma * 1j * u
    d = np.sqrt(b * b + sigma**2 * (1j * u + u * u))
    g = (b - d) / (b + d)
    e = np.exp(-d * t)
    c = (1j * u * r * t + kappa * eta / sigma**2
         * ((b - d) * t - 2.0 * np.log((1.0 - g * e) / (1.0 - g))))
    dd = (b - d) / sigma**2 * (1.0 - e) / (1.0 - g * e)
    return np.exp(c + dd * v0 + 1j * u * math.log(s0))


def heston_calls(s0: float, strikes, r: float, maturities, kappa: float,
                 eta: float, sigma: float, rho: float, v0: float,
                 n_quad: int = 384, u_max: float = 600.0) -> np.ndarray:
    """European call prices under Heston, no dividends, float64, of the
    `strikes` at each of the `maturities`, maturity by maturity:
    S0 P1 - K e^{-rT} P2. Within 1e-8 of the integral (n_quad 8192,
    u_max 1200) over the fit traffic's market states."""
    k = np.asarray(strikes, dtype=np.float64)
    u, w = _nodes(n_quad, float(u_max))
    rot = np.exp(-1j * np.outer(np.log(k), u)) / (1j * u)

    def prob(cf):
        # [maturities, strikes]
        return 0.5 + np.real(rot * cf[:, None, :]) @ w / math.pi

    t = np.asarray(maturities, dtype=np.float64)[:, None]
    args = (t, s0, r, kappa, eta, sigma, rho, v0)
    cf1 = _cf(u - 1j, *args) / _cf(np.array([-1j]), *args)
    calls = s0 * prob(cf1) - k * np.exp(-r * t) * prob(_cf(u, *args))
    return calls.reshape(-1)


def lm_update(jac, resid, lam):
    """The damped step d of (J^T J (1 + lam on the diagonal)) d = J^T r,
    in J's dtype (below float32, which linalg.solve does not take, the
    5 x 5 solve runs in float32 and is rounded)."""
    jtj = jac.T @ jac
    jtj = jtj * (1.0 + lam * torch.eye(jac.shape[1], dtype=jac.dtype,
                                       device=jac.device))
    rhs = (jac.T @ resid)[:, None]
    if jac.dtype in (torch.float64, torch.float32):
        return torch.linalg.solve(jtj, rhs)[:, 0]
    return torch.linalg.solve(jtj.float(), rhs.float())[:, 0].to(jac.dtype)


def clamp(vec, lo, hi):
    """The parameter clamps, elementwise."""
    return torch.minimum(torch.maximum(vec, lo), hi)

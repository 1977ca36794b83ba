"""The plain reference of book risk: the seven surface columns (price,
delta, gamma, theta, vega_v0, vanna, volga) and the five parameter
sensitivities of a book of calls, read off `heston_ref`'s own solution.

It builds on `heston_ref` (its time loop `solve`, its operators, its
stencil weights and its Jacobian) and imports nothing of the program.
The columns follow the description of the JAX package's surface risk
(heston_tpu/models/greeks.py:127-221): every stencil is the
discretization's 3-point one on the non-uniform grid, centred on the
clipped interior node and evaluated at the option's own (S0, v0) node:

* delta and gamma: w_beta and w_delta along s on the v0 row; delta adds
  gamma times the distance from the centre node to the spot node;
* vega_v0 and volga: w_beta and w_delta along v on the spot column;
  vega adds volga times the distance from the centre node to the v0
  node;
* vanna: the v-stencil of the three rows' deltas, each evaluated at the
  spot node;
* theta: -(L U + b e^{r_f dt n} + lambda) at the node, with L = A0 + A1
  + A2 the reference's operators, b = b1 + b2 its boundary vectors
  (built with e^{-r_f dt (n - 1)}) and lambda its American multiplier
  (zeros for a European book), n the option's own step count.

The Jacobian is `heston_ref.jacobian`: forward AD through the time loop
for kappa, eta, sigma and rho, the v-stencil of the surface for v0.

Where it departs from the JAX package's description:

* calls only, so there is no projected-obstacle branch (the American
  digital's multiplier rebuilt on its active set), and the boundary
  rate is r_f;
* a book at one step count a call: a mixed-maturity book runs group by
  group at the book's dt (`book`), where the JAX package scales each
  option's boundary through its own step count inside one batch;
* its surfaces are [B, ns, nv] (s-major), the JAX package's [nv, ns];
  L U is formed on the whole surface from `heston_ref`'s bands and
  shifts, not from the program's operator set, and read at the node;
* the dtype is the strikes': float64 for the reference, float32 for
  the control, inverses included.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference import heston_ref

# the order of the columns of `risk`: the seven surface columns, then
# d(kappa, eta, sigma, rho, v0)
SURFACE_KEYS = ("price", "delta", "gamma", "theta", "vega_v0", "vanna",
                "volga")
JACOBIAN_KEYS = ("kappa", "eta", "sigma", "rho", "v0")


def surface_columns(spec: heston_ref.Spec, u, lam, bk: heston_ref.Book,
                    r_f: float, dt: float, n_steps: int) -> torch.Tensor:
    """[B, 7] the SURFACE_KEYS columns of a book read off its terminal
    surfaces u and multipliers lam [B, ns, nv] after `n_steps` steps of
    `dt` (`heston_ref.solve`)."""
    b = u.shape[0]
    rows = torch.arange(b, device=u.device)
    vs, vv = bk.vec_s, bk.vec_v
    idx_s = bk.idx_s
    idx_v = bk.idx_v.expand(b)
    i = torch.clamp(idx_s, 1, spec.m1 - 1)
    j = torch.clamp(idx_v, 1, spec.m2 - 1)

    def s_at(k):
        return vs[rows, k]

    def u_at(si, vj):
        return u[rows, si, vj]

    bm, b0, bp = heston_ref.w_beta(s_at(i) - s_at(i - 1),
                                   s_at(i + 1) - s_at(i))
    dm, d0, dp = heston_ref.w_delta(s_at(i) - s_at(i - 1),
                                    s_at(i + 1) - s_at(i))
    cm, c0, cp = heston_ref.w_beta(vv[j] - vv[j - 1], vv[j + 1] - vv[j])
    em, e0, ep = heston_ref.w_delta(vv[j] - vv[j - 1], vv[j + 1] - vv[j])
    ds = s_at(idx_s) - s_at(i)
    dv = vv[idx_v] - vv[j]

    def s_stencils(vj):
        """(first, second) s-derivative of the row vj at the centre."""
        r = (u_at(i - 1, vj), u_at(i, vj), u_at(i + 1, vj))
        return (bm * r[0] + b0 * r[1] + bp * r[2],
                dm * r[0] + d0 * r[1] + dp * r[2])

    first, gamma = s_stencils(idx_v)
    col = [u_at(idx_s, jj) for jj in (j - 1, j, j + 1)]
    volga = em * col[0] + e0 * col[1] + ep * col[2]
    vega = cm * col[0] + c0 * col[1] + cp * col[2] + volga * dv
    deltas = []
    for jj in (j - 1, j, j + 1):
        f, g = s_stencils(jj)
        deltas.append(f + g * ds)
    vanna = (cm * deltas[0] + c0 * deltas[1] + cp * deltas[2]
             + (em * deltas[0] + e0 * deltas[1] + ep * deltas[2]) * dv)
    lu = (heston_ref.a0_mul(bk, u) + heston_ref.a1_mul(bk, u)
          + heston_ref.a2_mul(bk, u)
          + (bk.b1 + bk.b2) * math.exp(r_f * dt * n_steps) + lam)
    return torch.stack([u_at(idx_s, idx_v), first + gamma * ds, gamma,
                        -lu[rows, idx_s, idx_v], vega, vanna, volga], 1)


def risk(spec: heston_ref.Spec, strikes, s0, params, r_d, r_f, dt: float,
         n_steps: int, american: bool = False,
         dividends=None) -> torch.Tensor:
    """[B, 12]: the SURFACE_KEYS columns and the Jacobian in
    JACOBIAN_KEYS of a book of calls at `strikes` [B] that runs `n_steps`
    steps of `dt`; params = (kappa, eta, sigma, rho, v0)."""
    u, lam, bk = heston_ref.solve(spec, strikes, s0, *params, r_d, r_f, dt,
                                  n_steps, american, dividends)
    cols = surface_columns(spec, u, lam, bk, r_f, dt, n_steps)
    _, jac = heston_ref.jacobian(spec, strikes, s0, params, r_d, r_f, dt,
                                 n_steps, american, dividends)
    return torch.cat([cols, jac], 1)


def book(spec: heston_ref.Spec, strikes, groups, s0, params, r_d, r_f,
         dt: float, american: bool = False, dividends=None,
         block: int = 250) -> torch.Tensor:
    """[B, 12] `risk` of a mixed-maturity book: (start, end, n_steps)
    `groups` of `strikes`, each group at its own step count and the
    book's dt, in blocks of at most `block` strikes."""
    return torch.cat([
        risk(spec, strikes[i:min(i + block, e)], s0, params, r_d, r_f, dt, n,
             american, dividends)
        for a, e, n in groups for i in range(a, e, block)])


def gaps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """[12] per column, the widest |got - ref| over the book divided by
    the largest |ref| of the column."""
    got = got.to(ref.dtype)
    return ((got - ref).abs().amax(0) / ref.abs().amax(0))

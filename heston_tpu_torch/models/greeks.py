"""Book risk read off the solution surfaces (PyTorch).

Counterpart of the pallas engine's branch of `heston_tpu.models.greeks`.
`batch_greeks` prices a book, uniform or mixed-maturity, in ONE launch of
the batched Douglas kernel that returns every option's terminal surface
and American multiplier (`kernels.fused_do.fused_surface_batch`), then
reads price, delta, gamma, calendar theta, vega_v0, vanna and volga off
each surface with the discretization's own stencils (`_surface_risk`,
vectorised over the book); theta applies the operator set the same
assembly built. Any `SolverConfig.scheme` runs; the JAX package
recommends "hv" for vanna and volga (heston_tpu/models/greeks.py:
187-191). A curve book (`rate_schedule`) takes one launch per rate
segment piece, and theta its last segment's operators and boundary rate.
Optional extras: the five exact model-parameter sensitivities through
the forward-mode kernel (`param_jacobian`) and the rate sensitivities by
central differences of bumped launches (`rates`).

The entry points run on the card unless the caller passes `device="cpu"`
(the plain versions of the kernels). `price_and_greeks` differentiates
the eager pricer for delta and waits for it (ROADMAP A6).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from heston_tpu_torch.config import DividendSchedule, GridSpec, SolverConfig
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import douglas
from heston_tpu_torch.models.calibration import (lane_steps,
                                                 validate_group_steps)
from heston_tpu_torch.ops import coeff, operators
from heston_tpu_torch.ops import grid as gridmod

# the per-option columns of every book-risk pass
RISK_KEYS = ("price", "delta", "gamma", "theta", "vega_v0", "vanna",
             "volga")


def _terminal_b_rate(solver, option_type, r_d, r_f, rate_schedule=None):
    """Boundary rate at valuation time tau = T: the scalar rates' for a
    flat book, the last calendar segment's for a curve book (the theta
    epilogue applies e^{b_rate dt N} against ops.b's baked anchor;
    heston_tpu/models/greeks.py:34-43)."""
    if rate_schedule is None:
        return operators.boundary_rate(r_d, r_f, option_type)
    return operators.rate_segment_structure(
        solver.n_steps, solver.delta_t, solver.maturity, rate_schedule,
        option_type)[-1][4]


def _book_prices(spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d,
                 r_f, american, dividends, option_type, group_steps=()):
    """Prices of a (possibly mixed-maturity) book in one launch of the
    batched kernel (heston_tpu/models/greeks.py:46-68, fused branch)."""
    return fused_do.fused_price_batch(
        spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american=american, dividends=dividends, option_type=option_type,
        n_steps_per=lane_steps(group_steps))


def _rates_rho(spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
               american, dividends, option_type, group_steps=()):
    """(dP/dr_d, dP/dr_f) [B] by central differences, two bumped launches
    per rate (the rates move the A1 Q-rows and the boundary scaling, which
    the forward-mode kernel takes as constants; heston_tpu/models/
    greeks.py:101-116). eps 2e-3 in float32, 1e-5 in float64; the bumped
    rates are formed in the book's dtype."""
    dtype = ks.dtype
    eps = torch.tensor(2e-3 if dtype == torch.float32 else 1e-5, dtype=dtype)
    rd = torch.tensor(float(r_d), dtype=dtype)
    rf = torch.tensor(float(r_f), dtype=dtype)
    args = (spec, solver, ks, s0, kappa, eta, sigma, rho, v0)
    tail = (american, dividends, option_type, group_steps)

    def prices(a, b):
        return _book_prices(*args, float(a), float(b), *tail)

    rho_rd = (prices(rd + eps, rf) - prices(rd - eps, rf)) / (2 * eps)
    rho_rf = (prices(rd, rf + eps) - prices(rd, rf - eps)) / (2 * eps)
    return rho_rd, rho_rf


def _surface_risk(spec, solver, b_rate, u, lam, ops, vs, vv, idx_s, idx_v,
                  nsf, active=None):
    """price / delta / gamma / theta / vega_v0 / vanna / volga [B] read off
    the surfaces u and multipliers lam [B, ns, nv] (heston_tpu/models/
    greeks.py:127-221, vectorised over the book): delta = w_beta and
    gamma = w_delta along s, vega_v0 = w_beta and volga = w_delta along v
    at the inserted v0 node, vanna = the v-stencil of the three rows'
    deltas, theta = -(L U + b e^{rate dt n_i} + lam) at the node. Each
    stencil is centred on the clipped interior node and evaluated at the
    actual one (a no-op for interior nodes). vs [B, ns], vv [nv], idx_s
    and idx_v [B], nsf [B] each option's own step count. `active`
    (optional, [B, ns, nv] bool): a projected obstacle's active set (an
    American digital carries no multiplier): there the multiplier is
    rebuilt from complementarity, lambda = max(0, -(L U + b)), so theta
    reads 0 in the stopping region (heston_tpu/models/greeks.py:170-177)."""
    rows_b = torch.arange(u.shape[0], device=u.device)
    i = torch.clamp(idx_s, 1, spec.m1 - 1)
    j = torch.clamp(idx_v, 1, spec.m2 - 1)

    def at_s(k):
        return vs[rows_b, k]

    def u_at(si, vj):
        return u[rows_b, si, vj]

    h0 = at_s(i) - at_s(i - 1)
    h1 = at_s(i + 1) - at_s(i)
    bm, b0, bp = coeff.w_beta(h0, h1)
    dm, d0, dp = coeff.w_delta(h0, h1)
    du = (operators.a0_multiply(ops, u) + operators.a1_multiply(ops, u)
          + operators.a2_multiply(ops, u)
          + ops.b * torch.exp(b_rate * solver.delta_t * nsf)[:, None, None]
          + lam)
    if active is not None:
        du = du + torch.where(active, torch.clamp(-du, min=0.0),
                              torch.zeros_like(du))
    row = (u_at(i - 1, idx_v), u_at(i, idx_v), u_at(i + 1, idx_v))
    gamma_i = dm * row[0] + d0 * row[1] + dp * row[2]
    delta_i = bm * row[0] + b0 * row[1] + bp * row[2]

    g0 = vv[j] - vv[j - 1]
    g1 = vv[j + 1] - vv[j]
    cm, c0, cp = coeff.w_beta(g0, g1)
    em, e0, ep = coeff.w_delta(g0, g1)
    dv = vv[idx_v] - vv[j]
    ds = at_s(idx_s) - at_s(i)
    vrows = (j - 1, j, j + 1)
    col = [u_at(idx_s, jj) for jj in vrows]
    volga = em * col[0] + e0 * col[1] + ep * col[2]
    vega = cm * col[0] + c0 * col[1] + cp * col[2] + volga * dv

    def row_delta(jj):
        r = (u_at(i - 1, jj), u_at(i, jj), u_at(i + 1, jj))
        g_r = dm * r[0] + d0 * r[1] + dp * r[2]
        d_r = bm * r[0] + b0 * r[1] + bp * r[2]
        return d_r + g_r * ds

    deltas = [row_delta(jj) for jj in vrows]
    dvanna_dv = em * deltas[0] + e0 * deltas[1] + ep * deltas[2]
    vanna = cm * deltas[0] + c0 * deltas[1] + cp * deltas[2] + dvanna_dv * dv
    return dict(
        price=u_at(idx_s, idx_v),
        delta=delta_i + gamma_i * ds,
        gamma=gamma_i,
        theta=-du[rows_b, idx_s, idx_v],
        vega_v0=vega,
        vanna=vanna,
        volga=volga,
    )


def fused_book_risk(spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d,
                    r_f, american=False, dividends=None, option_type="call",
                    nst=None, rate_schedule=None):
    """Book risk from the launches of the batched kernel (the surfaces, the
    multipliers and the operator set of `fused_surface_batch`) plus the
    stencil and theta epilogues (heston_tpu/models/greeks.py:352-396).
    `nst`: optional per-option step counts [B]; `rate_schedule`: an
    optional curve."""
    surfaces = fused_do.fused_surface_batch(
        spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american=american, dividends=dividends, option_type=option_type,
        n_steps_per=nst, rate_schedule=rate_schedule)
    return risk_epilogue(spec, solver, ks, v0, r_d, r_f, surfaces,
                         option_type, nst, american, rate_schedule)


def risk_epilogue(spec, solver, ks, v0, r_d, r_f, surfaces,
                  option_type="call", nst=None, american=False,
                  rate_schedule=None):
    """The RISK_KEYS columns [B] of a book of strikes `ks` from its
    surfaces = (u, lam, ops, vec_s, idx_s, idx_v), the output of
    `fused_surface_batch`; `nst`: optional per-option step counts;
    `rate_schedule`: the curve of a curve book (theta's boundary rate). An
    American digital book's active set is where the surface equals the
    (barrier-masked) payoff exactly: the projection writes the payoff
    bitwise where it binds (heston_tpu/models/greeks.py:383-394)."""
    u, lam, ops, vec_s, idx_s, idx_v = surfaces
    active = None
    if american and operators.is_digital(option_type):
        u0 = operators.grid_payoff(vec_s, ks[:, None], option_type)
        if spec.barrier is not None:
            u0 = spec.barrier.mask_payoff(u0)
        active = u == u0[:, :, None]
    nsf = (torch.full_like(ks, float(solver.n_steps)) if nst is None
           else nst.to(dtype=ks.dtype, device=ks.device))
    # the v grid is strike-independent (v0 insertion only): one vector
    # serves the whole book
    vv = gridmod.make_v_nodes(spec.m2, spec.v_max, v0,
                              spec.v_max / spec.d_div, ks.dtype, ks.device)
    b_rate = _terminal_b_rate(solver, option_type, r_d, r_f, rate_schedule)
    return _surface_risk(spec, solver, b_rate, u, lam, ops, vec_s, vv,
                         idx_s, idx_v, nsf, active)


def batch_greeks(
    spec: GridSpec,
    solver: SolverConfig,
    strikes,
    s0,
    kappa, eta, sigma, rho, v0, r_d, r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    param_jacobian: bool = False,
    group_steps=(),
    rates: bool = False,
    rate_schedule=None,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Book risk in ONE batched solve: the RISK_KEYS columns [B] for every
    option, read off its solution surface (heston_tpu/models/greeks.py:
    403-565, the fused engine's branch). The strikes go to `device`
    (None: the card; "cpu" runs the plain version of the kernel); the
    dtype is the strikes'. A batch of one stays on the batched kernel.

    group_steps: optional (start, end, n_steps) slices of a mixed-maturity
    book under the shared-dt convention T_i = n_i * solver.delta_t with
    solver.n_steps = max(n_i); the whole book still runs in one launch
    (per-option step counts). param_jacobian=True adds
    "param_jacobian" [B, 5], the exact d(kappa, eta, sigma, rho, v0)
    through one launch of the forward-mode kernel; rates=True adds
    "rho_rd" and "rho_rf" by central differences of bumped launches.

    rate_schedule: an optional `config.RateSchedule` (the scalar r_d,
    r_f are then not read): one launch per rate segment piece
    (`fused_surface_batch`). As in the JAX package (heston_tpu/models/
    greeks.py:451-462) it composes with neither group_steps nor
    rates=True (ValueError); its param_jacobian runs the JAX package's
    XLA linearize path, not the fused kernel, and raises
    NotImplementedError (ROADMAP A6)."""
    if solver.solver_engine != "pallas":
        raise NotImplementedError(
            f"solver_engine {solver.solver_engine!r} is not ported yet; "
            f"only 'pallas', the fused time-loop kernel (ROADMAP A6)")
    if rate_schedule is not None and group_steps:
        raise ValueError(
            "rate_schedule does not compose with group_steps: risk a "
            "mixed-maturity curve book per maturity group")
    if rate_schedule is not None and rates:
        raise ValueError(
            "rates=True is undefined for curve books (the scalar r_d, r_f "
            "are not read): bump the RateSchedule and reprice")
    if rate_schedule is not None and param_jacobian:
        raise NotImplementedError(
            "the parameter Jacobian of a curve book runs the XLA linearize "
            "path of the eager pricer, which is not ported yet (ROADMAP A6)")
    ks = douglas.as_strikes(strikes, douglas.resolve_device(device))
    if group_steps:
        validate_group_steps(group_steps, int(ks.shape[0]),
                             n_steps=solver.n_steps)
    nst = lane_steps(group_steps)
    out = fused_book_risk(spec, solver, ks, s0, kappa, eta, sigma, rho, v0,
                          r_d, r_f, american=american, dividends=dividends,
                          option_type=option_type, nst=nst,
                          rate_schedule=rate_schedule)
    if param_jacobian:
        tv = torch.tensor([float(x) for x in (kappa, eta, sigma, rho, v0)],
                          dtype=ks.dtype, device=ks.device)
        _, out["param_jacobian"] = fused_do.fused_theta_jacobian(
            spec, solver, ks, s0, tv, r_d, r_f, american=american,
            dividends=dividends, option_type=option_type, n_steps_per=nst)
    if rates:
        out["rho_rd"], out["rho_rf"] = _rates_rho(
            spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
            american, dividends, option_type, group_steps)
    return out


def pde_theta(spec: GridSpec, solver: SolverConfig, strike, s0, kappa, eta,
              sigma, rho, v0, r_d, r_f, american: bool = False,
              dividends: Optional[DividendSchedule] = None,
              option_type: str = "call", rate_schedule=None,
              device=None) -> torch.Tensor:
    """Calendar theta dPrice/dt of one option from the PDE itself,
    -(L U + b + lambda) at the extraction node: a thin wrapper over
    batch_greeks."""
    return batch_greeks(
        spec, solver, torch.as_tensor(strike).reshape(1), s0, kappa, eta,
        sigma, rho, v0, r_d, r_f, american=american, dividends=dividends,
        option_type=option_type, rate_schedule=rate_schedule,
        device=device)["theta"][0]


def gamma(spec: GridSpec, solver: SolverConfig, strike, s0, kappa, eta,
          sigma, rho, v0, r_d, r_f, american: bool = False,
          dividends: Optional[DividendSchedule] = None,
          option_type: str = "call", rate_schedule=None,
          device=None) -> torch.Tensor:
    """d2Price/dS0^2 of one option: the w_delta stencil of its solution
    surface at the spot node (one solve): a thin wrapper over
    batch_greeks."""
    return batch_greeks(
        spec, solver, torch.as_tensor(strike).reshape(1), s0, kappa, eta,
        sigma, rho, v0, r_d, r_f, american=american, dividends=dividends,
        option_type=option_type, rate_schedule=rate_schedule,
        device=device)["gamma"][0]


def price_and_greeks(*args, **kwargs):
    """Price, delta, vega_v0 and the five model-parameter sensitivities of
    one option (heston_tpu/models/greeks.py:250-349). Its delta and rate
    sensitivities linearize the eager pricer `douglas.price_option`,
    which is not ported yet."""
    raise NotImplementedError(
        "price_and_greeks linearizes the eager Douglas pricer, which is not "
        "ported yet (ROADMAP A6); batch_greeks(param_jacobian=True, "
        "rates=True) gives the book's sensitivities")

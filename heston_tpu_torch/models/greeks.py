"""Greeks and book risk read off the solution surfaces (PyTorch).

Counterpart of `heston_tpu.models.greeks`. `batch_greeks` prices a book,
uniform or mixed-maturity, and reads price, delta, gamma, calendar theta,
vega_v0, vanna and volga off each option's terminal surface with the
discretization's own stencils (`_surface_risk`, vectorised over the
book); theta applies the operator set of the same assembly. Under
"pallas" the surfaces and the American multipliers come from ONE launch
of the batched kernel (`kernels.fused_do.fused_surface_batch`); under
"scan" and "pcr" from the eager loop (`models.douglas.run_time_loop`),
one maturity group at a time. Any `SolverConfig.scheme` runs; the JAX
package recommends "hv" for vanna and volga (heston_tpu/models/greeks.py:
187-191). A curve book (`rate_schedule`) takes its segments' operator
sets, and theta its last segment's operators and boundary rate.
Optional extras: the five exact model-parameter sensitivities
(`param_jacobian`: the forward-mode kernel under "pallas" at flat rates,
else the eager loop linearized) and the rate sensitivities (`rates`:
central differences of bumped launches under "pallas", exact AD through
the eager loop otherwise). `price_and_greeks` gives one option's price,
delta and parameter and rate sensitivities by forward-mode AD.

The entry points run on the card unless the caller passes `device="cpu"`
(the plain versions of the kernels).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from heston_tpu_torch.config import DividendSchedule, GridSpec, SolverConfig
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import douglas
from heston_tpu_torch.models.calibration import jacobian_and_prices_ad
from heston_tpu_torch.ops import coeff, operators
from heston_tpu_torch.ops import grid as gridmod
from heston_tpu_torch.utils.profiling import scope

# the per-option columns of every book-risk pass
RISK_KEYS = ("price", "delta", "gamma", "theta", "vega_v0", "vanna",
             "volga")
# `batch_greeks` calls so far and the options they risked
BATCH_GREEKS = {"calls": 0, "lanes": 0}


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
    """Prices of a (possibly mixed-maturity) book (heston_tpu/models/
    greeks.py:46-83) through `douglas.price_batch`: one launch of the
    batched kernel under "pallas" (a book of one too, as the rest of book
    risk), else the eager loop on the "scan" engine per maturity group."""
    if solver.solver_engine == "pallas":
        group_steps = group_steps or ((0, int(ks.shape[0]), solver.n_steps),)
    else:
        solver = dataclasses.replace(solver, solver_engine="scan")
    return douglas.price_batch(
        spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
        american=american, dividends=dividends, option_type=option_type,
        device=ks.device, group_steps=group_steps)


def _rates_rho(spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
               american, dividends, option_type, group_steps=()):
    """(dP/dr_d, dP/dr_f) [B] (heston_tpu/models/greeks.py:86-124). Under
    "pallas" by central differences, two bumped launches per rate (the
    rates move the A1 Q-rows and the boundary scaling, which the
    forward-mode kernel takes as constants): eps 2e-3 in float32, 1e-5 in
    float64, the bumped rates formed in the book's dtype. Under the eager
    engines by exact forward-mode AD through `_book_prices`."""
    dtype = ks.dtype
    args = (spec, solver, ks, s0, kappa, eta, sigma, rho, v0)
    tail = (american, dividends, option_type, group_steps)
    if solver.solver_engine != "pallas":
        x = torch.tensor([float(r_d), float(r_f)], dtype=dtype,
                         device=ks.device)
        cols, _ = douglas.linearize(
            lambda rates: _book_prices(*args, *rates, *tail), x)
        return cols[0], cols[1]
    eps = torch.tensor(2e-3 if dtype == torch.float32 else 1e-5, dtype=dtype)
    rd = torch.tensor(float(r_d), dtype=dtype)
    rf = torch.tensor(float(r_f), dtype=dtype)

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


@scope("risk_epilogue")
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


@scope("batch_greeks")
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
    """Book risk: the RISK_KEYS columns [B] for every option, read off its
    solution surface (heston_tpu/models/greeks.py:403-565). The strikes go
    to `device` (None: the card; "cpu" runs the plain version of the
    kernel); the dtype is the strikes'. Under "pallas" the whole book,
    a batch of one included, runs in one pass of the batched kernel;
    under "scan" and "pcr" the eager loop runs each maturity group.

    group_steps: optional (start, end, n_steps) slices of a mixed-maturity
    book under the shared-dt convention T_i = n_i * solver.delta_t with
    solver.n_steps = max(n_i); under "pallas" the whole book still runs
    in one launch (per-option step counts). param_jacobian=True adds
    "param_jacobian" [B, 5], the exact d(kappa, eta, sigma, rho, v0):
    one launch of the forward-mode kernel under "pallas", the eager loop
    linearized per group otherwise (`calibration.jacobian_and_prices_ad`).
    rates=True adds "rho_rd" and "rho_rf" (`_rates_rho`).

    rate_schedule: an optional `config.RateSchedule` (the scalar r_d,
    r_f are then not read): under "pallas" one launch per rate segment
    piece (`fused_surface_batch`). As in the JAX package (heston_tpu/
    models/greeks.py:451-462) it composes with neither group_steps nor
    rates=True (ValueError); its param_jacobian linearizes the eager loop
    under every engine.

    Counts each call and its options in `BATCH_GREEKS`."""
    if rate_schedule is not None and group_steps:
        raise ValueError(
            "rate_schedule does not compose with group_steps: risk a "
            "mixed-maturity curve book per maturity group")
    if rate_schedule is not None and rates:
        raise ValueError(
            "rates=True is undefined for curve books (the scalar r_d, r_f "
            "are not read): bump the RateSchedule and reprice")
    ks = douglas.as_strikes(strikes, douglas.resolve_device(device))
    BATCH_GREEKS["calls"] += 1
    BATCH_GREEKS["lanes"] += int(ks.shape[0])
    if group_steps:
        douglas.validate_group_steps(group_steps, int(ks.shape[0]),
                             n_steps=solver.n_steps)
    nst = douglas.lane_steps(group_steps)
    if solver.solver_engine == "pallas":
        out = fused_book_risk(spec, solver, ks, s0, kappa, eta, sigma, rho,
                              v0, r_d, r_f, american=american,
                              dividends=dividends, option_type=option_type,
                              nst=nst, rate_schedule=rate_schedule)
    else:
        douglas._validate_barrier_book(spec, s0, ks)
        groups = group_steps or ((0, int(ks.shape[0]), None),)
        parts = [_eager_group_risk(
            spec, solver, ks[a:e], s0, kappa, eta, sigma, rho, v0, r_d, r_f,
            american, dividends, option_type, rate_schedule, n)
            for a, e, n in groups]
        out = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    if param_jacobian:
        tv = torch.tensor([float(x) for x in (kappa, eta, sigma, rho, v0)],
                          dtype=ks.dtype, device=ks.device)
        # a curve book's Jacobian takes the eager loop under every engine
        # (the forward-mode kernel runs flat-rate books)
        jac_kw = dict(american=american, dividends=dividends,
                      option_type=option_type, device=ks.device)
        if rate_schedule is not None:
            jac, _ = jacobian_and_prices_ad(spec, solver, ks, s0, tv, r_d,
                                            r_f, rate_schedule=rate_schedule,
                                            **jac_kw)
        elif solver.solver_engine == "pallas":
            _, jac = fused_do.fused_theta_jacobian(
                spec, solver, ks, s0, tv, r_d, r_f, american=american,
                dividends=dividends, option_type=option_type,
                n_steps_per=nst)
        else:
            jac = torch.cat([jacobian_and_prices_ad(
                spec, douglas.group_solver(solver, n), ks[a:e], s0, tv, r_d,
                r_f, **{**jac_kw, "dividends": douglas.group_dividends(
                    solver, dividends, n)})[0] for a, e, n in groups])
        out["param_jacobian"] = jac
    if rates:
        out["rho_rd"], out["rho_rf"] = _rates_rho(
            spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d, r_f,
            american, dividends, option_type, group_steps)
    return out


def _eager_group_risk(spec, solver, ks, s0, kappa, eta, sigma, rho, v0, r_d,
                      r_f, american, dividends, option_type, rate_schedule,
                      n):
    """The RISK_KEYS columns of one maturity group (n steps; the book's
    count for None) off the eager loop's surfaces and multipliers
    (heston_tpu/models/greeks.py:487-517). The stencils and theta read
    the book's solver (its dt), the loop the group's, with the dividends
    on the book's step axis (`douglas.group_dividends`)."""
    sol_g = douglas.group_solver(solver, n)
    inst = douglas.prepare_instance(spec, sol_g, ks, s0, kappa, eta, sigma,
                                    rho, v0, r_d, r_f, option_type,
                                    rate_schedule)
    u, lam = douglas.run_time_loop(
        inst, sol_g, _terminal_b_rate(solver, option_type, r_d, r_f,
                                      rate_schedule),
        american, douglas.group_dividends(solver, dividends, n), option_type,
        with_lambda=True, rate_schedule=rate_schedule)
    nst = torch.full(ks.shape, sol_g.n_steps, device=ks.device)
    return risk_epilogue(
        spec, solver, ks, v0, r_d, r_f,
        (u, lam, inst.ops, inst.grid.vec_s, inst.idx_s,
         inst.idx_v.expand(ks.shape)), option_type, nst, american,
        rate_schedule)


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


def price_and_greeks(spec: GridSpec, solver: SolverConfig, strike, s0, kappa,
                     eta, sigma, rho, v0, r_d, r_f, american: bool = False,
                     dividends: Optional[DividendSchedule] = None,
                     option_type: str = "call", rate_schedule=None,
                     device=None) -> Dict[str, torch.Tensor]:
    """Price, delta, vega_v0 and the five model-parameter sensitivities of
    one option by forward-mode AD (heston_tpu/models/greeks.py:250-349);
    0-d tensors in the strike's dtype, on `device` (None: the card).

    Under "pallas" at flat rates the parameter sensitivities come from
    one launch of the forward-mode kernel (`fused_do.
    fused_theta_jacobian`, vega_v0 its surface v-stencil column), and
    delta and the rate sensitivities rho_rd, rho_rf from one linearized
    solve of the eager loop on "scan" over (s0, r_d, r_f): the spot moves
    the s-grid, a tangent the kernel does not carry. Otherwise the eager
    loop linearized over (s0, kappa, eta, sigma, rho, r_d, r_f), vega_v0
    the surface v-stencil (`douglas.price_and_v0_stencil`); with a
    `rate_schedule` over the first five only, and the result has no
    rho_rd, rho_rf (bump the curve and reprice for those)."""
    ks = douglas.as_strikes(strike, douglas.resolve_device(device)).reshape(1)
    douglas._validate_barrier_book(spec, s0, ks)
    dtype, dev = ks.dtype, ks.device

    def vec(*xs):
        return torch.tensor([float(x) for x in xs], dtype=dtype, device=dev)

    kw = dict(american=american, dividends=dividends,
              option_type=option_type)
    if solver.solver_engine == "pallas" and rate_schedule is None:
        base, jac = fused_do.fused_theta_jacobian(
            spec, solver, ks, s0, vec(kappa, eta, sigma, rho, v0), r_d, r_f,
            **kw)
        xla = dataclasses.replace(solver, solver_engine="scan")

        def price_s0_rates(x):
            return douglas._price(spec, xla, ks, x[0], kappa, eta, sigma,
                                  rho, v0, x[1], x[2], american, dividends,
                                  option_type, None)[0]

        (delta, rho_rd, rho_rf), _ = douglas.linearize(
            price_s0_rates, vec(s0, r_d, r_f))
        return {"price": base[0], "delta": delta, "d_kappa": jac[0, 0],
                "d_eta": jac[0, 1], "d_sigma": jac[0, 2],
                "d_rho": jac[0, 3], "vega_v0": jac[0, 4], "rho_rd": rho_rd,
                "rho_rf": rho_rf}

    def price_fn(x):
        price, dv = douglas._price_and_v0_stencil(
            spec, solver, ks, x[0], x[1], x[2], x[3], x[4], v0, x[5], x[6],
            american, dividends, option_type, rate_schedule)
        return price[0], dv[0]

    n_tg = 5 if rate_schedule is not None else 7
    grads, (price, vega_v0) = douglas.linearize(
        price_fn, vec(s0, kappa, eta, sigma, rho, r_d, r_f), n_tg,
        has_aux=True)
    out = {"price": price, "delta": grads[0], "d_kappa": grads[1],
           "d_eta": grads[2], "d_sigma": grads[3], "d_rho": grads[4],
           "vega_v0": vega_v0}
    if rate_schedule is None:
        out["rho_rd"], out["rho_rf"] = grads[5], grads[6]
    return out

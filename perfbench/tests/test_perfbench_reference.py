"""The plain reference: the upstream golden pins in float64, the
program's plain versions (CPU) at a small size, a mixed-maturity book and
its Jacobian, and the fit's Heston market."""

import pytest
import torch

from perfbench.reference import heston_ref as R
from perfbench.reference import market

GOLDEN_CONVERGED = 8.8943383103218502   # ref src/solver.cpp:390-401
P = (1.5, 0.04, 0.3, -0.9, 0.04)


def spec(m1, m2, variant):
    return R.Spec(m1, m2, 8.0, 0.2, 5.0, 500.0, 0.8, variant)


def f64(*ks):
    return torch.tensor(ks, dtype=torch.float64)


def test_golden_grid():
    """100 x 75 x 20, central A2, K = 100, European: the scheme's value
    (tests/test_douglas.py:50) and its distance to the converged golden
    price."""
    price = float(R.prices(spec(100, 75, "central"), f64(100.0), 100.0, P,
                           0.025, 0.0, 0.05, 20)[0])
    assert price == pytest.approx(8.869179918466847, abs=1e-9)
    assert abs(price - GOLDEN_CONVERGED) < 0.026


def test_american_and_dividend_pins():
    s = spec(50, 25, "upwind")
    amer = R.prices(s, f64(95.0), 100.0, P, 0.025, 0.0, 0.05, 20, True,
                    R.GOLDEN_DIVIDENDS)
    div = R.prices(s, f64(100.0), 100.0, P, 0.025, 0.0, 0.05, 20, False,
                   R.GOLDEN_DIVIDENDS)
    assert float(amer[0]) == pytest.approx(8.510573074266677, abs=1e-9)
    assert float(div[0]) == pytest.approx(3.85096222593301, abs=1e-9)


def test_against_the_programs_plain_versions():
    from heston_tpu_torch import GOLDEN_DIVIDENDS, GridSpec, SolverConfig
    from heston_tpu_torch.kernels import fused_do

    s, gs = spec(20, 12, "upwind"), GridSpec(20, 12)
    sol = SolverConfig(n_steps=20, solver_engine="pallas")
    p = (1.3, 0.045, 0.35, -0.7, 0.037)
    groups = ((0, 5, 4), (5, 10, 10), (10, 15, 20))
    ks = torch.linspace(70.0, 130.0, 5, dtype=torch.float64).repeat(3)
    nst = torch.tensor([n for a, b, n in groups for _ in range(b - a)])
    prog = fused_do.fused_price_batch(
        gs, sol, ks, 100.0, *p, 0.025, 0.0, american=True,
        dividends=GOLDEN_DIVIDENDS, n_steps_per=nst)
    ref = torch.cat([R.prices(s, ks[a:b], 100.0, p, 0.025, 0.0, 0.05, n,
                              True, R.GOLDEN_DIVIDENDS)
                     for a, b, n in groups])
    assert float((prog - ref).abs().max()) < 1e-11
    base, jac = fused_do.fused_theta_jacobian(
        gs, sol, ks, 100.0, torch.tensor(p, dtype=torch.float64), 0.025,
        0.0, n_steps_per=nst)
    jr = [R.jacobian(s, ks[a:b], 100.0, p, 0.025, 0.0, 0.05, n)
          for a, b, n in groups]
    assert float((base - torch.cat([b for b, _ in jr])).abs().max()) < 1e-11
    assert float((jac - torch.cat([j for _, j in jr])).abs().max()) < 1e-9


def test_heston_market():
    """The fit's market: Case 1's European call at S0 = K = 100, T = 1 is
    the semi-analytic 8.8948693600540167 (upstream src/solver.cpp:1666),
    and the quadrature is converged at the ladder's shortest maturity."""
    case1 = (1.5, 0.04, 0.3, -0.9, 0.04)
    price = market.heston_calls(100.0, [100.0], 0.025, [1.0], *case1)
    assert float(price[0]) == pytest.approx(8.8948693600540167, abs=1e-11)
    ks = [80.0 + 2.0 * i for i in range(20)]
    corner = (1.0, 0.03, 0.4, -0.9, 0.03)
    got = market.heston_calls(100.0, ks, 0.025, [0.1, 1.0], *corner)
    fine = market.heston_calls(100.0, ks, 0.025, [0.1, 1.0], *corner,
                               n_quad=8192, u_max=1200.0)
    assert abs(got - fine).max() < 1e-8 and got.min() > 0.0

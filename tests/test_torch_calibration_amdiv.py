"""`calibrate_device` on the upstream's American-with-dividends
multi-maturity chain (src/heston_calibration.cpp:3245-3821), on the CPU
in float64 (the plain versions of the kernels), at a small grid: four
maturity groups in one chain, the calibration's two dividends on step
boundaries, a Black-Scholes market with escrowed dividends at a seeded
flat vol. Held against the benchmark's plain reference: the
Levenberg-Marquardt loop of `perfbench/reference/lm.py` on
`heston_ref`'s prices and Jacobian and `bs_market`'s market; the
reference in float32 must fail the same tolerance. No JAX."""

import numpy as np
import pytest
import torch

from heston_tpu_torch import CalibrationConfig, GridSpec, SolverConfig
from heston_tpu_torch.models import bs, calibration
from heston_tpu_torch.scenarios import CALIB_DIVIDENDS
from perfbench.reference import bs_market, heston_ref, lm

SPEC = GridSpec(m1=20, m2=10)
# dt = 1/4: the dividends at 0.25 and 0.75 fall on steps 1 and 3, the last
# steps of the 0.25 and 0.75 groups
SOLVER = SolverConfig(n_steps=4, a2_variant="upwind", solver_engine="pallas")
MATS = (0.25, 0.5, 0.75, 1.0)
K_ONE = (88.0, 100.0, 112.0)
GROUPS = tuple((3 * i, 3 * i + 3, i + 1) for i in range(len(MATS)))
KS = torch.tensor(K_ONE * len(MATS), dtype=torch.float64)
S0, R_D, R_F = 100.0, 0.025, 0.0
DIVS = tuple(zip(CALIB_DIVIDENDS.dates, CALIB_DIVIDENDS.amounts,
                 CALIB_DIVIDENDS.percentages))
# the cell's LM settings (traffic/calib_amdiv80_f64.json), from Case 1,
# cut to the first two iterations (an accepted step, then one at the
# damping it moved)
LM = {"max_iter": 2, "tol": 0.1, "jacobian_mode": "ad", "lambda_init": 0.01,
      "lambda_down": 0.1, "lambda_up": 10.0, "lambda_min": 1e-07,
      "lambda_max": 1e7, "init": [1.5, 0.04, 0.3, -0.9, 0.04],
      "clamp_lo": [0.001, 0.01, 0.01, -1.0, 0.01],
      "clamp_hi": [None, None, None, 1.0, None]}
INIT = torch.tensor(LM["init"], dtype=torch.float64)
CFG = CalibrationConfig(max_iter=LM["max_iter"], tol=LM["tol"],
                        jacobian_mode="ad")
REF_SPEC = heston_ref.Spec(SPEC.m1, SPEC.m2, SPEC.s_max_mult, SPEC.c_mult,
                           SPEC.v_max, SPEC.d_div, SOLVER.theta,
                           SOLVER.a2_variant)
# flat vols drawn as the cell draws them
VOLS = [float(v) for v in np.random.default_rng(23).uniform(0.15, 0.25, 2)]
# The iterates' tolerance, relative to each parameter's size: the plain
# versions and the reference agree to ~1e-11 in price here (Thomas and
# penta sweeps against dense inverses), and the damped 5x5 solve carries
# that into the iterates at 1.5e-11 to 1.8e-11 after the first iteration
# and 2.9e-10 to 6.3e-10 after the second; a path of 15 iterations at a
# small damping drifts further (~1e-7: J^T J's conditioning), so the
# comparison stops early. The reference in float32 moves the first
# iterate by 1.6e-2 to 1.8e-2 already.
RTOL = 1e-8


@pytest.fixture(autouse=True)
def one_thread():
    """The reference's small tensor operations run fastest on one
    thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def market(vol):
    return bs_market.calls(S0, K_ONE, R_D, MATS, vol, DIVS)


def program(vol):
    return calibration.calibrate_device(
        SPEC, SOLVER, KS, market(vol), S0, INIT, R_D, R_F,
        cfg=CFG, american=True, dividends=CALIB_DIVIDENDS,
        group_steps=GROUPS, device="cpu")


def reference(vol, dtype, max_iter=LM["max_iter"]):
    ks, dt = KS.to(dtype), SOLVER.maturity / SOLVER.n_steps

    def chain(params, jac=False):
        fn = heston_ref.jacobian if jac else heston_ref.prices
        parts = [fn(REF_SPEC, ks[a:b], S0, params, R_D, R_F, dt, n, True,
                    DIVS) for a, b, n in GROUPS]
        if not jac:
            return torch.cat(parts)
        return (torch.cat([p for p, _ in parts]),
                torch.cat([j for _, j in parts]))

    return lm.fit(lambda p: chain(p, jac=True), chain, market(vol).to(dtype),
                  LM["init"], dict(LM, max_iter=max_iter))


def gap(got, want):
    """The widest relative gap between two fits' iterates, and whether
    their iteration counts agree."""
    it = got[1]["iterations"]
    a = got[1]["history"]["params"][:it].double()
    b = want[1]["history"]["params"][:it].double()
    return (float(((a - b).abs() / b.abs()).max()),
            it == want[1]["iterations"])


@pytest.fixture(scope="module")
def fits():
    return {vol: program(vol) for vol in VOLS}


@pytest.mark.parametrize("vol", VOLS)
def test_fit_matches_the_reference_lm(fits, vol):
    """The iterates, the iteration count, the final SSE and the fitted
    prices of the program's fit against the reference's loop, in
    float64."""
    got, want = fits[vol], reference(vol, torch.float64)
    rel, same_count = gap(got, want)
    assert got[1]["iterations"] == LM["max_iter"]
    assert same_count and rel < RTOL, rel
    assert torch.equal(got[1]["history"]["accepted"],
                       want[1]["history"]["accepted"])
    # the reference's loop returns its final SSE in float32: its fitted
    # prices give it in float64
    ref_sse = float(((market(vol) - want[1]["fitted_prices"]) ** 2).sum())
    assert float(got[1]["final_error"]) == pytest.approx(ref_sse, rel=RTOL)
    torch.testing.assert_close(got[1]["fitted_prices"],
                               want[1]["fitted_prices"], rtol=RTOL,
                               atol=1e-12)


def test_reference_in_float32_fails_the_tolerance(fits):
    """Its first iterate alone is outside the tolerance."""
    vol = VOLS[0]
    want = reference(vol, torch.float32, max_iter=1)
    first = fits[vol][1]["history"]["params"][0]
    rel = float(((want[1]["history"]["params"][0].double() - first).abs()
                 / first.abs()).max())
    assert rel > RTOL, rel


@pytest.mark.parametrize("vol", [0.15, 0.2, 0.25])
def test_bs_market_matches_the_port(vol):
    """The reference's escrowed-dividend Black-Scholes calls against the
    port's `generate_market_data_with_dividends`, maturity by maturity
    (the dividend at a group's maturity is not escrowed)."""
    ks = torch.tensor(np.arange(80.0, 120.0, 2.0))
    got = bs_market.calls(S0, ks, R_D, MATS, vol, DIVS)
    want = torch.cat([bs.generate_market_data_with_dividends(
        S0, t, R_D, ks, CALIB_DIVIDENDS.dates, CALIB_DIVIDENDS.amounts,
        CALIB_DIVIDENDS.percentages, vol=vol) for t in MATS])
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-12)

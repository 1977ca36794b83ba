"""Book risk of a mixed-maturity American book with the golden dividends
through the port's normal entry, `batch_greeks(group_steps=,
param_jacobian=True)`, on the CPU in float64 (the plain versions of the
kernels), against the benchmark's plain risk reference
(`perfbench/reference/risk_ref.py`) column by column, with that reference
in float32 failing the same tolerance. No JAX."""

import numpy as np
import pytest
import torch

from heston_tpu_torch import (GOLDEN_DIVIDENDS, RISK_KEYS, GridSpec,
                              SolverConfig, batch_greeks)
from perfbench.reference import heston_ref, risk_ref

SPEC = GridSpec(m1=20, m2=10)
SOLVER = SolverConfig(n_steps=10, a2_variant="upwind", solver_engine="pallas")
KS = torch.tensor([85.0, 95.0, 105.0, 115.0] * 3, dtype=torch.float64)
GROUPS = ((0, 4, 3), (4, 8, 6), (8, 12, 10))
RATES = (0.025, 0.0)
# market states drawn as the benchmark's traffic draws them
_RNG = np.random.default_rng(21)
STATES = [tuple(float(_RNG.uniform(lo, hi)) for lo, hi in
                ((1.0, 2.0), (0.03, 0.05), (0.2, 0.4), (-0.9, -0.6),
                 (0.03, 0.05)))
          for _ in range(3)]
# per column, the widest gap over the book over the column's largest
# reference value: the plain versions agree with the reference to ~1e-13
# on this grid, a step, a dividend or a tangent out of place moves a
# column by 1e-4 and more, and the reference in float32 reads 1e-7 and
# more in every column
TOL = 1e-9
COLUMNS = (*RISK_KEYS, *(f"d_{k}" for k in risk_ref.JACOBIAN_KEYS))


def reference(state, dtype):
    spec = heston_ref.Spec(SPEC.m1, SPEC.m2, SPEC.s_max_mult, SPEC.c_mult,
                           SPEC.v_max, SPEC.d_div, SOLVER.theta,
                           SOLVER.a2_variant)
    return risk_ref.book(spec, KS.to(dtype), GROUPS, 100.0, state, *RATES,
                         SOLVER.delta_t, True, heston_ref.GOLDEN_DIVIDENDS)


@pytest.mark.parametrize("state", range(len(STATES)))
def test_book_risk_matches_the_reference_and_float32_does_not(state):
    """The seven columns and the five sensitivities of every option,
    each group at its own step count and the book's dt: the program
    within TOL in each column, the float32 reference outside it in
    each."""
    out = batch_greeks(SPEC, SOLVER, KS, 100.0, *STATES[state], *RATES,
                       american=True, dividends=GOLDEN_DIVIDENDS,
                       group_steps=GROUPS, param_jacobian=True, device="cpu")
    got = torch.cat([torch.stack([out[k] for k in RISK_KEYS], 1),
                     out["param_jacobian"]], 1)
    want = reference(STATES[state], torch.float64)
    gaps = dict(zip(COLUMNS, risk_ref.gaps(got, want).tolist()))
    assert all(g <= TOL for g in gaps.values()), gaps
    control = dict(zip(COLUMNS, risk_ref.gaps(
        reference(STATES[state], torch.float32), want).tolist()))
    assert all(g > TOL for g in control.values()), control

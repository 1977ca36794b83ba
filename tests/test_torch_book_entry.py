"""`models.douglas.price_batch(..., group_steps=)`: a mixed-maturity book
through the port's normal entry, on the CPU in float64 (the plain
versions of the kernels). Against the benchmark's plain reference
(`perfbench/reference/heston_ref.py`) group by group; bitwise one
`price_batch` call per group; the eager engines against the kernel's
plain version; what it refuses; and that calls without groups take the
routes they took before. No JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from heston_tpu_torch import (GOLDEN_DIVIDENDS, DividendSchedule, GridSpec,
                              RateSchedule, SolverConfig)
from heston_tpu_torch.kernels import fused_do, fused_single
from heston_tpu_torch.models import douglas
from perfbench.reference import heston_ref

SPEC = GridSpec(m1=20, m2=10)
SOLVER = SolverConfig(n_steps=10, a2_variant="upwind", solver_engine="pallas")
KS = torch.tensor([85.0, 95.0, 105.0, 115.0] * 3, dtype=torch.float64)
# 3 and 6 steps at dt = 0.1: n * dt / n is an ulp off dt, which the eager
# route has to keep off the dividends' steps (douglas.group_dividends)
GROUPS = ((0, 4, 3), (4, 8, 6), (8, 12, 10))
RATES = (0.025, 0.0)
PRODUCTS = {"european": dict(), "american": dict(american=True),
            "american_dividends": dict(american=True,
                                       dividends=GOLDEN_DIVIDENDS)}
# market states drawn as the benchmark's traffic draws them
_RNG = np.random.default_rng(17)
STATES = [tuple(float(_RNG.uniform(lo, hi)) for lo, hi in
                ((1.0, 2.0), (0.03, 0.05), (0.2, 0.4), (-0.9, -0.6),
                 (0.03, 0.05)))
          for _ in range(3)]
CPU = "cpu"


def book(solver=SOLVER, ks=KS, state=STATES[0], **kw):
    return douglas.price_batch(SPEC, solver, ks, 100.0, *state, *RATES,
                               device=CPU, **kw)


def engine(name):
    return dataclasses.replace(SOLVER, solver_engine=name)


@pytest.mark.parametrize("state", range(len(STATES)))
@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_matches_the_reference_group_by_group(product, state):
    """Each group against the reference at its own step count and the
    book's dt, within 1e-9: the plain versions pin to 1e-11 against it
    (PERF.md §2), so 1e-9 leaves room for the grid and the state, and a
    step or a dividend out of place moves a price by 1e-3 and more."""
    kw = PRODUCTS[product]
    got = book(state=STATES[state], group_steps=GROUPS, **kw)
    spec = heston_ref.Spec(SPEC.m1, SPEC.m2, SPEC.s_max_mult, SPEC.c_mult,
                           SPEC.v_max, SPEC.d_div, SOLVER.theta,
                           SOLVER.a2_variant)
    div = kw.get("dividends")
    for a, e, n in GROUPS:
        want = heston_ref.prices(
            spec, KS[a:e], 100.0, STATES[state], *RATES, SOLVER.delta_t, n,
            kw.get("american", False),
            None if div is None else heston_ref.GOLDEN_DIVIDENDS)
        torch.testing.assert_close(got[a:e], want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_bitwise_one_call_per_group(product):
    """The book in one call is bitwise each group priced as a book of its
    own at the same solver (the same dt): one plan and one launch a phase
    for the whole book, each option stopping at its own count."""
    kw = PRODUCTS[product]
    calls, lanes = fused_do.book_plan.calls, fused_do.book_plan.lanes
    whole = book(group_steps=GROUPS, **kw)
    assert (fused_do.book_plan.calls - calls,
            fused_do.book_plan.lanes - lanes) == (1, 12)
    parts = torch.cat([book(ks=KS[a:e], group_steps=((0, e - a, n),), **kw)
                       for a, e, n in GROUPS])
    assert torch.equal(whole, parts)


@pytest.mark.parametrize("name", ["scan", "pcr"])
@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_eager_engines_agree_with_the_kernel(product, name):
    """The eager loop, one group at a time, against the batched kernel's
    plain version at 1e-11 (the two loops sum in another order: u plain
    against the delta form with a compensated carry)."""
    kw = PRODUCTS[product]
    kernel = book(group_steps=GROUPS, **kw)
    eager = book(engine(name), group_steps=GROUPS, **kw)
    torch.testing.assert_close(eager, kernel, rtol=0, atol=1e-11)


@pytest.mark.parametrize("n_steps", [10, 20, 40, 7])
def test_group_dividends_fall_on_the_books_steps(n_steps):
    """Every group's re-dated dividends fire before the steps of its own
    solver that the book's dt gives them, and none past its count."""
    solver = dataclasses.replace(SOLVER, n_steps=n_steps)
    divs = DividendSchedule(dates=(0.1, 0.2, 0.3, 0.4, 0.6, 0.7, 0.8),
                            amounts=(0.5,) * 7, percentages=(0.01,) * 7)
    for n in range(1, n_steps + 1):
        group = douglas.group_solver(solver, n)
        moved = douglas.group_dividends(solver, divs, n)
        for k in range(1, n_steps + 1):
            want = divs.events_for_step(k, solver.delta_t) if k <= n else []
            assert moved.events_for_step(k, group.delta_t) == want, (n, k)
    assert douglas.group_dividends(solver, None, 3) is None
    assert douglas.group_dividends(solver, divs, None) is divs


CURVE = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.0))
REFUSED = {
    "gap": dict(group_steps=((0, 4, 3), (5, 12, 10))),
    "overlap": dict(group_steps=((0, 5, 3), (4, 12, 10))),
    "short": dict(group_steps=((0, 4, 3), (4, 8, 10))),
    "out_of_order": dict(group_steps=((4, 12, 10), (0, 4, 3))),
    "zero_steps": dict(group_steps=((0, 4, 0), (4, 12, 10))),
    "past_n_steps": dict(group_steps=((0, 4, 3), (4, 12, 11))),
    "rate_schedule": dict(group_steps=GROUPS, rate_schedule=CURVE),
}


@pytest.mark.parametrize("name", ["pallas", "scan"])
@pytest.mark.parametrize("case", sorted(REFUSED))
def test_refuses_groups_it_cannot_price(case, name):
    with pytest.raises(ValueError, match="group_steps|rate_schedule"):
        book(engine(name), **REFUSED[case])


def test_a_book_of_one_with_groups_takes_the_batched_kernel(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("fused_price_single called")

    monkeypatch.setattr(fused_single, "fused_price_single", refuse)
    got = book(ks=KS[:1], group_steps=((0, 1, 4),), american=True)
    want = fused_do.fused_price_batch(
        SPEC, SOLVER, KS[:1], 100.0, *STATES[0], *RATES, american=True,
        n_steps_per=[4])
    assert torch.equal(got, want)


@pytest.mark.parametrize("ks", [KS[:1], KS], ids=["one", "book"])
@pytest.mark.parametrize("name", ["pallas", "scan"])
def test_without_groups_the_routes_are_unchanged(name, ks):
    """No groups: a batch of one on the single-option kernel, a book on
    the batched kernel, the eager engines on the eager loop, bitwise."""
    kw = PRODUCTS["american_dividends"]
    got = book(engine(name), ks=ks, **kw)
    args = (SPEC, engine(name), ks, 100.0, *STATES[0], *RATES)
    if name != "pallas":
        want = douglas._price(*args, True, GOLDEN_DIVIDENDS, "call", None)
    elif ks.shape[0] == 1:
        want = fused_single.fused_price_single(*args, **kw)
    else:
        want = fused_do.fused_price_batch(*args, **kw)
    assert torch.equal(got, want)
    assert torch.equal(book(engine(name), ks=ks, group_steps=(), **kw), got)

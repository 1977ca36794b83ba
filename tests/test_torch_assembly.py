"""The layer both kernels stand on (heston_tpu_torch.kernels.assembly):
each decision has one home. Kernel 1's one packer gives, launch by
launch, the very buffers of a packed book plan, and the three plans that
build a phase's loop keywords (kernel 1's field dicts, kernel 2's, the
packed plans') agree phase by phase. Plain Python on CPU tensors: no card
and no JAX.
"""

import dataclasses

import pytest
import torch

from heston_tpu_torch.config import (GOLDEN_DIVIDENDS, Barrier, GridSpec,
                                     HestonParams, SolverConfig)
from heston_tpu_torch.kernels import assembly, fused_do, fused_single

P = HestonParams()
SPEC = GridSpec(m1=12, m2=8)
SOLVER = SolverConfig(n_steps=8, a2_variant="upwind", solver_engine="pallas")
STRIKES = (80.0, 95.0, 100.0, 110.0, 125.0)
# name: (Rannacher steps, book keywords): a European book, an American
# book with the golden dividends and per-lane step counts, and that book
# under Rannacher start-up (a damp phase and a main phase)
BOOKS = {
    "euro": (0, dict()),
    "amer_div": (0, dict(american=True, dividends=GOLDEN_DIVIDENDS,
                         n_steps_per=[8, 3, 8, 5, 1])),
    "rann": (2, dict(american=True, dividends=GOLDEN_DIVIDENDS,
                     n_steps_per=[8, 3, 8, 5, 1])),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("book", sorted(BOOKS))
def test_one_packer_gives_the_book_plans_buffers(book, dtype):
    """Each phase of a book packed by kernel 1's one packer (`_pack`, as
    the loop packs a launch) is bitwise the plan `pack_book_plan` holds:
    the state and the rows, and the views `book_phase_events` takes of
    the events and the per-lane counts."""
    rann, kw = BOOKS[book]
    fields, phases, at, _, _ = fused_do.book_plan(
        SPEC, dataclasses.replace(SOLVER, rannacher_steps=rann),
        torch.tensor(STRIKES, dtype=dtype), 100.0, P.kappa, P.eta, P.sigma,
        P.rho, P.v0, P.r_d, P.r_f, **kw)
    plan = fused_do.pack_book_plan(fields, phases, at)
    assert len(plan.phases) == len(phases) == (2 if rann else 1)
    assert plan.ev_step.numel() == sum(len(s) for s, _, _ in phases)
    for p, (steps, remaps, kw) in enumerate(phases):
        packed = fused_do._pack(fields, steps, remaps, kw["nst"])
        for got, want in zip(packed, (*plan[:5],
                                      *fused_do.book_phase_events(plan, p))):
            if want is None:
                assert got is None and "n_steps_per" not in BOOKS[book][1]
                continue
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.is_contiguous()
            assert torch.equal(got, want)


@pytest.mark.parametrize("dividends", [None, GOLDEN_DIVIDENDS],
                         ids=["no_div", "golden_div"])
@pytest.mark.parametrize("rann", [0, 2])
def test_plans_give_the_same_loop_keywords(rann, dividends):
    """A down-out American put, with and without Rannacher start-up and
    dividends: kernel 1's field-dict plan (`book_phases`, through
    `book_plan`), kernel 2's (`single_plan`) and the packed plans'
    (`plan_phases`) hold the same event steps and the same loop keywords
    phase by phase, all of them `loop_kwargs`' (kernel 1's adds only its
    lanes' step counts, None for a uniform book)."""
    spec = dataclasses.replace(SPEC, barrier=Barrier("down-out", 80.0))
    solver = dataclasses.replace(SOLVER, rannacher_steps=rann)
    args = (100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    kw = dict(american=True, dividends=dividends, option_type="put")
    _, book, _, _, _ = fused_do.book_plan(
        spec, solver, torch.tensor(STRIKES, dtype=torch.float64), *args,
        **kw)
    _, single, _ = fused_single.single_plan(
        spec, solver, torch.tensor([100.0], dtype=torch.float64), *args,
        **kw)
    events, packed = assembly.plan_phases(spec, solver, dividends, True,
                                          "put", P.r_d, P.r_f)
    assert len(book) == len(single) == len(packed) == (2 if rann else 1)
    assert all(b[2].pop("nst") is None for b in book)
    assert [b[2] for b in book] == [s[2] for s in single] == [
        p[2] for p in packed]
    assert [b[0] for b in book] == [s[0] for s in single] == [
        [e[0] for e in events[first:first + count]]
        for first, count, _ in packed]
    assert book[-1][2]["knocked"] == (0,)
    assert book[-1][2]["rf"] == P.r_d
    assert bool(events) == (dividends is not None)

"""The single-option plan in kernel 2's packed layout
(fused_single.device_plan) on the CPU, where it is `single_plan` packed
(`pack_plan`): the s-rows and v-columns in the kernel's order, every
phase's events in processing order, the price's node as one flat index,
and kernel 2's plain version on the packed buffers (`run_plan`) giving the
dict route's surfaces bit for bit, which is the route `fused_price_single`
takes. No card and no JAX; tests/test_torch_cuda.py holds the plan kernel
against this on the card.
"""

import dataclasses

import pytest
import torch

from heston_tpu_torch.config import (GOLDEN_DIVIDENDS, Barrier,
                                     DividendSchedule, GridSpec,
                                     HestonParams, SolverConfig)
from heston_tpu_torch.kernels import assembly, fused_single

P = HestonParams()
SPEC = GridSpec(m1=20, m2=10)
SOLVER = SolverConfig(n_steps=8, a2_variant="central", solver_engine="pallas")
# two events in one step, the second shifting every node to <= 0
TWO = DividendSchedule(dates=(0.2, 0.22, 0.5), amounts=(0.5, 150.0, 0.2),
                       percentages=(0.02, 0.0, 0.5))
CASES = {
    "euro": dict(),
    "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS),
    "put_div": dict(option_type="put", dividends=GOLDEN_DIVIDENDS),
    "digital_call_amer": dict(option_type="digital_call", american=True),
    "digital_put_div": dict(option_type="digital_put",
                            dividends=GOLDEN_DIVIDENDS),
    "up_out_div": dict(dividends=GOLDEN_DIVIDENDS,
                       spec=dataclasses.replace(
                           SPEC, barrier=Barrier("up-out", 140.0))),
    "rannacher_upwind": dict(american=True, dividends=GOLDEN_DIVIDENDS,
                             solver=dataclasses.replace(
                                 SOLVER, a2_variant="upwind",
                                 rannacher_steps=2)),
    "two_in_a_step": dict(dividends=TWO),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _plans(case, dtype):
    kw = dict(CASES[case])
    spec, solver = kw.pop("spec", SPEC), kw.pop("solver", SOLVER)
    args = (spec, solver, torch.tensor([97.5], dtype=DTYPES[dtype]), 100.0,
            P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    return (fused_single.device_plan(*args, **kw),
            fused_single.single_plan(*args, **kw))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_plan_packs_the_host_plan(case, dtype):
    """Every field of `single_plan` in its row of the packed buffers, the
    events of all phases in processing order with each phase's slice, and
    the flat node idx_v * ns + idx_s."""
    plan, (fields, phases, (idx_v, idx_s)) = _plans(case, dtype)
    nv, ns = fields["u"].shape
    assert torch.equal(plan.u, fields["u"])
    assert torch.equal(plan.lam, fields["lam"])
    for rows, keys in ((plan.sf, assembly.KERNEL_S_KEYS),
                       (plan.vf, assembly.KERNEL_V_KEYS),
                       (plan.sc, assembly.SCALAR_KEYS)):
        assert len(rows) == len(keys)
        for row, k in zip(rows, keys):
            assert torch.equal(row, fields[k]), k
    first = 0
    for (p_first, count, p_kw), (steps, remaps, kw) in zip(plan.phases,
                                                            phases):
        assert (p_first, count, p_kw) == (first, len(steps), kw)
        ev = slice(first, first + count)
        assert plan.ev_step[ev].tolist() == steps
        for idx, w, (i0, w0, i1, w1) in zip(plan.ev_idx[ev], plan.ev_w[ev],
                                            remaps):
            assert idx.dtype == torch.int32
            assert torch.equal(idx[0].long(), i0)
            assert torch.equal(idx[1].long(), i1)
            assert torch.equal(w[0], w0) and torch.equal(w[1], w1)
        first += count
    assert len(plan.phases) == len(phases)
    assert plan.ev_step.shape[0] == first
    assert tuple(plan.ev_idx.shape) == tuple(plan.ev_w.shape) == (first, 2,
                                                                  ns)
    assert plan.at.dtype == torch.int64
    assert plan.at.tolist() == [int(idx_v) * ns + int(idx_s)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_loop_matches_the_dict_route(case, dtype):
    """Kernel 2's plain version on the packed buffers, one call a phase,
    gives the dict route's (u, lam) bit for bit, and the gather at the
    flat node the price that `u[idx_v, idx_s]` reads."""
    plan, (fields, phases, at) = _plans(case, dtype)
    got_u, got_lam = fused_single.run_plan(plan)
    want_u, want_lam = assembly.run_phases(
        fused_single.fused_single_loop, fields, phases)
    assert torch.equal(got_u, want_u) and torch.equal(got_lam, want_lam)
    assert torch.equal(torch.take(got_u, plan.at), want_u[at].reshape(1))


def test_device_plan_takes_one_strike():
    """A book of two is refused: the plan is one option's."""
    with pytest.raises(ValueError, match="one option"):
        fused_single.device_plan(
            SPEC, SOLVER, torch.tensor([95.0, 100.0], dtype=torch.float64),
            100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["euro", "amer_div", "rannacher_upwind"])
def test_price_single_reads_the_packed_plan(case, dtype):
    """fused_price_single on a CPU strike: the packed plan, the plain
    kernel a phase and the gather at the flat node give the dict route's
    price bit for bit."""
    kw = dict(CASES[case])
    spec, solver = kw.pop("spec", SPEC), kw.pop("solver", SOLVER)
    args = (spec, solver, torch.tensor([97.5], dtype=DTYPES[dtype]), 100.0,
            P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    got = fused_single.fused_price_single(*args, **kw)
    fields, phases, at = fused_single.single_plan(*args, **kw)
    u, _ = assembly.run_phases(fused_single.fused_single_loop, fields,
                                   phases)
    assert got.shape == (1,) and torch.equal(got, u[at].reshape(1))


MARKET = (100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)


@pytest.mark.parametrize("given", ["numbers", "some_tensors",
                                   "float32_tensors"])
def test_market_buffer(given):
    """The plan kernel's market: by value when no value is a tensor, else
    all eight in a float64 [8] in the kernel's order, each value exact."""
    if given == "numbers":
        assert assembly.market_buffer(MARKET, "cpu") is None
        return
    dtype = torch.float64 if given == "some_tensors" else torch.float32
    market = [torch.tensor(x, dtype=dtype) if i in (1, 3, 5) else x
              for i, x in enumerate(MARKET)]
    buf = assembly.market_buffer(market, "cpu")
    assert buf.dtype == torch.float64 and tuple(buf.shape) == (8,)
    assert buf.tolist() == [float(x) for x in market]

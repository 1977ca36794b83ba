"""The book's plan in kernel 1's packed layout (fused_do.device_book_plan)
on the CPU, where it is `book_plan` packed (`pack_book_plan`): the
s-rows, v-columns and scalars in the kernel's order, every phase's events
in processing order as one block [B, count, 2, ns] with its int32 step
counts, the price's node as one flat index per option, and kernel 1's
plain version on the packed buffers (`run_book_plan`) giving the dict
route's surfaces bit for bit, which is the route `fused_price_batch`
takes for a flat-rate book. No card and no JAX; tests/test_torch_cuda.py
holds the book's plan kernel against this on the card.
"""

import dataclasses

import pytest
import torch

from heston_tpu_torch.config import (GOLDEN_DIVIDENDS, Barrier,
                                     DividendSchedule, GridSpec,
                                     HestonParams, RateSchedule,
                                     SolverConfig)
from heston_tpu_torch.kernels import (assembly, cuda_build, fused_do,
                                      fused_single)

P = HestonParams()
SPEC = GridSpec(m1=20, m2=10)
SOLVER = SolverConfig(n_steps=8, a2_variant="central", solver_engine="pallas")
STRIKES = [85.0, 92.5, 97.5, 100.0, 107.5, 115.0]
# per-lane counts: lanes that stop before the last events (golden
# dividends at steps 2, 4, 5, 7 of 8), and with Rannacher R = 2 lanes with
# n_i <= R, which run no main step
MIXED = [8, 3, 1, 2, 6, 8]
# two events in one step, the second shifting every node to <= 0
TWO = DividendSchedule(dates=(0.2, 0.22, 0.5), amounts=(0.5, 150.0, 0.2),
                       percentages=(0.02, 0.0, 0.5))
CASES = {
    "euro": dict(),
    "amer_div_mixed": dict(american=True, dividends=GOLDEN_DIVIDENDS,
                           n_steps_per=MIXED),
    "put_div": dict(option_type="put", dividends=GOLDEN_DIVIDENDS),
    "digital_put_div": dict(option_type="digital_put",
                            dividends=GOLDEN_DIVIDENDS),
    "digital_call_amer": dict(option_type="digital_call", american=True),
    "up_out_div": dict(dividends=GOLDEN_DIVIDENDS, n_steps_per=MIXED,
                       spec=dataclasses.replace(
                           SPEC, barrier=Barrier("up-out", 140.0))),
    "down_out_div": dict(option_type="put", dividends=GOLDEN_DIVIDENDS,
                         spec=dataclasses.replace(
                             SPEC, barrier=Barrier("down-out", 75.0))),
    "double_out_div": dict(dividends=GOLDEN_DIVIDENDS,
                           spec=dataclasses.replace(
                               SPEC, barrier=Barrier("double-out", 70.0,
                                                     150.0))),
    "rannacher_upwind_mixed": dict(
        american=True, dividends=GOLDEN_DIVIDENDS, n_steps_per=MIXED,
        solver=dataclasses.replace(SOLVER, a2_variant="upwind",
                                   rannacher_steps=2)),
    "two_in_a_step": dict(dividends=TWO, n_steps_per=MIXED),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _args(case, dtype):
    kw = dict(CASES[case])
    spec, solver = kw.pop("spec", SPEC), kw.pop("solver", SOLVER)
    if "n_steps_per" in kw:
        kw["n_steps_per"] = torch.tensor(kw["n_steps_per"])
    return (spec, solver, torch.tensor(STRIKES, dtype=DTYPES[dtype]), 100.0,
            P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f), kw


def _plans(case, dtype):
    args, kw = _args(case, dtype)
    order = ("american", "dividends", "option_type", "n_steps_per")
    return (fused_do.device_book_plan(*args, **kw),
            fused_do.book_plan(*args, *(kw.get(k, d) for k, d in zip(
                order, (False, None, "call", None)))))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_device_book_plan_packs_the_host_plan(case, dtype):
    """Every field of `book_plan` in its row of the packed buffers, the
    events of all phases in processing order, each phase's block
    [B, count, 2, ns] and int32 step counts, and the flat node
    b * ns * nv + idx_s * nv + idx_v."""
    plan, (fields, phases, (idx_s, idx_v), _, _) = _plans(case, dtype)
    b, ns, nv = fields["u"].shape
    assert torch.equal(plan.u, fields["u"])
    assert torch.equal(plan.lam, fields["lam"])
    for rows, keys in ((plan.sf, assembly.KERNEL_S_KEYS),
                       (plan.vf, assembly.KERNEL_V_KEYS),
                       (plan.sc, assembly.SCALAR_KEYS)):
        assert rows.shape[:2] == (b, len(keys))
        for k, row in zip(keys, rows.unbind(1)):
            assert torch.equal(row, fields[k]), k
    first = 0
    for p, (steps, remaps, kw) in enumerate(phases):
        p_first, count, p_kw = plan.phases[p]
        assert (p_first, count) == (first, len(steps))
        assert p_kw == {k: v for k, v in kw.items() if k != "nst"}
        ev_step, idx, w, nst = fused_do.book_phase_events(plan, p)
        assert ev_step.dtype == torch.int32 and ev_step.tolist() == steps
        assert tuple(idx.shape) == tuple(w.shape) == (b, count, 2, ns)
        assert idx.dtype == torch.int32
        for e, (i0, w0, i1, w1) in enumerate(remaps):
            assert torch.equal(idx[:, e, 0].long(), i0)
            assert torch.equal(idx[:, e, 1].long(), i1)
            assert torch.equal(w[:, e, 0], w0) and torch.equal(w[:, e, 1], w1)
        if kw["nst"] is None:
            assert nst is None
        else:
            assert nst.dtype == torch.int32
            assert nst.tolist() == kw["nst"].tolist()
        first += count
    assert len(plan.phases) == len(phases)
    assert plan.ev_step.shape[0] == first
    assert plan.ev_idx.numel() == plan.ev_w.numel() == first * b * 2 * ns
    assert plan.at.dtype == torch.int64
    assert plan.at.tolist() == [i * ns * nv + int(s) * nv + int(v)
                                for i, (s, v) in enumerate(zip(idx_s,
                                                               idx_v))]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_book_loop_matches_the_dict_route(case, dtype):
    """Kernel 1's plain version on the packed buffers, one call a phase,
    gives the dict route's (u, lam) bit for bit, and the gather at the
    flat nodes the prices that `u[b, idx_s, idx_v]` reads."""
    plan, (fields, phases, at, _, _) = _plans(case, dtype)
    got_u, got_lam = fused_do.run_book_plan(plan)
    want_u, want_lam = assembly.run_phases(fused_do.fused_do_loop, fields,
                                           phases)
    assert torch.equal(got_u, want_u) and torch.equal(got_lam, want_lam)
    assert torch.equal(torch.take(got_u, plan.at),
                       fused_do._extract(want_u, *at))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_price_batch_reads_the_packed_book_plan(case, dtype):
    """fused_price_batch on CPU strikes: the packed plan, the plain kernel
    a phase and the gather at the flat nodes give the dict route's prices
    bit for bit, with one book plan of B options counted."""
    args, kw = _args(case, dtype)
    calls, lanes = fused_do.book_plan.calls, fused_do.book_plan.lanes
    got = fused_do.fused_price_batch(*args, **kw)
    assert (fused_do.book_plan.calls - calls,
            fused_do.book_plan.lanes - lanes) == (1, len(STRIKES))
    _, (fields, phases, at, _, _) = _plans(case, dtype)
    u, _ = assembly.run_phases(fused_do.fused_do_loop, fields, phases)
    assert got.shape == (len(STRIKES),)
    assert torch.equal(got, fused_do._extract(u, *at))


# strikes that are a view: every other strike of a longer ladder, a
# column of a strike grid (offset and stride), one strike expanded
# (stride 0)
LAYOUTS = {
    "every_other": lambda ks: torch.stack([ks, ks + 1.0], 1).reshape(-1)[::2],
    "grid_column": lambda ks: torch.stack([ks - 1.0, ks, ks + 1.0], 1)[:, 1],
    "expanded": lambda ks: ks[3:4].expand(len(ks)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_price_batch_takes_strikes_of_any_layout(layout, dtype):
    """A book whose strikes are a strided or expanded view prices bit for
    bit as its contiguous copy, and its packed plan is the copy's."""
    args, kw = _args("amer_div_mixed", dtype)
    view = LAYOUTS[layout](args[2])
    assert not view.is_contiguous()
    dense = (*args[:2], view.contiguous(), *args[3:])
    strided = (*args[:2], view, *args[3:])
    got, want = (fused_do.device_book_plan(*strided, **kw),
                 fused_do.device_book_plan(*dense, **kw))
    for name, g, w in zip(fused_do.BookPlan._fields, got[:-1], want[:-1]):
        assert torch.equal(g, w), name
    assert torch.equal(fused_do.fused_price_batch(*strided, **kw),
                       fused_do.fused_price_batch(*dense, **kw))


def test_device_book_plan_takes_a_row_of_strikes():
    """Strikes of another shape than [B] are refused."""
    with pytest.raises(ValueError, match="strikes"):
        fused_do.device_book_plan(
            SPEC, SOLVER, torch.tensor([[95.0, 100.0]], dtype=torch.float64),
            100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)


def test_a_curve_book_keeps_the_dict_route():
    """A curve book (rate_schedule) still prices through `book_plan`'s
    field dicts, one launch a phase and segment piece: the same prices as
    run_phases on its plan."""
    curve = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.01))
    args, _ = _args("euro", "f64")
    got = fused_do.fused_price_batch(*args, dividends=GOLDEN_DIVIDENDS,
                                     rate_schedule=curve)
    fields, phases, at, _, _ = fused_do.book_plan(
        *args, dividends=GOLDEN_DIVIDENDS, rate_schedule=curve)
    u, _ = assembly.run_phases(fused_do.fused_do_loop, fields, phases)
    assert torch.equal(got, fused_do._extract(u, *at))


def test_a_build_hashes_the_plan_header(tmp_path):
    """Both CUDA sources include csrc/plan.cuh, the one copy of the plan
    arithmetic, and a build's tag moves with the header's content as
    with the source's."""
    for source in (fused_do.SOURCE, fused_single.SOURCE):
        assert [f.name for f in cuda_build.included(source)] == [
            source.name, "plan.cuh"]
        copy = tmp_path / source.name
        copy.write_bytes(source.read_bytes())
        header = tmp_path / "plan.cuh"
        header.write_bytes((source.parent / "plan.cuh").read_bytes())
        flags = cuda_build.nvcc_flags()
        before = cuda_build.build_tag(copy, flags)
        header.write_bytes(header.read_bytes() + b"\n")
        assert cuda_build.build_tag(copy, flags) != before
        assert cuda_build.build_tag(copy, cuda_build.nvcc_flags(True)) != \
            cuda_build.build_tag(copy, flags)

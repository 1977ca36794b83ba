"""The book cell on the CPU (the program's plain versions) with fewer
options a book: the program passes its limit and the reference in float32
fails it, a run with the time loop broken underneath comes out not
correct once for each fault a book can have, and the frozen bound of the
full book's launch."""

import argparse
import copy

import pytest
import torch

from conftest import bench
from perfbench import control, roofline_fp64, run
from perfbench.kinds import book
from test_perfbench_correct import FAULTS, SEEDS

CELL = "book.mixed5000.f64"


@pytest.fixture(autouse=True)
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_cell():
    """The cell with 3 maturity groups of 4 strikes: the configuration
    (grid, scheme, float64) and the route as the cell runs them, so the
    mix's own limit holds."""
    cell, cfg, mix, e2e, per_layer = run.load_cell(CELL, bench())
    mix = copy.deepcopy(mix)
    mix.update(strikes=[80.0, 120.0, 4], group_steps=[4, 11, 20],
               trace_requests=2)
    return cell, cfg, mix, e2e, per_layer


def run_cell(trace=0):
    args = argparse.Namespace(workload=CELL, seed=11, seconds=0.2,
                              trace=trace)
    result, _ = run.measure(args, *small_cell(), torch.device("cpu"))
    return result


def test_program_passes_float32_control_fails(monkeypatch):
    cell = small_cell()
    monkeypatch.setattr(run, "load_cell", lambda *_: cell)
    seen = set()
    for seed, side, checks, not_finite in control.readings(
            CELL, SEEDS, ("program", "control"), torch.device("cpu")):
        passed = bool(checks) and not not_finite and all(c.ok
                                                         for c in checks)
        assert passed == (side == "program"), (seed, side, checks)
        seen.add(side)
    assert seen == {"program", "control"}


def test_sound_run_is_correct():
    result = run_cell()
    assert result["correct"] and result["failed"] == 0
    assert set(result["checks"]) == {"book_gap"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(fault, monkeypatch):
    from heston_tpu_torch.kernels import fused_do

    fake = FAULTS[fault](fused_do.fused_do_loop)
    fake.launches = fake.tangent_launches = 0
    monkeypatch.setattr(fused_do, "fused_do_loop", fake)
    assert not run_cell()["correct"]


def test_traced_run_reads_one_plan_and_no_build(monkeypatch):
    """The per-layer readers that need no device trace: one book plan a
    book, nothing built inside the window."""
    seen = []
    monkeypatch.setattr(run, "load_reader",
                        lambda name: lambda rec: seen.append(rec) or 1.0)
    assert run_cell(trace=1)["correct"] and seen
    rec = seen[0]
    for name in ("book_plans.book", "rebuilds.book"):
        value = run._load_file(run.ROOT / "metrics" / f"{name}.py",
                               name).read(rec)
        assert value == (1.0 if name == "book_plans.book" else 0.0), name
    assert all(r["counters"]["book_plans.lanes"] == 12
               for r in rec["requests"])


def test_frozen_bound_of_the_full_book():
    """5,000 lanes, 55,000 lane-steps, the four golden events at steps 4,
    8, 11 and 16: 4.754 GFLOP and 162.5 MB, bound by operations at the
    float64 peak (0.1398 ms; the bytes alone 0.0485 ms)."""
    _, cfg, mix, _, _ = run.load_cell(CELL, bench())
    work = book.Workload(cfg, mix, torch.device("cpu"))
    assert work.ks.shape == (5000,) and work.ks.dtype == torch.float64
    bound = work.traced({}, None)["kernel1_bound_ms"]
    assert bound == pytest.approx(
        roofline_fp64.bound_ms(4_753_714_000, 162_460_000), rel=1e-12)
    assert bound == pytest.approx(0.13981512, rel=1e-6)

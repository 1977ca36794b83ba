"""The calibration cell on the CPU (the program's plain versions) with
fewer options a chain and fewer iterations a fit: a run passes its
limits, a run with the program broken underneath comes out not correct
once for each fault the cell can have (a dividend dropped, one maturity
group's step count off by one, a European update, the program in
float32), a traced run reads its counts, and the frozen bounds of the
full chain's launches."""

import argparse
import copy

import pytest
import torch

from conftest import bench
from perfbench import roofline_fp64, run
from perfbench.kinds import calib

CELL = "calib.amdiv80.f64"


@pytest.fixture(autouse=True)
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_cell(precision=None):
    """The cell with 2 strikes at each of its 4 maturities and 3 LM
    iterations at most: the configuration (grid, scheme, dividends on
    the 5- and 15-step groups' last steps) and the route as the cell runs
    them, so the mix's own limits hold."""
    cell, cfg, mix, e2e, per_layer = run.load_cell(CELL, bench())
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    if precision:
        cfg["precision"] = precision
    mix.update(strikes=[92.0, 16.0, 2], trace_requests=1)
    mix["lm"]["max_iter"] = 3
    return cell, cfg, mix, e2e, per_layer


def run_cell(trace=0, precision=None):
    args = argparse.Namespace(workload=CELL, seed=2**31 + 29, seconds=0.2,
                              trace=trace)
    result, _ = run.measure(args, *small_cell(precision), torch.device("cpu"))
    return result


def dividend_dropped(monkeypatch):
    from heston_tpu_torch import DividendSchedule
    from heston_tpu_torch.kernels import fused_do

    phases = fused_do.book_phases

    def fake(solver, dividends, *args, **kw):
        if dividends is not None:
            dividends = DividendSchedule(
                dates=dividends.dates[1:], amounts=dividends.amounts[1:],
                percentages=dividends.percentages[1:])
        return phases(solver, dividends, *args, **kw)

    monkeypatch.setattr(fused_do, "book_phases", fake)


def group_steps_off(monkeypatch):
    """The first maturity group one step longer than its own count."""
    from heston_tpu_torch.models import calibration

    lane_steps = calibration.lane_steps

    def off(group_steps):
        steps = lane_steps(group_steps)
        a, e, n = group_steps[0]
        steps[a:e] = n + 1
        return steps

    monkeypatch.setattr(calibration, "lane_steps", off)


def european_update(monkeypatch):
    from heston_tpu_torch.kernels import fused_do

    loop = fused_do.fused_do_loop

    def fake(fields, ev_steps, remaps, **kw):
        return loop(fields, ev_steps, remaps, **dict(kw, american=False))

    fake.launches = fake.tangent_launches = 0
    monkeypatch.setattr(fused_do, "fused_do_loop", fake)


FAULTS = {"dividend_dropped": dividend_dropped,
          "group_steps_off": group_steps_off,
          "european_update": european_update}


def test_the_program_passes():
    result = run_cell()
    assert result["correct"] and result["failed"] == 0, result["checks"]


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["float32_program"])
def test_fault_comes_out_not_correct(fault, monkeypatch):
    if fault == "float32_program":
        result = run_cell(precision="float32")
    else:
        FAULTS[fault](monkeypatch)
        result = run_cell()
    assert result["failed"] == 0 and not result["correct"], result["checks"]


def test_traced_run_reads_the_loop_counts(monkeypatch):
    """The per-layer readers that need no device trace: one read of the
    stop flag an iteration, nothing built inside the window, and on the
    CPU two host assemblies an iteration (the trial's plan and the
    Jacobian's linearization; on the card none)."""
    seen = []
    monkeypatch.setattr(run, "load_reader",
                        lambda name: lambda rec: seen.append(rec) or 1.0)
    assert run_cell(trace=1)["correct"] and seen
    rec = seen[0]

    def read(name):
        return run._load_file(run.ROOT / "metrics" / f"{name}.py",
                              name).read(rec)

    it = read("lm_iterations.calib")
    assert it == 3.0
    assert read("host_reads.calib") == it
    assert read("host_assemblies.calib") == 2 * it
    assert read("rebuilds.calib") == 0.0
    assert all(r["counters"]["calib.calls"] == 1 for r in rec["requests"])


def test_frozen_bounds_of_the_full_chain():
    """80 lanes, 1,000 lane-steps, 120 lane events (0.25 and 0.75 on
    steps 5 and 15): the trial's primal 84.65 MFLOP and 2.40 MB, the
    forward mode with four tangents 526.0 MFLOP and 6.46 MB, both bound
    by operations at the float64 peak; an iteration's pair is one
    launch of each."""
    _, cfg, mix, _, _ = run.load_cell(CELL, bench())
    work = calib.Workload(cfg, mix, torch.device("cpu"))
    assert work.ks.shape == (80,) and work.ks.dtype == torch.float64
    assert work.groups == ((0, 20, 5), (20, 40, 10), (40, 60, 15),
                           (60, 80, 20))
    assert work.bound_ms == pytest.approx(
        roofline_fp64.bound_ms(84_650_800, 2_403_520), rel=1e-12)
    assert work.fwd_bound_ms == pytest.approx(
        roofline_fp64.bound_ms(525_996_640, 6_461_120), rel=1e-12)
    traced = work.traced({}, {"info": {"iterations": 4}})
    assert traced == {"kernel1_bound_ms": 4 * work.bound_ms,
                      "kernel1_fwd_bound_ms": 4 * work.fwd_bound_ms,
                      "iterations": 4}


def test_the_market_loads_nothing_of_the_program():
    from test_perfbench_imports import FORBIDDEN, top_level_modules

    mods = top_level_modules("import sys; sys.path.insert(0, '.')\n"
                             "from perfbench.reference import bs_market")
    assert not mods & (FORBIDDEN | {"heston_tpu_torch"})

"""The risk cell on the CPU (the program's plain versions) with fewer
options a book: the program passes its limits and the reference in
float32 fails them, a run with the program broken underneath comes out
not correct once for each fault book risk can have (the tangents lost,
the American multiplier dropped, one maturity group's step count off),
a traced run reads its counts, and the frozen bound of the full book's
forward-mode launch."""

import argparse
import copy

import pytest
import torch

from conftest import bench
from perfbench import control, roofline_fp64, run
from perfbench.kinds import risk
from test_perfbench_correct import SEEDS

CELL = "risk.mixed5000.f64"


@pytest.fixture(autouse=True)
def cpu_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def small_cell():
    """The cell with 3 maturity groups of 4 strikes: the configuration
    (grid, scheme, float64) and the route as the cell runs them, so the
    mix's own limits hold."""
    cell, cfg, mix, e2e, per_layer = run.load_cell(CELL, bench())
    mix = copy.deepcopy(mix)
    mix.update(strikes=[80.0, 120.0, 4], group_steps=[4, 11, 20],
               trace_requests=1)
    return cell, cfg, mix, e2e, per_layer


def run_cell(trace=0):
    args = argparse.Namespace(workload=CELL, seed=2**31 + 11, seconds=0.2,
                              trace=trace)
    result, _ = run.measure(args, *small_cell(), torch.device("cpu"))
    return result


def test_program_passes_float32_control_fails(monkeypatch):
    cell = small_cell()
    monkeypatch.setattr(run, "load_cell", lambda *_: cell)
    seen = set()
    for seed, side, checks, not_finite in control.readings(
            CELL, SEEDS, ("program", "control"), torch.device("cpu")):
        assert {c.name for c in checks} == {"risk_gap", "jac_gap"}
        passed = bool(checks) and not not_finite and all(c.ok
                                                         for c in checks)
        assert passed == (side == "program"), (seed, side, checks)
        seen.add(side)
    assert seen == {"program", "control"}


def tangents_zeroed(loop):
    def fake(fields, ev_steps, remaps, **kw):
        out = loop(fields, ev_steps, remaps, **kw)
        if kw.get("tangents") is None:
            return out
        u, lam, dus, dlams = out
        return u, lam, [torch.zeros_like(x) for x in dus], dlams
    return fake


def lam_dropped(loop):
    def fake(fields, ev_steps, remaps, **kw):
        u, lam, *rest = loop(fields, ev_steps, remaps, **kw)
        return (u, torch.zeros_like(lam), *rest)
    return fake


FAULTS = {"tangents_zeroed": tangents_zeroed, "lam_dropped": lam_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["group_steps_off"])
def test_fault_comes_out_not_correct(fault, monkeypatch):
    from heston_tpu_torch.kernels import fused_do
    from heston_tpu_torch.models import douglas

    if fault == "group_steps_off":
        # the first maturity group one step longer than its own count
        lane_steps = douglas.lane_steps

        def off(group_steps):
            steps = lane_steps(group_steps)
            a, e, n = group_steps[0]
            steps[a:e] = n + 1
            return steps

        monkeypatch.setattr(douglas, "lane_steps", off)
    else:
        fake = FAULTS[fault](fused_do.fused_do_loop)
        fake.launches = fake.tangent_launches = 0
        monkeypatch.setattr(fused_do, "fused_do_loop", fake)
    result = run_cell()
    assert result["failed"] == 0 and not result["correct"], result["checks"]


def test_traced_run_reads_two_host_assemblies_and_no_build(monkeypatch):
    """The per-layer readers that need no device trace: two host
    assemblies a request (the surfaces' book plan and the Jacobian's
    linearization), nothing built inside the window, one book plan, on
    the host (none built on the card); the request counted once in
    batch_greeks with its 12 options."""
    seen = []
    monkeypatch.setattr(run, "load_reader",
                        lambda name: lambda rec: seen.append(rec) or 1.0)
    assert run_cell(trace=1)["correct"] and seen
    rec = seen[0]
    for name, want in (("host_assemblies.risk", 2.0),
                       ("rebuilds.risk", 0.0), ("book_plans.risk", 1.0),
                       ("device_plans.risk", 0.0)):
        value = run._load_file(run.ROOT / "metrics" / f"{name}.py",
                               name).read(rec)
        assert value == want, name
    assert all(r["counters"]["risk.batch_greeks_calls"] == 1
               and r["counters"]["risk.batch_greeks_lanes"] == 12
               for r in rec["requests"])


def test_frozen_bound_of_the_full_book():
    """5,000 lanes, 55,000 lane-steps, the four golden events, four
    tangents: 29.209 GFLOP and 416.06 MB, bound by operations at the
    float64 peak (0.8591 ms; the bytes alone 0.1242 ms). The surfaces'
    primal launch has the book's bound (0.1398 ms)."""
    _, cfg, mix, _, _ = run.load_cell(CELL, bench())
    work = risk.Workload(cfg, mix, torch.device("cpu"))
    assert work.ks.shape == (5000,) and work.ks.dtype == torch.float64
    traced = work.traced({}, None)
    bound = traced["kernel1_fwd_bound_ms"]
    assert bound == pytest.approx(
        roofline_fp64.bound_ms(29_209_132_000, 416_060_000), rel=1e-12)
    assert bound == pytest.approx(0.8590921, rel=1e-6)
    assert traced["kernel1_bound_ms"] == pytest.approx(
        roofline_fp64.bound_ms(4_753_714_000, 162_460_000), rel=1e-12)
    assert traced["kernel1_bound_ms"] == pytest.approx(0.13981512, rel=1e-6)

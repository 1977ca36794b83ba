"""Helpers of the benchmark's CPU tests: a cell with fewer options a
request, which the plain versions of the kernels run in seconds on the
CPU (the same code paths and grids; the limits are the mix's own)."""

import copy
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))


def bench():
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


def with_shelved():
    """BENCHMARK.json with the entries of `perfbench/shelved.json` added:
    the benchmark as it is once a later PR moves them in."""
    b = bench()
    with open(REPO / "perfbench" / "shelved.json") as f:
        shelved = json.load(f)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        b[k] = b[k] + shelved[k]
    return b


def small_cell(name: str):
    """(cell, cfg, mix, e2e, per_layer) of `name` with fewer requests'
    options: the configuration (grid, scheme, precision) as it is run and
    each option as the cell prices it, so the mix's own limits hold."""
    from perfbench import run

    cell, cfg, mix, e2e, per_layer = run.load_cell(name, with_shelved())
    cfg, mix = copy.deepcopy(cfg), copy.deepcopy(mix)
    if mix["kind"] == "quote":
        mix["cycle"]["strike"] = [87.5, 112.5]
        mix["check_sample"] = 6
    elif mix["kind"] == "fit":
        mix.update(strikes=[90.0, 10.0, 3], maturities=[0.5, 1.0])
        mix["lm"]["max_iter"] = 3
    mix["trace_requests"] = 2
    return cell, cfg, mix, e2e, per_layer

"""Smoke run of heston_tpu_torch on an NVIDIA GPU: builds the two CUDA
kernels from the sources in this checkout (one nvcc per source and
build, -fmad=false and -fmad=true, all started together), holds every
kernel (the batched loop's primal and forward-mode
variants, uniform and with per-lane step counts, the single-option
latency loop, each under the Douglas scheme and the three corrector
schemes) against its plain PyTorch version, checks the scheme pins on
both routes, and drives the paths of the port through the public entry
points: the flagship pricing call (batch-500 American calls with the
golden dividends, Douglas theta = 0.8, upwind A2, 50 x 25 x 20), the
bench's Rannacher and single-option arms, the single-option latency call
at the reference's 100 x 75 x 20 golden grid (bench.py:1261-1307; kernel
2 runs the option as one thread-block cluster, its launch plan and its
dependent chain's latency floor printed beside its times), the plan
kernel that builds that call's inputs on the card against the host plan,
bitwise, with its times beside the host plan's (plan_kernel), the
book's plan kernel the same way at the flagship's and the book cell's
shapes (book_plan_kernel), the card Jacobian's tangent-rows kernel
against its plain version at the flagship's and the risk cell's shapes,
with the main path's risk call's launches and that call's wall time on
the plain rows beside the kernel's (tangent_rows), the mixed-maturity
books (mixed5000, bench.py:1195-1237), the batched
kernel's launch plan on each kind of launch of the main path (placement:
the fields in shared memory, shared bytes, registers, blocks an SM from
the occupancy API, tangent groups, and the device time against every
field in global memory, alternating in one process), book risk
(book_risk500 and its 10-maturity variant, bench.py:1108-1151), the
Levenberg–Marquardt calibrations of the bench (lm60, the 10 x 20 maturity
ladder and its American-dividend variant, bench.py:974-1105), and then
the Craig-Sneyd, modified Craig-Sneyd and Hundsdorfer-Verwer schemes
through the same paths: the bench's cs/mcs/hv and jac_cs arms
(bench.py:834-836, :901-902), its per-scheme batch-500 timings
(bench.py:1154-1194), the golden-grid convergence check
(tests/test_schemes.py:62-78), kernel 2's launch plan at the golden
grid per scheme (single_placement: the cluster, rows, threads, fields in
shared memory and registers in both types, and the device time of the
default plan against one block with the PCR factors in global memory),
book risk under HV and lm60 under CS;
then both builds' float32 errors side by side (fma_build, ROADMAP C9),
and puts, cash-or-nothing digitals and up-out barriers through the same
paths: the bench's payoff arms (bench.py:830-848, :882-897) on kernel 1
and in forward mode, kernel 2 at the golden grid, the flagship book per
payoff, book risk as puts and American digitals, lm60 as puts, and
knock-in prices by in-out parity; then rate curves (the flagship book
as calls and as puts on a three-segment curve, undamped and damped: one
launch per phase and segment piece, each piece against the plain
version; its pricing time beside the flat book's; book risk on the
curve), the damped Jacobian (the tangent state handed from the damp
launch to the main one, at lm60's shape; lm60 and lm_multi200 under
Rannacher start-up) and the five-tangent Jacobian of v0_mode "ad";
then the eager ADI loop (solver_engine "scan" and "pcr", plain tensor
ops) on the flagship book, in float64 against kernel 1 and with no
kernel launched inside it, the host calibration loop `calibrate` on
lm60 (float32 and float64 with the forward-mode Jacobian, one launch of
kernel 1's forward mode per pass and the trial prices on the eager
loop; float64 with the FD Jacobian) and on the 10 x 20 maturity ladder
(one forward-mode launch per maturity group and pass), and
price_and_greeks at the golden grid, its "pallas" branch against its
"scan" branch; then the characteristic-function pricer (lm60's chain on
the card in float32 and float64 against the CPU, and
calibrate_device(pricer="cf") on lm60), the native OpenMP engine over
csrc/heston_cpu.cpp on the flagship book against kernel 1, the european
and american_dividends scenarios through run_scenario's device loop
(float32 against float64), and the port's bench (python -m
heston_tpu_torch.bench) in a process of its own, held to its selftest
budgets and finite outputs.
Each section's wall seconds are printed on a line of their own.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Exits non-zero
without a card, and when any phase fails. Imports no JAX. The last line
of its output is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the line before that lists every kernel
of the path with its launches, error, times and bound. Each entry's
error is that of the build it times (float32 on the main path's build:
-fmad=true for a primal launch, -fmad=false for the forward mode)
against the float64 plain version on the same inputs, gated at
the entry's RMSE budget; `bitwise_max_abs_err` is the -fmad=false build
against the float32 plain version.
"""

import dataclasses
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

# float32 price RMSE budgets per arm against float64, from the JAX
# package's on-chip selftest (bench.py:640-649, SELFTEST_BUDGET)
ARM_BUDGETS = {"euro": 2e-5, "amer": 4e-5, "div": 4e-5, "amer_div": 3e-5,
               "rann": 4e-5, "rann_amer_div": 3.5e-5,
               "single_rann": 3e-6, "single_amer_div": 3e-6}
F64_KERNEL_TOL = 1e-10       # f64 kernel vs f64 plain, max abs on surfaces
PIN_TOL = 1e-9               # f64 scheme pins
MAIN_RMSE = 3e-5             # f32 main path vs plain f64
MAIN_KERNEL_TOL = 1e-4       # f32 kernel vs f32 plain on the same inputs,
                             # max abs on prices (~50 ulps of a price ~30)
JAC_RMSE = 3e-5              # f32 Jacobian vs f64 plain, RMSE of entries
                             # normalized by max(1, |J64|) (bench.py:648)
TANGENT_KERNEL_TOL = 1e-3    # f32 forward-mode kernel vs f32 plain, max abs
                             # on the surfaces (tangents up to ~10^3)
F32_SURFACE_TOL = 1e-3       # f32 kernel vs f32 plain on the same inputs, max
                             # abs on the surfaces (values up to ~10^3)
GOLDEN_PIN = 8.869179918466847   # 100 x 75 x 20 central, K = 100, f64
                                 # (tests/test_douglas.py:50)
A100_SINGLE_S = 0.003        # the reference's single-option time on an A100
                             # (bench.py:1264), for comparison only
SSE_REL = 0.02               # lm60: f32 final SSE within 2% of f64's
# the corrector schemes: f32 price RMSE budgets of the European arms and
# the normalized Jacobian RMSE of the bench's jac_cs arm (bench.py:643,
# :648); hv meets the bench's 2e-5 on the float32 main path's
# -fmad=true build (ROADMAP C9). The converged golden price and the
# scheme's distance to it at 100 x 75 x 50 (tests/test_schemes.py:62-78)
CORRECTORS = ("cs", "mcs", "hv")
SCHEME_BUDGETS = {"cs": 2.5e-5, "mcs": 5e-5, "hv": 2e-5}
JAC_CS_RMSE = 3.5e-5
# puts, digitals and knock-out barriers: the bench's arms (64 strikes in
# [75, 125], 50 x 25 x 20; bench.py:830-848, :882-897) as (option_type,
# up-out barrier level or None, arm) and their f32 budgets (bench.py:
# 640-649); the flagship book's payoffs (payoff_batch_time) and kernel
# 2's at the golden grid (payoff_single), each with the budget of its
# bench arm
PAYOFF_ARMS = {"put_euro": ("put", None, "euro"),
               "put_amer_div": ("put", None, "amer_div"),
               "digital": ("digital_call", None, "euro"),
               "digital_amer": ("digital_call", None, "amer"),
               "barrier_amer_div": ("call", 160.0, "amer_div")}
PAYOFF_BUDGETS = {"put_euro": 3e-5, "put_amer_div": 3.5e-5,
                  "digital": 5e-6, "digital_amer": 5e-5,
                  "barrier_amer_div": 1e-4}
PAYOFF_BOOKS = {"call": ("call", None, MAIN_RMSE),
                "put": ("put", None, PAYOFF_BUDGETS["put_amer_div"]),
                "digital_call": ("digital_call", None,
                                 PAYOFF_BUDGETS["digital_amer"]),
                "up_out": ("call", 160.0,
                           PAYOFF_BUDGETS["barrier_amer_div"])}
PAYOFF_SINGLES = {"put": ("put", None, "euro", PAYOFF_BUDGETS["put_euro"]),
                  "digital_call_amer": ("digital_call", None, "amer",
                                        PAYOFF_BUDGETS["digital_amer"]),
                  "up_out": ("call", 160.0, "amer_div",
                             PAYOFF_BUDGETS["barrier_amer_div"])}
# the TPU kernel each CUDA source replaces (the kernels line)
REPLACES = {"fused_do": "heston_tpu/pallas/fused_do.py:328",
            "fused_single": "heston_tpu/pallas/fused_single.py:110"}
# ROADMAP C9, the fma_build phase: the arms run on both builds (name:
# (scheme, Rannacher steps, option_type, up-out level, arm) on kernel 1;
# Jacobian arms: scheme, European; kernel 2's single-option arms at
# K = 100: (Rannacher steps, American, golden dividends)) and their bench
# budgets (bench.py:640-649)
FMA_ARMS = {
    **{arm: ("do", 0, "call", None, arm)
       for arm in ("euro", "amer", "div", "amer_div")},
    **{scheme: (scheme, 0, "call", None, "euro") for scheme in CORRECTORS},
    "rann": ("do", 2, "call", None, "euro"),
    "rann_amer_div": ("do", 2, "call", None, "amer_div"),
    **{name: ("do", 0, *arm) for name, arm in PAYOFF_ARMS.items()}}
FMA_JAC_ARMS = {"jac": "do", "jac_cs": "cs"}
FMA_SINGLE_ARMS = {"single_euro": (0, False, False),
                   "single_amer_div": (0, True, True),
                   "single_rann": (2, False, False)}
FMA_BUDGETS = {**{k: ARM_BUDGETS[k] for k in ("euro", "amer", "div",
                                              "amer_div", "rann",
                                              "rann_amer_div",
                                              "single_amer_div",
                                              "single_rann")},
               **SCHEME_BUDGETS, **PAYOFF_BUDGETS, "jac": JAC_RMSE,
               "jac_cs": JAC_CS_RMSE, "single_euro": ARM_BUDGETS["euro"]}
GOLDEN_CONVERGED = 8.8943383103218502
GOLDEN_CONV_TOL = 2e-2
# book_risk500's f32 normalized RMSE under Douglas as PERF.md records it
# (NVIDIA H100 80GB HBM3, 700 W), printed beside HV's
RISK_DO_RECORDED = {"theta": 3.5e-4, "vanna": 5.3e-4, "volga": 1.8e-3}
REPS = 20
CAL_REPS = 5
# kernel 2's latency floor: its penta sweep runs nv dependent rows forward
# and nv back a stage (a corrector: two stages a step). The float32 FMA
# build's SASS (cuobjdump -sass, the golden Douglas instantiation) chains
# FMUL -> FFMA -> FFMA a forward row and FFMA -> FFMA a back row; each
# dependent operation is taken at an assumed 4 cycles on Hopper, at the
# card's top SM clock
SWEEP_CHAIN_OPS = (3, 2)
OP_CYCLES = 4
# the JAX package's round-5 TPU float32 records (ROUND5_NOTES.md:84-90),
# printed beside the port's fits for comparison only
TPU_RECORDS = {"lm60": {"sse": 0.0593, "iv_rmse_bp": 13.9},
               "lm_multi200": {"sse": 0.0959, "iv_rmse_bp": 73.0}}
# the port's own lm_multi200 fit with one launch per maturity group
# (chip run, PR 2, NVIDIA H100 80GB HBM3, 700 W), printed beside the
# one-launch fit
PER_GROUP_FIT = {"lm_multi200": {"sse": 0.0955, "iv_rmse_bp": 75.1}}
# mixed-maturity books (bench.py:1195-1237): 10 maturity groups at
# 2, 4, ..., 20 steps of the shared dt
N_GROUPS = 10
MIXED_PER_GROUP = 500          # mixed5000: the 500 ladder in every group
LANE_BOOK = 40                 # per_lane_vs_plain: options of the 500 ladder
MIXED_RMSE = {"euro": 2e-5, "amer_div": 3e-5}
RISK_REL_TOL = 1e-10           # f64 risk columns, kernel vs plain, relative
                               # to max(1, |x|)
MIXED_REL_TOL = 1e-12          # f64 one-launch book vs per-group launches
EAGER_F64_TOL = 1e-10          # f64 eager loop vs kernel 1 (the JAX
                               # package holds its kernel against "scan"
                               # at 1e-11, tests/test_pallas.py:54)
PAG_RTOL, PAG_ATOL = 1e-9, 1e-10  # price_and_greeks branches
                                  # (tests/test_greeks.py:50-63)
CF_F64_TOL = 1e-10            # CF chain: card f64 vs CPU f64, max abs
CF_F32_TOL = 1e-4             # CF chain: card f32 (complex64) vs CPU f64,
                              # max abs (the CPU's f32: 1.4e-5 on 60..150)
BENCH_TIMEOUT_S = 600         # python -m heston_tpu_torch.bench
CURVE_FLAT_TOL = 1e-12         # f64 constant curve vs flat scalars (max
                               # abs), and a phase cut into equal segments
                               # vs uncut (max_rel: each cut folds the
                               # compensation into u and round-trips lambda
                               # through lambda/dt, ulps of surfaces ~10^3)
# Monte Carlo, sharding, the CLI and the examples
MC_GOLDEN = 8.8943383103218502   # European call (tests/test_oracles.py:84-92)
MC_AMER_DIV_GOLDEN = 5.285130942409008   # American call, golden dividends
                                         # (tests/test_oracles.py:171-190)
MC_REPS = 5
MC_F32_PARITY_REL = 1e-5       # f32 knock-in + knock-out vs vanilla, rel
MC_F32_LSMC_GAP = 0.06         # f32 vs f64 LSMC dividend call, seed 0: the
                               # f32 5x5 regression's bias (0.034 on the
                               # H100 at 600k paths; JAX's f32 shows it too,
                               # scripts/torch_mc_bias.py lsmc32) + noise
SHARD_F64_TOL = 1e-12          # sharded vs one device, f64, max abs (risk:
                               # max_rel)
SHARD_NORMAL_EQ_TOL = 1e-10    # sharded LM step vs the dense one, f64, rel
SHARD_SSE_REL = 1e-3           # calibrate_sharded's SSE vs calibrate_device's
CLI_TOL = 1e-12                # f64 CLI output vs the in-process entry
                               # point, relative to max(1, |x|)
CLI_TIMEOUT_S = 300
# `python -c CLI_COUNTED argv...` runs `python -m heston_tpu_torch.cli
# argv...` (runpy, as -m does) and then writes the process's own kernel
# launch counts (kernel 2, kernel 1, kernel 1's forward mode) to stderr
CLI_COUNTED = """\
import json, runpy, sys
from heston_tpu_torch.kernels import fused_do, fused_single
try:
    runpy.run_module("heston_tpu_torch.cli", run_name="__main__",
                     alter_sys=True)
    rc = 0
except SystemExit as exc:
    rc = exc.code
print("CLI_LAUNCHES " + json.dumps([
    fused_single.fused_single_loop.launches, fused_do.fused_do_loop.launches,
    fused_do.fused_do_loop.tangent_launches]), file=sys.stderr)
sys.exit(rc)
"""
LM_INIT = (1.2, 0.05, 0.4, -0.5, 0.05)


def phase(name, **values):
    print(json.dumps({"phase": name, **values}), flush=True)


def section_clock():
    """mark(name): print the wall seconds of the section that ends there
    on a line of its own, and start the section `name` (None: the last
    one ends)."""
    current = {"name": None, "t0": 0.0}

    def mark(name=None):
        now = time.perf_counter()
        if current["name"] is not None:
            print(json.dumps({"section": current["name"],
                              "wall_s": now - current["t0"]}), flush=True)
        current.update(name=name, t0=now)
    return mark


def rmse(a, b):
    return float(torch.sqrt(torch.mean((a.double() - b.double()) ** 2)))


def cuda_ms(fn, reps=REPS):
    """Median milliseconds of fn() from CUDA events, after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def host_ms(fn, reps=REPS):
    """Median milliseconds of fn() + synchronize on the host clock."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def device_profile(fn, reps=5):
    """fn() under torch.profiler (after a warm-up), one call a session in
    `reps` sessions: the medians of the number of device kernels a call
    launches, their busy time (the union of their intervals) and the
    device time of the time-loop kernels (the batched one's primal and
    forward-mode instantiations, the single-option one), in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    rows = []
    for _ in range(reps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        busy, end = 0.0, float("-inf")
        for e in kernels:
            start = max(e.time_range.start, end)
            end = max(end, e.time_range.end)
            busy += max(0.0, e.time_range.end - start)
        # fused_do_kernel<T, TAN, SCHEME, GEN>: TAN = true is the
        # forward-mode variant (demangled ", true," or ", (bool)1,",
        # mangled "Lb1E" right after the type)
        loop = [(e.time_range.elapsed_us(),
                 bool(re.search(r"fused_do_kernel(<[^,]+, (true|\(bool\)1),"
                                r"|I[fd]Lb1E)", e.name)))
                for e in kernels if "fused_do_kernel" in e.name]
        rows.append(dict(
            device_kernels=len(kernels), device_busy_ms=busy / 1e3,
            primal_kernel_device_ms=sum(
                us for us, tan in loop if not tan) / 1e3,
            tangent_kernel_device_ms=sum(us for us, tan in loop if tan) / 1e3,
            single_kernel_device_ms=sum(
                e.time_range.elapsed_us() for e in kernels
                if "fused_single_kernel" in e.name) / 1e3))
    return {k: statistics.median(r[k] for r in rows) for k in rows[0]}


def single_device_ms(fn, launches, reps=15, kernel="fused_single_kernel"):
    """Kernel 2's device time of fn() (its `launches` launches summed; of
    another kernel, by the name `kernel` its device operations hold),
    the median over `reps` calls in one torch.profiler session after a
    warm-up: a session of one short call can come back without its kernel
    events (device_profile's sessions did on one run), one of many has
    not. None if the session recorded no launch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and kernel in e.name),
                    key=lambda e: e.time_range.start)
    times = [sum(e.time_range.elapsed_us()
                 for e in events[i:i + launches]) / 1e3
             for i in range(0, len(events) - launches + 1, launches)]
    return statistics.median(times) if times else None


def plan_kernel_rows(fused_single, gspec, gsolver, args, dividends, dev,
                     launches):
    """The single-option plan kernel (csrc/fused_single.cu
    single_plan_kernel, behind fused_single.device_plan) against its plain
    version, the host plan run on the card and packed
    (fused_single.pack_plan of single_plan), bitwise in every field in
    float32 and float64 at the golden grid for the quote's three products
    (European, European with the golden dividends, American with them);
    then, in float32, the plan kernel's device time, the wrapper's (CUDA
    events) and the host plan's it replaces, beside the kernel's bound:
    the bytes it writes at 3.35 TB/s. `launches`: the plan kernel's
    launches in the golden quote's own run (single_golden). Returns (rows,
    the kernels line's entry, with that count and the largest difference
    measured here); raises on a field that differs or a launch count that
    is not one a plan."""
    products = {"european": {}, "european_dividends": dict(
        dividends=dividends), "american_dividends": dict(
        american=True, dividends=dividends)}
    rows, max_abs = {}, 0.0
    for dtype in (torch.float32, torch.float64):
        k1 = torch.tensor([100.0], dtype=dtype, device=dev)
        for name, kw in products.items():
            before = fused_single.device_plan.launches
            got = fused_single.device_plan(gspec, gsolver, k1, 100.0, *args,
                                           **kw)
            want = fused_single.pack_plan(*fused_single.single_plan(
                gspec, gsolver, k1, 100.0, *args, **kw))
            torch.cuda.synchronize()
            n = fused_single.device_plan.launches - before
            differ = [f for f, g, w in zip(fused_single.DevicePlan._fields,
                                           got[:-1], want[:-1])
                      if not (torch.equal(g, w) and (
                          not g.is_floating_point() or torch.equal(
                              torch.signbit(g), torch.signbit(w))))]
            err = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got[:-1], want[:-1]) if g.numel())
            max_abs = max(max_abs, err)
            rows[f"{name}_{str(dtype)[-7:]}"] = dict(
                launches=n, fields_that_differ=differ, max_abs_err=err)
            if differ or n != 1:
                raise AssertionError(f"plan kernel, {name} {dtype}: fields "
                                     f"{differ} differ from the host plan, "
                                     f"{n} launches")
    k32 = torch.tensor([100.0], device=dev)
    kw = products["american_dividends"]

    def plan():
        return fused_single.device_plan(gspec, gsolver, k32, 100.0, *args,
                                        **kw)

    host = cuda_ms(lambda: fused_single.single_plan(gspec, gsolver, k32,
                                                    100.0, *args, **kw))
    wrapper = cuda_ms(plan)
    device = single_device_ms(plan, 1, kernel="single_plan_kernel")
    out = plan()
    written = sum(t.numel() * t.element_size() for t in out[:-1])
    bound = written / 3.35e12 * 1e3
    rows["timing_f32_american_dividends"] = dict(
        device_ms=device, wrapper_ms=wrapper, host_plan_ms=host,
        bytes_written=written, bound_ms=bound)
    entry = {"name": "single_plan", "route": "cuda",
             "source": "heston_tpu_torch/csrc/fused_single.cu",
             "replaces": None, "launches": launches,
             "bitwise_max_abs_err": max_abs,
             "ms": wrapper, "device_ms": device, "plain_ms": host,
             "bound_ms": bound, "bound_by": "bytes", "library_ms": None}
    return rows, entry


def book_plan_kernel_rows(fused_do, spec, solver, args, dividends, dev,
                          launches, mixed):
    """The book's plan kernel (csrc/fused_do.cu book_plan_kernel, behind
    fused_do.device_book_plan) against its plain version, the host plan
    run on the card and packed (fused_do.pack_book_plan of book_plan),
    bitwise in every field in float32 and float64 at the main path's two
    shapes: the flagship book (the 500 ladder, American calls with the
    golden dividends) and the book cell's (`mixed`: 5,000 options in ten
    maturity groups of 2..20 steps, the same product). Then at each shape
    in the type the main path prices it (flagship float32, the cell
    float64) the plan kernel's device time, the wrapper's (CUDA events)
    and the host plan's it replaces, beside the kernel's bound: the bytes
    it writes at 3.35 TB/s. `launches`: the plan kernel's launches in one
    flagship call of the main path (main_path). Returns (rows, the kernels
    line's entry at the cell's shape, with that count and the largest
    difference measured here); raises on a field that differs or a launch
    count that is not one a plan."""
    kw = dict(american=True, dividends=dividends)

    def book(shape, dtype):
        if shape == "flagship500":
            return torch.linspace(70.0, 130.0, 500, dtype=dtype,
                                  device=dev), None
        return mixed(dev, dtype)

    def plan(ks, nst):
        return fused_do.device_book_plan(spec, solver, ks, 100.0, *args,
                                         n_steps_per=nst, **kw)

    def host_plan(ks, nst):
        fields, phases, at, _, _ = fused_do.book_plan(
            spec, solver, ks, 100.0, *args, n_steps_per=nst, **kw)
        return fused_do.pack_book_plan(fields, phases, at)

    rows, max_abs = {}, 0.0
    for shape in ("flagship500", "mixed5000"):
        for dtype in (torch.float32, torch.float64):
            ks, nst = book(shape, dtype)
            before = fused_do.device_book_plan.launches
            got = plan(ks, nst)
            want = host_plan(ks, nst)
            torch.cuda.synchronize()
            n = fused_do.device_book_plan.launches - before
            differ = [f for f, g, w in zip(fused_do.BookPlan._fields,
                                           got[:-1], want[:-1])
                      if (g is None) != (w is None) or (
                          g is not None and not (torch.equal(g, w) and (
                              not g.is_floating_point() or torch.equal(
                                  torch.signbit(g), torch.signbit(w)))))]
            err = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got[:-1], want[:-1])
                      if g is not None and w is not None and g.numel()
                      and g.shape == w.shape)
            max_abs = max(max_abs, err)
            rows[f"{shape}_{str(dtype)[-7:]}"] = dict(
                launches=n, fields_that_differ=differ, max_abs_err=err)
            if differ or n != 1:
                raise AssertionError(f"book plan kernel, {shape} {dtype}: "
                                     f"fields {differ} differ from the "
                                     f"host plan, {n} launches")
    entry = None
    for shape, dtype in (("flagship500", torch.float32),
                         ("mixed5000", torch.float64)):
        ks, nst = book(shape, dtype)
        host = cuda_ms(lambda: host_plan(ks, nst))
        wrapper = cuda_ms(lambda: plan(ks, nst))
        device = single_device_ms(lambda: plan(ks, nst), 1,
                                  kernel="book_plan_kernel")
        out = plan(ks, nst)
        written = sum(t.numel() * t.element_size() for t in out[:-1]
                      if t is not None)
        bound = written / 3.35e12 * 1e3
        rows[f"timing_{str(dtype)[-7:]}_{shape}"] = dict(
            device_ms=device, wrapper_ms=wrapper, host_plan_ms=host,
            bytes_written=written, bound_ms=bound)
        entry = {"name": "book_plan", "route": "cuda",
                 "source": "heston_tpu_torch/csrc/fused_do.cu",
                 "replaces": None, "launches": launches,
                 "bitwise_max_abs_err": max_abs,
                 "ms": wrapper, "device_ms": device, "plain_ms": host,
                 "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
                 "shape": f"{shape} {str(dtype)[-7:]}"}
    return rows, entry


def tangent_rows_kernel_rows(fused_do, greeks, spec, solver, args, dividends,
                             dev, mixed, groups):
    """The tangent-rows kernel (csrc/fused_do.cu tangent_rows_kernel,
    behind fused_do.tangent_rows: the forward mode's rows of the card
    Jacobian under v0_mode "stencil") against its plain version
    (fused_do._tangent_rows_plain) on the same card plan, bitwise in every
    row and sign, in float32 and float64 at the flagship's shape (the 500
    ladder, American calls with the golden dividends) and the risk cell's
    (`mixed`: 5,000 options in ten maturity groups of 2..20 steps,
    `groups`, the same product). Then one main-path risk call at each
    shape in the type the main path runs it (batch_greeks(...,
    param_jacobian=True): the flagship float32, the cell float64), the
    counters reset just before it: its launches of the tangent-rows
    kernel, the book's plan kernel and kernel 1's two variants. At the
    cell's shape in float64: the kernel's device time, the wrapper's (CUDA
    events) and the plain rows' on the card, beside the kernel's bound
    (the bytes it reads and writes at 3.35 TB/s); and the risk call's wall
    ms with the kernel's rows and with the plain rows in their place,
    alternating (the end-to-end A/B of the kernel). Returns (rows, the
    kernels line's entry at the cell's shape); raises on a row that
    differs or a risk call that does not launch each kernel once."""
    s_row = fused_do.KERNEL_S_KEYS.index("vecs")
    v_row = fused_do.KERNEL_V_KEYS.index("vfl")

    def plain(plan, theta, a2_variant):
        return fused_do._tangent_rows_plain(
            theta, plan.sf[:, s_row], plan.vf[:, v_row],
            a2_variant == "upwind")

    def book(shape, dtype):
        if shape == "flagship500":
            return torch.linspace(70.0, 130.0, 500, dtype=dtype,
                                  device=dev), None, ()
        ks, nst = mixed(dev, dtype)
        return ks, nst, groups

    def plan_of(ks, nst, theta):
        return fused_do.device_book_plan(
            spec, solver, ks, 100.0, *theta.unbind(), *args[5:],
            n_steps_per=nst, american=True, dividends=dividends)

    def risk(ks, group_steps):
        return greeks.batch_greeks(spec, solver, ks, 100.0, *args,
                                   american=True, dividends=dividends,
                                   group_steps=group_steps,
                                   param_jacobian=True)

    rows, main_launches = {}, {}
    for shape in ("flagship500", "mixed5000"):
        for dtype in (torch.float32, torch.float64):
            ks, nst, _ = book(shape, dtype)
            theta = torch.tensor(args[:5], dtype=dtype, device=dev)
            plan = plan_of(ks, nst, theta)
            before = fused_do.tangent_rows.launches
            got = fused_do.tangent_rows(plan, theta, solver.a2_variant)
            want = plain(plan, theta, solver.a2_variant)
            torch.cuda.synchronize()
            n = fused_do.tangent_rows.launches - before
            differ = [name for name, g, w in zip(("tsf", "tvf"), got, want)
                      if g.shape != w.shape or not (torch.equal(g, w) and
                                                    torch.equal(
                                                        torch.signbit(g),
                                                        torch.signbit(w)))]
            rows[f"{shape}_{str(dtype)[-7:]}"] = dict(
                launches=n, rows_that_differ=differ,
                max_abs_err=max(float((g.double() - w.double()).abs().max())
                                for g, w in zip(got, want)))
            if differ or n != 1:
                raise AssertionError(f"tangent rows kernel, {shape} {dtype}: "
                                     f"{differ} differ from the plain "
                                     f"version, {n} launches")
    for shape, dtype in (("flagship500", torch.float32),
                         ("mixed5000", torch.float64)):
        ks, _, group_steps = book(shape, dtype)
        risk(ks, group_steps)
        torch.cuda.synchronize()
        reset_counts()
        risk(ks, group_steps)
        torch.cuda.synchronize()
        counts = dict(tangent_rows=fused_do.tangent_rows.launches,
                      book_plan=fused_do.device_book_plan.launches,
                      kernel1=fused_do.fused_do_loop.launches,
                      kernel1_fwd=fused_do.fused_do_loop.tangent_launches)
        main_launches[shape] = counts
        rows[f"main_path_risk_{shape}_{str(dtype)[-7:]}"] = counts
        if counts != dict(tangent_rows=1, book_plan=1, kernel1=1,
                          kernel1_fwd=1):
            raise AssertionError(f"tangent rows, the main path's risk call "
                                 f"at {shape}: launches {counts}, want one "
                                 f"of each")
    ks, nst, group_steps = book("mixed5000", torch.float64)
    theta = torch.tensor(args[:5], dtype=torch.float64, device=dev)
    plan = plan_of(ks, nst, theta)
    wrapper = cuda_ms(lambda: fused_do.tangent_rows(plan, theta,
                                                    solver.a2_variant))
    device = single_device_ms(
        lambda: fused_do.tangent_rows(plan, theta, solver.a2_variant), 1,
        kernel="tangent_rows_kernel")
    plain_ms = cuda_ms(lambda: plain(plan, theta, solver.a2_variant))
    out = fused_do.tangent_rows(plan, theta, solver.a2_variant)
    moved = sum(t.numel() * t.element_size() for t in (
        *out, plan.sf[:, s_row], plan.vf[:, v_row], theta))
    bound = moved / 3.35e12 * 1e3
    # the risk call with the kernel's rows and with the plain rows in
    # their place (packed_jacobian reads fused_do.tangent_rows at call
    # time), alternating, each arm's median wall ms
    kernel_rows = fused_do.tangent_rows
    walls = {"kernel": [], "plain": []}
    try:
        for _ in range(2):
            for arm, fn in (("kernel", kernel_rows), ("plain", plain)):
                fused_do.tangent_rows = fn
                walls[arm].append(host_ms(lambda: risk(ks, group_steps),
                                          reps=5))
    finally:
        fused_do.tangent_rows = kernel_rows
    risk_ms = {arm: statistics.median(w) for arm, w in walls.items()}
    rows["timing_float64_mixed5000"] = dict(
        device_ms=device, wrapper_ms=wrapper, plain_rows_ms=plain_ms,
        bytes_moved=moved, bound_ms=bound,
        risk_call_ms_kernel_rows=risk_ms["kernel"],
        risk_call_ms_plain_rows=risk_ms["plain"])
    entry = {"name": "tangent_rows", "route": "cuda",
             "source": "heston_tpu_torch/csrc/fused_do.cu",
             "replaces": None,
             "launches": main_launches["mixed5000"]["tangent_rows"],
             "bitwise_max_abs_err": max(
                 r["max_abs_err"] for k, r in rows.items()
                 if "max_abs_err" in r),
             "ms": wrapper, "device_ms": device, "plain_ms": plain_ms,
             "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
             "shape": "mixed5000 float64"}
    return rows, entry


def chain_floor_ms(n_steps, nv, scheme, clock_mhz):
    """The least time kernel 2's dependent chain takes, computed, not
    measured: n_steps steps of one (Douglas) or two (a corrector) penta
    sweeps of nv forward and nv back rows at SWEEP_CHAIN_OPS dependent
    operations of OP_CYCLES cycles, at clock_mhz. No placement of the
    work shortens it: one option's time loop cannot use the card's whole
    rate, which is what kernel_bound's throughput bound assumes."""
    stages = 1 if scheme == "do" else 2
    return (1e3 * n_steps * stages * nv * sum(SWEEP_CHAIN_OPS) * OP_CYCLES
            / (clock_mhz * 1e6))


def single_plan_row(fused_single, fields, scheme, plan=None):
    """Kernel 2's launch plan of a launch on `fields` (the default plan,
    or `plan`) with its resources on this card: cluster, rows, threads,
    fields in shared memory, shared bytes (the kernel's count, checked
    against the plan's), registers, local bytes, clusters at once."""
    nv, ns = fields["u"].shape
    dtype = fields["u"].dtype
    plan = plan or fused_single.default_plan(dtype, ns, nv, scheme)
    occ = fused_single.occupancy(dtype, ns, nv, scheme, plan)
    if occ["smem_bytes"] != plan.smem_bytes:
        raise AssertionError(f"fused_single {scheme}: the kernel's shared "
                             f"bytes {occ['smem_bytes']} != the plan's "
                             f"{plan.smem_bytes}")
    return occ


def forced_do_loop(fmad=None, **forced):
    """fused_do_loop's interface on the card with the build `fmad` and,
    given `forced` (launch_plan's smem_budget and groups), that launch plan
    for this card forced at kernel 1's one launch: the fields packed as the
    loop packs them, then `_launch_packed`."""
    from heston_tpu_torch.kernels import fused_do

    def loop(fields, steps, remaps, *, tangents=None, nst=None,
             segment=None, **kw):
        fields = fields if segment is None else {**fields, **segment}
        u = fields["u"]
        plan = fused_do.launch_plan(
            *u.shape, u.element_size(), kw.get("scheme", "do"),
            kw["american"], len(tangents or ()),
            n_sm=fused_do._sm_count(torch.cuda.current_device()),
            **forced) if forced else None
        got = fused_do._launch_packed(
            *fused_do._pack(fields, steps, remaps, nst), **kw, fmad=fmad,
            plan=plan, tangent=None if tangents is None
            else fused_do._pack_tangents(fields, tangents, kw["american"]))
        if tangents is None:
            return got
        u, lam, du, dlam = got
        return (u, lam, list(du.unbind(1)),
                None if dlam is None else list(dlam.unbind(1)))
    return loop


def forced_single_loop(fmad=None, **forced):
    """fused_single_loop's interface on the card with the build `fmad`
    and, given `forced` (launch_plan's cluster and factors), that launch
    plan forced at kernel 2's one launch: the fields packed as the loop
    packs them, then `_launch_packed`."""
    from heston_tpu_torch.kernels import fused_single

    def loop(fields, steps, remaps, **kw):
        nv, ns = fields["u"].shape
        plan = fused_single.launch_plan(
            ns, nv, fields["u"].element_size(), kw["scheme"],
            **forced) if forced else None
        return fused_single._launch_packed(
            *fused_single._pack(fields, steps, remaps), **kw, fmad=fmad,
            plan=plan)
    return loop


def launch_counts():
    from heston_tpu_torch.kernels import fused_do, fused_single

    return (fused_single.fused_single_loop.launches,
            fused_do.fused_do_loop.launches)


def reset_counts():
    from heston_tpu_torch.kernels import fused_do, fused_single

    fused_single.device_plan.launches = 0
    fused_do.device_book_plan.launches = 0
    fused_do.tangent_rows.launches = 0
    fused_single.fused_single_loop.launches = 0
    fused_do.fused_do_loop.launches = 0
    fused_do.fused_do_loop.tangent_launches = 0


def max_rel(a, b):
    """max |a - b| / max(1, |b|), in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(((a - b).abs() / b.abs().clamp(min=1.0)).max())


def norm_rmse(a, b):
    """RMSE of (a - b) / max(1, |b|), in float64."""
    a, b = a.double().cpu(), b.double().cpu()
    return float(torch.sqrt(torch.mean(((a - b) / b.abs().clamp(min=1.0))
                                       ** 2)))


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


LADDER_MATS = [0.1 * (i + 1) for i in range(10)]


def lm_multi200(dev, dtype):
    """The bench's 10 x 20 maturity ladder (bench.py:1012-1105): strikes
    [200], the flat-vol-0.2 market at HestonParams' r_d and the (start,
    end, n_steps) groups at 20 steps a year."""
    from heston_tpu_torch import HestonParams
    from heston_tpu_torch.models import bs

    ks_one = torch.tensor([80.0 + i * 2.0 for i in range(20)],
                          dtype=torch.float64, device=dev)
    market = torch.cat([
        bs.generate_market_data(100.0, t, HestonParams().r_d, ks_one)
        for t in LADDER_MATS])
    groups = tuple((20 * i, 20 * (i + 1), max(1, round(20 * t)))
                   for i, t in enumerate(LADDER_MATS))
    return ks_one.repeat(10).to(dtype), market.to(dtype), groups


def gloo_rank(rank, world, port, out):
    """One rank of the sharded phase's gloo world on one card (NCCL
    refuses two ranks on one GPU; gloo takes the CUDA tensors through the
    host): the flagship book through price_batch_sharded in float64 and
    float32 and the lm_multi200 ladder through calibrate_sharded in
    float32, each with its kernel launches and host wall ms; saved to
    <out>/rank<rank>.pt (a traceback if it failed)."""
    import traceback

    import torch.distributed as dist

    res = {}
    try:
        from heston_tpu_torch import (GOLDEN_DIVIDENDS, CalibrationConfig,
                                      GridSpec, HestonParams, SolverConfig)
        from heston_tpu_torch import parallel as par
        from heston_tpu_torch.kernels import fused_do

        par.ensure_distributed("cuda:0", backend="gloo",
                               init_method=f"tcp://localhost:{port}",
                               world_size=world, rank=rank)
        mesh = par.make_mesh("cuda:0")
        p = HestonParams()
        spec = GridSpec(m1=50, m2=25)
        solver = SolverConfig(n_steps=20, solver_engine="pallas")
        tv = torch.tensor(p.bumpable(), dtype=torch.float64)
        res["backend"] = dist.get_backend()

        def counted(fn):
            reset_counts()
            t0 = time.perf_counter()
            out_ = fn()
            torch.cuda.synchronize()
            return out_, 1e3 * (time.perf_counter() - t0), (
                *launch_counts(), fused_do.fused_do_loop.tangent_launches)

        for dtype in (torch.float64, torch.float32):
            book = torch.linspace(70.0, 130.0, 500, dtype=dtype,
                                  device=mesh.device)
            prices, wall, counts = counted(lambda: par.price_batch_sharded(
                mesh, spec, solver, book, 100.0, tv, p.r_d, p.r_f,
                american=True, dividends=GOLDEN_DIVIDENDS))
            res[str(dtype)] = dict(prices=prices.cpu(), wall_ms=wall,
                                   launches=counts)
        ks, market, groups = lm_multi200(mesh.device, torch.float32)
        (tv_s, info), wall, counts = counted(lambda: par.calibrate_sharded(
            mesh, spec, solver, ks, market, 100.0, torch.tensor(LM_INIT),
            p.r_d, p.r_f, cfg=CalibrationConfig(max_iter=15, tol=0.1,
                                                jacobian_mode="ad"),
            group_steps=groups))
        res["lm_multi200"] = dict(
            params=tv_s.tolist(), final_sse=info["final_error"],
            iterations=info["iterations"], wall_ms=wall, launches=counts,
            trials=sum("new_sse" in h for h in info["history"]))
    except Exception:
        res["traceback"] = traceback.format_exc()
    finally:
        torch.save(res, Path(out) / f"rank{rank}.pt")
        if dist.is_initialized():
            dist.destroy_process_group()


def mixed_book(dev, dtype, per):
    """The bench's mixed-maturity book (bench.py:1214-1215): the ladder
    linspace(70, 130, per) in every one of N_GROUPS groups, group i at
    2*(i + 1) steps. Returns (strikes [10*per], steps [10*per])."""
    ks = torch.linspace(70.0, 130.0, per, dtype=dtype, device=dev)
    nst = 2 * (torch.arange(N_GROUPS, device=dev) + 1)
    return ks.repeat(N_GROUPS), nst.repeat_interleave(per)


def lane_book(dev, dtype):
    """LANE_BOOK options of the 500 ladder (every 12th), the 10 groups'
    step counts 2..20 interleaved."""
    ks = torch.linspace(70.0, 130.0, 500, dtype=dtype, device=dev)
    nst = 2 * (torch.arange(LANE_BOOK, device=dev) % N_GROUPS + 1)
    return ks[::12][:LANE_BOOK], nst


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    # the package is imported only once a card is known to be there; run
    # alone (no checkout around the script) the smoke run fails here
    try:
        import heston_tpu_torch
        # a launch's bound from the benchmark's frozen operation counts
        # and peaks
        from perfbench.roofline import kernel_bound, lane_events
    except ModuleNotFoundError as exc:
        raise SystemExit(f"chip_smoke: {exc}: run it from the root of a "
                         f"checkout of the repository")
    from heston_tpu_torch import (GOLDEN_DIVIDENDS, Barrier,
                                  CalibrationConfig, GridSpec, HestonParams,
                                  RateSchedule, SolverConfig)
    from heston_tpu_torch.bench import iv_rmse
    from heston_tpu_torch.kernels import (assembly, cuda_build, fused_do,
                                          fused_single)
    from heston_tpu_torch.models import bs, calibration, greeks
    from heston_tpu_torch.ops import operators

    # every float32 kernel-against-plain check launches the -fmad=false
    # builds, whose arithmetic is the plain version's operation for
    # operation (a kernels entry's bitwise_max_abs_err); the main path and
    # the timings take the build cuda_build.use_fmad picks (float32: the FMA
    # build for a primal launch, -fmad=false for the forward mode), held
    # against the float64 plain version by the arms' RMSE
    # budgets (a kernels entry's max_abs_err and RMSE)
    # (both forced at the kernels' one launch, `_launch_packed`)
    bitwise_do = forced_do_loop(fmad=False)
    bitwise_single = forced_single_loop(fmad=False)

    def vs_f64(got32, want64, budget, what, norm=False):
        """The timed build's float32 result against the float64 plain
        version on the same inputs: max abs and RMSE (normalized by
        max(1, |x|) with `norm`, as the Jacobians are); raises when a value
        is not finite or the RMSE is over `budget`."""
        got, want = got32.detach().double().cpu(), want64.double().cpu()
        err = norm_rmse(got, want) if norm else rmse(got, want)
        if not (bool(torch.isfinite(got).all()) and err <= budget):
            raise AssertionError(f"{what}: the timed f32 build's RMSE {err} "
                                 f"against the f64 plain version, budget "
                                 f"{budget}")
        return {"max_abs_err": float((got - want).abs().max()),
                "rmse_vs_plain_f64": err, "rmse_budget": budget}

    def kernel_entry(name, source, launches, timed, bitwise, ms, plain_ms,
                     bound, bound_by, **extra):
        """One entry of the kernels line: `timed` from vs_f64, `bitwise`
        the -fmad=false build against the float32 plain version; `extra`
        (kernel 2: its plan and chain floor) after the contract's keys."""
        return {"name": name, "route": "cuda",
                "source": f"heston_tpu_torch/csrc/{source}.cu",
                "replaces": REPLACES[source], "launches": launches, **timed,
                "bitwise_max_abs_err": bitwise, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": None, **extra}

    mark = section_clock()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    phase("device", kind=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda, sm_clock_max_mhz=clock_mhz)

    # one nvcc per source and build (-fmad=false, -fmad=true), all four
    # started together
    mark("build")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        libs = list(pool.map(lambda a: cuda_build.build(*a), [
            (src, fmad) for fmad in (False, True)
            for src in (fused_do.SOURCE, fused_single.SOURCE)]))
    phase("build", seconds=time.perf_counter() - t0,
          libraries=[lib.name for lib in libs])

    p = HestonParams()
    spec = GridSpec(m1=50, m2=25)
    solver = SolverConfig(n_steps=20, theta=0.8, maturity=1.0,
                          a2_variant="upwind", solver_engine="pallas")
    args = (p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d, p.r_f)
    arms = {
        "euro": dict(american=False, dividends=None),
        "amer": dict(american=True, dividends=None),
        "div": dict(american=False, dividends=GOLDEN_DIVIDENDS),
        "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS),
    }

    def inputs(strikes, arm, scheme="do"):
        fields, vec_s, idx_s, idx_v, _ = assembly.assemble(
            spec, solver, strikes, 100.0, *args)
        events = assembly.dividend_plan(solver, arms[arm]["dividends"])
        remaps = assembly.build_remap_fields(vec_s, events)
        kw = dict(theta=solver.theta, delta_t=solver.delta_t,
                  n_steps=solver.n_steps, rf=p.r_f,
                  american=arms[arm]["american"], scheme=scheme)
        return (fields, [e[0] for e in events], remaps, kw), (idx_s, idx_v)

    def prices(u, idx):
        return fused_do._extract(u, *idx)

    theta = [p.kappa, p.eta, p.sigma, p.rho, p.v0]

    def tangent_inputs(strikes, arm, sol=solver, params=theta, nst=None):
        tv = torch.tensor(params, dtype=strikes.dtype, device=dev)
        fields, tangents, vec_s, idx_s, idx_v = fused_do._linearized_assemble(
            spec, sol, strikes, 100.0, tv, p.r_d, p.r_f, nst)
        (steps, remaps, kw), = fused_do.book_phases(
            sol, arms[arm]["dividends"], vec_s, p.r_f, arms[arm]["american"],
            nst)
        return ((fields, steps, remaps, dict(kw, tangents=tangents)),
                (fields["vfl"], idx_s, idx_v, tv[4]))

    def jac_vs_f64(plan, budget, what):
        """vs_f64 of a Jacobian (normalized): plan(dtype) gives the
        forward-mode launch ((loop arguments, keywords)) and
        _read_jacobian's extra arguments at that dtype; the float32 one
        runs on the timed build, the float64 one on the plain version."""
        jacs = []
        for dtype, loop in ((torch.float32, fused_do.fused_do_loop),
                            (torch.float64, fused_do.fused_do_reference)):
            (loop_args, loop_kw), extra = plan(dtype)
            u, _, dus, _ = loop(*loop_args, **loop_kw)
            jacs.append(fused_do._read_jacobian(spec, u, dus, *extra)[1])
        return vs_f64(*jacs, budget, what, norm=True)

    def chain_plan(strikes, sol):
        """jac_vs_f64's plan of a European call chain at the default
        parameters (tangent_inputs)."""
        def plan(dtype):
            loop, extra = tangent_inputs(strikes.to(dtype), "euro", sol=sol)
            return (loop[:3], loop[3]), extra
        return plan

    flagship = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    ks = torch.linspace(75.0, 125.0, 64, dtype=torch.float64, device=dev)

    mark("fma_build")
    # ---- C9: the float32 error of the two builds side by side (ROADMAP
    # C9): the bench's arms on kernel 1 (64 strikes in [75, 125], 50 x 25
    # x 20; the schemes, Rannacher, the payoffs), its Jacobian arms,
    # kernel 2's single-option arms (K = 100),
    # each f32 against the f64 -fmad=false kernel, and HV's book_risk500
    # columns against f64. The float32 main path's primal launches take the
    # FMA build and its forward mode the -fmad=false one (cuda_build.use_fmad),
    # chosen because they bring hv within the bench's 2e-5 and keep every
    # other arm within its budget: each arm is gated on the build the main
    # path takes for it (the Jacobian arms on -fmad=false), and the phase fails
    # when it no longer does
    sol_hv = dataclasses.replace(solver, scheme="hv")
    ks_r = torch.linspace(70.0, 130.0, 500, dtype=torch.float64, device=dev)

    def hv_risk(strikes, fmad):
        fields, phases_h, at, ops, vec_s = fused_do.book_plan(
            spec, sol_hv, strikes, 100.0, *args, **flagship, epilogue=True)
        u, lam = assembly.run_phases(
            forced_do_loop(fmad=fmad), fields,
            phases_h)
        return greeks.risk_epilogue(spec, sol_hv, strikes, p.v0, p.r_d,
                                    p.r_f, (u, lam, ops, vec_s, *at))

    def arm_prices(strikes, name, fmad):
        scheme, rann, option_type, level, arm = FMA_ARMS[name]
        fields, phases_a, at, _, _ = fused_do.book_plan(
            dataclasses.replace(spec, barrier=None if level is None
                                else Barrier("up-out", level)),
            dataclasses.replace(solver, scheme=scheme, rannacher_steps=rann),
            strikes, 100.0, *args, option_type=option_type, **arms[arm])
        u, _ = assembly.run_phases(
            forced_do_loop(fmad=fmad), fields,
            phases_a)
        return prices(u, at)

    def single_price(arm, dtype, fmad):
        rann, american, div = FMA_SINGLE_ARMS[arm]
        sf, ph, at = fused_single.single_plan(
            spec, dataclasses.replace(solver, rannacher_steps=rann),
            torch.tensor([100.0], dtype=dtype, device=dev), 100.0, *args,
            american=american, dividends=GOLDEN_DIVIDENDS if div else None)
        u, _ = assembly.run_phases(
            forced_single_loop(fmad=fmad), sf,
            ph)
        return u[at]

    ref64 = {}
    for name in FMA_ARMS:
        ref64[name] = arm_prices(ks, name, False)
    for name, scheme in FMA_JAC_ARMS.items():
        loop64, extra64 = tangent_inputs(
            ks, "euro", sol=dataclasses.replace(solver, scheme=scheme))
        u, _, dus, _ = forced_do_loop(fmad=False)(*loop64[:3], **loop64[3])
        ref64[name] = fused_do._read_jacobian(spec, u, dus, *extra64)[1]
    for name in FMA_SINGLE_ARMS:
        ref64[name] = single_price(name, torch.float64, False)
    risk64 = hv_risk(ks_r, False)
    builds, within = {}, {}
    for fmad in (False, True):
        row = {}
        for name in FMA_ARMS:
            row[name] = rmse(arm_prices(ks.float(), name, fmad), ref64[name])
        for name, scheme in FMA_JAC_ARMS.items():
            loop32, extra32 = tangent_inputs(
                ks.float(), "euro",
                sol=dataclasses.replace(solver, scheme=scheme))
            u, _, dus, _ = forced_do_loop(fmad=fmad)(*loop32[:3],
                                                     **loop32[3])
            row[name] = norm_rmse(
                fused_do._read_jacobian(spec, u, dus, *extra32)[1],
                ref64[name])
        for name in FMA_SINGLE_ARMS:
            row[name] = abs(float(single_price(name, torch.float32, fmad))
                            - float(ref64[name]))
        risk32 = hv_risk(ks_r.float(), fmad)
        key = "fmad=true" if fmad else "fmad=false"
        builds[key] = dict(
            row, hv_risk500_price_rmse=rmse(risk32["price"], risk64["price"]),
            hv_risk500_norm_rmse={k: norm_rmse(risk32[k], risk64[k])
                                  for k in ("theta", "vanna", "volga")})
        within[key] = {k: row[k] <= FMA_BUDGETS[k] for k in FMA_BUDGETS}
        if not all(torch.isfinite(x).all() for x in risk32.values()):
            raise AssertionError(f"fma_build {key}: non-finite HV risk")
    main_build = {k: "fmad=true" if cuda_build.use_fmad(
        torch.float32, tangent=k in FMA_JAC_ARMS) else "fmad=false"
        for k in FMA_BUDGETS}
    fma_ok = all(within[main_build[k]][k] for k in FMA_BUDGETS)
    phase("fma_build", budgets=FMA_BUDGETS, builds=builds, within=within,
          main_path_build=main_build, main_path_within_every_budget=fma_ok)
    if not fma_ok:
        raise AssertionError(f"fma_build: a float32 main-path build misses "
                             f"a budget: {within}, builds {main_build}")

    mark("kernel_vs_plain")
    # ---- kernel against plain, every arm, f64 and f32
    for arm in arms:
        loop64, idx64 = inputs(ks, arm)
        got64, _ = fused_do.fused_do_loop(*loop64[:3], **loop64[3])
        want64, _ = fused_do.fused_do_reference(*loop64[:3], **loop64[3])
        torch.cuda.synchronize()
        err64 = float((got64 - want64).abs().max())
        loop32, idx32 = inputs(ks.float(), arm)
        got32, _ = fused_do.fused_do_loop(*loop32[:3], **loop32[3])
        err32 = rmse(prices(got32, idx32), prices(want64, idx64))
        phase("kernel_vs_plain", arm=arm, f64_max_abs=err64,
              f64_tol=F64_KERNEL_TOL, f32_rmse=err32,
              f32_budget=ARM_BUDGETS[arm])
        if not err64 <= F64_KERNEL_TOL:
            raise AssertionError(f"{arm}: f64 kernel vs plain {err64}")
        if not err32 <= ARM_BUDGETS[arm]:
            raise AssertionError(f"{arm}: f32 RMSE {err32} over budget")

    mark("lam_carry")
    # ---- a nonzero input multiplier (the American state a later phase
    # takes over): local steps 3..20 at delta_t/2, f64 and f32, surfaces
    # and multipliers against the plain version
    gen = torch.Generator(device="cpu").manual_seed(3)
    lam_in = torch.rand((64, spec.m1 + 1, spec.m2 + 1), generator=gen,
                        dtype=torch.float64)
    for dtype, tol in ((torch.float64, F64_KERNEL_TOL),
                       (torch.float32, F32_SURFACE_TOL)):
        (fields, steps, remaps, kw), _ = inputs(ks.to(dtype), "amer_div")
        fields["lam"] = lam_in.to(dtype=dtype, device=dev)
        keep = [k for k, step in enumerate(steps) if step >= 3]
        kw.update(first_step=3, delta_t=solver.delta_t / 2)
        lam_args = (fields, [steps[k] for k in keep],
                    [remaps[k] for k in keep])
        got = bitwise_do(*lam_args, **kw)
        want = fused_do.fused_do_reference(*lam_args, **kw)
        err_u, err_lam = (float((g - w).abs().max())
                          for g, w in zip(got, want))
        phase("lam_carry", dtype=str(dtype), u_max_abs=err_u,
              lam_max_abs=err_lam, tol=tol)
        if not (err_u <= tol and err_lam <= tol):
            raise AssertionError(f"{dtype}: kernel vs plain with a nonzero "
                                 f"input lambda: {err_u}, {err_lam}")

    mark("pin")
    # ---- scheme pins (tests/test_douglas.py:51-52), f64, on both routes:
    # price_batch with one strike (the single-option kernel) and the
    # batched kernel at B = 1
    for strike, kw, pin in (
            (95.0, dict(american=True, dividends=GOLDEN_DIVIDENDS),
             8.510573074266677),
            (100.0, dict(dividends=GOLDEN_DIVIDENDS), 3.85096222593301)):
        k1 = torch.tensor([strike], dtype=torch.float64, device=dev)
        reset_counts()
        got = float(heston_tpu_torch.price_batch(spec, solver, k1, 100.0,
                                                 *args, **kw)[0])
        single_route = launch_counts()
        got_b = float(fused_do.fused_price_batch(spec, solver, k1, 100.0,
                                                 *args, **kw)[0])
        phase("pin", strike=strike, want=pin, single=got,
              single_err=got - pin, batched=got_b, batched_err=got_b - pin,
              single_route_launches=single_route)
        if single_route != (1, 0):
            raise AssertionError(f"pin K={strike}: (single, batched) "
                                 f"launches {single_route}, want (1, 0)")
        if not (abs(got - pin) <= PIN_TOL and abs(got_b - pin) <= PIN_TOL):
            raise AssertionError(f"pin K={strike}: {got}, {got_b} != {pin}")

    mark("main_path")
    # ---- the main path: the flagship call on the bench's 500-strike
    # ladder, then on its 5000-option book — the same ladder tiled ten
    # times (bench.py:1214)
    ladder = torch.linspace(70.0, 130.0, 500, dtype=torch.float32,
                            device=dev)
    report = None
    for batch in (500, 5000):
        strikes = ladder.repeat(batch // 500)

        def call():
            return heston_tpu_torch.price_batch(
                spec, solver, strikes, 100.0, *args, **flagship)

        reset_counts()
        out = call()
        torch.cuda.synchronize()
        single_launches, launches = launch_counts()
        book_plan_launches = fused_do.device_book_plan.launches
        counts = (book_plan_launches, single_launches, launches)
        if counts != (1, 0, 1):
            raise AssertionError(f"B={batch}: (book plan, single, batched) "
                                 f"launches {counts} in one call, want "
                                 f"(1, 0, 1)")
        if out.shape != (batch,) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"B={batch}: bad output {out.shape}")

        loop32, idx32 = inputs(strikes, "amer_div")
        loop64, idx64 = inputs(strikes.double(), "amer_div")
        plain64 = prices(fused_do.fused_do_reference(*loop64[:3],
                                                     **loop64[3])[0], idx64)
        timed = vs_f64(out, plain64, MAIN_RMSE, f"B={batch}")
        kern32 = prices(bitwise_do(*loop32[:3], **loop32[3])[0], idx32)
        plain32 = prices(fused_do.fused_do_reference(*loop32[:3],
                                                     **loop32[3])[0], idx32)
        err_kernel = float((kern32 - plain32).abs().max())
        if not err_kernel <= MAIN_KERNEL_TOL:
            raise AssertionError(f"B={batch}: kernel vs plain f32 "
                                 f"{err_kernel}")

        e2e = host_ms(call)
        prof = device_profile(call)
        plan_ms = cuda_ms(lambda: fused_do.device_book_plan(
            spec, solver, strikes, 100.0, *args, **flagship))
        host_plan = cuda_ms(lambda: inputs(strikes, "amer_div"))
        kernel = cuda_ms(lambda: fused_do.fused_do_loop(*loop32[:3],
                                                        **loop32[3]))
        plain = cuda_ms(lambda: fused_do.fused_do_reference(*loop32[:3],
                                                            **loop32[3]))
        phase("main_path", batch=batch, launches=launches,
              book_plan_launches=book_plan_launches,
              timed_build_vs_plain_f64=timed,
              kernel_vs_plain_f32_max_abs=err_kernel,
              e2e_ms=e2e, assembly_ms=plan_ms, host_plan_ms=host_plan,
              kernel_ms=kernel,
              plain_f32_ms=plain, price_mid=float(out[batch // 2]), **prof,
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
        if batch == 500:
            main_book_plan_launches = book_plan_launches
            n_ev = len(loop32[1])
            bound, bound_by, _, _ = kernel_bound(
                [solver.n_steps] * batch, [n_ev] * batch, spec.m1 + 1,
                spec.m2 + 1, n_ev, 4, True)
            report = kernel_entry("fused_do", "fused_do", launches, timed,
                                  err_kernel, kernel, plain, bound,
                                  bound_by)

    mark("placement")
    # ---- the launch plan of each kind of batched-kernel launch on the main
    # path (fused_do.launch_plan): the working fields in shared memory,
    # shared bytes and threads a block, the tangent groups G, registers and
    # resident blocks an SM (the occupancy API through the library), and
    # the device time with the default placement against every field in
    # global memory (smem_budget=0), the two alternating in this process.
    # The float32 Douglas primal at 51 x 26 keeps at least
    # PRIMAL_BLOCKS_PER_SM blocks an SM, and lm60's forward-mode launch runs
    # in one wave on more than 60 SMs
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    chain = torch.arange(70.0, 130.0, dtype=torch.float32, device=dev)

    def book_launch(strikes, sol=solver, **kw):
        fields, phases_b, _, _, _ = fused_do.book_plan(
            spec, sol, strikes, 100.0, *args, **kw)
        return fields, phases_b, None

    def jacobian_launch(sol=solver, **kw):
        tv = torch.tensor(theta, dtype=torch.float32, device=dev)
        fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
            spec, sol, chain, 100.0, tv, p.r_d, p.r_f, **kw)
        return (fields, fused_do.book_phases(sol, None, vec_s, p.r_f, False),
                tangents)

    ks_mixed, nst_mixed = mixed_book(dev, torch.float32, MIXED_PER_GROUP)
    kinds = {
        "flagship_b500": book_launch(ladder, **flagship),
        "b5000": book_launch(ladder.repeat(10), **flagship),
        "mixed5000": book_launch(ks_mixed, n_steps_per=nst_mixed,
                                 **flagship),
        "cs_b500": book_launch(ladder, dataclasses.replace(solver,
                                                           scheme="cs"),
                               **flagship),
        "lm60_prices": book_launch(chain),
        "lm60_k4": jacobian_launch(),
        "lm60_k5": jacobian_launch(v0_mode="ad"),
        "lm60_k4_damped": jacobian_launch(
            dataclasses.replace(solver, rannacher_steps=2))}
    placements = {}
    for launch_kind, (fields, phases_k, tangents) in kinds.items():
        _, _, kw0 = phases_k[0]
        b, ns, nv = fields["u"].shape
        k = len(tangents) if tangents else 0
        plan = fused_do.launch_plan(b, ns, nv, 4, kw0["scheme"],
                                    kw0["american"], k, n_sm=n_sm)
        occ = fused_do.occupancy(torch.float32, ns, nv, kw0["scheme"],
                                 kw0["american"], plan, k)
        key = "tangent_kernel_device_ms" if k else "primal_kernel_device_ms"
        times = {"default": [], "all_global": []}
        for arm in ("default", "all_global", "all_global", "default"):
            loop = (forced_do_loop(smem_budget=0) if arm == "all_global"
                    else fused_do.fused_do_loop)
            times[arm].append(device_profile(lambda: assembly.run_phases(
                loop, fields, phases_k, tangents))[key])
        blocks = b * plan.groups
        row = dict(occ, launches=len(phases_k), options=b, blocks=blocks,
                   waves=-(-blocks // (occ["blocks_per_sm"] * n_sm)),
                   device_ms={a: statistics.median(v)
                              for a, v in times.items()},
                   device_ms_runs=times)
        placements[launch_kind] = row
        phase("placement", kind=launch_kind, **row)
        if occ["smem_bytes"] != plan.smem_bytes:
            raise AssertionError(f"{launch_kind}: the kernel's shared bytes "
                                 f"{occ['smem_bytes']} != the plan's "
                                 f"{plan.smem_bytes}")
    if (placements["flagship_b500"]["blocks_per_sm"]
            < fused_do.PRIMAL_BLOCKS_PER_SM):
        raise AssertionError(f"f32 Douglas primal at 51 x 26: "
                             f"{placements['flagship_b500']['blocks_per_sm']}"
                             f" blocks an SM")
    lm = placements["lm60_k4"]
    if not (lm["waves"] == 1 and min(lm["blocks"], n_sm) > 60):
        raise AssertionError(f"lm60 forward mode: {lm['blocks']} blocks in "
                             f"{lm['waves']} waves on {n_sm} SMs")

    mark("rannacher_batched")
    # ---- Rannacher start-up on the batched route: the bench's arms rann
    # and rann_amer_div (bench.py:851-855), 64 strikes in [75, 125], f32
    # through price_batch against the f64 plain version (price_batch on
    # the CPU), and the f64 kernel against that plain version
    rann_solver = dataclasses.replace(solver, rannacher_steps=2)
    for arm, kw in (("rann", {}), ("rann_amer_div", flagship)):
        reset_counts()
        got32 = heston_tpu_torch.price_batch(spec, rann_solver, ks.float(),
                                             100.0, *args, **kw)
        torch.cuda.synchronize()
        counts = launch_counts()
        got64 = heston_tpu_torch.price_batch(spec, rann_solver, ks, 100.0,
                                             *args, **kw)
        plain64 = heston_tpu_torch.price_batch(spec, rann_solver, ks.cpu(),
                                               100.0, *args, **kw,
                                               device="cpu")
        err64 = float((got64.cpu() - plain64).abs().max())
        err32 = rmse(got32.cpu(), plain64)
        phase("rannacher_batched", arm=arm, launches=counts,
              f64_max_abs=err64, f64_tol=F64_KERNEL_TOL, f32_rmse=err32,
              f32_budget=ARM_BUDGETS[arm])
        if counts != (0, 2):
            raise AssertionError(f"{arm}: (single, batched) launches "
                                 f"{counts}, want (0, 2)")
        if not err64 <= F64_KERNEL_TOL:
            raise AssertionError(f"{arm}: f64 kernel vs plain {err64}")
        if not err32 <= ARM_BUDGETS[arm]:
            raise AssertionError(f"{arm}: f32 RMSE {err32} over budget")
    # the kernel's two launches (damp phase at 2R sub-steps, main phase)
    # on the flagship's 500 ladder, f32: times and the bound of N + R
    # steps an option
    fields, phases_r, at, _, _ = fused_do.book_plan(
        spec, rann_solver, ladder, 100.0, *args, **flagship)
    rann_ms = cuda_ms(lambda: assembly.run_phases(fused_do.fused_do_loop,
                                                  fields, phases_r))
    rann_plain_ms = cuda_ms(lambda: assembly.run_phases(
        fused_do.fused_do_reference, fields, phases_r), reps=3)
    rann_prof = device_profile(lambda: assembly.run_phases(
        fused_do.fused_do_loop, fields, phases_r))
    n_ev = sum(len(steps) for steps, _, _ in phases_r)
    bound, bound_by, _, _ = kernel_bound(
        [solver.n_steps + 2] * len(ladder), [n_ev] * len(ladder),
        spec.m1 + 1, spec.m2 + 1, n_ev, 4, True)
    phase("rannacher_batched_time", arm="rann_amer_div", batch=len(ladder),
          launches=len(phases_r), kernel_ms=rann_ms,
          kernel_device_ms=rann_prof["primal_kernel_device_ms"],
          plain_f32_ms=rann_plain_ms, bound_ms=bound, bound_by=bound_by)

    mark("single_vs_plain")
    # ---- the single-option kernel against plain at the bench's arms
    # (50 x 25 x 20, K = 100, bench.py:857-878 and the core arms), on the
    # launches fused_price_single makes (fused_single.single_plan): f64
    # surfaces and multipliers, f32 surfaces against the f32 plain
    # version, the f32 price against the f64 plain one; then one
    # price_batch call with that strike: its launches, and its f32 price
    # against the f64 plain one
    single_arms = {
        "euro": (0, {}), "amer": (0, dict(american=True)),
        "div": (0, dict(dividends=GOLDEN_DIVIDENDS)),
        "single_amer_div": (0, flagship),
        "single_rann": (2, {}), "rann_amer_div": (2, flagship)}
    for arm, (rann, kw) in single_arms.items():
        sol = dataclasses.replace(solver, rannacher_steps=rann)
        k1 = torch.tensor([100.0], device=dev)
        f64, ph64, at = fused_single.single_plan(spec, sol, k1.double(),
                                                 100.0, *args, **kw)
        f32, ph32, _ = fused_single.single_plan(spec, sol, k1, 100.0, *args,
                                                **kw)
        run = assembly.run_phases
        got64 = run(fused_single.fused_single_loop, f64, ph64)
        want64 = run(fused_single.fused_single_reference, f64, ph64)
        got32 = run(bitwise_single, f32, ph32)
        want32 = run(fused_single.fused_single_reference, f32, ph32)
        torch.cuda.synchronize()
        err64 = max(float((g - w).abs().max())
                    for g, w in zip(got64, want64))
        err_k32 = max(float((g - w).abs().max())
                      for g, w in zip(got32, want32))
        err32 = abs(float(got32[0][at]) - float(want64[0][at]))
        reset_counts()
        price = float(heston_tpu_torch.price_batch(spec, sol, k1, 100.0,
                                                   *args, **kw)[0])
        torch.cuda.synchronize()
        counts = launch_counts()
        err_entry = abs(price - float(want64[0][at]))
        budget = ARM_BUDGETS[arm]
        phase("single_vs_plain", arm=arm, phases=len(ph64),
              launches=counts, f64_max_abs=err64, f64_tol=F64_KERNEL_TOL,
              f32_kernel_vs_plain_f32_max_abs=err_k32,
              f32_tol=F32_SURFACE_TOL, f32_price_err=err32,
              f32_budget=budget, price=price, price_err=err_entry,
              price_vs_kernel=price - float(got32[0][at]))
        if counts != (len(ph64), 0):
            raise AssertionError(f"{arm}: (single, batched) launches "
                                 f"{counts}, want ({len(ph64)}, 0)")
        if not err64 <= F64_KERNEL_TOL:
            raise AssertionError(f"{arm}: f64 single kernel vs plain {err64}")
        if not err_k32 <= F32_SURFACE_TOL:
            raise AssertionError(f"{arm}: f32 single kernel vs plain "
                                 f"{err_k32}")
        if not (err32 <= budget and err_entry <= budget):
            raise AssertionError(f"{arm}: f32 price error {err32} (kernel), "
                                 f"{err_entry} (price_batch) over {budget}")

    mark("single_golden")
    # ---- the single-option latency path at the reference's golden grid
    # (bench.py:1261-1307): 100 x 75 x 20, central A2, K = 100, European;
    # the f64 scheme pin, the f32 error, and the times of the call, its
    # assembly, the kernel, its plain version and the batched kernel on
    # the same option
    gspec = GridSpec(m1=100, m2=75)
    gsolver = SolverConfig(n_steps=20, theta=0.8, maturity=1.0,
                           a2_variant="central", solver_engine="pallas")
    k64 = torch.tensor([100.0], dtype=torch.float64, device=dev)
    pin64 = float(heston_tpu_torch.price_batch(gspec, gsolver, k64, 100.0,
                                               *args)[0])
    plain64 = float(heston_tpu_torch.price_batch(
        gspec, gsolver, k64.cpu(), 100.0, *args, device="cpu")[0])

    def golden():
        return heston_tpu_torch.price_batch(gspec, gsolver, k64.float(),
                                            100.0, *args)

    reset_counts()
    out = golden()
    torch.cuda.synchronize()
    plan_launches = fused_single.device_plan.launches
    single_launches, batched_launches = launch_counts()
    err32 = abs(float(out[0]) - plain64)
    gf, gph, _ = fused_single.single_plan(gspec, gsolver, k64.float(), 100.0,
                                          *args)
    g_kern = assembly.run_phases(bitwise_single, gf, gph)
    g_plain = assembly.run_phases(fused_single.fused_single_reference,
                                      gf, gph)
    err_single = float((g_kern[0] - g_plain[0]).abs().max())
    e2e = host_ms(golden)
    prof = device_profile(golden)
    plan_ms = cuda_ms(lambda: fused_single.device_plan(
        gspec, gsolver, k64.float(), 100.0, *args))
    host_plan = cuda_ms(lambda: fused_single.single_plan(
        gspec, gsolver, k64.float(), 100.0, *args))
    single_ms = cuda_ms(lambda: assembly.run_phases(
        fused_single.fused_single_loop, gf, gph))
    single_plain_ms = cuda_ms(lambda: assembly.run_phases(
        fused_single.fused_single_reference, gf, gph), reps=5)
    b1 = assembly.assemble(gspec, gsolver, k64.float(), 100.0, *args)[0]
    b1_kw = dict(theta=gsolver.theta, delta_t=gsolver.delta_t,
                 n_steps=gsolver.n_steps, rf=p.r_f, american=False)
    batched_b1_ms = cuda_ms(lambda: fused_do.fused_do_loop(b1, [], [],
                                                           **b1_kw))
    g_plan = single_plan_row(fused_single, gf, "do")
    g_floor = chain_floor_ms(gsolver.n_steps, gspec.m2 + 1, "do", clock_mhz)
    phase("single_golden", grid="100x75x20",
          launches=(plan_launches, single_launches, batched_launches),
          plan=g_plan, chain_floor_ms=g_floor,
          f64_price=pin64, f64_pin=GOLDEN_PIN, f64_pin_err=pin64 - GOLDEN_PIN,
          f64_plain_price=plain64, f32_price=float(out[0]),
          f32_err_vs_plain_f64=err32,
          f32_kernel_vs_plain_f32_max_abs=err_single, e2e_ms=e2e,
          assembly_ms=plan_ms, host_plan_ms=host_plan, kernel_ms=single_ms,
          plain_f32_ms=single_plain_ms, batched_kernel_b1_ms=batched_b1_ms,
          a100_reference_ms=1e3 * A100_SINGLE_S, **prof,
          device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
    golden_launches = (plan_launches, single_launches, batched_launches)
    if golden_launches != (1, 1, 0):
        raise AssertionError(f"golden grid: (plan, single, batched) "
                             f"launches {golden_launches}, want (1, 1, 0)")
    if not abs(pin64 - GOLDEN_PIN) <= PIN_TOL:
        raise AssertionError(f"golden pin: {pin64} != {GOLDEN_PIN}")
    if not (bool(torch.isfinite(out).all()) and err32 <= ARM_BUDGETS["euro"]):
        raise AssertionError(f"golden grid: f32 price {float(out[0])}, "
                             f"error {err32}")
    if not err_single <= F32_SURFACE_TOL:
        raise AssertionError(f"golden grid: f32 single kernel vs plain "
                             f"{err_single}")
    bound, bound_by, _, _ = kernel_bound([gsolver.n_steps], [0], gspec.m1 + 1,
                                         gspec.m2 + 1, 0, 4, False)
    report_single = kernel_entry(
        "fused_single", "fused_single", single_launches,
        vs_f64(out, torch.tensor([plain64], dtype=torch.float64),
               ARM_BUDGETS["euro"], "golden grid"),
        err_single, single_ms, single_plain_ms, bound, bound_by,
        device_ms=single_device_ms(lambda: assembly.run_phases(
            fused_single.fused_single_loop, gf, gph), len(gph)),
        plan={k: g_plan[k] for k in ("cluster", "rows", "threads",
                                     "smem_bytes", "global_fields")})

    mark("plan_kernel")
    # ---- the quote's plan built on the card (fused_single.device_plan)
    # against the host plan, bitwise, and its times beside the host plan's
    plan_rows, report_plan = plan_kernel_rows(
        fused_single, gspec, gsolver, args, GOLDEN_DIVIDENDS, dev,
        plan_launches)
    phase("plan_kernel", grid="100x75x20", **plan_rows)

    mark("book_plan_kernel")
    # ---- a book's plan built on the card (fused_do.device_book_plan)
    # against the host plan, bitwise, at the flagship's and the book
    # cell's shapes, and its times beside the host plan's
    book_plan_rows, report_book_plan = book_plan_kernel_rows(
        fused_do, spec, solver, args, GOLDEN_DIVIDENDS, dev,
        main_book_plan_launches,
        lambda d, t: mixed_book(d, t, MIXED_PER_GROUP))
    phase("book_plan_kernel", grid="50x25x20", **book_plan_rows)

    mark("tangent_rows")
    # ---- the card Jacobian's tangent rows (fused_do.tangent_rows) against
    # their plain version on the same card plan, bitwise, at the
    # flagship's and the risk cell's shapes; the main path's risk call's
    # launches; the kernel's times and the risk call with the plain rows
    tangent_rows_rows, report_tangent_rows = tangent_rows_kernel_rows(
        fused_do, greeks, spec, solver, args, GOLDEN_DIVIDENDS, dev,
        lambda d, t: mixed_book(d, t, MIXED_PER_GROUP), tuple(
            (i * MIXED_PER_GROUP, (i + 1) * MIXED_PER_GROUP, 2 * (i + 1))
            for i in range(N_GROUPS)))
    phase("tangent_rows", grid="50x25x20", **tangent_rows_rows)

    mark("tangent_vs_plain")
    # ---- forward mode against plain, every arm: 64 strikes in [75, 125]
    # on the flagship grid; f64 surfaces, then the f32 Jacobian against
    # the f64 plain one (normalized per entry, bench.py:934)
    for arm in arms:
        loop64, extra64 = tangent_inputs(ks, arm)
        got_u, _, got_du, _ = fused_do.fused_do_loop(*loop64[:3], **loop64[3])
        want_u, _, want_du, _ = fused_do.fused_do_reference(
            *loop64[:3], **loop64[3])
        torch.cuda.synchronize()
        err64 = max(float((g - w).abs().max())
                    for g, w in zip([got_u, *got_du], [want_u, *want_du]))
        _, jac64 = fused_do._read_jacobian(spec, want_u, want_du, *extra64)
        _, jac32 = fused_do.fused_theta_jacobian(
            spec, solver, ks.float(), 100.0,
            torch.tensor(theta, dtype=torch.float32, device=dev), p.r_d,
            p.r_f, **arms[arm])
        rel = (jac32.double() - jac64) / torch.clamp(jac64.abs(), min=1.0)
        jac_rmse = float(torch.sqrt(torch.mean(rel ** 2)))
        phase("tangent_vs_plain", arm=arm, f64_max_abs=err64,
              f64_tol=F64_KERNEL_TOL, f32_jac_norm_rmse=jac_rmse,
              f32_jac_budget=JAC_RMSE)
        if not err64 <= F64_KERNEL_TOL:
            raise AssertionError(f"{arm}: f64 tangent kernel vs plain {err64}")
        if not jac_rmse <= JAC_RMSE:
            raise AssertionError(f"{arm}: f32 Jacobian RMSE {jac_rmse}")

    mark("per_lane_vs_plain")
    # ---- per-lane step counts, kernel against plain: LANE_BOOK options
    # of the 500 ladder at the bench's 10 maturities (2..20 steps), the
    # arms euro, amer_div and rann_amer_div (Rannacher and per-lane
    # together: the damp phase at 2*min(n_i, 2) sub-steps), f64 surfaces
    # and multipliers, f32 prices; then the forward-mode variant on
    # amer_div
    lane_arms = {"euro": (0, arms["euro"]), "amer_div": (0, flagship),
                 "rann_amer_div": (2, flagship)}
    for arm, (rann, kw) in lane_arms.items():
        sol = dataclasses.replace(solver, rannacher_steps=rann)
        errs, counts = {}, {}
        for dtype in (torch.float64, torch.float32):
            ks_l, nst_l = lane_book(dev, dtype)
            fields, phases_l, at, _, _ = fused_do.book_plan(
                spec, sol, ks_l, 100.0, *args, n_steps_per=nst_l, **kw)
            reset_counts()
            got = assembly.run_phases(bitwise_do, fields, phases_l)
            torch.cuda.synchronize()
            counts[str(dtype)] = launch_counts()[1]
            want = assembly.run_phases(fused_do.fused_do_reference, fields,
                                       phases_l)
            if dtype == torch.float64:
                errs[dtype] = max(float((g - w).abs().max())
                                  for g, w in zip(got, want))
            else:
                errs[dtype] = float((prices(got[0], at)
                                     - prices(want[0], at)).abs().max())
        phase("per_lane_vs_plain", arm=arm, options=LANE_BOOK,
              phases=len(phases_l), launches=counts,
              f64_max_abs=errs[torch.float64],
              f64_exact=errs[torch.float64] == 0.0, f64_tol=F64_KERNEL_TOL,
              f32_price_max_abs=errs[torch.float32],
              f32_tol=MAIN_KERNEL_TOL)
        if set(counts.values()) != {len(phases_l)}:
            raise AssertionError(f"{arm}: per-lane launches {counts}, want "
                                 f"{len(phases_l)} each")
        if not errs[torch.float64] <= F64_KERNEL_TOL:
            raise AssertionError(f"{arm}: per-lane f64 kernel vs plain "
                                 f"{errs[torch.float64]}")
        if not errs[torch.float32] <= MAIN_KERNEL_TOL:
            raise AssertionError(f"{arm}: per-lane f32 kernel vs plain "
                                 f"{errs[torch.float32]}")
    tan_errs = {}
    for dtype, tol in ((torch.float64, F64_KERNEL_TOL),
                       (torch.float32, TANGENT_KERNEL_TOL)):
        ks_l, nst_l = lane_book(dev, dtype)
        loop_l, _ = tangent_inputs(ks_l, "amer_div", nst=nst_l)
        got_u, _, got_du, _ = bitwise_do(*loop_l[:3], **loop_l[3])
        want_u, _, want_du, _ = fused_do.fused_do_reference(
            *loop_l[:3], **loop_l[3])
        tan_errs[str(dtype)] = max(
            float((g - w).abs().max())
            for g, w in zip([got_u, *got_du], [want_u, *want_du]))
        if not tan_errs[str(dtype)] <= tol:
            raise AssertionError(f"per-lane forward mode, {dtype}: kernel "
                                 f"vs plain {tan_errs[str(dtype)]}")
    phase("per_lane_vs_plain", arm="amer_div_forward_mode",
          options=LANE_BOOK, max_abs=tan_errs,
          f64_exact=tan_errs[str(torch.float64)] == 0.0,
          tol={"f64": F64_KERNEL_TOL, "f32": TANGENT_KERNEL_TOL})

    mark("mixed_vs_groups")
    # ---- the one-launch mixed book against one launch per maturity
    # group, the mixed5000 book, f64 and f32 (ROADMAP C2). "exact_dt":
    # each group's own n-step launch at the shared dt (its fields at n
    # steps, its events up to step n), which isolates the freeze and the
    # identity events; "group_solver": each group through the entry point
    # with calibrate_device's per-group solver (maturity * n / N), whose
    # dt can differ from the shared one by an ulp
    def group_launch(strikes, n, kw):
        fields, vec_s, idx_s, idx_v, _ = assembly.assemble(
            spec, solver, strikes, 100.0, *args,
            nsteps=torch.full(strikes.shape, n, device=dev))
        events = [e for e in assembly.dividend_plan(solver, kw["dividends"])
                  if e[0] <= n]
        u, _ = fused_do.fused_do_loop(
            fields, [e[0] for e in events],
            assembly.build_remap_fields(vec_s, events), theta=solver.theta,
            delta_t=solver.delta_t, n_steps=n, rf=p.r_f,
            american=kw["american"])
        return fused_do._extract(u, idx_s, idx_v)

    for arm, kw in (("euro", arms["euro"]), ("amer_div", flagship)):
        diffs = {}
        for dtype in (torch.float64, torch.float32):
            ks_m, nst_m = mixed_book(dev, dtype, MIXED_PER_GROUP)
            one = fused_do.fused_price_batch(spec, solver, ks_m, 100.0, *args,
                                             n_steps_per=nst_m, **kw)
            exact, entry, other_dt = [], [], []
            for i in range(N_GROUPS):
                n = 2 * (i + 1)
                sl = slice(i * MIXED_PER_GROUP, (i + 1) * MIXED_PER_GROUP)
                exact.append(group_launch(ks_m[sl], n, kw))
                sol_g = calibration._group_solver(solver, n)
                if sol_g.delta_t != solver.delta_t:
                    other_dt.append(n)
                entry.append(fused_do.fused_price_batch(
                    spec, sol_g, ks_m[sl], 100.0, *args, **kw))
            exact, entry = torch.cat(exact), torch.cat(entry)
            diffs[str(dtype)] = dict(
                exact_dt_max_abs=float((one - exact).abs().max()),
                exact_dt_max_rel=max_rel(one, exact),
                group_solver_max_abs=float((one - entry).abs().max()),
                group_solver_other_dt_groups=other_dt)
        phase("mixed_vs_groups", arm=arm, options=N_GROUPS * MIXED_PER_GROUP,
              diffs=diffs, f64_rel_tol=MIXED_REL_TOL)
        if not diffs[str(torch.float64)]["exact_dt_max_rel"] <= MIXED_REL_TOL:
            raise AssertionError(f"{arm}: one launch vs per-group launches "
                                 f"{diffs}")

    mark("mixed5000")
    # ---- mixed5000 (bench.py:1195-1237): 5000 options in one launch,
    # f32, against the f64 plain version; the wrapper and device times,
    # the kernel against its plain version, and the bound from the
    # per-lane step sum
    report_lane = None
    for arm, kw in (("euro", arms["euro"]), ("amer_div", flagship)):
        ks_m, nst_m = mixed_book(dev, torch.float32, MIXED_PER_GROUP)

        def mixed():
            return fused_do.fused_price_batch(spec, solver, ks_m, 100.0,
                                              *args, n_steps_per=nst_m, **kw)

        reset_counts()
        out = mixed()
        torch.cuda.synchronize()
        counts = launch_counts()
        ks64, _ = mixed_book(dev, torch.float64, MIXED_PER_GROUP)
        f64, ph64, at64, _, _ = fused_do.book_plan(
            spec, solver, ks64, 100.0, *args, n_steps_per=nst_m, **kw)
        timed = vs_f64(out, prices(assembly.run_phases(
            fused_do.fused_do_reference, f64, ph64)[0], at64),
            MIXED_RMSE[arm], f"mixed5000 {arm}")
        fields, phases_m, at, _, _ = fused_do.book_plan(
            spec, solver, ks_m, 100.0, *args, n_steps_per=nst_m, **kw)
        got = assembly.run_phases(bitwise_do, fields, phases_m)
        want = assembly.run_phases(fused_do.fused_do_reference, fields,
                                   phases_m)
        err_k = float((prices(got[0], at) - prices(want[0], at)).abs().max())
        e2e = host_ms(mixed)
        prof = device_profile(mixed)
        kernel = cuda_ms(lambda: assembly.run_phases(
            fused_do.fused_do_loop, fields, phases_m))
        plain = cuda_ms(lambda: assembly.run_phases(
            fused_do.fused_do_reference, fields, phases_m), reps=3)
        steps_m = phases_m[0][0]
        nst_list = nst_m.tolist()
        bound, bound_by, flops, nbytes = kernel_bound(
            nst_list, lane_events(steps_m, nst_list), spec.m1 + 1,
            spec.m2 + 1, len(steps_m), 4, kw["american"], per_lane=True)
        phase("mixed5000", arm=arm, launches=counts,
              timed_build_vs_plain_f64=timed,
              kernel_vs_plain_f32_max_abs=err_k,
              e2e_ms=e2e, kernel_ms=kernel, plain_f32_ms=plain,
              lane_steps=sum(nst_list), bound_ms=bound, bound_by=bound_by,
              bound_gflop=flops / 1e9, bound_mb=nbytes / 1e6, **prof,
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
        if counts != (0, 1):
            raise AssertionError(f"mixed5000 {arm}: (single, batched) "
                                 f"launches {counts}, want (0, 1)")
        if not err_k <= MAIN_KERNEL_TOL:
            raise AssertionError(f"mixed5000 {arm}: f32 kernel vs plain "
                                 f"{err_k}")
        if arm == "amer_div":
            report_lane = kernel_entry("fused_do_per_lane", "fused_do",
                                       counts[1], timed, err_k, kernel,
                                       plain, bound, bound_by)

    mark("book_risk")
    # ---- book risk (bench.py:1108-1151): batch_greeks on the 500 ladder,
    # American with the golden dividends, uniform and in the bench's 10
    # maturities; one primal launch a call, every column of the f64
    # kernel against the f64 plain version on the same inputs (and, for
    # information, against batch_greeks on the CPU: another assembly, so
    # ulps apart in the grids), the f32 price RMSE and the normalized
    # RMSE of the other f32 columns against f64
    per = 500 // N_GROUPS
    risk_do_norm = {}
    risk_books = {"book_risk500": (), "book_risk500_multi10": tuple(
        (i * per, (i + 1) * per, 2 * (i + 1)) for i in range(N_GROUPS))}
    for case, group_steps in risk_books.items():
        ks_r = torch.linspace(70.0, 130.0, 500, dtype=torch.float32,
                              device=dev)

        def risk(strikes=ks_r, **extra):
            return heston_tpu_torch.batch_greeks(
                spec, solver, strikes, 100.0, *args, **flagship,
                group_steps=group_steps, **extra)

        reset_counts()
        out32 = risk()
        torch.cuda.synchronize()
        counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
        ks64 = ks_r.double()
        out64 = risk(ks64)
        nst_r = calibration.lane_steps(group_steps)
        fields, phases_r, at, ops, vec_s = fused_do.book_plan(
            spec, solver, ks64, 100.0, *args, **flagship,
            n_steps_per=nst_r, epilogue=True)
        u, lam = assembly.run_phases(fused_do.fused_do_reference, fields,
                                     phases_r)
        plain64 = greeks.risk_epilogue(spec, solver, ks64, p.v0, p.r_d,
                                       p.r_f, (u, lam, ops, vec_s, *at),
                                       nst=nst_r)
        cpu64 = risk(ks64.cpu(), device="cpu")
        col_err = {k: max_rel(out64[k], plain64[k])
                   for k in heston_tpu_torch.RISK_KEYS}
        cpu_err = {k: max_rel(out64[k], cpu64[k])
                   for k in heston_tpu_torch.RISK_KEYS}
        price_rmse = rmse(out32["price"], out64["price"])
        f32_norm = {k: norm_rmse(out32[k], out64[k])
                    for k in heston_tpu_torch.RISK_KEYS}
        risk_do_norm.setdefault(case, f32_norm)
        e2e = host_ms(risk)
        prof = device_profile(risk)
        phase("book_risk", case=case, launches=counts,
              f64_kernel_vs_plain_rel=col_err, f64_rel_tol=RISK_REL_TOL,
              f64_card_vs_cpu_rel=cpu_err,
              f32_price_rmse=price_rmse, f32_price_budget=MAIN_RMSE,
              f32_norm_rmse=f32_norm, e2e_ms=e2e, **prof,
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
        if counts != (0, 1, 0):
            raise AssertionError(f"{case}: (single, primal, tangent) "
                                 f"launches {counts}, want (0, 1, 0)")
        if not all(bool(torch.isfinite(x).all()) for x in out32.values()):
            raise AssertionError(f"{case}: non-finite risk")
        if not max(col_err.values()) <= RISK_REL_TOL:
            raise AssertionError(f"{case}: f64 kernel vs plain {col_err}")
        if not price_rmse <= MAIN_RMSE:
            raise AssertionError(f"{case}: f32 price RMSE {price_rmse}")

    mark("calibration")
    # ---- calibration, lm60 (bench.py:974-1009): 60 European calls,
    # K = 70..129, T = 1, a flat-vol-0.2 market, 50 x 25 x 20, float32
    init = [1.2, 0.05, 0.4, -0.5, 0.05]
    lm_cfg = CalibrationConfig(max_iter=15, tol=0.1, jacobian_mode="ad")

    def lm60(dtype):
        strikes = torch.arange(70.0, 130.0, dtype=dtype, device=dev)
        market = bs.generate_market_data(100.0, 1.0, p.r_d, strikes)

        def run():
            return heston_tpu_torch.calibrate_device(
                spec, solver, strikes, market, 100.0,
                torch.tensor(init, dtype=dtype), p.r_d, p.r_f, cfg=lm_cfg)
        return strikes, market, run

    strikes60, market60, run60 = lm60(torch.float32)
    reset_counts()
    tv32, info32 = run60()
    torch.cuda.synchronize()
    iters = info32["iterations"]
    cal_launches = (fused_do.fused_do_loop.tangent_launches,
                    fused_do.fused_do_loop.launches)
    if cal_launches != (iters, iters):
        raise AssertionError(f"lm60: (tangent, primal) launches "
                             f"{cal_launches} in {iters} iterations, want "
                             f"one of each per iteration")
    _, _, run64 = lm60(torch.float64)
    tv64, info64 = run64()
    sse32 = float(info32["final_error"])
    sse64 = float(info64["final_error"])
    finite = all(bool(torch.isfinite(x).all()) for x in (
        tv32, info32["fitted_prices"], info32["final_error"], tv64,
        info64["final_error"]))
    rmse_iv = iv_rmse(info32["fitted_prices"], market60, strikes60, p.r_d,
                      [(0, 60, 1.0)])
    wall = host_ms(run60, reps=CAL_REPS)
    prof60 = device_profile(run60)
    # one Jacobian pass at the lm60 shape: the linearized assembly and
    # the forward-mode kernel (wrapper included), CUDA events
    tv60 = torch.tensor(init, dtype=torch.float32, device=dev)
    jac_ms = cuda_ms(lambda: fused_do.fused_theta_jacobian(
        spec, solver, strikes60, 100.0, tv60, p.r_d, p.r_f))
    lin_ms = cuda_ms(lambda: fused_do._linearized_assemble(
        spec, solver, strikes60, 100.0, tv60, p.r_d, p.r_f))
    loop60, _ = tangent_inputs(strikes60, "euro")
    tan_ms = cuda_ms(lambda: fused_do.fused_do_loop(*loop60[:3],
                                                    **loop60[3]))
    got_u, _, got_du, _ = bitwise_do(*loop60[:3], **loop60[3])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        *loop60[:3], **loop60[3])
    stop.record()
    stop.synchronize()
    tan_plain_ms = start.elapsed_time(stop)     # one run: see the docstring
    err_tan = max(float((g - w).abs().max())
                  for g, w in zip([got_u, *got_du], [want_u, *want_du]))
    phase("calibration", case="lm60", dtype="float32", iterations=iters,
          converged=bool(info32["converged"]), final_sse=sse32,
          final_sse_f64=sse64, iterations_f64=info64["iterations"],
          params=tv32.tolist(), params_f64=tv64.tolist(),
          iv_rmse=rmse_iv, iv_rmse_bp=1e4 * rmse_iv,
          tangent_launches=cal_launches[0], primal_launches=cal_launches[1],
          wall_ms=wall, jacobian_pass_ms=jac_ms,
          linearized_assembly_ms=lin_ms, tangent_kernel_ms=tan_ms,
          tangent_plain_f32_ms=tan_plain_ms,
          tangent_kernel_vs_plain_f32_max_abs=err_tan, **prof60,
          device_idle_share=1.0 - prof60["device_busy_ms"] / wall,
          tpu_record_jax_round5=TPU_RECORDS["lm60"])
    # calibrate_device's lm60 fit, printed again beside `calibrate`'s
    lm60_device = dict(iterations=iters, final_sse=sse32, wall_ms=wall,
                       iv_rmse_bp=1e4 * rmse_iv)
    if not finite:
        raise AssertionError("lm60: non-finite output")
    if not abs(sse32 - sse64) <= SSE_REL * sse64:
        raise AssertionError(f"lm60: f32 SSE {sse32} vs f64 {sse64}")
    if not err_tan <= TANGENT_KERNEL_TOL:
        raise AssertionError(f"lm60: f32 tangent kernel vs plain {err_tan}")
    bound, bound_by, _, _ = kernel_bound(
        [solver.n_steps] * 60, [0] * 60, spec.m1 + 1, spec.m2 + 1, 0, 4,
        False, n_tangents=fused_do.JAC_TANGENTS)
    report_tangent = kernel_entry(
        "fused_do_tangent", "fused_do", cal_launches[0],
        jac_vs_f64(chain_plan(strikes60, solver), JAC_RMSE,
                   "lm60 forward mode"),
        err_tan, tan_ms, tan_plain_ms, bound, bound_by)

    mark("calibration_ladder")
    # ---- calibration ladders (bench.py:1012-1105): 10 maturities x 20
    # strikes, the whole ladder in one launch per pass (per-lane step
    # counts), float32
    mats = LADDER_MATS
    ladder, ladder_market, groups = lm_multi200(dev, torch.float32)
    ladder_nst = torch.cat([torch.full((b - a,), n, device=dev)
                            for a, b, n in groups])

    def ladder_vs_plain(arm, lanes=slice(None)):
        """Both kernels against their f32 plain versions on the inputs of
        the first Jacobian pass and trial pricing: the ladder's options
        (`lanes` of them) in one launch at the ladder's largest count,
        each at its group's count. lanes=slice(0, 100) is a slice with
        every lane short of the launch's count, as a rank's slice of a
        mixed book under price_batch_sharded. Max abs of (primal prices,
        forward-mode surfaces)."""
        sol = calibration._group_solver(solver, max(n for *_, n in groups))
        loop_l, extra = tangent_inputs(ladder[lanes], arm, sol, params=init,
                                       nst=ladder_nst[lanes])
        primal_kw = {k: v for k, v in loop_l[3].items() if k != "tangents"}
        got_p = prices(bitwise_do(*loop_l[:3], **primal_kw)[0], extra[1:3])
        want_p = prices(fused_do.fused_do_reference(*loop_l[:3],
                                                    **primal_kw)[0],
                        extra[1:3])
        got_u, _, got_du, _ = bitwise_do(*loop_l[:3], **loop_l[3])
        want_u, _, want_du, _ = fused_do.fused_do_reference(
            *loop_l[:3], **loop_l[3])
        return (float((got_p - want_p).abs().max()),
                max(float((g - w).abs().max())
                    for g, w in zip([got_u, *got_du], [want_u, *want_du])))

    for case, arm, kw in (("lm_multi200", "euro", {}),
                          ("lm_multi200_amer_div", "amer_div",
                           dict(american=True,
                                dividends=GOLDEN_DIVIDENDS))):
        reset_counts()
        t0 = time.perf_counter()
        tv_l, info_l = heston_tpu_torch.calibrate_device(
            spec, solver, ladder, ladder_market, 100.0,
            torch.tensor(init), p.r_d, p.r_f, cfg=lm_cfg,
            group_steps=groups, **kw)
        torch.cuda.synchronize()
        wall_l = 1e3 * (time.perf_counter() - t0)
        it_l = info_l["iterations"]
        per_pass = (fused_do.fused_do_loop.tangent_launches / it_l,
                    fused_do.fused_do_loop.launches / it_l)
        rmse_l = (iv_rmse(info_l["fitted_prices"], ladder_market, ladder,
                          p.r_d, [(a, b, t) for (a, b, _), t
                                  in zip(groups, mats)])
                  if not kw else None)
        err_p, err_t = ladder_vs_plain(arm)
        err_sp, err_st = ladder_vs_plain(arm, slice(0, 100))
        phase("calibration_ladder", case=case, dtype="float32",
              iterations=it_l, converged=bool(info_l["converged"]),
              final_sse=float(info_l["final_error"]), params=tv_l.tolist(),
              iv_rmse=rmse_l,
              iv_rmse_bp=None if rmse_l is None else 1e4 * rmse_l,
              wall_ms_one_run=wall_l,
              tangent_launches_per_pass=per_pass[0],
              primal_launches_per_trial=per_pass[1],
              kernel_vs_plain_f32_max_abs=err_p,
              tangent_kernel_vs_plain_f32_max_abs=err_t,
              short_slice_kernel_vs_plain_f32_max_abs=err_sp,
              short_slice_tangent_kernel_vs_plain_f32_max_abs=err_st,
              per_group_fit_pr2=PER_GROUP_FIT.get(case),
              tpu_record_jax_round5=TPU_RECORDS.get(case))
        if not (bool(torch.isfinite(tv_l).all())
                and bool(torch.isfinite(info_l["final_error"]))):
            raise AssertionError(f"{case}: non-finite output")
        if per_pass != (1.0, 1.0):
            raise AssertionError(f"{case}: (tangent, primal) launches per "
                                 f"iteration {per_pass}, want one each")
        if not max(err_p, err_sp) <= MAIN_KERNEL_TOL:
            raise AssertionError(f"{case}: f32 kernel vs plain {err_p}, "
                                 f"short-only slice {err_sp}")
        if not max(err_t, err_st) <= TANGENT_KERNEL_TOL:
            raise AssertionError(f"{case}: f32 tangent kernel vs plain "
                                 f"{err_t}, short-only slice {err_st}")

    mark("scheme_kernel_vs_plain")
    # ---- the corrector schemes: kernel 1 against its plain version on
    # the bench's arms (64 strikes in [75, 125], 50 x 25 x 20), euro and
    # amer_div: f64 surfaces and multipliers, the f32 prices' RMSE against
    # the f64 plain version (gated on euro at the bench's budgets,
    # printed on amer_div, ROADMAP C3), and the distance to Douglas's
    for scheme in CORRECTORS:
        for arm in ("euro", "amer_div"):
            loop64, idx64 = inputs(ks, arm, scheme)
            got64 = fused_do.fused_do_loop(*loop64[:3], **loop64[3])
            want64 = fused_do.fused_do_reference(*loop64[:3], **loop64[3])
            torch.cuda.synchronize()
            err64 = max(float((g - w).abs().max())
                        for g, w in zip(got64, want64))
            loop32, idx32 = inputs(ks.float(), arm, scheme)
            p32 = prices(fused_do.fused_do_loop(*loop32[:3],
                                                **loop32[3])[0], idx32)
            err32 = rmse(p32, prices(want64[0], idx64))
            do64 = fused_do.fused_do_loop(*loop64[:3],
                                          **dict(loop64[3], scheme="do"))[0]
            vs_do = float((prices(got64[0], idx64)
                           - prices(do64, idx64)).abs().max())
            budget = SCHEME_BUDGETS[scheme] if arm == "euro" else None
            phase("scheme_kernel_vs_plain", scheme=scheme, arm=arm,
                  f64_max_abs=err64, f64_tol=F64_KERNEL_TOL, f32_rmse=err32,
                  f32_budget=budget, price_max_abs_vs_do=vs_do)
            if not err64 <= F64_KERNEL_TOL:
                raise AssertionError(f"{scheme} {arm}: f64 kernel vs plain "
                                     f"{err64}")
            if not (bool(torch.isfinite(p32).all())
                    and (budget is None or err32 <= budget)):
                raise AssertionError(f"{scheme} {arm}: f32 RMSE {err32}")
            if not vs_do > 1e-6:
                raise AssertionError(f"{scheme} {arm}: prices equal to "
                                     f"Douglas's ({vs_do})")

    mark("scheme_tangent_vs_plain")
    # ---- the corrector schemes, kernel 1's forward mode against its
    # plain version (64 strikes, the flagship grid): f64 surfaces, and
    # the f32 Jacobian's normalized RMSE against the f64 plain one (gated
    # on the bench's jac_cs arm, cs euro; printed for the others)
    for scheme in CORRECTORS:
        sol_s = dataclasses.replace(solver, scheme=scheme)
        for arm in ("euro", "amer_div"):
            loop64, extra64 = tangent_inputs(ks, arm, sol=sol_s)
            got_u, _, got_du, _ = fused_do.fused_do_loop(
                *loop64[:3], **loop64[3])
            want_u, _, want_du, _ = fused_do.fused_do_reference(
                *loop64[:3], **loop64[3])
            torch.cuda.synchronize()
            err64 = max(float((g - w).abs().max())
                        for g, w in zip([got_u, *got_du], [want_u, *want_du]))
            _, jac64 = fused_do._read_jacobian(spec, want_u, want_du,
                                               *extra64)
            _, jac32 = fused_do.fused_theta_jacobian(
                spec, sol_s, ks.float(), 100.0,
                torch.tensor(theta, dtype=torch.float32, device=dev), p.r_d,
                p.r_f, **arms[arm])
            jac_rmse = norm_rmse(jac32, jac64)
            budget = JAC_CS_RMSE if (scheme, arm) == ("cs", "euro") else None
            phase("scheme_tangent_vs_plain", scheme=scheme, arm=arm,
                  f64_max_abs=err64, f64_tol=F64_KERNEL_TOL,
                  f32_jac_norm_rmse=jac_rmse, f32_jac_budget=budget)
            if not err64 <= F64_KERNEL_TOL:
                raise AssertionError(f"{scheme} {arm}: f64 tangent kernel vs "
                                     f"plain {err64}")
            if not (bool(torch.isfinite(jac32).all())
                    and (budget is None or jac_rmse <= budget)):
                raise AssertionError(f"{scheme} {arm}: f32 Jacobian RMSE "
                                     f"{jac_rmse}")

    mark("scheme_single")
    # ---- the corrector schemes on kernel 2: f64 against plain at K = 100
    # (euro, amer_div), one price_batch call with one strike (its
    # launches), the golden-grid convergence (100 x 75 x 50, central A2:
    # within 2e-2 of the converged price in f64; f32 printed), and
    # Rannacher + scheme on both routes (a Douglas damp launch, then the
    # scheme's) in f64 against price_batch on the CPU; then the kernel's
    # times at the golden grid 101 x 76 x 20
    k1 = torch.tensor([100.0], dtype=torch.float64, device=dev)
    conv_spec = GridSpec(m1=100, m2=75)
    reports_single = []
    for scheme in CORRECTORS:
        sol_s = dataclasses.replace(solver, scheme=scheme)
        errs = {}
        for arm, kw in (("euro", {}), ("amer_div", flagship)):
            sf, ph, _ = fused_single.single_plan(spec, sol_s, k1, 100.0,
                                                 *args, **kw)
            got = assembly.run_phases(fused_single.fused_single_loop,
                                          sf, ph)
            want = assembly.run_phases(
                fused_single.fused_single_reference, sf, ph)
            errs[arm] = max(float((g - w).abs().max())
                            for g, w in zip(got, want))
        reset_counts()
        heston_tpu_torch.price_batch(spec, sol_s, k1, 100.0, *args,
                                     **flagship)
        torch.cuda.synchronize()
        counts = launch_counts()
        conv_sol = SolverConfig(n_steps=50, theta=0.8, maturity=1.0,
                                a2_variant="central", solver_engine="pallas",
                                scheme=scheme)
        conv64, conv32 = (float(heston_tpu_torch.price_batch(
            conv_spec, conv_sol, k1.to(dtype), 100.0, *args)[0])
            for dtype in (torch.float64, torch.float32))
        rann_sol = dataclasses.replace(sol_s, rannacher_steps=2)
        rann = {}
        for route, strikes in (("single", k1), ("batched", ks)):
            reset_counts()
            got = heston_tpu_torch.price_batch(spec, rann_sol, strikes,
                                               100.0, *args, **flagship)
            torch.cuda.synchronize()
            want = heston_tpu_torch.price_batch(
                spec, rann_sol, strikes.cpu(), 100.0, *args, **flagship,
                device="cpu")
            rann[route] = dict(launches=launch_counts(), f64_max_abs=float(
                (got.cpu() - want).abs().max()))
        phase("scheme_single", scheme=scheme, f64_max_abs=errs,
              f64_tol=F64_KERNEL_TOL, launches=counts,
              golden_100x75x50_f64=conv64, golden_100x75x50_f32=conv32,
              golden_converged=GOLDEN_CONVERGED,
              golden_f64_err=conv64 - GOLDEN_CONVERGED,
              golden_tol=GOLDEN_CONV_TOL, rannacher=rann)
        if counts != (1, 0):
            raise AssertionError(f"{scheme}: (single, batched) launches "
                                 f"{counts}, want (1, 0)")
        if not max(errs.values()) <= F64_KERNEL_TOL:
            raise AssertionError(f"{scheme}: f64 single kernel vs plain "
                                 f"{errs}")
        if not abs(conv64 - GOLDEN_CONVERGED) < GOLDEN_CONV_TOL:
            raise AssertionError(f"{scheme}: golden-grid price {conv64}")
        if ([r["launches"] for r in rann.values()] != [(2, 0), (0, 2)]
                or not max(r["f64_max_abs"] for r in rann.values())
                <= F64_KERNEL_TOL):
            raise AssertionError(f"{scheme}: Rannacher + scheme {rann}")

        # kernel 2's launch and times at the golden grid, f32
        g_sol = dataclasses.replace(gsolver, scheme=scheme)
        reset_counts()
        out = heston_tpu_torch.price_batch(gspec, g_sol, k64.float(), 100.0,
                                           *args)
        torch.cuda.synchronize()
        g_counts = launch_counts()
        gf, gph, _ = fused_single.single_plan(gspec, g_sol, k64.float(),
                                              100.0, *args)
        g_kern = assembly.run_phases(bitwise_single, gf, gph)
        g_plain = assembly.run_phases(
            fused_single.fused_single_reference, gf, gph)
        err_g = float((g_kern[0] - g_plain[0]).abs().max())
        gf64, gph64, g_at = fused_single.single_plan(gspec, g_sol, k64,
                                                     100.0, *args)
        g_timed = vs_f64(out, assembly.run_phases(
            fused_single.fused_single_reference, gf64, gph64)[0][g_at]
            .reshape(1), SCHEME_BUDGETS[scheme], f"{scheme} golden grid")
        g_ms = cuda_ms(lambda: assembly.run_phases(
            fused_single.fused_single_loop, gf, gph))
        g_plain_ms = cuda_ms(lambda: assembly.run_phases(
            fused_single.fused_single_reference, gf, gph), reps=3)
        g_prof = device_profile(lambda: assembly.run_phases(
            fused_single.fused_single_loop, gf, gph))
        bound, bound_by, _, _ = kernel_bound(
            [gsolver.n_steps], [0], gspec.m1 + 1, gspec.m2 + 1, 0, 4, False,
            scheme=scheme)
        s_plan = single_plan_row(fused_single, gf, scheme)
        s_floor = chain_floor_ms(gsolver.n_steps, gspec.m2 + 1, scheme,
                                 clock_mhz)
        phase("scheme_single_golden", scheme=scheme, grid="100x75x20",
              plan=s_plan, chain_floor_ms=s_floor,
              launches=g_counts, f32_price=float(out[0]),
              timed_build_vs_plain_f64=g_timed,
              f32_kernel_vs_plain_f32_max_abs=err_g, kernel_ms=g_ms,
              plain_f32_ms=g_plain_ms, bound_ms=bound, bound_by=bound_by,
              **g_prof)
        if g_counts != (1, 0) or not err_g <= F32_SURFACE_TOL:
            raise AssertionError(f"{scheme} golden grid: launches "
                                 f"{g_counts}, f32 kernel vs plain {err_g}")
        reports_single.append(kernel_entry(
            f"fused_single_{scheme}", "fused_single", g_counts[0], g_timed,
            err_g, g_ms, g_plain_ms, bound, bound_by,
            device_ms=single_device_ms(lambda: assembly.run_phases(
                fused_single.fused_single_loop, gf, gph), len(gph)),
            plan={k: s_plan[k] for k in ("cluster", "rows", "threads",
                                         "smem_bytes", "global_fields")}))

    mark("single_placement")
    # ---- kernel 2's launch plan at the golden grid (fused_single.
    # launch_plan; 101 x 76 x 20, central A2, K = 100, European), each
    # scheme: the cluster, rows and threads a block, the fields in shared
    # memory, shared bytes, registers and clusters at once from the
    # occupancy API, in float32 and float64; and the float32 device time
    # (single_device_ms) under the default plan against one block with
    # the PCR factors in global memory, alternating in this process. Every
    # field of the golden grid is in shared memory by default, in both
    # types
    for scheme in ("do", *CORRECTORS):
        g_sol = dataclasses.replace(gsolver, scheme=scheme)
        rows = {}
        for dtype in (torch.float32, torch.float64):
            gf, gph, _ = fused_single.single_plan(
                gspec, g_sol, k64.to(dtype), 100.0, *args)
            rows[str(dtype).split(".")[-1]] = single_plan_row(
                fused_single, gf, scheme)
        gf, gph, _ = fused_single.single_plan(gspec, g_sol, k64.float(),
                                              100.0, *args)
        one = fused_single.launch_plan(gspec.m1 + 1, gspec.m2 + 1, 4, scheme,
                                       cluster=1, factors=False)
        one_row = single_plan_row(fused_single, gf, scheme, one)
        times = {"default": [], "one_block_global_factors": []}
        for arm in ("default", "one_block_global_factors",
                    "one_block_global_factors", "default"):
            loop = (fused_single.fused_single_loop if arm == "default"
                    else forced_single_loop(cluster=1, factors=False))
            times[arm].append(single_device_ms(
                lambda: assembly.run_phases(loop, gf, gph), len(gph)))
        phase("single_placement", scheme=scheme, grid="100x75x20",
              plan=rows, one_block_global_factors=one_row,
              device_ms={a: statistics.median(x for x in v if x is not None)
                         if any(x is not None for x in v) else None
                         for a, v in times.items()},
              device_ms_runs=times,
              chain_floor_ms=chain_floor_ms(gsolver.n_steps, gspec.m2 + 1,
                                            scheme, clock_mhz))
        for name, row in rows.items():
            if row["global_fields"]:
                raise AssertionError(f"fused_single {scheme} {name} at the "
                                     f"golden grid: {row['global_fields']} "
                                     f"fields in global memory")

    mark("scheme_batch_time")
    # ---- the flagship book per scheme (bench.py:1154-1194's
    # _scheme_timings): 500 American calls with the golden dividends,
    # f32, through price_batch; Douglas timed beside them in this call
    book = torch.linspace(70.0, 130.0, 500, dtype=torch.float32, device=dev)
    reports_batch = []
    for scheme in ("do", *CORRECTORS):
        sol_s = dataclasses.replace(solver, scheme=scheme)

        def call(sol_s=sol_s):
            return heston_tpu_torch.price_batch(spec, sol_s, book, 100.0,
                                                *args, **flagship)

        reset_counts()
        out = call()
        torch.cuda.synchronize()
        counts = launch_counts()
        fields, phases_s, at, _, _ = fused_do.book_plan(
            spec, sol_s, book, 100.0, *args, **flagship)
        kern32 = prices(assembly.run_phases(bitwise_do, fields, phases_s)[0],
                        at)
        plain32 = prices(assembly.run_phases(fused_do.fused_do_reference,
                                             fields, phases_s)[0], at)
        err_k = float((kern32 - plain32).abs().max())
        f64, ph64, at64, _, _ = fused_do.book_plan(
            spec, sol_s, book.double(), 100.0, *args, **flagship)
        timed = vs_f64(out, prices(assembly.run_phases(
            fused_do.fused_do_reference, f64, ph64)[0], at64), MAIN_RMSE,
            f"{scheme} book")
        e2e = host_ms(call)
        prof = device_profile(call)
        plan_ms = cuda_ms(lambda sol_s=sol_s: fused_do.device_book_plan(
            spec, sol_s, book, 100.0, *args, **flagship))
        host_plan = cuda_ms(lambda sol_s=sol_s: fused_do.book_plan(
            spec, sol_s, book, 100.0, *args, **flagship))
        kernel = cuda_ms(lambda: assembly.run_phases(
            fused_do.fused_do_loop, fields, phases_s))
        plain = cuda_ms(lambda: assembly.run_phases(
            fused_do.fused_do_reference, fields, phases_s), reps=3)
        n_ev = len(phases_s[0][0])
        bound, bound_by, flops, _ = kernel_bound(
            [solver.n_steps] * len(book), [n_ev] * len(book), spec.m1 + 1,
            spec.m2 + 1, n_ev, 4, True, scheme=scheme)
        phase("scheme_batch_time", scheme=scheme, arm="amer_div",
              batch=len(book), launches=counts,
              timed_build_vs_plain_f64=timed,
              kernel_vs_plain_f32_max_abs=err_k, e2e_ms=e2e,
              assembly_ms=plan_ms, host_plan_ms=host_plan,
              kernel_ms=kernel, plain_f32_ms=plain,
              bound_ms=bound, bound_by=bound_by, bound_gflop=flops / 1e9,
              price_mid=float(out[len(book) // 2]), **prof,
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
        if counts != (0, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{scheme} book: launches {counts}")
        if not err_k <= MAIN_KERNEL_TOL:
            raise AssertionError(f"{scheme} book: f32 kernel vs plain "
                                 f"{err_k}")
        if scheme != "do":
            reports_batch.append(kernel_entry(
                f"fused_do_{scheme}", "fused_do", counts[1], timed, err_k,
                kernel, plain, bound, bound_by))

    mark("scheme_risk")
    # ---- book risk under HV (book_risk500): one primal launch, every f64
    # column of the kernel against the plain version on the same inputs,
    # the f32 normalized RMSE beside Douglas's in this run and as recorded
    sol_hv = dataclasses.replace(solver, scheme="hv")
    ks_r = torch.linspace(70.0, 130.0, 500, dtype=torch.float32, device=dev)

    def risk_hv(strikes=ks_r):
        return heston_tpu_torch.batch_greeks(spec, sol_hv, strikes, 100.0,
                                             *args, **flagship)

    reset_counts()
    out32 = risk_hv()
    torch.cuda.synchronize()
    counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
    ks64 = ks_r.double()
    out64 = risk_hv(ks64)
    fields, phases_r, at, ops, vec_s = fused_do.book_plan(
        spec, sol_hv, ks64, 100.0, *args, **flagship, epilogue=True)
    u, lam = assembly.run_phases(fused_do.fused_do_reference, fields,
                                 phases_r)
    plain64 = greeks.risk_epilogue(spec, sol_hv, ks64, p.v0, p.r_d, p.r_f,
                                   (u, lam, ops, vec_s, *at))
    col_err = {k: max_rel(out64[k], plain64[k])
               for k in heston_tpu_torch.RISK_KEYS}
    f32_norm = {k: norm_rmse(out32[k], out64[k])
                for k in heston_tpu_torch.RISK_KEYS}
    e2e = host_ms(risk_hv)
    prof = device_profile(risk_hv)
    phase("scheme_risk", case="book_risk500", scheme="hv", launches=counts,
          f64_kernel_vs_plain_rel=col_err, f64_rel_tol=RISK_REL_TOL,
          f32_price_rmse=rmse(out32["price"], out64["price"]),
          f32_norm_rmse=f32_norm,
          do_f32_norm_rmse_this_run=risk_do_norm["book_risk500"],
          do_f32_norm_rmse_recorded=RISK_DO_RECORDED, e2e_ms=e2e, **prof,
          device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
    if counts != (0, 1, 0):
        raise AssertionError(f"HV risk: (single, primal, tangent) launches "
                             f"{counts}, want (0, 1, 0)")
    if not all(bool(torch.isfinite(x).all()) for x in out32.values()):
        raise AssertionError("HV risk: non-finite columns")
    if not max(col_err.values()) <= RISK_REL_TOL:
        raise AssertionError(f"HV risk: f64 kernel vs plain {col_err}")

    mark("scheme_calibration")
    # ---- lm60 under CS: f32 and f64 fits, one forward-mode and one
    # primal launch per iteration; the forward-mode kernel at lm60's shape
    # against its plain version, and its times
    sol_cs = dataclasses.replace(solver, scheme="cs")

    def lm60_cs(dtype):
        strikes = strikes60.to(dtype)
        return heston_tpu_torch.calibrate_device(
            spec, sol_cs, strikes, market60.to(dtype), 100.0,
            torch.tensor(init, dtype=dtype), p.r_d, p.r_f, cfg=lm_cfg)

    reset_counts()
    tv32, info32 = lm60_cs(torch.float32)
    torch.cuda.synchronize()
    iters = info32["iterations"]
    cal_launches = (fused_do.fused_do_loop.tangent_launches,
                    fused_do.fused_do_loop.launches)
    tv64, info64 = lm60_cs(torch.float64)
    sse32 = float(info32["final_error"])
    sse64 = float(info64["final_error"])
    rmse_iv = iv_rmse(info32["fitted_prices"], market60, strikes60, p.r_d,
                      [(0, 60, 1.0)])
    wall = host_ms(lambda: lm60_cs(torch.float32), reps=CAL_REPS)
    loop60, _ = tangent_inputs(strikes60, "euro", sol=sol_cs)
    got_u, _, got_du, _ = bitwise_do(*loop60[:3], **loop60[3])
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        *loop60[:3], **loop60[3])
    err_tan = max(float((g - w).abs().max())
                  for g, w in zip([got_u, *got_du], [want_u, *want_du]))
    tan_ms = cuda_ms(lambda: fused_do.fused_do_loop(*loop60[:3],
                                                    **loop60[3]))
    tan_plain_ms = cuda_ms(lambda: fused_do.fused_do_reference(
        *loop60[:3], **loop60[3]), reps=1)
    tan_prof = device_profile(lambda: fused_do.fused_do_loop(*loop60[:3],
                                                             **loop60[3]))
    bound, bound_by, _, _ = kernel_bound(
        [solver.n_steps] * 60, [0] * 60, spec.m1 + 1, spec.m2 + 1, 0, 4,
        False, n_tangents=fused_do.JAC_TANGENTS, scheme="cs")
    phase("scheme_calibration", case="lm60", scheme="cs", dtype="float32",
          iterations=iters, converged=bool(info32["converged"]),
          final_sse=sse32, final_sse_f64=sse64,
          iterations_f64=info64["iterations"], params=tv32.tolist(),
          params_f64=tv64.tolist(), iv_rmse=rmse_iv,
          iv_rmse_bp=1e4 * rmse_iv, tangent_launches=cal_launches[0],
          primal_launches=cal_launches[1], wall_ms=wall,
          tangent_kernel_ms=tan_ms,
          tangent_kernel_device_ms=tan_prof["tangent_kernel_device_ms"],
          tangent_plain_f32_ms=tan_plain_ms,
          tangent_kernel_vs_plain_f32_max_abs=err_tan, bound_ms=bound,
          bound_by=bound_by)
    if cal_launches != (iters, iters):
        raise AssertionError(f"lm60 cs: (tangent, primal) launches "
                             f"{cal_launches} in {iters} iterations")
    if not all(bool(torch.isfinite(x).all()) for x in (
            tv32, info32["final_error"], tv64, info64["final_error"])):
        raise AssertionError("lm60 cs: non-finite output")
    if not abs(sse32 - sse64) <= SSE_REL * sse64:
        raise AssertionError(f"lm60 cs: f32 SSE {sse32} vs f64 {sse64}")
    if not err_tan <= TANGENT_KERNEL_TOL:
        raise AssertionError(f"lm60 cs: f32 tangent kernel vs plain "
                             f"{err_tan}")
    report_tangent_cs = kernel_entry(
        "fused_do_tangent_cs", "fused_do", cal_launches[0],
        jac_vs_f64(chain_plan(strikes60, sol_cs), JAC_CS_RMSE,
                   "lm60 cs forward mode"),
        err_tan, tan_ms, tan_plain_ms, bound, bound_by)

    mark("payoff_kernel_vs_plain")
    # ---- puts, cash-or-nothing digitals and knock-out barriers
    # (ROADMAP A1-A2). Kernel 1 against its plain version on the bench's
    # payoff arms (64 strikes in [75, 125], 50 x 25 x 20): f64 surfaces
    # and multipliers of the -fmad=false build, the knocked columns of the
    # kernel's surface exactly 0, the f32 kernel (-fmad=false) against the
    # f32 plain version on prices, and the f32 main path (price_batch)
    # against the f64 plain prices, gated at the bench's budgets
    def payoff_spec(level, base=spec):
        return dataclasses.replace(
            base, barrier=None if level is None else Barrier("up-out", level))

    def payoff_plan(strikes, option_type, level, arm, sol=solver,
                    base=spec):
        fields, phases_p, at, _, _ = fused_do.book_plan(
            payoff_spec(level, base), sol, strikes, 100.0, *args,
            option_type=option_type, **arms[arm])
        return fields, phases_p, at

    def knocked_zero(u, knocked, s_axis=1):
        return all(bool((u.select(s_axis, c) == 0.0).all()) for c in knocked)

    plain_loop = fused_do.fused_do_reference
    for name, (option_type, level, arm) in PAYOFF_ARMS.items():
        knocked = assembly.barrier_positions(payoff_spec(level))
        f64, ph64, at64 = payoff_plan(ks, option_type, level, arm)
        got = assembly.run_phases(bitwise_do, f64, ph64)
        want = assembly.run_phases(plain_loop, f64, ph64)
        torch.cuda.synchronize()
        err64 = max(float((g - w).abs().max()) for g, w in zip(got, want))
        zero64 = knocked_zero(got[0], knocked)
        f32, ph32, at32 = payoff_plan(ks.float(), option_type, level, arm)
        k32 = prices(assembly.run_phases(bitwise_do, f32, ph32)[0], at32)
        p32 = prices(assembly.run_phases(plain_loop, f32, ph32)[0], at32)
        err_k32 = float((k32 - p32).abs().max())
        reset_counts()
        main32 = heston_tpu_torch.price_batch(
            payoff_spec(level), solver, ks.float(), 100.0, *args,
            option_type=option_type, **arms[arm])
        torch.cuda.synchronize()
        counts = launch_counts()
        err32 = rmse(main32, prices(want[0], at64))
        phase("payoff_kernel_vs_plain", arm=name, option_type=option_type,
              barrier=level, f64_max_abs=err64, f64_tol=F64_KERNEL_TOL,
              knocked_columns_zero=zero64,
              f32_kernel_vs_plain_f32_max_abs=err_k32,
              f32_kernel_vs_plain_f32_bitwise=bool(torch.equal(k32, p32)),
              f32_rmse=err32, f32_budget=PAYOFF_BUDGETS[name],
              launches=counts)
        if counts != (0, 1):
            raise AssertionError(f"{name}: (single, batched) launches "
                                 f"{counts}, want (0, 1)")
        if not (err64 <= F64_KERNEL_TOL and zero64):
            raise AssertionError(f"{name}: f64 kernel vs plain {err64}, "
                                 f"knocked columns zero: {zero64}")
        if not err_k32 <= MAIN_KERNEL_TOL:
            raise AssertionError(f"{name}: f32 kernel vs plain {err_k32}")
        if not (bool(torch.isfinite(main32).all())
                and err32 <= PAYOFF_BUDGETS[name]):
            raise AssertionError(f"{name}: f32 RMSE {err32} over budget")

    mark("payoff_tangent_vs_plain")
    # ---- the payoffs in forward mode (kernel 1, 64 strikes, the flagship
    # grid): f64 primal and tangent surfaces against the plain version,
    # knocked columns 0 in every surface; the f32 Jacobian through
    # fused_theta_jacobian against the f64 plain one (normalized RMSE,
    # gated at 3e-5 on the European put chain, printed for the others)
    for name, (option_type, level, arm) in (
            ("put_euro", ("put", None, "euro")),
            ("put_amer_div", ("put", None, "amer_div")),
            ("digital_amer", ("digital_call", None, "amer")),
            ("barrier_amer_div", ("call", 160.0, "amer_div"))):
        pspec = payoff_spec(level)
        knocked = assembly.barrier_positions(pspec)
        tv = torch.tensor(theta, dtype=torch.float64, device=dev)
        fields, tangents, vec_s, idx_s, idx_v = fused_do._linearized_assemble(
            pspec, solver, ks, 100.0, tv, p.r_d, p.r_f,
            option_type=option_type)
        (steps, remaps, kw), = fused_do.book_phases(
            solver, arms[arm]["dividends"], vec_s,
            operators.boundary_rate(p.r_d, p.r_f, option_type),
            arms[arm]["american"], option_type=option_type, knocked=knocked)
        reset_counts()
        got_u, _, got_du, _ = bitwise_do(
            fields, steps, remaps, **kw, tangents=tangents)
        torch.cuda.synchronize()
        tan_launches = fused_do.fused_do_loop.tangent_launches
        want_u, _, want_du, _ = plain_loop(
            fields, steps, remaps, **kw, tangents=tangents)
        err64 = max(float((g - w).abs().max())
                    for g, w in zip([got_u, *got_du], [want_u, *want_du]))
        zero64 = all(knocked_zero(x, knocked) for x in [got_u, *got_du])
        _, jac64 = fused_do._read_jacobian(spec, want_u, want_du,
                                           fields["vfl"], idx_s, idx_v,
                                           tv[4])
        _, jac32 = fused_do.fused_theta_jacobian(
            pspec, solver, ks.float(), 100.0, tv.float(), p.r_d, p.r_f,
            option_type=option_type, **arms[arm])
        jac_rmse = norm_rmse(jac32, jac64)
        budget = JAC_RMSE if name == "put_euro" else None
        phase("payoff_tangent_vs_plain", arm=name, option_type=option_type,
              barrier=level, tangent_launches=tan_launches,
              f64_max_abs=err64, f64_tol=F64_KERNEL_TOL,
              knocked_columns_zero=zero64, f32_jac_norm_rmse=jac_rmse,
              f32_jac_budget=budget)
        if tan_launches != 1:
            raise AssertionError(f"{name}: tangent launches {tan_launches}")
        if not (err64 <= F64_KERNEL_TOL and zero64):
            raise AssertionError(f"{name}: f64 tangent kernel vs plain "
                                 f"{err64}, knocked columns zero: {zero64}")
        if not (bool(torch.isfinite(jac32).all())
                and (budget is None or jac_rmse <= budget)):
            raise AssertionError(f"{name}: f32 Jacobian RMSE {jac_rmse}")

    mark("payoff_single")
    # ---- the payoffs on kernel 2 at the golden grid (100 x 75 x 20,
    # central A2, K = 100): f64 kernel against plain (surfaces and
    # multipliers, knocked columns 0), the f32 price of one price_batch
    # call (its launches) against the f64 plain price, and the kernel's
    # times and bound
    reports_payoff = []
    for name, (option_type, level, arm, budget) in PAYOFF_SINGLES.items():
        pspec = payoff_spec(level, gspec)
        knocked = assembly.barrier_positions(pspec)
        sf64, ph64, at = fused_single.single_plan(
            pspec, gsolver, k64, 100.0, *args, option_type=option_type,
            **arms[arm])
        got = assembly.run_phases(bitwise_single, sf64, ph64)
        want = assembly.run_phases(fused_single.fused_single_reference,
                                       sf64, ph64)
        torch.cuda.synchronize()
        err64 = max(float((g - w).abs().max()) for g, w in zip(got, want))
        zero64 = knocked_zero(got[0], knocked)
        reset_counts()
        out = heston_tpu_torch.price_batch(pspec, gsolver, k64.float(),
                                           100.0, *args,
                                           option_type=option_type,
                                           **arms[arm])
        torch.cuda.synchronize()
        counts = launch_counts()
        timed = vs_f64(out, want[0][at].reshape(1), budget,
                       f"single {name}")
        sf32, ph32, _ = fused_single.single_plan(
            pspec, gsolver, k64.float(), 100.0, *args,
            option_type=option_type, **arms[arm])
        k32 = assembly.run_phases(bitwise_single, sf32, ph32)[0]
        p32 = assembly.run_phases(fused_single.fused_single_reference,
                                      sf32, ph32)[0]
        err_k32 = float((k32 - p32).abs().max())
        s_ms = cuda_ms(lambda: assembly.run_phases(
            fused_single.fused_single_loop, sf32, ph32))
        s_plain_ms = cuda_ms(lambda: assembly.run_phases(
            fused_single.fused_single_reference, sf32, ph32), reps=3)
        s_prof = device_profile(lambda: assembly.run_phases(
            fused_single.fused_single_loop, sf32, ph32))
        n_ev = sum(len(steps) for steps, _, _ in ph32)
        bound, bound_by, _, _ = kernel_bound(
            [gsolver.n_steps], [n_ev], gspec.m1 + 1, gspec.m2 + 1, n_ev, 4,
            arms[arm]["american"], option_type=option_type, knocked=knocked)
        phase("payoff_single", payoff=name, option_type=option_type,
              barrier=level, arm=arm, grid="100x75x20", launches=counts,
              f64_max_abs=err64, f64_tol=F64_KERNEL_TOL,
              knocked_columns_zero=zero64, f64_price=float(want[0][at]),
              f32_price=float(out[0]), timed_build_vs_plain_f64=timed,
              f32_kernel_vs_plain_f32_max_abs=err_k32, kernel_ms=s_ms,
              plain_f32_ms=s_plain_ms, bound_ms=bound, bound_by=bound_by,
              **s_prof)
        if counts != (1, 0):
            raise AssertionError(f"single {name}: (single, batched) "
                                 f"launches {counts}, want (1, 0)")
        if not (err64 <= F64_KERNEL_TOL and zero64):
            raise AssertionError(f"single {name}: f64 kernel vs plain "
                                 f"{err64}, knocked columns zero: {zero64}")
        if not (bool(torch.isfinite(out).all())
                and err_k32 <= F32_SURFACE_TOL):
            raise AssertionError(f"single {name}: f32 {float(out[0])}, "
                                 f"kernel vs plain {err_k32}")
        reports_payoff.append(kernel_entry(
            f"fused_single_{name}", "fused_single", counts[0], timed,
            err_k32, s_ms, s_plain_ms, bound, bound_by))

    mark("payoff_batch_time")
    # ---- the flagship book (500 American options with the golden
    # dividends, f32) as calls, puts, digital calls and up-out 160 calls,
    # through price_batch, in one call: launches, end-to-end and device
    # times, the kernel (main-path build) and its plain version, the
    # main path's f32 prices against the f64 plain ones (gated at the
    # payoff's bench budget), the f32 kernel (-fmad=false) against the f32
    # plain prices, and the bound
    for name, (option_type, level, budget) in PAYOFF_BOOKS.items():
        pspec = payoff_spec(level)
        knocked = assembly.barrier_positions(pspec)

        def call(pspec=pspec, option_type=option_type):
            return heston_tpu_torch.price_batch(
                pspec, solver, book, 100.0, *args, option_type=option_type,
                **flagship)

        reset_counts()
        out = call()
        torch.cuda.synchronize()
        counts = launch_counts()
        fields, phases_p, at = payoff_plan(book, option_type, level,
                                           "amer_div")
        k32 = assembly.run_phases(bitwise_do, fields, phases_p)[0]
        p32 = prices(assembly.run_phases(plain_loop, fields, phases_p)[0], at)
        err_k = float((prices(k32, at) - p32).abs().max())
        fma = assembly.run_phases(fused_do.fused_do_loop, fields, phases_p)[0]
        f64, ph64, at64 = payoff_plan(book.double(), option_type, level,
                                      "amer_div")
        timed = vs_f64(out, prices(assembly.run_phases(plain_loop, f64,
                                                       ph64)[0], at64),
                       budget, f"{name} book")
        e2e = host_ms(call)
        prof = device_profile(call)
        kernel = cuda_ms(lambda: assembly.run_phases(
            fused_do.fused_do_loop, fields, phases_p))
        plain = cuda_ms(lambda: assembly.run_phases(plain_loop, fields,
                                                    phases_p), reps=3)
        n_ev = len(phases_p[0][0])
        bound, bound_by, flops, _ = kernel_bound(
            [solver.n_steps] * len(book), [n_ev] * len(book), spec.m1 + 1,
            spec.m2 + 1, n_ev, 4, True, option_type=option_type,
            knocked=knocked)
        phase("payoff_batch_time", payoff=name, option_type=option_type,
              barrier=level, arm="amer_div", batch=len(book),
              launches=counts, kernel_vs_plain_f32_max_abs=err_k,
              timed_build_vs_plain_f64=timed,
              main_build_knocked_columns_zero=knocked_zero(fma, knocked),
              e2e_ms=e2e, kernel_ms=kernel, plain_f32_ms=plain,
              bound_ms=bound, bound_by=bound_by, bound_gflop=flops / 1e9,
              price_mid=float(out[len(book) // 2]), **prof,
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
        if counts != (0, 1) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} book: launches {counts}")
        if not (err_k <= MAIN_KERNEL_TOL and knocked_zero(k32, knocked)
                and knocked_zero(fma, knocked)):
            raise AssertionError(f"{name} book: f32 kernel vs plain {err_k}")
        if name != "call":
            reports_payoff.append(kernel_entry(
                f"fused_do_{name}", "fused_do", counts[1], timed, err_k,
                kernel, plain, bound, bound_by))

    mark("payoff_risk")
    # ---- book risk (book_risk500) as American puts and as American
    # digital calls (whose theta reads the projection's active set), with
    # the golden dividends: one primal launch, every f64 column of the
    # kernel against the plain version on the same inputs, the f32 price
    # RMSE and the other columns' normalized RMSE
    for name, option_type in (("put", "put"), ("digital_amer",
                                               "digital_call")):
        def risk_p(strikes=ks_r, option_type=option_type):
            return heston_tpu_torch.batch_greeks(
                spec, solver, strikes, 100.0, *args, option_type=option_type,
                **flagship)

        reset_counts()
        out32 = risk_p()
        torch.cuda.synchronize()
        counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
        ks64 = ks_r.double()
        out64 = risk_p(ks64)
        fields, phases_r, at, ops, vec_s = fused_do.book_plan(
            spec, solver, ks64, 100.0, *args, option_type=option_type,
            **flagship, epilogue=True)
        u, lam = assembly.run_phases(plain_loop, fields, phases_r)
        plain64 = greeks.risk_epilogue(spec, solver, ks64, p.v0, p.r_d,
                                       p.r_f, (u, lam, ops, vec_s, *at),
                                       option_type, american=True)
        floor = operators.grid_payoff(vec_s, ks64[:, None], option_type)
        active = int((u == floor[:, :, None]).sum())
        col_err = {k: max_rel(out64[k], plain64[k])
                   for k in heston_tpu_torch.RISK_KEYS}
        f32_norm = {k: norm_rmse(out32[k], out64[k])
                    for k in heston_tpu_torch.RISK_KEYS}
        e2e = host_ms(risk_p)
        prof = device_profile(risk_p)
        phase("payoff_risk", case="book_risk500", payoff=name,
              launches=counts, f64_kernel_vs_plain_rel=col_err,
              f64_rel_tol=RISK_REL_TOL, active_set_nodes=active,
              f32_price_rmse=rmse(out32["price"], out64["price"]),
              f32_norm_rmse=f32_norm, e2e_ms=e2e, **prof,
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
        if counts != (0, 1, 0):
            raise AssertionError(f"{name} risk: (single, primal, tangent) "
                                 f"launches {counts}, want (0, 1, 0)")
        if not all(bool(torch.isfinite(x).all()) for x in out32.values()):
            raise AssertionError(f"{name} risk: non-finite columns")
        if not max(col_err.values()) <= RISK_REL_TOL:
            raise AssertionError(f"{name} risk: f64 kernel vs plain "
                                 f"{col_err}")

    mark("payoff_calibration")
    # ---- lm60 as 60 European puts (K = 70..129, T = 1, market from
    # bs.put_price at flat vol 0.2), f32 and f64: one forward-mode and one
    # primal launch per iteration, iterations and SSE
    def lm60_put(dtype):
        strikes = strikes60.to(dtype)
        market = bs.put_price(100.0, strikes, p.r_d, 0.2, 1.0)
        return strikes, market, heston_tpu_torch.calibrate_device(
            spec, solver, strikes, market, 100.0,
            torch.tensor(init, dtype=dtype), p.r_d, p.r_f, cfg=lm_cfg,
            option_type="put")

    reset_counts()
    _, market_put, (tv32, info32) = lm60_put(torch.float32)
    torch.cuda.synchronize()
    iters = info32["iterations"]
    cal_launches = (fused_do.fused_do_loop.tangent_launches,
                    fused_do.fused_do_loop.launches)
    _, _, (tv64, info64) = lm60_put(torch.float64)
    sse32 = float(info32["final_error"])
    sse64 = float(info64["final_error"])
    wall = host_ms(lambda: lm60_put(torch.float32), reps=CAL_REPS)
    phase("payoff_calibration", case="lm60_put", dtype="float32",
          iterations=iters, converged=bool(info32["converged"]),
          final_sse=sse32, final_sse_f64=sse64,
          iterations_f64=info64["iterations"], params=tv32.tolist(),
          params_f64=tv64.tolist(), tangent_launches=cal_launches[0],
          primal_launches=cal_launches[1], wall_ms=wall,
          sse_rel_budget=SSE_REL)
    if cal_launches != (iters, iters):
        raise AssertionError(f"lm60 put: (tangent, primal) launches "
                             f"{cal_launches} in {iters} iterations")
    if not all(bool(torch.isfinite(x).all()) for x in (
            tv32, info32["final_error"], tv64, info64["final_error"])):
        raise AssertionError("lm60 put: non-finite output")
    if not abs(sse32 - sse64) <= SSE_REL * sse64:
        raise AssertionError(f"lm60 put: f32 SSE {sse32} vs f64 {sse64}")
    # the forward-mode kernel on the put chain at lm60's shape (the main
    # path's build) against its plain version, its times and bound
    def put_plan(dtype):
        """jac_vs_f64's plan of the lm60 put chain at the start
        parameters."""
        tv = torch.tensor(init, dtype=dtype, device=dev)
        fields, tangents, vec_s, idx_s, idx_v = fused_do._linearized_assemble(
            spec, solver, strikes60.to(dtype), 100.0, tv, p.r_d, p.r_f,
            option_type="put")
        (steps, remaps, kw), = fused_do.book_phases(
            solver, None, vec_s, operators.boundary_rate(p.r_d, p.r_f, "put"),
            False, option_type="put")
        return (((fields, steps, remaps), dict(kw, tangents=tangents)),
                (fields["vfl"], idx_s, idx_v, tv[4]))

    (put_loop, kw), _ = put_plan(torch.float32)
    got_u, _, got_du, _ = bitwise_do(*put_loop, **kw)
    want_u, _, want_du, _ = plain_loop(*put_loop, **kw)
    err_tan = max(float((g - w).abs().max())
                  for g, w in zip([got_u, *got_du], [want_u, *want_du]))
    tan_ms = cuda_ms(lambda: fused_do.fused_do_loop(*put_loop, **kw))
    tan_plain_ms = cuda_ms(lambda: plain_loop(*put_loop, **kw), reps=1)
    tan_prof = device_profile(lambda: fused_do.fused_do_loop(*put_loop,
                                                             **kw))
    bound, bound_by, _, _ = kernel_bound(
        [solver.n_steps] * 60, [0] * 60, spec.m1 + 1, spec.m2 + 1, 0, 4,
        False, n_tangents=fused_do.JAC_TANGENTS, option_type="put")
    phase("payoff_calibration_tangent", case="lm60_put",
          tangent_kernel_ms=tan_ms,
          tangent_kernel_device_ms=tan_prof["tangent_kernel_device_ms"],
          tangent_plain_f32_ms=tan_plain_ms,
          tangent_kernel_vs_plain_f32_max_abs=err_tan, bound_ms=bound,
          bound_by=bound_by)
    if not err_tan <= TANGENT_KERNEL_TOL:
        raise AssertionError(f"lm60 put: f32 tangent kernel vs plain "
                             f"{err_tan}")
    reports_payoff.append(kernel_entry(
        "fused_do_tangent_put", "fused_do", cal_launches[0],
        jac_vs_f64(put_plan, JAC_RMSE, "lm60 put forward mode"), err_tan,
        tan_ms, tan_plain_ms, bound, bound_by))

    mark("knock_in")
    # ---- knock-in prices by in-out parity (price_knock_in: the vanilla
    # book and the knock-out book, one launch each), the 500 ladder as
    # up-and-in 160 calls with the golden dividends: f64 on the card
    # against the same call on the CPU, f32 against f64
    kin_spec = payoff_spec(160.0)
    reset_counts()
    kin32 = heston_tpu_torch.price_knock_in(kin_spec, solver, book, 100.0,
                                            *args, dividends=GOLDEN_DIVIDENDS)
    torch.cuda.synchronize()
    counts = launch_counts()
    kin64 = heston_tpu_torch.price_knock_in(kin_spec, solver, book.double(),
                                            100.0, *args,
                                            dividends=GOLDEN_DIVIDENDS)
    kin_cpu = heston_tpu_torch.price_knock_in(
        kin_spec, solver, book.double().cpu(), 100.0, *args,
        dividends=GOLDEN_DIVIDENDS, device="cpu")
    err_cpu = float((kin64.cpu() - kin_cpu).abs().max())
    phase("knock_in", batch=len(book), barrier=160.0, launches=counts,
          f64_card_vs_cpu_max_abs=err_cpu, f64_tol=F64_KERNEL_TOL,
          f32_rmse_vs_f64=rmse(kin32, kin64),
          price_mid=float(kin64[len(book) // 2]))
    if counts != (0, 2) or not bool(torch.isfinite(kin32).all()):
        raise AssertionError(f"knock-in: launches {counts}")
    if not err_cpu <= F64_KERNEL_TOL:
        raise AssertionError(f"knock-in: f64 card vs CPU {err_cpu}")

    # ---- rate curves (ROADMAP A3): the flagship book (B = 500 American,
    # golden dividends, 50 x 25 x 20) as calls and as puts on the
    # three-segment curve of tests/test_rate_schedule.py:139-140,
    # undamped and with Rannacher start-up (R = 2): one launch per phase
    # and segment piece, each with its segment's fields and boundary
    # rate. f64: the kernel against its plain version on u and lambda
    # after every piece (each chain from its own state); f32 (the main
    # path's build) through price_batch against the f64 plain version;
    # a constant curve against flat scalars; and pieces of one phase cut
    # at equal segments against the unsplit phase
    mark("curve_kernel_vs_plain")
    curve = RateSchedule(times=(1.0 / 3.0, 2.0 / 3.0),
                         r_d=(0.02, 0.035, 0.025), r_f=(0.0, 0.01, 0.004))
    book500 = torch.linspace(70.0, 130.0, 500, dtype=torch.float32,
                             device=dev)

    def states(loop, fields, phases, tangents=None):
        """The state after each launch of a plan: (u, lam), or (u, lam,
        dus, dlams) with tangents."""
        out, state = [], {}
        for steps, remaps, kw in phases:
            tkw = {} if tangents is None else dict(tangents=tangents)
            got = loop({**fields, **state}, steps, remaps, **kw, **tkw)
            state = dict(zip(("u", "lam", "du", "dlam"), got))
            out.append(got)
        return out

    def state_err(a, b, american, rel=False):
        """max |a - b| (with `rel`, max_rel) over u (and lam), the
        tangents and, American, their multipliers, of two states of the
        same launch."""
        parts = [(a[0], b[0])] + ([(a[1], b[1])] if american else [])
        if len(a) == 4:
            parts += list(zip(a[2], b[2]))
            if american:
                parts += list(zip(a[3], b[3]))
        return max(max_rel(x, y) if rel else float((x - y).abs().max())
                   for x, y in parts)

    def pieces_bound(phases, n_tangents=0, option_type="call", b=500):
        """kernel_bound summed over the launches of a plan (f32)."""
        total, by = 0.0, None
        for steps, _, kw in phases:
            n = kw["n_steps"] - kw["first_step"] + 1
            ms, by, _, _ = kernel_bound(
                [n] * b, [len(steps)] * b, spec.m1 + 1, spec.m2 + 1,
                len(steps), 4, kw["american"], n_tangents=n_tangents,
                scheme=kw["scheme"], option_type=option_type)
            total += ms
        return total, by

    report_curve = None
    for option_type in ("call", "put"):
        for rann in (0, 2):
            sol_c = dataclasses.replace(solver, rannacher_steps=rann)

            def plan(strikes, sched=curve, sol_c=sol_c,
                     option_type=option_type):
                return fused_do.book_plan(
                    spec, sol_c, strikes, 100.0, *args, **flagship,
                    option_type=option_type, rate_schedule=sched)

            f64, ph64, at64, _, _ = plan(book500.double())
            got = states(fused_do.fused_do_loop, f64, ph64)
            want = states(fused_do.fused_do_reference, f64, ph64)
            torch.cuda.synchronize()
            piece_err = [state_err(g, w, True) for g, w in zip(got, want)]
            plain64 = prices(want[-1][0], at64)
            reset_counts()
            out32 = heston_tpu_torch.price_batch(
                spec, sol_c, book500, 100.0, *args, **flagship,
                option_type=option_type, rate_schedule=curve)
            torch.cuda.synchronize()
            counts = launch_counts()
            timed = vs_f64(out32, plain64, MAIN_RMSE,
                           f"curve {option_type} R={rann}")
            f32, ph32, at32, _, _ = plan(book500)
            bitwise = float((states(bitwise_do, f32, ph32)[-1][0]
                             - states(fused_do.fused_do_reference, f32,
                                      ph32)[-1][0]).abs().max())
            const = RateSchedule(times=(1.0 / 3.0, 2.0 / 3.0),
                                 r_d=(p.r_d,) * 3, r_f=(p.r_f,) * 3)
            flat64 = heston_tpu_torch.price_batch(
                spec, sol_c, book500.double(), 100.0, *args, **flagship,
                option_type=option_type)
            const64 = heston_tpu_torch.price_batch(
                spec, sol_c, book500.double(), 100.0, *args, **flagship,
                option_type=option_type, rate_schedule=const)
            const_err = float((const64 - flat64).abs().max())
            # the flat book's phases cut at steps 1 | 2..7 | 8..20 into
            # segments with the same fields
            fl, _, _, _, vs = fused_do.book_plan(
                spec, sol_c, book500.double(), 100.0, *args, **flagship,
                option_type=option_type)
            rf_b = operators.boundary_rate(p.r_d, p.r_f, option_type)
            cut = fused_do.book_phases(
                sol_c, GOLDEN_DIVIDENDS, vs, None, True, None, option_type,
                (), [(1, 1, rf_b, fl), (2, 7, rf_b, fl), (8, 20, rf_b, fl)])
            whole = fused_do.book_phases(sol_c, GOLDEN_DIVIDENDS, vs, rf_b,
                                         True, option_type=option_type)
            split_err = state_err(
                assembly.run_phases(fused_do.fused_do_loop, fl, cut),
                assembly.run_phases(fused_do.fused_do_loop, fl, whole), True,
                rel=True)
            phase("curve_kernel_vs_plain", option_type=option_type,
                  rannacher_steps=rann, launches=counts,
                  f64_max_abs_per_piece=piece_err, f64_tol=F64_KERNEL_TOL,
                  f32=timed, f32_bitwise_max_abs=bitwise,
                  constant_curve_vs_flat_f64=const_err,
                  split_vs_whole_f64_rel=split_err,
                  price_mid=float(out32[250]))
            if counts != (0, len(ph64)):
                raise AssertionError(f"curve {option_type} R={rann}: "
                                     f"launches {counts}, want "
                                     f"(0, {len(ph64)})")
            if not max(piece_err) <= F64_KERNEL_TOL:
                raise AssertionError(f"curve {option_type} R={rann}: f64 "
                                     f"kernel vs plain {piece_err}")
            if not (const_err <= CURVE_FLAT_TOL
                    and split_err <= CURVE_FLAT_TOL):
                raise AssertionError(f"curve {option_type} R={rann}: "
                                     f"constant curve {const_err}, split "
                                     f"{split_err} vs flat")
            if (option_type, rann) == ("call", 0):
                bound, bound_by = pieces_bound(ph32)
                report_curve = kernel_entry(
                    "fused_do_curve", "fused_do", counts[1], timed, bitwise,
                    cuda_ms(lambda: assembly.run_phases(
                        fused_do.fused_do_loop, f32, ph32)),
                    cuda_ms(lambda: assembly.run_phases(
                        fused_do.fused_do_reference, f32, ph32), reps=3),
                    bound, bound_by)

    # ---- the curve book's pricing time beside the flat book's, in one
    # call: the flagship calls, f32
    mark("curve_batch_time")
    for name, sched in (("flat", None), ("curve", curve)):
        def call(sched=sched):
            return heston_tpu_torch.price_batch(
                spec, solver, book500, 100.0, *args, **flagship,
                rate_schedule=sched)

        reset_counts()
        call()
        torch.cuda.synchronize()
        counts = launch_counts()
        e2e = host_ms(call)
        prof = device_profile(call)
        phase("curve_batch_time", book=name, batch=500, launches=counts,
              e2e_ms=e2e, **prof,
              device_ms_per_launch=prof["primal_kernel_device_ms"]
              / counts[1],
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)

    # ---- book_risk500 on the curve: one launch per segment, theta at the
    # last segment's operators and boundary rate; every f64 column of the
    # kernel against the plain version on the same inputs, f32 against f64
    mark("curve_risk")
    ks_c = torch.linspace(70.0, 130.0, 500, dtype=torch.float32, device=dev)

    def curve_risk(strikes=ks_c, **extra):
        return heston_tpu_torch.batch_greeks(
            spec, solver, strikes, 100.0, *args, **flagship,
            rate_schedule=curve, **extra)

    reset_counts()
    out32 = curve_risk()
    torch.cuda.synchronize()
    counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
    ks64 = ks_c.double()
    out64 = curve_risk(ks64)
    fields, phases_c, at, ops, vec_s = fused_do.book_plan(
        spec, solver, ks64, 100.0, *args, **flagship, rate_schedule=curve,
        epilogue=True)
    u, lam = assembly.run_phases(fused_do.fused_do_reference, fields,
                                 phases_c)
    plain64 = greeks.risk_epilogue(spec, solver, ks64, p.v0, p.r_d, p.r_f,
                                   (u, lam, ops, vec_s, *at),
                                   rate_schedule=curve)
    col_err = {k: max_rel(out64[k], plain64[k])
               for k in heston_tpu_torch.RISK_KEYS}
    price_rmse = rmse(out32["price"], out64["price"])
    e2e = host_ms(curve_risk)
    prof = device_profile(curve_risk)
    phase("curve_risk", case="book_risk500_curve", launches=counts,
          f64_kernel_vs_plain_rel=col_err, f64_rel_tol=RISK_REL_TOL,
          f32_price_rmse=price_rmse, f32_price_budget=MAIN_RMSE,
          f32_norm_rmse={k: norm_rmse(out32[k], out64[k])
                         for k in heston_tpu_torch.RISK_KEYS},
          e2e_ms=e2e, **prof,
          device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
    if counts != (0, len(phases_c), 0):
        raise AssertionError(f"curve risk: launches {counts}")
    if not all(bool(torch.isfinite(x).all()) for x in out32.values()):
        raise AssertionError("curve risk: non-finite risk")
    if not max(col_err.values()) <= RISK_REL_TOL:
        raise AssertionError(f"curve risk: f64 kernel vs plain {col_err}")
    if not price_rmse <= MAIN_RMSE:
        raise AssertionError(f"curve risk: f32 price RMSE {price_rmse}")

    # ---- the damped Jacobian (ROADMAP A4): the forward-mode kernel at
    # lm60's shape (60 calls, K = 4) and the same chain American with the
    # golden dividends under Rannacher start-up (R = 2): the damp launch
    # hands u, lambda, du_k and dlam_k to the main launch. f64 kernel
    # against plain after the damp launch and at the end; the f32
    # Jacobian (the main path's build) against the f64 plain one
    mark("rann_tangent_vs_plain")

    def rann_plan(dtype, arm, sol=rann_solver, v0_mode="stencil"):
        """(fields, tangents, phases, _read_jacobian's extra arguments) of
        the lm60 chain at the default parameters."""
        tv = torch.tensor(theta, dtype=dtype, device=dev)
        fields, tangents, vec_s, idx_s, idx_v = fused_do._linearized_assemble(
            spec, sol, strikes60.to(dtype), 100.0, tv, p.r_d, p.r_f,
            v0_mode=v0_mode)
        phases = fused_do.book_phases(sol, arms[arm]["dividends"], vec_s,
                                      p.r_f, arms[arm]["american"])
        return fields, tangents, phases, (fields["vfl"], idx_s, idx_v, tv[4])

    rann_jac = {}
    for arm in ("euro", "amer_div"):
        american = arms[arm]["american"]
        fields, tangents, phases_t, extra = rann_plan(torch.float64, arm)
        got = states(fused_do.fused_do_loop, fields, phases_t, tangents)
        want = states(fused_do.fused_do_reference, fields, phases_t,
                      tangents)
        torch.cuda.synchronize()
        err_damp = state_err(got[0], want[0], american)
        err_end = state_err(got[-1], want[-1], american)
        _, jac64 = fused_do._read_jacobian(spec, want[-1][0], want[-1][2],
                                           *extra)
        _, jac32 = fused_do.fused_theta_jacobian(
            spec, rann_solver, strikes60, 100.0,
            torch.tensor(theta, dtype=torch.float32, device=dev), p.r_d,
            p.r_f, **arms[arm])
        timed = vs_f64(jac32, jac64, JAC_RMSE, f"damped Jacobian {arm}",
                       norm=True)
        f32, t32, ph32, _ = rann_plan(torch.float32, arm)
        bitwise = state_err(states(bitwise_do, f32, ph32, t32)[-1],
                            states(fused_do.fused_do_reference, f32, ph32,
                                   t32)[-1], american)
        rann_jac[arm] = (timed, bitwise, f32, t32, ph32)
        phase("rann_tangent_vs_plain", arm=arm, launches=len(phases_t),
              f64_max_abs_after_damp=err_damp, f64_max_abs_end=err_end,
              f64_tol=F64_KERNEL_TOL, f32_jac=timed,
              f32_kernel_vs_plain_f32_max_abs=bitwise)
        if len(phases_t) != 2:
            raise AssertionError(f"damped Jacobian {arm}: {len(phases_t)} "
                                 f"launches, want 2")
        if not max(err_damp, err_end) <= F64_KERNEL_TOL:
            raise AssertionError(f"damped Jacobian {arm}: f64 kernel vs "
                                 f"plain {err_damp}, {err_end}")

    # ---- lm60 under Rannacher start-up: one damp and one main launch of
    # each kernel per iteration; f32 against f64; then lm_multi200 damped,
    # one run: launches per pass
    mark("rann_calibration")

    def run_rann(dtype):
        return heston_tpu_torch.calibrate_device(
            spec, rann_solver, strikes60.to(dtype), market60.to(dtype),
            100.0, torch.tensor(init, dtype=dtype), p.r_d, p.r_f,
            cfg=lm_cfg)

    reset_counts()
    tv_r32, info_r32 = run_rann(torch.float32)
    torch.cuda.synchronize()
    it_r = info_r32["iterations"]
    rann_launches = (fused_do.fused_do_loop.tangent_launches,
                     fused_do.fused_do_loop.launches)
    tv_r64, info_r64 = run_rann(torch.float64)
    sse_r32 = float(info_r32["final_error"])
    sse_r64 = float(info_r64["final_error"])
    wall_r = host_ms(lambda: run_rann(torch.float32), reps=CAL_REPS)
    prof_r = device_profile(lambda: run_rann(torch.float32))
    reset_counts()
    t0 = time.perf_counter()
    tv_m, info_m = heston_tpu_torch.calibrate_device(
        spec, rann_solver, ladder, ladder_market, 100.0, torch.tensor(init),
        p.r_d, p.r_f, cfg=lm_cfg, group_steps=groups)
    torch.cuda.synchronize()
    wall_m = 1e3 * (time.perf_counter() - t0)
    it_m = info_m["iterations"]
    per_pass_m = (fused_do.fused_do_loop.tangent_launches / it_m,
                  fused_do.fused_do_loop.launches / it_m)
    phase("rann_calibration", case="lm60_rann", dtype="float32",
          iterations=it_r, iterations_f64=info_r64["iterations"],
          final_sse=sse_r32, final_sse_f64=sse_r64,
          params=tv_r32.tolist(), params_f64=tv_r64.tolist(),
          tangent_launches=rann_launches[0],
          primal_launches=rann_launches[1], wall_ms=wall_r, **prof_r,
          device_idle_share=1.0 - prof_r["device_busy_ms"] / wall_r,
          lm_multi200_rann=dict(
              iterations=it_m, final_sse=float(info_m["final_error"]),
              wall_ms_one_run=wall_m, tangent_launches_per_pass=per_pass_m[0],
              primal_launches_per_trial=per_pass_m[1]))
    if rann_launches != (2 * it_r, 2 * it_r):
        raise AssertionError(f"lm60 damped: (tangent, primal) launches "
                             f"{rann_launches} in {it_r} iterations, want "
                             f"two of each per iteration")
    if not all(bool(torch.isfinite(x).all()) for x in (
            tv_r32, info_r32["final_error"], tv_r64, tv_m,
            info_m["final_error"])):
        raise AssertionError("damped calibration: non-finite output")
    if not abs(sse_r32 - sse_r64) <= SSE_REL * sse_r64:
        raise AssertionError(f"lm60 damped: f32 SSE {sse_r32} vs f64 "
                             f"{sse_r64}")
    if per_pass_m != (2.0, 2.0):
        raise AssertionError(f"lm_multi200 damped: launches per pass "
                             f"{per_pass_m}, want two each")
    timed, bitwise, f32, t32, ph32 = rann_jac["euro"]
    bound, bound_by = pieces_bound(ph32, fused_do.JAC_TANGENTS, b=60)
    report_rann = kernel_entry(
        "fused_do_tangent_rann", "fused_do", rann_launches[0], timed,
        bitwise,
        cuda_ms(lambda: assembly.run_phases(fused_do.fused_do_loop, f32,
                                            ph32, t32)),
        cuda_ms(lambda: assembly.run_phases(fused_do.fused_do_reference, f32,
                                            ph32, t32), reps=1),
        bound, bound_by)
    # the forward-mode kernel's device time at lm60's shape: the damped
    # pair of launches, the undamped K = 4 launch and (v0_ad_tangent) the
    # K = 5 one, each on the main path's build
    f4, t4, ph4, _ = rann_plan(torch.float32, "euro", sol=solver)
    tangent_device = {
        "k4": device_profile(lambda: assembly.run_phases(
            fused_do.fused_do_loop, f4, ph4, t4))["tangent_kernel_device_ms"],
        "k4_rann": device_profile(lambda: assembly.run_phases(
            fused_do.fused_do_loop, f32, ph32, t32))[
                "tangent_kernel_device_ms"]}
    phase("rann_tangent_time", case="lm60", launches_rann=len(ph32),
          tangent_kernel_device_ms=tangent_device, bound_ms_rann=bound)

    # ---- v0_mode="ad" (ROADMAP A11): the forward-mode kernel with K = 5
    # at lm60's shape, the v0 direction the v-grid's motion through the
    # v0 node's insertion. f64 kernel against plain; the f32 Jacobian's
    # normalized error per column and the v0 column's distance to the
    # surface stencil, printed (no budget exists for them)
    mark("v0_ad_tangent")
    fields, tangents, phases_a, extra = rann_plan(torch.float64, "euro",
                                                  sol=solver, v0_mode="ad")
    got = states(fused_do.fused_do_loop, fields, phases_a, tangents)
    want = states(fused_do.fused_do_reference, fields, phases_a, tangents)
    torch.cuda.synchronize()
    err_k5 = state_err(got[-1], want[-1], False)
    _, jac64_ad = fused_do._read_jacobian(spec, want[-1][0], want[-1][2],
                                          *extra)
    tv32 = torch.tensor(theta, dtype=torch.float32, device=dev)
    reset_counts()
    jac32_ad, _ = calibration.jacobian_and_prices_ad(
        spec, solver, strikes60, 100.0, tv32, p.r_d, p.r_f, v0_mode="ad")
    torch.cuda.synchronize()
    k5_launches = fused_do.fused_do_loop.tangent_launches
    _, jac64_st = fused_do.fused_theta_jacobian(
        spec, solver, strikes60.double(), 100.0, tv32.double(), p.r_d, p.r_f)
    col_rmse = [norm_rmse(jac32_ad[:, k], jac64_ad[:, k]) for k in range(5)]
    f32k5, t32k5, ph32k5, _ = rann_plan(torch.float32, "euro", sol=solver,
                                        v0_mode="ad")
    bitwise_k5 = state_err(states(bitwise_do, f32k5, ph32k5, t32k5)[-1],
                           states(fused_do.fused_do_reference, f32k5,
                                  ph32k5, t32k5)[-1], False)
    jac_diff = (jac32_ad.double() - jac64_ad).cpu()
    timed_k5 = {"max_abs_err": float(jac_diff.abs().max()),
                "rmse_vs_plain_f64": norm_rmse(jac32_ad, jac64_ad),
                "rmse_budget": None}
    v0_gap = (jac64_ad[:, 4] - jac64_st[:, 4]).cpu()
    tangent_device["k5"] = device_profile(lambda: assembly.run_phases(
        fused_do.fused_do_loop, f32k5, ph32k5, t32k5))[
            "tangent_kernel_device_ms"]
    phase("v0_ad_tangent", launches=k5_launches, f64_max_abs=err_k5,
          tangent_kernel_device_ms=tangent_device,
          f64_tol=F64_KERNEL_TOL, f32_jac_norm_rmse_per_column=col_rmse,
          f32_jac=timed_k5, f32_kernel_vs_plain_f32_max_abs=bitwise_k5,
          v0_ad_vs_stencil_f64_max_abs=float(v0_gap.abs().max()),
          v0_ad_vs_stencil_f64_norm_rmse=norm_rmse(jac64_ad[:, 4],
                                                   jac64_st[:, 4]))
    if k5_launches != 1:
        raise AssertionError(f"v0_mode ad: {k5_launches} tangent launches")
    if not err_k5 <= F64_KERNEL_TOL:
        raise AssertionError(f"v0_mode ad: f64 kernel vs plain {err_k5}")
    if not bool(torch.isfinite(jac32_ad).all()):
        raise AssertionError("v0_mode ad: non-finite f32 Jacobian")
    bound, bound_by = pieces_bound(ph32k5, 5, b=60)
    report_k5 = kernel_entry(
        "fused_do_tangent_k5", "fused_do", k5_launches, timed_k5, bitwise_k5,
        cuda_ms(lambda: assembly.run_phases(fused_do.fused_do_loop, f32k5,
                                            ph32k5, t32k5)),
        cuda_ms(lambda: assembly.run_phases(fused_do.fused_do_reference,
                                            f32k5, ph32k5, t32k5), reps=1),
        bound, bound_by)
    mark("eager_engine")
    # ---- the eager ADI loop (models.douglas, "scan" and "pcr": plain
    # tensor ops, no kernel of its own) on the flagship book: B = 500
    # American calls with the golden dividends, 50 x 25 x 20. float64
    # against kernel 1's float64 prices (gated at EAGER_F64_TOL); float32
    # against the engine's own float64 (recorded beside the arm's
    # budget); CUDA-event times beside kernel 1's on the same book; no
    # kernel launch inside the eager calls (gated)
    book64 = torch.linspace(70.0, 130.0, 500, dtype=torch.float64,
                            device=dev)
    kernel64 = heston_tpu_torch.price_batch(spec, solver, book64, 100.0,
                                            *args, **flagship)
    kernel_ms_flag = cuda_ms(lambda: heston_tpu_torch.price_batch(
        spec, solver, book64.float(), 100.0, *args, **flagship), reps=5)
    eager_rows = {}
    for engine in ("scan", "pcr"):
        sol_e = dataclasses.replace(solver, solver_engine=engine)

        def eager(dtype, sol_e=sol_e):
            return heston_tpu_torch.price_batch(
                spec, sol_e, book64.to(dtype), 100.0, *args, **flagship)

        reset_counts()
        e64 = eager(torch.float64)
        e32 = eager(torch.float32)
        torch.cuda.synchronize()
        counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
        err64 = float((e64 - kernel64).abs().max())
        row = dict(f64_vs_kernel1_f64_max_abs=err64,
                   f64_tol=EAGER_F64_TOL,
                   f32_rmse_vs_f64=rmse(e32, e64),
                   f32_budget=ARM_BUDGETS["amer_div"],
                   f32_max_abs_vs_f64=float((e32.double() - e64)
                                            .abs().max()),
                   kernel_launches_in_eager_calls=counts,
                   ms_f32=cuda_ms(lambda: eager(torch.float32), reps=5),
                   ms_f64=cuda_ms(lambda: eager(torch.float64), reps=5))
        prof_e = device_profile(lambda: eager(torch.float32), reps=3)
        row.update(device_kernels_f32=prof_e["device_kernels"],
                   device_busy_ms_f32=prof_e["device_busy_ms"],
                   device_idle_share_f32=1.0 - prof_e["device_busy_ms"]
                   / row["ms_f32"])
        eager_rows[engine] = row
        if counts != (0, 0, 0):
            raise AssertionError(f"eager {engine}: kernel launches "
                                 f"(single, batched, tangent) {counts}")
        if not (bool(torch.isfinite(e32).all()) and err64 <= EAGER_F64_TOL):
            raise AssertionError(f"eager {engine}: f64 vs kernel 1 {err64}")
    phase("eager_engine", batch=500, grid="50x25x20", arm="amer_div",
          kernel1_ms_f32=kernel_ms_flag, **eager_rows)

    mark("host_calibration")
    # ---- the host calibration path: the host LM loop `calibrate` on lm60
    # (bench.py:974-1009), float32, jacobian_mode "ad", solver_engine
    # "pallas": one forward-mode launch of kernel 1 per Jacobian pass,
    # the base and trial prices of the eager loop; the f32 SSE within
    # SSE_REL of a float64 run's; calibrate_device's lm60 run (the
    # calibration section) beside it; one float64 run with the FD
    # Jacobian (the reference's), its SSE within SSE_REL of the AD run's
    market60_host = market60.double().cpu().numpy()

    def targets60(dtype):
        # the strikes' dtype is the fit's
        return calibration.CalibrationTargets(
            strikes=strikes60.to(dtype).cpu().numpy(),
            maturities=np.ones(60), prices=market60_host, s0=100.0,
            r_d=p.r_d, r_f=p.r_f)
    init_p = dataclasses.replace(p, kappa=init[0], eta=init[1],
                                 sigma=init[2], rho=init[3], v0=init[4])

    def host_run(targets, cfg=lm_cfg):
        reset_counts()
        t0 = time.perf_counter()
        res = heston_tpu_torch.calibrate(targets, spec, solver, init_p, cfg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
        return res, wall_ms, counts, res.iterations

    res32, wall32, counts32, passes32 = host_run(targets60(torch.float32))
    res64, wall64, counts64, _ = host_run(targets60(torch.float64))
    res_fd, wall_fd, counts_fd, _ = host_run(
        targets60(torch.float64),
        dataclasses.replace(lm_cfg, jacobian_mode="fd"))
    prof_h = device_profile(lambda: heston_tpu_torch.calibrate(
        targets60(torch.float32), spec, solver, init_p, lm_cfg), reps=2)
    fitted32 = torch.as_tensor(res32.fitted_prices, device=dev)
    iv_host = iv_rmse(fitted32, market60, strikes60, p.r_d, [(0, 60, 1.0)])
    phase("host_calibration", case="lm60", dtype="float32",
          jacobian_mode="ad", iterations=res32.iterations,
          converged=res32.converged, final_sse=res32.final_error,
          iv_rmse=iv_host, iv_rmse_bp=1e4 * iv_host, wall_ms=wall32,
          **prof_h, device_idle_share=1.0 - prof_h["device_busy_ms"]
          / wall32,
          params=list(res32.params.bumpable()),
          tangent_launches=counts32[2], jacobian_passes=passes32,
          primal_launches=counts32[1], single_launches=counts32[0],
          f64=dict(iterations=res64.iterations, final_sse=res64.final_error,
                   wall_ms=wall64, tangent_launches=counts64[2]),
          sse_rel_vs_f64=abs(res32.final_error - res64.final_error)
          / res64.final_error, sse_rel_budget=SSE_REL,
          fd_f64=dict(iterations=res_fd.iterations,
                      final_sse=res_fd.final_error, wall_ms=wall_fd,
                      kernel_launches=counts_fd,
                      sse_rel_vs_ad_f64=abs(res_fd.final_error
                                            - res64.final_error)
                      / res64.final_error),
          calibrate_device_f32=lm60_device,
          tpu_record_jax_round5=TPU_RECORDS["lm60"])
    if counts32[2] != passes32 or counts32[:2] != (0, 0):
        raise AssertionError(f"lm60 calibrate: (single, primal, tangent) "
                             f"launches {counts32}, want (0, 0, "
                             f"{passes32}): one forward-mode launch per "
                             f"Jacobian pass, trial prices eager")
    if not all(np.isfinite(x) for x in (res32.final_error,
                                        *res32.params.bumpable())):
        raise AssertionError("lm60 calibrate: non-finite result")
    for what, sse in (("f32", res32.final_error),
                      ("fd f64", res_fd.final_error)):
        if not abs(sse - res64.final_error) <= SSE_REL * res64.final_error:
            raise AssertionError(f"lm60 calibrate: {what} SSE {sse} vs "
                                 f"the f64 AD run's {res64.final_error}")
    report_tangent["launches_host_calibrate_lm60"] = counts32[2]

    mark("host_calibration_ladder")
    # ---- the 10 x 20 maturity ladder (bench.py:1012-1105) through
    # `calibrate`, float32, "ad": one forward-mode launch per maturity
    # group per pass (gated), the trial prices eager per group
    mats_np = torch.tensor(mats, dtype=torch.float64).repeat_interleave(
        20).numpy()
    targets_l = calibration.CalibrationTargets(
        strikes=ladder.float().cpu().numpy(), maturities=mats_np,
        prices=ladder_market.double().cpu().numpy(), s0=100.0, r_d=p.r_d,
        r_f=p.r_f)
    res_l, wall_l, counts_l, passes_l = host_run(targets_l)
    iv_l = iv_rmse(torch.as_tensor(res_l.fitted_prices, device=dev),
                   ladder_market, ladder, p.r_d,
                   [(a, b, t) for (a, b, _), t in zip(groups, mats)])
    phase("host_calibration_ladder", case="lm_multi200", dtype="float32",
          groups=len(mats), iterations=res_l.iterations,
          converged=res_l.converged, final_sse=res_l.final_error,
          iv_rmse=iv_l, iv_rmse_bp=1e4 * iv_l, wall_ms=wall_l,
          tangent_launches=counts_l[2],
          tangent_launches_per_pass=counts_l[2] / passes_l,
          primal_launches=counts_l[1],
          per_group_fit_pr2=PER_GROUP_FIT["lm_multi200"],
          tpu_record_jax_round5=TPU_RECORDS["lm_multi200"])
    if counts_l[2] != len(mats) * passes_l or counts_l[:2] != (0, 0):
        raise AssertionError(f"ladder calibrate: (single, primal, tangent) "
                             f"launches {counts_l} in {passes_l} passes")
    if not np.isfinite(res_l.final_error):
        raise AssertionError("ladder calibrate: non-finite SSE")

    mark("price_and_greeks")
    # ---- price_and_greeks at the golden option (100 x 75 x 20, central
    # A2, K = 100): the "pallas" branch (one forward-mode launch, delta
    # and the rate rhos off the linearized eager loop) against the "scan"
    # branch (the eager loop linearized in seven inputs), float64, every
    # key at PAG_RTOL / PAG_ATOL; each branch's float32 wall time
    g_spec = GridSpec(m1=100, m2=75)
    g_sol = SolverConfig(n_steps=20, a2_variant="central",
                         solver_engine="pallas")
    pag = {}
    for engine in ("pallas", "scan"):
        sol_g = dataclasses.replace(g_sol, solver_engine=engine)

        def pag_call(dtype, sol_g=sol_g):
            return heston_tpu_torch.price_and_greeks(
                g_spec, sol_g, torch.tensor(100.0, dtype=dtype), 100.0,
                *args)

        reset_counts()
        out = pag_call(torch.float64)
        torch.cuda.synchronize()
        tangent_l = fused_do.fused_do_loop.tangent_launches
        pag[engine] = dict(out=out, tangent_launches=tangent_l,
                           wall_ms_f32=host_ms(lambda: pag_call(
                               torch.float32), reps=2))
    worst = max(float((pag["pallas"]["out"][k] - pag["scan"]["out"][k])
                      .abs() / (PAG_ATOL + PAG_RTOL
                                * pag["scan"]["out"][k].abs()))
                for k in pag["scan"]["out"])
    phase("price_and_greeks", grid="100x75x20", strike=100.0,
          values={k: float(v) for k, v in pag["scan"]["out"].items()},
          max_abs_diff={k: float((pag["pallas"]["out"][k] - v).abs())
                        for k, v in pag["scan"]["out"].items()},
          worst_over_tol=worst, rtol=PAG_RTOL, atol=PAG_ATOL,
          tangent_launches={e: pag[e]["tangent_launches"] for e in pag},
          wall_ms_f32={e: pag[e]["wall_ms_f32"] for e in pag},
          golden_pin=GOLDEN_PIN)
    if set(pag["pallas"]["out"]) != set(pag["scan"]["out"]) or worst > 1.0:
        raise AssertionError(f"price_and_greeks: branches differ ({worst} "
                             f"of the tolerance)")
    if (pag["pallas"]["tangent_launches"], pag["scan"]["tangent_launches"]
            ) != (1, 0):
        raise AssertionError(f"price_and_greeks: tangent launches "
                             f"{pag['pallas']['tangent_launches']}, "
                             f"{pag['scan']['tangent_launches']}")
    if abs(float(pag["scan"]["out"]["price"]) - GOLDEN_PIN) > PIN_TOL:
        raise AssertionError("price_and_greeks: golden price off its pin")

    mark("cf_pricer")
    # ---- the characteristic-function pricer (models.heston_cf: plain
    # torch in complex64 / complex128, no kernel of its own): the lm60
    # chain on the card in float32 and float64 against the CPU's float64,
    # then calibrate_device(pricer="cf") on lm60 in both types: iterations,
    # SSE (float32 within SSE_REL of float64), wall ms; no kernel launched
    # inside (gated)
    from heston_tpu_torch.models import heston_cf

    cf_args = (p.v0, p.kappa, p.eta, p.sigma, p.rho, p.r_d, 1.0)
    cf_cpu64 = heston_cf.price_chain(100.0, strikes60.double().cpu(),
                                     *cf_args, device="cpu")
    cf_rows = {}
    reset_counts()
    for dtype in (torch.float32, torch.float64):
        name = str(dtype).split(".")[-1]
        ks_cf = strikes60.to(dtype)
        chain = heston_cf.price_chain(100.0, ks_cf, *cf_args)
        _, market_cf, _ = lm60(dtype)

        def cf_fit(dtype=dtype, ks_cf=ks_cf, market_cf=market_cf):
            return heston_tpu_torch.calibrate_device(
                spec, solver, ks_cf, market_cf, 100.0,
                torch.tensor(init, dtype=dtype), p.r_d, p.r_f, cfg=lm_cfg,
                pricer="cf")

        tv_cf, info_cf = cf_fit()
        cf_rows[name] = dict(
            chain_max_abs_vs_cpu_f64=float((chain.double().cpu() - cf_cpu64)
                                           .abs().max()),
            chain_ms=cuda_ms(lambda ks_cf=ks_cf: heston_cf.price_chain(
                100.0, ks_cf, *cf_args)),
            iterations=info_cf["iterations"],
            final_sse=float(info_cf["final_error"]), params=tv_cf.tolist(),
            finite=bool(torch.isfinite(chain).all()
                        and torch.isfinite(tv_cf).all()
                        and torch.isfinite(info_cf["final_error"])),
            fit_wall_ms=host_ms(cf_fit, reps=CAL_REPS))
    torch.cuda.synchronize()
    cf_counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
    phase("cf_pricer", case="lm60", n_quad=256, kernel_launches=cf_counts,
          chain_f64_tol=CF_F64_TOL, chain_f32_tol=CF_F32_TOL,
          sse_rel=SSE_REL, **cf_rows)
    sse_cf32, sse_cf64 = (cf_rows[k]["final_sse"] for k in ("float32",
                                                             "float64"))
    if cf_counts != (0, 0, 0):
        raise AssertionError(f"cf_pricer: kernel launches {cf_counts}")
    if not all(r["finite"] for r in cf_rows.values()):
        raise AssertionError("cf_pricer: non-finite output")
    if not (cf_rows["float64"]["chain_max_abs_vs_cpu_f64"] <= CF_F64_TOL
            and cf_rows["float32"]["chain_max_abs_vs_cpu_f64"]
            <= CF_F32_TOL):
        raise AssertionError(f"cf_pricer: chain against the CPU {cf_rows}")
    if not abs(sse_cf32 - sse_cf64) <= SSE_REL * sse_cf64:
        raise AssertionError(f"cf_pricer: f32 SSE {sse_cf32} vs f64 "
                             f"{sse_cf64}")

    mark("native_engine")
    # ---- the native OpenMP engine (utils.native over csrc/heston_cpu.cpp,
    # float64 on the host) on the flagship book, within EAGER_F64_TOL of
    # kernel 1's float64 prices (eager_engine's kernel64); its wall time
    # (host clock, median of 5 after a warm-up) and thread count beside
    # kernel 1's call on the same book (CUDA events)
    from heston_tpu_torch.utils import native

    t0 = time.perf_counter()
    native.load()
    native_build_s = time.perf_counter() - t0
    book_np = book64.cpu().numpy()

    def native_call():
        return native.price_batch_cpu(spec, solver, book_np, 100.0, *args,
                                      **flagship)

    reset_counts()
    cpu_prices = torch.as_tensor(native_call())
    native_counts = (*launch_counts(),
                     fused_do.fused_do_loop.tangent_launches)
    native_err = float((cpu_prices - kernel64.cpu()).abs().max())
    native_times = []
    for _ in range(5):
        t0 = time.perf_counter()
        native_call()
        native_times.append(1e3 * (time.perf_counter() - t0))
    native_ms = statistics.median(native_times)
    kernel_ms_f64 = cuda_ms(lambda: heston_tpu_torch.price_batch(
        spec, solver, book64, 100.0, *args, **flagship), reps=5)
    phase("native_engine", batch=500, grid="50x25x20", arm="amer_div",
          omp_threads=native.omp_threads(), build_s=native_build_s,
          flags=list(native.cxx_flags()), cxx_env=os.environ.get("CXX"),
          f64_vs_kernel1_f64_max_abs=native_err, f64_tol=EAGER_F64_TOL,
          native_ms_f64=native_ms, kernel1_ms_f32=kernel_ms_flag,
          kernel1_ms_f64=kernel_ms_f64,
          native_over_kernel1_f32=native_ms / kernel_ms_flag,
          native_over_kernel1_f64=native_ms / kernel_ms_f64,
          kernel_launches_in_native_call=native_counts)
    if not native_err <= EAGER_F64_TOL:
        raise AssertionError(f"native_engine: f64 vs kernel 1 {native_err}")
    if native_counts != (0, 0, 0):
        raise AssertionError(f"native_engine: kernel launches "
                             f"{native_counts}")

    mark("scenarios")
    # ---- the reference's calibration scenarios through run_scenario with
    # the device loop (calibrate_device on kernel 1: one forward-mode and
    # one primal launch an iteration in float32, gated), european and
    # american_dividends (60 strikes, 50 x 25 x 20), float32 ("ad")
    # against float64 (the FD Jacobian, as the JAX package with x64):
    # iterations, SSE (float32 within SSE_REL of float64), wall seconds
    sc_solver = dataclasses.replace(solver, solver_engine="pallas")
    sc_rows = {}
    for name in ("european", "american_dividends"):
        row = {}
        for dtype in (torch.float32, torch.float64):
            reset_counts()
            res, wall_sc = heston_tpu_torch.run_scenario(
                name, spec=spec, solver=sc_solver, verbose=False,
                device_loop=True, dtype=dtype)
            torch.cuda.synchronize()
            key = str(dtype).split(".")[-1]
            row[key] = dict(
                iterations=res.iterations, final_sse=res.final_error,
                params=list(res.params.bumpable()), wall_s=wall_sc,
                launches=dict(zip(("single", "primal", "tangent"), (
                    *launch_counts(),
                    fused_do.fused_do_loop.tangent_launches))))
        sc_rows[name] = row
    phase("scenarios", device_loop=True, sse_rel=SSE_REL, **sc_rows)
    for name, row in sc_rows.items():
        f32, f64 = row["float32"], row["float64"]
        if not all(np.isfinite(x) for r in (f32, f64)
                   for x in (r["final_sse"], *r["params"])):
            raise AssertionError(f"scenario {name}: non-finite fit")
        if not abs(f32["final_sse"] - f64["final_sse"]) <= (
                SSE_REL * f64["final_sse"]):
            raise AssertionError(f"scenario {name}: f32 SSE "
                                 f"{f32['final_sse']} vs f64 "
                                 f"{f64['final_sse']}")
        n = f32["iterations"]
        if f32["launches"] != dict(single=0, primal=n, tangent=n):
            raise AssertionError(f"scenario {name}: launches "
                                 f"{f32['launches']} in {n} iterations")
    mark("bench")
    # ---- the port's bench in a process of its own (python -m
    # heston_tpu_torch.bench, the JAX bench's stages on the card): its
    # last line parses, every selftest arm is within its budget, every
    # timed output is finite and it exits 0
    from heston_tpu_torch import bench as port_bench

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "heston_tpu_torch.bench"],
        cwd=str(Path(__file__).resolve().parent), capture_output=True,
        text=True, timeout=BENCH_TIMEOUT_S)
    bench_wall = time.perf_counter() - t0
    try:
        last = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError) as exc:
        raise AssertionError(f"bench: no parseable last line ({exc}); rc "
                             f"{proc.returncode}\n{proc.stderr[-4000:]}")
    stage_walls = {k: v for k, v in last.items() if k.endswith("_wall_s")}
    phase("bench", rc=proc.returncode, wall_s=bench_wall,
          metric=last.get("metric"), value=last.get("value"),
          vs_baseline=last.get("vs_baseline"),
          baseline_s=port_bench.BASELINE_SECONDS,
          selftest_arms_run=last.get("selftest_arms_run"),
          selftest_rmse_max=last.get("selftest_rmse_max"),
          selftest_arms_over_budget=last.get("selftest_arms_over_budget"),
          nonfinite_outputs=last.get("nonfinite_outputs"),
          stage_walls=stage_walls, nvidia_smi=last.get("nvidia_smi"))
    print(json.dumps({"bench_last_line": last}), flush=True)
    if not (proc.returncode == 0 and last.get("ok") is True
            and last.get("selftest_arms_over_budget") == []
            and last.get("nonfinite_outputs") == []
            and last.get("selftest_arms_run")
            == len(port_bench.SELFTEST_BUDGET)
            and isinstance(last.get("value"), float)):
        raise AssertionError(f"bench: rc {proc.returncode}, ok "
                             f"{last.get('ok')}\n{proc.stderr[-4000:]}")

    mark("mc")
    # ---- the Monte Carlo oracle (models.mc: plain tensor ops, no kernel
    # of its own) at HestonParams' defaults, S0 = K = 100, T = 1, from a
    # seeded generator on the card: the European call, 100,000 paths x
    # 350 steps, truncation, within max(4 half-widths, 0.15) of the
    # golden (tests/test_oracles.py:84-92); QE at 16 steps within its
    # half-width of the CF price; knock-in + knock-out = vanilla on an
    # up-out at 130 (f64 1e-12 absolute, f32 MC_F32_PARITY_REL); the LSMC
    # American put, 100,000 x 50, within 2 half-widths + 0.08 of kernel
    # 1's American put at 100 x 50 x 80 (tests/test_oracles.py:95-115);
    # the LSMC American call with the golden dividends, 600,000 x 100,
    # antithetic, half-width <= 0.014 and within 2 half-widths + 0.02 of
    # the golden (:171-190) in float64, as the test runs, and the float32
    # run within MC_F32_LSMC_GAP of the float64 one. Each in float32 and
    # float64; no host sync in any call, the first included
    # (torch.cuda.set_sync_debug_mode), and no kernel launch (gated);
    # CUDA-event times, median of MC_REPS
    import warnings

    from heston_tpu_torch.models import douglas, heston_cf, mc

    def mc_args(dtype, strike=100.0):
        return (100.0, p.v0, torch.tensor(strike, dtype=dtype, device=dev),
                p.r_d, p.r_f, p.kappa, p.eta, p.sigma, p.rho, 1.0)

    def host_syncs(fn):
        """fn() under the sync debug mode "warn": (its result, the number
        of host synchronizations it made)."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out_ = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # "called a synchronizing CUDA operation" (not the notice that
        # the mode is a prototype)
        return out_, [f"{w.filename}:{w.lineno}: {w.message}"
                      for w in caught
                      if "called a synchronizing" in str(w.message)]

    def mc_run(fn):
        (price, half), syncs = host_syncs(fn)     # the first call
        return dict(price=float(price), half_width=float(half),
                    host_syncs=len(syncs), sync_sites=syncs[:3],
                    ms=cuda_ms(fn, reps=MC_REPS))

    cf_call = float(heston_cf.price_chain(
        100.0, torch.tensor([100.0], dtype=torch.float64, device=dev),
        p.v0, p.kappa, p.eta, p.sigma, p.rho, p.r_d, 1.0)[0])
    pde_put = float(heston_tpu_torch.price_batch(
        GridSpec(m1=100, m2=50), SolverConfig(n_steps=80,
                                              solver_engine="pallas"),
        torch.tensor([90.0, 100.0, 110.0], dtype=torch.float64, device=dev),
        100.0, *args, american=True, option_type="put")[1])
    # a control: one read of a value on the card counts as a sync
    _, control = host_syncs(lambda: float(torch.ones(2, device=dev).sum()))
    mc_rows, mc_fail = {}, [] if control else ["sync detection"]
    reset_counts()
    for dtype in (torch.float32, torch.float64):
        key = str(dtype).split(".")[-1]
        # the strike on the card before the calls: a copy from the host
        # would count as a sync
        margs = mc_args(dtype)
        euro = mc_run(lambda margs=margs: mc.price_european_call_mc(
            torch.Generator(device=dev).manual_seed(7), *margs,
            num_paths=100_000, n_steps=350, scheme="truncation"))
        qe = mc_run(lambda margs=margs: mc.price_european_call_mc(
            torch.Generator(device=dev).manual_seed(11), *margs,
            num_paths=100_000, n_steps=16, scheme="qe"))
        legs = {}
        for leg, kw in (("knock_out", dict(barrier=Barrier("up-out", 130.0))),
                        ("knock_in", dict(barrier=Barrier("up-out", 130.0),
                                          knock_in=True)),
                        ("vanilla", {})):
            legs[leg] = float(mc.price_european_call_mc(
                torch.Generator(device=dev).manual_seed(5), *margs,
                num_paths=100_000, n_steps=350, scheme="truncation",
                **kw)[0])
        parity = abs(legs["knock_in"] + legs["knock_out"] - legs["vanilla"])
        put = mc_run(lambda margs=margs: mc.price_american_lsmc(
            torch.Generator(device=dev).manual_seed(0), *margs,
            num_paths=100_000, n_steps=50))
        amer_div = mc_run(lambda margs=margs: mc.price_american_lsmc(
            torch.Generator(device=dev).manual_seed(0), *margs,
            num_paths=600_000, n_steps=100, option_type="call",
            dividends=GOLDEN_DIVIDENDS, antithetic=True))
        mc_rows[key] = dict(euro_100k_x350=euro, qe_100k_x16=qe,
                            in_out_legs=legs, in_out_parity_abs=parity,
                            lsmc_put_100k_x50=put,
                            lsmc_amer_div_call_600k_x100=amer_div)
        checks = {
            "euro": abs(euro["price"] - MC_GOLDEN)
            <= max(4.0 * euro["half_width"], 0.15),
            "qe": abs(qe["price"] - cf_call) <= qe["half_width"],
            "lsmc_put": abs(put["price"] - pde_put)
            <= 2.0 * put["half_width"] + 0.08,
            # the oracle test runs under x64: float32 is held against
            # float64 below
            "lsmc_amer_div": dtype == torch.float32
            or (amer_div["half_width"] <= 0.014
                and abs(amer_div["price"] - MC_AMER_DIV_GOLDEN)
                <= 2.0 * amer_div["half_width"] + 0.02),
            "in_out": parity <= (MC_F32_PARITY_REL * legs["vanilla"]
                                 if dtype == torch.float32 else 1e-12),
            "no_host_syncs": all(r["host_syncs"] == 0
                                 for r in (euro, qe, put, amer_div))}
        mc_fail += [f"{key}:{k}" for k, ok in checks.items() if not ok]
    lsmc_gap = abs(mc_rows["float32"]["lsmc_amer_div_call_600k_x100"]["price"]
                   - mc_rows["float64"]["lsmc_amer_div_call_600k_x100"]
                   ["price"])
    if not lsmc_gap <= MC_F32_LSMC_GAP:
        mc_fail.append("float32:lsmc_amer_div_vs_float64")
    torch.cuda.synchronize()
    mc_counts = (*launch_counts(), fused_do.fused_do_loop.tangent_launches)
    phase("mc", cf_call=cf_call, golden=MC_GOLDEN,
          control_syncs=len(control), golden_amer_div=MC_AMER_DIV_GOLDEN,
          kernel1_american_put=pde_put, kernel_launches=mc_counts,
          lsmc_amer_div_f32_vs_f64_abs=lsmc_gap,
          failed=mc_fail, **mc_rows)
    if mc_fail or mc_counts != (0, 0, 0):
        raise AssertionError(f"mc: failed {mc_fail}, kernel launches "
                             f"{mc_counts}")

    mark("sharded")
    # ---- option-book sharding (parallel) over torch.distributed: world 1
    # under NCCL in this process, then world 2 under gloo in two spawned
    # processes on this card. The flagship book through
    # price_batch_sharded against price_batch (f64 within SHARD_F64_TOL,
    # f32 within the flagship arm's budget of the f64 plain version),
    # book_risk500 through batch_greeks_sharded, lm60's AD normal
    # equations against the dense step, calibrate_sharded on lm_multi200
    # (SSE within SHARD_SSE_REL of calibrate_device's). Kernel launches:
    # one primal launch per rank per book, one forward-mode launch per
    # rank per pass (gated)
    import multiprocessing
    import tempfile

    import torch.distributed as dist

    from heston_tpu_torch import parallel as par

    par.ensure_distributed(dev, init_method=f"tcp://localhost:{free_port()}",
                           world_size=1, rank=0)
    mesh = par.make_mesh(dev)
    tv_def = torch.tensor(p.bumpable(), dtype=torch.float64)

    def counted(fn):
        reset_counts()
        out_ = fn()
        torch.cuda.synchronize()
        return out_, (*launch_counts(),
                      fused_do.fused_do_loop.tangent_launches)

    book = {dt: torch.linspace(70.0, 130.0, 500, dtype=dt, device=dev)
            for dt in (torch.float32, torch.float64)}

    def flag_sharded(dtype):
        return par.price_batch_sharded(mesh, spec, solver, book[dtype],
                                       100.0, tv_def, p.r_d, p.r_f,
                                       **flagship)

    def flag_single(dtype):
        return heston_tpu_torch.price_batch(spec, solver, book[dtype], 100.0,
                                            *args, **flagship)

    sh64, c64 = counted(lambda: flag_sharded(torch.float64))
    sh32, c32 = counted(lambda: flag_sharded(torch.float32))
    one64 = flag_single(torch.float64)
    flag_err = float((sh64 - one64).abs().max())
    flag_rmse = rmse(sh32, one64)
    risk_sh, c_risk = counted(lambda: par.batch_greeks_sharded(
        mesh, spec, solver, book[torch.float64], 100.0, tv_def, p.r_d,
        p.r_f, **flagship))
    risk_one = heston_tpu_torch.batch_greeks(spec, solver, book[torch.float64],
                                             100.0, *args, **flagship)
    risk_err = max(max_rel(risk_sh[k], risk_one[k])
                   for k in heston_tpu_torch.RISK_KEYS)
    ks60_64 = strikes60.double()
    market60_64 = bs.generate_market_data(100.0, 1.0, p.r_d, ks60_64)
    tv_init64 = torch.tensor(LM_INIT, dtype=torch.float64, device=dev)
    (d_sh, base_sh, sse_sh), c_ne = counted(
        lambda: par.jacobian_normal_eq_sharded(
            mesh, spec, solver, ks60_64, market60_64, 100.0, tv_init64,
            p.r_d, p.r_f, 0.01, jacobian_mode="ad"))
    jac_d, base_d = calibration.jacobian_and_prices_ad(
        spec, solver, ks60_64, 100.0, tv_init64, p.r_d, p.r_f)
    d_dense = calibration.lm_update(jac_d, market60_64 - base_d, 0.01)
    ne_err = dict(delta_rel=max_rel(d_sh, d_dense),
                  base_max_abs=float((base_sh - base_d).abs().max()),
                  sse_rel=abs(float(sse_sh) - float(((market60_64 - base_d)
                                                     ** 2).sum()))
                  / float(sse_sh))
    lad_ks, lad_market, lad_groups = lm_multi200(dev, torch.float32)
    t0 = time.perf_counter()
    (tv_sh, info_sh), c_cal = counted(lambda: par.calibrate_sharded(
        mesh, spec, solver, lad_ks, lad_market, 100.0, torch.tensor(LM_INIT),
        p.r_d, p.r_f, cfg=lm_cfg, group_steps=lad_groups))
    cal_sh_ms = 1e3 * (time.perf_counter() - t0)
    trials = sum("new_sse" in h for h in info_sh["history"])
    tv_dev, info_dev = heston_tpu_torch.calibrate_device(
        spec, solver, lad_ks, lad_market, 100.0, torch.tensor(LM_INIT),
        p.r_d, p.r_f, cfg=lm_cfg, group_steps=lad_groups)
    sse_dev = float(info_dev["final_error"])
    world1 = dict(
        backend=dist.get_backend(), world_size=mesh.size,
        flagship=dict(f64_vs_price_batch_max_abs=flag_err,
                      f32_rmse_vs_f64=flag_rmse, f32_budget=MAIN_RMSE,
                      launches_f64=c64, launches_f32=c32,
                      sharded_ms_f32=host_ms(lambda: flag_sharded(
                          torch.float32), reps=5),
                      single_ms_f32=host_ms(lambda: flag_single(
                          torch.float32), reps=5)),
        book_risk500=dict(f64_vs_batch_greeks_max_rel=risk_err,
                          launches=c_risk),
        lm60_normal_eq=dict(ne_err, launches=c_ne),
        lm_multi200=dict(iterations=info_sh["iterations"],
                         final_sse=info_sh["final_error"],
                         calibrate_device_sse=sse_dev,
                         calibrate_host_sse=res_l.final_error,
                         sse_rel_vs_device=abs(info_sh["final_error"]
                                               - sse_dev) / sse_dev,
                         wall_ms=cal_sh_ms, launches=c_cal, trials=trials,
                         params=tv_sh.tolist()))
    dist.destroy_process_group()
    # world 2: two spawned ranks under gloo, both on this card
    out_dir = Path(tempfile.mkdtemp(prefix="chip_smoke_gloo_"))
    port = free_port()
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    ranks = [ctx.Process(target=gloo_rank, args=(r, 2, port, str(out_dir)))
             for r in range(2)]
    for proc in ranks:
        proc.start()
    for proc in ranks:
        proc.join(300)
    world2_s = time.perf_counter() - t0
    for proc in ranks:
        if proc.is_alive():
            proc.kill()
    got2 = [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            if (out_dir / f"rank{r}.pt").exists() else {"traceback": "none"}
            for r in range(2)]
    world2 = {"wall_s": world2_s}
    w2_fail = [f"rank{r}: {g['traceback']}" for r, g in enumerate(got2)
               if "traceback" in g]
    if not w2_fail:
        r0 = got2[0]
        world2.update(
            backend=r0["backend"],
            f64_vs_world1_max_abs=float(
                (r0["torch.float64"]["prices"] - sh64.cpu()).abs().max()),
            f32_rmse_vs_f64=rmse(r0["torch.float32"]["prices"], one64.cpu()),
            ranks_equal=all(torch.equal(g[k]["prices"], r0[k]["prices"])
                            for g in got2 for k in ("torch.float64",
                                                    "torch.float32")),
            launches_per_rank={r: {k: g[k]["launches"] for k in
                                   ("torch.float64", "torch.float32",
                                    "lm_multi200")}
                               for r, g in enumerate(got2)},
            flagship_wall_ms_f32=[g["torch.float32"]["wall_ms"]
                                  for g in got2],
            lm_multi200=dict(r0["lm_multi200"], sse_rel_vs_device=abs(
                r0["lm_multi200"]["final_sse"] - sse_dev) / sse_dev))
    phase("sharded", case="flagship B=500, book_risk500, lm60, lm_multi200",
          world1=world1, world2=world2, f64_tol=SHARD_F64_TOL,
          normal_eq_tol=SHARD_NORMAL_EQ_TOL, sse_rel=SHARD_SSE_REL)
    sh_fail = list(w2_fail)
    if not (flag_err <= SHARD_F64_TOL and flag_rmse <= MAIN_RMSE
            and risk_err <= SHARD_F64_TOL):
        sh_fail.append("world 1: flagship or risk off the single device")
    if not (ne_err["delta_rel"] <= SHARD_NORMAL_EQ_TOL
            and ne_err["base_max_abs"] <= SHARD_F64_TOL
            and ne_err["sse_rel"] <= SHARD_F64_TOL):
        sh_fail.append(f"world 1: lm60 normal equations {ne_err}")
    if (c64, c32, c_risk, c_ne) != ((0, 1, 0),) * 3 + ((0, 0, 1),):
        sh_fail.append(f"world 1: launches {(c64, c32, c_risk, c_ne)}")
    n_pass = info_sh["iterations"]
    if c_cal != (0, trials, n_pass) or not abs(
            info_sh["final_error"] - sse_dev) <= SHARD_SSE_REL * sse_dev:
        sh_fail.append(f"world 1: lm_multi200 launches {c_cal} in "
                       f"{n_pass} passes / {trials} trials, SSE "
                       f"{info_sh['final_error']} vs {sse_dev}")
    if not w2_fail:
        cal2 = world2["lm_multi200"]
        if not (world2["f64_vs_world1_max_abs"] <= SHARD_F64_TOL
                and world2["f32_rmse_vs_f64"] <= MAIN_RMSE
                and world2["ranks_equal"]):
            sh_fail.append("world 2: flagship off world 1")
        for g in got2:
            want = ((0, 1, 0),) * 2 + ((0, g["lm_multi200"]["trials"],
                                        g["lm_multi200"]["iterations"]),)
            got_c = tuple(g[k]["launches"] for k in (
                "torch.float64", "torch.float32", "lm_multi200"))
            if got_c != want:
                sh_fail.append(f"world 2: launches {got_c}, want {want}")
        if not cal2["sse_rel_vs_device"] <= SHARD_SSE_REL:
            sh_fail.append(f"world 2: lm_multi200 SSE {cal2['final_sse']}")
    if sh_fail:
        raise AssertionError(f"sharded: {sh_fail}")
    report["launches_sharded_flagship_per_rank"] = c32[1]
    report_tangent["launches_sharded_lm_multi200"] = c_cal[2]

    mark("cli")
    # ---- the command line (python -m heston_tpu_torch.cli) in
    # subprocesses, all started together with the examples (the walls
    # below are of processes that share the card and the host's cores),
    # float64: each must exit 0 and print JSON that parses, and each
    # number agree with the in-process entry point within CLI_TOL;
    # kernel launches of the in-process calls
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_cli_"))
    f64 = torch.float64
    book500 = torch.linspace(70.0, 130.0, 500, dtype=f64)
    ks60 = torch.arange(70.0, 130.0, dtype=f64)
    iv_ks = torch.tensor([90.0, 110.0], dtype=f64)
    iv_px = bs.generate_market_data(100.0, 1.0, p.r_d, iv_ks)
    golden_sol = SolverConfig(n_steps=20, a2_variant="central")

    def floats(x):
        return [repr(float(v)) for v in x]

    cli_argv = {
        "price_flagship": ["price", "--strikes", *floats(book500),
                           "--american", "--dividends", "golden",
                           "--engine", "pallas"],
        "price_golden_single": ["price", "--strikes", "100", "--m1", "100",
                                "--m2", "75", "--a2-variant", "central",
                                "--engine", "pallas"],
        "risk": ["risk", "--strikes", *floats(ks60), "--american",
                 "--dividends", "golden", "--engine", "pallas",
                 "--param-jacobian"],
        "calibrate": ["calibrate", "european"],
        "calibrate_device_loop": ["calibrate", "european", "--device-loop"],
        "calibrate_sharded": ["calibrate", "european", "--sharded"],
        "mc": ["mc", "--paths", "100000"],
        "surface": ["surface", "--m1", "100", "--m2", "75", "--a2-variant",
                    "central", "--csv", str(tmp / "surface.csv")],
        "iv": ["iv", "--strikes", *floats(iv_ks), "--prices",
               *floats(iv_px)],
        "greeks": ["greeks"],
    }
    commands = {k: ["-c", CLI_COUNTED, *v, "--float64"]
                for k, v in cli_argv.items()}
    commands["example_quickstart"] = [
        "-m", "heston_tpu_torch.examples.quickstart", "--csv",
        str(tmp / "fit.csv")]
    commands["example_distributed"] = [
        "-m", "heston_tpu_torch.examples.distributed"]

    def run_cli(argv):
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, *argv], capture_output=True, text=True,
                timeout=CLI_TIMEOUT_S,
                cwd=str(Path(__file__).resolve().parent))
            return proc.returncode, proc.stdout, proc.stderr, \
                time.perf_counter() - t0
        except subprocess.TimeoutExpired as exc:
            return "timeout", str(exc.stdout), str(exc.stderr), \
                time.perf_counter() - t0

    pool = ThreadPoolExecutor(len(commands))
    futures = {k: pool.submit(run_cli, v) for k, v in commands.items()}
    # the in-process entry points, while the subprocesses run
    g_spec = GridSpec(m1=100, m2=75)
    ref = {}
    ref["price_flagship"] = counted(lambda: heston_tpu_torch.price_batch(
        spec, solver, book500.to(dev), 100.0, *args, **flagship))
    ref["price_golden_single"] = counted(lambda: heston_tpu_torch.price_batch(
        g_spec, dataclasses.replace(golden_sol, solver_engine="pallas"),
        torch.tensor([100.0], dtype=f64, device=dev), 100.0, *args))
    ref["risk"] = counted(lambda: heston_tpu_torch.batch_greeks(
        spec, solver, ks60.to(dev), 100.0, *args, **flagship,
        param_jacobian=True))
    for key, loop in (("calibrate", False), ("calibrate_device_loop", True)):
        ref[key] = counted(lambda loop=loop: heston_tpu_torch.run_scenario(
            "european", spec=spec, solver=SolverConfig(n_steps=20),
            init=HestonParams(), steps_per_year=20, verbose=False,
            device_loop=loop, dtype=f64)[0])
    # the world of one's sharded path runs the plain path's arithmetic
    ref["calibrate_sharded"] = ref["calibrate"]
    ref["mc"] = counted(lambda: mc.price_european_call_mc(
        torch.Generator(device=dev).manual_seed(0), 100.0, p.v0,
        torch.tensor(100.0, dtype=f64, device=dev), p.r_d, p.r_f, p.kappa,
        p.eta, p.sigma, p.rho, 1.0, num_paths=100_000, n_steps=350))
    ref["surface"] = counted(lambda: douglas.price_surface(
        g_spec, golden_sol, torch.tensor(100.0, dtype=f64, device=dev),
        100.0, HestonParams())[0][0])
    ref["iv"] = counted(lambda: bs.implied_vol_chain(
        iv_px.to(dev), 100.0, iv_ks.to(dev), p.r_d, 1.0))

    def greeks_ref():
        sol = SolverConfig(n_steps=20)
        out_ = dict(heston_tpu_torch.price_and_greeks(
            spec, sol, torch.tensor(100.0, dtype=f64, device=dev), 100.0,
            *args))
        risk = heston_tpu_torch.batch_greeks(
            spec, sol, torch.tensor([100.0], dtype=f64, device=dev), 100.0,
            *args)
        out_.update(gamma=risk["gamma"][0], theta=risk["theta"][0])
        return out_

    ref["greeks"] = counted(greeks_ref)
    results = {k: f.result() for k, f in futures.items()}
    pool.shutdown()

    def rel_err(got, want):
        return abs(got - want) / max(1.0, abs(want))

    def cli_err(key, lines):
        """The largest relative difference of the command's numbers from
        the in-process call's."""
        want, _ = ref[key]
        if key.startswith("price"):
            return max(rel_err(r["price"], float(w))
                       for r, w in zip(lines, want.tolist(), strict=True))
        if key == "risk":
            cols = {k: want[k].tolist() for k in heston_tpu_torch.RISK_KEYS}
            for i, name in enumerate(("d_kappa", "d_eta", "d_sigma", "d_rho",
                                      "d_v0")):
                cols[name] = want["param_jacobian"][:, i].tolist()
            return max(rel_err(r[k], cols[k][i])
                       for i, r in enumerate(lines) for k in cols)
        if key.startswith("calibrate"):
            (r,) = lines
            if r["iterations"] != want.iterations:
                return float("inf")
            return max(rel_err(r["sse"], want.final_error),
                       *(rel_err(r["params"][k], v) for k, v in zip(
                           ("kappa", "eta", "sigma", "rho", "v0"),
                           want.params.bumpable())))
        if key == "mc":
            (r,) = lines
            return max(rel_err(r["price"], float(want[0])),
                       rel_err(r["ci95_half_width"], float(want[1])))
        if key == "surface":
            # after the "# metadata" and "s,v,price" lines (the first s
            # node may print as a tiny negative)
            rows = (tmp / "surface.csv").read_text().splitlines()[2:]
            got_u = torch.tensor([float(row.split(",")[2]) for row in rows],
                                 dtype=f64)
            return max(float((got_u - want.T.reshape(-1).cpu()).abs()
                             .max()), 0.0) if len(rows) == want.numel() \
                else float("inf")
        if key == "iv":
            return max(rel_err(r["implied_vol"], float(w))
                       for r, w in zip(lines, want.tolist(), strict=True))
        (r,) = lines
        return max(rel_err(r[k], float(v)) for k, v in want.items())

    cli_rows, cli_fail = {}, []
    for key in cli_argv:
        rc, out_, err_, wall_s = results[key]
        counts = [json.loads(line.split(" ", 1)[1])
                  for line in err_.splitlines()
                  if line.startswith("CLI_LAUNCHES ")]
        row = dict(rc=rc, wall_s=wall_s,
                   launches=tuple(counts[-1]) if counts else None,
                   launches_in_process=ref[key][1])
        try:
            lines = [json.loads(line) for line in out_.splitlines()
                     if line.startswith("{")]
            row["max_rel_err"] = cli_err(key, lines)
        except (ValueError, KeyError, TypeError) as exc:
            row["max_rel_err"] = None
            row["error"] = repr(exc)
        # the CLI's own launches: those of the in-process call
        if rc != 0 or row["max_rel_err"] is None \
                or not row["max_rel_err"] <= CLI_TOL \
                or row["launches"] != row["launches_in_process"]:
            row["stderr_tail"] = err_[-2000:]
            cli_fail.append(key)
        cli_rows[key] = row
    phase("cli", float64=True, tol=CLI_TOL, concurrent_processes=len(
        commands), failed=cli_fail, **cli_rows)
    if cli_fail:
        raise AssertionError(f"cli: {cli_fail}")
    # the CLI's price and risk reach their kernels (its calibrate and
    # greeks run the "xla" engine by default, as the JAX CLI's do)
    if not (cli_rows["price_flagship"]["launches"][1] >= 1
            and cli_rows["price_golden_single"]["launches"][0] >= 1
            and min(cli_rows["risk"]["launches"][1:]) >= 1):
        raise AssertionError("cli: price or risk launched no kernel")
    report["launches_cli_price_flagship"] = \
        cli_rows["price_flagship"]["launches"][1]
    report_single["launches_cli_price_golden"] = \
        cli_rows["price_golden_single"]["launches"][0]
    report_tangent["launches_cli_risk60"] = cli_rows["risk"]["launches"][2]

    mark("examples")
    # ---- the worked examples (python -m), run with the CLI above: exit 0
    # and their last lines
    ex_rows = {}
    for key in ("example_quickstart", "example_distributed"):
        rc, out_, err_, wall_s = results[key]
        ex_rows[key] = dict(rc=rc, wall_s=wall_s,
                            last_lines=out_.strip().splitlines()[-2:],
                            stderr_tail=err_[-2000:] if rc != 0 else "")
    phase("examples", **ex_rows)
    if any(r["rc"] != 0 for r in ex_rows.values()):
        raise AssertionError(f"examples: {ex_rows}")

    mark()

    print(json.dumps({"kernels": [report, report_tangent, report_single,
                                  report_plan, report_book_plan,
                                  report_tangent_rows,
                                  report_lane, *reports_batch,
                                  report_tangent_cs, *reports_single,
                                  *reports_payoff, report_curve,
                                  report_rann, report_k5]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Benchmark sweeps mirroring the reference's performance tests (PyTorch
port of `heston_tpu.benchmarks`).

The reference sweeps batch sizes {1, 10, 20, 50, 100, 200, 300, 500} at
m1=50, m2=25, N=20 with 10 timed runs and writes a CSV with total runtime
/ runtime per instance / throughput (ref: src/perfomance_test.cpp:
20-231). Here the same sweep runs the batched kernel (engine "pallas"),
the eager loop ("scan", "pcr") or the native OpenMP engine ("cpu"), timed
per call on the card with CUDA events around chained repetitions.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Optional, Sequence

import numpy as np
import torch

from heston_tpu_torch.config import (GOLDEN_DIVIDENDS, DividendSchedule,
                                     GridSpec, HestonParams, SolverConfig)
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import douglas
from heston_tpu_torch.utils import io as hio

DEFAULT_INSTANCES = (1, 10, 20, 50, 100, 200, 300, 500)
ENGINES = ("cpu", "pallas", "scan", "pcr")


def timed_scan(fn, example: torch.Tensor, reps: int = 200,
               samples: int = 5) -> float:
    """Median seconds per call of `fn(example)`: `reps` calls chained so
    that each input depends on the previous call's output (nothing can be
    skipped or reordered), as the JAX package's lax.scan chains them
    (heston_tpu/benchmarks.py:32-67), after one warm-up run of the chain;
    `samples` timed chains. On the card each chain is timed by CUDA
    events, on the CPU by the host clock."""
    def run_many(x):
        carry = torch.zeros((), dtype=x.dtype, device=x.device)
        for i in range(reps):
            out = fn(x * (1.0 + (i + carry) * 1e-7))
            carry = (out.reshape(-1)[0] * 1e-12).to(x.dtype)
        return carry

    cuda = example.device.type == "cuda"
    run_many(example)
    if cuda:
        torch.cuda.synchronize(example.device)
    times = []
    for _ in range(samples):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run_many(example)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop) / 1e3 / reps)
        else:
            t0 = time.perf_counter()
            run_many(example)
            times.append((time.perf_counter() - t0) / reps)
    return float(statistics.median(times))


def device_name(dev: torch.device) -> str:
    """The card's name for a CUDA device, else the device type."""
    if dev.type == "cuda":
        return torch.cuda.get_device_name(dev)
    return dev.type


def run_sweep(
    spec: GridSpec = GridSpec(m1=50, m2=25),
    solver: SolverConfig = SolverConfig(n_steps=20),
    params: HestonParams = HestonParams(),
    instances: Sequence[int] = DEFAULT_INSTANCES,
    american: bool = True,
    dividends: Optional[DividendSchedule] = GOLDEN_DIVIDENDS,
    engine: str = "pallas",
    dtype=torch.float32,
    csv_path: Optional[str] = None,
    reps: int = 200,
    samples: int = 5,
    device=None,
):
    """Rows (m1, m2, n_steps, instances, total_runtime_s, device) of the
    batch-size sweep; optionally the reference-format CSV (ref:
    src/perfomance_test.cpp:214-221). engine "pallas": the batched kernel
    (`fused_do.fused_price_batch`); "scan"/"pcr": `douglas.price_batch`
    on the eager loop; both timed by `timed_scan` on `device` (None: the
    card), `device` in the rows the card's name. "cpu": the native OpenMP
    engine (`utils.native.price_batch_cpu`, float64; `reps`, `dtype` and
    `device` do not apply), host wall time per call, median of `samples`
    after a warm-up, `device` "cpu-omp-<threads>t"."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{ENGINES}")
    p = params
    args = (100.0, p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d, p.r_f)
    kw = dict(american=american, dividends=dividends)
    rows = []
    if engine == "cpu":
        from heston_tpu_torch.utils import native

        kind = f"cpu-omp-{native.omp_threads()}t"
        for n in instances:
            strikes = np.linspace(70.0, 130.0, n)
            native.price_batch_cpu(spec, solver, strikes, *args, **kw)
            times = []
            for _ in range(samples):
                t0 = time.perf_counter()
                native.price_batch_cpu(spec, solver, strikes, *args, **kw)
                times.append(time.perf_counter() - t0)
            rows.append(dict(m1=spec.m1, m2=spec.m2, n_steps=solver.n_steps,
                             instances=n,
                             total_runtime_s=float(np.median(times)),
                             device=kind))
    else:
        dev = douglas.resolve_device(device)
        if engine == "pallas":
            def pricer(ks):
                return fused_do.fused_price_batch(spec, solver, ks, *args,
                                                  **kw)
        else:
            sol = dataclasses.replace(solver, solver_engine=engine)

            def pricer(ks):
                return douglas.price_batch(spec, sol, ks, *args, **kw,
                                           device=dev)
        for n in instances:
            strikes = torch.linspace(70.0, 130.0, n, dtype=dtype, device=dev)
            rows.append(dict(m1=spec.m1, m2=spec.m2, n_steps=solver.n_steps,
                             instances=n,
                             total_runtime_s=timed_scan(pricer, strikes,
                                                        reps, samples),
                             device=device_name(dev)))
    if csv_path:
        hio.export_benchmark(csv_path, rows)
    return rows


def _study(specs_solvers, params, reference_price, csv_path, device):
    p = params
    dev = douglas.resolve_device(device)
    rows = []
    for spec, solver in specs_solvers:
        t0 = time.perf_counter()
        price = float(douglas.price_option(
            spec, solver, torch.tensor(100.0, dtype=torch.float64), 100.0,
            p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d, p.r_f, device=dev))
        rows.append(dict(m1=spec.m1, m2=spec.m2, n_steps=solver.n_steps,
                         price=price, runtime_s=time.perf_counter() - t0))
    if csv_path:
        hio.export_convergence(csv_path, rows, reference_price)
    return rows


def run_convergence_study(
    reference_price: float = 8.8943383103218502,
    m2_values: Sequence[int] = (15, 25, 50, 75, 100),
    n_steps: int = 200,
    params: HestonParams = HestonParams(),
    a2_variant: str = "central",
    csv_path: Optional[str] = None,
    device=None,
):
    """Spatial convergence sweep with m1 = 2*m2 against a reference price
    on the eager loop, float64 (the reference's ConvergenceExporter study,
    ref: src/solver.cpp:61-312, test_convergence :1653-1741); runtime_s
    the host wall time of each price, the read of the price included."""
    return _study([(GridSpec(m1=2 * m2, m2=m2),
                    SolverConfig(n_steps=n_steps, a2_variant=a2_variant))
                   for m2 in m2_values], params, reference_price, csv_path,
                  device)


def run_timestep_study(
    reference_price: float = 8.8943383103218502,
    n_values: Sequence[int] = (10, 20, 40, 80, 160),
    spec: GridSpec = GridSpec(m1=100, m2=75),
    params: HestonParams = HestonParams(),
    a2_variant: str = "central",
    scheme: str = "do",
    rannacher_steps: int = 0,
    csv_path: Optional[str] = None,
    device=None,
):
    """Timestep refinement sweep at a fixed grid, as
    `run_convergence_study`."""
    return _study([(spec, SolverConfig(n_steps=n, a2_variant=a2_variant,
                                       scheme=scheme,
                                       rannacher_steps=rannacher_steps))
                   for n in n_values], params, reference_price, csv_path,
                  device)

"""Smoke run of heston_tpu_torch on an NVIDIA GPU: builds the CUDA kernel
from the sources in this checkout, holds it against its plain PyTorch
version, checks the scheme pins, and drives the flagship pricing call
(batch-500 American calls with the golden dividends, Douglas theta = 0.8,
upwind A2, 50 x 25 x 20) through the public entry point.

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Exits non-zero
without a card, and when any phase fails. Imports no JAX. The last line
of its output is {"ok": true, "device": {...}}; the line before it lists
every kernel of the path with its launches, error and times.
"""

import json
import statistics
import subprocess
import sys
import time

import torch

# float32 price RMSE budgets per arm against float64, from the JAX
# package's on-chip selftest (bench.py:640-649, SELFTEST_BUDGET)
ARM_BUDGETS = {"euro": 2e-5, "amer": 4e-5, "div": 4e-5, "amer_div": 3e-5}
F64_KERNEL_TOL = 1e-10       # f64 kernel vs f64 plain, max abs on surfaces
PIN_TOL = 1e-9               # f64 scheme pins
MAIN_RMSE = 3e-5             # f32 main path vs plain f64
MAIN_KERNEL_TOL = 1e-4       # f32 kernel vs f32 plain on the same inputs,
                             # max abs on prices (~50 ulps of a price ~30)
REPS = 20


def phase(name, **values):
    print(json.dumps({"phase": name, **values}), flush=True)


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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    # the package is imported only once a card is known to be there
    import heston_tpu_torch
    from heston_tpu_torch import (GOLDEN_DIVIDENDS, GridSpec, HestonParams,
                                  SolverConfig)
    from heston_tpu_torch.kernels import fused_do

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    phase("device", kind=kind, count=torch.cuda.device_count(),
          nvidia_smi=smi, torch=torch.__version__,
          cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = fused_do.build()
    phase("build", seconds=time.perf_counter() - t0, library=lib.name)

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

    def inputs(strikes, arm):
        fields, vec_s, idx_s, idx_v = fused_do._assemble(
            spec, solver, strikes, 100.0, *args)
        events = fused_do.dividend_plan(solver, arms[arm]["dividends"])
        remaps = fused_do._build_remap_fields(vec_s, events)
        kw = dict(theta=solver.theta, delta_t=solver.delta_t,
                  n_steps=solver.n_steps, rf=p.r_f,
                  american=arms[arm]["american"])
        return (fields, [e[0] for e in events], remaps, kw), (idx_s, idx_v)

    def prices(u, idx):
        return fused_do._extract(u, *idx)

    # ---- kernel against plain, every arm, f64 and f32
    ks = torch.linspace(75.0, 125.0, 64, dtype=torch.float64, device=dev)
    for arm in arms:
        loop64, idx64 = inputs(ks, arm)
        got64 = fused_do.fused_do_loop(*loop64[:3], **loop64[3])
        want64 = fused_do.fused_do_reference(*loop64[:3], **loop64[3])
        torch.cuda.synchronize()
        err64 = float((got64 - want64).abs().max())
        loop32, idx32 = inputs(ks.float(), arm)
        got32 = fused_do.fused_do_loop(*loop32[:3], **loop32[3])
        err32 = rmse(prices(got32, idx32), prices(want64, idx64))
        phase("kernel_vs_plain", arm=arm, f64_max_abs=err64,
              f64_tol=F64_KERNEL_TOL, f32_rmse=err32,
              f32_budget=ARM_BUDGETS[arm])
        if not err64 <= F64_KERNEL_TOL:
            raise AssertionError(f"{arm}: f64 kernel vs plain {err64}")
        if not err32 <= ARM_BUDGETS[arm]:
            raise AssertionError(f"{arm}: f32 RMSE {err32} over budget")

    # ---- scheme pins (tests/test_douglas.py:51-52), f64 through the kernel
    for strike, kw, pin in (
            (95.0, dict(american=True, dividends=GOLDEN_DIVIDENDS),
             8.510573074266677),
            (100.0, dict(dividends=GOLDEN_DIVIDENDS), 3.85096222593301)):
        got = float(heston_tpu_torch.price_batch(
            spec, solver, torch.tensor([strike], dtype=torch.float64,
                                       device=dev), 100.0, *args, **kw)[0])
        phase("pin", strike=strike, got=got, want=pin, err=got - pin)
        if not abs(got - pin) <= PIN_TOL:
            raise AssertionError(f"pin K={strike}: {got} != {pin}")

    # ---- the main path: the flagship call on the bench's 500-strike
    # ladder, then on its 5000-option book — the same ladder tiled ten
    # times (bench.py:1214)
    flagship = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    ladder = torch.linspace(70.0, 130.0, 500, dtype=torch.float32,
                            device=dev)
    report = None
    for batch in (500, 5000):
        strikes = ladder.repeat(batch // 500)

        def call():
            return heston_tpu_torch.price_batch(
                spec, solver, strikes, 100.0, *args, **flagship)

        fused_do.fused_do_loop.launches = 0
        out = call()
        torch.cuda.synchronize()
        launches = fused_do.fused_do_loop.launches
        if launches != 1:
            raise AssertionError(f"B={batch}: {launches} kernel launches "
                                 f"in one call, want 1")
        if out.shape != (batch,) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"B={batch}: bad output {out.shape}")

        loop32, idx32 = inputs(strikes, "amer_div")
        loop64, idx64 = inputs(strikes.double(), "amer_div")
        plain64 = prices(fused_do.fused_do_reference(*loop64[:3],
                                                     **loop64[3]), idx64)
        err_main = rmse(out, plain64)
        kern32 = prices(fused_do.fused_do_loop(*loop32[:3], **loop32[3]),
                        idx32)
        plain32 = prices(fused_do.fused_do_reference(*loop32[:3],
                                                     **loop32[3]), idx32)
        err_kernel = float((kern32 - plain32).abs().max())
        if not err_main <= MAIN_RMSE:
            raise AssertionError(f"B={batch}: RMSE {err_main} vs plain f64")
        if not err_kernel <= MAIN_KERNEL_TOL:
            raise AssertionError(f"B={batch}: kernel vs plain f32 "
                                 f"{err_kernel}")

        e2e = host_ms(call)
        assembly = cuda_ms(lambda: inputs(strikes, "amer_div"))
        kernel = cuda_ms(lambda: fused_do.fused_do_loop(*loop32[:3],
                                                        **loop32[3]))
        plain = cuda_ms(lambda: fused_do.fused_do_reference(*loop32[:3],
                                                            **loop32[3]))
        phase("main_path", batch=batch, launches=launches,
              rmse_vs_plain_f64=err_main, rmse_budget=MAIN_RMSE,
              kernel_vs_plain_f32_max_abs=err_kernel,
              e2e_ms=e2e, assembly_ms=assembly, kernel_ms=kernel,
              plain_f32_ms=plain, price_mid=float(out[batch // 2]))
        if batch == 500:
            report = {"name": "fused_do", "route": "cuda",
                      "source": "heston_tpu_torch/csrc/fused_do.cu",
                      "replaces": "heston_tpu/pallas/fused_do.py:328",
                      "launches": launches, "max_abs_err": err_kernel,
                      "ms": kernel, "plain_ms": plain}

    print(json.dumps({"kernels": [report]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of heston_tpu_torch on an NVIDIA GPU: builds the CUDA kernel
from the sources in this checkout, holds both of its variants (primal and
forward mode) against their plain PyTorch versions, checks the scheme
pins, and drives the two legs of the main path through the public entry
points: the flagship pricing call (batch-500 American calls with the
golden dividends, Douglas theta = 0.8, upwind A2, 50 x 25 x 20) and the
Levenberg–Marquardt calibrations of the bench (lm60, the 10 x 20
maturity ladder and its American-dividend variant, bench.py:974-1105).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Exits non-zero
without a card, and when any phase fails. Imports no JAX. The last line
of its output is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the line before that lists every kernel
of the path with its launches, error, times and bound.
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
JAC_RMSE = 3e-5              # f32 Jacobian vs f64 plain, RMSE of entries
                             # normalized by max(1, |J64|) (bench.py:648)
TANGENT_KERNEL_TOL = 1e-3    # f32 forward-mode kernel vs f32 plain, max abs
                             # on the surfaces (tangents up to ~10^3)
SSE_REL = 0.02               # lm60: f32 final SSE within 2% of f64's
REPS = 20
CAL_REPS = 5
# the H100's published peaks (NVIDIA's H100 SXM data sheet): float32 outside
# the tensor cores, and HBM bandwidth
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# floating-point operations the time loop needs (each add, multiply,
# divide or compare counts one), keyed by `american`. Every stencil of
# a surface is formed once per point and step and its differences are
# shared; products of coefficient rows alone (c_a0 and its tangents, the
# implicit bands, the American floor) are step-invariant and counted once
# per launch; per tangent only the terms that involve that tangent.
# Primal, per point and step: s-differences 2, beta_s 3, beta_v 5, A2
# with reaction 13, A1 10, sum 3, dt-scale 1 (+ lam 1); Thomas 5, penta
# 9; update 4 (American 9: compensated sum, floor, multiplier).
FLOPS_STEP = {False: 55, True: 61}
# with tangents, once per point and step: z1's s-differences and A1
# P-term 5, z2's v-differences 4
FLOPS_STEP_TANGENT_SHARED = 9
# per tangent, point and step: tangent beta_v bands 3, the tangent
# surface's beta_s and beta_v 10, A0 term 4, dA1 u 1, A1 du 10, dA2 u 7,
# A2 du 13, sum and dt-scale 5, td dA1 z1 2 (+ dlam 1); Thomas 5; td dA2
# z2 8, penta 9; update 1 (American 2)
FLOPS_STEP_PER_TANGENT = {False: 78, True: 80}
# per point and launch: the Thomas factorization 14 and c_a0 1; per
# tangent its dc_a0 3
FLOPS_SETUP = 15
FLOPS_SETUP_PER_TANGENT = 3
# per point and dividend event: the fold 1, the 2-point remap 5, the
# 2Sum 6; per tangent the remap 5 and its sum 1
FLOPS_EVENT = 12
FLOPS_EVENT_PER_TANGENT = 6
# the JAX package's round-5 TPU float32 records (ROUND5_NOTES.md:84-90),
# printed beside the port's fits for comparison only
TPU_RECORDS = {"lm60": {"sse": 0.0593, "iv_rmse_bp": 13.9},
               "lm_multi200": {"sse": 0.0959, "iv_rmse_bp": 73.0}}


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


def device_profile(fn):
    """One fn() call (after a warm-up) under torch.profiler: the number of
    device kernels, their busy time (the union of their intervals) and
    the device time of the time-loop kernels, split into the primal and
    the forward-mode instantiation, in ms."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
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
    # fused_do_kernel<T, TAN>: TAN = true is the forward-mode variant
    # (demangled ", true>", mangled "Lb1E")
    loop = [(e.time_range.elapsed_us(),
             ", true>" in e.name or "Lb1E" in e.name)
            for e in kernels if "fused_do_kernel" in e.name]
    tangent = sum(us for us, tan in loop if tan)
    primal = sum(us for us, tan in loop if not tan)
    return dict(device_kernels=len(kernels), device_busy_ms=busy / 1e3,
                primal_kernel_device_ms=primal / 1e3,
                tangent_kernel_device_ms=tangent / 1e3)


def kernel_bound(b, ns, nv, n_steps, n_events, itemsize, american,
                 n_tangents=0):
    """(bound_ms, bound_by, flops, bytes) of one launch: each input read
    once and each output written once, over the HBM rate, against the
    operations the function needs over the float32 peak (FLOPS_* above;
    the kernel itself does more, recomputing shared terms)."""
    npts = ns * nv
    step = FLOPS_STEP[american]
    if n_tangents:
        step += (FLOPS_STEP_TANGENT_SHARED
                 + n_tangents * FLOPS_STEP_PER_TANGENT[american])
    # plus, per step, the boundary injections: 4 on each s-node and 2 on
    # each v-node
    flops = b * (
        npts * (FLOPS_SETUP + n_tangents * FLOPS_SETUP_PER_TANGENT
                + n_steps * step
                + n_events * (FLOPS_EVENT
                              + n_tangents * FLOPS_EVENT_PER_TANGENT))
        + n_steps * (4 * ns + 2 * nv))
    # u0 and u_out, the coefficient rows (11 s-rows, 9 v-rows, 2 scalars),
    # the remap rows (int32 indices + weights); tangents: their rows
    # (1 s-row, 8 v-rows each) and their surfaces out
    values = b * (2 * npts + 11 * ns + 9 * nv + 2 + 2 * n_events * ns
                  + n_tangents * (ns + 8 * nv + npts))
    nbytes = values * itemsize + b * 2 * n_events * ns * 4
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def iv_rmse(fitted, market, strikes, r_d, slices):
    """RMSE of the implied-vol differences of fitted and market call
    prices (float64 on the CPU, the port's implied_vol), over the chain
    segments slices = [(lo, hi, maturity)]; non-finite vols are dropped
    (bench.py _iv_rmse)."""
    from heston_tpu_torch.models import bs

    diffs = []
    for lo, hi, t in slices:
        ks = strikes[lo:hi].detach().double().cpu()
        iv_f = bs.implied_vol(fitted[lo:hi].detach().double().cpu(), 100.0,
                              ks, r_d, t)
        iv_m = bs.implied_vol(market[lo:hi].detach().double().cpu(), 100.0,
                              ks, r_d, t)
        diffs.append(iv_f - iv_m)
    d = torch.cat(diffs)
    d = d[torch.isfinite(d)]
    return float(torch.sqrt(torch.mean(d ** 2))) if d.numel() else float(
        "nan")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    # the package is imported only once a card is known to be there
    import heston_tpu_torch
    from heston_tpu_torch import (GOLDEN_DIVIDENDS, CalibrationConfig,
                                  GridSpec, HestonParams, SolverConfig)
    from heston_tpu_torch.kernels import fused_do
    from heston_tpu_torch.models import bs, calibration

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
        prof = device_profile(call)
        assembly = cuda_ms(lambda: inputs(strikes, "amer_div"))
        kernel = cuda_ms(lambda: fused_do.fused_do_loop(*loop32[:3],
                                                        **loop32[3]))
        plain = cuda_ms(lambda: fused_do.fused_do_reference(*loop32[:3],
                                                            **loop32[3]))
        phase("main_path", batch=batch, launches=launches,
              rmse_vs_plain_f64=err_main, rmse_budget=MAIN_RMSE,
              kernel_vs_plain_f32_max_abs=err_kernel,
              e2e_ms=e2e, assembly_ms=assembly, kernel_ms=kernel,
              plain_f32_ms=plain, price_mid=float(out[batch // 2]), **prof,
              device_idle_share=1.0 - prof["device_busy_ms"] / e2e)
        if batch == 500:
            bound, bound_by, _, _ = kernel_bound(
                batch, spec.m1 + 1, spec.m2 + 1, solver.n_steps,
                len(loop32[1]), 4, True)
            report = {"name": "fused_do", "route": "cuda",
                      "source": "heston_tpu_torch/csrc/fused_do.cu",
                      "replaces": "heston_tpu/pallas/fused_do.py:328",
                      "launches": launches, "max_abs_err": err_kernel,
                      "ms": kernel, "plain_ms": plain, "bound_ms": bound,
                      "bound_by": bound_by, "library_ms": None}

    # ---- forward mode against plain, every arm: 64 strikes in [75, 125]
    # on the flagship grid; f64 surfaces, then the f32 Jacobian against
    # the f64 plain one (normalized per entry, bench.py:934)
    theta = [p.kappa, p.eta, p.sigma, p.rho, p.v0]

    def tangent_inputs(strikes, arm, sol=solver, params=theta):
        tv = torch.tensor(params, dtype=strikes.dtype, device=dev)
        fields, tangents, vec_s, idx_s, idx_v = fused_do._linearized_assemble(
            spec, sol, strikes, 100.0, tv, p.r_d, p.r_f)
        events = fused_do.dividend_plan(sol, arms[arm]["dividends"])
        remaps = fused_do._build_remap_fields(vec_s, events)
        kw = dict(theta=sol.theta, delta_t=sol.delta_t, n_steps=sol.n_steps,
                  rf=p.r_f, american=arms[arm]["american"],
                  tangents=tangents)
        return ((fields, [e[0] for e in events], remaps, kw),
                (fields["vfl"], idx_s, idx_v, tv[4]))

    for arm in arms:
        loop64, extra64 = tangent_inputs(ks, arm)
        got_u, got_du = fused_do.fused_do_loop(*loop64[:3], **loop64[3])
        want_u, want_du = fused_do.fused_do_reference(*loop64[:3],
                                                      **loop64[3])
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
    fused_do.fused_do_loop.launches = 0
    fused_do.fused_do_loop.tangent_launches = 0
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
    got_u, got_du = fused_do.fused_do_loop(*loop60[:3], **loop60[3])
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want_u, want_du = fused_do.fused_do_reference(*loop60[:3], **loop60[3])
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
    if not finite:
        raise AssertionError("lm60: non-finite output")
    if not abs(sse32 - sse64) <= SSE_REL * sse64:
        raise AssertionError(f"lm60: f32 SSE {sse32} vs f64 {sse64}")
    if not err_tan <= TANGENT_KERNEL_TOL:
        raise AssertionError(f"lm60: f32 tangent kernel vs plain {err_tan}")
    bound, bound_by, _, _ = kernel_bound(
        60, spec.m1 + 1, spec.m2 + 1, solver.n_steps, 0, 4, False,
        n_tangents=fused_do.JAC_TANGENTS)
    report_tangent = {
        "name": "fused_do_tangent", "route": "cuda",
        "source": "heston_tpu_torch/csrc/fused_do.cu",
        "replaces": "heston_tpu/pallas/fused_do.py:328",
        "launches": cal_launches[0], "max_abs_err": err_tan, "ms": tan_ms,
        "plain_ms": tan_plain_ms, "bound_ms": bound, "bound_by": bound_by,
        "library_ms": None}

    # ---- calibration ladders (bench.py:1012-1105): 10 maturities x 20
    # strikes, one kernel launch per maturity group per pass, float32
    mats = [0.1 * (i + 1) for i in range(10)]
    ks_one = torch.tensor([80.0 + i * 2.0 for i in range(20)],
                          dtype=torch.float64, device=dev)
    ladder = ks_one.repeat(10).float()
    ladder_market = torch.cat([
        bs.generate_market_data(100.0, t, p.r_d, ks_one)
        for t in mats]).float()
    groups = tuple((20 * i, 20 * (i + 1), max(1, round(20 * t)))
                   for i, t in enumerate(mats))

    def ladder_vs_plain(arm):
        """Both kernels against their f32 plain versions on the inputs
        of each group's first Jacobian pass and trial pricing: 20
        options, the group's step count, its own dividend events. Max
        abs over groups of (primal prices, forward-mode surfaces)."""
        worst_p = worst_t = 0.0
        for a, b, n in groups:
            sol = calibration._group_solver(solver, n)
            loop_g, extra = tangent_inputs(ladder[a:b], arm, sol,
                                           params=init)
            primal_kw = {k: v for k, v in loop_g[3].items()
                         if k != "tangents"}
            got_p = prices(fused_do.fused_do_loop(*loop_g[:3], **primal_kw),
                           extra[1:3])
            want_p = prices(fused_do.fused_do_reference(*loop_g[:3],
                                                        **primal_kw),
                            extra[1:3])
            got_u, got_du = fused_do.fused_do_loop(*loop_g[:3], **loop_g[3])
            want_u, want_du = fused_do.fused_do_reference(*loop_g[:3],
                                                          **loop_g[3])
            worst_p = max(worst_p, float((got_p - want_p).abs().max()))
            worst_t = max([worst_t] + [
                float((g - w).abs().max())
                for g, w in zip([got_u, *got_du], [want_u, *want_du])])
        return worst_p, worst_t

    for case, arm, kw in (("lm_multi200", "euro", {}),
                          ("lm_multi200_amer_div", "amer_div",
                           dict(american=True,
                                dividends=GOLDEN_DIVIDENDS))):
        fused_do.fused_do_loop.tangent_launches = 0
        t0 = time.perf_counter()
        tv_l, info_l = heston_tpu_torch.calibrate_device(
            spec, solver, ladder, ladder_market, 100.0,
            torch.tensor(init), p.r_d, p.r_f, cfg=lm_cfg,
            group_steps=groups, **kw)
        torch.cuda.synchronize()
        wall_l = 1e3 * (time.perf_counter() - t0)
        it_l = info_l["iterations"]
        per_pass = fused_do.fused_do_loop.tangent_launches / it_l
        rmse_l = (iv_rmse(info_l["fitted_prices"], ladder_market, ladder,
                          p.r_d, [(a, b, t) for (a, b, _), t
                                  in zip(groups, mats)])
                  if not kw else None)
        err_p, err_t = ladder_vs_plain(arm)
        phase("calibration_ladder", case=case, dtype="float32",
              iterations=it_l, converged=bool(info_l["converged"]),
              final_sse=float(info_l["final_error"]), params=tv_l.tolist(),
              iv_rmse=rmse_l,
              iv_rmse_bp=None if rmse_l is None else 1e4 * rmse_l,
              wall_ms_one_run=wall_l, tangent_launches_per_pass=per_pass,
              groups_kernel_vs_plain_f32_max_abs=err_p,
              groups_tangent_kernel_vs_plain_f32_max_abs=err_t,
              tpu_record_jax_round5=TPU_RECORDS.get(case))
        if not (bool(torch.isfinite(tv_l).all())
                and bool(torch.isfinite(info_l["final_error"]))):
            raise AssertionError(f"{case}: non-finite output")
        if per_pass != len(groups):
            raise AssertionError(f"{case}: {per_pass} tangent launches per "
                                 f"Jacobian pass, want {len(groups)}")
        if not err_p <= MAIN_KERNEL_TOL:
            raise AssertionError(f"{case}: f32 kernel vs plain {err_p} "
                                 f"on a group's inputs")
        if not err_t <= TANGENT_KERNEL_TOL:
            raise AssertionError(f"{case}: f32 tangent kernel vs plain "
                                 f"{err_t} on a group's inputs")

    print(json.dumps({"kernels": [report, report_tangent]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

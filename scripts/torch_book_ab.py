"""A/B of heston_tpu_torch's batched kernel (csrc/fused_do.cu) on one
NVIDIA GPU, for two or more source trees in one run: each instantiation's
registers, spills and resident blocks an SM, and the device time of the
Douglas call books, among them the books that fill the card several
times over.

    python3 scripts/torch_book_ab.py --arm parent=DIR --arm change=. \
        [--rounds 2] [--out build/torch_book_ab.json]

An arm is NAME=DIR[:SOURCE]: DIR holds a heston_tpu_torch package (a
checkout, or `git archive` of one unpacked), SOURCE optionally another
csrc/fused_do.cu with the same ABI, built in place of the package's own.
Each arm builds its libraries as its package does (the builds of all
arms start together) and reads their resource usage with cuobjdump; the
blocks an SM follow from the registers (128 threads a primal block, 256 a
forward-mode one, 64K registers and 64 warps an SM; the few KB of shared
memory a block takes at 51 x 26 do not bind).

Books, float32, Douglas theta 0.8, upwind A2, 50 x 25 x 20
(chip_smoke.py's main path): the flagship 500-strike ladder and its
5000-option tiling (American calls with the golden dividends), and the
mixed-maturity book mixed5000 (the ladder in 10 groups of 2..20 steps),
European and American with dividends. Each (arm, round) runs in a
process of its own, the arms in the order A B .. B A; each book's device
time is the median of REPS launches under torch.profiler, on the
package's main-path build and, where the package has one, its -fmad=false
build too. Prints one JSON line per process, then a summary, then the
card's name and power limit; writes all of it to --out.
"""

import argparse
import functools
import inspect
import json
import re
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

REPS = 15
THREADS = {False: 128, True: 256}   # primal / forward-mode block
REGS_PER_SM, WARPS_PER_SM, BLOCKS_PER_SM = 65536, 64, 32


def parse_arm(text):
    name, _, rest = text.partition("=")
    tree, _, source = rest.partition(":")
    return name, str(Path(tree).resolve()), (str(Path(source).resolve())
                                             if source else None)


def load(tree, source):
    """The arm's fused_do module, with its source swapped in."""
    sys.path.insert(0, tree)
    from heston_tpu_torch.kernels import fused_do

    if source is not None:
        fused_do.SOURCE = Path(source)
    return fused_do


def builds(fused_do):
    """{label: fmad} of the arm's builds: the main path's float32 one, and
    -fmad=false when the package builds both."""
    if "fmad" not in inspect.signature(fused_do.build).parameters:
        return {"main": None}
    return {"main": fused_do.use_fmad(torch.float32), "fmad_false": False}


def build_child(tree, source):
    """Build the arm's libraries; print {label: (library, source, fmad)}
    as JSON."""
    fused_do = load(tree, source)

    def one(fmad):
        lib = (fused_do.build(fused_do.SOURCE) if fmad is None
               else fused_do.build(fused_do.SOURCE, fmad))
        return str(lib), str(fused_do.SOURCE), bool(fmad)

    flags = builds(fused_do)
    with ThreadPoolExecutor(len(flags)) as pool:
        paths = dict(zip(flags, pool.map(one, flags.values())))
    print(json.dumps(paths))


def demangle(name):
    """The kernel's template name, e.g. fused_do_kernel<float, false, 0,
    true>, else the symbol as it stands."""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        name = subprocess.run([filt, name], capture_output=True, text=True,
                              timeout=60).stdout.strip() or name
    except OSError:
        pass
    k = re.search(r"(fused_do_kernel\w*<[^>]*>)", name)
    return k.group(1) if k else name


def resource_usage(lib, source, fmad):
    """{kernel: (registers, stack, local)} of the library's kernels, from
    cuobjdump; where that reads nothing, from ptxas -v on the source
    compiled again with the build's flags."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-resource-usage", lib],
                         capture_output=True, text=True, timeout=300).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if m and name:
            usage[name] = tuple(int(x) for x in m.groups())
    if usage:
        return usage
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    cubin = Path(lib).with_suffix(".cubin")
    err = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", f"-fmad={'true' if fmad else 'false'}", "-cubin",
         "-Xptxas", "-v", "-o", str(cubin), source],
        capture_output=True, text=True, timeout=1200).stderr
    stack = 0
    for line in err.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            stack = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name] = (int(m.group(1)), stack, 0)
    return usage


def is_tangent(kernel):
    """Whether a demangled fused_do_kernel<T, TAN, ...> is a forward-mode
    instantiation (the bounded kernel is primal only)."""
    m = re.match(r"fused_do_kernel<[^,]+, ([^,>]+)", kernel)
    return bool(m) and m.group(1) in ("true", "(bool)1")


def blocks_per_sm(regs, tangent):
    warps = THREADS[tangent] // 32
    per_warp = -(-regs * 32 // 256) * 256
    return min(REGS_PER_SM // (per_warp * warps), WARPS_PER_SM // warps,
               BLOCKS_PER_SM)


def time_child(tree, source):
    """Device ms of each book on each build of the arm; one JSON line."""
    from torch.profiler import ProfilerActivity, profile

    fused_do = load(tree, source)
    from heston_tpu_torch import GOLDEN_DIVIDENDS, GridSpec, HestonParams
    from heston_tpu_torch import SolverConfig

    dev = torch.device("cuda")
    p = HestonParams()
    args = (100.0, p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d, p.r_f)
    spec = GridSpec(m1=50, m2=25)
    solver = SolverConfig(n_steps=20, theta=0.8, maturity=1.0,
                          a2_variant="upwind", solver_engine="pallas")
    ladder = torch.linspace(70.0, 130.0, 500, dtype=torch.float32,
                            device=dev)
    amer_div = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    mixed = (ladder.repeat(10),
             (2 * (torch.arange(10, device=dev) + 1)).repeat_interleave(500))
    books = {"b500": (ladder, None, amer_div),
             "b5000": (ladder.repeat(10), None, amer_div),
             "mixed5000_euro": (*mixed, {}),
             "mixed5000_amer_div": (*mixed, amer_div)}

    def device_ms(run):
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and "fused_do_kernel" in e.name]
        return statistics.median(times) if times else None

    result = {}
    for label, fmad in builds(fused_do).items():
        loop = (fused_do.fused_do_loop if fmad is None else
                functools.partial(fused_do.fused_do_loop, fmad=fmad))
        for book, (strikes, nst, kw) in books.items():
            fields, phases, _, _, _ = fused_do.book_plan(
                spec, solver, strikes, *args, n_steps_per=nst, **kw)
            result[f"{book}/{label}"] = device_ms(
                lambda: fused_do.run_phases(loop, fields, phases))
    print(json.dumps(result))


def run_child(mode, arm):
    _, tree, source = arm
    cmd = [sys.executable, __file__, f"--{mode}", tree]
    if source:
        cmd += ["--source", source]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=1500)
    if proc.returncode != 0:
        raise RuntimeError(f"{mode} {arm}: rc {proc.returncode}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", action="append", type=parse_arm, default=[])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default="build/torch_book_ab.json")
    ap.add_argument("--build", help=argparse.SUPPRESS)
    ap.add_argument("--time", help=argparse.SUPPRESS)
    ap.add_argument("--source", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.build:
        return build_child(opts.build, opts.source)
    if opts.time:
        return time_child(opts.time, opts.source)
    if not torch.cuda.is_available() or len(opts.arm) < 2:
        raise SystemExit("torch_book_ab: needs a CUDA card and two arms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    report = {"card": smi, "arms": {a[0]: a[1:] for a in opts.arm},
              "resources": {}, "runs": []}
    with ThreadPoolExecutor(len(opts.arm)) as pool:
        libs = dict(zip([a[0] for a in opts.arm],
                        pool.map(lambda a: run_child("build", a), opts.arm)))
    for name, paths in libs.items():
        report["resources"][name] = {}
        for label, (lib, source, fmad) in paths.items():
            report["resources"][name][label] = {
                k: {"registers": r, "stack": st, "local": lo,
                    "blocks_per_sm": blocks_per_sm(r, is_tangent(k))}
                for k, (r, st, lo) in sorted(
                    resource_usage(lib, source, fmad).items())}
        print(json.dumps({"resources": name, **report["resources"][name]}),
              flush=True)
    order = list(opts.arm)
    for r in range(opts.rounds):
        for arm in (order if r % 2 == 0 else order[::-1]):
            times = run_child("time", arm)
            report["runs"].append({"arm": arm[0], "round": r, **times})
            print(json.dumps(report["runs"][-1]), flush=True)
    summary = {}
    for run in report["runs"]:
        for key, ms in run.items():
            if key not in ("arm", "round") and ms is not None:
                summary.setdefault(key, {}).setdefault(run["arm"], []).append(
                    ms)
    report["summary"] = {k: {a: statistics.median(v) for a, v in arms.items()}
                         for k, arms in summary.items()}
    print(json.dumps({"summary_device_ms": report["summary"]}))
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

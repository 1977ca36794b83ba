"""A/B of heston_tpu_torch's batched kernel (csrc/fused_do.cu) on one
NVIDIA GPU, for two or more source trees in one process: each
instantiation's registers and spills, each launch's placement (the
fields in shared memory, shared bytes, threads, tangent groups G and
resident blocks an SM from the occupancy API, where the tree has
fused_do.launch_plan), and the device time of the books and launches of
the main path, the arms alternating.

    python3 scripts/torch_book_ab.py --arm parent=DIR --arm change=. \
        [--rounds 4] [--phase-clock] [--out build/torch_book_ab.json]

An arm is NAME=DIR[:SOURCE]: DIR holds a heston_tpu_torch package (a
checkout, or `git archive` of one unpacked), SOURCE optionally another
csrc/fused_do.cu with the same ABI, built in place of the package's own.
Every arm's package is imported into this one process (each imported
anew from its DIR, its modules bound to each other) and builds its
libraries as its package does, all arms' builds started together; their
resource usage comes from cuobjdump.

Cases, float32, theta 0.8, upwind A2, 50 x 25 x 20 (chip_smoke.py's main
path), each through the arm's own book_plan / _linearized_assemble and
run_phases on its main-path build: the flagship 500-strike ladder of
American calls with the golden dividends (b500), its 5000-option tiling
(b5000), the mixed-maturity book mixed5000 (the ladder in 10 groups of
2..20 steps), European and American with dividends, the flagship book
under Craig-Sneyd (b500_cs), and lm60's two launches (60 European calls,
K = 70..129): its trial pricing (b60_euro) and its forward-mode Jacobian
launch with K = 4 (lm60_k4), K = 5 (v0_mode "ad", lm60_k5) and damped
(Rannacher R = 2: two launches, lm60_k4_damped). In each round the arms
run in turn (A B .. then .. B A); a case's device time is the median over
REPS calls under torch.profiler of the kernel time a call takes (its
launches summed). Prints one JSON line per (round, arm), then a summary
(the median over rounds, and each arm over the first), then the card's
name and power limit; writes all of it to --out.

--phase-clock: the last arm's source compiled once more with the kernel's
phase-clock hooks defined (clock64() at every phase boundary of block
(0, 0), summed over the steps and printed at its end), in a child process:
the cycles of each phase (setup, events, rhs, thomas, penta, corr, trhs,
tthomas, tpenta, tcorr, update, out) for b500, b60_euro and lm60_k4 with
the default placement, all fields in global memory, and lm60_k4 with
G = 1; with the SM clock nvidia-smi reads after the run.
"""

import argparse
import ctypes
import importlib
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
PHASES = ("setup", "events", "rhs", "thomas", "penta", "corr", "trhs",
          "tthomas", "tpenta", "tcorr", "update", "out")
# the hooks' definitions prepended to the phase-clock copy of the source
# (the kernel names its phases with the PhaseId enum, NPHASE of them)
CLOCK_DEFS = r"""#include <cstdio>
#define PHASE_CLOCK_BEGIN long long pc_t = clock64(); long long pc_acc[NPHASE] = {};
#define PHASE_MARK(id) if (tid == 0) { const long long pc_n = clock64(); pc_acc[id] += pc_n - pc_t; pc_t = pc_n; }
#define PHASE_CLOCK_END if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) printf("phase_clock %d %d %d %lld %lld %lld %lld %lld %lld %lld %lld %lld %lld %lld %lld\n", (int)TAN, SCHEME, last - first_step + 1, pc_acc[0], pc_acc[1], pc_acc[2], pc_acc[3], pc_acc[4], pc_acc[5], pc_acc[6], pc_acc[7], pc_acc[8], pc_acc[9], pc_acc[10], pc_acc[11]);
"""


def parse_arm(text):
    name, _, rest = text.partition("=")
    tree, _, source = rest.partition(":")
    return name, str(Path(tree).resolve()), (str(Path(source).resolve())
                                             if source else None)


def load_arm(tree, source):
    """(package, fused_do) of the tree, imported anew beside the arms
    loaded before: each arm's modules stay bound to each other, and
    sys.modules holds the last arm's."""
    for key in [k for k in sys.modules
                if k.split(".")[0] == "heston_tpu_torch"]:
        del sys.modules[key]
    sys.path.insert(0, tree)
    try:
        pkg = importlib.import_module("heston_tpu_torch")
        fused_do = importlib.import_module("heston_tpu_torch.kernels.fused_do")
    finally:
        sys.path.remove(tree)
    if source is not None:
        fused_do.SOURCE = Path(source)
    return pkg, fused_do


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


def resource_usage(lib):
    """{kernel: (registers, stack, local)} of the library's kernels, from
    cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "--dump-resource-usage", str(lib)],
                         capture_output=True, text=True, timeout=300).stdout
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S+):", line)
        if m:
            name = demangle(m.group(1))
        m = re.search(r"REG:(\d+) STACK:(\d+) SHARED:\d+ LOCAL:(\d+)", line)
        if m and name:
            usage[name] = tuple(int(x) for x in m.groups())
    return usage


def cases(pkg, fused_do, dev="cuda"):
    """{case: (fields, phases, tangents or None)} of the arm, on `dev`."""
    p = pkg.HestonParams()
    spec = pkg.GridSpec(m1=50, m2=25)
    solver = pkg.SolverConfig(n_steps=20, theta=0.8, maturity=1.0,
                              a2_variant="upwind", solver_engine="pallas")
    args = (100.0, p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d, p.r_f)
    ladder = torch.linspace(70.0, 130.0, 500, dtype=torch.float32,
                            device=dev)
    chain = torch.arange(70.0, 130.0, dtype=torch.float32, device=dev)
    amer_div = dict(american=True, dividends=pkg.GOLDEN_DIVIDENDS)
    mixed = dict(n_steps_per=(2 * (torch.arange(10, device=dev) + 1))
                 .repeat_interleave(500))
    out = {}

    def book(name, strikes, sol=solver, **kw):
        fields, phases, _, _, _ = fused_do.book_plan(spec, sol, strikes,
                                                     *args, **kw)
        out[name] = (fields, phases, None)

    def jacobian(name, sol=solver, **kw):
        tv = torch.tensor([p.kappa, p.eta, p.sigma, p.rho, p.v0],
                          dtype=torch.float32, device=dev)
        fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
            spec, sol, chain, 100.0, tv, p.r_d, p.r_f, **kw)
        phases = fused_do.book_phases(sol, None, vec_s, p.r_f, False)
        out[name] = (fields, phases, tangents)

    book("b500", ladder, **amer_div)
    book("b5000", ladder.repeat(10), **amer_div)
    book("mixed5000_euro", ladder.repeat(10), **mixed)
    book("mixed5000_amer_div", ladder.repeat(10), **mixed, **amer_div)
    book("b500_cs", ladder, sol=pkg.SolverConfig(
        n_steps=20, theta=0.8, maturity=1.0, a2_variant="upwind",
        solver_engine="pallas", scheme="cs"), **amer_div)
    book("b60_euro", chain)
    jacobian("lm60_k4")
    jacobian("lm60_k5", v0_mode="ad")
    jacobian("lm60_k4_damped", sol=pkg.SolverConfig(
        n_steps=20, theta=0.8, maturity=1.0, a2_variant="upwind",
        solver_engine="pallas", rannacher_steps=2))
    return out


def run_case(fused_do, case, **kw):
    fields, phases, tangents = case
    loop = fused_do.fused_do_loop
    if kw:
        def loop(*a, **k):
            return fused_do.fused_do_loop(*a, **k, **kw)
    return fused_do.run_phases(loop, fields, phases, tangents)


def device_ms(fused_do, case):
    """Median over REPS calls of the kernel time of one call (its launches
    summed), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    run_case(fused_do, case)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            run_case(fused_do, case)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "fused_do_kernel" in e.name),
                    key=lambda e: e.time_range.start)
    per = len(case[1])
    times = [sum(e.time_range.elapsed_us() for e in events[i:i + per]) / 1e3
             for i in range(0, len(events) - per + 1, per)]
    return statistics.median(times) if times else None


def placement(fused_do, case):
    """The change's plan and occupancy of the case's first launch (None
    for a tree without launch_plan)."""
    if not hasattr(fused_do, "launch_plan"):
        return None
    fields, phases, tangents = case
    steps, remaps, kw = phases[0]
    b, ns, nv = fields["u"].shape
    k = len(tangents) if tangents else 0
    plan = fused_do.launch_plan(b, ns, nv, fields["u"].element_size(),
                                kw.get("scheme", "do"), kw["american"], k,
                                n_sm=torch.cuda.get_device_properties(0)
                                .multi_processor_count)
    return fused_do.occupancy(fields["u"].dtype, ns, nv,
                              kw.get("scheme", "do"), kw["american"], plan,
                              k, kw.get("option_type", "call"),
                              kw.get("knocked", ()))


def clock_child(tree):
    """The phase-clock run (see the docstring): one JSON line per case."""
    pkg, fused_do = load_arm(tree, None)
    src = fused_do.SOURCE.read_text()
    copy = Path(tree) / "build" / "phase_clock" / "fused_do.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    copy.write_text(CLOCK_DEFS + src)
    fused_do.SOURCE = copy
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda fmad: fused_do.build(copy, fmad),
                      (False, True)))
    all_cases = cases(pkg, fused_do)
    libc = ctypes.CDLL(None)
    runs = [("b500", {}), ("b500", dict(smem_budget=0)),
            ("b60_euro", {}), ("b60_euro", dict(smem_budget=0)),
            ("lm60_k4", {}), ("lm60_k4", dict(smem_budget=0)),
            ("lm60_k4", dict(groups=1))]
    for name, kw in runs:
        print(f"case {json.dumps([name, kw])}", flush=True)
        run_case(fused_do, all_cases[name], **kw)
        torch.cuda.synchronize()
        libc.fflush(None)


def parse_clock(text):
    """[{case, placement, launches: [{tan, scheme, steps, cycles}]}] from
    the child's output."""
    out = []
    for line in text.splitlines():
        if line.startswith("case "):
            name, kw = json.loads(line[5:])
            out.append({"case": name, "override": kw, "launches": []})
        elif line.startswith("phase_clock ") and out:
            v = [int(x) for x in line.split()[1:]]
            total = sum(v[3:])
            out[-1]["launches"].append({
                "tan": v[0], "scheme": v[1], "steps": v[2],
                "cycles": dict(zip(PHASES, v[3:])), "total_cycles": total,
                "cycles_per_step": total / max(1, v[2]),
                "share": {k: c / total for k, c in zip(PHASES, v[3:]) if c}})
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arm", action="append", type=parse_arm, default=[])
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default="build/torch_book_ab.json")
    ap.add_argument("--phase-clock", action="store_true")
    ap.add_argument("--clock-child", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.clock_child:
        return clock_child(opts.clock_child)
    if not torch.cuda.is_available() or len(opts.arm) < 2:
        raise SystemExit("torch_book_ab: needs a CUDA card and two arms")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    report = {"card": smi, "arms": {a[0]: a[1:] for a in opts.arm},
              "resources": {}, "placement": {}, "runs": []}
    arms = {name: load_arm(tree, source) for name, tree, source in opts.arm}
    # every arm's two builds, started together
    jobs = [(name, fmad) for name in arms for fmad in (False, True)]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: arms[j[0]][1].build(
            arms[j[0]][1].SOURCE, j[1]), jobs))
    for (name, fmad), lib in zip(jobs, libs):
        label = "fmad_true" if fmad else "fmad_false"
        report["resources"].setdefault(name, {})[label] = {
            k: {"registers": r, "stack": st, "local": lo}
            for k, (r, st, lo) in sorted(resource_usage(lib).items())}
        print(json.dumps({"resources": name, "build": label,
                          **report["resources"][name][label]}), flush=True)
    inputs = {name: cases(*arm) for name, arm in arms.items()}
    for name, (_, fused_do) in arms.items():
        rows = {c: placement(fused_do, case)
                for c, case in inputs[name].items()}
        if any(rows.values()):
            report["placement"][name] = rows
            print(json.dumps({"placement": name, **rows}), flush=True)
    order = list(arms)
    for r in range(opts.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            fused_do = arms[name][1]
            times = {c: device_ms(fused_do, case)
                     for c, case in inputs[name].items()}
            report["runs"].append({"arm": name, "round": r, **times})
            print(json.dumps(report["runs"][-1]), flush=True)
    summary = {}
    for run in report["runs"]:
        for key, ms in run.items():
            if key not in ("arm", "round") and ms is not None:
                summary.setdefault(key, {}).setdefault(run["arm"], []).append(
                    ms)
    report["summary"] = {
        k: {**{a: statistics.median(v) for a, v in by_arm.items()},
            **{f"{a}/{order[0]}": (statistics.median(v)
                                   / statistics.median(by_arm[order[0]]))
               for a, v in by_arm.items() if a != order[0]
               and order[0] in by_arm}}
        for k, by_arm in summary.items()}
    print(json.dumps({"summary_device_ms": report["summary"]}), flush=True)
    if opts.phase_clock:
        tree = opts.arm[-1][1]
        proc = subprocess.run([sys.executable, __file__, "--clock-child",
                               tree], capture_output=True, text=True,
                              timeout=1500)
        if proc.returncode != 0:
            raise RuntimeError(f"phase clock: rc {proc.returncode}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        report["phase_clock"] = {"sm_clock": clocks,
                                 "runs": parse_clock(proc.stdout)}
        for row in report["phase_clock"]["runs"]:
            print(json.dumps({"phase_clock": row}), flush=True)
        print(json.dumps({"sm_clock": clocks}), flush=True)
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(report, indent=1))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())

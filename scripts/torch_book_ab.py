"""A/B of heston_tpu_torch's two CUDA kernels on one NVIDIA GPU, for two
or more source trees in one process: the batched kernel
(csrc/fused_do.cu; kernel 1) and the single-option kernel
(csrc/fused_single.cu; kernel 2). Each instantiation's registers and
spills, each launch's placement (kernel 1: the fields in shared memory,
shared bytes, threads, tangent groups G and resident blocks an SM from
the occupancy API, where the tree has fused_do.launch_plan; kernel 2: the
cluster of blocks, rows a block, threads, fields in shared memory and
bytes, where the tree has fused_single.launch_plan), and the device time
of the launches of the main path, the arms alternating.

    python3 scripts/torch_book_ab.py --arm parent=DIR --arm change=. \
        [--kernels 1,2] [--rounds 4] [--phase-clock] \
        [--out build/torch_book_ab.json]

An arm is NAME=DIR[:SOURCE]: DIR holds a heston_tpu_torch package (a
checkout, or `git archive` of one unpacked), SOURCE optionally another
csrc/fused_do.cu with the same ABI, built in place of the package's own.
Every arm's package is imported into this one process (each imported
anew from its DIR, its modules bound to each other) and builds its
libraries as its package does, all arms' builds started together; their
resource usage comes from cuobjdump. A package's kernel layer must be
this one (kernels.assembly and kernels.cuda_build beside the kernels):
a build or a launch plan is forced at each kernel's `_launch_packed`.

Cases, float32, theta 0.8, upwind A2, 50 x 25 x 20 (chip_smoke.py's main
path), each through the arm's own book_plan / _linearized_assemble and
run_phases on its main-path build: the flagship 500-strike ladder of
American calls with the golden dividends (b500), its 5000-option tiling
(b5000), the mixed-maturity book mixed5000 (the ladder in 10 groups of
2..20 steps), European and American with dividends, the flagship book
under Craig-Sneyd (b500_cs), and lm60's two launches (60 European calls,
K = 70..129): its trial pricing (b60_euro) and its forward-mode Jacobian
launch with K = 4 (lm60_k4), K = 5 (v0_mode "ad", lm60_k5) and damped
(Rannacher R = 2: two launches, lm60_k4_damped). In float64, the book
cell's launch (book.mixed5000.f64): the mixed5000 book American with the
golden dividends (mixed5000_amer_div_f64), whose u and lambda on its
main-path build (-fmad=false) are also held bit for bit, each arm against
the first; the script exits 1 (after its report) where any differs.

Kernel-2 cases, K = 100, each through the arm's own
fused_single.single_plan and run_phases on its main-path build: the
reference's golden grid 100 x 75 x 20 (theta 0.8, central A2, European,
float32) under Douglas, Craig-Sneyd, modified Craig-Sneyd and
Hundsdorfer-Verwer (golden_do .. golden_hv), the bench's single-option
arms at 50 x 25 x 20 (upwind, float32): American with the golden
dividends (s50_amer_div) and with Rannacher start-up (s50_rann_amer_div),
and the largest grid class the routing admits, 120 x 100 in float64
with Rannacher, American, the golden dividends (g121_f64). The payoff
cases (50 x 25, float32: an American put with dividends, an American
digital call, an up-out-160 call with dividends, a double-out 80/150
American digital call) run only in the bitwise check: every kernel-2
case's u and lambda on the -fmad=false build, each arm against the first,
bit for bit; the script exits 1 (after its report) where any differs.
For a tree with fused_single.launch_plan, golden_do,
golden_hv, s50_amer_div and g121_f64 are also timed under the forced
clusters of SINGLE_VARIANTS (as CASE@C<n>).

In each round the arms run in turn (A B .. then .. B A); a case's device
time is the median over REPS calls under torch.profiler of the kernel
time a call takes (its launches summed). Prints one JSON line per (round,
arm), then a summary (the median over rounds, and each arm over the
first), then the card's name and power limit; writes all of it to --out.

--phase-clock: each arm's source that carries the kernel's phase-clock
hooks compiled once more with them defined (clock64() at every phase
boundary of block (0, 0), summed over the steps and printed at its end),
in a child process per arm (--clock-arms NAME,..: the arms clocked;
default kernel 1's last arm and kernel 2's every arm whose source has the
hooks). Kernel 1: the cycles of each phase (setup, events, rhs, thomas,
penta, corr, trhs, tthomas, tpenta, tcorr, update, out) for b500,
b60_euro and lm60_k4 with the default placement, all fields in global
memory, lm60_k4 with G = 1, and mixed5000_amer_div_f64 with the default
placement (block (0, 0) is a 2-step lane of it). Kernel 2: setup,
events, rhs, pcr, scale, penta, corr, update, barrier (waits for other
blocks: cluster barriers, mbarriers), out, scatter (the solution's rows
to their blocks), for every timed kernel-2 case, under the default plan
and (a tree with fused_single.launch_plan) the forced plan of one block
with the PCR factors in global memory. With the SM clock nvidia-smi
reads after the run.
"""

import argparse
import ctypes
import functools
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
# the book cell's launch (book.mixed5000.f64), held bit for bit across arms
BOOK_F64 = "mixed5000_amer_div_f64"
# kernel 2 under forced cluster sizes (a tree with fused_single.launch_plan):
# case -> the clusters timed beside its default plan, as CASE@C<n>
SINGLE_VARIANTS = {"golden_do": (1, 4, 8), "golden_hv": (8,),
                   "s50_amer_div": (1, 4, 8), "g121_f64": (8,)}
SINGLE_PHASES = ("setup", "events", "rhs", "pcr", "scale", "penta", "corr",
                 "update", "barrier", "out", "scatter")
PHASES = ("setup", "events", "rhs", "thomas", "penta", "corr", "trhs",
          "tthomas", "tpenta", "tcorr", "update", "out")
# the hooks' definitions prepended to the phase-clock copy of the source
# (the kernel names its phases with the PhaseId enum, NPHASE of them)
CLOCK_DEFS = r"""#include <cstdio>
#define PHASE_CLOCK_BEGIN long long pc_t = clock64(); long long pc_acc[NPHASE] = {};
#define PHASE_MARK(id) if (tid == 0) { const long long pc_n = clock64(); pc_acc[id] += pc_n - pc_t; pc_t = pc_n; }
#define PHASE_CLOCK_END if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) printf("phase_clock %d %d %d %lld %lld %lld %lld %lld %lld %lld %lld %lld %lld %lld %lld\n", (int)TAN, SCHEME, last - first_step + 1, pc_acc[0], pc_acc[1], pc_acc[2], pc_acc[3], pc_acc[4], pc_acc[5], pc_acc[6], pc_acc[7], pc_acc[8], pc_acc[9], pc_acc[10], pc_acc[11]);
"""
# the same for csrc/fused_single.cu (its PhaseId enum, NPHASE phases in
# SINGLE_PHASES order; block 0 of the cluster): scheme, steps, blocks, then
# the cycles of each phase
CLOCK_DEFS_SINGLE = r"""#include <cstdio>
#define PHASE_CLOCK_BEGIN long long pc_t = clock64(); long long pc_acc[NPHASE] = {};
#define PHASE_MARK(id) if (tid == 0) { const long long pc_n = clock64(); pc_acc[id] += pc_n - pc_t; pc_t = pc_n; }
#define PHASE_CLOCK_END if (tid == 0 && blockIdx.x == 0) { printf("phase_clock_single %d %d %d", SCHEME, n_steps - first_step + 1, (int)gridDim.x); for (int pc_q = 0; pc_q < NPHASE; ++pc_q) printf(" %lld", pc_acc[pc_q]); printf("\n"); }
"""


def parse_arm(text):
    name, _, rest = text.partition("=")
    tree, _, source = rest.partition(":")
    return name, str(Path(tree).resolve()), (str(Path(source).resolve())
                                             if source else None)


def load_arm(tree, source):
    """(package, fused_do, fused_single, assembly, cuda_build) of the
    tree, imported anew beside the arms loaded before: each arm's modules
    stay bound to each other, and sys.modules holds the last arm's."""
    for key in [k for k in sys.modules
                if k.split(".")[0] == "heston_tpu_torch"]:
        del sys.modules[key]
    sys.path.insert(0, tree)
    try:
        pkg = importlib.import_module("heston_tpu_torch")
        fused_do = importlib.import_module("heston_tpu_torch.kernels.fused_do")
        fused_single = importlib.import_module(
            "heston_tpu_torch.kernels.fused_single")
        assembly = importlib.import_module(
            "heston_tpu_torch.kernels.assembly")
        cuda_build = importlib.import_module(
            "heston_tpu_torch.kernels.cuda_build")
    finally:
        sys.path.remove(tree)
    if source is not None:
        fused_do.SOURCE = Path(source)
    return pkg, fused_do, fused_single, assembly, cuda_build


def demangle(name):
    """The kernel's template name, e.g. fused_do_kernel<float, false, 0,
    true>, else the symbol as it stands."""
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    try:
        name = subprocess.run([filt, name], capture_output=True, text=True,
                              timeout=60).stdout.strip() or name
    except OSError:
        pass
    k = re.search(r"(fused_(?:do|single)_kernel\w*<[^>]*>)", name)
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
    book(BOOK_F64, torch.linspace(70.0, 130.0, 500, dtype=torch.float64,
                                  device=dev).repeat(10), **mixed, **amer_div)
    jacobian("lm60_k4")
    jacobian("lm60_k5", v0_mode="ad")
    jacobian("lm60_k4_damped", sol=pkg.SolverConfig(
        n_steps=20, theta=0.8, maturity=1.0, a2_variant="upwind",
        solver_engine="pallas", rannacher_steps=2))
    return out


def single_cases(pkg, fused_single, dev="cuda"):
    """{case: (fields, phases, timed)} of the arm's kernel-2 cases (see the
    docstring), on `dev`; `timed`: the case is timed (else it runs only
    in the bitwise check)."""
    p = pkg.HestonParams()
    args = (100.0, p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d, p.r_f)
    amer_div = dict(american=True, dividends=pkg.GOLDEN_DIVIDENDS)
    out = {}

    def single(name, spec, sol, dtype=torch.float32, timed=True, **kw):
        fields, phases, _ = fused_single.single_plan(
            spec, sol, torch.tensor([100.0], dtype=dtype, device=dev),
            *args, **kw)
        out[name] = (fields, phases, timed)

    golden = pkg.GridSpec(m1=100, m2=75)
    for scheme in ("do", "cs", "mcs", "hv"):
        single(f"golden_{scheme}", golden, pkg.SolverConfig(
            n_steps=20, theta=0.8, maturity=1.0, a2_variant="central",
            solver_engine="pallas", scheme=scheme))
    s50 = pkg.GridSpec(m1=50, m2=25)
    sol = pkg.SolverConfig(n_steps=20, theta=0.8, maturity=1.0,
                           a2_variant="upwind", solver_engine="pallas")
    rann = pkg.SolverConfig(n_steps=20, theta=0.8, maturity=1.0,
                            a2_variant="upwind", solver_engine="pallas",
                            rannacher_steps=2)
    single("s50_amer_div", s50, sol, **amer_div)
    single("s50_rann_amer_div", s50, rann, **amer_div)
    single("g121_f64", pkg.GridSpec(m1=120, m2=100), rann,
           dtype=torch.float64, **amer_div)
    single("s50_put_amer_div", s50, sol, timed=False, option_type="put",
           **amer_div)
    single("s50_digital_amer", s50, sol, timed=False,
           option_type="digital_call", american=True)
    single("s50_up_out_amer_div", pkg.GridSpec(
        m1=50, m2=25, barrier=pkg.Barrier("up-out", 160.0)), sol,
        timed=False, **amer_div)
    single("s50_double_out_digital", pkg.GridSpec(
        m1=50, m2=25, barrier=pkg.Barrier("double-out", 80.0,
                                          level_hi=150.0)), rann,
        timed=False, option_type="digital_call", american=True)
    return out


def do_loop(fused_do, fmad=None, **forced):
    """fused_do_loop's interface with the build `fmad` and, given `forced`
    (launch_plan's smem_budget and groups), that launch plan for this card
    forced at kernel 1's one launch: the fields packed as the loop packs
    them, then `_launch_packed`."""
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


def single_loop(fused_single, fmad=None, **forced):
    """fused_single_loop's interface with the build `fmad` and, given
    `forced` (launch_plan's cluster and factors), that launch plan forced
    at kernel 2's one launch: the fields packed as the loop packs them,
    then `_launch_packed`."""
    def loop(fields, steps, remaps, **kw):
        nv, ns = fields["u"].shape
        plan = fused_single.launch_plan(
            ns, nv, fields["u"].element_size(), kw["scheme"],
            **forced) if forced else None
        return fused_single._launch_packed(
            *fused_single._pack(fields, steps, remaps), **kw, fmad=fmad,
            plan=plan)
    return loop


def forced_loop(fused_single, fields, cluster):
    """Kernel 2's loop under the plan launch_plan forces for `cluster`
    blocks (each launch's own scheme); None where that plan is not
    valid."""
    nv, ns = fields["u"].shape
    size = fields["u"].element_size()
    try:
        for scheme in ("do", "cs", "mcs", "hv"):
            fused_single.launch_plan(ns, nv, size, scheme, cluster=cluster)
    except ValueError:
        return None
    return single_loop(fused_single, cluster=cluster)


def single_device_ms(arm, case, loop=None):
    """Median over REPS calls of kernel 2's device time of one call (its
    launches summed), from torch.profiler; `loop` in place of
    fused_single_loop (a forced plan)."""
    from torch.profiler import ProfilerActivity, profile

    _, _, fused_single, assembly, _ = arm
    fields, phases, _ = case
    run = functools.partial(assembly.run_phases,
                            loop or fused_single.fused_single_loop, fields,
                            phases)
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            run()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and "fused_single_kernel" in e.name),
                    key=lambda e: e.time_range.start)
    per = len(phases)
    times = [sum(e.time_range.elapsed_us() for e in events[i:i + per]) / 1e3
             for i in range(0, len(events) - per + 1, per)]
    return statistics.median(times) if times else None


def single_bitwise(arm, case):
    """(u, lam) of the case on the -fmad=false build."""
    _, _, fused_single, assembly, _ = arm
    fields, phases, _ = case
    out = assembly.run_phases(single_loop(fused_single, fmad=False), fields,
                              phases)
    torch.cuda.synchronize()
    return out


def single_placement(fused_single, case):
    """The plan of the case's launches (None for a tree without
    fused_single.launch_plan)."""
    if not hasattr(fused_single, "launch_plan"):
        return None
    fields, phases, _ = case
    nv, ns = fields["u"].shape
    plan = fused_single.default_plan(fields["u"].dtype, ns, nv,
                                     phases[-1][2]["scheme"])
    return fused_single.occupancy(fields["u"].dtype, ns, nv,
                                  phases[-1][2]["scheme"], plan)


def run_case(arm, case, **forced):
    """The case through kernel 1's loop, under the launch plan `forced`
    (launch_plan's smem_budget and groups) where given."""
    _, fused_do, _, assembly, _ = arm
    fields, phases, tangents = case
    loop = do_loop(fused_do, **forced) if forced else fused_do.fused_do_loop
    return assembly.run_phases(loop, fields, phases, tangents)


def device_ms(arm, case):
    """Median over REPS calls of the kernel time of one call (its launches
    summed), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    run_case(arm, case)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            run_case(arm, case)
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


def clock_child_single(tree):
    """Kernel 2's phase-clock run (see the docstring): one JSON line per
    case and plan."""
    arm = load_arm(tree, None)
    pkg, _, fused_single, assembly, _ = arm
    src = fused_single.SOURCE.read_text()
    copy = Path(tree) / "build" / "phase_clock" / "fused_single.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    for header in fused_single.SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, copy.parent / header.name)
    copy.write_text(CLOCK_DEFS_SINGLE + src)
    fused_single.SOURCE = copy
    all_cases = single_cases(pkg, fused_single)
    libc = ctypes.CDLL(None)
    for name, (fields, phases, timed) in all_cases.items():
        if not timed:
            continue
        plans = [("default", {})]
        if hasattr(fused_single, "launch_plan"):
            plans.append(("one_block_global_factors",
                          dict(cluster=1, factors=False)))
        for label, forced in plans:
            loop = single_loop(fused_single, **forced)
            print(f"case {json.dumps([name, label])}", flush=True)
            assembly.run_phases(loop, fields, phases)
            torch.cuda.synchronize()
            libc.fflush(None)


def clock_child(tree):
    """The phase-clock run (see the docstring): one JSON line per case."""
    arm = load_arm(tree, None)
    pkg, fused_do, _, _, cuda_build = arm
    src = fused_do.SOURCE.read_text()
    copy = Path(tree) / "build" / "phase_clock" / "fused_do.cu"
    copy.parent.mkdir(parents=True, exist_ok=True)
    for header in fused_do.SOURCE.parent.glob("*.cuh"):
        shutil.copy(header, copy.parent / header.name)
    copy.write_text(CLOCK_DEFS + src)
    fused_do.SOURCE = copy
    with ThreadPoolExecutor(2) as pool:
        list(pool.map(lambda fmad: cuda_build.build(copy, fmad),
                      (False, True)))
    all_cases = cases(pkg, fused_do)
    libc = ctypes.CDLL(None)
    runs = [("b500", {}), ("b500", dict(smem_budget=0)),
            ("b60_euro", {}), ("b60_euro", dict(smem_budget=0)),
            ("lm60_k4", {}), ("lm60_k4", dict(smem_budget=0)),
            ("lm60_k4", dict(groups=1)), (BOOK_F64, {})]
    for name, kw in runs:
        print(f"case {json.dumps([name, kw])}", flush=True)
        run_case(arm, all_cases[name], **kw)
        torch.cuda.synchronize()
        libc.fflush(None)


def parse_clock(text):
    """[{case, placement, launches: [{tan, scheme, steps, cycles}]}] from
    the child's output (kernel 2's: [{scheme, steps, blocks, cycles}])."""
    out = []
    for line in text.splitlines():
        if line.startswith("case "):
            name, kw = json.loads(line[5:])
            out.append({"case": name, "override": kw, "launches": []})
        elif line.startswith("phase_clock_single ") and out:
            v = [int(x) for x in line.split()[1:]]
            total = sum(v[3:])
            out[-1]["launches"].append({
                "scheme": v[0], "steps": v[1], "blocks": v[2],
                "cycles": dict(zip(SINGLE_PHASES, v[3:])),
                "total_cycles": total,
                "cycles_per_step": total / max(1, v[1]),
                "share": {k: c / total for k, c in zip(SINGLE_PHASES, v[3:])
                          if c}})
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
    ap.add_argument("--kernels", default="1,2",
                    help="the kernels whose cases run: 1, 2 or 1,2")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--out", default="build/torch_book_ab.json")
    ap.add_argument("--phase-clock", action="store_true")
    ap.add_argument("--clock-arms", default=None,
                    help="the arms phase-clocked (comma-separated; "
                         "default: kernel 1's last arm, kernel 2's every "
                         "arm with hooks)")
    ap.add_argument("--clock-child", help=argparse.SUPPRESS)
    ap.add_argument("--clock-kernel", help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.clock_child:
        return (clock_child_single if opts.clock_kernel == "2"
                else clock_child)(opts.clock_child)
    if not torch.cuda.is_available() or len(opts.arm) < 2:
        raise SystemExit("torch_book_ab: needs a CUDA card and two arms")
    kernels = set(opts.kernels.split(","))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    report = {"card": smi, "arms": {a[0]: a[1:] for a in opts.arm},
              "resources": {}, "placement": {}, "runs": []}
    arms = {name: load_arm(tree, source) for name, tree, source in opts.arm}
    # every arm's builds of the kernels that run, started together
    jobs = [(name, mod, fmad) for name in arms for fmad in (False, True)
            for mod in (1, 2) if str(mod) in kernels]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda j: arms[j[0]][4].build(
            arms[j[0]][j[1]].SOURCE, j[2]), jobs))
    for (name, mod, fmad), lib in zip(jobs, libs):
        label = "fmad_true" if fmad else "fmad_false"
        report["resources"].setdefault(name, {}).setdefault(
            label, {}).update({
                k: {"registers": r, "stack": st, "local": lo}
                for k, (r, st, lo) in sorted(resource_usage(lib).items())})
    for name, by_build in report["resources"].items():
        for label, usage in by_build.items():
            print(json.dumps({"resources": name, "build": label, **usage}),
                  flush=True)
    inputs = {name: (cases(arm[0], arm[1]) if "1" in kernels else {})
              for name, arm in arms.items()}
    singles = {name: (single_cases(arm[0], arm[2]) if "2" in kernels
                      else {}) for name, arm in arms.items()}
    for name, (_, fused_do, fused_single, _, _) in arms.items():
        rows = {c: placement(fused_do, case)
                for c, case in inputs[name].items()}
        rows.update({c: single_placement(fused_single, case)
                     for c, case in singles[name].items() if case[2]})
        if any(rows.values()):
            report["placement"][name] = rows
            print(json.dumps({"placement": name, **rows}), flush=True)
    # kernel 2 on the -fmad=false build: every case's u and lambda, each
    # arm against the first, bit for bit
    if singles[next(iter(arms))]:
        first = next(iter(arms))
        want = {c: single_bitwise(arms[first], case)
                for c, case in singles[first].items()}
        report["single_bitwise"] = {}
        for name in list(arms)[1:]:
            rows = {}
            for c, case in singles[name].items():
                got = single_bitwise(arms[name], case)
                rows[c] = {
                    "equal": all(torch.equal(g, w)
                                 for g, w in zip(got, want[c])),
                    "max_abs": max(float((g.double() - w.double()).abs()
                                         .max()) for g, w in zip(got,
                                                                 want[c]))}
            report["single_bitwise"][name] = rows
            print(json.dumps({"single_bitwise": name, "vs": first, **rows}),
                  flush=True)
    # kernel 1 on the float64 book on its main-path build: u and lambda,
    # each arm against the first, bit for bit
    if BOOK_F64 in inputs[next(iter(arms))]:
        first = next(iter(arms))
        want = run_case(arms[first], inputs[first][BOOK_F64])
        report["book_bitwise"] = {}
        for name in list(arms)[1:]:
            got = run_case(arms[name], inputs[name][BOOK_F64])
            torch.cuda.synchronize()
            row = {"equal": all(torch.equal(g, w) for g, w in zip(got, want)),
                   "max_abs": max(float((g - w).abs().max())
                                  for g, w in zip(got, want))}
            report["book_bitwise"][name] = row
            print(json.dumps({"book_bitwise": name, "vs": first,
                              BOOK_F64: row}), flush=True)
        del want, got
    order = list(arms)
    for r in range(opts.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            _, fused_do, fused_single, _, _ = arms[name]
            times = {c: device_ms(arms[name], case)
                     for c, case in inputs[name].items()}
            times.update({c: single_device_ms(arms[name], case)
                          for c, case in singles[name].items() if case[2]})
            if hasattr(fused_single, "launch_plan"):
                for c, clusters in SINGLE_VARIANTS.items():
                    if c not in singles[name]:
                        continue
                    for cl in clusters:
                        loop = forced_loop(fused_single, singles[name][c][0],
                                           cl)
                        if loop is not None:
                            times[f"{c}@C{cl}"] = single_device_ms(
                                arms[name], singles[name][c], loop)
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
        children = []
        wanted = set(opts.clock_arms.split(",")) if opts.clock_arms else None
        if "1" in kernels:
            children += [("1", name, tree) for name, tree, _ in opts.arm
                         if name in (wanted or {opts.arm[-1][0]})]
        if "2" in kernels:
            children += [("2", name, tree) for name, tree, _ in opts.arm
                         if name in (wanted or set(arms))
                         and "PHASE_CLOCK_BEGIN"
                         in arms[name][2].SOURCE.read_text()]
        report["phase_clock"] = {"runs": []}
        for kernel, name, tree in children:
            proc = subprocess.run([sys.executable, __file__, "--clock-child",
                                   tree, "--clock-kernel", kernel],
                                  capture_output=True, text=True,
                                  timeout=1500)
            if proc.returncode != 0:
                raise RuntimeError(f"phase clock: rc {proc.returncode}\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            for row in parse_clock(proc.stdout):
                row.update(kernel=kernel, arm=name)
                report["phase_clock"]["runs"].append(row)
                print(json.dumps({"phase_clock": row}), flush=True)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        report["phase_clock"]["sm_clock"] = clocks
        print(json.dumps({"sm_clock": clocks}), flush=True)
    Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
    Path(opts.out).write_text(json.dumps(report, indent=1))
    print(smi)
    unequal = [(name, c) for name, rows in report.get(
        "single_bitwise", {}).items() for c, row in rows.items()
        if not row["equal"]]
    if unequal:
        print(f"torch_book_ab: kernel 2's -fmad=false u or lambda differs "
              f"from the first arm's in {unequal}", file=sys.stderr)
    book_unequal = [name for name, row in report.get(
        "book_bitwise", {}).items() if not row["equal"]]
    if book_unequal:
        print(f"torch_book_ab: kernel 1's {BOOK_F64} u or lambda differs "
              f"from the first arm's in {book_unequal}", file=sys.stderr)
    return 1 if unequal or book_unequal else 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that the limits of `correct` are set from: for each seed,
the numbers a run compares for the program and for the control (the
plain reference computed in bfloat16, the precision below the
configuration's float32, put in the program's place), on the requests a
run's check would sample (the seed's first `check_sample` requests).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 \
        [--sides program,control]

prints one JSON line per seed and side: {"seed", "side", "checks",
"not_finite"}. It runs on the card, as a run does; the benchmark's runs
do not run it.
"""

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _finite(out) -> bool:
    import torch

    x = out["params"] if isinstance(out, dict) else out
    return bool(torch.isfinite(x).all())


def readings(cell: str, seeds, sides, device):
    """Yield (seed, side, checks, not_finite) of `cell` on `device`. The
    control's checks are of its answers that are numbers, and not_finite
    counts the others: a diverging answer fails by itself, but sets no
    reading."""
    import torch

    from perfbench import run, traffic

    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    _, cfg, mix, _, _ = run.load_cell(cell, bench)
    work = run.load_kind(mix["kind"]).Workload(cfg, mix, device)
    for fields in traffic.Stream(mix, 0).warm():
        work.call(work.prepare(fields))
    for seed in seeds:
        stream = traffic.Stream(mix, seed)
        reqs = [work.prepare(stream.fields(i))
                for i in range(mix["check_sample"])]
        for side in sides:
            call = work.call if side == "program" else work.control
            done = [(r, call(r)) for r in reqs]
            kept = done if side == "program" else [
                (r, o) for r, o in done if _finite(o)]
            yield (seed, side, work.check(kept) if kept else [],
                   len(done) - len(kept))
            del done, kept
            if device.type == "cuda":
                torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--sides", default="program,control")
    args = p.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch

    if not torch.cuda.is_available():
        print("control: no card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for seed, side, checks, not_finite in readings(
            args.workload, [int(s) for s in args.seeds.split(",")],
            args.sides.split(","), torch.device("cuda", 0)):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "side": side,
                          "checks": {c.name: c.value for c in checks},
                          "not_finite": not_finite}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

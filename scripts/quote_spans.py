"""Where a quote's host time goes, by the program's own spans: the
benchmark's `quote.golden` cell (BENCHMARK.json; its configuration,
traffic and kind under perfbench/) driven closed-loop as
`perfbench/run.py` drives it, once without a profiler and once under
`torch.profiler` with the program's `heston.*` spans on.

    python3 scripts/quote_spans.py [--program DIR] [--seed N] \
        [--requests N] [--stack 3] [--device cuda] [--out FILE]

`--program`: the directory whose heston_tpu_torch package runs (default
the checkout itself; e.g. a parent commit unpacked with `git archive`).
The same requests (the seed's first `--requests`, after one warm request
of each product) run in both windows. Prints one JSON line:

* `untraced_ms`, `traced_ms`: each window's quote latencies on the host
  clock (median, p95, mean), so the difference is what tracing costs;
* `window_s`, `busy_s`, `device_ops`, `idle_gaps`: the traced window as
  `perfbench/trace.py` reads it, and the idle time a quote;
* `spans`: per span name (`perfbench/spans.py`), a quote: spans, ms under
  the span, device-idle ms under it, blocking runtime calls in it; each
  span of the quote path (`SPANS`) that the window does not hold reads
  "absent" (a card quote builds its plan on the card, so it opens no
  `assemble` and no `remaps`);
* `device_side_spans`: the spans' copies on the device's timeline, each
  name's count and how many of them are user annotations;
* with `--stack N`: N more quotes (each product in turn) profiled with
  Python stacks, and each blocking runtime call's innermost enclosing
  operation and the program's frames above it (`sync_sites`).

Runs on the card (`--device cuda`, the default) or, to rehearse at small
`--requests`, on the CPU with the kernels' plain versions (no device
operations: every span reads idle).
"""

import argparse
import json
import statistics
import sys
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CELL = "quote.golden"
# the spans of the quote path (heston_tpu_torch.utils.profiling)
SPANS = ("price_batch", "single_plan", "assemble", "remaps", "loop")


def latency_ms(records) -> dict:
    ms = sorted(1e3 * r["latency_s"] for r in records if r["ok"])
    return dict(n=len(ms), median=statistics.median(ms),
                p95=ms[max(0, -(-95 * len(ms) // 100) - 1)],
                mean=statistics.fmean(ms))


def sync_sites(events, names) -> Counter:
    """Each host event named in `names` (the blocking runtime calls), by
    its innermost enclosing operation and the program's innermost Python
    frames around it (the profiler's Python function events), counted."""
    import torch

    host = [e for e in events
            if e.device_type != torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    sites = Counter()
    for e in host:
        if e.name not in names:
            continue
        t = e.time_range.start

        def around(keep):
            inside = [o for o in host if o is not e and keep(o)
                      and o.time_range.start <= t <= o.time_range.end]
            return sorted(inside, key=lambda o: o.time_range.end
                          - o.time_range.start)

        ops = around(lambda o: not getattr(o, "is_python_function", False))
        frames = around(lambda o: getattr(o, "is_python_function", False)
                        and ("heston_tpu_torch" in o.name
                             or "perfbench" in o.name))
        where = [ops[0].name if ops else "?"] + [f.name for f in frames[:2]]
        sites[f"{e.name} <- {' <- '.join(where)}"] += 1
    return sites


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--program", default=str(REPO))
    ap.add_argument("--seed", type=int, default=1500000001)
    ap.add_argument("--requests", type=int, default=102)
    ap.add_argument("--stack", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    opts = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    import torch
    from torch.profiler import ProfilerActivity, profile

    # the checkout's benchmark, then the program of --program
    from perfbench import run, spans, trace, traffic
    sys.path.insert(0, str(Path(opts.program).resolve()))
    import heston_tpu_torch

    device = torch.device(opts.device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("quote_spans: no card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    with open(REPO / "BENCHMARK.json") as f:
        cell, cfg, mix, _, _ = run.load_cell(CELL, json.load(f))
    work = run.load_kind(mix["kind"]).Workload(cfg, mix, device)
    stream = traffic.Stream(mix, opts.seed)
    for fields in stream.warm():
        work.call(work.prepare(fields))
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    # the profiler's own start-up, outside both windows
    with profile(activities=acts):
        run.run_requests(work, stream.warm().__getitem__, 0, 1e9, limit=1,
                         span=True)

    def window(span):
        records, _, _ = run.run_requests(work, stream.fields, 0, 1e9,
                                         limit=opts.requests, span=span)
        if cuda:
            torch.cuda.synchronize()
        return records

    untraced = window(False)
    with profile(activities=acts) as prof:
        traced = window(True)
    events = prof.events()
    reading = trace.read(events)
    rec = dict(requests=traced, trace=dict(spans=spans.read(events)))
    done = sum(1 for r in traced if r["ok"])
    per = spans.per_request
    found = [n[len(spans.PREFIX):] for n in rec["trace"]["spans"]]
    out = dict(
        program=str(Path(heston_tpu_torch.__file__).parent),
        device=torch.cuda.get_device_name(device) if cuda else "cpu",
        seed=opts.seed, quotes=done, failed=len(traced) - done,
        untraced_ms=latency_ms(untraced), traced_ms=latency_ms(traced),
        window_s=reading["window_s"], busy_s=reading["busy_s"],
        device_ops=reading["device_ops"],
        idle_ms_a_quote=1e3 * (reading["window_s"] - reading["busy_s"])
        / done,
        idle_gaps=reading["idle_gaps"],
        spans={n: dict(spans=per(rec, n, "count"),
                       ms=per(rec, n, "seconds", 1e3),
                       idle_ms=per(rec, n, "idle_s", 1e3),
                       syncs=per(rec, n, "syncs"))
               if n in found else "absent"
               for n in dict.fromkeys(SPANS + tuple(found))})
    # the spans' copies on the device's timeline, which trace.read leaves
    # out as user annotations: {name: [events, of them user annotations]}
    device_side = {}
    for e in events:
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and e.name.startswith((spans.PREFIX, trace.REQUEST_SPAN))):
            n = device_side.setdefault(e.name, [0, 0])
            n[0] += 1
            n[1] += bool(getattr(e, "is_user_annotation", False))
    out["device_side_spans"] = device_side
    if opts.stack:
        with profile(activities=acts, with_stack=True) as prof:
            run.run_requests(work, stream.fields, 0, 1e9, limit=opts.stack,
                             span=True)
            if cuda:
                torch.cuda.synchronize()
        out["sync_sites"] = dict(sync_sites(
            prof.events(), spans.SYNCS).most_common())
    if cuda:
        out["builds"] = run.snapshot(run.load_counters())
    line = json.dumps(out)
    print(line, flush=True)
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        with open(opts.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

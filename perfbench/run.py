"""One run of one cell of the benchmark of heston_tpu_torch.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. It reads the cell's entry in BENCHMARK.json, its configuration
(`configs/<config>.json`), its traffic mix (`traffic/<mix>.json`, whose
`kind` names the entry the window drives, `kinds/<kind>.py`) and the
reader of each of the cell's per-layer metrics (`metrics/<name>.py`).
It makes the requests from the seed, warms up the cell's shapes with one
request of each product the mix cycles through, and then runs the
requests closed-loop, one caller, each from the call to its result on the
host:

* `--trace 0`: for `--seconds` (the window closes when the request in
  flight at that point returns), and prints the cell's end-to-end
  metrics (`endtoend.py`);
* `--trace 1`: under the profiler, for the mix's `trace_requests`
  requests or `--seconds`, whichever ends first, and prints the cell's
  per-layer metrics, the device's busy time and the traced window, and
  the breakdown of device time and idle gaps.

A request whose call raises, or that does not make the kernel launches
its entry must make (counted by the program, `counters/launches.py`),
fails. Every counter file under `counters/` is read around each request,
and what it counted is kept in the request's record, beside the
request's latency; the per-layer readers get the records, the window,
the set-up time, the trace's reading and the device's facts (memory
peak, busy and window seconds). Once the window has
closed and the memory peak is read, a sample of the requests drawn from
the seed is held against the plain reference (`reference/`); the numbers
compared and their limits are the last lines on standard error and the
last key (`checks`) of the result line, the last line on standard
output. `correct` is true when no request failed and every number is
within its limit.

Exits with 2 and prints no result when there is no card, too few cards,
or no program to run; with 3 when JAX or the JAX package is loaded once
the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
# the program and the JAX package are told apart by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "heston_tpu")


def _load_file(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(name: str, bench: dict):
    """(cell, configuration, mix, end-to-end metrics, per-layer metrics)
    of the cell `name` in `bench` (BENCHMARK.json's contents)."""
    from perfbench import traffic

    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"perfbench: no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(REPO / cfg_entry["file"]) as f:
        cfg = json.load(f)
    mix = traffic.load_mix(cell["traffic"])

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return (cell, cfg, mix, mine(bench["end_to_end"]),
            mine(bench["per_layer"]))


def load_kind(kind: str):
    return _load_file(ROOT / "kinds" / f"{kind}.py", f"perfbench.kinds.{kind}")


def load_reader(metric: str):
    return _load_file(ROOT / "metrics" / f"{metric}.py",
                      f"perfbench.metrics.{metric}").read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_counters() -> dict:
    """The read function of each counter file (`counters/<name>.py`), by
    name: each returns the program's cumulative counts {key: number}."""
    return {p.stem: _load_file(p, f"perfbench.counters.{p.stem}").read
            for p in sorted((ROOT / "counters").glob("*.py"))}


def snapshot(counters: dict) -> dict:
    return {f"{name}.{key}": value for name, read in counters.items()
            for key, value in read().items()}


def run_requests(work, fields_at, first: int, seconds: float, limit=None,
                 span: bool = False):
    """Closed loop from request index `first` (`fields_at(i)` the fields
    of request i): start requests until `seconds` have passed (or `limit`
    requests ran). Returns (records, outputs, window_s); each record: ok,
    latency_s, counters (what each program counter counted during
    the request, `counters/`), traced (the kind's bounds and counts, with
    `span`)."""
    count = work.dep.device.type == "cuda"
    counters = load_counters()
    if span:
        from torch.profiler import record_function

        from perfbench.trace import REQUEST_SPAN
    records, outputs = [], []
    t0 = time.perf_counter()
    i = first
    while time.perf_counter() - t0 < seconds and (limit is None
                                                   or i - first < limit):
        request = work.prepare(fields_at(i))
        before = snapshot(counters)
        start = time.perf_counter()
        try:
            if span:
                with record_function(REQUEST_SPAN):
                    out = work.call(request)
            else:
                out = work.call(request)
            latency = time.perf_counter() - start
            made = {k: v - before.get(k, 0)
                    for k, v in snapshot(counters).items()}
            want = {f"launches.{k}": v for k, v in
                    work.expected_launches(request, out).items()}
            # the plain versions the program runs on the CPU count nothing
            ok = not count or all(made.get(k) == v for k, v in want.items())
            if not ok:
                print(f"perfbench: request {i} made launches "
                      f"{ {k: made.get(k) for k in want} }, want {want}",
                      file=sys.stderr)
        except Exception as exc:    # a failed request; the loop goes on
            latency, out, ok, made = (time.perf_counter() - start, None,
                                      False, {})
            print(f"perfbench: request {i} failed: {exc!r}", file=sys.stderr)
        rec = dict(ok=ok, latency_s=latency, counters=made)
        if span and ok:
            rec["traced"] = work.traced(request, out)
        records.append(rec)
        outputs.append((request, out))
        i += 1
    return records, outputs, time.perf_counter() - t0


def measure(args, cell, cfg, mix, e2e, per_layer, device):
    """One run on `device`: the result line's dict and the checks."""
    import torch

    from perfbench import endtoend, trace, traffic

    work = load_kind(mix["kind"]).Workload(cfg, mix, device)
    stream = traffic.Stream(mix, args.seed)
    # warm-up: one request of each product of the mix (the combinations
    # it cycles through), market states drawn apart from the timed ones
    warm = stream.warm()
    for fields in warm:
        work.call(work.prepare(fields))
    reading = {}
    if args.trace:
        # the profiler's own start-up, on one request outside the window
        with trace.profiled({}):
            run_requests(work, warm.__getitem__, 0, args.seconds, limit=1,
                         span=True)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    if args.trace:
        with trace.profiled(reading):
            records, outputs, window_s = run_requests(
                work, stream.fields, 0, args.seconds,
                limit=mix["trace_requests"], span=True)
    else:
        records, outputs, window_s = run_requests(work, stream.fields, 0,
                                                  args.seconds)
    if device.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    info = device_info(device, cell["chips"], peak, reading)
    rec = dict(requests=records, window_s=window_s, setup_s=setup_s,
               trace=reading, device=info)
    metrics = {}
    if args.trace:
        for m in per_layer:
            value = load_reader(m["name"])(rec)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e:
            metrics[m["name"]] = {"value": endtoend.METRICS[m["name"]](rec),
                                  "unit": m["unit"]}
    # the check: a sample drawn from the seed of the requests that
    # returned, against the reference, once the program's state is freed
    done = [outputs[i] for i in stream.sample(len(outputs),
                                              mix["check_sample"])
            if records[i]["ok"]]
    del outputs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = work.check(done) if done else []
    failed = sum(1 for r in records if not r["ok"])
    result = dict(
        correct=bool(done) and failed == 0 and all(c.ok for c in checks),
        attempted=len(records), failed=failed, metrics=metrics,
        device=info)
    if args.trace:
        result["breakdown"] = {"device_ops": reading["top_device_ops"],
                               "idle_gaps": reading["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return result, checks


def device_info(device, chips: int, peak: int, reading: dict) -> dict:
    import torch

    if device.type != "cuda":
        return dict(platform=device.type, kind=device.type, count=chips,
                    memory_peak_bytes=peak, **_busy(reading))
    info = dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=chips, memory_peak_bytes=peak, **_busy(reading))
    try:
        info["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return info


def _busy(reading: dict) -> dict:
    if not reading:
        return {}
    return dict(busy_s=reading["busy_s"], window_s=reading["window_s"])


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    sys.path.insert(0, str(REPO))
    cell, cfg, mix, e2e, per_layer = load_cell(args.workload, bench)
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import heston_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"perfbench: the program is not there ({exc}): run from the "
              f"root of a checkout", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # one caller: the host's work is the program's dispatch, in one thread
    torch.set_num_threads(1)
    result, checks = measure(args, cell, cfg, mix, e2e, per_layer,
                             torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded once the window closed: {bad}",
              file=sys.stderr)
        return 3
    for c in checks:
        print(f"check {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(_json_numbers(result), allow_nan=False), flush=True)
    return 0


def _json_numbers(x):
    """x with every float that is not finite (a p95 over failed requests,
    a gap of a diverging answer) as null: strict JSON has no inf or NaN."""
    if isinstance(x, dict):
        return {k: _json_numbers(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_json_numbers(v) for v in x]
    if isinstance(x, float) and not math.isfinite(x):
        return None
    return x


if __name__ == "__main__":
    sys.exit(main())

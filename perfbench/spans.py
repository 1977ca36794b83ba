"""Reading the program's own spans in a traced window.

The program opens a span `heston.<name>` at each of its layer
boundaries while a profiler records (`heston_tpu_torch.utils.profiling.
scope`): host-side user annotations on the profiler's clock, the clock of
the device's operations. From the profiler's events this module keeps
those spans, clipped to the traced window as `trace.read` clips (the
first request span's start to the last one's end), and the device's
operations by `trace.read`'s own rule. For each span name it gives:

* `count`: the spans of that name in the window;
* `seconds`: the length of the union of their intervals (a span nested
  in another of its name counts once);
* `idle_s`: the part of that union in which no device operation ran;
* `syncs`: the blocking runtime calls (`SYNCS`) that start inside it.

`trace.read` leaves every user annotation but the request span out of its
reading, so the spans change none of its numbers.
"""

from __future__ import annotations

from collections import defaultdict

from perfbench.trace import REQUEST_SPAN, _union

PREFIX = "heston."
# the runtime calls that hold the host until the device has drained
SYNCS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"))


def _overlap(a, b) -> float:
    """The length of the intersection of two merged interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(events) -> dict:
    """{span name: {count, seconds, idle_s, syncs}} of a profiler's
    events; {} where the window holds no request span."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, requests, syncs = [], [], []
    spans = defaultdict(list)
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name == REQUEST_SPAN:
            if e.device_type != cuda:
                requests.append((s, t))
        elif getattr(e, "is_user_annotation", False):
            if e.device_type != cuda and e.name.startswith(PREFIX):
                spans[e.name].append((s, t))
        elif e.device_type == cuda:
            dev.append((s, t))
        elif e.name in SYNCS:
            syncs.append(s)
    if not requests:
        return {}
    w0 = min(s for s, _ in requests)
    w1 = max(t for _, t in requests)

    def clip(intervals):
        return sorted((max(s, w0), min(t, w1)) for s, t in intervals
                      if t > w0 and s < w1)

    busy = _union(clip(dev))
    syncs.sort()
    us = 1e-6
    out = {}
    for name, intervals in sorted(spans.items()):
        inside = clip(intervals)
        if not inside:
            continue
        merged = _union(inside)
        length = sum(t - s for s, t in merged)
        n_sync, k = 0, 0
        for s, t in merged:
            while k < len(syncs) and syncs[k] < s:
                k += 1
            while k < len(syncs) and syncs[k] <= t:
                n_sync += 1
                k += 1
        out[name] = dict(count=len(inside), seconds=length * us,
                         idle_s=(length - _overlap(merged, busy)) * us,
                         syncs=n_sync)
    return out


def per_request(rec, name: str, key: str, scale: float = 1.0):
    """`key` of the span `heston.<name>` in a run's record (its trace
    reading's `spans`), times `scale`, over the requests completed; None
    where the window holds no such span."""
    span = rec["trace"].get("spans", {}).get(PREFIX + name)
    done = sum(1 for r in rec["requests"] if r["ok"])
    if span is None or not done:
        return None
    return span[key] * scale / done

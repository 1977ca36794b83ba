"""Reading the device trace of a traced window (`--trace 1`).

The window runs under `torch.profiler` with host and CUDA activities;
each request is wrapped in a host span named REQUEST_SPAN. From the
profiler's events this module keeps the device operations (kernels,
copies, sets) and the host operations, and works out:

* the traced window: from the start of the first request span to the end
  of the last;
* the device's busy time: the union of the device operations' intervals
  inside the window (operations that overlap count once);
* the idle gaps: the rest of the window, each named by the innermost host
  operation that spans its midpoint (or by the request span alone, or
  "between requests");
* the device time by operation name, and the device time of the kernels
  of the program by kind (kernel 1's primal and forward-mode
  instantiations, kernel 2).
"""

from __future__ import annotations

import contextlib
import re
from collections import defaultdict

REQUEST_SPAN = "perfbench.request"

# fused_do_kernel<T, TAN, SCHEME, GEN, SMEM>: TAN = true is the
# forward-mode instantiation (demangled ", true," or ", (bool)1,", mangled
# "Lb1E" right after the type)
_TANGENT = re.compile(r"fused_do_kernel(<[^,]+, (true|\(bool\)1),|I[fd]Lb1E)")


def kernel_kind(name: str):
    """'kernel1', 'kernel1_fwd', 'kernel2' or None for a device operation's
    name."""
    if "fused_single_kernel" in name:
        return "kernel2"
    if "fused_do_kernel" in name:
        return "kernel1_fwd" if _TANGENT.search(name) else "kernel1"
    return None


@contextlib.contextmanager
def profiled(out: dict):
    """Profile the body (host and CUDA activities); on exit fill `out`
    with the trace's reading (`read`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    with profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])) as prof:
        yield
        if cuda:
            torch.cuda.synchronize()
    out.update(read(prof.events()))


def _union(intervals):
    """Merged [start, end) intervals of a list sorted by start."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def read(events) -> dict:
    """The reading of a profiler's events (times in seconds)."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host, spans = [], [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if e.name == REQUEST_SPAN:
            # the span is also recorded on the device's timeline, as an
            # annotation and not an operation
            if e.device_type != cuda:
                spans.append((s, t))
        elif getattr(e, "is_user_annotation", False):
            continue
        elif e.device_type == cuda:
            dev.append((s, t, e.name))
        else:
            host.append((s, t, e.name))
    if not spans:
        raise RuntimeError("the traced window holds no request span")
    w0, w1 = min(s for s, _ in spans), max(t for _, t in spans)
    dev = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev
                 if t > w0 and s < w1)
    busy = _union([(s, t) for s, t, _ in dev])
    by_name, by_kind = defaultdict(float), defaultdict(float)
    counts = defaultdict(int)
    for s, t, n in dev:
        by_name[n] += t - s
        kind = kernel_kind(n)
        if kind:
            by_kind[kind] += t - s
            counts[kind] += 1
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    # the host operations nest: a sweep in time order keeps the chain of
    # operations open at each point, whose top is the innermost
    host.sort()
    mids = sorted((0.5 * (a + b), b - a) for a, b in gaps)
    spans.sort()
    idle = defaultdict(float)
    stack, h, r = [], 0, 0
    for mid, length in mids:
        while h < len(host) and host[h][0] <= mid:
            while stack and stack[-1][1] < host[h][0]:
                stack.pop()
            stack.append(host[h])
            h += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        while r < len(spans) and spans[r][1] < mid:
            r += 1
        in_request = r < len(spans) and spans[r][0] <= mid
        name = (stack[-1][2] if stack and in_request else
                REQUEST_SPAN if in_request else "between requests")
        idle[name] += length
    us = 1e-6
    return dict(
        window_s=(w1 - w0) * us,
        busy_s=sum(t - s for s, t in busy) * us,
        device_ops=len(dev),
        kernel_s={k: v * us for k, v in by_kind.items()},
        kernel_launches=dict(counts),
        top_device_ops=[[n, v * us] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[n, v * us] for n, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10] if v > 0])

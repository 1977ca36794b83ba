"""What the per-layer metrics read from a traced window's record.

A record holds `requests` (per request of the traced window: `ok`,
`latency_s`, `counters`, what each program counter of `counters/`
counted during it, and `traced`, the kind's frozen bounds and counts for
it), `window_s`, `setup_s`, `trace`, the device trace's reading
(`trace.read`), and `device`, the run's device facts
(`memory_peak_bytes`, `busy_s`, `window_s`). Each function returns None
where the window holds nothing to read, and the harness then leaves the
metric out of the result line. Each metric's own file under `metrics/` names
the function and the arguments it takes.
"""

from __future__ import annotations


def _done(rec):
    return [r for r in rec["requests"] if r["ok"]]


def _per_request(rec, value):
    done = _done(rec)
    return value / len(done) if done and value is not None else None


def other_device_ops(rec, kernel: str):
    """Device operations a request, besides the launches of `kernel`."""
    t = rec["trace"]
    return _per_request(rec, t["device_ops"]
                        - t["kernel_launches"].get(kernel, 0))


def kernel_ms(rec, kernel: str):
    """The device time of `kernel` a request, in ms."""
    s = rec["trace"]["kernel_s"].get(kernel)
    return _per_request(rec, None if s is None else 1e3 * s)


def roofline_pct(rec, kernel: str, bound: str):
    """The frozen bound of the window's launches of `kernel` (the sum of
    each request's `bound`) over their device time, in %."""
    s = rec["trace"]["kernel_s"].get(kernel)
    if not s:
        return None
    return 100.0 * sum(r["traced"][bound] for r in _done(rec)) / (1e3 * s)


def idle_pct(rec):
    """The share of the traced window in which no device operation ran."""
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def count_per_request(rec, key: str):
    """A count the program reports (such as LM iterations), a request."""
    return _per_request(rec, sum(r["traced"][key] for r in _done(rec)))


def device_ops_per(rec, key: str):
    """Device operations over a count the program reports."""
    n = sum(r["traced"][key] for r in _done(rec))
    return rec["trace"]["device_ops"] / n if n else None

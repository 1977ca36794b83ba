"""The arithmetic of the end-to-end metrics, from the record of a measured
window (no device trace: these come from the host clock alone).

A window record holds `window_s` (from the start of the first timed
request to the end of the last; the loop starts no request once
`--seconds` have passed and the window closes when the request in flight
returns), `setup_s` (process start to the first timed request) and
`requests`: one dict per request started in the window, with `ok`
(returned, with the launches the entry must make) and `latency_s` (the
call to the result on the host). A failed request completes no work and
counts as beyond every latency limit.
"""

from __future__ import annotations

import math


def percentile_ms(rec, q: float) -> float:
    """The q-th percentile (nearest rank) of every request's latency in ms;
    a failed request reads +inf."""
    lat = sorted(1e3 * r["latency_s"] if r["ok"] else math.inf
                 for r in rec["requests"])
    return lat[max(0, math.ceil(q / 100.0 * len(lat)) - 1)]


def seconds_per_request(rec) -> float:
    """The window over the requests completed in it."""
    done = sum(1 for r in rec["requests"] if r["ok"])
    return rec["window_s"] / done if done else math.inf


METRICS = {
    "setup_s": lambda rec: rec["setup_s"],
    "quote_p95_ms": lambda rec: percentile_ms(rec, 95.0),
    "fit_s": seconds_per_request,
}

"""The arithmetic of the end-to-end metrics on synthetic records."""

import math

from perfbench import endtoend


def rec(lat, ok=None, window=2.0):
    ok = ok or [True] * len(lat)
    return dict(window_s=window, setup_s=12.5, requests=[
        dict(ok=o, latency_s=x) for x, o in zip(lat, ok)])


def test_fit_seconds():
    assert endtoend.METRICS["fit_s"](rec([0.4] * 5, window=2.1)) == 2.1 / 5
    r = rec([0.4] * 5, ok=[True, True, False, True, True], window=2.0)
    assert endtoend.METRICS["fit_s"](r) == 0.5


def test_p95_of_every_request():
    lat = [i / 1000.0 for i in range(1, 101)]          # 1..100 ms
    assert endtoend.METRICS["quote_p95_ms"](rec(lat)) == 95.0
    ok = [True] * 94 + [False] * 6                      # 6 failures
    assert math.isinf(endtoend.METRICS["quote_p95_ms"](rec(lat, ok)))
    ok = [False] + [True] * 99                          # one failure
    assert endtoend.METRICS["quote_p95_ms"](rec(lat, ok)) == 96.0


def test_setup():
    assert endtoend.METRICS["setup_s"](rec([0.1])) == 12.5

"""The reading of the program's spans (`spans.py`) on synthetic profiler
events, the trace's reading unchanged by them, and the build counters and
their metric."""

from types import SimpleNamespace

import pytest
import torch

from perfbench import run, spans, trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
US = 1e-6


def ev(name, start, end, device=CPU, annotation=False):
    return SimpleNamespace(name=name, device_type=device,
                           is_user_annotation=annotation,
                           time_range=SimpleNamespace(start=start, end=end))


def span(name, start, end, device=CPU):
    return ev(name, start, end, device, annotation=True)


def window():
    """Two requests, [0, 100] and [110, 200] us, with host and device
    operations and the request spans' device-side annotations."""
    return [span(trace.REQUEST_SPAN, 0, 100),
            span(trace.REQUEST_SPAN, 110, 200),
            span(trace.REQUEST_SPAN, 20, 95, CUDA),
            ev("aten::mul", 12, 18), ev("cudaLaunchKernel", 14, 16),
            ev("aten::copy_", 50, 70), ev("cudaStreamSynchronize", 55, 68),
            ev("cudaMemcpyAsync", 52, 54), ev("cudaMemcpy", 120, 130),
            ev("cudaStreamSynchronize", 165, 167),
            ev("void elementwise_kernel", 20, 30, CUDA),
            ev("fused_single_kernel<float, 0, 1>", 60, 90, CUDA),
            ev("Memcpy HtoD", 125, 128, CUDA)]


def program_spans():
    """Spans on both timelines (the device-side ones as the profiler
    derives them from the kernels launched inside)."""
    return [span("heston.price_batch", 10, 95),
            span("heston.assemble", 10, 40), span("heston.loop", 50, 92),
            span("heston.price_batch", 115, 160),
            span("heston.assemble", 115, 140),
            span("heston.price_batch", 20, 90, CUDA),
            span("heston.loop", 60, 90, CUDA)]


def test_idle_time_goes_to_the_span_it_falls_in():
    got = spans.read(window() + program_spans())
    assert set(got) == {"heston.price_batch", "heston.assemble",
                        "heston.loop"}
    # assemble [10, 40] and [115, 140]: busy 20-30 and 125-128
    a = got["heston.assemble"]
    assert a["count"] == 2
    assert a["seconds"] == pytest.approx(55 * US)
    assert a["idle_s"] == pytest.approx((55 - 10 - 3) * US)
    # loop [50, 92]: busy 60-90
    assert got["heston.loop"]["idle_s"] == pytest.approx(12 * US)
    p = got["heston.price_batch"]
    assert p["seconds"] == pytest.approx((85 + 45) * US)
    assert p["idle_s"] == pytest.approx((130 - 10 - 30 - 3) * US)


def test_nested_spans_of_one_name_count_once():
    got = spans.read(window() + [span("heston.assemble", 10, 40),
                                 span("heston.assemble", 20, 30),
                                 span("heston.assemble", 35, 45)])
    a = got["heston.assemble"]
    assert a["count"] == 3
    assert a["seconds"] == pytest.approx(35 * US)
    assert a["idle_s"] == pytest.approx(25 * US)


def test_syncs_inside_and_outside_the_spans():
    got = spans.read(window() + program_spans())
    # the stream sync at 55 (price_batch and loop), the blocking memcpy at
    # 120 (the second price_batch and assemble); not the async copy, not
    # the sync at 165, which no span holds
    assert got["heston.loop"]["syncs"] == 1
    assert got["heston.price_batch"]["syncs"] == 2
    assert got["heston.assemble"]["syncs"] == 1


def test_spans_are_clipped_to_the_window():
    got = spans.read(window() + [span("heston.loop", -50, 10),
                                 span("heston.loop", 190, 260),
                                 span("heston.remaps", 300, 310)])
    assert "heston.remaps" not in got
    assert got["heston.loop"]["count"] == 2
    assert got["heston.loop"]["seconds"] == pytest.approx(20 * US)


def test_no_request_span_no_reading():
    assert spans.read([span("heston.loop", 0, 10)]) == {}


def test_trace_reading_is_the_same_with_the_program_spans():
    assert trace.read(window() + program_spans()) == trace.read(window())


@pytest.mark.parametrize("name,key", [
    ("single_plan", "seconds"), ("assemble", "seconds"),
    ("remaps", "seconds"), ("loop", "seconds"), ("price_batch", "idle_s"),
    ("price_batch", "syncs")])
def test_per_request_is_none_without_spans(name, key):
    ok = [dict(ok=True)] * 3
    assert spans.per_request(dict(requests=ok, trace={}), name, key) is None
    assert spans.per_request(dict(requests=ok, trace=dict(spans={})), name,
                             key) is None
    reading = {spans.PREFIX + name: dict(count=3, seconds=6e-3, idle_s=3e-3,
                                         syncs=9)}
    rec = dict(requests=ok, trace=dict(spans=reading))
    assert spans.per_request(rec, name, key) == reading[
        spans.PREFIX + name][key] / 3
    rec["requests"] = [dict(ok=False)]
    assert spans.per_request(rec, name, key) is None


def test_build_counters_are_ints():
    counts = run.load_counters()["builds"]()
    assert set(counts) == {"nvcc", "kernel1_library", "kernel2_library",
                           "kernel1_plan", "kernel2_plan"}
    assert all(type(v) is int and v >= 0 for v in counts.values())


def test_rebuilds_a_quote():
    read = run.load_reader("rebuilds.quote")
    built = {"builds.nvcc": 0, "builds.kernel2_library": 1,
             "launches.kernel2": 1}
    none = {"builds.nvcc": 0, "builds.kernel2_library": 0}
    reqs = [dict(ok=True, counters=built), dict(ok=True, counters=none),
            dict(ok=False, counters={})]
    assert read(dict(requests=reqs)) == 0.5
    # a program without the counters
    assert read(dict(requests=[dict(ok=True, counters={
        "launches.kernel2": 1})])) is None

"""Kernel 1's share of its frozen float64 throughput bound in the books."""

from perfbench import readers


def read(rec):
    return readers.roofline_pct(rec, "kernel1", "kernel1_bound_ms")

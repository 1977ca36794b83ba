"""Kernel 2's share of its frozen throughput bound in the quotes."""

from perfbench import readers


def read(rec):
    return readers.roofline_pct(rec, "kernel2", "kernel2_bound_ms")

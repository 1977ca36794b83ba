"""Kernel 1's primal (the surfaces' launch) against its frozen float64
bound in the risk requests."""

from perfbench import readers


def read(rec):
    return readers.roofline_pct(rec, "kernel1", "kernel1_bound_ms")

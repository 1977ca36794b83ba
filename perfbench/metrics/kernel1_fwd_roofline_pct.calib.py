"""Kernel 1's forward mode (4 tangents) against its frozen float64 bound
in the fits."""

from perfbench import readers


def read(rec):
    return readers.roofline_pct(rec, "kernel1_fwd", "kernel1_fwd_bound_ms")

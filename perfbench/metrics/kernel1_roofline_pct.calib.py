"""Kernel 1's primal (the trial pricings) against its frozen float64 bound
in the fits."""

from perfbench import readers


def read(rec):
    return readers.roofline_pct(rec, "kernel1", "kernel1_bound_ms")

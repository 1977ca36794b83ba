"""Kernel 1's primal device time a fit (the trial pricing, one launch an
iteration), in ms."""

from perfbench import readers


def read(rec):
    return readers.kernel_ms(rec, "kernel1")

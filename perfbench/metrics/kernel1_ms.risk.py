"""Kernel 1's primal device time a risk request (the surfaces' launch),
in ms."""

from perfbench import readers


def read(rec):
    return readers.kernel_ms(rec, "kernel1")

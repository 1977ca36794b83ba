"""Kernel 1's forward-mode device time a risk request, in ms."""

from perfbench import readers


def read(rec):
    return readers.kernel_ms(rec, "kernel1_fwd")

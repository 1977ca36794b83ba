"""Kernel 1's forward-mode device time a fit (one launch an iteration),
in ms."""

from perfbench import readers


def read(rec):
    return readers.kernel_ms(rec, "kernel1_fwd")

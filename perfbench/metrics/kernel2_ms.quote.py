"""Kernel 2's device time a quote, in ms."""

from perfbench import readers


def read(rec):
    return readers.kernel_ms(rec, "kernel2")

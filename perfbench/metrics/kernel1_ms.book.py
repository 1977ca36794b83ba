"""Kernel 1's device time a book, in ms."""

from perfbench import readers


def read(rec):
    return readers.kernel_ms(rec, "kernel1")

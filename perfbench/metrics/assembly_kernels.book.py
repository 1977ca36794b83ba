"""Device operations a book launches besides kernel 1 (the book plan's
small kernels and copies, the strikes' and prices' copies)."""

from perfbench import readers


def read(rec):
    return readers.other_device_ops(rec, "kernel1")

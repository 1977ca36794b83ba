"""Device operations a quote launches besides kernel 2 (single_plan's small
kernels, copies and the read)."""

from perfbench import readers


def read(rec):
    return readers.other_device_ops(rec, "kernel2")

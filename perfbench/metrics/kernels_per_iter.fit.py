"""Device operations a Levenberg-Marquardt iteration launches (linearized
assembly, both kernels, the 5x5 update, the reads)."""

from perfbench import readers


def read(rec):
    return readers.device_ops_per(rec, "iterations")

"""Levenberg-Marquardt iterations a fit, as calibrate_device reports them."""

from perfbench import readers


def read(rec):
    return readers.count_per_request(rec, "iterations")

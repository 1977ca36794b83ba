"""The share of the traced risk window in which the device ran nothing."""

from perfbench import readers


def read(rec):
    return readers.idle_pct(rec)

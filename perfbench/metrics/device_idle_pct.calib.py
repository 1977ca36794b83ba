"""The share of the traced fit window in which the device ran nothing."""

from perfbench import readers


def read(rec):
    return readers.idle_pct(rec)

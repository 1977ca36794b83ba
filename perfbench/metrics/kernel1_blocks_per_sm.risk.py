"""Resident blocks an SM of kernel 1's primal launches, over the
completed risk requests: a request's growth of the program's counter
(`counters/resident_blocks.py`) over its kernel-1 primal launches
(`counters/launches.py`), averaged. None where the program keeps no such
counter."""


def read(rec):
    per = [r["counters"]["resident_blocks.blocks"]
           / r["counters"]["launches.kernel1"]
           for r in rec["requests"]
           if r["ok"] and "resident_blocks.blocks" in r["counters"]
           and r["counters"].get("launches.kernel1")]
    return sum(per) / len(per) if per else None

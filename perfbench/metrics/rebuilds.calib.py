"""Builds inside the traced window a fit: nvcc runs, kernel library loads
and launch-plan device queries, by the program's counters
(`counters/builds.py`), over the fits completed; 0 where set-up built
everything. None where the program keeps no such counter."""


def read(rec):
    done = sum(1 for r in rec["requests"] if r["ok"])
    counts = [v for r in rec["requests"] for k, v in r["counters"].items()
              if k.startswith("builds.")]
    return sum(counts) / done if done and counts else None

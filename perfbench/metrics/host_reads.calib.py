"""Host reads of the stop flag a completed fit: the program's
`calibrate_device.host_reads` (`counters/calib.py`) over the fits
completed; one an iteration. None where the program keeps no such
counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["calib.host_reads"] for r in done
              if "calib.host_reads" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

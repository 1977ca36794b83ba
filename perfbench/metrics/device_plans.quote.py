"""Plans built on the card a completed quote: launches of the program's
single-option plan kernel (`counters/plans.py`) over the quotes
completed; 1.0 where every quote built its plan on the card. None where
the program keeps no such counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["plans.device"] for r in done
              if "plans.device" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

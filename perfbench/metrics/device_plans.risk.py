"""Plans built on the card a completed risk request: launches of the
program's book plan kernel (`counters/device_book_plans.py`) over the
requests completed; 0.0 where the surfaces' plan is assembled on the
host. None where the program keeps no such counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["device_book_plans.launches"] for r in done
              if "device_book_plans.launches" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

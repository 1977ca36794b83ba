"""Plans built on the card a completed book: launches of the program's
book plan kernel (`counters/device_book_plans.py`) over the books
completed; 1.0 where every book built its plan on the card in one launch.
None where the program keeps no such counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["device_book_plans.launches"] for r in done
              if "device_book_plans.launches" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

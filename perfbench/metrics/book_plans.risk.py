"""Book plans a completed risk request: the program's plans of the
batched kernel (`counters/book_plans.py`) over the requests completed;
1.0 where the surfaces take one plan. None where the program keeps no
such counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["book_plans.calls"] for r in done
              if "book_plans.calls" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

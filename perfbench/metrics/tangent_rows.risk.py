"""Tangent-rows launches a completed risk request: launches of the
program's tangent-rows kernel (`counters/tangent_rows.py`) over the
requests completed; 1.0 where the Jacobian's forward-mode rows are
written on the card, 0.0 where they come from the host's linearized
assembly. None where the program keeps no such counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["tangent_rows.launches"] for r in done
              if "tangent_rows.launches" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

"""Host assemblies a completed fit: the program's `assembly.assemble.calls`
(`counters/risk.py`) over the fits completed; 0 where every pass's plan
and tangent rows are built on the card. None where the program keeps no
such counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["risk.assemble_calls"] for r in done
              if "risk.assemble_calls" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

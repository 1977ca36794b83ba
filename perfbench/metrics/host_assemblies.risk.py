"""Host assemblies a completed risk request: the program's
`assembly.assemble.calls` (`counters/risk.py`) over the requests
completed; 2 where a request assembles the surfaces' book plan and the
Jacobian's linearization on the host. None where the program keeps no
such counter."""


def read(rec):
    done = [r for r in rec["requests"] if r["ok"]]
    counts = [r["counters"]["risk.assemble_calls"] for r in done
              if "risk.assemble_calls" in r["counters"]]
    return sum(counts) / len(done) if done and counts else None

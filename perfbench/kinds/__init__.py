"""The entries the traffic drives, one module per mix `kind`.

Each module defines `Workload(cfg, mix, device)` with:
  prepare(fields)               the request the caller sends (its inputs
                                made from the generator's fields), made
                                before the request's clock starts
  call(request)                 the timed request, its result on the host
  expected_launches(request, out)  {"kernel2", "kernel1", "kernel1_fwd"}:
                                the launches the request must make, by
                                the program's counters (counters/launches.py)
  check(done)                   the Checks of sampled (request, out) pairs
                                against the plain reference
  control(request)              `call` with the reference in bfloat16 in
                                the program's place
  traced(request, out)          the frozen bounds and counts the
                                per-layer metrics read
"""

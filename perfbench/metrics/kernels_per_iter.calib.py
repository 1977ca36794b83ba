"""Device operations a Levenberg-Marquardt iteration launches: the
Jacobian's plan kernel, tangent rows, forward mode and read-out, the 5x5
solve and clamps, the trial's plan kernel and primal, the accept/reject
update and the stop flag's copy."""

from perfbench import readers


def read(rec):
    return readers.device_ops_per(rec, "iterations")

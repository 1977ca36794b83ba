"""Calibrations on the device so far in this process, by the program's own
counters: the fits of `calibration.calibrate_device` (`.calls`), their
Levenberg-Marquardt iterations (`.iterations`) and the reads of the
stop flag on the host (`.host_reads`). A program without them gives
none."""


def read() -> dict:
    from heston_tpu_torch.models import calibration

    fn = calibration.calibrate_device
    out = {}
    for key in ("calls", "iterations", "host_reads"):
        value = getattr(fn, key, None)
        if value is not None:
            out[key] = value
    return out

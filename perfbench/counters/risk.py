"""Book risk so far in this process, by the program's own counters: the
calls of `greeks.batch_greeks` and the options they risked
(`greeks.BATCH_GREEKS`) and the host assemblies
(`assembly.assemble.calls`). The Jacobian's forward-mode passes are
kernel 1's tangent launches (`counters/launches.py`). A program without
them gives none."""


def read() -> dict:
    from heston_tpu_torch.kernels import assembly
    from heston_tpu_torch.models import greeks

    out = {f"batch_greeks_{k}": v
           for k, v in getattr(greeks, "BATCH_GREEKS", {}).items()}
    calls = getattr(assembly.assemble, "calls", None)
    if calls is not None:
        out["assemble_calls"] = calls
    return out

"""Book plans built so far in this process, by the program's own counters:
the plans of the batched kernel (`fused_do.book_plan.calls`) and the
options they planned (`fused_do.book_plan.lanes`). A program without
them gives none."""


def read() -> dict:
    from heston_tpu_torch.kernels import fused_do

    out = {}
    for key in ("calls", "lanes"):
        value = getattr(fused_do.book_plan, key, None)
        if value is not None:
            out[key] = value
    return out

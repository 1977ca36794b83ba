"""Single-option plans built on the card so far in this process, by the
program's own counter: launches of the plan kernel
(`fused_single.device_plan.launches`). A program without it gives
none."""


def read() -> dict:
    from heston_tpu_torch.kernels import fused_single

    value = getattr(getattr(fused_single, "device_plan", None), "launches",
                    None)
    return {} if value is None else {"device": value}

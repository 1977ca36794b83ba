"""Book plans built on the card so far in this process, by the program's
own counter: launches of the book's plan kernel
(`fused_do.device_book_plan.launches`). A program without it gives
none."""


def read() -> dict:
    from heston_tpu_torch.kernels import fused_do

    value = getattr(getattr(fused_do, "device_book_plan", None), "launches",
                    None)
    return {} if value is None else {"launches": value}

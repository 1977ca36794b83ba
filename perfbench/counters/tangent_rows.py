"""Tangent rows built on the card so far in this process, by the
program's own counter: launches of the Jacobian's tangent-rows kernel
(`fused_do.tangent_rows.launches`). A program without it gives none."""


def read() -> dict:
    from heston_tpu_torch.kernels import fused_do

    value = getattr(getattr(fused_do, "tangent_rows", None), "launches",
                    None)
    return {} if value is None else {"launches": value}

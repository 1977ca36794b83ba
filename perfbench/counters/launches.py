"""Kernel launches so far in this process, by the program's own counters:
kernel 2 (`fused_single_loop.launches`), kernel 1's primal and its
forward mode (`fused_do_loop.launches`, `.tangent_launches`)."""


def read() -> dict:
    from heston_tpu_torch.kernels import fused_do, fused_single

    return {"kernel2": fused_single.fused_single_loop.launches,
            "kernel1": fused_do.fused_do_loop.launches,
            "kernel1_fwd": fused_do.fused_do_loop.tangent_launches}

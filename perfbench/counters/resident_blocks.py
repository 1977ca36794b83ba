"""Kernel 1's resident blocks an SM so far in this process, by the
program's own counters: the blocks an SM of the kernel each primal launch
took, summed over the launches (`fused_do_loop.resident_blocks`), and the
occupancy queries behind them (`fused_do.resident_blocks.queries`, the
misses of its cache). A program without them gives none."""


def read() -> dict:
    from heston_tpu_torch.kernels import fused_do

    out = {}
    blocks = getattr(fused_do.fused_do_loop, "resident_blocks", None)
    if blocks is not None:
        out["blocks"] = blocks
    queries = getattr(getattr(fused_do, "resident_blocks", None), "queries",
                      None)
    if queries is not None:
        out["queries"] = queries
    return out

"""Option-book sharding over a `torch.distributed` group (PyTorch port of
`heston_tpu.parallel`): each rank prices its slice of the book, and the
only communication is an all_gather of the results and the calibration
normal equations' all_reduce (JᵀJ 5x5, Jᵀr 5, the SSE).
"""

from heston_tpu_torch.parallel.sharded import (
    batch_greeks_sharded,
    calibrate_sharded,
    ensure_distributed,
    jacobian_normal_eq_sharded,
    make_mesh,
    price_batch_sharded,
    shard_batch,
    sharded_pricing_fns,
)

__all__ = [
    "make_mesh",
    "shard_batch",
    "price_batch_sharded",
    "batch_greeks_sharded",
    "jacobian_normal_eq_sharded",
    "calibrate_sharded",
    "sharded_pricing_fns",
    "ensure_distributed",
]

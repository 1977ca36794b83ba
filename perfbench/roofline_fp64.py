"""The card's float64 peak, for the launches that run in float64: a
launch's bound is the larger of its operations over the float64 peak
outside the tensor cores and its bytes over the HBM rate. The operations
and bytes are `roofline.kernel_bound`'s, whatever the precision."""

from __future__ import annotations

from perfbench.roofline import H100_HBM_BYTES_PER_S

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: FP64 outside the
# tensor cores (the FP64 tensor cores' 67 TFLOP/s run matrix products
# only, which the ADI loop has none of)
H100_FP64_FLOPS = 34e12


def bound_ms(flops: float, nbytes: float) -> float:
    """The least time in ms a float64 launch of `flops` operations and
    `nbytes` bytes can take on the card."""
    return 1e3 * max(flops / H100_FP64_FLOPS, nbytes / H100_HBM_BYTES_PER_S)

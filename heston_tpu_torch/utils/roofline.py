"""Analytic roofline model of the ADI time-loop launches (PyTorch port).

Counterpart of `heston_tpu.utils.roofline`, with the same algorithmic
operation counts (the floating-point work the ADI scheme does per option
per step, counted from the discretization: stencil applies, banded
solves, axpys — not from the emitted instructions), so an achieved
GFLOP/s from it is a lower bound on what the card executes.

The time loop has no matrix products, so its ceiling is the card's FP32
rate outside the tensor cores, and, for the launch's inputs and outputs,
its HBM rate; both are reported beside the tensor-core peak. Peaks are
NVIDIA's published figures for the card (H100 SXM data sheet, dense,
at the 700 W limit); an unknown device kind gets a spec named as
unknown, with NaN peaks. `chip_smoke.py`'s bounds read the H100 row.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    fp32_flops: float          # FP32 on the CUDA cores (no tensor cores)
    hbm_bytes_per_s: float     # HBM bandwidth
    bf16_tensor_flops: float   # dense bf16 on the tensor cores
    source: str


H100 = ChipSpec("nvidia-h100-sxm", 67e12, 3.35e12, 989e12,
                "published (NVIDIA H100 SXM data sheet, dense, 700 W)")
UNKNOWN = ChipSpec("unknown", math.nan, math.nan, math.nan,
                   "unknown device kind: no peaks")

# keyed by a substring of torch.cuda.get_device_name() (lowercased)
_CHIP_TABLE = (("h100", H100),)


def lookup(device_kind: str) -> ChipSpec:
    dk = (device_kind or "").lower()
    for key, spec in _CHIP_TABLE:
        if key in dk:
            return spec
    return UNKNOWN


def step_flops(m1: int, m2: int, scheme: str = "do",
               american: bool = False) -> float:
    """Algorithmic FLOPs of ONE ADI step of ONE option on the
    (m1+1)x(m2+1) grid (heston_tpu/utils/roofline.py:77-105): per point,
    Douglas ~70 (A0 17, A1 7, A2 11, axpys ~6, the A1 Thomas solve ~10,
    the A2 penta solve ~19); CS +46; MCS and HV +81; American +4."""
    pts = (m1 + 1) * (m2 + 1)
    base = 70.0
    if scheme == "cs":
        base += 46.0
    elif scheme in ("mcs", "hv"):
        base += 81.0
    if american:
        base += 4.0
    return base * pts


def batch_launch_flops(batch: int, m1: int, m2: int, n_steps: int,
                       scheme: str = "do", american: bool = False,
                       n_dividends: int = 0,
                       n_tangents: int = 0) -> float:
    """FLOPs of one time-loop launch pricing `batch` options: a dividend
    re-map ~6 a point; each forward-mode tangent re-runs the step's
    arithmetic."""
    pts = (m1 + 1) * (m2 + 1)
    per_opt = n_steps * step_flops(m1, m2, scheme, american)
    per_opt += n_dividends * 6.0 * pts
    return batch * per_opt * (1 + n_tangents)


def launch_hbm_bytes(batch: int, itemsize: int = 4,
                     extra_bytes: float = 0.0) -> float:
    """HBM traffic of one launch as the JAX package counts it: strikes in
    and prices out; `extra_bytes` for surfaces or Jacobians."""
    return batch * itemsize * 2.0 + extra_bytes


def report(prefix: str, measured_s: float, flops: float,
           hbm_bytes: float, device_kind: str) -> dict:
    """Bench fields relating a measured time to the card's ceilings:
    achieved GFLOP/s, % of the FP32 peak, % of the HBM peak, and the time
    the algorithmic FLOPs need at the FP32 peak (NaN on an unknown
    card)."""
    spec = lookup(device_kind)
    return {
        f"{prefix}_model_gflop": flops / 1e9,
        f"{prefix}_achieved_gflops": flops / measured_s / 1e9,
        f"{prefix}_pct_fp32_peak": 100.0 * flops / measured_s
        / spec.fp32_flops,
        f"{prefix}_pct_hbm_peak": 100.0 * hbm_bytes / measured_s
        / spec.hbm_bytes_per_s,
        f"{prefix}_sol_s_at_fp32_peak": flops / spec.fp32_flops,
        "roofline_chip": spec.name,
        "roofline_fp32_tflops": spec.fp32_flops / 1e12,
        "roofline_hbm_gbps": spec.hbm_bytes_per_s / 1e9,
        "roofline_bf16_tensor_tflops": spec.bf16_tensor_flops / 1e12,
        "roofline_source": spec.source,
        "_roofline_hbm_gbps_achieved": hbm_bytes / measured_s / 1e9,
    }

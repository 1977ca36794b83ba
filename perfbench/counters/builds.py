"""Builds so far in this process, by the program's own counters: nvcc
runs (`fused_do.build.nvcc_runs`), loads of either kernel's library (the
misses of each module's `_library` cache) and launch-plan device queries
(kernel 2's `_default_plan` misses, kernel 1's `_sm_count` misses). A
program without these counters gives none."""

COUNTERS = {"nvcc": ("fused_do", "build", "nvcc_runs"),
            "kernel1_library": ("fused_do", "_library", "loads"),
            "kernel2_library": ("fused_single", "_library", "loads"),
            "kernel1_plan": ("fused_do", "_sm_count", "queries"),
            "kernel2_plan": ("fused_single", "_default_plan", "queries")}


def read() -> dict:
    from heston_tpu_torch.kernels import fused_do, fused_single

    modules = {"fused_do": fused_do, "fused_single": fused_single}
    out = {}
    for key, (module, fn, attr) in COUNTERS.items():
        value = getattr(getattr(modules[module], fn), attr, None)
        if value is not None:
            out[key] = value
    return out

"""Tracing and profiling hooks (PyTorch port of `heston_tpu.utils.profiling`).

* `PhaseTimer.phase(name, sync=)` — a wall-clock span; with `sync`, the
  devices of its tensors are synchronized before the span ends (the JAX
  package's `block_until_ready`);
* `scope(name)` — `torch.profiler.record_function`: a named range in a
  profiler trace;
* `trace(log_dir)` — a `torch.profiler` session over the block, written
  as a Chrome trace into `log_dir`.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path
from typing import Dict, List

import torch

scope = torch.profiler.record_function


def _leaves(tree):
    """The leaves of a (nested) tuple, list or dict."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def _synchronize(tree) -> None:
    """Wait until the work producing the CUDA tensors of `tree` is done."""
    for dev in {x.device for x in _leaves(tree)
                if isinstance(x, torch.Tensor) and x.is_cuda}:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates named wall-clock spans (device-synchronized)."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            self.spans.setdefault(name, []).append(
                time.perf_counter() - t0)

    def report(self) -> str:
        lines = []
        for name, ts in self.spans.items():
            lines.append(
                f"{name}: n={len(ts)} total={sum(ts):.4f}s "
                f"mean={sum(ts) / len(ts):.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block (the CPU, and the card when there is one) and
    write a Chrome trace (`trace_<pid>_<ns>.json`) into `log_dir`; yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(
        str(log_dir / f"trace_{os.getpid()}_{time.time_ns()}.json"))

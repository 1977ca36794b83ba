"""Tracing hooks: the port's named spans and its profiler sessions.

* `scope(name)` — the span `heston.<name>` in a `torch.profiler` trace,
  on the host timeline beside the device's operations. It records only
  while a profiler session records (`torch.autograd._profiler_enabled()`);
  otherwise it is a shared no-op context, whose cost is that one check.
  A context manager, or a decorator that checks at each call. Spans nest
  by the one host thread's call stack: a span belongs to the span, or the
  caller's span, that contains it.
* `trace(log_dir)` — a `torch.profiler` session over the block, written
  as a Chrome trace into `log_dir`.

The spans on the single-option path, from the entry down:
`heston.price_batch` (`models.douglas.price_batch`) holds
`heston.single_plan` (`kernels.fused_single.single_plan`), which holds
`heston.assemble` (`kernels.assembly.assemble`) and one
`heston.remaps` a phase (`kernels.assembly.build_remap_fields`), and
then one `heston.loop` a phase (`fused_single.fused_single_loop`; books:
`fused_do.fused_do_loop`). A book's `heston.price_batch` holds
`heston.book_plan` (`kernels.fused_do.book_plan`, which holds
`heston.assemble` and one `heston.remaps` a phase) and then one
`heston.loop` a phase; the linearized assembly carries `heston.assemble`
too. On the card a quote's
`heston.single_plan` holds the plan kernel's launch
(`fused_single.device_plan`), with no `heston.assemble` or
`heston.remaps` inside, and its `heston.loop` a phase holds
`fused_single._launch_packed` (`fused_single.run_plan`); a flat-rate
book's `heston.book_plan` holds the book's plan kernel's launch
(`fused_do.device_book_plan`), again with no `heston.assemble` or
`heston.remaps` inside, and its `heston.loop` a phase holds
`fused_do._launch_packed` (`fused_do.run_book_plan`). Curve books and
book risk's surfaces keep `heston.assemble` on the card too.
Book risk's `heston.batch_greeks` (`models.greeks.batch_greeks`) holds
the surfaces' `heston.book_plan` and `heston.loop`, then
`heston.risk_epilogue` (the stencils and theta) and, with
`param_jacobian`, `heston.jacobian` (`fused_do.fused_theta_jacobian`).
On the card under v0_mode "stencil" that holds the Jacobian's
`heston.book_plan` (the book's plan kernel) and its forward-mode
`heston.loop` a phase, with no `heston.assemble` inside; the host route
(CPU strikes, v0_mode "ad") holds `heston.linearize`
(`fused_do._linearized_assemble`, with its `heston.assemble`), the
phases' `heston.remaps` and the forward-mode `heston.loop`.
A fit's `heston.calibrate_device` (`models.calibration.
calibrate_device`) holds one `heston.lm_iteration` an iteration; under
"pallas" each holds the Jacobian pass's `heston.jacobian` (as above:
on the card its `heston.book_plan` and forward-mode `heston.loop`, no
`heston.assemble`) and then the trial pricing's `heston.book_plan` and
`heston.loop` (`fused_do.fused_price_batch`), and ends with the read of
the stop flag.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from pathlib import Path

import torch

PREFIX = "heston."


class _Off:
    """The span `name` while no profiler records: enters nothing. As a
    decorator, the function with the span opened at each call made while
    a profiler records."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False

    def __call__(self, fn):
        return _spanned(self.name, fn)


class _On(torch.profiler.record_function):
    """The span `name` while a profiler records; as a decorator, the same
    per-call check as `_Off`'s."""

    def __init__(self, name: str):
        super().__init__(PREFIX + name)
        self.short = name

    def __call__(self, fn):
        return _spanned(self.short, fn)


def _spanned(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        if not torch.autograd._profiler_enabled():
            return fn(*args, **kwargs)
        with _On(name):
            return fn(*args, **kwargs)
    return spanned


@functools.cache
def _off(name: str) -> _Off:
    return _Off(name)


def scope(name: str):
    """The span `heston.<name>`: a `torch.profiler.record_function` while
    a profiler session records, else a shared no-op context."""
    if torch.autograd._profiler_enabled():
        return _On(name)
    return _off(name)


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block (the CPU, and the card when there is one) and
    write a Chrome trace (`trace_<pid>_<ns>.json`) into `log_dir`; yields
    the profiler. The block's `scope` spans are in the trace."""
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

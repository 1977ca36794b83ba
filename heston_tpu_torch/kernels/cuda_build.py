"""How both time-loop kernels are built and called (the layers:
`kernels.assembly`): the nvcc build of a source of csrc/, the choice of
build and the launch checks both wrappers share.

Builds (ROADMAP C9): each source compiles twice, with -fmad=false (every
float64 launch, the float32 forward mode, and the float32 launches held
bitwise against the plain version) and -fmad=true (multiply-adds
contracted into FMAs, as XLA does: every other float32 launch,
`use_fmad`).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from heston_tpu_torch.kernels.assembly import (KERNEL_S_KEYS, KERNEL_V_KEYS,
                                               SCALAR_KEYS, n_react)
from heston_tpu_torch.ops import operators

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "heston_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "--split-compile=0")


def _nvcc(source: Path) -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(cuda_home) / "bin" / "nvcc"
    if nvcc.exists():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found under {cuda_home} or on PATH: the kernel is "
            f"built from {source} at first use")
    return found


def nvcc_flags(fmad: bool = False) -> tuple:
    """The nvcc flags of a build: NVCC_FLAGS, with -fmad=true for the
    FMA build."""
    return tuple("-fmad=true" if f == "-fmad=false" and fmad else f
                 for f in NVCC_FLAGS)


def use_fmad(dtype: torch.dtype, fmad: Optional[bool] = None,
             tangent: bool = False) -> bool:
    """The build a launch takes: the one named by `fmad` (the
    kernel-against-plain checks name False), else -fmad=true for a float32
    primal launch and -fmad=false for float64 and for the forward mode
    (`tangent`). On an H100 the FMA build brings the hv euro arm's float32
    RMSE within the bench's 2e-5 (-fmad=false: 2.26e-5) and keeps every
    other primal arm within its budget (ROADMAP C9, chip_smoke.py's
    fma_build phase). Which multiply-adds the FMA build contracts follows
    the code's shape, not its arithmetic: after the shared-memory redesign
    it took the float32 Jacobian of the American-dividend arm to 3.42e-5
    against the bench's 3e-5 (2.51e-5 before), so the forward mode keeps
    the -fmad=false build, whose rounding is the plain version's. float64
    stays on -fmad=false, within 1e-10 of the plain versions. Chosen by
    dtype and purpose only: nothing switches builds on a failure."""
    if fmad is not None:
        return bool(fmad)
    return dtype == torch.float32 and not tangent


def included(source: Path, seen=None) -> list:
    """`source` and every file it includes by a quoted `#include "..."`
    (beside the including file), recursively, each once, in the order
    they are met."""
    seen = [] if seen is None else seen
    seen.append(source)
    for line in source.read_text().splitlines():
        words = line.split()
        if (len(words) >= 2 and words[0] == "#include"
                and words[1].startswith('"')):
            dep = source.parent / words[1].strip('"')
            if dep not in seen:
                included(dep, seen)
    return seen


def build_tag(source: Path, flags) -> str:
    """The tag of a build: a hash of every file it compiles (`included`)
    and of its flags."""
    src = b"".join(f.read_bytes() for f in included(source))
    return hashlib.sha256(src + " ".join(flags).encode()).hexdigest()[:16]


def build(source: Path, fmad: bool = False) -> Path:
    """Compile one CUDA source of csrc/ into build/heston_tpu_torch/, once
    per content of the source, of the headers it includes (`included`:
    csrc/plan.cuh, the plan arithmetic both sources share) and of the
    flags (`nvcc_flags(fmad)`), and return the shared library's path. The
    hash covers every file the build compiles; the two builds of a source
    have separate hashes. Counts each compile in `build.nvcc_runs`."""
    flags = nvcc_flags(fmad)
    out = BUILD_DIR / f"{source.stem}_{build_tag(source, flags)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(source), *flags, "-o", tmp, str(source)]
    build.nvcc_runs += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


build.nvcc_runs = 0


def on_card(t: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor `t`, False for a CPU one, else ValueError."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got "
                         f"{t.device}")
    return t.device.type == "cuda"


def check_dtype(dtype: torch.dtype, what: str) -> None:
    """Raise TypeError unless `dtype` is one `what` (a kernel) takes."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what} takes float32/float64, got {dtype}")


def check_field(name, t, shape, dtype, dev):
    """Raise ValueError unless the field `name` is `shape` `dtype` on
    `dev`."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(
            f"field {name!r}: want {shape} {dtype} on {dev}, got "
            f"{tuple(t.shape)} {t.dtype} on {t.device}")


def check_fields(fields, batch: tuple, ns: int, nv: int, what: str):
    """Raise TypeError unless u is of a dtype `what` (a kernel) takes, and
    ValueError unless lam (u's shape) and the packed rows of a launch's
    `fields` ([*batch, ns] s-rows, [*batch, nv] v-rows, `batch` scalars)
    are of u's dtype on u's device."""
    u = fields["u"]
    check_dtype(u.dtype, what)
    shapes = {"lam": tuple(u.shape),
              **{k: (*batch, ns) for k in KERNEL_S_KEYS},
              **{k: (*batch, nv) for k in KERNEL_V_KEYS},
              **{k: batch for k in SCALAR_KEYS}}
    for k, shape in shapes.items():
        check_field(k, fields[k], shape, u.dtype, u.device)


def check_events(ev_steps, remaps, first_step, n_steps, shape, dtype, dev):
    """Raise ValueError unless the event steps ascend within
    first_step..n_steps, one remap each, and every remap field has the
    given shape on `dev` (int64 indices, `dtype` weights)."""
    steps = list(ev_steps)
    if len(steps) != len(remaps):
        raise ValueError("one remap per event step")
    if steps != sorted(steps) or any(not first_step <= s <= n_steps
                                     for s in steps):
        raise ValueError(f"event steps must ascend within "
                         f"{first_step}..{n_steps}: {steps}")
    for rm in remaps:
        for t, want in zip(rm, (torch.int64, dtype, torch.int64, dtype)):
            if t.device != dev or t.dtype != want or tuple(t.shape) != shape:
                raise ValueError(f"remap fields must be {shape} on the "
                                 f"state's device (int64 indices)")
    return steps


def launch_flags(option_type: str, knocked, ns: int, nv: int) -> list:
    """The payoff's launch arguments of both kernels: the payoff's index
    in operators.OPTION_TYPES (call, put, digital_call, digital_put, the
    kernels' Payoff enum), `n_react`, and the knocked s columns as two
    ints (-1: none). ValueError for a knocked column off the grid."""
    knocked = tuple(knocked)
    if len(knocked) > 2 or any(not 0 <= c < ns for c in knocked):
        raise ValueError(f"knocked columns must be at most two s indices "
                         f"in 0..{ns - 1}, got {knocked}")
    ks = list(knocked) + [-1] * (2 - len(knocked))
    return [operators.OPTION_TYPES.index(
        operators._validate_option_type(option_type)),
        n_react(option_type, knocked, ns, nv), *ks]

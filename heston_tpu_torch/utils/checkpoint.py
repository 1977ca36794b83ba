"""Calibration checkpoint / resume.

The port's copy of `heston_tpu.utils.checkpoint`: the host LM loop
(`models.calibration.calibrate`) can persist its whole state (parameters,
damping, iteration count, history) after every iteration and resume
mid-run. Plain JSON, written to a temporary file and renamed into place.
The file format and the problem fingerprint are the JAX package's, so a
checkpoint written by either package resumes in the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from heston_tpu_torch.config import HestonParams


def problem_key(*parts) -> str:
    """Stable fingerprint of a calibration problem (strikes, market,
    spec, solver, ...), stored in the checkpoint so that a stale or
    foreign file cannot silently hijack a resumed run. Arrays and tensors
    enter as lists of their values, anything else by its repr — the JAX
    package's key for the same problem."""

    def norm(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().numpy().tolist()
        if isinstance(x, np.ndarray):
            return x.tolist()
        try:  # numpy scalars and plain values
            return np.asarray(x).tolist()
        except Exception:
            return repr(x)

    blob = repr([norm(p) for p in parts]).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


@dataclasses.dataclass
class LMState:
    """Resumable Levenberg–Marquardt state."""

    theta_vec: np.ndarray        # (5,) current parameters
    lam: float                   # damping
    iteration: int
    final_error: float
    converged: bool
    history: list
    key: str = ""                # problem fingerprint ("" = unchecked)

    def save(self, path) -> Path:
        path = Path(path)
        payload = dict(
            theta_vec=np.asarray(self.theta_vec).tolist(),
            lam=self.lam,
            iteration=self.iteration,
            final_error=self.final_error,
            converged=self.converged,
            history=self.history,
            key=self.key,
        )
        tmp = path.with_suffix(".tmp")
        tmp.write_text(json.dumps(payload))
        tmp.replace(path)           # atomic on POSIX
        return path

    @classmethod
    def load(cls, path) -> "LMState":
        d = json.loads(Path(path).read_text())
        return cls(
            theta_vec=np.asarray(d["theta_vec"], dtype=np.float64),
            lam=float(d["lam"]),
            iteration=int(d["iteration"]),
            final_error=float(d["final_error"]),
            converged=bool(d["converged"]),
            history=d["history"],
            key=str(d.get("key", "")),
        )

    @classmethod
    def fresh(cls, init: HestonParams, lam: float) -> "LMState":
        return cls(theta_vec=np.array(init.bumpable()), lam=lam,
                   iteration=0, final_error=float("inf"), converged=False,
                   history=[])

    def maybe_resume(self, path: Optional[str]) -> "LMState":
        """The stored state if `path` exists, else self. When both carry a
        problem fingerprint, a mismatch raises instead of resuming a
        different calibration (a stale path reused)."""
        if path and Path(path).exists():
            stored = self.load(path)
            if self.key and stored.key and stored.key != self.key:
                raise ValueError(
                    f"checkpoint at {path} belongs to a different "
                    f"calibration problem (fingerprint {stored.key} != "
                    f"{self.key}); delete it or use a fresh path")
            return stored
        return self

"""Carry parameters and kernel inputs across from the JAX package.

The functions take numpy arrays (never JAX arrays), so this module needs
no JAX: a caller converts with `np.asarray` first. The time-loop scheme
(`SolverConfig.scheme`) is a static flag of a launch, not a field: the
correctors of "cs", "mcs" and "hv" read the same fields as Douglas, so
`fields_from_jax` and `tangent_fields_from_jax` carry everything every
scheme needs.
"""

from __future__ import annotations

import numpy as np
import torch

from heston_tpu_torch.kernels.fused_do import (_TANGENT_KEYS, BIG_KEYS,
                                               S_KEYS, SCALAR_KEYS, V_KEYS)

PARAM_NAMES = ("kappa", "eta", "sigma", "rho", "v0")


def params_from_jax(theta_vec: np.ndarray, r_d, r_f, device=None,
                    dtype=torch.float64) -> dict:
    """The JAX package's parameter vector theta_vec = (kappa, eta, sigma,
    rho, v0) plus the two rates as a dict of 0-d tensors, ready for
    `price_batch(spec, solver, strikes, s0, **params)`."""
    theta_vec = np.asarray(theta_vec, dtype=np.float64)
    if theta_vec.shape != (5,):
        raise ValueError(f"theta_vec must have shape (5,), got "
                         f"{theta_vec.shape}")
    values = dict(zip(PARAM_NAMES, theta_vec.tolist()), r_d=r_d, r_f=r_f)
    return {k: torch.tensor(float(v), dtype=dtype, device=device)
            for k, v in values.items()}


def fields_from_jax(fields: dict) -> dict:
    """The field dict of `heston_tpu.pallas.fused_do._assemble` (batch
    last and s-major: big fields [ns, nv, B], row fields [n, B], scalars
    [1, B]) as numpy arrays, in the port's batch-first layout as CPU
    tensors: [B, ns, nv], [B, n] and [B]; the per-lane step counts "nst"
    of a mixed-maturity book ([1, B], in the float dtype there) as int64
    [B]. Keys outside the time loop's inputs are passed through unchanged
    (e.g. the float "rf_val")."""
    out = {}
    for k, x in fields.items():
        if k in BIG_KEYS:
            out[k] = torch.as_tensor(np.asarray(x).transpose(2, 0, 1).copy())
        elif k in S_KEYS or k in V_KEYS:
            out[k] = torch.as_tensor(np.asarray(x).T.copy())
        elif k in SCALAR_KEYS:
            out[k] = torch.as_tensor(np.asarray(x).reshape(-1).copy())
        elif k == "nst":
            out[k] = torch.as_tensor(
                np.rint(np.asarray(x).reshape(-1)).astype(np.int64))
        else:
            out[k] = x
    return out


def tangent_fields_from_jax(tangents) -> list:
    """The JAX package's per-direction tangent fields (a list of K dicts
    keyed by `heston_tpu.pallas.fused_do._TANGENT_KEYS`, each field a row
    field [n, B], as numpy arrays) in the port's batch-first layout: K
    dicts of CPU tensors [B, n], ready for `fused_do_loop(...,
    tangents=...)`."""
    out = []
    for t in tangents:
        if set(t) != set(_TANGENT_KEYS):
            raise ValueError(f"tangent fields must have the keys "
                             f"{_TANGENT_KEYS}, got {sorted(t)}")
        out.append({k: torch.as_tensor(np.asarray(t[k]).T.copy())
                    for k in _TANGENT_KEYS})
    return out

"""Shared helpers of the JAX-vs-PyTorch parity tests (tests/test_torch_*).

Inputs are made with numpy from a seed and handed to both packages;
results come back as numpy arrays. Everything runs in float64 on the CPU
unless a test says otherwise (tests/conftest.py enables JAX x64).
"""

import dataclasses
import os

import numpy as np
import torch

from heston_tpu_torch import config as tconfig

if os.environ.get("PYTEST_XDIST_WORKER"):
    # one intra-op thread per worker process: the suite runs several
    torch.set_num_threads(1)

F64 = torch.float64
CPU = "cpu"


def port_cfg(obj):
    """A configuration dataclass of the JAX package (heston_tpu.config) as
    the port's own class of the same name (heston_tpu_torch.config), field
    for field; anything else is returned as it is. JAX-package calls get
    the JAX objects, port calls their counterparts."""
    if not dataclasses.is_dataclass(obj):
        return obj
    cls = getattr(tconfig, type(obj).__name__)
    return cls(**{f.name: port_cfg(getattr(obj, f.name))
                  for f in dataclasses.fields(obj)})


def t64(x):
    """numpy/JAX array or scalar -> float64 CPU tensor."""
    return torch.as_tensor(np.array(x, dtype=np.float64))


def npy(x):
    """torch tensor or JAX array -> numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_close(got, want, rtol=1e-12, atol=1e-12, err_msg=""):
    np.testing.assert_allclose(npy(got), npy(want), rtol=rtol, atol=atol,
                               err_msg=err_msg)


def param_args(p, r_f=None):
    """(kappa, eta, sigma, rho, v0, r_d, r_f) of a HestonParams."""
    return (p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d,
            p.r_f if r_f is None else r_f)

"""The eager ADI loop's float32 error (ROADMAP C10): the port's
`price_batch` under "scan" and "pcr" in float32 against its own float64,
held to 1.5x the JAX package's true-float32 error (JAX under
`jax.enable_x64(False)`) against the JAX package's own float64, on the
same books: 40 strikes and the 500 ladder in [70, 130], European and
American with the golden dividends, 50 x 25 x 20, on the CPU.

Both books run as one book of 540 (every option's loop is its own, in
both packages); each book's RMSE is read off its slice. The worst
strikes of both packages are those whose grid puts a node next to S0
(ROADMAP C6), not a port fault.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, GridSpec, HestonParams,
                               SolverConfig)
from heston_tpu.models import douglas as jdouglas
import heston_tpu_torch

from torch_parity import CPU, param_args, port_cfg
from torch_parity import release_jax_executables  # noqa: F401

SPEC = GridSpec(m1=50, m2=25)
BOOKS = {"k40": np.linspace(70.0, 130.0, 40),
         "ladder500": np.linspace(70.0, 130.0, 500)}
STRIKES = np.concatenate(list(BOOKS.values()))
SLICES = {"k40": slice(0, 40), "ladder500": slice(40, 540)}
ARMS = {"euro": {}, "amer_div": dict(american=True,
                                     dividends=GOLDEN_DIVIDENDS)}
ENGINES = ("scan", "pcr")
RATIO = 1.5


def _rmse(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def _jax_prices(params, engine, arm, dtype):
    sol = SolverConfig(n_steps=20, solver_engine=engine)
    return np.asarray(jdouglas.price_batch(
        SPEC, sol, jnp.asarray(STRIKES, dtype), 100.0, *param_args(params),
        **ARMS[arm]), np.float64)


@functools.cache
def _jax_rmse(engine, arm):
    """The JAX package's true-float32 RMSE against its float64 per book,
    one (engine, arm) at a time and once per process (the cases may run
    in different workers)."""
    params = HestonParams()
    want = _jax_prices(params, engine, arm, jnp.float64)
    with jax.enable_x64(False):
        got = _jax_prices(params, engine, arm, jnp.float32)
    return {book: _rmse(got[sl], want[sl]) for book, sl in SLICES.items()}


@pytest.mark.parametrize("arm", list(ARMS))
@pytest.mark.parametrize("engine", ENGINES)
def test_eager_float32_error_within_jax(params, engine, arm):
    jax_rmse = _jax_rmse(engine, arm)
    sol = port_cfg(SolverConfig(n_steps=20, solver_engine=engine))
    kw = {k: port_cfg(v) for k, v in ARMS[arm].items()}
    prices = {}
    for dtype in (torch.float32, torch.float64):
        got = heston_tpu_torch.price_batch(
            port_cfg(SPEC), sol, torch.as_tensor(STRIKES, dtype=dtype), 100.0,
            *param_args(params), device=CPU, **kw)
        assert got.dtype == dtype
        prices[dtype] = got.double().numpy()
    for book, sl in SLICES.items():
        err = _rmse(prices[torch.float32][sl], prices[torch.float64][sl])
        bound = RATIO * jax_rmse[book]
        assert np.isfinite(err) and err <= bound, (
            f"{book}: port f32 RMSE {err:.3g} > {RATIO} x JAX's "
            f"{jax_rmse[book]:.3g}")

"""heston_tpu_torch.ops.banded against heston_tpu.ops.banded: the
factorizations and both engines' solves of batched tridiagonal and
pentadiagonal systems, in float64 on the CPU. "scan" runs the JAX
package's arithmetic row for row (atol 1e-12); "pcr" composes the affine
maps in another order than `lax.associative_scan` and is held at 1e-9,
the JAX package's own bound between its engines (tests/test_banded.py:
122-129)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.ops import banded as jbanded
from heston_tpu_torch.ops import banded

from torch_parity import assert_close, t64

SEED = 20261017
ATOL = {"scan": 1e-12, "pcr": 1e-9}


def _tridiag(rng, batch, n):
    md = 3.0 + rng.standard_normal((*batch, n))
    ml = 0.5 * rng.standard_normal((*batch, n))
    mu = 0.5 * rng.standard_normal((*batch, n))
    ml[..., 0] = 0.0
    mu[..., -1] = 0.0
    return ml, md, mu


def _penta(rng, batch, n):
    d = 4.0 + rng.standard_normal((*batch, n))
    l1, u1 = (0.4 * rng.standard_normal((*batch, n)) for _ in range(2))
    l2, u2 = (0.2 * rng.standard_normal((*batch, n)) for _ in range(2))
    l1[..., 0] = 0.0
    l2[..., :2] = 0.0
    u1[..., -1] = 0.0
    u2[..., -2:] = 0.0
    return l2, l1, d, u1, u2


@pytest.mark.parametrize("batch", [(), (3, 4)])
def test_tridiag_factor_matches_jax(batch):
    bands = _tridiag(np.random.default_rng(SEED), batch, 13)
    got = banded.tridiag_factor(*map(t64, bands))
    want = jbanded.tridiag_factor(*map(jnp.asarray, bands))
    for name in banded.TridiagFactor._fields:
        assert_close(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("engine", banded.ENGINES)
@pytest.mark.parametrize("batch", [(), (3, 4)])
def test_tridiag_solve_matches_jax(engine, batch):
    """Along the last axis, every leading axis batched."""
    rng = np.random.default_rng(SEED + 1)
    n = 17
    bands = _tridiag(rng, batch, n)
    rhs = rng.standard_normal((*batch, n))
    got = banded.tridiag_solve(banded.tridiag_factor(*map(t64, bands)),
                               t64(rhs), engine)
    want = jbanded.tridiag_solve(
        jbanded.tridiag_factor(*map(jnp.asarray, bands)), jnp.asarray(rhs),
        engine)
    assert got.shape == rhs.shape
    assert_close(got, want, rtol=0, atol=ATOL[engine])


def test_penta_factor_matches_jax():
    bands = _penta(np.random.default_rng(SEED + 2), (3,), 11)
    got = banded.penta_factor(*map(t64, bands))
    want = jbanded.penta_factor(*map(jnp.asarray, bands))
    for name in banded.PentaFactor._fields:
        assert_close(getattr(got, name), getattr(want, name), err_msg=name)


@pytest.mark.parametrize("engine", banded.ENGINES)
@pytest.mark.parametrize("batch", [(), (3,)])
def test_penta_solve_matches_jax(engine, batch):
    """Along axis -2, the bands (..., n) broadcast over the last axis."""
    rng = np.random.default_rng(SEED + 3)
    n, k = 13, 7
    bands = _penta(rng, batch, n)
    rhs = rng.standard_normal((*batch, n, k))
    got = banded.penta_solve(banded.penta_factor(*map(t64, bands)),
                             t64(rhs), engine)
    want = jbanded.penta_solve(
        jbanded.penta_factor(*map(jnp.asarray, bands)), jnp.asarray(rhs),
        engine)
    assert got.shape == rhs.shape
    assert_close(got, want, rtol=0, atol=ATOL[engine])


@pytest.mark.parametrize("n", [1, 2, 5, 16, 21])
def test_pcr_agrees_with_scan_at_every_length(n):
    """The doubling covers lengths that are and are not powers of two,
    down to one row; both recurrences solve the dense system."""
    rng = np.random.default_rng(SEED + n)
    ml, md, mu = _tridiag(rng, (2,), n)
    rhs = rng.standard_normal((2, n))
    fac = banded.tridiag_factor(t64(ml), t64(md), t64(mu))
    x = {e: banded.tridiag_solve(fac, t64(rhs), e) for e in banded.ENGINES}
    assert_close(x["pcr"], x["scan"], rtol=0, atol=1e-12)
    for b in range(2):
        a = np.diag(md[b]) + np.diag(ml[b, 1:], -1) + np.diag(mu[b, :-1], 1)
        np.testing.assert_allclose(a @ x["scan"][b].numpy(), rhs[b],
                                   atol=1e-12)
    l2, l1, d, u1, u2 = _penta(rng, (), n)
    prhs = rng.standard_normal((n, 3))
    pfac = banded.penta_factor(*map(t64, (l2, l1, d, u1, u2)))
    assert_close(banded.penta_solve(pfac, t64(prhs), "pcr"),
                 banded.penta_solve(pfac, t64(prhs), "scan"), rtol=0,
                 atol=1e-12)


def test_solves_are_differentiable_in_forward_mode():
    """The engines are out-of-place: torch.func.jvp through a solve gives
    the derivative of the solution, d x = A^-1 d rhs, under both."""
    rng = np.random.default_rng(SEED + 4)
    bands = _tridiag(rng, (), 9)
    rhs, drhs = rng.standard_normal(9), rng.standard_normal(9)
    fac = banded.tridiag_factor(*map(t64, bands))
    for engine in banded.ENGINES:
        _, dx = torch.func.jvp(
            lambda r: banded.tridiag_solve(fac, r, engine), (t64(rhs),),
            (t64(drhs),))
        assert_close(dx, banded.tridiag_solve(fac, t64(drhs), "scan"),
                     rtol=0, atol=1e-12)


@pytest.mark.parametrize("engine", ["pallas", "qr"])
def test_unknown_engine_raises(engine):
    """'pallas' is dispatched above the solvers, as in the JAX package."""
    fac = banded.tridiag_factor(*map(t64, _tridiag(
        np.random.default_rng(SEED), (), 5)))
    with pytest.raises(ValueError, match="banded-solver engine"):
        banded.tridiag_solve(fac, t64(np.ones(5)), engine)

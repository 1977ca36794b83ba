"""heston_tpu_torch.parallel (option-book sharding over torch.distributed)
against heston_tpu.parallel and against the port's single-device path,
float64 on the CPU.

One gloo world of 4 ranks (tests/torch_sharding_world.py) runs every
case once per test run: the xdist workers share its results through a
file under a lock. The JAX package's sharded functions run on the
suite's 8 virtual devices (tests/conftest.py), each case once. Books of
11 and 13 strikes do not divide by 4: the padded lanes must leave every
result, and the normal equations, as the unpadded book's.
"""

import dataclasses
import fcntl
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from heston_tpu.config import GOLDEN_DIVIDENDS, GridSpec, SolverConfig
from heston_tpu.models import bs as jbs
from heston_tpu.parallel import sharded as jsh
from heston_tpu_torch import CalibrationConfig, HestonParams
from heston_tpu_torch import GOLDEN_DIVIDENDS as T_DIVS
from heston_tpu_torch import parallel as par
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import bs, calibration, douglas, greeks
from heston_tpu_torch.models.greeks import RISK_KEYS

import torch_sharding_world as world
from torch_parity import CPU, F64, npy
from torch_parity import release_jax_executables  # noqa: F401

P = HestonParams()
SPEC = GridSpec(**world.SPEC)
SCAN = SolverConfig(**world.SOLVER)
FUSED = dataclasses.replace(SCAN, solver_engine="pallas")
TV = torch.tensor(P.bumpable(), dtype=F64)
RATES = (P.r_d, P.r_f)
KS11 = np.linspace(85.0, 115.0, 11)
KS13 = np.linspace(85.0, 115.0, 13)
K_NE = np.linspace(90.0, 110.0, 11)
W_NE = np.linspace(0.5, 2.0, 11)
AMER_DIV = dict(american=True, dividends=GOLDEN_DIVIDENDS)
# the port's sharded results against its own single-device path: the
# same arithmetic on each option, so prices and risk agree to rounding
# of the batched operations (measured 0 to 2e-13)
SELF_TOL = 1e-12
# against the JAX package: prices relative to max(1, |price|) (measured
# up to 4.6e-14), risk columns at tests/test_torch_greeks.py's rtol with
# an atol relative to the column's largest entry (volga ~1e3 at this
# grid: an option deep in the money has ~1e-11 from one package and
# ~2e-10 from the other, both rounding noise about 0), and the AD normal
# equations
PRICE_TOL = 1e-12
RISK_RTOL, RISK_ATOL = 1e-9, 1e-12
NORMAL_EQ_TOL = 1e-10
# FD normal equations at eps = 1e-3: a price gap of ~1e-13 between the
# ranks' batches and one device's becomes ~1e-10 in J (measured delta
# 5.8e-10 relative)
FD_TOL = 1e-8


def t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The results of every rank of the gloo world, run once per test
    run (under xdist the workers share the base temp dir's parent)."""
    base = tmp_path_factory.getbasetemp()
    root = base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base
    out = root / "torch_sharding_world"
    with open(root / "torch_sharding_world.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = out / "done"
        if not done.exists():
            world.run_world(out)
            done.touch()
    res = [torch.load(out / f"rank{r}.pt", weights_only=False)
           for r in range(world.WORLD)]
    for r in res:
        assert "traceback" not in r, r["traceback"]
    return res


@pytest.fixture(scope="module")
def got(ranks):
    return ranks[0]


def _jax_mesh():
    import jax

    assert len(jax.devices()) == 8, "conftest must force 8 virtual devices"
    return jsh.make_mesh()


@functools.cache
def jax_case(name):
    mesh = _jax_mesh()
    tv = jnp.asarray(P.bumpable())
    groups = world.GROUPS
    ks11 = jnp.asarray(KS11)
    if name == "prices16":
        return npy(jsh.price_batch_sharded(
            mesh, SPEC, SCAN, jnp.linspace(80.0, 120.0, 16), 100.0, tv,
            *RATES))
    if name == "prices13_div":
        return npy(jsh.price_batch_sharded(
            mesh, SPEC, SCAN, jnp.asarray(KS13), 100.0, tv, *RATES,
            dividends=GOLDEN_DIVIDENDS))
    if name == "mixed_prices_scan":
        return npy(jsh.price_batch_sharded(
            mesh, SPEC, SCAN, ks11, 100.0, tv, *RATES, group_steps=groups,
            **AMER_DIV))
    if name == "mixed_risk_scan":
        out = jsh.batch_greeks_sharded(mesh, SPEC, SCAN, ks11, 100.0, tv,
                                       *RATES, group_steps=groups,
                                       **AMER_DIV)
        return {k: npy(v) for k, v in out.items()}
    if name == "risk_put":
        out = jsh.batch_greeks_sharded(mesh, SPEC, SCAN, ks11, 100.0, tv,
                                       *RATES, american=True,
                                       option_type="put")
        return {k: npy(v) for k, v in out.items()}
    if name.startswith("normal_eq_ad"):
        k = jnp.asarray(K_NE)
        mkt = jbs.generate_market_data(100.0, 1.0, P.r_d, k)
        w = jnp.asarray(W_NE) if name.endswith("weighted") else None
        return tuple(npy(x) for x in jsh.jacobian_normal_eq_sharded(
            mesh, SPEC, SCAN, k, mkt, 100.0, tv, *RATES, 0.01,
            jacobian_mode="ad", weights=w))
    raise KeyError(name)


# ---------------------------------------------------------------------------
# the world itself
# ---------------------------------------------------------------------------

def test_every_rank_gets_the_whole_result(ranks):
    assert [r["mesh"] for r in ranks] == [(i, world.WORLD, "cpu")
                                         for i in range(world.WORLD)]
    for r in ranks[1:]:
        assert r["errors"] == ranks[0]["errors"]
        for name in ranks[0]:
            if name not in ("mesh", "errors"):
                torch.testing.assert_close(r[name], ranks[0][name], rtol=0,
                                           atol=0, msg=name)


# ---------------------------------------------------------------------------
# against the JAX package's sharded functions (8 virtual devices); the
# port's "pallas" books (its kernels' plain versions) against JAX's
# "scan" ones, which compute the same prices without running JAX's Pallas
# kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["prices16", "prices13_div",
                                  "mixed_prices_scan",
                                  "mixed_prices_pallas"])
def test_prices_match_jax_sharded(got, name):
    want = jax_case(name.replace("pallas", "scan"))
    assert got[name].shape == want.shape
    np.testing.assert_allclose(npy(got[name]), want, rtol=PRICE_TOL,
                               atol=PRICE_TOL)


@pytest.mark.parametrize("name", ["risk_put", "mixed_risk_scan",
                                  "mixed_risk_pallas"])
def test_book_risk_matches_jax_sharded(got, name):
    want = jax_case(name.replace("pallas", "scan"))
    assert set(got[name]) == set(want) == set(RISK_KEYS)
    for k in RISK_KEYS:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(npy(got[name][k]), want[k],
                                   rtol=RISK_RTOL, atol=RISK_ATOL * scale,
                                   err_msg=f"{name}:{k}")


@pytest.mark.parametrize("name", ["normal_eq_ad", "normal_eq_ad_weighted"])
def test_ad_normal_equations_match_jax_sharded(got, name):
    delta, base, sse = got[name]
    w_delta, w_base, w_sse = jax_case(name)
    np.testing.assert_allclose(npy(base), w_base, rtol=0, atol=PRICE_TOL)
    np.testing.assert_allclose(npy(delta), w_delta, rtol=NORMAL_EQ_TOL,
                               atol=NORMAL_EQ_TOL)
    np.testing.assert_allclose(float(sse), float(w_sse), rtol=NORMAL_EQ_TOL)


# ---------------------------------------------------------------------------
# against the port's single-device path
# ---------------------------------------------------------------------------

def _single_prices(name):
    kw = {}
    if name == "prices16":
        ks, sol = np.linspace(80.0, 120.0, 16), SCAN
    elif name == "prices13_div":
        ks, sol, kw = KS13, SCAN, dict(dividends=T_DIVS)
    else:
        ks, sol = KS11, SCAN if name.endswith("scan") else FUSED
        kw = dict(american=True, dividends=T_DIVS)
    if not name.startswith("mixed"):
        return douglas.price_batch(SPEC, sol, t(ks), 100.0, *TV, *RATES,
                                   device=CPU, **kw)
    return torch.cat([douglas.price_batch(
        SPEC, douglas.group_solver(sol, g), t(ks[a:e]), 100.0, *TV,
        *RATES, device=CPU, **kw) for a, e, g in world.GROUPS])


@pytest.mark.parametrize("name", ["prices16", "prices13_div",
                                  "mixed_prices_scan",
                                  "mixed_prices_pallas"])
def test_prices_match_single_device(got, name):
    torch.testing.assert_close(got[name], _single_prices(name), rtol=0,
                               atol=SELF_TOL)


@pytest.mark.parametrize("name,solver,kw,groups", [
    ("risk_put", SCAN, dict(american=True, option_type="put"), ()),
    ("risk_pallas13", FUSED, dict(american=True, dividends=T_DIVS), ()),
    ("mixed_risk_scan", SCAN, dict(american=True, dividends=T_DIVS),
     world.GROUPS),
    ("mixed_risk_pallas", FUSED, dict(american=True, dividends=T_DIVS),
     world.GROUPS)])
def test_book_risk_matches_single_device(got, name, solver, kw, groups):
    ks = KS13 if name.endswith("13") else KS11
    want = greeks.batch_greeks(SPEC, solver, t(ks), 100.0, *TV, *RATES,
                               group_steps=groups, device=CPU, **kw)
    for k in RISK_KEYS:
        torch.testing.assert_close(got[name][k], want[k], rtol=SELF_TOL,
                                   atol=SELF_TOL, msg=f"{name}:{k}")


def _dense_step(jac, base, market, lam=0.01, w=None):
    """The damped normal-equation step of the whole book on one device."""
    w = torch.ones_like(base) if w is None else w
    resid = market - base
    jtj = (jac * w[:, None]).T @ jac * (1.0 + lam * torch.eye(5, dtype=F64))
    delta = torch.linalg.solve(jtj, (jac * w[:, None]).T @ resid)
    return delta, float(resid @ (w * resid))


@pytest.mark.parametrize("name", ["normal_eq_ad", "normal_eq_ad_weighted",
                                  "normal_eq_ad_pallas13", "normal_eq_fd"])
def test_normal_equations_match_single_device(got, name):
    """Uniform books; the 13-strike book leaves 3 padded lanes on 4 ranks,
    which must carry no weight."""
    ks = KS13 if name.endswith("13") else K_NE
    market = bs.generate_market_data(100.0, 1.0, P.r_d, t(ks))
    kw = dict(american=True) if name.endswith("13") else {}
    sol = FUSED if name.endswith("13") else SCAN
    if name == "normal_eq_fd":
        jac, base = calibration.jacobian_and_prices(
            SPEC, sol, t(ks), 100.0, TV, *RATES, eps=world.FD_EPS,
            device=CPU)
    else:
        jac, base = calibration.jacobian_and_prices_ad(
            SPEC, sol, t(ks), 100.0, TV, *RATES, device=CPU, **kw)
    w = t(W_NE) if name.endswith("weighted") else None
    want_delta, want_sse = _dense_step(jac, base, market, w=w)
    delta, base_sh, sse = got[name]
    tol = FD_TOL if name.endswith("fd") else NORMAL_EQ_TOL
    torch.testing.assert_close(base_sh, base, rtol=0, atol=SELF_TOL)
    torch.testing.assert_close(delta, want_delta, rtol=tol, atol=tol)
    assert abs(float(sse) - want_sse) <= 1e-12 * want_sse


@pytest.mark.parametrize("mode", ["ad", "fd"])
def test_mixed_normal_equations_match_single_launch(got, mode):
    """A maturity ladder: each rank's slice in one per-lane launch (the
    forward mode for "ad", six bumped primal launches for "fd") equals
    the whole ladder's launch on one device."""
    ks, market = world.ladder(torch, bs, P.r_d)
    nst = calibration.lane_steps(world.LADDER_GROUPS)
    if mode == "ad":
        base, jac = fused_do.fused_theta_jacobian(
            SPEC, FUSED, ks, 100.0, TV, *RATES, n_steps_per=nst,
            american=True, dividends=T_DIVS)
    else:
        prices = torch.stack([fused_do.fused_price_batch(
            SPEC, FUSED, ks, 100.0, *row, *RATES, n_steps_per=nst)
            for row in calibration._bumped_param_matrix(TV, world.FD_EPS)])
        base, jac = prices[0], ((prices[1:] - prices[0]) / world.FD_EPS).T
    want_delta, want_sse = _dense_step(jac, base, market)
    delta, base_sh, sse = got[f"normal_eq_mixed_{mode}"]
    tol = FD_TOL if mode == "fd" else NORMAL_EQ_TOL
    torch.testing.assert_close(base_sh, base, rtol=0, atol=SELF_TOL)
    torch.testing.assert_close(delta, want_delta, rtol=tol, atol=tol)
    assert abs(float(sse) - want_sse) <= 1e-12 * want_sse


@pytest.mark.parametrize("name,solver,kw", [
    ("jac_fn_fd", SCAN, {}),
    ("jac_fn_fd_pallas", FUSED, dict(american=True)),
    ("jac_fn_ad_pallas", FUSED, dict(american=True))])
def test_sharded_pricing_fns_jacobian(got, name, solver, kw):
    """ROADMAP C1: the sharded FD Jacobian at eps = 1e-3 against the
    single-device one (at 1e-6 the bump turns a price gap of ~1e-12
    between two programs into ~1e-6 in J); the forward mode exactly."""
    ks = t(K_NE[:10])
    if name.endswith("ad_pallas"):
        want_jac, want_base = calibration.jacobian_and_prices_ad(
            SPEC, solver, ks, 100.0, TV, *RATES, device=CPU, **kw)
    else:
        prices = torch.stack([douglas.price_batch(
            SPEC, solver, ks, 100.0, *row, *RATES, device=CPU, **kw)
            for row in calibration._bumped_param_matrix(TV, world.FD_EPS)])
        want_base = prices[0]
        want_jac = ((prices[1:] - prices[0]) / world.FD_EPS).T
        if solver is SCAN:
            # and the eager FD Jacobian of the host driver
            eager, _ = calibration.jacobian_and_prices(
                SPEC, SCAN, ks, 100.0, TV, *RATES, eps=world.FD_EPS,
                device=CPU)
            torch.testing.assert_close(want_jac, eager, rtol=0, atol=1e-9)
    jac, base = got[name]
    torch.testing.assert_close(base, want_base, rtol=0, atol=SELF_TOL)
    torch.testing.assert_close(jac, want_jac, rtol=0, atol=1e-9)


def test_sharded_price_fn(got):
    want = douglas.price_batch(SPEC, SCAN, t(K_NE), 100.0, *TV, *RATES,
                               american=True, device=CPU)
    torch.testing.assert_close(got["price_fn"], want, rtol=0, atol=SELF_TOL)


def test_calibrate_sharded_ladder_matches_calibrate_device(got):
    """The whole American-dividend ladder sharded for every pass; the
    trajectory of calibrate_device's one-launch loop (the same AD
    Jacobian and LM rules), and the SSE cut."""
    ks, market = world.ladder(torch, bs, P.r_d)
    cfg = CalibrationConfig(max_iter=3, tol=1e-12, jacobian_mode="ad")
    want_tv, want = calibration.calibrate_device(
        SPEC, FUSED, ks, market, 100.0, torch.tensor(world.INIT, dtype=F64),
        *RATES, cfg=cfg, group_steps=world.LADDER_GROUPS, american=True,
        dividends=T_DIVS, device=CPU)
    res = got["calibrate_ladder"]
    assert res["iterations"] == 3
    assert res["final_error"] < 0.2 * res["first_sse"]
    torch.testing.assert_close(res["tv"], want_tv, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res["final_error"], float(want["final_error"]),
                               rtol=1e-9)


def test_calibrate_sharded_resumes_from_rank_zeros_checkpoint(got):
    """Two iterations with a checkpoint (written by rank 0), then resumed
    to three on every rank: the straight run's result."""
    res, straight = got["calibrate_resumed"], got["calibrate_ladder"]
    assert res["file_after_first"]
    assert res["iterations"] == 3 and res["history_len"] == 3
    torch.testing.assert_close(res["tv"], straight["tv"], rtol=0, atol=0)
    assert res["final_error"] == straight["final_error"]


def test_host_calibrate_through_sharded_pricing_fns(got):
    """calibrate(pricing_fns=sharded_pricing_fns(mesh)) with the FD
    Jacobian at eps = 1e-3 follows the single-device host loop. JᵀJ's
    condition number is ~9e8 at the start, so Jacobians ~1e-11 apart
    leave the parameters and the SSE ~1e-7 apart (relative; measured
    1.8e-7 and 1.1e-8) after three steps."""
    targets = calibration.CalibrationTargets(
        strikes=K_NE, maturities=np.ones(11),
        prices=npy(bs.generate_market_data(100.0, 1.0, P.r_d, t(K_NE))),
        s0=100.0, r_d=P.r_d)
    init = dataclasses.replace(P, kappa=world.INIT[0], eta=world.INIT[1],
                               sigma=world.INIT[2], rho=world.INIT[3],
                               v0=world.INIT[4])
    fit = calibration.calibrate(
        targets, SPEC, SCAN, init,
        CalibrationConfig(max_iter=3, tol=1e-12, eps=world.FD_EPS),
        device=CPU)
    res = got["calibrate_host_fd"]
    assert res["iterations"] == fit.iterations == 3
    np.testing.assert_allclose(npy(res["tv"]), fit.params.bumpable(),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(res["final_error"], fit.final_error,
                               rtol=1e-6)


def test_bad_group_steps_raise_on_every_rank(got):
    msgs = got["errors"]
    assert all(m is not None and "group_steps" in m for m in msgs[:6])
    assert "fused engine" in msgs[6]


# ---------------------------------------------------------------------------
# a world of one, without a process group
# ---------------------------------------------------------------------------

def test_world_of_one_without_a_process_group(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    par.ensure_distributed("cpu")
    assert not dist.is_initialized()
    mesh = par.make_mesh("cpu")
    assert (mesh.group, mesh.rank, mesh.size) == (None, 0, 1)
    assert mesh.device == torch.device("cpu")
    ks = t(KS13)
    assert torch.equal(par.shard_batch(ks, mesh), ks)
    got = par.price_batch_sharded(mesh, SPEC, FUSED, ks, 100.0, TV, *RATES,
                                  american=True)
    want = douglas.price_batch(SPEC, FUSED, ks, 100.0, *TV, *RATES,
                               american=True, device=CPU)
    assert torch.equal(got, want)
    risk = par.batch_greeks_sharded(mesh, SPEC, SCAN, ks, 100.0, TV, *RATES)
    want_r = greeks.batch_greeks(SPEC, SCAN, ks, 100.0, *TV, *RATES,
                                 device=CPU)
    for k in RISK_KEYS:
        assert torch.equal(risk[k], want_r[k]), k


def test_padding_repeats_the_last_option():
    mesh = par.sharded.Mesh(None, 2, 4, torch.device("cpu"))
    ks = t(KS13)
    padded, n = par.sharded._pad_to(ks, 4)
    assert n == 13 and padded.shape == (16,)
    assert torch.equal(padded[13:], ks[-1:].expand(3))
    assert torch.equal(par.shard_batch(ks, mesh), padded[8:12])


def test_mesh_and_group_errors(monkeypatch):
    with pytest.raises(ValueError, match="not initialized"):
        par.make_mesh("cpu", group=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        par.make_mesh()

"""The gloo world of tests/test_torch_sharding.py: `run_world` spawns
WORLD ranks on the CPU, joined through a FileStore; each runs every case
of `cases` through heston_tpu_torch.parallel in float64 and saves what it
got (tensors, floats, error messages) to <out>/rank<r>.pt. No JAX here:
each rank imports torch and the port only."""

import dataclasses
import multiprocessing
import os
import time
import traceback
from pathlib import Path

WORLD = 4
SPEC = dict(m1=16, m2=10)
SOLVER = dict(n_steps=6, theta=0.8, maturity=1.0, a2_variant="upwind")
INIT = (1.0, 0.05, 0.4, -0.5, 0.05)
GROUPS = ((0, 5, 3), (5, 11, 6))          # the 11-strike mixed book
LADDER_GROUPS = ((0, 8, 3), (8, 16, 6))   # two maturities of 8 strikes
BAD_GROUPS = (((0, 4, 5), (6, 8, 10)),    # a gap
              ((4, 8, 10), (0, 4, 5)),    # out of order
              ((0, 4, 5), (4, 6, 10)))    # short cover
FD_EPS = 1e-3


def ladder(torch, bs, r_d):
    """Strikes [16] and Black–Scholes quotes of the two-maturity ladder
    (T = 0.5, 1), as tests/test_sharding.py builds it."""
    ks = torch.cat([torch.linspace(90.0, 110.0, 8,
                                   dtype=torch.float64)] * 2)
    market = torch.cat([bs.generate_market_data(100.0, 0.5, r_d, ks[:8]),
                        bs.generate_market_data(100.0, 1.0, r_d, ks[8:])])
    return ks, market


def _cases(mesh, ckpt_dir):
    """name -> a function of nothing returning the case's result."""
    import torch

    from heston_tpu_torch import (GOLDEN_DIVIDENDS, CalibrationConfig,
                                  GridSpec, HestonParams, SolverConfig)
    from heston_tpu_torch import parallel as par
    from heston_tpu_torch.models import bs, calibration

    f64 = torch.float64
    p = HestonParams()
    spec = GridSpec(**SPEC)
    scan = SolverConfig(**SOLVER)
    fused = dataclasses.replace(scan, solver_engine="pallas")
    tv = torch.tensor(p.bumpable(), dtype=f64)
    rates = (p.r_d, p.r_f)
    ks11 = torch.linspace(85.0, 115.0, 11, dtype=f64)
    ks13 = torch.linspace(85.0, 115.0, 13, dtype=f64)
    k_ne = torch.linspace(90.0, 110.0, 11, dtype=f64)
    mkt_ne = bs.generate_market_data(100.0, 1.0, p.r_d, k_ne)
    w_ne = torch.linspace(0.5, 2.0, 11, dtype=f64)
    mkt13 = bs.generate_market_data(100.0, 1.0, p.r_d, ks13)
    ks_l, mkt_l = ladder(torch, bs, p.r_d)
    amer_div = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    jac_fn, price_fn = par.sharded_pricing_fns(mesh)
    cfg = CalibrationConfig(max_iter=3, tol=1e-12, jacobian_mode="ad")

    def normal_eq(solver, ks, mkt, **kw):
        return par.jacobian_normal_eq_sharded(mesh, spec, solver, ks, mkt,
                                              100.0, tv, *rates, 0.01, **kw)

    def errors():
        out = []
        for bad in BAD_GROUPS:
            for fn in (par.price_batch_sharded, par.batch_greeks_sharded):
                try:
                    fn(mesh, spec, scan, torch.linspace(90.0, 110.0, 8,
                                                        dtype=f64),
                       100.0, tv, *rates, group_steps=bad)
                    out.append(None)
                except ValueError as exc:
                    out.append(str(exc))
        try:
            normal_eq(scan, k_ne[:8], mkt_ne[:8],
                      group_steps=((0, 4, 3), (4, 8, 6)))
            out.append(None)
        except ValueError as exc:
            out.append(str(exc))
        return out

    def resumed():
        """calibrate_sharded for 2 iterations with a checkpoint, then
        resumed to 3: rank 0 writes, every rank reads."""
        path = str(Path(ckpt_dir) / "lm.json")
        kw = dict(group_steps=LADDER_GROUPS, checkpoint_path=path,
                  **amer_div)
        par.calibrate_sharded(mesh, spec, fused, ks_l, mkt_l, 100.0,
                              torch.tensor(INIT, dtype=f64), *rates,
                              cfg=dataclasses.replace(cfg, max_iter=2), **kw)
        first = Path(path).exists()
        tv3, info = par.calibrate_sharded(
            mesh, spec, fused, ks_l, mkt_l, 100.0,
            torch.tensor(INIT, dtype=f64), *rates, cfg=cfg, **kw)
        return dict(tv=tv3, iterations=info["iterations"],
                    final_error=info["final_error"], file_after_first=first,
                    history_len=len(info["history"]))

    def calibrated():
        tv3, info = par.calibrate_sharded(
            mesh, spec, fused, ks_l, mkt_l, 100.0,
            torch.tensor(INIT, dtype=f64), *rates, cfg=cfg,
            group_steps=LADDER_GROUPS, **amer_div)
        return dict(tv=tv3, iterations=info["iterations"],
                    final_error=info["final_error"],
                    first_sse=info["history"][0]["sse"],
                    fitted=torch.as_tensor(info["fitted_prices"]))

    def host_calibrated():
        targets = calibration.CalibrationTargets(
            strikes=k_ne.numpy(), maturities=torch.ones(11, dtype=f64)
            .numpy(), prices=mkt_ne.numpy(), s0=100.0, r_d=p.r_d)
        fit = calibration.calibrate(
            targets, spec, scan, dataclasses.replace(
                p, kappa=INIT[0], eta=INIT[1], sigma=INIT[2], rho=INIT[3],
                v0=INIT[4]),
            CalibrationConfig(max_iter=3, tol=1e-12, eps=FD_EPS),
            pricing_fns=(jac_fn, price_fn), device="cpu")
        return dict(tv=torch.tensor(fit.params.bumpable(), dtype=f64),
                    final_error=fit.final_error, iterations=fit.iterations)

    return {
        "prices16": lambda: par.price_batch_sharded(
            mesh, spec, scan, torch.linspace(80.0, 120.0, 16, dtype=f64),
            100.0, tv, *rates),
        "prices13_div": lambda: par.price_batch_sharded(
            mesh, spec, scan, ks13, 100.0, tv, *rates,
            dividends=GOLDEN_DIVIDENDS),
        "mixed_prices_scan": lambda: par.price_batch_sharded(
            mesh, spec, scan, ks11, 100.0, tv, *rates, group_steps=GROUPS,
            **amer_div),
        "mixed_prices_pallas": lambda: par.price_batch_sharded(
            mesh, spec, fused, ks11, 100.0, tv, *rates, group_steps=GROUPS,
            **amer_div),
        "risk_put": lambda: par.batch_greeks_sharded(
            mesh, spec, scan, ks11, 100.0, tv, *rates, american=True,
            option_type="put"),
        "risk_pallas13": lambda: par.batch_greeks_sharded(
            mesh, spec, fused, ks13, 100.0, tv, *rates, **amer_div),
        "mixed_risk_scan": lambda: par.batch_greeks_sharded(
            mesh, spec, scan, ks11, 100.0, tv, *rates, group_steps=GROUPS,
            **amer_div),
        "mixed_risk_pallas": lambda: par.batch_greeks_sharded(
            mesh, spec, fused, ks11, 100.0, tv, *rates, group_steps=GROUPS,
            **amer_div),
        "normal_eq_ad": lambda: normal_eq(scan, k_ne, mkt_ne,
                                          jacobian_mode="ad"),
        "normal_eq_ad_weighted": lambda: normal_eq(
            scan, k_ne, mkt_ne, jacobian_mode="ad", weights=w_ne),
        "normal_eq_ad_pallas13": lambda: normal_eq(
            fused, ks13, mkt13, jacobian_mode="ad", american=True),
        "normal_eq_fd": lambda: normal_eq(scan, k_ne, mkt_ne, eps=FD_EPS),
        "normal_eq_mixed_ad": lambda: normal_eq(
            fused, ks_l, mkt_l, jacobian_mode="ad", group_steps=LADDER_GROUPS,
            **amer_div),
        "normal_eq_mixed_fd": lambda: normal_eq(
            fused, ks_l, mkt_l, eps=FD_EPS, jacobian_mode="fd",
            group_steps=LADDER_GROUPS),
        "jac_fn_fd": lambda: jac_fn(spec, scan, k_ne[:10], 100.0, tv,
                                    *rates, eps=FD_EPS),
        "jac_fn_fd_pallas": lambda: jac_fn(spec, fused, k_ne[:10], 100.0,
                                           tv, *rates, eps=FD_EPS,
                                           american=True),
        "jac_fn_ad_pallas": lambda: jac_fn(spec, fused, k_ne[:10], 100.0,
                                           tv, *rates, american=True,
                                           jacobian_mode="ad"),
        "price_fn": lambda: price_fn(spec, scan, k_ne, 100.0, tv, *rates,
                                     american=True),
        "calibrate_ladder": calibrated,
        "calibrate_resumed": resumed,
        "calibrate_host_fd": host_calibrated,
        "errors": errors,
    }


def _rank(rank, store_path, out_dir):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from heston_tpu_torch import parallel as par

    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, WORLD), rank=rank,
        world_size=WORLD)
    results = {}
    try:
        par.ensure_distributed("cpu")          # already initialized: no-op
        mesh = par.make_mesh("cpu")
        results["mesh"] = (mesh.rank, mesh.size, str(mesh.device))
        for name, fn in _cases(mesh, out_dir).items():
            results[name] = fn()
    except Exception:
        results["traceback"] = traceback.format_exc()
    finally:
        torch.save(results, Path(out_dir) / f"rank{rank}.pt")
        dist.destroy_process_group()


def run_world(out_dir, timeout: float = 240.0):
    """Spawn the WORLD ranks, wait for them, return the results of every
    rank (a list of dicts)."""
    import torch

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    store = out_dir / "store"
    store.unlink(missing_ok=True)     # a FileStore file holds one world
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, str(store),
                                             str(out_dir)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
    if alive:
        raise RuntimeError(f"{len(alive)} ranks still running after "
                           f"{timeout} s")
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


if __name__ == "__main__":
    import sys

    res = run_world(sys.argv[1] if len(sys.argv) > 1 else "world_out")
    print({k: type(v).__name__ for k, v in res[0].items()})
    os._exit(0)

"""Multi-rank walkthrough: shard an option book over the ranks of a
`torch.distributed` group, run whole-book risk, and calibrate a
mixed-maturity chain with the distributed LM driver (the port of
examples/distributed.py).

One process (a world of one, no process group):

    python -m heston_tpu_torch.examples.distributed [--device cpu]

N processes, one card each (NCCL; gloo with --device cpu):

    torchrun --nproc_per_node=N -m heston_tpu_torch.examples.distributed

Float64 on the CPU, float32 on the card (the JAX example's x64 on its CPU
backend). Rank 0 prints.
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist

from heston_tpu_torch import (GOLDEN_DIVIDENDS, CalibrationConfig, GridSpec,
                              HestonParams, SolverConfig)
from heston_tpu_torch.models import bs
from heston_tpu_torch.parallel import (batch_greeks_sharded,
                                       calibrate_sharded, ensure_distributed,
                                       make_mesh, price_batch_sharded)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="distributed")
    ap.add_argument("--device", default=None,
                    help="torch device of every rank (default: the card)")
    args = ap.parse_args(argv)
    ensure_distributed(args.device)
    mesh = make_mesh(args.device)
    dtype = torch.float64 if mesh.device.type == "cpu" else torch.float32

    def say(*what):
        if mesh.rank == 0:
            print(*what, flush=True)

    params = HestonParams()
    spec = GridSpec(m1=30, m2=15)
    solver = SolverConfig(n_steps=10, theta=0.8, maturity=1.0,
                          a2_variant="upwind", solver_engine="pallas")
    say(f"mesh: {mesh.size} ranks ({mesh.device.type})")
    tv = torch.tensor(params.bumpable(), dtype=dtype)

    # --- 1. sharded pricing: each rank prices its slice, no communication
    # until the gather ---------------------------------------------------
    book = torch.linspace(70.0, 130.0, 24, dtype=dtype)
    prices = price_batch_sharded(
        mesh, spec, solver, book, 100.0, tv, params.r_d, params.r_f,
        american=True, dividends=GOLDEN_DIVIDENDS)
    say("sharded book prices:", np.round(prices[:6].cpu().numpy(), 4), "...")

    # --- 2. sharded whole-book risk, mixed maturities in one per-lane
    # launch per rank ------------------------------------------------------
    groups = ((0, 12, 5), (12, 24, 10))     # T=0.5 and T=1.0 halves
    risk = batch_greeks_sharded(
        mesh, spec, solver, book, 100.0, tv, params.r_d, params.r_f,
        american=True, group_steps=groups)
    say("mixed-book delta:", np.round(risk["delta"][:6].cpu().numpy(), 4),
        "...")

    # --- 3. distributed mixed-maturity calibration: the chain stays
    # sharded for every Jacobian pass (one forward-mode launch per rank)
    # and every trial pricing; JᵀJ and Jᵀr reduce over the ranks --------
    market = torch.cat([
        bs.generate_market_data(100.0, 0.5, params.r_d, book[:12]),
        bs.generate_market_data(100.0, 1.0, params.r_d, book[12:]),
    ])
    tv_fit, info = calibrate_sharded(
        mesh, spec, solver, book, market, 100.0,
        torch.tensor([1.0, 0.05, 0.4, -0.5, 0.05], dtype=dtype), params.r_d,
        params.r_f,
        cfg=CalibrationConfig(max_iter=5, tol=1e-8, jacobian_mode="ad"),
        group_steps=groups)
    say(f"calibrated in {info['iterations']} iterations, "
        f"sse={info['final_error']:.4e}:",
        np.round(tv_fit.cpu().numpy(), 4))
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()

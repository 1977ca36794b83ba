"""Measurements behind the Monte Carlo tolerances (tests/test_torch_mc.py)
and PERF.md's float32 LSMC finding, on the CPU.

    python scripts/torch_mc_bias.py bias      # the port, 2,000,000 paths
    python scripts/torch_mc_bias.py lsmc32    # both packages, f32 and f64

bias: each scheme's European price against the CF price at the test's
step counts (50 Euler, 16 QE steps), calls and puts, antithetic, float64.
lsmc32: the LSMC American call with the golden dividends, 300,000 paths
x 100 steps, antithetic, seeds 0 and 1, in float32 and float64, the JAX
package (x64 off and on, a process each) and the port.
"""

import subprocess
import sys


def bias():
    import torch

    from heston_tpu_torch.config import HestonParams
    from heston_tpu_torch.models import heston_cf, mc

    p = HestonParams()
    k = torch.tensor(100.0, dtype=torch.float64)
    gen = torch.Generator().manual_seed(123)
    for ot in ("call", "put"):
        truth = float(heston_cf.price_chain(
            100.0, k.reshape(1), p.v0, p.kappa, p.eta, p.sigma, p.rho, p.r_d,
            1.0, option_type=ot, device="cpu")[0])
        for scheme, n in (("truncation", 50), ("reflection", 50),
                          ("qe", 16)):
            price, half = mc.price_european_call_mc(
                gen, 100.0, p.v0, k, p.r_d, p.r_f, p.kappa, p.eta, p.sigma,
                p.rho, 1.0, num_paths=2_000_000, n_steps=n, scheme=scheme,
                option_type=ot, antithetic=True, device="cpu")
            print(scheme, ot, "bias", float(price) - truth, "+-",
                  float(half))


def lsmc_jax(x64):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    from heston_tpu.config import GOLDEN_DIVIDENDS, HestonParams
    from heston_tpu.models import mc

    p = HestonParams()
    for seed in (0, 1):
        price, half = mc.price_american_lsmc(
            jax.random.PRNGKey(seed), 100.0, p.v0, 100.0, p.r_d, p.r_f,
            p.kappa, p.eta, p.sigma, p.rho, 1.0, num_paths=300_000,
            n_steps=100, option_type="call", dividends=GOLDEN_DIVIDENDS,
            antithetic=True)
        print("jax", "float64" if x64 else "float32", "seed", seed,
              float(price), "+-", float(half), flush=True)


def lsmc_port():
    import torch

    from heston_tpu_torch.config import GOLDEN_DIVIDENDS, HestonParams
    from heston_tpu_torch.models import mc

    p = HestonParams()
    for dtype in (torch.float32, torch.float64):
        for seed in (0, 1):
            price, half = mc.price_american_lsmc(
                torch.Generator().manual_seed(seed), 100.0, p.v0,
                torch.tensor(100.0, dtype=dtype), p.r_d, p.r_f, p.kappa,
                p.eta, p.sigma, p.rho, 1.0, num_paths=300_000, n_steps=100,
                option_type="call", dividends=GOLDEN_DIVIDENDS,
                antithetic=True, device="cpu")
            print("port", dtype, "seed", seed, float(price), "+-",
                  float(half), flush=True)


if __name__ == "__main__":
    what = sys.argv[1] if len(sys.argv) > 1 else "bias"
    if what == "bias":
        bias()
    elif what == "lsmc32":
        for x64 in ("0", "1"):      # JAX's x64 is fixed once per process
            subprocess.run([sys.executable, __file__, "lsmc_jax", x64],
                           check=True)
        lsmc_port()
    elif what == "lsmc_jax":
        lsmc_jax(sys.argv[2] == "1")
    else:
        raise SystemExit(f"unknown measurement {what!r}")

"""ROADMAP C1: why tests/test_sharding.py's two FD tests fail. Runs the
JAX package's sharded functions on 8 virtual CPU devices on those tests'
inputs and prints, for each: the sharded base prices against the
one-device ones (price_batch_sharded and the FD program of
sharded_pricing_fns), the FD Jacobian's gap at eps = 1e-6 and 1e-3, and
(normal equations) the LM step's gap. Edits nothing.

    python scripts/c1_fd_amplification.py
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from heston_tpu.config import GridSpec, HestonParams, SolverConfig  # noqa
from heston_tpu.models import calibration as calib  # noqa: E402
from heston_tpu.parallel import (jacobian_normal_eq_sharded,  # noqa: E402
                                 make_mesh, price_batch_sharded,
                                 sharded_pricing_fns)


def main():
    spec = GridSpec(m1=16, m2=10)           # tests/test_sharding.py:19-20
    solver = SolverConfig(n_steps=6, theta=0.8, maturity=1.0,
                          a2_variant="upwind")
    p = HestonParams()
    tv = jnp.array(p.bumpable())
    mesh = make_mesh()
    jac_fn, _ = sharded_pricing_fns(mesh)
    for name, ks in (("normal_equations (:57)", jnp.linspace(90., 110., 11)),
                     ("pricing_fns (:79)", jnp.linspace(80., 120., 10))):
        base = calib.base_prices(spec, solver, ks, 100.0, tv, p.r_d, p.r_f)
        sharded = price_batch_sharded(mesh, spec, solver, ks, 100.0, tv,
                                      p.r_d, p.r_f)
        print(name, "price_batch_sharded - base_prices:",
              float(jnp.max(jnp.abs(sharded - base))))
        for eps in (1e-6, 1e-3):
            j_sh, b_sh = jac_fn(spec, solver, ks, 100.0, tv, p.r_d, p.r_f,
                                eps=eps)
            j, b = calib.jacobian_and_prices(spec, solver, ks, 100.0, tv,
                                             p.r_d, p.r_f, eps=eps)
            print(f"  eps={eps:g}: FD base gap",
                  float(jnp.max(jnp.abs(b_sh - b))), "J gap",
                  float(jnp.max(jnp.abs(j_sh - j))))
            if name.startswith("normal") and eps == 1e-6:
                market = calib.base_prices(spec, solver, ks, 100.0,
                                           tv * 1.05, p.r_d, p.r_f)
                want = calib.lm_update(j, market - b, 0.01)
                delta, _, _ = jacobian_normal_eq_sharded(
                    mesh, spec, solver, ks, market, 100.0, tv, p.r_d,
                    p.r_f, 0.01)
                print("  LM step gap", float(jnp.max(jnp.abs(delta - want))),
                      "relative", float(jnp.max(jnp.abs(delta - want)
                                                / jnp.abs(want))))


if __name__ == "__main__":
    main()

"""heston_tpu_torch — Heston PDE pricing and calibration in PyTorch with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of the JAX package `heston_tpu`, which stays the reference. It
imports nothing of that package: `config.py` is its own copy of the
configuration dataclasses. Layout mirrors the JAX package: `ops/` (grids,
stencils, operator bands), `kernels/` (host side, wrapper and plain
version of each GPU kernel; CUDA sources in `csrc/`), `models/` (pricing
and calibration entry points, Black–Scholes oracle) and `convert.py`
(inputs carried across from JAX, for the tests).

Entry points run on the card unless the caller passes `device="cpu"`.
Ported: batched ADI pricing (Douglas, Craig–Sneyd, modified Craig–Sneyd,
Hundsdorfer–Verwer) of calls, puts and cash-or-nothing digitals, with or
without a knock-out barrier, European or American, with or without
discrete dividends, at flat rates or on a piecewise-constant rate curve
(`RateSchedule`), with or without Rannacher start-up damping: through
the fused time-loop kernels (`price_batch` with `solver_engine="pallas"`;
`price_knock_in` by in–out parity) and through the eager ADI loop
(`price_option`, `price_and_v0_stencil`, `price_surface`, and
`price_batch` under "scan" or "pcr", a sequential or a log-depth banded
engine). Levenberg–Marquardt calibration on the device
(`calibrate_device`), with the exact forward-mode Jacobian through the
same time-loop kernel (damped or not; the v0 column off the surface
stencil or, `v0_mode="ad"`, the grid motion) or through the eager loop,
and the host LM loop `calibrate` (per-maturity groups, weights,
checkpoints that resume in either package, `utils.checkpoint`);
mixed-maturity books (per-option step counts) in one launch; book risk
read off the solution surfaces (`batch_greeks`, `pde_theta`, `gamma`)
and one option's price and sensitivities by forward-mode AD
(`price_and_greeks`). The semi-analytic characteristic-function pricer
(`price_chain`, `models.heston_cf`; `calibrate_device(pricer="cf")`), the
native OpenMP CPU engine over csrc/heston_cpu.cpp (`utils.native`), the
reference's calibration scenarios (`run_scenario`, `SCENARIOS`), the
benchmark sweeps (`benchmarks`), CSV exporters (`utils.io`), roofline
counts (`utils.roofline`), named spans on the pricing path, recorded only
under a profiler session, and a profiler session written as a Chrome
trace (`utils.profiling`: `scope`, `trace`), and the bench on the card: `python -m heston_tpu_torch.bench`. The Monte Carlo
oracle (`models.mc`: Euler and Andersen QE paths, dividend jumps,
Brownian-bridge barriers, Longstaff–Schwartz American options) from a
seeded `torch.Generator`; option-book sharding over a `torch.distributed`
group (`parallel`: each rank prices its slice on the same kernels, the LM
normal equations reduced in one all_reduce); the command line
(`python -m heston_tpu_torch.cli`) and worked examples
(`python -m heston_tpu_torch.examples.quickstart`, `.distributed`).
"""

from heston_tpu_torch.config import (
    GOLDEN_DIVIDENDS,
    Barrier,
    CalibrationConfig,
    DividendSchedule,
    GridSpec,
    HestonParams,
    RateSchedule,
    SolverConfig,
)
from heston_tpu_torch.models.calibration import (CalibrationResult,
                                                 CalibrationTargets,
                                                 calibrate, calibrate_device)
from heston_tpu_torch.models.douglas import (price_and_v0_stencil,
                                             price_batch, price_batch_params,
                                             price_knock_in, price_option,
                                             price_surface)
from heston_tpu_torch.models.greeks import (RISK_KEYS, batch_greeks, gamma,
                                            pde_theta, price_and_greeks)
from heston_tpu_torch.models.heston_cf import price_chain
from heston_tpu_torch.models.mc import (price_american_lsmc,
                                        price_european_call_mc)
from heston_tpu_torch.parallel import (batch_greeks_sharded,
                                       calibrate_sharded, make_mesh,
                                       price_batch_sharded,
                                       sharded_pricing_fns)
from heston_tpu_torch.scenarios import SCENARIOS, run_scenario

__all__ = [
    "Barrier",
    "HestonParams",
    "GridSpec",
    "SolverConfig",
    "DividendSchedule",
    "RateSchedule",
    "GOLDEN_DIVIDENDS",
    "CalibrationConfig",
    "CalibrationResult",
    "CalibrationTargets",
    "calibrate",
    "calibrate_device",
    "price_batch",
    "price_batch_params",
    "price_knock_in",
    "price_option",
    "price_and_v0_stencil",
    "price_surface",
    "price_and_greeks",
    "RISK_KEYS",
    "batch_greeks",
    "pde_theta",
    "gamma",
    "price_chain",
    "price_european_call_mc",
    "price_american_lsmc",
    "make_mesh",
    "price_batch_sharded",
    "batch_greeks_sharded",
    "calibrate_sharded",
    "sharded_pricing_fns",
    "SCENARIOS",
    "run_scenario",
]

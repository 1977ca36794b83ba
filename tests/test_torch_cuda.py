"""The CUDA time-loop kernel against its plain PyTorch version, on the card.

Imports no JAX (the machine with the card has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips (the skip is decided inside the fixture).
"""

import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, GridSpec, HestonParams,
                               SolverConfig)
from heston_tpu_torch.kernels import fused_do

P = HestonParams()
SPEC = GridSpec(m1=20, m2=12)
SOLVER = SolverConfig(n_steps=8, a2_variant="upwind", solver_engine="pallas")
ARMS = {
    "euro": dict(american=False, dividends=None),
    "amer": dict(american=True, dividends=None),
    "div": dict(american=False, dividends=GOLDEN_DIVIDENDS),
    "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _inputs(device, dtype, arm, r_f=0.0):
    strikes = torch.linspace(70.0, 130.0, 37, dtype=dtype, device=device)
    fields, vec_s, idx_s, idx_v = fused_do._assemble(
        SPEC, SOLVER, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, r_f)
    events = fused_do.dividend_plan(SOLVER, ARMS[arm]["dividends"])
    remaps = fused_do._build_remap_fields(vec_s, events)
    kw = dict(theta=SOLVER.theta, delta_t=SOLVER.delta_t,
              n_steps=SOLVER.n_steps, rf=r_f,
              american=ARMS[arm]["american"])
    return fields, [e[0] for e in events], remaps, kw


@pytest.mark.cuda
@pytest.mark.parametrize("r_f", [0.0, 0.01])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_kernel_f64_matches_plain(cuda_device, arm, r_f):
    """float64 kernel against the float64 plain version on the same
    inputs, every grid point at 1e-10; exactly one launch per call."""
    fields, steps, remaps, kw = _inputs(cuda_device, torch.float64, arm, r_f)
    before = fused_do.fused_do_loop.launches
    got = fused_do.fused_do_loop(fields, steps, remaps, **kw)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.launches == before + 1
    want = fused_do.fused_do_reference(fields, steps, remaps, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_kernel_f32_matches_plain_f32(cuda_device, arm):
    """float32 kernel against the float32 plain version on the same
    inputs: both run the same IEEE operation sequence (the kernel is
    built with -fmad=false), so they agree to a few ulps of the surface
    (values up to ~10^3: 1e-3 absolute is ~16 ulps there)."""
    fields, steps, remaps, kw = _inputs(cuda_device, torch.float32, arm)
    got = fused_do.fused_do_loop(fields, steps, remaps, **kw)
    want = fused_do.fused_do_reference(fields, steps, remaps, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m1,m2", [(6, 9), (100, 75), (150, 140)])
def test_kernel_f64_matches_plain_other_grids(cuda_device, m1, m2):
    """Grid shapes off the main path: m1 < m2 (the b1 flat-index quirk
    wraps past column 0), the reference's 101 x 76 golden grid, and
    lines longer than the 128-thread block (strided sweeps)."""
    spec = GridSpec(m1=m1, m2=m2)
    solver = SolverConfig(n_steps=4, solver_engine="pallas")
    strikes = torch.linspace(80.0, 120.0, 5, dtype=torch.float64,
                             device=cuda_device)
    fields, vec_s, _, _ = fused_do._assemble(
        spec, solver, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, 0.01)
    events = fused_do.dividend_plan(solver, GOLDEN_DIVIDENDS)
    remaps = fused_do._build_remap_fields(vec_s, events)
    kw = dict(theta=solver.theta, delta_t=solver.delta_t,
              n_steps=solver.n_steps, rf=0.01, american=True)
    steps = [e[0] for e in events]
    got = fused_do.fused_do_loop(fields, steps, remaps, **kw)
    want = fused_do.fused_do_reference(fields, steps, remaps, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)

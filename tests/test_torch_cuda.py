"""The CUDA time-loop kernels against their plain PyTorch versions, on the
card: the batched kernel (primal and forward mode, uniform and
mixed-maturity books, rate-curve pieces, the tangent state handed from a
damp launch on, five tangents) and the single-option latency kernel,
under every scheme (Douglas, Craig-Sneyd, modified Craig-Sneyd,
Hundsdorfer-Verwer) and payoff (calls, puts, cash-or-nothing digitals,
knock-out barriers).

Imports no JAX (the machine with the card has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips (the skip is decided inside the fixture).
The launch plan (fused_do.launch_plan) is forced through the private
smem_budget and groups keywords where a test holds every placement of the
working fields and both tangent groupings against the plain version;
kernel 2's (fused_single.launch_plan) through the private plan keyword:
clusters of 1, 2 and 8 blocks, the PCR factors in shared or global
memory.
The float32 kernel-against-plain tests name the -fmad=false builds
(`fmad=False`), whose arithmetic is the plain version's operation for
operation; the float32 main path takes the -fmad=true build
(fused_do.use_fmad, ROADMAP C9).
"""

import dataclasses
import functools

import pytest
import torch

from heston_tpu_torch.config import (GOLDEN_DIVIDENDS, Barrier,
                                     CalibrationConfig, GridSpec,
                                     HestonParams, RateSchedule,
                                     SolverConfig)
from heston_tpu_torch.kernels import fused_do, fused_single

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
    fields, vec_s, idx_s, idx_v, _ = fused_do._assemble(
        SPEC, SOLVER, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, r_f)
    events = fused_do.dividend_plan(SOLVER, ARMS[arm]["dividends"])
    remaps = fused_do._build_remap_fields(vec_s, events)
    kw = dict(theta=SOLVER.theta, delta_t=SOLVER.delta_t,
              n_steps=SOLVER.n_steps, rf=r_f,
              american=ARMS[arm]["american"])
    return fields, [e[0] for e in events], remaps, kw


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("r_f", [0.0, 0.01])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_kernel_f64_matches_plain(cuda_device, arm, r_f, scheme):
    """float64 kernel against the float64 plain version on the same
    inputs, u and lambda on every grid point at 1e-10, under every
    scheme; exactly one launch per call. A corrector scheme's surfaces
    are not Douglas's (no scheme runs as another)."""
    fields, steps, remaps, kw = _inputs(cuda_device, torch.float64, arm, r_f)
    before = fused_do.fused_do_loop.launches
    got = fused_do.fused_do_loop(fields, steps, remaps, **kw, scheme=scheme)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.launches == before + 1
    want = fused_do.fused_do_reference(fields, steps, remaps, **kw,
                                       scheme=scheme)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)
    if scheme != "do":
        douglas, _ = fused_do.fused_do_loop(fields, steps, remaps, **kw)
        assert float((got[0] - douglas).abs().max()) > 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_kernel_f32_matches_plain_f32(cuda_device, arm, scheme):
    """float32 kernel against the float32 plain version on the same
    inputs: both run the same IEEE operation sequence (the kernel is
    built with -fmad=false), so they agree to a few ulps of the surface
    (values up to ~10^3: 1e-3 absolute is ~16 ulps there)."""
    fields, steps, remaps, kw = _inputs(cuda_device, torch.float32, arm)
    got, _ = fused_do.fused_do_loop(fields, steps, remaps, **kw,
                                    scheme=scheme, fmad=False)
    want, _ = fused_do.fused_do_reference(fields, steps, remaps, **kw,
                                          scheme=scheme)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("m1,m2", [(6, 9), (100, 75), (150, 140)])
def test_kernel_f64_matches_plain_other_grids(cuda_device, m1, m2):
    """Grid shapes off the main path: m1 < m2 (the b1 flat-index quirk
    wraps past column 0), the reference's 101 x 76 golden grid, and
    lines longer than the block (strided sweeps: 300 options take
    128-thread blocks, fused_do.launch_plan)."""
    spec = GridSpec(m1=m1, m2=m2)
    solver = SolverConfig(n_steps=4, solver_engine="pallas")
    n = 300 if m1 + 1 > fused_do.PRIMAL_THREADS else 5
    if n == 300:
        assert fused_do.launch_plan(n, m1 + 1, m2 + 1, 8, "do",
                                    True).threads < m1 + 1
    strikes = torch.linspace(80.0, 120.0, n, dtype=torch.float64,
                             device=cuda_device)
    fields, vec_s, _, _, _ = fused_do._assemble(
        spec, solver, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, 0.01)
    events = fused_do.dividend_plan(solver, GOLDEN_DIVIDENDS)
    remaps = fused_do._build_remap_fields(vec_s, events)
    kw = dict(theta=solver.theta, delta_t=solver.delta_t,
              n_steps=solver.n_steps, rf=0.01, american=True)
    steps = [e[0] for e in events]
    got, _ = fused_do.fused_do_loop(fields, steps, remaps, **kw)
    want, _ = fused_do.fused_do_reference(fields, steps, remaps, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-10)


def _tangent_inputs(device, dtype, arm, spec=SPEC, solver=SOLVER, n=37):
    strikes = torch.linspace(70.0, 130.0, n, dtype=dtype, device=device)
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0], dtype=dtype,
                         device=device)
    fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
        spec, solver, strikes, 100.0, theta, P.r_d, 0.0)
    events = fused_do.dividend_plan(solver, ARMS[arm]["dividends"])
    remaps = fused_do._build_remap_fields(vec_s, events)
    kw = dict(theta=solver.theta, delta_t=solver.delta_t,
              n_steps=solver.n_steps, rf=0.0,
              american=ARMS[arm]["american"], tangents=tangents)
    return fields, [e[0] for e in events], remaps, kw


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_tangent_kernel_f64_matches_plain(cuda_device, arm, scheme):
    """The forward-mode kernel in float64 against the plain forward-mode
    loop on the same inputs, under every scheme: the primal and the four
    tangent surfaces at 1e-10 on every grid point; one tangent launch, no
    primal launch."""
    fields, steps, remaps, kw = _tangent_inputs(cuda_device, torch.float64,
                                                arm)
    before = (fused_do.fused_do_loop.launches,
              fused_do.fused_do_loop.tangent_launches)
    got_u, _, got_du, _ = fused_do.fused_do_loop(
        fields, steps, remaps, **kw, scheme=scheme)
    torch.cuda.synchronize()
    assert (fused_do.fused_do_loop.launches,
            fused_do.fused_do_loop.tangent_launches) == (before[0],
                                                         before[1] + 1)
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        fields, steps, remaps, **kw, scheme=scheme)
    torch.testing.assert_close(got_u, want_u, rtol=0, atol=1e-10)
    assert len(got_du) == fused_do.JAC_TANGENTS
    for g, w in zip(got_du, want_du):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_tangent_kernel_f64_matches_plain_other_grid(cuda_device):
    """A grid off the main path whose lines outnumber the 256-thread
    block with all four tangents (G = 1: K*ns = 4*121 penta lines) and
    need dynamic shared memory past 48 KB in float64: American with the
    golden dividends."""
    spec = GridSpec(m1=120, m2=90)
    solver = SolverConfig(n_steps=3, solver_engine="pallas")
    fields, steps, remaps, kw = _tangent_inputs(
        cuda_device, torch.float64, "amer_div", spec=spec, solver=solver,
        n=5)
    got_u, _, got_du, _ = fused_do.fused_do_loop(fields, steps, remaps, **kw,
                                                 groups=1)
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        fields, steps, remaps, **kw)
    torch.testing.assert_close(got_u, want_u, rtol=0, atol=1e-10)
    for g, w in zip(got_du, want_du):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_tangent_kernel_f32_matches_plain_f32(cuda_device, arm):
    """float32 forward-mode kernel against the float32 plain version:
    the same IEEE operation sequence (-fmad=false), so a few ulps of the
    surfaces (tangent values up to ~10^3 here: 1e-3 is ~16 ulps)."""
    fields, steps, remaps, kw = _tangent_inputs(cuda_device, torch.float32,
                                                arm)
    got_u, _, got_du, _ = fused_do.fused_do_loop(
        fields, steps, remaps, **kw, fmad=False)
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        fields, steps, remaps, **kw)
    torch.testing.assert_close(got_u, want_u, rtol=0, atol=1e-3)
    for g, w in zip(got_du, want_du):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_calibrate_device_on_the_card_matches_cpu(cuda_device):
    """calibrate_device with its default device (the card) against the
    same call with device="cpu" (the plain versions), float64: one
    tangent and one primal launch per iteration."""
    from heston_tpu_torch import calibrate_device
    from heston_tpu_torch.models import bs

    spec = GridSpec(m1=12, m2=8)
    solver = SolverConfig(n_steps=6, solver_engine="pallas")
    ks = torch.linspace(85.0, 115.0, 8, dtype=torch.float64)
    market = bs.generate_market_data(100.0, 1.0, P.r_d, ks)
    init = torch.tensor([1.2, 0.05, 0.4, -0.5, 0.05], dtype=torch.float64)
    cfg = CalibrationConfig(max_iter=4, tol=1e-10, jacobian_mode="ad")
    args = (spec, solver, ks, market, 100.0, init, P.r_d, P.r_f)
    fused_do.fused_do_loop.launches = 0
    fused_do.fused_do_loop.tangent_launches = 0
    got, info = calibrate_device(*args, cfg=cfg, american=True)
    assert got.device.type == "cuda"
    assert fused_do.fused_do_loop.tangent_launches == info["iterations"]
    assert fused_do.fused_do_loop.launches == info["iterations"]
    want, _ = calibrate_device(*args, cfg=cfg, american=True, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=1e-9, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("american", [False, True])
def test_kernel_f64_carries_a_nonzero_lambda(cuda_device, american):
    """A nonzero input multiplier, a launch over local steps 3..8 at
    delta_t/2 (a later phase): the kernel converts lambda at the launch
    boundary as the plain version does (dt*lam in, lam/dt out), 1e-10 on
    surfaces and multipliers."""
    fields, steps, remaps, kw = _inputs(cuda_device, torch.float64,
                                        "amer_div" if american else "div")
    gen = torch.Generator(device="cpu").manual_seed(3)
    fields["lam"] = torch.rand(fields["u"].shape, generator=gen,
                               dtype=torch.float64).to(cuda_device)
    keep = [k for k, s in enumerate(steps) if s >= 3]
    kw.update(first_step=3, delta_t=SOLVER.delta_t / 2)
    args = (fields, [steps[k] for k in keep], [remaps[k] for k in keep])
    got_u, got_lam = fused_do.fused_do_loop(*args, **kw)
    want_u, want_lam = fused_do.fused_do_reference(*args, **kw)
    torch.testing.assert_close(got_u, want_u, rtol=0, atol=1e-10)
    torch.testing.assert_close(got_lam, want_lam, rtol=0, atol=1e-10)
    if not american:
        assert got_lam is fields["lam"]


# mixed-maturity books: 37 options at steps 1..8 (the golden dividends
# fall before steps 1..6 at N = 8)
LANE_ARMS = {"euro": (0, ARMS["euro"]), "amer_div": (0, ARMS["amer_div"]),
             "rann_amer_div": (2, ARMS["amer_div"])}


def _lane_nst(device, n=37):
    return torch.arange(n, device=device) % SOLVER.n_steps + 1


def _lane_plan(device, dtype, arm):
    """(fields, phases) of a mixed book as fused_price_batch launches it
    (fused_do.book_plan)."""
    rann, kw = LANE_ARMS[arm]
    solver = SolverConfig(n_steps=8, a2_variant="upwind",
                          solver_engine="pallas", rannacher_steps=rann)
    strikes = torch.linspace(70.0, 130.0, 37, dtype=dtype, device=device)
    fields, phases, _, _, _ = fused_do.book_plan(
        SPEC, solver, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, 0.01, n_steps_per=_lane_nst(device), **kw)
    return fields, phases


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_per_lane_kernel_f64_matches_plain(cuda_device, arm):
    """Per-lane step counts: each block stops at its own count; the
    float64 kernel against the plain version (which freezes lanes), u and
    lambda at 1e-10; one launch per phase."""
    fields, phases = _lane_plan(cuda_device, torch.float64, arm)
    before = fused_do.fused_do_loop.launches
    got = fused_do.run_phases(fused_do.fused_do_loop, fields, phases)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.launches == before + len(phases)
    want = fused_do.run_phases(fused_do.fused_do_reference, fields, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_per_lane_kernel_f32_matches_plain_f32(cuda_device, arm):
    """The same in float32: a few ulps of the surfaces (-fmad=false)."""
    fields, phases = _lane_plan(cuda_device, torch.float32, arm)
    got = fused_do.run_phases(
        functools.partial(fused_do.fused_do_loop, fmad=False), fields,
        phases)
    want = fused_do.run_phases(fused_do.fused_do_reference, fields, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-3)])
def test_per_lane_tangent_kernel_matches_plain(cuda_device, dtype, tol,
                                               scheme):
    """The forward-mode kernel on a mixed American book with the golden
    dividends, under every scheme: primal and tangent surfaces against
    the plain version."""
    nst = _lane_nst(cuda_device)
    strikes = torch.linspace(70.0, 130.0, 37, dtype=dtype, device=cuda_device)
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0], dtype=dtype,
                         device=cuda_device)
    fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
        SPEC, SOLVER, strikes, 100.0, theta, P.r_d, 0.0, nst)
    (steps, remaps, kw), = fused_do.book_phases(
        dataclasses.replace(SOLVER, scheme=scheme), GOLDEN_DIVIDENDS, vec_s,
        0.0, True, nst)
    before = fused_do.fused_do_loop.tangent_launches
    got_u, _, got_du, _ = fused_do.fused_do_loop(
        fields, steps, remaps, **kw, tangents=tangents, fmad=False)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.tangent_launches == before + 1
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        fields, steps, remaps, **kw, tangents=tangents)
    torch.testing.assert_close(got_u, want_u, rtol=0, atol=tol)
    for g, w in zip(got_du, want_du):
        torch.testing.assert_close(g, w, rtol=0, atol=tol)


@pytest.mark.cuda
def test_batch_greeks_on_the_card_matches_cpu(cuda_device):
    """batch_greeks on a mixed-maturity American book with its default
    device (the card) against device="cpu", float64: one primal launch,
    every column at 1e-10 * max(1, |x|)."""
    from heston_tpu_torch import RISK_KEYS, batch_greeks

    ks = torch.linspace(80.0, 120.0, 12, dtype=torch.float64)
    args = (SPEC, SOLVER, ks, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
            P.r_d, P.r_f)
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS,
              group_steps=((0, 4, 3), (4, 8, 8), (8, 12, 5)))
    fused_do.fused_do_loop.launches = 0
    got = batch_greeks(*args, **kw)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.launches == 1
    want = batch_greeks(*args, **kw, device="cpu")
    for k in RISK_KEYS:
        err = (got[k].cpu() - want[k]).abs() / want[k].abs().clamp(min=1.0)
        assert float(err.max()) <= 1e-10, k


SINGLE_ARMS = {**{arm: (0, kw) for arm, kw in ARMS.items()},
               "rann": (2, dict(american=False, dividends=None)),
               "rann_amer_div": (2, ARMS["amer_div"])}


def _single_phases(device, dtype, arm, spec=SPEC, strike=100.0, r_f=0.0,
                   scheme="do"):
    """(fields, phases) of one option's loop, as fused_price_single
    launches it."""
    rann, kw = SINGLE_ARMS[arm]
    solver = SolverConfig(n_steps=8, a2_variant="upwind",
                          solver_engine="pallas", rannacher_steps=rann,
                          scheme=scheme)
    sf, phases, _ = fused_single.single_plan(
        spec, solver, torch.tensor([strike], dtype=dtype, device=device),
        100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, r_f, **kw)
    return sf, phases


@pytest.mark.cuda
@pytest.mark.parametrize("r_f", [0.0, 0.01])
@pytest.mark.parametrize("arm", sorted(SINGLE_ARMS))
def test_single_kernel_f64_matches_plain(cuda_device, arm, r_f):
    """The single-option kernel in float64 against its plain version on
    the same inputs, phase by phase: surfaces and multipliers at 1e-10;
    one launch per phase."""
    sf, phases = _single_phases(cuda_device, torch.float64, arm, r_f=r_f)
    before = fused_single.fused_single_loop.launches
    got = fused_single.run_phases(fused_single.fused_single_loop, sf, phases)
    torch.cuda.synchronize()
    assert fused_single.fused_single_loop.launches == before + len(phases)
    want = fused_single.run_phases(fused_single.fused_single_reference, sf, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(SINGLE_ARMS))
def test_single_kernel_f32_matches_plain_f32(cuda_device, arm):
    """float32 single-option kernel against the float32 plain version:
    the same IEEE operation sequence (-fmad=false), so a few ulps of the
    surface (values up to ~10^3: 1e-3 absolute is ~16 ulps)."""
    sf, phases = _single_phases(cuda_device, torch.float32, arm)
    got = fused_single.run_phases(
        functools.partial(fused_single.fused_single_loop, fmad=False), sf,
        phases)
    want = fused_single.run_phases(fused_single.fused_single_reference, sf, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("m1,m2", [(6, 9), (100, 75), (120, 100)])
def test_single_kernel_f64_matches_plain_other_grids(cuda_device, m1, m2,
                                                     scheme):
    """Grid shapes off the main path, under every scheme (a Douglas damp
    launch, then the scheme's): m1 < m2, the golden 101 x 76 grid (shared
    memory past 48 KB), and the largest grid class the routing rule
    admits in float64 (~210 KB of shared memory)."""
    sf, phases = _single_phases(cuda_device, torch.float64, "rann_amer_div",
                                spec=GridSpec(m1=m1, m2=m2), r_f=0.01,
                                scheme=scheme)
    assert [ph[2]["scheme"] for ph in phases] == ["do", scheme]
    got = fused_single.run_phases(fused_single.fused_single_loop, sf, phases)
    want = fused_single.run_phases(fused_single.fused_single_reference, sf, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
def test_price_batch_of_one_on_the_card(cuda_device, scheme):
    """price_batch with one strike on the card, under every scheme: one
    launch of the single kernel per phase, none of the batched one;
    float64 equal to the same call on the CPU (the plain versions)."""
    from heston_tpu_torch import price_batch

    spec = GridSpec(m1=50, m2=25)
    solver = SolverConfig(n_steps=20, theta=0.8, a2_variant="upwind",
                          solver_engine="pallas", rannacher_steps=2,
                          scheme=scheme)
    args = (spec, solver, torch.tensor([95.0], dtype=torch.float64), 100.0,
            P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    fused_do.fused_do_loop.launches = 0
    fused_single.fused_single_loop.launches = 0
    got = price_batch(*args, **kw)
    torch.cuda.synchronize()
    assert got.device.type == "cuda"
    assert (fused_single.fused_single_loop.launches,
            fused_do.fused_do_loop.launches) == (2, 0)
    want = price_batch(*args, **kw, device="cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)



# kernel 2 under forced launch plans (fused_single.launch_plan): clusters
# of 1, 2 and 8 blocks, with the PCR factors in shared memory (as far as
# they fit) or all in global scratch
SINGLE_PLANS = [(c, f) for c in (1, 2, 8) for f in (True, False)]


@functools.cache
def _forced_plan_case(dtype, arm, m1, m2, scheme):
    """(fields, phases, knocked, plain result) of one option on the card:
    American calls with the golden dividends (rann_amer_div) or an
    American cash-or-nothing digital call knocked out at 80 and 150, 8
    steps, Rannacher start-up (a Douglas damp launch, then the scheme's);
    the plain version's result computed once per case."""
    spec = GridSpec(m1=m1, m2=m2)
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    option_type = "call"
    if arm == "double_out_digital":
        spec = dataclasses.replace(spec, barrier=Barrier(
            "double-out", 80.0, level_hi=150.0))
        kw, option_type = dict(american=True), "digital_call"
    solver = SolverConfig(n_steps=8, a2_variant="upwind",
                          solver_engine="pallas", rannacher_steps=2,
                          scheme=scheme)
    sf, phases, _ = fused_single.single_plan(
        spec, solver, torch.tensor([100.0], dtype=dtype, device="cuda"),
        100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, 0.01,
        option_type=option_type, **kw)
    want = fused_single.run_phases(fused_single.fused_single_reference, sf,
                                   phases)
    return sf, phases, fused_do.barrier_positions(spec), want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-3)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("cluster,factors", SINGLE_PLANS,
                         ids=[f"C{c}-{'smem' if f else 'global'}"
                              for c, f in SINGLE_PLANS])
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("arm", ["rann_amer_div", "double_out_digital"])
@pytest.mark.parametrize("m1,m2", [(6, 9), (100, 75), (120, 100)])
def test_single_kernel_forced_plans_match_plain(cuda_device, m1, m2, arm,
                                                scheme, cluster, factors,
                                                dtype, tol):
    """The single-option kernel under forced plans (a cluster of 1, 2 or
    8 blocks; the PCR factors in shared memory or global scratch), every
    scheme, the Rannacher American-dividend arm and a double-out American
    digital, at m1 < m2, the golden grid and the largest grid class the
    routing admits: against its plain version phase by phase, f64 at
    1e-10, f32 on the -fmad=false build at the f32 single-kernel
    tolerance; one launch per phase; the knocked columns exactly 0."""
    sf, phases, knocked, want = _forced_plan_case(dtype, arm, m1, m2,
                                                  scheme)

    loop = functools.partial(fused_single.fused_single_loop,
                             cluster=cluster, factors=factors, fmad=False)
    before = fused_single.fused_single_loop.launches
    got = fused_single.run_phases(loop, sf, phases)
    torch.cuda.synchronize()
    assert fused_single.fused_single_loop.launches == before + len(phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
    _assert_knocked_zero(got[0], knocked, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("arm", ["rann_amer_div", "double_out_digital"])
@pytest.mark.parametrize("m1,m2", [(6, 9), (100, 75), (120, 100)])
def test_single_kernel_plans_agree_bitwise(cuda_device, m1, m2, arm, scheme,
                                           dtype):
    """The placement changes no bit: on the -fmad=false build, the
    default plan (at the golden grid a cluster of 16 blocks where the
    card schedules one, else 8) and every forced plan of SINGLE_PLANS
    (clusters of 1, 2 and 8 blocks, the PCR factors in shared memory or
    global scratch) give the same u and lambda, torch.equal, for every
    scheme, the Rannacher American-dividend arm and the double-out
    American digital (values <= 1, where a tolerance set for call
    surfaces would hide thousands of ulps)."""
    sf, phases, _, _ = _forced_plan_case(dtype, arm, m1, m2, scheme)

    def run(**forced):
        out = fused_single.run_phases(functools.partial(
            fused_single.fused_single_loop, fmad=False, **forced), sf, phases)
        torch.cuda.synchronize()
        return out

    want = run()
    for cluster, factors in SINGLE_PLANS:
        got = run(cluster=cluster, factors=factors)
        for name, g, w in zip(("u", "lam"), got, want):
            assert torch.equal(g, w), (
                f"C{cluster} {'smem' if factors else 'global'} factors: "
                f"{name} differs from the default plan's by "
                f"{float((g - w).abs().max())}")


# puts, cash-or-nothing digitals and knock-out barriers: name -> (option
# type, barrier); S0 = 100 lies inside every barrier's alive domain
PAYOFFS = {
    "put": ("put", None),
    "digital_call": ("digital_call", None),
    "digital_put": ("digital_put", None),
    "up_out_call": ("call", Barrier("up-out", 150.0)),
    "down_out_put": ("put", Barrier("down-out", 80.0)),
    "double_out_digital_call": ("digital_call",
                                Barrier("double-out", 80.0, level_hi=150.0)),
}


def _payoff_plan(device, dtype, payoff, arm, scheme="do", n=37):
    """(fields, phases, knocked) of a book of the payoff as
    fused_price_batch launches it (fused_do.book_plan)."""
    option_type, barrier = PAYOFFS[payoff]
    spec = dataclasses.replace(SPEC, barrier=barrier)
    strikes = torch.linspace(85.0, 120.0, n, dtype=dtype, device=device)
    fields, phases, _, _, _ = fused_do.book_plan(
        spec, dataclasses.replace(SOLVER, scheme=scheme), strikes, 100.0,
        P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, 0.01,
        option_type=option_type, **ARMS[arm])
    return fields, phases, fused_do.barrier_positions(spec)


def _assert_knocked_zero(u, knocked, s_axis):
    for c in knocked:
        col = u.select(s_axis, c)
        assert bool((col == 0.0).all()), f"knocked column {c} not zero"


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("payoff", sorted(PAYOFFS))
def test_payoff_kernel_f64_matches_plain(cuda_device, payoff, arm):
    """The batched kernel on puts, digitals and barrier books in float64
    against its plain version on the same inputs: u and lambda at 1e-10,
    one launch; the knocked columns of the kernel's surface exactly 0."""
    fields, phases, knocked = _payoff_plan(cuda_device, torch.float64,
                                           payoff, arm)
    before = fused_do.fused_do_loop.launches
    got = fused_do.run_phases(fused_do.fused_do_loop, fields, phases)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.launches == before + 1
    want = fused_do.run_phases(fused_do.fused_do_reference, fields, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)
    _assert_knocked_zero(got[0], knocked, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ("cs", "mcs", "hv"))
@pytest.mark.parametrize("payoff", sorted(PAYOFFS))
def test_payoff_scheme_kernel_f64_matches_plain(cuda_device, payoff, scheme):
    """The same under the corrector schemes, American with dividends."""
    fields, phases, knocked = _payoff_plan(cuda_device, torch.float64,
                                           payoff, "amer_div", scheme)
    got = fused_do.run_phases(fused_do.fused_do_loop, fields, phases)
    want = fused_do.run_phases(fused_do.fused_do_reference, fields, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)
    _assert_knocked_zero(got[0], knocked, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("payoff", sorted(PAYOFFS))
def test_payoff_kernel_f32_matches_plain_f32(cuda_device, payoff, arm):
    """float32 on the -fmad=false build against the float32 plain version:
    the same IEEE operation sequence, so the surfaces are bitwise equal
    (the multiplier is handed back through lambda/dt, which PyTorch's CUDA
    division by a Python scalar takes as a reciprocal product: a few
    ulps, ROADMAP C8)."""
    fields, phases, knocked = _payoff_plan(cuda_device, torch.float32,
                                           payoff, arm)
    got = fused_do.run_phases(
        functools.partial(fused_do.fused_do_loop, fmad=False), fields,
        phases)
    want = fused_do.run_phases(fused_do.fused_do_reference, fields, phases)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(got[1], want[1], rtol=0, atol=1e-3)
    _assert_knocked_zero(got[0], knocked, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-3)])
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("payoff", ["put", "digital_call", "up_out_call"])
def test_payoff_tangent_kernel_matches_plain(cuda_device, payoff, arm, dtype,
                                             tol):
    """Forward mode on put, digital (the American projection's JVP) and
    up-out books: the primal and the four tangent surfaces against the
    plain forward-mode loop; one tangent launch; knocked columns of every
    surface exactly 0."""
    option_type, barrier = PAYOFFS[payoff]
    spec = dataclasses.replace(SPEC, barrier=barrier)
    strikes = torch.linspace(85.0, 120.0, 37, dtype=dtype, device=cuda_device)
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0], dtype=dtype,
                         device=cuda_device)
    fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
        spec, SOLVER, strikes, 100.0, theta, P.r_d, 0.0,
        option_type=option_type)
    knocked = fused_do.barrier_positions(spec)
    (steps, remaps, kw), = fused_do.book_phases(
        SOLVER, ARMS[arm]["dividends"], vec_s,
        fused_do.operators.boundary_rate(P.r_d, 0.0, option_type),
        ARMS[arm]["american"], option_type=option_type, knocked=knocked)
    before = fused_do.fused_do_loop.tangent_launches
    got_u, _, got_du, _ = fused_do.fused_do_loop(
        fields, steps, remaps, **kw, tangents=tangents, fmad=False)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.tangent_launches == before + 1
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        fields, steps, remaps, **kw, tangents=tangents)
    for g, w in zip([got_u, *got_du], [want_u, *want_du]):
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
        _assert_knocked_zero(g, knocked, 1)


def _payoff_single(device, dtype, payoff, arm, rann=0, strike=100.0):
    option_type, barrier = PAYOFFS[payoff]
    solver = dataclasses.replace(SOLVER, rannacher_steps=rann)
    sf, phases, _ = fused_single.single_plan(
        dataclasses.replace(SPEC, barrier=barrier), solver,
        torch.tensor([strike], dtype=dtype, device=device), 100.0, P.kappa,
        P.eta, P.sigma, P.rho, P.v0, P.r_d, 0.01, option_type=option_type,
        **ARMS[arm])
    return sf, phases, fused_do.barrier_positions(
        dataclasses.replace(SPEC, barrier=barrier))


@pytest.mark.cuda
@pytest.mark.parametrize("rann", [0, 2])
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("payoff", sorted(PAYOFFS))
def test_payoff_single_kernel_f64_matches_plain(cuda_device, payoff, arm,
                                                rann):
    """The single-option kernel on every payoff, with and without the
    Rannacher start-up, float64 against its plain version phase by phase:
    surfaces and multipliers at 1e-10, one launch per phase; the knocked
    columns exactly 0 (kernel 2's surfaces are [nv, ns])."""
    sf, phases, knocked = _payoff_single(cuda_device, torch.float64, payoff,
                                         arm, rann)
    before = fused_single.fused_single_loop.launches
    got = fused_single.run_phases(fused_single.fused_single_loop, sf, phases)
    torch.cuda.synchronize()
    assert fused_single.fused_single_loop.launches == before + len(phases)
    want = fused_single.run_phases(fused_single.fused_single_reference, sf,
                                   phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)
    _assert_knocked_zero(got[0], knocked, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(ARMS))
@pytest.mark.parametrize("payoff", sorted(PAYOFFS))
def test_payoff_single_kernel_f32_matches_plain_f32(cuda_device, payoff,
                                                    arm):
    """float32 single-option kernel (-fmad=false) against its float32
    plain version: a few ulps of the surface (American: lambda/dt through
    PyTorch's reciprocal, C8)."""
    sf, phases, knocked = _payoff_single(cuda_device, torch.float32, payoff,
                                         arm)
    got = fused_single.run_phases(
        functools.partial(fused_single.fused_single_loop, fmad=False), sf,
        phases)
    want = fused_single.run_phases(fused_single.fused_single_reference, sf,
                                   phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3)
    _assert_knocked_zero(got[0], knocked, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("payoff", sorted(PAYOFFS))
def test_payoff_price_batch_on_the_card_matches_cpu(cuda_device, payoff):
    """price_batch on both routes (a book, a batch of one) and batch_greeks
    on the card against the same calls with device="cpu", float64, American
    with the golden dividends: prices at 1e-10, risk columns at
    1e-10 * max(1, |x|) (an American digital book reads its active set)."""
    from heston_tpu_torch import RISK_KEYS, batch_greeks, price_batch

    option_type, barrier = PAYOFFS[payoff]
    spec = dataclasses.replace(SPEC, barrier=barrier)
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS,
              option_type=option_type)
    for ks in (torch.linspace(85.0, 120.0, 9, dtype=torch.float64),
               torch.tensor([100.0], dtype=torch.float64)):
        args = (spec, SOLVER, ks, 100.0, P.kappa, P.eta, P.sigma, P.rho,
                P.v0, P.r_d, 0.01)
        got = price_batch(*args, **kw)
        want = price_batch(*args, **kw, device="cpu")
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-10)
    got = batch_greeks(*args[:2], torch.linspace(85.0, 120.0, 9,
                                                 dtype=torch.float64),
                       *args[3:], **kw)
    want = batch_greeks(*args[:2], torch.linspace(85.0, 120.0, 9,
                                                  dtype=torch.float64),
                        *args[3:], **kw, device="cpu")
    for k in RISK_KEYS:
        err = (got[k].cpu() - want[k]).abs() / want[k].abs().clamp(min=1.0)
        assert float(err.max()) <= 1e-10, k


@pytest.mark.cuda
def test_hv_euro_f32_gate(cuda_device):
    """The bench's hv euro arm (64 strikes in [75, 125], 50 x 25 x 20, HV,
    European calls): the float32 main path's prices (the -fmad=true build)
    against the float64 kernel, RMSE within the bench's 2e-5, the gate the
    FMA-build measurement chose (ROADMAP C9)."""
    from heston_tpu_torch import price_batch

    spec = GridSpec(m1=50, m2=25)
    solver = SolverConfig(n_steps=20, theta=0.8, a2_variant="upwind",
                          solver_engine="pallas", scheme="hv")
    ks = torch.linspace(75.0, 125.0, 64, dtype=torch.float64,
                        device=cuda_device)
    args = (100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    got = price_batch(spec, solver, ks.float(), *args)
    want = price_batch(spec, solver, ks, *args)
    err = float(torch.sqrt(torch.mean((got.double() - want) ** 2)))
    assert err <= 2e-5, err


# ---------------------------------------------------------------------------
# rate curves, the tangent state across launches, five tangents
# ---------------------------------------------------------------------------

CURVE = RateSchedule(times=(1.0 / 3.0, 2.0 / 3.0), r_d=(0.02, 0.035, 0.025),
                     r_f=(0.0, 0.01, 0.004))


def _launch_states(loop, fields, phases, tangents=None):
    """The state after each launch of a plan: (u, lam) or, with
    tangents, (u, lam, dus, dlams)."""
    out, state = [], {}
    for steps, remaps, kw in phases:
        tkw = {} if tangents is None else dict(tangents=tangents)
        got = loop({**fields, **state}, steps, remaps, **kw, **tkw)
        state = dict(zip(("u", "lam", "du", "dlam"), got))
        out.append(got)
    return out


def _assert_states_close(got, want, american, tol):
    for g, w in zip(got, want):
        torch.testing.assert_close(g[0], w[0], rtol=0, atol=tol)
        if american:
            torch.testing.assert_close(g[1], w[1], rtol=0, atol=tol)
        if len(g) == 4:
            for x, y in zip(g[2], w[2]):
                torch.testing.assert_close(x, y, rtol=0, atol=tol)
            if american:
                for x, y in zip(g[3], w[3]):
                    torch.testing.assert_close(x, y, rtol=0, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("option_type", ["call", "put"])
@pytest.mark.parametrize("rann", [0, 4])
def test_curve_pieces_f64_match_plain(cuda_device, rann, option_type,
                                      scheme):
    """A curve book (three rate segments: main steps 1-3, 4-5, 6-8)
    American with the golden dividends: the kernel against the plain
    version on u and lambda after every launch of the phase x segment
    plan, each chain from its own state, under every scheme (the damp
    phase is Douglas); one launch per piece. R = 4 cuts the damp phase
    too (main steps 1-3 | 4)."""
    solver = dataclasses.replace(SOLVER, rannacher_steps=rann, scheme=scheme)
    strikes = torch.linspace(70.0, 130.0, 37, dtype=torch.float64,
                             device=cuda_device)
    fields, phases, _, _, _ = fused_do.book_plan(
        SPEC, solver, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, P.r_f, american=True, dividends=GOLDEN_DIVIDENDS,
        option_type=option_type, rate_schedule=CURVE)
    assert len(phases) == (4 if rann else 3)
    before = fused_do.fused_do_loop.launches
    got = _launch_states(fused_do.fused_do_loop, fields, phases)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.launches == before + len(phases)
    want = _launch_states(fused_do.fused_do_reference, fields, phases)
    _assert_states_close(got, want, True, 1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("arm", ["euro", "amer_div"])
def test_tangent_kernel_resumes_from_a_state(cuda_device, arm, scheme):
    """The forward-mode kernel from a nonzero state (u, lambda and the
    tangents du_k, dlam_k a damp launch hands on): local steps 3..8 at
    delta_t / 2, float64, every part of the state against the plain
    version at 1e-10."""
    fields, steps, remaps, kw = _tangent_inputs(cuda_device, torch.float64,
                                                arm)
    gen = torch.Generator(device="cpu").manual_seed(5)
    shape = fields["u"].shape

    def rand():
        return torch.rand(shape, generator=gen, dtype=torch.float64).to(
            cuda_device)

    k = len(kw["tangents"])
    fields = dict(fields, lam=rand(), du=[rand() for _ in range(k)],
                  dlam=[rand() for _ in range(k)])
    keep = [i for i, s in enumerate(steps) if s >= 3]
    args = (fields, [steps[i] for i in keep], [remaps[i] for i in keep])
    kw.update(first_step=3, delta_t=SOLVER.delta_t / 2, scheme=scheme)
    got = fused_do.fused_do_loop(*args, **kw)
    want = fused_do.fused_do_reference(*args, **kw)
    _assert_states_close([got], [want], kw["american"], 1e-10)
    assert float((got[2][0] - fields["du"][0]).abs().max()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("arm", ["euro", "amer_div"])
def test_damped_tangent_kernel_f64_matches_plain(cuda_device, arm, scheme):
    """The damped Jacobian's launches (Rannacher R = 2: the Douglas damp
    launch at delta_t / 2, then the scheme's main launch from its state):
    the full state after each launch against the plain version at 1e-10;
    fused_theta_jacobian on the card equal to its CPU run at 1e-10."""
    solver = dataclasses.replace(SOLVER, rannacher_steps=2, scheme=scheme)
    strikes = torch.linspace(70.0, 130.0, 37, dtype=torch.float64,
                             device=cuda_device)
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0],
                         dtype=torch.float64, device=cuda_device)
    fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
        SPEC, solver, strikes, 100.0, theta, P.r_d, P.r_f)
    phases = fused_do.book_phases(solver, ARMS[arm]["dividends"], vec_s,
                                  P.r_f, ARMS[arm]["american"])
    before = fused_do.fused_do_loop.tangent_launches
    got = _launch_states(fused_do.fused_do_loop, fields, phases, tangents)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.tangent_launches == before + 2
    want = _launch_states(fused_do.fused_do_reference, fields, phases,
                          tangents)
    _assert_states_close(got, want, ARMS[arm]["american"], 1e-10)
    args = (SPEC, solver, strikes, 100.0, theta, P.r_d, P.r_f)
    for g, w in zip(fused_do.fused_theta_jacobian(*args, **ARMS[arm]),
                    fused_do.fused_theta_jacobian(
                        *(x.cpu() if torch.is_tensor(x) else x
                          for x in args), **ARMS[arm])):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", fused_do.SCHEMES)
@pytest.mark.parametrize("arm", ["euro", "amer_div"])
def test_k5_tangent_kernel_f64_matches_plain(cuda_device, arm, scheme):
    """v0_mode "ad": the forward-mode kernel with five tangents (the v0
    one the v-grid's motion), float64, the whole state against the plain
    version at 1e-10."""
    solver = dataclasses.replace(SOLVER, scheme=scheme)
    strikes = torch.linspace(70.0, 130.0, 37, dtype=torch.float64,
                             device=cuda_device)
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0],
                         dtype=torch.float64, device=cuda_device)
    fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
        SPEC, solver, strikes, 100.0, theta, P.r_d, P.r_f, v0_mode="ad")
    assert len(tangents) == 5
    phases = fused_do.book_phases(solver, ARMS[arm]["dividends"], vec_s,
                                  P.r_f, ARMS[arm]["american"])
    got = _launch_states(fused_do.fused_do_loop, fields, phases, tangents)
    want = _launch_states(fused_do.fused_do_reference, fields, phases,
                          tangents)
    _assert_states_close(got, want, ARMS[arm]["american"], 1e-10)


# ---------------------------------------------------------------------------
# the launch plan (fused_do.launch_plan): every placement of the working
# fields (all in shared memory, the first three, none) through the private
# smem_budget, and the forward mode's tangent groups G = 1 and G = K
# ---------------------------------------------------------------------------

PLACEMENTS = ("all_smem", "partial", "all_global")


def _placed(placement, groups=None, fmad=None):
    """fused_do_loop with the working fields placed as `placement` says
    (the budget that leaves exactly that many fields in shared memory,
    checked against the plan) and `groups` tangent groups."""
    def loop(fields, steps, remaps, **kw):
        u = fields["u"]
        b, ns, nv = u.shape
        k = len(kw.get("tangents") or ())
        scheme = kw.get("scheme", "do")
        args = (b, ns, nv, u.element_size(), scheme, kw["american"], k)
        budget = {"all_smem": fused_do.SMEM_PER_BLOCK, "all_global": 0,
                  "partial": fused_do.launch_plan(
                      *args, smem_budget=0, groups=groups).smem_bytes
                  + 3 * fused_do.surface_elems(ns, nv) * u.element_size()
                  }[placement]
        plan = fused_do.launch_plan(*args, smem_budget=budget, groups=groups)
        kg = k // plan.groups if k else 0
        every = tuple(fused_do.field_counts(scheme, kw["american"], kg))
        assert plan.smem_fields == {"all_smem": every, "partial": every[:3],
                                    "all_global": ()}[placement]
        return fused_do.fused_do_loop(fields, steps, remaps, **kw,
                                      smem_budget=budget, groups=groups,
                                      fmad=fmad)
    return loop


def _assert_f32_states(got, want):
    """float32 on the -fmad=false build: u bitwise equal to the plain
    version, the multipliers and tangents within 1e-3 (values up to
    ~10^3; the multipliers come back through lambda/dt, ROADMAP C8)."""
    for g, w in zip(got, want):
        assert torch.equal(g[0], w[0])
        rest = zip([g[1], *g[2], *g[3]] if len(g) == 4 else [g[1]],
                   [w[1], *w[2], *w[3]] if len(w) == 4 else [w[1]])
        for x, y in rest:
            torch.testing.assert_close(x, y, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("payoff", ["call", "put"])
@pytest.mark.parametrize("scheme", ["do", "cs"])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_placement_kernel_matches_plain(cuda_device, placement, scheme,
                                        payoff, dtype):
    """A book of American options with the golden dividends (calls fold
    the compensation at a dividend, puts remap it apart) under Douglas and
    Craig-Sneyd, the fields in each placement: float64 u and lambda at
    1e-10, float32 u bitwise (-fmad=false). 37 options (Douglas on
    256-thread blocks) and, for Douglas calls, 300 (128-thread blocks)."""
    for n in (37, 300) if (scheme, payoff) == ("do", "call") else (37,):
        fields, phases, _, _, _ = fused_do.book_plan(
            SPEC, dataclasses.replace(SOLVER, scheme=scheme),
            torch.linspace(85.0, 120.0, n, dtype=dtype, device=cuda_device),
            100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, 0.01,
            option_type=payoff, **ARMS["amer_div"])
        loop = _placed(placement,
                       fmad=False if dtype == torch.float32 else None)
        got = _launch_states(loop, fields, phases)
        want = _launch_states(fused_do.fused_do_reference, fields, phases)
        if dtype == torch.float64:
            _assert_states_close(got, want, True, 1e-10)
        else:
            _assert_f32_states(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("payoff", ["call", "put"])
@pytest.mark.parametrize("scheme", ["do", "cs"])
@pytest.mark.parametrize("groups", ["1", "K"])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_placement_tangent_kernel_matches_plain(cuda_device, placement,
                                                groups, scheme, payoff,
                                                dtype):
    """The damped Jacobian's launches (Rannacher R = 2, the tangent state
    handed from the damp launch to the main one) of an American book with
    the golden dividends, every placement, G = 1 (all four tangents in
    each option's block) and G = K (a block per tangent, each recomputing
    the primal): the whole state after each launch against the plain
    version, float64 at 1e-10, float32 u bitwise."""
    option_type = payoff
    solver = dataclasses.replace(SOLVER, rannacher_steps=2, scheme=scheme)
    strikes = torch.linspace(85.0, 120.0, 37, dtype=dtype,
                             device=cuda_device)
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0], dtype=dtype,
                         device=cuda_device)
    fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
        SPEC, solver, strikes, 100.0, theta, P.r_d, P.r_f,
        option_type=option_type)
    phases = fused_do.book_phases(
        solver, GOLDEN_DIVIDENDS, vec_s,
        fused_do.operators.boundary_rate(P.r_d, P.r_f, option_type), True,
        option_type=option_type)
    loop = _placed(placement, len(tangents) if groups == "K" else 1,
                   fmad=False if dtype == torch.float32 else None)
    before = fused_do.fused_do_loop.tangent_launches
    got = _launch_states(loop, fields, phases, tangents)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.tangent_launches == before + 2
    want = _launch_states(fused_do.fused_do_reference, fields, phases,
                          tangents)
    if dtype == torch.float64:
        _assert_states_close(got, want, True, 1e-10)
    else:
        _assert_f32_states(got, want)


@pytest.mark.cuda
def test_golden_grid_tangent_kernel_f64_matches_plain(cuda_device):
    """The reference's golden grid (100 x 75) in float64 forward mode with
    four tangents, American with the golden dividends: the working set
    (~0.9 MB an option) cannot sit in shared memory, so the default plan
    keeps most fields in global scratch, and the launch still equals the
    plain version at 1e-10."""
    spec = GridSpec(m1=100, m2=75)
    solver = SolverConfig(n_steps=3, solver_engine="pallas")
    fields, steps, remaps, kw = _tangent_inputs(
        cuda_device, torch.float64, "amer_div", spec=spec, solver=solver,
        n=3)
    plan = fused_do.launch_plan(3, 101, 76, 8, "do", True, 4)
    assert 0 < len(plan.smem_fields) < len(
        fused_do.field_counts("do", True, 4 // plan.groups))
    got_u, got_lam, got_du, got_dlam = fused_do.fused_do_loop(
        fields, steps, remaps, **kw)
    want_u, want_lam, want_du, want_dlam = fused_do.fused_do_reference(
        fields, steps, remaps, **kw)
    for g, w in zip([got_u, got_lam, *got_du, *got_dlam],
                    [want_u, want_lam, *want_du, *want_dlam]):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


# ---------------------------------------------------------------------------
# the eager ADI loop and the host calibration loop on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["scan", "pcr"])
@pytest.mark.parametrize("case", ["amer_div_hv_rann", "put_curve"])
def test_eager_engine_on_the_card_matches_the_cpu(cuda_device, engine, case):
    """The eager loop (no kernel of its own) runs on the card as on the
    CPU: float64 prices at 1e-12 and their linearized Jacobian at 1e-12
    relative (its columns reach ~50; CUDA's exp and division round apart
    from the CPU's), and no launch of either kernel."""
    from heston_tpu_torch.models import calibration, douglas

    solver = dataclasses.replace(SOLVER, solver_engine=engine)
    kw = dict(ARMS["amer_div"])
    if case == "amer_div_hv_rann":
        solver = dataclasses.replace(solver, scheme="hv", rannacher_steps=2)
    else:
        kw = dict(option_type="put", american=True,
                  rate_schedule=RateSchedule(times=(0.5,), r_d=(0.02, 0.03),
                                             r_f=(0.0, 0.01)))
    ks = torch.linspace(80.0, 120.0, 9, dtype=torch.float64)
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0],
                         dtype=torch.float64)
    before = (fused_do.fused_do_loop.launches,
              fused_do.fused_do_loop.tangent_launches,
              fused_single.fused_single_loop.launches)
    out = {}
    for dev in ("cpu", "cuda"):
        price = douglas.price_option(SPEC, solver, ks, 100.0, P.kappa, P.eta,
                                     P.sigma, P.rho, P.v0, P.r_d, P.r_f,
                                     device=dev, **kw)
        jac, base = calibration.jacobian_and_prices_ad(
            SPEC, solver, ks, 100.0, theta, P.r_d, P.r_f, device=dev, **kw)
        out[dev] = (price, jac, base)
    for c, g, rtol in zip(out["cpu"], out["cuda"], (0, 1e-12, 0)):
        assert g.device.type == "cuda"
        torch.testing.assert_close(g.cpu(), c, rtol=rtol, atol=1e-12)
    assert before == (fused_do.fused_do_loop.launches,
                      fused_do.fused_do_loop.tangent_launches,
                      fused_single.fused_single_loop.launches)


@pytest.mark.cuda
def test_calibrate_on_the_card_matches_the_cpu(cuda_device):
    """The host LM loop on a small chain, float64: the forward-mode kernel
    once per maturity group and pass, the trial prices on the eager loop;
    the same history and parameters (1e-10) as the CPU run of the plain
    versions."""
    import numpy as np

    from heston_tpu_torch.models import bs, calibration

    ks = np.tile(np.linspace(85.0, 115.0, 6), 2)
    ts = np.repeat([0.5, 1.0], 6)
    prices = np.concatenate([bs.generate_market_data(
        100.0, t, P.r_d, torch.as_tensor(ks[:6])).numpy() for t in (0.5, 1.0)])
    targets = calibration.CalibrationTargets(
        strikes=ks, maturities=ts, prices=prices, s0=100.0, r_d=P.r_d,
        american=True)
    init = HestonParams(kappa=1.0, eta=0.05, sigma=0.4, rho=-0.5, v0=0.05)
    cfg = CalibrationConfig(max_iter=4, tol=1e-10, jacobian_mode="ad")
    res = {}
    for dev in ("cpu", "cuda"):
        n0 = fused_do.fused_do_loop.tangent_launches
        res[dev] = calibration.calibrate(targets, SPEC, SOLVER, init, cfg,
                                         device=dev)
        launches = fused_do.fused_do_loop.tangent_launches - n0
        assert launches == (2 * res[dev].iterations if dev == "cuda" else 0)
    assert res["cuda"].iterations == res["cpu"].iterations
    assert ([h["accepted"] for h in res["cuda"].history]
            == [h["accepted"] for h in res["cpu"].history])
    np.testing.assert_allclose(res["cuda"].params.bumpable(),
                               res["cpu"].params.bumpable(), rtol=0,
                               atol=1e-10)
    assert res["cuda"].final_error < res["cuda"].history[0]["sse"]

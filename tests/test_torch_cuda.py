"""The CUDA time-loop kernels against their plain PyTorch versions, on the
card: the batched kernel (primal and forward mode, uniform and
mixed-maturity books, rate-curve pieces, the tangent state handed from a
damp launch on, five tangents) and the single-option latency kernel
with the plan kernel that builds its inputs (bitwise the host plan),
under every scheme (Douglas, Craig-Sneyd, modified Craig-Sneyd,
Hundsdorfer-Verwer) and payoff (calls, puts, cash-or-nothing digitals,
knock-out barriers).

Imports no JAX (the machine with the card has none), so it runs there
without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Without a card every test skips (the skip is decided inside the fixture).
A build or a launch plan is forced only at each kernel's one launch,
`_launch_packed(..., fmad=, plan=)`, on the loop's own packing (`_do_loop`,
`_single_loop`): kernel 1's plan (fused_do.launch_plan) where a test holds
every placement of the working fields and both tangent groupings against
the plain version, kernel 2's (fused_single.launch_plan): clusters of 1, 2
and 8 blocks, the PCR factors in shared or global memory.
The float32 kernel-against-plain tests name the -fmad=false builds
(`fmad=False`), whose arithmetic is the plain version's operation for
operation; the float32 main path takes the -fmad=true build
(cuda_build.use_fmad, ROADMAP C9).
"""

import dataclasses
import functools

import pytest
import torch

from heston_tpu_torch.config import (GOLDEN_DIVIDENDS, Barrier,
                                     CalibrationConfig, DividendSchedule,
                                     GridSpec, HestonParams, RateSchedule,
                                     SolverConfig)
from heston_tpu_torch.kernels import (assembly, cuda_build, fused_do,
                                      fused_single)

P = HestonParams()
SPEC = GridSpec(m1=20, m2=12)
SOLVER = SolverConfig(n_steps=8, a2_variant="upwind", solver_engine="pallas")
ARMS = {
    "euro": dict(american=False, dividends=None),
    "amer": dict(american=True, dividends=None),
    "div": dict(american=False, dividends=GOLDEN_DIVIDENDS),
    "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS),
}


def _do_loop(fmad=None, **forced):
    """fused_do_loop's interface on the card with the build `fmad` and,
    given `forced` (launch_plan's smem_budget and groups), that launch plan
    for this card forced at kernel 1's one launch: the fields packed as the
    loop packs them, then `_launch_packed`."""
    def loop(fields, steps, remaps, *, tangents=None, nst=None,
             segment=None, **kw):
        fields = fields if segment is None else {**fields, **segment}
        u = fields["u"]
        plan = fused_do.launch_plan(
            *u.shape, u.element_size(), kw.get("scheme", "do"),
            kw["american"], len(tangents or ()),
            n_sm=fused_do._sm_count(torch.cuda.current_device()),
            **forced) if forced else None
        got = fused_do._launch_packed(
            *fused_do._pack(fields, steps, remaps, nst), **kw, fmad=fmad,
            plan=plan, tangent=None if tangents is None
            else fused_do._pack_tangents(fields, tangents, kw["american"]))
        if tangents is None:
            return got
        u, lam, du, dlam = got
        return (u, lam, list(du.unbind(1)),
                None if dlam is None else list(dlam.unbind(1)))
    return loop


def _single_loop(fmad=None, **forced):
    """fused_single_loop's interface on the card with the build `fmad`
    and, given `forced` (launch_plan's cluster and factors), that launch
    plan forced at kernel 2's one launch: the fields packed as the loop
    packs them, then `_launch_packed`."""
    def loop(fields, steps, remaps, **kw):
        nv, ns = fields["u"].shape
        plan = fused_single.launch_plan(
            ns, nv, fields["u"].element_size(), kw["scheme"],
            **forced) if forced else None
        return fused_single._launch_packed(
            *fused_single._pack(fields, steps, remaps), **kw, fmad=fmad,
            plan=plan)
    return loop


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda")


def _inputs(device, dtype, arm, r_f=0.0):
    strikes = torch.linspace(70.0, 130.0, 37, dtype=dtype, device=device)
    fields, vec_s, idx_s, idx_v, _ = assembly.assemble(
        SPEC, SOLVER, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, r_f)
    events = assembly.dividend_plan(SOLVER, ARMS[arm]["dividends"])
    remaps = assembly.build_remap_fields(vec_s, events)
    kw = dict(theta=SOLVER.theta, delta_t=SOLVER.delta_t,
              n_steps=SOLVER.n_steps, rf=r_f,
              american=ARMS[arm]["american"])
    return fields, [e[0] for e in events], remaps, kw


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_kernel_f32_matches_plain_f32(cuda_device, arm, scheme):
    """float32 kernel against the float32 plain version on the same
    inputs: both run the same IEEE operation sequence (the kernel is
    built with -fmad=false), so they agree to a few ulps of the surface
    (values up to ~10^3: 1e-3 absolute is ~16 ulps there)."""
    fields, steps, remaps, kw = _inputs(cuda_device, torch.float32, arm)
    got, _ = _do_loop(fmad=False)(fields, steps, remaps, **kw,
                                  scheme=scheme)
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
    fields, vec_s, _, _, _ = assembly.assemble(
        spec, solver, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, 0.01)
    events = assembly.dividend_plan(solver, GOLDEN_DIVIDENDS)
    remaps = assembly.build_remap_fields(vec_s, events)
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
    events = assembly.dividend_plan(solver, ARMS[arm]["dividends"])
    remaps = assembly.build_remap_fields(vec_s, events)
    kw = dict(theta=solver.theta, delta_t=solver.delta_t,
              n_steps=solver.n_steps, rf=0.0,
              american=ARMS[arm]["american"], tangents=tangents)
    return fields, [e[0] for e in events], remaps, kw


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
    got_u, _, got_du, _ = _do_loop(groups=1)(fields, steps, remaps, **kw)
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
    got_u, _, got_du, _ = _do_loop(fmad=False)(fields, steps, remaps, **kw)
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
# fall before steps 1..6 at N = 8), and 300 of them, past the 2 x 132
# options of a Douglas book of 256-thread blocks
LANE_ARMS = {"euro": (0, ARMS["euro"], 37),
             "amer_div": (0, ARMS["amer_div"], 37),
             "rann_amer_div": (2, ARMS["amer_div"], 37),
             "amer_div_300": (0, ARMS["amer_div"], 300)}


def _lane_nst(device, n=37):
    return torch.arange(n, device=device) % SOLVER.n_steps + 1


def _lane_plan(device, dtype, arm):
    """(fields, phases) of a mixed book as fused_price_batch launches it
    (fused_do.book_plan)."""
    rann, kw, n = LANE_ARMS[arm]
    solver = SolverConfig(n_steps=8, a2_variant="upwind",
                          solver_engine="pallas", rannacher_steps=rann)
    strikes = torch.linspace(70.0, 130.0, n, dtype=dtype, device=device)
    fields, phases, _, _, _ = fused_do.book_plan(
        SPEC, solver, strikes, 100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0,
        P.r_d, 0.01, n_steps_per=_lane_nst(device, n), **kw)
    return fields, phases


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_per_lane_kernel_f64_matches_plain(cuda_device, arm):
    """Per-lane step counts: each block stops at its own count; the
    float64 kernel against the plain version (which freezes lanes), u and
    lambda at 1e-10; one launch per phase. 300 options take 128-thread
    blocks and the kernel bounded to 4 of them an SM
    (fused_do.bounded_kernel), bitwise the plain version (-fmad=false:
    the bound moves registers, not roundings). Each launch adds its
    kernel's resident blocks an SM to `fused_do_loop.resident_blocks`,
    queried once a shape: the second run queries nothing."""
    fields, phases = _lane_plan(cuda_device, torch.float64, arm)
    b, ns, nv = fields["u"].shape
    plan = fused_do.launch_plan(
        b, ns, nv, 8, "do", phases[0][2]["american"],
        n_sm=fused_do._sm_count(torch.cuda.current_device()))
    bounded = arm == "amer_div_300"
    assert fused_do.bounded_kernel(torch.float64, "do",
                                   plan.threads) == bounded
    blocks = fused_do.occupancy(torch.float64, ns, nv, "do",
                                phases[0][2]["american"], plan)
    for run in range(2):
        before = (fused_do.fused_do_loop.launches,
                  fused_do.fused_do_loop.resident_blocks,
                  fused_do.resident_blocks.queries)
        got = assembly.run_phases(fused_do.fused_do_loop, fields, phases)
        torch.cuda.synchronize()
        launches, resident, queries = (
            a - b for a, b in zip((fused_do.fused_do_loop.launches,
                                   fused_do.fused_do_loop.resident_blocks,
                                   fused_do.resident_blocks.queries),
                                  before))
        assert launches == len(phases)
        assert resident == len(phases) * blocks["blocks_per_sm"]
        assert queries == 0 or run == 0
    if bounded:
        assert blocks["blocks_per_sm"] == 4 and blocks["registers"] <= 128
    want = assembly.run_phases(fused_do.fused_do_reference, fields, phases)
    for g, w in zip(got, want):
        if bounded:
            assert float((g - w).abs().max()) == 0.0
        else:
            torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_f64_douglas_book_keeps_four_blocks_an_sm(cuda_device):
    """The book cell's launch (5,000 float64 American options at 51 x 26,
    128 threads, d, tw and ti in shared memory at the 4-block budget)
    takes the bounded kernel: at most 128 registers a thread and 4
    resident blocks an SM, as its shared memory allows. A book of at most
    264 options (256 threads) keeps the unbounded kernel, whose compiler
    choice passes 128 registers."""
    plan = fused_do.launch_plan(5000, 51, 26, 8, "do", True)
    assert plan.threads == fused_do.PRIMAL_THREADS
    assert plan.smem_fields == ("d", "tw", "ti")
    occ = fused_do.occupancy(torch.float64, 51, 26, "do", True, plan)
    assert occ["bounded"] and occ["blocks_per_sm"] == 4
    assert occ["registers"] <= 128
    wide = fused_do.launch_plan(264, 51, 26, 8, "do", True)
    assert wide.threads == fused_do.WIDE_THREADS
    occ = fused_do.occupancy(torch.float64, 51, 26, "do", True, wide)
    assert not occ["bounded"] and occ["registers"] > 128


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_per_lane_kernel_f32_matches_plain_f32(cuda_device, arm):
    """The same in float32: a few ulps of the surfaces (-fmad=false)."""
    fields, phases = _lane_plan(cuda_device, torch.float32, arm)
    got = assembly.run_phases(_do_loop(fmad=False), fields, phases)
    want = assembly.run_phases(fused_do.fused_do_reference, fields, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
    got_u, _, got_du, _ = _do_loop(fmad=False)(
        fields, steps, remaps, **kw, tangents=tangents)
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
    got = assembly.run_phases(fused_single.fused_single_loop, sf, phases)
    torch.cuda.synchronize()
    assert fused_single.fused_single_loop.launches == before + len(phases)
    want = assembly.run_phases(fused_single.fused_single_reference, sf, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("arm", sorted(SINGLE_ARMS))
def test_single_kernel_f32_matches_plain_f32(cuda_device, arm):
    """float32 single-option kernel against the float32 plain version:
    the same IEEE operation sequence (-fmad=false), so a few ulps of the
    surface (values up to ~10^3: 1e-3 absolute is ~16 ulps)."""
    sf, phases = _single_phases(cuda_device, torch.float32, arm)
    got = assembly.run_phases(_single_loop(fmad=False), sf, phases)
    want = assembly.run_phases(fused_single.fused_single_reference, sf, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
    got = assembly.run_phases(fused_single.fused_single_loop, sf, phases)
    want = assembly.run_phases(fused_single.fused_single_reference, sf, phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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


# the single-option plan built on the card by the plan kernel
# (fused_single.device_plan) against the host plan (single_plan) run on the
# same CUDA tensors and packed (pack_plan): bitwise, every field, signed
# zeros included, in float32 and float64
GOLDEN = GridSpec(m1=100, m2=75)
GOLDEN_SOLVER = SolverConfig(n_steps=20, a2_variant="central",
                             solver_engine="pallas")
PLAN_PRODUCTS = {
    "call_euro": dict(),
    "call_div": dict(dividends=GOLDEN_DIVIDENDS),
    "call_amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS),
    "put_amer_div": dict(option_type="put", american=True,
                         dividends=GOLDEN_DIVIDENDS),
    "digital_call_div": dict(option_type="digital_call",
                             dividends=GOLDEN_DIVIDENDS),
    "digital_put_amer": dict(option_type="digital_put", american=True),
}
PLAN_DTYPES = {"f32": torch.float32, "f64": torch.float64}


def _market(seed):
    """A market state drawn as the benchmark's quote traffic draws it:
    (kappa, eta, sigma, rho, v0, r_d, r_f), Python floats."""
    import random

    rng = random.Random(seed)
    return (rng.uniform(1.0, 2.0), rng.uniform(0.03, 0.05),
            rng.uniform(0.2, 0.4), rng.uniform(-0.9, -0.6),
            rng.uniform(0.03, 0.05), P.r_d, P.r_f)


def _plan_pair(device, dtype, spec, solver, strike, market, **kw):
    """(device plan, host plan packed) of one option on the card."""
    args = (spec, solver, torch.tensor([strike], dtype=dtype, device=device),
            100.0, *market)
    got = fused_single.device_plan(*args, **kw)
    want = fused_single.pack_plan(*fused_single.single_plan(*args, **kw))
    torch.cuda.synchronize()
    return got, want


def _assert_plans_equal(got, want):
    for name, g, w in zip(fused_single.DevicePlan._fields, got[:-1],
                          want[:-1]):
        assert (g.dtype, tuple(g.shape)) == (w.dtype, tuple(w.shape)), name
        assert torch.equal(g, w), name
        if g.is_floating_point():
            assert torch.equal(torch.signbit(g), torch.signbit(w)), name
    assert got.phases == want.phases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("product", sorted(PLAN_PRODUCTS))
@pytest.mark.parametrize("strike", [80.0, 92.5, 100.0, 107.5, 120.0])
def test_plan_kernel_matches_host_plan_golden(cuda_device, strike, product,
                                              dtype):
    """The golden grid, strikes across 80..120 (K = 107.5 among them) at a
    drawn market state, calls, puts and both digitals, European and
    American, with and without the golden dividends: one launch of the
    plan kernel, bitwise the host plan."""
    before = fused_single.device_plan.launches
    got, want = _plan_pair(cuda_device, PLAN_DTYPES[dtype], GOLDEN,
                           GOLDEN_SOLVER, strike, _market(int(strike * 10)),
                           **PLAN_PRODUCTS[product])
    assert fused_single.device_plan.launches == before + 1
    _assert_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("rann", [0, 2])
@pytest.mark.parametrize("a2", ["central", "upwind"])
@pytest.mark.parametrize("m1,m2", [(50, 25), (120, 100)])
def test_plan_kernel_matches_host_plan_other_grids(cuda_device, m1, m2, a2,
                                                   rann, dtype):
    """Two more grids the routing rule admits (50 x 25 and 121 x 101),
    central and upwind A2 (the 121 x 101 v-grid reaches v > 1, where
    upwind's rows enter), Rannacher on and off: the American call with
    the golden dividends, bitwise."""
    spec = GridSpec(m1=m1, m2=m2)
    solver = SolverConfig(n_steps=20, a2_variant=a2, solver_engine="pallas",
                          rannacher_steps=rann)
    assert fused_single.use_single(spec, solver, 1)
    got, want = _plan_pair(cuda_device, PLAN_DTYPES[dtype], spec, solver,
                           95.0, _market(m1 + m2), american=True,
                           dividends=GOLDEN_DIVIDENDS)
    assert len(got.phases) == (2 if rann else 1)
    _assert_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("option_type", ["call", "put"])
@pytest.mark.parametrize("barrier", [Barrier("up-out", 140.0),
                                     Barrier("down-out", 80.0),
                                     Barrier("double-out", 75.0, 150.0)],
                         ids=lambda b: b.kind)
def test_plan_kernel_matches_host_plan_barriers(cuda_device, barrier,
                                                option_type, dtype):
    """Knock-out domains (the pinned ends, S0 among the lower nodes under
    a top knock, the masked payoff, the re-knocked remap column), with the
    golden dividends, bitwise."""
    spec = dataclasses.replace(GOLDEN, barrier=barrier)
    got, want = _plan_pair(cuda_device, PLAN_DTYPES[dtype], spec,
                           GOLDEN_SOLVER, 100.0, _market(7),
                           option_type=option_type,
                           dividends=GOLDEN_DIVIDENDS)
    _assert_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("gap", [0.0, 3e-7, 1e-6])
def test_plan_kernel_v0_next_to_a_v_node(cuda_device, gap, dtype):
    """v0 on a v-node of the raw grid (the duplicate rule keeps the
    nodes) and within 1e-6 of one, at K = 107.5: bitwise."""
    from heston_tpu_torch.ops import grid as gridmod

    d = PLAN_DTYPES[dtype]
    nodes = gridmod.make_v_nodes(GOLDEN.m2, GOLDEN.v_max, 1.0,
                                 GOLDEN.v_max / GOLDEN.d_div, d, cuda_device)
    v0 = float(nodes[12]) + gap
    market = (1.5, 0.04, 0.3, -0.9, v0, P.r_d, P.r_f)
    got, want = _plan_pair(cuda_device, d, GOLDEN, GOLDEN_SOLVER, 107.5,
                           market)
    _assert_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("option_type", ["call", "put"])
def test_plan_kernel_two_events_in_a_step(cuda_device, option_type, dtype):
    """Two events in one step, the second shifting every node to <= 0
    (calls zero those columns, puts copy column 0), then a proportional
    one: bitwise."""
    from heston_tpu_torch.config import DividendSchedule

    two = DividendSchedule(dates=(0.2, 0.22, 0.5), amounts=(0.5, 900.0, 0.2),
                           percentages=(0.02, 0.0, 0.5))
    got, want = _plan_pair(cuda_device, PLAN_DTYPES[dtype], GOLDEN,
                           GOLDEN_SOLVER, 100.0, _market(3),
                           option_type=option_type, dividends=two)
    assert got.ev_step.tolist() == [4, 4, 10]
    _assert_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_plan_kernel_over_several_launches(cuda_device, dtype):
    """A schedule longer than a launch's events (PLAN_EVENTS) takes more
    launches of the same kernel: 40 small dividends, several to a step,
    in two launches, bitwise the host plan."""
    from heston_tpu_torch.config import DividendSchedule

    n = assembly.PLAN_EVENTS + 8
    many = DividendSchedule(dates=tuple(0.1 + 0.02 * k for k in range(n)),
                            amounts=(0.05,) * n, percentages=(0.001,) * n)
    before = fused_single.device_plan.launches
    got, want = _plan_pair(cuda_device, PLAN_DTYPES[dtype], GOLDEN,
                           GOLDEN_SOLVER, 100.0, _market(5), american=True,
                           dividends=many)
    assert fused_single.device_plan.launches == before + 2
    assert got.ev_step.shape[0] == n
    _assert_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("product", ["call_euro", "call_div",
                                     "call_amer_div"])
def test_price_batch_of_one_takes_the_device_plan(cuda_device, product,
                                                  dtype):
    """price_batch of one strike on the card: one plan launch and one
    launch of kernel 2 a quote (none of kernel 1), and bitwise the price
    of the host-plan route (single_plan, kernel 2, the node's read)."""
    from heston_tpu_torch import price_batch

    strikes = torch.tensor([97.5], dtype=PLAN_DTYPES[dtype],
                           device=cuda_device)
    args = (GOLDEN, GOLDEN_SOLVER, strikes, 100.0, *_market(11))
    kw = PLAN_PRODUCTS[product]
    counts = (fused_single.device_plan.launches,
              fused_single.fused_single_loop.launches,
              fused_do.fused_do_loop.launches)
    got = price_batch(*args, **kw)
    torch.cuda.synchronize()
    assert (fused_single.device_plan.launches - counts[0],
            fused_single.fused_single_loop.launches - counts[1],
            fused_do.fused_do_loop.launches - counts[2]) == (1, 1, 0)
    fields, phases, at = fused_single.single_plan(*args, **kw)
    u, _ = assembly.run_phases(fused_single.fused_single_loop, fields,
                                   phases)
    assert got.shape == (1,) and torch.equal(got, u[at].reshape(1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_sharded_quote_of_one_takes_the_plan_kernel(cuda_device, dtype):
    """A sharded book of one strike: each rank hands price_batch its
    parameters as 0-d tensors on the card (sharded._local_prices), which
    the plan kernel reads there. One plan launch and one launch of kernel
    2 (none of kernel 1), and bitwise the price of the same market passed
    by value."""
    from heston_tpu_torch import parallel as par

    mesh = par.make_mesh()
    strikes = torch.tensor([97.5], dtype=PLAN_DTYPES[dtype],
                           device=cuda_device)
    theta = _market(17)[:5]
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    counts = (fused_single.device_plan.launches,
              fused_single.fused_single_loop.launches,
              fused_do.fused_do_loop.launches)
    got = par.price_batch_sharded(mesh, GOLDEN, GOLDEN_SOLVER, strikes,
                                  100.0,
                                  torch.tensor(theta, dtype=torch.float64),
                                  P.r_d, P.r_f, **kw)
    torch.cuda.synchronize()
    assert (fused_single.device_plan.launches - counts[0],
            fused_single.fused_single_loop.launches - counts[1],
            fused_do.fused_do_loop.launches - counts[2]) == (1, 1, 0)
    # the rank's parameters as the kernel read them: rounded to the book's
    # dtype, then taken in float64
    by_value = torch.tensor(theta, dtype=PLAN_DTYPES[dtype]).tolist()
    want = fused_single.fused_price_single(GOLDEN, GOLDEN_SOLVER, strikes,
                                           100.0, *by_value, P.r_d, P.r_f,
                                           **kw)
    assert got.shape == (1,) and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("market", ["numbers", "tensors"])
def test_plan_kernel_speaks_only_through_the_price(cuda_device, market):
    """The device route of a quote reads nothing back to the host before
    the caller's own copy, with the market as numbers and with the
    parameters as 0-d tensors on the card: run under a CUDA sync debug
    mode that raises on a blocking call; the tensors price as their
    values passed as numbers, bit for bit."""
    strikes = torch.tensor([100.0], device=cuda_device)
    values = list(_market(13))
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    if market == "tensors":
        values[:5] = [torch.tensor(x, device=cuda_device)
                      for x in values[:5]]
    want = fused_single.fused_price_single(   # builds and warms
        GOLDEN, GOLDEN_SOLVER, strikes, 100.0,
        *[float(x) for x in values], **kw)
    args = (GOLDEN, GOLDEN_SOLVER, strikes, 100.0, *values)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        price = fused_single.fused_price_single(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert price.shape == (1,) and torch.equal(price, want)



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
    want = assembly.run_phases(fused_single.fused_single_reference, sf,
                                   phases)
    return sf, phases, assembly.barrier_positions(spec), want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10),
                                       (torch.float32, 1e-3)],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("cluster,factors", SINGLE_PLANS,
                         ids=[f"C{c}-{'smem' if f else 'global'}"
                              for c, f in SINGLE_PLANS])
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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

    loop = _single_loop(fmad=False, cluster=cluster, factors=factors)
    before = fused_single.fused_single_loop.launches
    got = assembly.run_phases(loop, sf, phases)
    torch.cuda.synchronize()
    assert fused_single.fused_single_loop.launches == before + len(phases)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=tol)
    _assert_knocked_zero(got[0], knocked, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
        out = assembly.run_phases(_single_loop(fmad=False, **forced), sf,
                                  phases)
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
    return fields, phases, assembly.barrier_positions(spec)


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
    got = assembly.run_phases(fused_do.fused_do_loop, fields, phases)
    torch.cuda.synchronize()
    assert fused_do.fused_do_loop.launches == before + 1
    want = assembly.run_phases(fused_do.fused_do_reference, fields, phases)
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
    got = assembly.run_phases(fused_do.fused_do_loop, fields, phases)
    want = assembly.run_phases(fused_do.fused_do_reference, fields, phases)
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
    got = assembly.run_phases(_do_loop(fmad=False), fields, phases)
    want = assembly.run_phases(fused_do.fused_do_reference, fields, phases)
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
    knocked = assembly.barrier_positions(spec)
    (steps, remaps, kw), = fused_do.book_phases(
        SOLVER, ARMS[arm]["dividends"], vec_s,
        fused_do.operators.boundary_rate(P.r_d, 0.0, option_type),
        ARMS[arm]["american"], option_type=option_type, knocked=knocked)
    before = fused_do.fused_do_loop.tangent_launches
    got_u, _, got_du, _ = _do_loop(fmad=False)(
        fields, steps, remaps, **kw, tangents=tangents)
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
    return sf, phases, assembly.barrier_positions(
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
    got = assembly.run_phases(fused_single.fused_single_loop, sf, phases)
    torch.cuda.synchronize()
    assert fused_single.fused_single_loop.launches == before + len(phases)
    want = assembly.run_phases(fused_single.fused_single_reference, sf,
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
    got = assembly.run_phases(_single_loop(fmad=False), sf, phases)
    want = assembly.run_phases(fused_single.fused_single_reference, sf,
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
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
@pytest.mark.parametrize("scheme", assembly.SCHEMES)
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
# fields (all in shared memory, the first three, none) through its
# smem_budget, and the forward mode's tangent groups G = 1 and G = K, each
# forced at the packed launch
# ---------------------------------------------------------------------------

PLACEMENTS = ("all_smem", "partial", "all_global")


def _placed(placement, groups=None, fmad=None):
    """Kernel 1's loop (`_do_loop`) with the working fields placed as
    `placement` says (the budget that leaves exactly that many fields in
    shared memory, checked against the plan) and `groups` tangent
    groups."""
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
        return _do_loop(fmad=fmad, smem_budget=budget, groups=groups)(
            fields, steps, remaps, **kw)
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


# ---------------------------------------------------------------------------
# the characteristic-function pricer, the scenarios, the native engine
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("option_type", ["call", "put", "digital_call"])
def test_cf_chain_on_the_card_matches_the_cpu(cuda_device, option_type):
    """The CF pricer (plain torch, complex128) on the card as on the CPU,
    float64 at 1e-10; float32 (complex64) within 1e-4 of the CPU's
    float64."""
    from heston_tpu_torch.models import heston_cf

    ks = torch.linspace(60.0, 150.0, 19, dtype=torch.float64)
    args = (P.v0, P.kappa, P.eta, P.sigma, P.rho, P.r_d, 1.0)
    want = heston_cf.price_chain(100.0, ks, *args, option_type=option_type,
                                 device="cpu")
    for dtype, atol in ((torch.float64, 1e-10), (torch.float32, 1e-4)):
        got = heston_cf.price_chain(100.0, ks.to(dtype), *args,
                                    option_type=option_type)
        assert got.device.type == "cuda" and got.dtype == dtype
        torch.testing.assert_close(got.double().cpu(), want, rtol=0,
                                   atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ad", "fd"])
def test_cf_calibration_on_the_card_matches_the_cpu(cuda_device, mode):
    """calibrate_device(pricer="cf") on the card, float64: the same
    iterations and accept flags as the CPU run, the parameters at 1e-8
    ("ad") and 4e-8 relative ("fd": its 1e-3 bumps turn CUDA's exp and
    log, which round apart from the CPU's, into 3.6e-9 relative on kappa,
    measured), and no kernel launch."""
    from heston_tpu_torch.models import bs, calibration

    ks = torch.linspace(80.0, 120.0, 12, dtype=torch.float64)
    market = bs.generate_market_data(100.0, 1.0, P.r_d, ks)
    cfg = CalibrationConfig(max_iter=3, tol=1e-10, eps=1e-3,
                            jacobian_mode=mode)
    before = (fused_do.fused_do_loop.launches,
              fused_do.fused_do_loop.tangent_launches,
              fused_single.fused_single_loop.launches)
    out = {}
    for dev in ("cpu", "cuda"):
        out[dev] = calibration.calibrate_device(
            SPEC, SOLVER, ks, market, 100.0,
            torch.tensor([1.2, 0.05, 0.3, -0.4, 0.05], dtype=torch.float64),
            P.r_d, P.r_f, cfg=cfg, pricer="cf", device=dev)
    (tc, ic), (tg, ig) = out["cpu"], out["cuda"]
    assert tg.device.type == "cuda" and ig["iterations"] == ic["iterations"]
    torch.testing.assert_close(ig["history"]["accepted"].cpu(),
                               ic["history"]["accepted"])
    torch.testing.assert_close(tg.cpu(), tc, rtol=4e-8 if mode == "fd"
                               else 0, atol=0 if mode == "fd" else 1e-8)
    assert before == (fused_do.fused_do_loop.launches,
                      fused_do.fused_do_loop.tangent_launches,
                      fused_single.fused_single_loop.launches)


@pytest.mark.cuda
def test_scenario_device_loop_on_the_card_matches_the_cpu(cuda_device,
                                                          monkeypatch):
    """A shrunk scenario (american_dividends, 5 strikes, one iteration,
    14 x 8 x 4) through run_scenario(device_loop=True) on kernel 1,
    float64: the fit of the CPU run (plain versions) at 1e-10, one
    forward-mode and one primal launch."""
    from heston_tpu_torch import scenarios

    name = "american_dividends"
    monkeypatch.setitem(scenarios.SCENARIOS, name, dataclasses.replace(
        scenarios.SCENARIOS[name], num_strikes=5, max_iter=1, tol=1e-9))
    monkeypatch.setattr(scenarios, "CalibrationConfig", functools.partial(
        scenarios.CalibrationConfig, jacobian_mode="ad"))
    solver = SolverConfig(n_steps=4, solver_engine="pallas")
    res = {}
    for dev in ("cpu", "cuda"):
        n0 = (fused_do.fused_do_loop.launches,
              fused_do.fused_do_loop.tangent_launches)
        res[dev], _ = scenarios.run_scenario(
            name, spec=GridSpec(m1=14, m2=8), solver=solver,
            steps_per_year=4, verbose=False, device_loop=True,
            dtype=torch.float64, device=dev)
        launches = (fused_do.fused_do_loop.launches - n0[0],
                    fused_do.fused_do_loop.tangent_launches - n0[1])
        assert launches == ((1, 1) if dev == "cuda" else (0, 0))
    assert res["cuda"].iterations == res["cpu"].iterations == 1
    torch.testing.assert_close(
        torch.as_tensor(res["cuda"].params.bumpable()),
        torch.as_tensor(res["cpu"].params.bumpable()), rtol=0, atol=1e-10)
    torch.testing.assert_close(torch.as_tensor(res["cuda"].fitted_prices),
                               torch.as_tensor(res["cpu"].fitted_prices),
                               rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_native_engine_matches_kernel_1(cuda_device):
    """The native OpenMP engine (float64 on the host) against kernel 1's
    float64 prices of the same book, American with the golden dividends,
    at 1e-10."""
    from heston_tpu_torch.models import douglas
    from heston_tpu_torch.utils import native

    ks = torch.linspace(70.0, 130.0, 37, dtype=torch.float64)
    args = (P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    want = douglas.price_batch(SPEC, SOLVER, ks.to("cuda"), 100.0, *args,
                               **ARMS["amer_div"])
    got = native.price_batch_cpu(SPEC, SOLVER, ks.numpy(), 100.0, *args,
                                 **ARMS["amer_div"])
    torch.testing.assert_close(torch.as_tensor(got), want.cpu(), rtol=0,
                               atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme,steps", [("truncation", 50), ("qe", 16)])
def test_mc_on_the_card_matches_the_cpu(cuda_device, scheme, steps):
    """The Monte Carlo oracle from generators on the card and on the CPU
    (different streams): the two f64 prices within their combined 95%
    half-widths, and no kernel launch."""
    from heston_tpu_torch.models import mc

    def price(dev):
        return [float(x) for x in mc.price_european_call_mc(
            torch.Generator(device=dev).manual_seed(3), 100.0, P.v0,
            torch.tensor(100.0, dtype=torch.float64, device=dev), P.r_d,
            P.r_f, P.kappa, P.eta, P.sigma, P.rho, 1.0, num_paths=40_000,
            n_steps=steps, scheme=scheme, device=dev)]

    fused_do.fused_do_loop.launches = 0
    (card, h_card), (cpu, h_cpu) = price(cuda_device), price("cpu")
    assert fused_do.fused_do_loop.launches == 0
    assert abs(card - cpu) <= 2.0 * (h_card ** 2 + h_cpu ** 2) ** 0.5


@pytest.mark.cuda
def test_sharded_world_of_one_on_the_card(cuda_device):
    """Without a process group the mesh is this process on the card: the
    sharded book equals price_batch's, in one launch of kernel 1."""
    from heston_tpu_torch import parallel as par
    from heston_tpu_torch.models import douglas

    mesh = par.make_mesh()
    assert (mesh.size, mesh.device.type) == (1, "cuda")
    ks = torch.linspace(70.0, 130.0, 37, dtype=torch.float64,
                        device=cuda_device)
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS)
    fused_do.fused_do_loop.launches = 0
    got = par.price_batch_sharded(mesh, SPEC, SOLVER, ks, 100.0,
                                  torch.tensor(P.bumpable(),
                                               dtype=torch.float64),
                                  P.r_d, P.r_f, **kw)
    assert fused_do.fused_do_loop.launches == 1
    want = douglas.price_batch(SPEC, SOLVER, ks, 100.0, P.kappa, P.eta,
                               P.sigma, P.rho, P.v0, P.r_d, P.r_f, **kw)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cli_price_on_the_card(cuda_device, capsys):
    """The CLI's default device is the card: its prices are price_batch's
    on the card."""
    import json

    from heston_tpu_torch import cli
    from heston_tpu_torch.models import douglas

    assert cli.main(["price", "--strikes", "90", "100", "110", "--m1",
                     "20", "--m2", "12", "--n-steps", "8", "--engine",
                     "pallas", "--float64"]) == 0
    got = [json.loads(line)["price"]
           for line in capsys.readouterr().out.splitlines()]
    want = douglas.price_batch(
        SPEC, SOLVER, torch.tensor([90.0, 100.0, 110.0], dtype=torch.float64,
                                   device=cuda_device), 100.0, P.kappa,
        P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    assert got == want.tolist()


# market states of the book cell's traffic (kappa, eta, sigma, rho, v0),
# each with the card-against-CPU tolerance: one drawn from its ranges
# (numpy's default_rng(1700), five uniform draws) and C6's.
# C6's state (ROADMAP C6: v0 next to a v-node, strikes with an s-node
# next to S0) reads a float32 gap of 4.76, ~1e8 float32 roundings; the
# same conditioning takes float64's rounding (1.1e-16) to ~1e-8.
BOOK_STATES = {
    "drawn": ((1.08751, 0.04464, 0.30741, -0.81605, 0.03063), 1e-12),
    "c6": ((1.197, 0.0432, 0.368, -0.833, 0.0448), 1e-8),
}


@pytest.mark.cuda
@pytest.mark.parametrize("state", sorted(BOOK_STATES))
def test_price_batch_mixed_book_f64_at_the_published_widths(cuda_device,
                                                            state):
    """price_batch(group_steps=) at the book cell's widths: 50 x 25 x 20
    float64, upwind A2, 10 maturity groups (2, 4, ..., 20 steps) of the
    same 500 strikes, American with the golden dividends. The card
    against the CPU's plain version (atol 1e-12 at a drawn state, ROADMAP
    C8; C6's state at its conditioning's 1e-8); one launch of kernel 1,
    none of kernel 2, one book plan of 5,000 options."""
    from heston_tpu_torch.models import douglas

    spec = GridSpec(m1=50, m2=25)
    solver = SolverConfig(n_steps=20, a2_variant="upwind",
                          solver_engine="pallas")
    ks = torch.linspace(70.0, 130.0, 500, dtype=torch.float64).repeat(10)
    groups = tuple((500 * i, 500 * (i + 1), 2 * (i + 1)) for i in range(10))
    market, atol = BOOK_STATES[state]

    def counters():
        return (fused_do.fused_do_loop.launches,
                fused_single.fused_single_loop.launches,
                fused_do.book_plan.calls, fused_do.book_plan.lanes)

    def prices(device):
        return douglas.price_batch(spec, solver, ks, 100.0, *market, P.r_d,
                                   P.r_f, american=True,
                                   dividends=GOLDEN_DIVIDENDS, device=device,
                                   group_steps=groups)

    before = counters()
    got = prices(cuda_device)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counters(), before)] == [1, 0, 1, 5000]
    want = prices("cpu")
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=atol)


# the book's plan built on the card by its plan kernel
# (fused_do.device_book_plan, one block an option) against the host plan
# (book_plan) run on the same CUDA tensors and packed (pack_book_plan):
# bitwise, every field, signed zeros included, in float32 and float64
BOOK_SPEC = GridSpec(m1=50, m2=25)
BOOK_SOLVER = SolverConfig(n_steps=20, a2_variant="upwind",
                           solver_engine="pallas")
# per-lane counts of a 37-strike book: lanes that stop before the later
# golden dividends (steps 5, 9, 13, 17), and under Rannacher (R = 2) lanes
# with n_i <= R
BOOK_MIXED = [20, 1, 2, 3, 4, 9, 12, 16, 17, 20, 19, 5] * 3 + [8]
BOOK_TWO = DividendSchedule(dates=(0.2, 0.22, 0.5),
                            amounts=(0.5, 900.0, 0.2),
                            percentages=(0.02, 0.0, 0.5))
BOOK_PLAN_CASES = {
    "euro": dict(),
    "amer_div_mixed": dict(american=True, dividends=GOLDEN_DIVIDENDS,
                           n_steps_per=BOOK_MIXED),
    "put_div": dict(option_type="put", dividends=GOLDEN_DIVIDENDS),
    "digital_put_div": dict(option_type="digital_put",
                            dividends=GOLDEN_DIVIDENDS),
    "digital_call_amer": dict(option_type="digital_call", american=True),
    "up_out_div": dict(dividends=GOLDEN_DIVIDENDS, n_steps_per=BOOK_MIXED,
                       spec=dataclasses.replace(
                           BOOK_SPEC, barrier=Barrier("up-out", 140.0))),
    "down_out_div": dict(option_type="put", dividends=GOLDEN_DIVIDENDS,
                         spec=dataclasses.replace(
                             BOOK_SPEC, barrier=Barrier("down-out", 75.0))),
    "double_out_div": dict(dividends=GOLDEN_DIVIDENDS,
                           spec=dataclasses.replace(
                               BOOK_SPEC, barrier=Barrier("double-out", 70.0,
                                                          150.0))),
    "rannacher_central_mixed": dict(
        american=True, dividends=GOLDEN_DIVIDENDS, n_steps_per=BOOK_MIXED,
        solver=dataclasses.replace(BOOK_SOLVER, a2_variant="central",
                                   rannacher_steps=2)),
    "rannacher_upwind_mixed": dict(
        american=True, dividends=GOLDEN_DIVIDENDS, n_steps_per=BOOK_MIXED,
        solver=dataclasses.replace(BOOK_SOLVER, rannacher_steps=2)),
    "two_in_a_step": dict(dividends=BOOK_TWO, n_steps_per=BOOK_MIXED),
}
_BOOK_ORDER = (("american", False), ("dividends", None),
               ("option_type", "call"), ("n_steps_per", None))


def _book_args(device, dtype, case, market, strikes=None):
    kw = dict(BOOK_PLAN_CASES[case])
    spec = kw.pop("spec", BOOK_SPEC)
    solver = kw.pop("solver", BOOK_SOLVER)
    if "n_steps_per" in kw:
        kw["n_steps_per"] = torch.tensor(kw["n_steps_per"])
    if strikes is None:
        strikes = torch.linspace(70.0, 130.0, 37, dtype=torch.float64)
    return (spec, solver, strikes.to(device, dtype), 100.0, *market), kw


def _book_plan_pair(args, kw):
    """(card plan, host plan packed) of a book on the card."""
    got = fused_do.device_book_plan(*args, **kw)
    fields, phases, at, _, _ = fused_do.book_plan(
        *args, *(kw.get(k, d) for k, d in _BOOK_ORDER))
    want = fused_do.pack_book_plan(fields, phases, at)
    torch.cuda.synchronize()
    return got, want


def _assert_book_plans_equal(got, want):
    for name, g, w in zip(fused_do.BookPlan._fields, got[:-1], want[:-1]):
        if w is None:
            assert g is None, name
            continue
        assert (g.dtype, tuple(g.shape)) == (w.dtype, tuple(w.shape)), name
        assert torch.equal(g, w), name
        if g.is_floating_point():
            assert torch.equal(torch.signbit(g), torch.signbit(w)), name
    assert got.phases == want.phases


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("case", sorted(BOOK_PLAN_CASES))
def test_book_plan_kernel_matches_host_plan(cuda_device, case, dtype):
    """A 37-strike book on 51 x 26, calls, puts and both digitals,
    European and American, the three knock-out domains, Rannacher with
    both A2 variants, mixed step counts (events past some lanes' counts,
    lanes with n_i <= R), two events in one step: one launch of the book's
    plan kernel, bitwise the host plan."""
    args, kw = _book_args(cuda_device, PLAN_DTYPES[dtype], case,
                          _market(len(case)))
    before = fused_do.device_book_plan.launches
    got, want = _book_plan_pair(args, kw)
    assert fused_do.device_book_plan.launches == before + 1
    _assert_book_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_book_plan_kernel_at_the_cell_shape(cuda_device, dtype):
    """The book cell's own shape: 5,000 American calls with the golden
    dividends, 10 maturity groups (2, 4, ..., 20 steps) of the same 500
    strikes on 51 x 26 with upwind A2, at a drawn market state: bitwise."""
    from heston_tpu_torch.models import douglas

    groups = tuple((500 * i, 500 * (i + 1), 2 * (i + 1)) for i in range(10))
    ks = torch.linspace(70.0, 130.0, 500, dtype=torch.float64).repeat(10)
    args = (BOOK_SPEC, BOOK_SOLVER, ks.to(cuda_device, PLAN_DTYPES[dtype]),
            100.0, *_market(5000))
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS,
              n_steps_per=douglas.lane_steps(groups))
    got, want = _book_plan_pair(args, kw)
    _assert_book_plans_equal(got, want)


# strikes that are a view: every other strike of a longer ladder, a
# column of a strike grid (offset and stride), one strike expanded
# (stride 0)
BOOK_LAYOUTS = {
    "every_other": lambda ks: torch.stack([ks, ks + 1.0], 1).reshape(-1)[::2],
    "grid_column": lambda ks: torch.stack([ks - 1.0, ks, ks + 1.0], 1)[:, 1],
    "expanded": lambda ks: ks[5:6].expand(len(ks)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("layout", sorted(BOOK_LAYOUTS))
def test_book_plan_kernel_takes_strikes_of_any_layout(cuda_device, layout,
                                                      dtype):
    """A mixed book whose strikes are a strided or expanded view on the
    card: the plan kernel's buffers are bitwise the host plan's on the
    same view, and fused_price_batch's prices bitwise the host-plan
    route's."""
    args, kw = _book_args(cuda_device, PLAN_DTYPES[dtype], "amer_div_mixed",
                          _market(31))
    view = BOOK_LAYOUTS[layout](args[2])
    assert not view.is_contiguous()
    args = (*args[:2], view, *args[3:])
    got, want = _book_plan_pair(args, kw)
    _assert_book_plans_equal(got, want)
    prices = fused_do.fused_price_batch(*args, **kw)
    fields, phases, at, _, _ = fused_do.book_plan(
        *args, *(kw.get(k, d) for k, d in _BOOK_ORDER))
    u, _ = assembly.run_phases(fused_do.fused_do_loop, fields, phases)
    assert torch.equal(prices, fused_do._extract(u, *at))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_book_plan_kernel_over_several_launches(cuda_device, dtype):
    """A schedule longer than a launch's events (PLAN_EVENTS) takes more
    launches of the same kernel: 40 small dividends, several to a step,
    on a mixed book under Rannacher, in two launches, bitwise."""
    n = assembly.PLAN_EVENTS + 8
    many = DividendSchedule(dates=tuple(0.1 + 0.02 * k for k in range(n)),
                            amounts=(0.05,) * n, percentages=(0.001,) * n)
    args, kw = _book_args(cuda_device, PLAN_DTYPES[dtype],
                          "rannacher_upwind_mixed", _market(41))
    kw["dividends"] = many
    before = fused_do.device_book_plan.launches
    got, want = _book_plan_pair(args, kw)
    assert fused_do.device_book_plan.launches == before + 2
    assert got.ev_step.shape[0] == n
    _assert_book_plans_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("case", ["euro", "amer_div_mixed", "put_div",
                                  "rannacher_upwind_mixed"])
def test_price_batch_book_takes_the_device_book_plan(cuda_device, case,
                                                     dtype):
    """fused_price_batch of a flat-rate book on the card: one launch of
    the book's plan kernel, one book plan of 37 options, one launch of
    kernel 1 a phase (none of kernel 2), and bitwise the prices of the
    host-plan route (book_plan, kernel 1 from the field dicts, the nodes'
    read)."""
    args, kw = _book_args(cuda_device, PLAN_DTYPES[dtype], case,
                          _market(23))
    n_phases = 2 if "rannacher" in case else 1

    def counters():
        return (fused_do.device_book_plan.launches,
                fused_do.book_plan.calls, fused_do.book_plan.lanes,
                fused_do.fused_do_loop.launches,
                fused_single.fused_single_loop.launches)

    before = counters()
    got = fused_do.fused_price_batch(*args, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counters(), before)] == [
        1, 1, 37, n_phases, 0]
    fields, phases, at, _, _ = fused_do.book_plan(
        *args, *(kw.get(k, d) for k, d in _BOOK_ORDER))
    u, _ = assembly.run_phases(fused_do.fused_do_loop, fields, phases)
    assert got.shape == (37,) and torch.equal(got, fused_do._extract(u, *at))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
def test_book_plan_kernel_reads_a_market_of_tensors(cuda_device, dtype):
    """A mixed book whose parameters come as 0-d tensors on the card (as
    sharded ranks and calibration's trial pricing pass them): the plan
    kernel reads them there, and the route reads nothing back to the host
    before the caller's own copy (run under a CUDA sync debug mode that
    raises on a blocking call); the prices are bitwise those of the same
    values passed as numbers."""
    d = PLAN_DTYPES[dtype]
    values = list(_market(29))
    args, kw = _book_args(cuda_device, d, "amer_div_mixed", values)
    want = fused_do.fused_price_batch(*args, **kw)     # builds and warms
    theta = [torch.tensor(x, dtype=d, device=cuda_device)
             for x in values[:5]]
    by_value = [float(x) for x in theta]
    want = fused_do.fused_price_batch(*args[:4], *by_value, *values[5:],
                                      **kw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fused_do.fused_price_batch(*args[:4], *theta, *values[5:],
                                         **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_book_routes_on_the_card_open_their_spans(cuda_device):
    """On the card a flat-rate book's price_batch opens book_plan (the plan
    kernel's launch) and loop, and neither assemble nor remaps; a curve
    book, batch_greeks and fused_surface_batch still assemble on the
    host (heston.assemble)."""
    from torch.profiler import ProfilerActivity, profile

    from heston_tpu_torch import batch_greeks, price_batch

    ks = torch.linspace(80.0, 120.0, 8, dtype=torch.float64,
                        device=cuda_device)
    market = (100.0, P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f)
    groups = ((0, 4, 10), (4, 8, 20))
    curve = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.01))
    calls = {
        "book": lambda: price_batch(
            BOOK_SPEC, BOOK_SOLVER, ks, *market, american=True,
            dividends=GOLDEN_DIVIDENDS, group_steps=groups),
        "curve": lambda: fused_do.fused_price_batch(
            BOOK_SPEC, BOOK_SOLVER, ks, *market,
            dividends=GOLDEN_DIVIDENDS, rate_schedule=curve),
        "greeks": lambda: batch_greeks(
            BOOK_SPEC, BOOK_SOLVER, ks, *market, american=True,
            dividends=GOLDEN_DIVIDENDS),
        "surface": lambda: fused_do.fused_surface_batch(
            BOOK_SPEC, BOOK_SOLVER, ks, *market, american=True),
    }
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call()
            torch.cuda.synchronize()
        spans = {e.name for e in prof.events()
                 if e.name.startswith("heston.")}
        if name == "book":
            assert {"heston.book_plan", "heston.loop"} <= spans, spans
            assert not spans & {"heston.assemble", "heston.remaps"}, spans
        else:
            assert "heston.assemble" in spans, (name, spans)


# the risk Jacobian's card route (fused_do.packed_jacobian): the book's
# plan kernel, the tangent-rows kernel and kernel 1's forward mode
# straight from both, against the host route (linearized_jacobian: the
# vmap over jvp of the assembly, run on the same CUDA tensors), on the
# risk cell's book (5,000 American calls with the golden dividends, 10
# maturity groups of 2, 4, ..., 20 steps x 500 strikes, 51 x 26 upwind)
# and on a 250-lane sub-book of it (every 20th option, every maturity)
RISK_GROUPS = tuple((500 * i, 500 * (i + 1), 2 * (i + 1)) for i in range(10))
RISK_BOOKS = {"cell5000": slice(None), "sub250": slice(None, None, 20)}


def _risk_jacobian_args(device, dtype, book):
    from heston_tpu_torch.models import douglas

    pick = RISK_BOOKS[book]
    ks = torch.linspace(70.0, 130.0, 500, dtype=torch.float64).repeat(10)
    market = _market(5000)
    theta = torch.tensor(market[:5], dtype=dtype, device=device)
    return ((BOOK_SPEC, BOOK_SOLVER, ks[pick].to(device, dtype), 100.0,
             theta, *market[5:]),
            dict(american=True, dividends=GOLDEN_DIVIDENDS,
                 n_steps_per=douglas.lane_steps(RISK_GROUPS)[pick]))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("book", sorted(RISK_BOOKS))
def test_tangent_rows_kernel_matches_the_host_route(cuda_device, book,
                                                    dtype):
    """One launch of the tangent-rows kernel from the card plan: every
    row (sfac's, the eight v-rows of each of the four directions) bitwise
    the host's JVP of the assembly on the card, packed as the forward
    mode reads it, and bitwise its own plain version on the CPU."""
    (spec, solver, ks, s0, theta, r_d, r_f), kw = _risk_jacobian_args(
        cuda_device, PLAN_DTYPES[dtype], book)
    plan = fused_do.device_book_plan(spec, solver, ks, s0, *theta.unbind(),
                                     r_d, r_f, **kw)
    before = fused_do.tangent_rows.launches
    got = fused_do.tangent_rows(plan, theta, solver.a2_variant)
    torch.cuda.synchronize()
    assert fused_do.tangent_rows.launches == before + 1
    fields, tangents, _, _, _ = fused_do._linearized_assemble(
        spec, solver, ks, s0, theta, r_d, r_f,
        kw["n_steps_per"].to(cuda_device))
    want = fused_do._pack_tangents(fields, tangents, True)[:2]
    cpu_plan = fused_do.BookPlan(*(x.cpu() if torch.is_tensor(x) else x
                                   for x in plan))
    plain = fused_do.tangent_rows(cpu_plan, theta.cpu(), solver.a2_variant)
    for g, w, p in zip(got, want, plain):
        assert g.shape == w.shape
        assert torch.equal(g, w) and torch.equal(g.cpu(), p)
        assert torch.equal(torch.signbit(g), torch.signbit(w))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(PLAN_DTYPES))
@pytest.mark.parametrize("book", sorted(RISK_BOOKS))
def test_card_jacobian_matches_the_host_route(cuda_device, book, dtype):
    """fused_theta_jacobian on the card (the card route: one plan-kernel,
    one tangent-rows and one forward-mode launch, no host assembly)
    against the host route on the same CUDA tensors: the prices bitwise,
    each Jacobian column within 1e-12 of its largest value in float64
    (float32: 1e-5)."""
    args, kw = _risk_jacobian_args(cuda_device, PLAN_DTYPES[dtype], book)

    def counters():
        return (fused_do.device_book_plan.launches,
                fused_do.tangent_rows.launches,
                fused_do.fused_do_loop.tangent_launches,
                fused_do.fused_do_loop.launches, assembly.assemble.calls)

    before = counters()
    base, jac = fused_do.fused_theta_jacobian(*args, **kw)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counters(), before)] == [1, 1, 1, 0, 0]
    want_base, want_jac = fused_do.linearized_jacobian(*args, **kw)
    assert torch.equal(base, want_base)
    rel = ((jac - want_jac).abs().amax(0)
           / want_jac.abs().amax(0).clamp(min=1e-300))
    tol = 1e-12 if dtype == "f64" else 1e-5
    assert bool((rel <= tol).all()), rel.tolist()


@pytest.mark.cuda
def test_batch_greeks_jacobian_takes_the_card_plan(cuda_device):
    """One batch_greeks(..., param_jacobian=True) call on the card, the
    risk cell's traffic on a 250-lane sub-book: the surfaces' host plan
    and primal launch, then the Jacobian's card plan, one tangent-rows
    launch and one forward-mode launch; one host assembly, not two."""
    from heston_tpu_torch.models import greeks

    args, kw = _risk_jacobian_args(cuda_device, torch.float64, "sub250")
    spec, solver, ks, s0, theta, r_d, r_f = args
    groups = tuple((25 * i, 25 * (i + 1), 2 * (i + 1)) for i in range(10))
    greeks.batch_greeks(spec, solver, ks, s0, *theta.tolist(), r_d, r_f,
                        american=True, dividends=GOLDEN_DIVIDENDS,
                        group_steps=groups, param_jacobian=True)

    def counters():
        return (fused_do.device_book_plan.launches,
                fused_do.tangent_rows.launches, assembly.assemble.calls,
                fused_do.fused_do_loop.launches,
                fused_do.fused_do_loop.tangent_launches)

    before = counters()
    out = greeks.batch_greeks(spec, solver, ks, s0, *theta.tolist(), r_d,
                              r_f, american=True, dividends=GOLDEN_DIVIDENDS,
                              group_steps=groups, param_jacobian=True)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counters(), before)] == [1, 1, 1, 1, 1]
    assert out["param_jacobian"].shape == (250, 5)
    assert bool(torch.isfinite(out["param_jacobian"]).all())

"""The risk Jacobian's card route on the CPU: the forward mode's tangent
rows written out (`fused_do.tangent_rows`, whose plain version the CPU
runs) against the host's vmap over jvp of the assembly
(`_linearized_assemble`, packed by `_pack_tangents`), and the whole
packed route (`packed_jacobian`: the packed plan, the rows, one
forward-mode launch a phase straight from both) against the host route
(`linearized_jacobian`), on mixed-maturity books, calls and puts,
European and American, with and without Rannacher, a knock-out book,
both A2 variants, the Douglas scheme and the three correctors, float32
and float64. Every row and every number comes
out bitwise. Then which calls take which route. No card and no JAX;
tests/test_torch_cuda.py holds the tangent-rows kernel and the card
route against the host route on the card.
"""

import dataclasses

import pytest
import torch

from heston_tpu_torch.config import (GOLDEN_DIVIDENDS, Barrier, GridSpec,
                                     HestonParams, RateSchedule,
                                     SolverConfig)
from heston_tpu_torch.kernels import assembly, fused_do

P = HestonParams()
# m2 = 16 puts v-nodes above 1 (1.37 at row 14), where upwind's rows act
SPEC = GridSpec(m1=20, m2=16)
SOLVER = SolverConfig(n_steps=8, a2_variant="upwind", solver_engine="pallas")
STRIKES = [85.0, 92.5, 97.5, 100.0, 107.5, 115.0]
MIXED = [8, 3, 1, 2, 6, 8]
CASES = {
    "call_euro": dict(),
    "call_amer_div_mixed": dict(american=True, dividends=GOLDEN_DIVIDENDS,
                                n_steps_per=MIXED),
    "put_amer_div": dict(option_type="put", american=True,
                         dividends=GOLDEN_DIVIDENDS),
    "put_euro_mixed": dict(option_type="put", n_steps_per=MIXED),
    "rannacher_amer_div_mixed": dict(
        american=True, dividends=GOLDEN_DIVIDENDS, n_steps_per=MIXED,
        solver=dataclasses.replace(SOLVER, rannacher_steps=2)),
    "rannacher_central_euro": dict(solver=dataclasses.replace(
        SOLVER, a2_variant="central", rannacher_steps=2)),
    "up_out_div_mixed": dict(dividends=GOLDEN_DIVIDENDS, n_steps_per=MIXED,
                             spec=dataclasses.replace(
                                 SPEC, barrier=Barrier("up-out", 140.0))),
    # the corrector schemes: the tangent rows are the scheme's own, the
    # forward mode adds the tangent corrector stages
    "cs_put_div_mixed": dict(option_type="put", dividends=GOLDEN_DIVIDENDS,
                             n_steps_per=MIXED, solver=dataclasses.replace(
                                 SOLVER, scheme="cs")),
    "mcs_amer_div_mixed": dict(american=True, dividends=GOLDEN_DIVIDENDS,
                               n_steps_per=MIXED, solver=dataclasses.replace(
                                   SOLVER, scheme="mcs")),
    "hv_rannacher_amer": dict(american=True, solver=dataclasses.replace(
        SOLVER, scheme="hv", rannacher_steps=2)),
    "cell_grid_amer_div_mixed": dict(
        american=True, dividends=GOLDEN_DIVIDENDS, n_steps_per=[20, 4, 12],
        strikes=[70.0, 100.0, 130.0], spec=GridSpec(m1=50, m2=25),
        solver=dataclasses.replace(SOLVER, n_steps=20)),
}
DTYPES = {"f32": torch.float32, "f64": torch.float64}
# a market off the defaults, so that no tangent is a round number
THETA = (1.7, 0.045, 0.35, -0.72, 0.037)


def _args(case, dtype):
    kw = dict(CASES[case])
    spec = kw.pop("spec", SPEC)
    solver = kw.pop("solver", SOLVER)
    strikes = torch.tensor(kw.pop("strikes", STRIKES), dtype=dtype)
    theta = torch.tensor(THETA, dtype=dtype)
    return (spec, solver, strikes, 100.0, theta, P.r_d, P.r_f), kw


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_tangent_rows_match_the_linearized_assembly(case, dtype):
    """tangent_rows (its plain version) from the book's packed plan
    against the host's JVP of the assembly, packed as the forward-mode
    launch reads it: every row bitwise, signed zeros included (sfac's
    sigma and rho rows, al2, al1, au1, au2 along kappa, eta and sigma;
    vfl, vfac and the beta_v weights zero), and nothing launched."""
    (spec, solver, strikes, s0, theta, r_d, r_f), kw = _args(case,
                                                             DTYPES[dtype])
    nst = kw.get("n_steps_per")
    nst = None if nst is None else torch.tensor(nst)
    fields, tangents, _, _, _ = fused_do._linearized_assemble(
        spec, solver, strikes, s0, theta, r_d, r_f, nst,
        kw.get("option_type", "call"))
    want = fused_do._pack_tangents(fields, tangents, False)[:2]
    plan = fused_do.device_book_plan(spec, solver, strikes, s0,
                                     *theta.unbind(), r_d, r_f, **kw)
    before = fused_do.tangent_rows.launches
    tsf, tvf = fused_do.tangent_rows(plan, theta, solver.a2_variant)
    assert fused_do.tangent_rows.launches == before
    rows = [("sfac", tsf, want[0])] + [
        (k, tvf[:, :, f], want[1][:, :, f])
        for f, k in enumerate(fused_do._KERNEL_TV_KEYS)]
    for name, got, ref in rows:
        assert (got.dtype, got.shape) == (ref.dtype, ref.shape), name
        assert torch.equal(got, ref), name
        assert torch.equal(torch.signbit(got), torch.signbit(ref)), name
    moving = {k for k, got, _ in rows if bool(got.abs().max() > 0)}
    assert {"sfac", "al1", "au1", "au2"} <= moving
    assert not moving & {"vfl", "vfac", "bvm", "bvp"}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_packed_jacobian_matches_the_host_route(case, dtype):
    """The card route's arithmetic on the CPU (the packed plan, the plain
    tangent rows, the plain forward-mode loop a phase from the packed
    buffers, the tangent state handed from the damp phase to the main
    one): prices and all five Jacobian columns bitwise the host route's,
    with one plan and no host assembly."""
    args, kw = _args(case, DTYPES[dtype])
    want = fused_do.linearized_jacobian(*args, **kw)
    before = fused_do.book_plan.calls
    got = fused_do.packed_jacobian(*args, **kw)
    assert fused_do.book_plan.calls == before + 1
    for g, w in zip(got, want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape)
        assert torch.equal(g, w)


def test_tangent_rows_refuse_what_they_cannot_read():
    (spec, solver, strikes, s0, theta, r_d, r_f), kw = _args("call_euro",
                                                             torch.float64)
    plan = fused_do.device_book_plan(spec, solver, strikes, s0,
                                     *theta.unbind(), r_d, r_f)
    with pytest.raises(ValueError, match="A2 variant"):
        fused_do.tangent_rows(plan, theta, "central2")
    with pytest.raises(ValueError, match="theta_vec"):
        fused_do.tangent_rows(plan, theta.float(), "upwind")
    for short in (theta[:3], theta[0]):
        with pytest.raises(ValueError, match="theta_vec"):
            fused_do.tangent_rows(plan, short, "upwind")


class _Taken(Exception):
    """Raised by a stubbed route, naming it."""


def _stub_routes(monkeypatch):
    """Stub both of fused_theta_jacobian's routes: each raises _Taken
    with its name."""
    def stub(name):
        def route(*args, **kw):
            raise _Taken(name)
        return route

    monkeypatch.setattr(fused_do, "packed_jacobian", stub("packed"))
    monkeypatch.setattr(fused_do, "linearized_jacobian", stub("host"))


def _route(*args, **kw):
    with pytest.raises(_Taken) as taken:
        fused_do.fused_theta_jacobian(*args, **kw)
    return str(taken.value)


def test_the_route_follows_device_and_v0_mode(monkeypatch):
    """fused_theta_jacobian takes the card plan only for CUDA strikes
    under v0_mode "stencil": CPU strikes take the host route in either
    mode, and so do CUDA strikes under v0_mode "ad" (whose v0 direction
    moves the v-grid). The device is what `on_card` reports, stubbed
    here to stand for CUDA strikes."""
    args, _ = _args("call_amer_div_mixed", torch.float64)
    _stub_routes(monkeypatch)
    assert _route(*args) == "host"
    assert _route(*args, v0_mode="ad") == "host"
    monkeypatch.setattr(fused_do, "on_card", lambda t, what: True)
    assert _route(*args) == "packed"
    assert _route(*args, v0_mode="stencil") == "packed"
    assert _route(*args, v0_mode="ad") == "host"
    with pytest.raises(ValueError, match="v0_mode"):
        fused_do.fused_theta_jacobian(*args, v0_mode="bump")


@pytest.mark.parametrize("engine", ["pallas", "scan"])
def test_curve_books_and_the_eager_engines_keep_their_route(monkeypatch,
                                                           engine):
    """batch_greeks' Jacobian of a curve book (under every engine) and of
    a flat book under the eager engines never enters
    fused_theta_jacobian, so neither the card plan nor the tangent-rows
    kernel: they linearize the eager loop."""
    from heston_tpu_torch.models import greeks

    def refuse(*args, **kw):
        raise AssertionError("fused_theta_jacobian entered")

    monkeypatch.setattr(fused_do, "fused_theta_jacobian", refuse)
    solver = SolverConfig(n_steps=4, solver_engine=engine)
    ks = torch.tensor([95.0, 105.0], dtype=torch.float64)
    market = (100.0, *THETA[:5], P.r_d, P.r_f)
    curve = RateSchedule(times=(0.5,), r_d=(0.02, 0.03), r_f=(0.0, 0.01))
    before = (fused_do.tangent_rows.launches,
              fused_do.device_book_plan.launches)
    books = [dict(rate_schedule=curve)]
    if engine != "pallas":
        books.append({})
    for kw in books:
        out = greeks.batch_greeks(GridSpec(m1=12, m2=8), solver, ks,
                                  *market, american=True,
                                  param_jacobian=True, device="cpu", **kw)
        assert out["param_jacobian"].shape == (2, 5)
    assert before == (fused_do.tangent_rows.launches,
                      fused_do.device_book_plan.launches)


def test_the_host_route_keeps_its_assembly():
    """On the CPU fused_theta_jacobian is the host route: one host
    assembly under the linearization, no book plan, in either v0_mode."""
    args, kw = _args("call_amer_div_mixed", torch.float64)
    for mode in ("stencil", "ad"):
        before = (assembly.assemble.calls, fused_do.book_plan.calls)
        got = fused_do.fused_theta_jacobian(*args, **kw, v0_mode=mode)
        assert (assembly.assemble.calls - before[0],
                fused_do.book_plan.calls - before[1]) == (1, 0)
        want = fused_do.linearized_jacobian(*args, **kw, v0_mode=mode)
        for g, w in zip(got, want):
            assert torch.equal(g, w)

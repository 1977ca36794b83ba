"""The port's spans (`utils.profiling.scope`) on the single-option path,
on the CPU: which spans a quote records under a profiler and how they
nest, that they record nothing without one, and that they leave every
number the same, inside torch.func transforms too. No JAX."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import heston_tpu_torch
from heston_tpu_torch import (GOLDEN_DIVIDENDS, GridSpec, HestonParams,
                              SolverConfig)
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.utils import profiling

SPEC = GridSpec(m1=20, m2=10)
SOLVER = SolverConfig(n_steps=4, solver_engine="pallas")
P = HestonParams()
PRODUCTS = {"european": dict(),
            "american_dividends": dict(american=True,
                                       dividends=GOLDEN_DIVIDENDS)}
SPANS = {"heston.price_batch", "heston.single_plan", "heston.assemble",
         "heston.remaps", "heston.loop"}


def quote(**kw):
    return heston_tpu_torch.price_batch(
        SPEC, SOLVER, torch.tensor([97.5], dtype=torch.float64), 100.0,
        P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f, device="cpu",
        **kw)


def profiled(fn):
    """fn's result and the `heston.*` spans recorded while it ran, as
    {name: [(start, end), ...]}."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = {}
    for e in prof.events():
        if e.name.startswith(profiling.PREFIX):
            assert e.is_user_annotation
            spans.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out, spans


def inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_a_quote_records_the_five_spans_nested(product):
    """price_batch holds single_plan, which holds assemble and the remaps
    (one a phase); the loop (one a phase) is in price_batch, after the
    plan and outside it."""
    _, spans = profiled(lambda: quote(**PRODUCTS[product]))
    assert set(spans) == SPANS
    assert all(len(spans[name]) == 1 for name in SPANS)
    (entry,) = spans["heston.price_batch"]
    (plan,) = spans["heston.single_plan"]
    (assemble,), (remaps,) = spans["heston.assemble"], spans["heston.remaps"]
    (loop,) = spans["heston.loop"]
    assert inside(plan, entry) and inside(loop, entry)
    assert inside(assemble, plan) and inside(remaps, plan)
    assert loop[0] >= plan[1]


@pytest.mark.parametrize("product", sorted(PRODUCTS))
def test_prices_are_bitwise_the_same_under_a_profiler(product):
    off = quote(**PRODUCTS[product])
    on, spans = profiled(lambda: quote(**PRODUCTS[product]))
    assert spans and torch.equal(on, off)


def test_no_profiler_no_record_function(monkeypatch):
    """Without a profiler session, a span is one shared no-op context and
    enters no record_function, as a context or as a decorator; under one,
    it does."""
    def refuse(self):
        raise RuntimeError("record_function entered")

    monkeypatch.setattr(torch.profiler.record_function, "__enter__", refuse)
    assert profiling.scope("a") is profiling.scope("a")
    with profiling.scope("a"):
        pass
    assert torch.isfinite(quote(**PRODUCTS["american_dividends"])).all()
    with pytest.raises(RuntimeError, match="record_function entered"):
        profiled(lambda: quote())


def test_decorated_functions_record_only_under_a_profiler():
    calls = []

    @profiling.scope("probe")
    def probe(x):
        calls.append(x)
        return 2 * x

    assert probe(3) == 6
    out, spans = profiled(lambda: probe(4))
    assert out == 8 and calls == [3, 4]
    assert list(spans) == ["heston.probe"] and len(spans["heston.probe"]) == 1
    assert probe.__name__ == "probe"


def test_linearized_assembly_is_bitwise_the_same_under_a_profiler():
    """The span inside `_assemble` runs under vmap over jvp and changes
    none of the fields or tangents."""
    theta = torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0],
                         dtype=torch.float64)
    strikes = torch.tensor([90.0, 100.0, 110.0], dtype=torch.float64)

    def linearized():
        return fused_do._linearized_assemble(SPEC, SOLVER, strikes, 100.0,
                                             theta, P.r_d, P.r_f)

    off = linearized()
    on, spans = profiled(linearized)
    assert "heston.assemble" in spans
    f_off, t_off, *rest_off = off
    f_on, t_on, *rest_on = on
    assert set(f_on) == set(f_off)
    assert all(torch.equal(f_on[k], f_off[k]) for k in f_off)
    assert len(t_on) == len(t_off) == fused_do.JAC_TANGENTS
    for a, b in zip(t_on, t_off):
        assert all(torch.equal(a[k], b[k]) for k in b)
    assert all(torch.equal(a, b) for a, b in zip(rest_on, rest_off))


BOOK_GROUPS = ((0, 3, 2), (3, 6, 4))


def mixed_book():
    return heston_tpu_torch.price_batch(
        SPEC, SOLVER, torch.tensor([90.0, 100.0, 110.0] * 2,
                                   dtype=torch.float64), 100.0,
        P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f, american=True,
        dividends=GOLDEN_DIVIDENDS, device="cpu", group_steps=BOOK_GROUPS)


def test_a_book_records_book_plan_inside_price_batch():
    """A mixed book's price_batch holds one book_plan, which holds the
    assembly and the remaps (one phase); the loop follows the plan.
    Read through the benchmark's own span reader, inside a request span."""
    from perfbench import spans as span_reader
    from perfbench.trace import REQUEST_SPAN

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(REQUEST_SPAN):
            mixed_book()
    events = prof.events()
    read = span_reader.read(events)
    assert {name: read[name]["count"] for name in read} == {
        "heston.price_batch": 1, "heston.book_plan": 1,
        "heston.assemble": 1, "heston.remaps": 1, "heston.loop": 1}
    at = {e.name: (e.time_range.start, e.time_range.end) for e in events
          if e.name.startswith(profiling.PREFIX)}
    assert inside(at["heston.book_plan"], at["heston.price_batch"])
    assert inside(at["heston.assemble"], at["heston.book_plan"])
    assert inside(at["heston.remaps"], at["heston.book_plan"])
    assert inside(at["heston.loop"], at["heston.price_batch"])
    assert at["heston.loop"][0] >= at["heston.book_plan"][1]


def test_book_plan_without_a_profiler_enters_no_record_function(
        monkeypatch):
    """Without a session the book plan's wrapper opens no span (the shared
    no-op), and its prices are bitwise those it gives under a session."""
    off = mixed_book()
    on, spans = profiled(mixed_book)
    assert "heston.book_plan" in spans and torch.equal(on, off)

    def refuse(self):
        raise RuntimeError("record_function entered")

    monkeypatch.setattr(torch.profiler.record_function, "__enter__", refuse)
    assert profiling.scope("book_plan") is profiling.scope("book_plan")
    assert torch.equal(mixed_book(), off)


def book_risk():
    out = heston_tpu_torch.batch_greeks(
        SPEC, SOLVER, torch.tensor([90.0, 100.0, 110.0] * 2,
                                   dtype=torch.float64), 100.0,
        P.kappa, P.eta, P.sigma, P.rho, P.v0, P.r_d, P.r_f, american=True,
        dividends=GOLDEN_DIVIDENDS, device="cpu", group_steps=BOOK_GROUPS,
        param_jacobian=True)
    return torch.cat([torch.stack([out[k] for k in heston_tpu_torch.RISK_KEYS],
                                  1), out["param_jacobian"]], 1)


def test_book_risk_records_its_spans_nested_and_bitwise():
    """A risk call's batch_greeks holds the surfaces' book_plan and loop,
    the risk_epilogue after them, and the jacobian, which holds the
    linearize (holding its assemble), its remaps and the forward-mode
    loop; its columns are bitwise those it gives without a profiler."""
    off = book_risk()
    on, spans = profiled(book_risk)
    assert torch.equal(on, off)
    assert {name: len(v) for name, v in spans.items()} == {
        "heston.batch_greeks": 1, "heston.book_plan": 1,
        "heston.assemble": 2, "heston.remaps": 2, "heston.loop": 2,
        "heston.risk_epilogue": 1, "heston.jacobian": 1,
        "heston.linearize": 1}
    (entry,) = spans["heston.batch_greeks"]
    (plan,), (epilogue,) = spans["heston.book_plan"], spans[
        "heston.risk_epilogue"]
    (jac,), (lin,) = spans["heston.jacobian"], spans["heston.linearize"]
    surface_loop, jac_loop = sorted(spans["heston.loop"])
    plan_assemble, lin_assemble = sorted(spans["heston.assemble"])
    plan_remaps, jac_remaps = sorted(spans["heston.remaps"])
    for span in (plan, surface_loop, epilogue, jac):
        assert inside(span, entry)
    assert plan[1] <= surface_loop[0] and surface_loop[1] <= epilogue[0]
    assert epilogue[1] <= jac[0]
    assert inside(plan_assemble, plan) and inside(plan_remaps, plan)
    assert inside(lin, jac) and inside(jac_remaps, jac)
    assert inside(jac_loop, jac)
    assert inside(lin_assemble, lin) and lin[1] <= jac_loop[0]


def test_book_risk_counters_move_by_one_call():
    """One risk call of 6 options: one batch_greeks call of 6 lanes, two
    host assemblies (the surfaces' plan and the linearization), one book
    plan. (Kernel 1's launches count on the card only; its spans here
    show the two passes.)"""
    from heston_tpu_torch.kernels import assembly
    from heston_tpu_torch.models import greeks

    def read():
        return {"greeks.calls": greeks.BATCH_GREEKS["calls"],
                "greeks.lanes": greeks.BATCH_GREEKS["lanes"],
                "assemble.calls": assembly.assemble.calls,
                "book_plan.calls": fused_do.book_plan.calls}

    before = read()
    book_risk()
    after = read()
    assert {k: after[k] - before[k] for k in before} == {
        "greeks.calls": 1, "greeks.lanes": 6, "assemble.calls": 2,
        "book_plan.calls": 1}


def test_book_risk_without_a_profiler_enters_no_record_function(
        monkeypatch):
    """Without a profiler none of the risk call's spans (batch_greeks,
    risk_epilogue, jacobian, linearize) enters a record_function."""
    def refuse(self):
        raise RuntimeError("record_function entered")

    monkeypatch.setattr(torch.profiler.record_function, "__enter__", refuse)
    assert torch.isfinite(book_risk()).all()


def fit():
    from heston_tpu_torch import CalibrationConfig
    from heston_tpu_torch.models import calibration

    ks = torch.tensor([90.0, 100.0, 110.0] * 2, dtype=torch.float64)
    market = heston_tpu_torch.price_batch(
        SPEC, SOLVER, ks, 100.0, 2.0, 0.05, 0.4, -0.6, 0.05, P.r_d, P.r_f,
        american=True, dividends=GOLDEN_DIVIDENDS, device="cpu",
        group_steps=BOOK_GROUPS)
    return calibration.calibrate_device(
        SPEC, SOLVER, ks, market, 100.0,
        torch.tensor([P.kappa, P.eta, P.sigma, P.rho, P.v0],
                     dtype=torch.float64), P.r_d, P.r_f,
        cfg=CalibrationConfig(max_iter=2, tol=1e-12, jacobian_mode="ad"),
        american=True, dividends=GOLDEN_DIVIDENDS, group_steps=BOOK_GROUPS,
        device="cpu")


def test_a_fit_records_one_span_an_iteration_and_counts_its_reads():
    """A fit's calibrate_device holds one lm_iteration an iteration, in
    order; each holds the Jacobian pass's jacobian and the trial's
    book_plan and loop. The counters move by one call, its iterations
    and one read of the stop flag an iteration; the fit is bitwise the
    one it gives without a profiler."""
    from heston_tpu_torch.models import calibration

    def counts():
        fn = calibration.calibrate_device
        return fn.calls, fn.iterations, fn.host_reads

    off = fit()
    before = counts()
    on, spans = profiled(fit)
    it = on[1]["iterations"]
    assert it == 2 and torch.equal(on[0], off[0])
    assert [a - b for a, b in zip(counts(), before)] == [1, it, it]
    (entry,) = spans["heston.calibrate_device"]
    iters = sorted(spans["heston.lm_iteration"])
    assert len(iters) == it
    assert all(inside(span, entry) for span in iters)
    assert all(a[1] <= b[0] for a, b in zip(iters, iters[1:]))
    for name in ("heston.jacobian", "heston.book_plan"):
        assert [sum(inside(s, span) for s in spans[name])
                for span in iters] == [1] * it, name
    # the trial's loop and the Jacobian's forward-mode loop
    assert [sum(inside(s, span) for s in spans["heston.loop"])
            for span in iters] == [2] * it

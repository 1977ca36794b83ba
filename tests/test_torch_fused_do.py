"""heston_tpu_torch.kernels.fused_do against heston_tpu.pallas.fused_do:
the host-side assembly, the dividend remap fields, and the plain time loop
fed the JAX package's own fields against its Pallas kernel run in
interpret mode — primal and forward mode (tangent fields, the linearized
assembly, the calibration Jacobian), uniform and mixed-maturity books
(per-option step counts). float64 on the CPU; the CUDA kernel itself is
compared with the plain version on the card in tests/test_torch_cuda.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, DividendSchedule, GridSpec,
                               HestonParams, SolverConfig)
from heston_tpu.ops import operators as jops
from heston_tpu.pallas import fused_do as jfd
from heston_tpu_torch.convert import fields_from_jax, tangent_fields_from_jax
from heston_tpu_torch.kernels import assembly, fused_do

from torch_parity import assert_close, npy, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

SEED = 7
SPEC = GridSpec(m1=10, m2=8)
SOLVER = SolverConfig(n_steps=6, a2_variant="upwind", solver_engine="pallas")
ARMS = {
    "euro": dict(american=False, dividends=None),
    "amer": dict(american=True, dividends=None),
    "div": dict(american=False, dividends=GOLDEN_DIVIDENDS),
    "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS),
}
# 12 events at N = 24: two launches of the JAX kernel (8 events each at
# most), one launch of the port's
TWELVE_DIVIDENDS = DividendSchedule(
    dates=tuple((n + 0.5) / 24.0 for n in range(1, 24, 2)),
    amounts=tuple(0.05 * (1 + k % 4) for k in range(12)),
    percentages=(0.01,) * 12)


def _jax_fields(spec, solver, strikes, p, r_f, nsteps=None):
    fields, vec_s, idx_s, idx_v, _ = jfd._assemble(
        spec, solver, jnp.asarray(strikes), 100.0, *param_args(p, r_f),
        nsteps_p=None if nsteps is None else jnp.asarray(nsteps))
    fields["rf_val"] = jops.boundary_rate(p.r_d, r_f, "call")
    return fields, vec_s, idx_s, idx_v


def _to_numpy(fields):
    return {k: v if isinstance(v, float) else np.asarray(v)
            for k, v in fields.items()}


@pytest.mark.parametrize("nsteps", [None, [5, 1, 3, 4, 2]])
def test_remap_fields_match_jax(params, nsteps):
    """Exact indices, weights at 1e-15. The events cover the golden
    schedule, a cash dividend large enough to push the low nodes below
    s = 0 (calls zero them), and a negative amount that pushes the top
    nodes past s_max (index > m1 maps to 0: copy column 0). With
    per-option step counts, a lane that stops before an event's step
    gets the identity row there."""
    rng = np.random.default_rng(SEED)
    strikes = rng.uniform(70.0, 130.0, 5)
    _, vec_s, _, _ = _jax_fields(SPEC, SOLVER, strikes, params, 0.0)
    events = [(1, 0.5, 0.02), (2, 0.3, 0.0), (3, 40.0, 0.01),
              (4, -50.0, 0.0), (5, 0.0, 0.5)]
    want = jfd._build_remap_fields(
        vec_s, events, vec_s.dtype,
        nsteps=None if nsteps is None else jnp.asarray(nsteps))
    got = assembly.build_remap_fields(
        t64(vec_s), events, None if nsteps is None else torch.tensor(nsteps))
    for (gi0, gw0, gi1, gw1), (wi0, ww0, wi1, ww1) in zip(got, want):
        assert gi0.dtype == torch.int64 and gi1.dtype == torch.int64
        np.testing.assert_array_equal(npy(gi0), np.asarray(wi0))
        np.testing.assert_array_equal(npy(gi1), np.asarray(wi1))
        assert_close(gw0, ww0, rtol=0, atol=1e-15)
        assert_close(gw1, ww1, rtol=0, atol=1e-15)
        # Sterbenz pairing: each pair sums to exactly 1 (or 0)
        total = npy(gw0 + gw1)
        assert np.all((total == 1.0) | (total == 0.0))


@pytest.mark.parametrize("r_f,nsteps", [(0.0, None), (0.01, None),
                                         (0.01, [6, 2, 1, 4])])
def test_assemble_fields_match_jax(params, r_f, nsteps):
    """Every field of the port's assembly against the JAX package's,
    carried across with fields_from_jax, at 1e-12; K = 10 is the 8K < S0
    quirk (spot node dropped, index 0). Per-option step counts scale each
    option's boundary data by its own e^{-r_f dt (n_i - 1)} and come
    across as the int64 field "nst"."""
    spec = GridSpec(m1=12, m2=9)
    strikes = np.array([10.0, 85.0, 100.0, 117.5])
    jf, _, jidx_s, jidx_v = _jax_fields(spec, SOLVER, strikes, params, r_f,
                                        nsteps)
    want = fields_from_jax(_to_numpy(jf))
    got, vec_s, idx_s, idx_v, _ = assembly.assemble(
        port_cfg(spec), port_cfg(SOLVER), t64(strikes), 100.0,
        *param_args(params, r_f),
        None if nsteps is None else torch.tensor(nsteps))
    if nsteps is not None:
        assert want["nst"].dtype == torch.int64
        assert torch.equal(got["nst"], want["nst"])
    assert set(got) == set(want) - {"rf_val"}
    for k in got:
        assert got[k].shape == want[k].shape, k
        assert_close(got[k], want[k], err_msg=k)
    assert_close(vec_s, want["vecs"])
    np.testing.assert_array_equal(npy(idx_s), np.asarray(jidx_s))
    np.testing.assert_array_equal(npy(idx_v), np.asarray(jidx_v))
    assert int(idx_s[0]) == 0


def _run_both(spec, solver, strikes, p, r_f, american, dividends):
    """JAX _run_chunks in interpret mode and the port's plain loop on the
    same (JAX-assembled) fields; both as [B, ns, nv] numpy arrays."""
    jstrikes, tile, n_tiles, _ = jfd._pad_strikes(
        spec, jnp.asarray(strikes), strict=False)
    jf, vec_s, _, _ = _jax_fields(spec, solver, np.asarray(jstrikes), p, r_f)
    want, _, _ = jfd._run_chunks(spec, solver, american, dividends,
                                 jf["u"].dtype, True, False, n_tiles, tile,
                                 jf, vec_s)
    tf = fields_from_jax(_to_numpy(jf))
    events = assembly.dividend_plan(port_cfg(solver), port_cfg(dividends))
    remaps = assembly.build_remap_fields(tf["vecs"], events)
    got, _ = fused_do.fused_do_reference(
        tf, [e[0] for e in events], remaps, theta=solver.theta,
        delta_t=solver.delta_t, n_steps=solver.n_steps, rf=tf["rf_val"],
        american=american)
    return npy(got), np.asarray(want).transpose(2, 0, 1)


@pytest.mark.parametrize("r_f", [0.0, 0.01])
@pytest.mark.parametrize("arm", sorted(ARMS))
def test_plain_loop_matches_jax_kernel(params, arm, r_f):
    """The plain time loop fed the JAX package's own fields equals the
    Pallas kernel (interpret mode) on every grid point at 1e-11. r_f =
    0.01 makes the per-step boundary coefficients grow (kb2b != 0)."""
    strikes = np.linspace(80.0, 120.0, 6)
    got, want = _run_both(SPEC, SOLVER, strikes, params, r_f, **ARMS[arm])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


def test_twelve_dividends_in_one_launch(params):
    """A 12-event schedule at N = 24: the JAX kernel runs it as two
    launches (at most 8 events each), the port's loop as one; the
    surfaces agree."""
    solver = SolverConfig(n_steps=24, solver_engine="pallas")
    chunks = jfd._chunk_dividend_plan(solver, TWELVE_DIVIDENDS)
    assert len(chunks) == 2
    plan = assembly.dividend_plan(port_cfg(solver),
                                  port_cfg(TWELVE_DIVIDENDS))
    assert len(plan) == 12
    got, want = _run_both(SPEC, solver, np.linspace(85.0, 115.0, 4), params,
                          0.0, american=True, dividends=TWELVE_DIVIDENDS)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)


@pytest.mark.parametrize("n_steps,dividends", [
    (20, GOLDEN_DIVIDENDS), (6, GOLDEN_DIVIDENDS), (24, TWELVE_DIVIDENDS),
    (20, None)])
def test_dividend_plan_matches_jax_chunks(n_steps, dividends):
    """The port's single event list is the JAX chunk plan flattened: the
    same (step, amount, pct) in the same order."""
    solver = SolverConfig(n_steps=n_steps)
    want = []
    if dividends is not None:
        for _plan, events in jfd._chunk_dividend_plan(solver, dividends):
            want.extend(events)
    assert assembly.dividend_plan(port_cfg(solver),
                                  port_cfg(dividends)) == want


@pytest.mark.parametrize("phases", ["main", "damp", "damp_main"])
def test_plain_loop_carries_lambda_like_jax(params, phases):
    """A nonzero input multiplier (an American state handed over from an
    earlier launch): the plain loop and JAX's Pallas kernel (interpret
    mode) convert it at the launch boundary the same way, dt*lam in and
    lam/dt out — at delta_t (one main launch), at delta_t/2 (a damp launch
    at theta = 1 over the whole horizon, N = 4: the golden dividends of
    main steps 1, 2, 3 at its sub-steps 1, 3, 5), and
    across a damp and a main launch. Surfaces and multipliers at 1e-11."""
    solver = {"main": SOLVER,
              "damp": dataclasses.replace(SOLVER, n_steps=4,
                                          rannacher_steps=4),
              "damp_main": dataclasses.replace(SOLVER,
                                               rannacher_steps=2)}[phases]
    jstrikes, tile, n_tiles, _ = jfd._pad_strikes(
        SPEC, jnp.asarray(np.linspace(85.0, 115.0, 4)), strict=False)
    jf, vec_s, _, _ = _jax_fields(SPEC, solver, np.asarray(jstrikes), params,
                                  0.0)
    jf["lam"] = jnp.asarray(np.random.default_rng(SEED).uniform(
        0.0, 0.5, jf["lam"].shape))
    want_u, want_lam, _ = jfd._run_chunks(
        SPEC, solver, True, GOLDEN_DIVIDENDS, jf["u"].dtype, True, False,
        n_tiles, tile, jf, vec_s)
    tf = fields_from_jax(_to_numpy(jf))
    plan = assembly.phase_plan(port_cfg(solver), port_cfg(GOLDEN_DIVIDENDS))
    assert len(plan) == (2 if phases == "damp_main" else 1)
    if phases == "damp":
        assert [e[0] for e in plan[0]["events"]] == [1, 3, 5]
    u, lam = tf["u"], tf["lam"]
    for ph in plan:
        u, lam = fused_do.fused_do_reference(
            {**tf, "u": u, "lam": lam}, [e[0] for e in ph["events"]],
            assembly.build_remap_fields(tf["vecs"], ph["events"]),
            theta=ph["theta"], delta_t=ph["delta_t"],
            first_step=ph["first_step"], n_steps=ph["last_step"],
            rf=tf["rf_val"], american=True)
    np.testing.assert_allclose(npy(u), np.asarray(want_u).transpose(2, 0, 1),
                               rtol=0, atol=1e-11)
    np.testing.assert_allclose(npy(lam),
                               np.asarray(want_lam).transpose(2, 0, 1),
                               rtol=0, atol=1e-11)
    assert float(np.abs(npy(lam)).max()) > 0.0


@pytest.mark.parametrize("n_steps,rannacher,dividends", [
    (20, 2, GOLDEN_DIVIDENDS), (6, 2, GOLDEN_DIVIDENDS), (6, 9, None),
    (24, 3, TWELVE_DIVIDENDS), (20, 0, GOLDEN_DIVIDENDS)])
def test_phase_plan_matches_jax(n_steps, rannacher, dividends):
    """The port's phases against JAX's _run_chunks phase list, under every
    scheme: theta, delta_t, scheme (the damp phase always Douglas, the
    main phase the solver's; heston_tpu/pallas/fused_do.py:1715-1720),
    local step windows, and each phase's events at their phase-local
    steps, flattened from _chunk_dividend_plan."""
    for scheme in assembly.SCHEMES:
        solver = SolverConfig(n_steps=n_steps, rannacher_steps=rannacher,
                              scheme=scheme)
        r = min(rannacher, n_steps)
        want = []
        if r:
            want.append((1.0, solver.delta_t / 2, "do", 1, 2 * r, 1, r,
                         lambda n: 2 * n - 1, 2 * r + 1))
        if r < n_steps:
            want.append((solver.theta, solver.delta_t, scheme, r + 1,
                         n_steps, r + 1, n_steps, lambda n: n, n_steps + 1))
        got = assembly.phase_plan(port_cfg(solver), port_cfg(dividends))
        assert len(got) == len(want)
        for g, (theta, dt, sch, lo, hi, n_lo, n_hi, to_local, end) in zip(
                got, want):
            assert (g["theta"], g["delta_t"], g["scheme"], g["first_step"],
                    g["last_step"]) == (theta, dt, sch, lo, hi)
            events = []
            if dividends is not None:
                for _plan, ev in jfd._chunk_dividend_plan(
                        solver, dividends, n_lo=n_lo, n_hi=n_hi,
                        to_local=to_local, local_end=end):
                    events.extend(ev)
            assert g["events"] == events


def test_phase_plan_lane_counts():
    """Each phase's per-lane last local steps: 2*min(n_i, R) damp
    sub-steps, main steps up to n_i (a lane with n_i <= R runs none of the
    main phase's R+1..N)."""
    solver = port_cfg(SolverConfig(n_steps=6, rannacher_steps=2))
    nst = torch.tensor([1, 2, 3, 6])
    damp, main = assembly.phase_plan(solver, None, nst)
    assert damp["nst"].tolist() == [2, 4, 4, 4] and damp["last_step"] == 4
    assert main["nst"].tolist() == [1, 2, 3, 6] and main["first_step"] == 3
    assert all(ph["nst"] is None for ph in assembly.phase_plan(solver, None))


@pytest.mark.parametrize("m1,m2", [(10, 8), (50, 25), (4, 9), (6, 6)])
def test_b1_mask_matches_jax_positions(m1, m2):
    """b1 positions (the flat-index m1*(j+1) quirk) against the JAX
    kernel's table, and against the closed form the CUDA kernel uses:
    v-major flat index f = j*ns + i is a b1 node iff m1 <= f <= m1*nv and
    m1 divides f."""
    ns, nv = m1 + 1, m2 + 1
    want = np.zeros((ns, nv))
    for col, rows in jfd._b1_colrows(m1, m2).items():
        for r in rows:
            want[col, r] = 1.0
    np.testing.assert_array_equal(npy(fused_do.b1_mask(ns, nv)), want)
    closed = np.array([[1.0 if (m1 <= j * ns + i <= m1 * nv
                                and (j * ns + i) % m1 == 0) else 0.0
                        for j in range(nv)] for i in range(ns)])
    np.testing.assert_array_equal(closed, want)


def _book_inputs(dtype=torch.float64, device="cpu", n=5, american=True):
    p = HestonParams()
    strikes = torch.linspace(80.0, 120.0, n, dtype=dtype, device=device)
    fields, vec_s, _, _, _ = assembly.assemble(
        port_cfg(SPEC), port_cfg(SOLVER), strikes, 100.0, *param_args(p))
    events = assembly.dividend_plan(port_cfg(SOLVER),
                                    port_cfg(GOLDEN_DIVIDENDS))
    remaps = assembly.build_remap_fields(vec_s, events)
    kw = dict(theta=SOLVER.theta, delta_t=SOLVER.delta_t,
              n_steps=SOLVER.n_steps, rf=0.0, american=american)
    return fields, [e[0] for e in events], remaps, kw


def test_loop_on_cpu_runs_the_plain_version():
    fields, steps, remaps, kw = _book_inputs()
    before = fused_do.fused_do_loop.launches
    got_u, got_lam = fused_do.fused_do_loop(fields, steps, remaps, **kw)
    want_u, want_lam = fused_do.fused_do_reference(fields, steps, remaps,
                                                   **kw)
    assert torch.equal(got_u, want_u) and torch.equal(got_lam, want_lam)
    assert fused_do.fused_do_loop.launches == before


def test_loop_on_other_devices_raises():
    fields, steps, remaps, kw = _book_inputs()
    meta = {k: v.to("meta") for k, v in fields.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_do.fused_do_loop(meta, steps, remaps, **kw)


@pytest.mark.parametrize("fault", ["dtype", "shape", "steps", "remap"])
def test_launch_rejects_bad_inputs(fault):
    """The wrapper checks dtype, shapes and the event list before it
    builds or launches anything."""
    fields, steps, remaps, kw = _book_inputs()
    if fault == "dtype":
        fields = {k: v.to(torch.float16) for k, v in fields.items()}
        err = TypeError
    elif fault == "shape":
        fields["b2r"] = fields["b2r"][:, :-1]
        err = ValueError
    elif fault == "steps":
        steps = steps[::-1]
        err = ValueError
    else:
        remaps = [(i0.to(torch.int32), w0, i1, w1)
                  for i0, w0, i1, w1 in remaps]
        err = ValueError
    with pytest.raises(err):
        fused_do._launch(fields, steps, remaps, **kw)


# ---------------------------------------------------------------------------
# forward mode
# ---------------------------------------------------------------------------

TANGENT_ARMS = ("euro", "amer", "amer_div")
JAC_STRIKES = np.linspace(85.0, 115.0, 6)   # tests/test_pallas.py:88
JAC_SOLVER = SolverConfig(n_steps=4, a2_variant="upwind",
                          solver_engine="pallas")


def _theta(p):
    return np.array([p.kappa, p.eta, p.sigma, p.rho, p.v0])


def _jax_linearized(spec, solver, strikes, p, n_tangents):
    """JAX's linearized assembly, as fused_theta_jacobian builds it
    (heston_tpu/pallas/fused_do.py:2053-2074): n_tangents = 4 is
    v0_mode="stencil" (v0 fixed), 5 is v0_mode="ad". Returns the primal
    fields, vec_s, idx_s, idx_v and K dicts of tangent fields."""
    tv = jnp.asarray(_theta(p))

    def prep(t):
        full = jnp.concatenate([t, tv[4:]]) if n_tangents == 4 else t
        f, vec_s, idx_s, idx_v, _ = jfd._assemble(
            spec, solver, jnp.asarray(strikes), 100.0, full[0], full[1],
            full[2], full[3], full[4], p.r_d, p.r_f)
        return tuple(f[k] for k in jfd._TANGENT_KEYS), (f, vec_s, idx_s,
                                                         idx_v)

    _, jvp_fn, (jf, vec_s, idx_s, idx_v) = jax.linearize(
        prep, tv[:n_tangents], has_aux=True)
    dfields = jax.vmap(jvp_fn)(jnp.eye(n_tangents))
    tangents = [{k: leaf[kk] for k, leaf in zip(jfd._TANGENT_KEYS, dfields)}
                for kk in range(n_tangents)]
    return jf, vec_s, idx_s, idx_v, tangents


@functools.cache
def _jax_linearized_k5():
    """_jax_linearized along all five parameters on the padded strikes of
    fused_theta_jacobian, as one compiled program; the arms share it (the
    assembly is the same for every exercise style and dividend
    schedule)."""
    jstrikes, _, _, _ = jfd._pad_strikes(
        SPEC, jnp.asarray(JAC_STRIKES), n_tangents=5, strict=False)
    return jax.jit(lambda: _jax_linearized(SPEC, JAC_SOLVER, jstrikes,
                                           HestonParams(), 5))()


@functools.cache
def _jax_forward_mode(arm):
    """One forward-mode run of the JAX package per arm, shared by the
    tests below: its linearized assembly along all five parameters
    (v0_mode="ad") on the padded strikes of its fused_theta_jacobian,
    and its forward-mode Pallas kernel in interpret mode on it (K = 5).
    Its first four tangents are those of the K = 4 launch of
    fused_theta_jacobian's default v0_mode="stencil" (each tangent's
    arithmetic is its own; the two agree to 1e-13 on amer_div), so the
    Jacobian that function reads off its launch is read off this one:
    base prices and the columns of (kappa, eta, sigma, rho) at the price
    node, the v0 column the surface stencil (jfd._v0_stencil_col) —
    heston_tpu/pallas/fused_do.py:2076-2084 — and under v0_mode "ad"
    the fifth tangent's column."""
    p = HestonParams()
    kw = ARMS[arm]
    jstrikes, tile, n_tiles, _ = jfd._pad_strikes(
        SPEC, jnp.asarray(JAC_STRIKES), n_tangents=5, strict=False)
    b = len(JAC_STRIKES)
    jf, vec_s, idx_s, idx_v, tangents = _jax_linearized_k5()
    jf = dict(jf, rf_val=jops.boundary_rate(p.r_d, p.r_f, "call"))
    u, _, dus = jfd._run_chunks(
        SPEC, JAC_SOLVER, kw["american"], kw["dividends"], jf["u"].dtype,
        True, False, n_tiles, tile, jf, vec_s, tangents)
    cols = [jfd._extract(du, idx_s, idx_v, b) for du in dus]
    stencil = jfd._v0_stencil_col(SPEC, u, jf["vfl"], idx_s, idx_v, b,
                                  jnp.asarray(p.v0))
    return dict(
        fields=jf, strikes=np.asarray(jstrikes),
        tangents=[{k: np.asarray(x) for k, x in t.items()}
                  for t in tangents],
        u=np.asarray(u).transpose(2, 0, 1),
        dus=[np.asarray(du).transpose(2, 0, 1) for du in dus],
        base=np.asarray(jfd._extract(u, idx_s, idx_v, b)),
        jac_stencil=np.asarray(jnp.stack(cols[:4] + [stencil], axis=-1)),
        jac_ad=np.asarray(jnp.stack(cols, axis=-1)))


def test_linearized_assembly_matches_jax_linearize(params):
    """The port's linearized assembly (vmap of jvp over _assemble) against
    JAX's jax.linearize of its own assembly on the same (padded) strikes,
    every tangent field at 1e-12: the four directions of v0_mode
    "stencil" (v0 fixed) against JAX's first four, and the five of "ad"
    (the v0 direction moves the v-grid through the v0 node's insertion,
    ops.grid.make_v_nodes) against all five; the primal fields come out
    as _assemble's, bitwise."""
    run = _jax_forward_mode("euro")
    strikes = run["strikes"]
    want = tangent_fields_from_jax(run["tangents"])
    for v0_mode, k in (("stencil", fused_do.JAC_TANGENTS), ("ad", 5)):
        fields, got, _, _, _ = fused_do._linearized_assemble(
            port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(strikes), 100.0,
            t64(_theta(params)), params.r_d, params.r_f, v0_mode=v0_mode)
        assert len(got) == k
        for g, w in zip(got, want):
            assert set(g) == set(fused_do._TANGENT_KEYS)
            for key in fused_do._TANGENT_KEYS:
                assert g[key].shape == w[key].shape, key
                assert_close(g[key], w[key], err_msg=f"{v0_mode} {key}")
    plain, _, _, _, _ = assembly.assemble(
        port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(strikes), 100.0,
        *param_args(params))
    for k in plain:
        assert torch.equal(fields[k], plain[k]), k


@pytest.mark.parametrize("arm", TANGENT_ARMS)
def test_plain_tangent_loop_matches_jax_kernel(params, arm):
    """The plain forward-mode loop fed JAX's v0_mode="ad" tangent fields
    (all five directions, the grid-motion v0 tangents included) against
    JAX's forward-mode Pallas kernel in interpret mode on the same fields:
    primal surfaces at 1e-11, tangent surfaces at 1e-9 (the bar of
    tests/test_pallas.py:102-103)."""
    kw = ARMS[arm]
    run = _jax_forward_mode(arm)
    tf = fields_from_jax({k: v if isinstance(v, float) else np.asarray(v)
                          for k, v in run["fields"].items()})
    events = assembly.dividend_plan(port_cfg(JAC_SOLVER),
                                    port_cfg(kw["dividends"]))
    remaps = assembly.build_remap_fields(tf["vecs"], events)
    got_u, _, got_du, _ = fused_do.fused_do_reference(
        tf, [e[0] for e in events], remaps, theta=JAC_SOLVER.theta,
        delta_t=JAC_SOLVER.delta_t, n_steps=JAC_SOLVER.n_steps,
        rf=tf["rf_val"], american=kw["american"],
        tangents=tangent_fields_from_jax(run["tangents"]))
    np.testing.assert_allclose(npy(got_u), run["u"], rtol=0, atol=1e-11)
    assert len(got_du) == 5
    for g, w in zip(got_du, run["dus"]):
        np.testing.assert_allclose(npy(g), w, rtol=0, atol=1e-9)


@pytest.mark.parametrize("arm", TANGENT_ARMS)
def test_fused_theta_jacobian_matches_jax(params, arm):
    """The port's Jacobian (linearized assembly, plain forward-mode loop,
    v0 surface stencil) against the Jacobian JAX's fused_theta_jacobian
    reads off its forward-mode kernel in interpret mode
    (_jax_forward_mode): base prices at 1e-11, Jacobian at 1e-9; and the
    port's v0_mode "ad" (five tangents, the v0 column the grid motion)
    against the five columns of that kernel at 1e-9."""
    kw = ARMS[arm]
    run = _jax_forward_mode(arm)
    args = (port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(JAC_STRIKES), 100.0,
            t64(_theta(params)), params.r_d, params.r_f)
    pkw = dict(american=kw["american"], dividends=port_cfg(kw["dividends"]))
    base, jac = fused_do.fused_theta_jacobian(*args, **pkw)
    assert base.shape == (6,) and jac.shape == (6, 5)
    np.testing.assert_allclose(npy(base), run["base"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(npy(jac), run["jac_stencil"], rtol=0,
                               atol=1e-9)
    base_ad, jac_ad = fused_do.fused_theta_jacobian(*args, **pkw,
                                                    v0_mode="ad")
    assert torch.equal(base_ad, base)
    np.testing.assert_allclose(npy(jac_ad), run["jac_ad"], rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("arm", TANGENT_ARMS)
def test_packed_jacobian_matches_jax(params, arm):
    """The card's route to the Jacobian (packed_jacobian: the packed book
    plan, the tangent rows, one forward-mode launch a phase straight from
    both; on the CPU their plain versions) against the Jacobian JAX's
    fused_theta_jacobian reads off its forward-mode kernel
    (_jax_forward_mode): base prices at 1e-11, Jacobian at 1e-9; and
    bitwise the host route's (fused_theta_jacobian on CPU strikes)."""
    kw = ARMS[arm]
    run = _jax_forward_mode(arm)
    args = (port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(JAC_STRIKES), 100.0,
            t64(_theta(params)), params.r_d, params.r_f)
    pkw = dict(american=kw["american"], dividends=port_cfg(kw["dividends"]))
    base, jac = fused_do.packed_jacobian(*args, **pkw)
    np.testing.assert_allclose(npy(base), run["base"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(npy(jac), run["jac_stencil"], rtol=0,
                               atol=1e-9)
    host_base, host_jac = fused_do.fused_theta_jacobian(*args, **pkw)
    assert torch.equal(base, host_base) and torch.equal(jac, host_jac)


def test_jacobian_base_equals_primal_pricing(params):
    """The Jacobian launch's base prices are the primal loop's, bitwise:
    the tangent phase leaves the primal arithmetic untouched."""
    kw = dict(american=True, dividends=port_cfg(GOLDEN_DIVIDENDS))
    args = (port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(JAC_STRIKES), 100.0)
    base, _ = fused_do.fused_theta_jacobian(
        *args, t64(_theta(params)), params.r_d, params.r_f, **kw)
    want = fused_do.fused_price_batch(*args, *param_args(params), **kw)
    assert torch.equal(base, want)


def test_jacobian_v0_mode(params):
    """v0_mode "ad" carries five tangents (the v0 one the v-grid's
    motion): its base prices are the stencil mode's, bitwise, and so are
    its first four columns to 1e-12; an unknown mode is a ValueError."""
    args = (port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(JAC_STRIKES), 100.0,
            t64(_theta(params)), params.r_d, params.r_f)
    base_ad, jac_ad = fused_do.fused_theta_jacobian(*args, v0_mode="ad")
    base, jac = fused_do.fused_theta_jacobian(*args)
    assert torch.equal(base_ad, base) and jac_ad.shape == jac.shape
    assert_close(jac_ad[:, :4], jac[:, :4], rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="v0_mode"):
        fused_do.fused_theta_jacobian(*args, v0_mode="bump")


# ---------------------------------------------------------------------------
# mixed-maturity books (per-option step counts)
# ---------------------------------------------------------------------------

# steps 1..6 at N = 6: the golden dividends fall before steps 1..4, so
# lanes stop before, between and after events
LANE_STEPS = [2, 6, 3, 6, 1, 4]
LANE_STRIKES = np.linspace(85.0, 115.0, 6)
LANE_ARMS = {"euro": (0, ARMS["euro"]), "amer_div": (0, ARMS["amer_div"]),
             "rann_amer_div": (2, ARMS["amer_div"])}


def _lane_book(params, rann, kw, n_steps_per=LANE_STEPS, strikes=None):
    """The port's fused_price_batch on the mixed book (plain version)."""
    solver = port_cfg(dataclasses.replace(SOLVER, rannacher_steps=rann))
    return fused_do.fused_price_batch(
        port_cfg(SPEC), solver,
        t64(LANE_STRIKES if strikes is None else strikes), 100.0,
        *param_args(params), american=kw["american"],
        dividends=port_cfg(kw["dividends"]), n_steps_per=n_steps_per)


@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_per_lane_book_matches_jax(params, arm):
    """fused_price_batch(n_steps_per=) in one launch per phase — the plain
    loop freezing each lane past its count, identity remap rows — against
    JAX's in interpret mode, rtol 1e-9 / atol 1e-10 (the rannacher arm,
    R = 2: the lane with n_i = 1 runs one damp step pair and no main
    step)."""
    rann, kw = LANE_ARMS[arm]
    solver = dataclasses.replace(SOLVER, rannacher_steps=rann)
    # op by op: the arms share the interpret-mode kernel's primitives
    want = jfd.fused_price_batch(
        SPEC, solver, jnp.asarray(LANE_STRIKES), 100.0, *param_args(params),
        interpret=True, n_steps_per=jnp.asarray(LANE_STEPS), **kw)
    assert_close(_lane_book(params, rann, kw), want, rtol=1e-9, atol=1e-10)


@pytest.mark.parametrize("arm", sorted(LANE_ARMS))
def test_mixed_book_matches_group_launches(params, arm):
    """The one-launch mixed book against one launch per maturity group
    (each at its count and the shared dt, as calibrate_device prices
    groups): 1e-12 relative. Not bitwise: a matured lane's identity event
    folds its compensation into u (ROADMAP C2)."""
    from heston_tpu_torch.models import calibration

    rann, kw = LANE_ARMS[arm]
    got = _lane_book(params, rann, kw)
    for n in sorted(set(LANE_STEPS)):
        lanes = [i for i, m in enumerate(LANE_STEPS) if m == n]
        solver = dataclasses.replace(SOLVER, rannacher_steps=rann)
        group = fused_do.fused_price_batch(
            port_cfg(SPEC),
            calibration._group_solver(port_cfg(solver), n),
            t64(LANE_STRIKES[lanes]), 100.0, *param_args(params),
            american=kw["american"], dividends=port_cfg(kw["dividends"]))
        assert_close(got[lanes], group, rtol=1e-12, atol=0)


def test_per_lane_jacobian_matches_jax(params):
    """fused_theta_jacobian(n_steps_per=): the whole mixed-maturity
    Jacobian in one forward-mode launch against JAX's (interpret mode),
    American with the golden dividends, rtol 1e-9 / atol 1e-10; its base
    prices are the per-lane primal launch's, bitwise, and the card's route
    (packed_jacobian) gives both bitwise."""
    kw = ARMS["amer_div"]
    nst = [1, 4, 2, 4, 3, 4]
    want_base, want_jac = jax.jit(lambda t: jfd.fused_theta_jacobian(
        SPEC, JAC_SOLVER, jnp.asarray(JAC_STRIKES), 100.0, t, params.r_d,
        params.r_f, interpret=True, n_steps_per=jnp.asarray(nst), **kw))(
            jnp.asarray(_theta(params)))
    args = (port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(JAC_STRIKES), 100.0)
    pkw = dict(american=True, dividends=port_cfg(kw["dividends"]),
               n_steps_per=nst)
    base, jac = fused_do.fused_theta_jacobian(
        *args, t64(_theta(params)), params.r_d, params.r_f, **pkw)
    assert_close(base, want_base, rtol=1e-9, atol=1e-10)
    assert_close(jac, want_jac, rtol=1e-9, atol=1e-10)
    assert torch.equal(base, fused_do.fused_price_batch(
        *args, *param_args(params), **pkw))
    # the card's route (packed_jacobian, its plain versions here) on the
    # same mixed book: the same numbers as the host route, bitwise
    packed = fused_do.packed_jacobian(*args, t64(_theta(params)),
                                      params.r_d, params.r_f, **pkw)
    assert torch.equal(packed[0], base) and torch.equal(packed[1], jac)


def _tangent_inputs(params):
    fields, tangents, vec_s, _, _ = fused_do._linearized_assemble(
        port_cfg(SPEC), port_cfg(JAC_SOLVER), t64(JAC_STRIKES), 100.0,
        t64(_theta(params)), params.r_d, params.r_f)
    kw = dict(theta=JAC_SOLVER.theta, delta_t=JAC_SOLVER.delta_t,
              n_steps=JAC_SOLVER.n_steps, rf=0.0, american=True)
    return fields, tangents, kw


def test_tangent_loop_on_cpu_runs_the_plain_version(params):
    fields, tangents, kw = _tangent_inputs(params)
    before = (fused_do.fused_do_loop.launches,
              fused_do.fused_do_loop.tangent_launches)
    got_u, _, got_du, _ = fused_do.fused_do_loop(
        fields, [], [], **kw, tangents=tangents)
    want_u, _, want_du, _ = fused_do.fused_do_reference(
        fields, [], [], **kw, tangents=tangents)
    assert torch.equal(got_u, want_u)
    assert all(torch.equal(g, w) for g, w in zip(got_du, want_du))
    assert (fused_do.fused_do_loop.launches,
            fused_do.fused_do_loop.tangent_launches) == before


@pytest.mark.parametrize("fault", ["shape", "dtype", "empty"])
def test_tangent_launch_rejects_bad_inputs(params, fault):
    """The wrapper checks every tangent field before it builds or
    launches anything."""
    fields, tangents, kw = _tangent_inputs(params)
    if fault == "shape":
        tangents[1]["al2"] = tangents[1]["al2"][:, :-1]
    elif fault == "dtype":
        tangents[0]["sfac"] = tangents[0]["sfac"].float()
    else:
        tangents = []
    with pytest.raises(ValueError):
        fused_do._launch(fields, [], [], **kw, tangents=tangents)

"""heston_tpu_torch.kernels.fused_do against heston_tpu.pallas.fused_do:
the host-side assembly, the dividend remap fields, and the plain time loop
fed the JAX package's own fields against its Pallas kernel run in
interpret mode. float64 on the CPU; the CUDA kernel itself is compared
with the plain version on the card in tests/test_torch_cuda.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, DividendSchedule, GridSpec,
                               HestonParams, SolverConfig)
from heston_tpu.ops import operators as jops
from heston_tpu.pallas import fused_do as jfd
from heston_tpu_torch.convert import fields_from_jax
from heston_tpu_torch.kernels import fused_do

from torch_parity import assert_close, npy, param_args, t64

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


def _jax_fields(spec, solver, strikes, p, r_f):
    fields, vec_s, idx_s, idx_v, _ = jfd._assemble(
        spec, solver, jnp.asarray(strikes), 100.0, *param_args(p, r_f))
    fields["rf_val"] = jops.boundary_rate(p.r_d, r_f, "call")
    return fields, vec_s, idx_s, idx_v


def _to_numpy(fields):
    return {k: v if isinstance(v, float) else np.asarray(v)
            for k, v in fields.items()}


def test_remap_fields_match_jax(params):
    """Exact indices, weights at 1e-15. The events cover the golden
    schedule, a cash dividend large enough to push the low nodes below
    s = 0 (calls zero them), and a negative amount that pushes the top
    nodes past s_max (index > m1 maps to 0: copy column 0)."""
    rng = np.random.default_rng(SEED)
    strikes = rng.uniform(70.0, 130.0, 5)
    _, vec_s, _, _ = _jax_fields(SPEC, SOLVER, strikes, params, 0.0)
    events = [(1, 0.5, 0.02), (2, 0.3, 0.0), (3, 40.0, 0.01),
              (4, -50.0, 0.0), (5, 0.0, 0.5)]
    want = jfd._build_remap_fields(vec_s, events, vec_s.dtype)
    got = fused_do._build_remap_fields(t64(vec_s), events)
    for (gi0, gw0, gi1, gw1), (wi0, ww0, wi1, ww1) in zip(got, want):
        assert gi0.dtype == torch.int64 and gi1.dtype == torch.int64
        np.testing.assert_array_equal(npy(gi0), np.asarray(wi0))
        np.testing.assert_array_equal(npy(gi1), np.asarray(wi1))
        assert_close(gw0, ww0, rtol=0, atol=1e-15)
        assert_close(gw1, ww1, rtol=0, atol=1e-15)
        # Sterbenz pairing: each pair sums to exactly 1 (or 0)
        total = npy(gw0 + gw1)
        assert np.all((total == 1.0) | (total == 0.0))


@pytest.mark.parametrize("r_f", [0.0, 0.01])
def test_assemble_fields_match_jax(params, r_f):
    """Every field of the port's assembly against the JAX package's,
    carried across with fields_from_jax, at 1e-12; K = 10 is the 8K < S0
    quirk (spot node dropped, index 0)."""
    spec = GridSpec(m1=12, m2=9)
    strikes = np.array([10.0, 85.0, 100.0, 117.5])
    jf, _, jidx_s, jidx_v = _jax_fields(spec, SOLVER, strikes, params, r_f)
    want = fields_from_jax(_to_numpy(jf))
    got, vec_s, idx_s, idx_v = fused_do._assemble(
        spec, SOLVER, t64(strikes), 100.0, *param_args(params, r_f))
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
    events = fused_do.dividend_plan(solver, dividends)
    remaps = fused_do._build_remap_fields(tf["vecs"], events)
    got = fused_do.fused_do_reference(
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
    plan = fused_do.dividend_plan(solver, TWELVE_DIVIDENDS)
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
    assert fused_do.dividend_plan(solver, dividends) == want


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
    fields, vec_s, _, _ = fused_do._assemble(
        SPEC, SOLVER, strikes, 100.0, *param_args(p))
    events = fused_do.dividend_plan(SOLVER, GOLDEN_DIVIDENDS)
    remaps = fused_do._build_remap_fields(vec_s, events)
    kw = dict(theta=SOLVER.theta, delta_t=SOLVER.delta_t,
              n_steps=SOLVER.n_steps, rf=0.0, american=american)
    return fields, [e[0] for e in events], remaps, kw


def test_loop_on_cpu_runs_the_plain_version():
    fields, steps, remaps, kw = _book_inputs()
    before = fused_do.fused_do_loop.launches
    got = fused_do.fused_do_loop(fields, steps, remaps, **kw)
    want = fused_do.fused_do_reference(fields, steps, remaps, **kw)
    assert torch.equal(got, want)
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

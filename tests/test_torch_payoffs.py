"""Puts, cash-or-nothing digitals and knock-out barriers on the batched
route of heston_tpu_torch against heston_tpu, float64 on the CPU: book
prices (kernel 1's plain version, `fused_do_reference`), a mixed-maturity
put book, book risk on an American digital book with its active set, the
forward-mode Jacobian of put and up-out chains, and calibrate_device on a
put chain; plus the conversion of the JAX package's assembled fields for
these payoffs into the port's layout.

Most cases hold the port against the JAX package's `solver_engine="scan"`
path, which its own tests hold equal to its Pallas kernels at 1e-11
(tests/test_barrier.py:195-227, tests/test_puts.py:126,
tests/test_digital.py:120). Where a kernel's own handling of a payoff
matters (the separate compensation remap of puts and barriers at a
dividend, the American digital's projection, the re-knock of a top
barrier, per-lane steps, the forward mode) the JAX side runs its Pallas
kernel in interpret mode, once per case, on a small grid."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import (GOLDEN_DIVIDENDS, Barrier, CalibrationConfig,
                               GridSpec, HestonParams, SolverConfig)
from heston_tpu.models import douglas as jdouglas
from heston_tpu.models import greeks as jgreeks
from heston_tpu.pallas import fused_do as jfd
import heston_tpu_torch
from heston_tpu_torch.convert import fields_from_jax
from heston_tpu_torch.kernels import assembly, fused_do
from heston_tpu_torch.models import greeks

from torch_parity import CPU, assert_close, npy, param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

P = HestonParams()
SPEC = GridSpec(m1=12, m2=8)
SCAN = SolverConfig(n_steps=6, a2_variant="upwind", solver_engine="scan")
PALLAS = dataclasses.replace(SCAN, solver_engine="pallas")
STRIKES = np.array([90.0, 104.0, 117.0])
R_F = 0.01
ARMS = {"euro": dict(american=False, dividends=None),
        "amer": dict(american=True, dividends=None),
        "div": dict(american=False, dividends=GOLDEN_DIVIDENDS),
        "amer_div": dict(american=True, dividends=GOLDEN_DIVIDENDS)}
# name -> (option_type, barrier); S0 = 100 lies inside every alive domain
PAYOFFS = {
    "put": ("put", None),
    "digital_call": ("digital_call", None),
    "digital_put": ("digital_put", None),
    "up_out_call": ("call", Barrier("up-out", 150.0)),
    "down_out_put": ("put", Barrier("down-out", 80.0)),
    "double_out_digital_call": ("digital_call",
                                Barrier("double-out", 80.0, level_hi=150.0)),
}
# every arm for the first three families, European and American with
# dividends for the rest
CASES = [(p, a) for p in ("put", "digital_call", "up_out_call")
         for a in ARMS] + [(p, a) for p in ("digital_put", "down_out_put",
                                            "double_out_digital_call")
                           for a in ("euro", "amer_div")]
PRICE_TOL = 1e-10     # f64 prices against the JAX package
JAC_TOL = 1e-9        # f64 forward-mode Jacobian against the JAX package


def _spec(payoff, spec=SPEC):
    return dataclasses.replace(spec, barrier=PAYOFFS[payoff][1])


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


def _prices(payoff, arm, solver=SCAN, spec=SPEC, strikes=STRIKES):
    """(JAX price_batch, the port's price_batch on the CPU) of a book."""
    option_type = PAYOFFS[payoff][0]
    spec = _spec(payoff, spec)
    want = jdouglas.price_batch(spec, solver, jnp.asarray(strikes), 100.0,
                                *param_args(P, R_F), option_type=option_type,
                                **ARMS[arm])
    got = heston_tpu_torch.price_batch(
        port_cfg(spec), port_cfg(dataclasses.replace(
            solver, solver_engine="pallas")),
        t64(strikes), 100.0, *param_args(P, R_F), option_type=option_type,
        **_port_kw(ARMS[arm]), device=CPU)
    return np.asarray(want), got


@pytest.mark.parametrize("payoff,arm", CASES)
def test_book_matches_jax_scan(payoff, arm):
    """A book of three strikes on the batched route (the plain version of
    kernel 1) against the JAX package's scan engine: prices at 1e-10;
    every price finite and, for digitals, within [0, 1]."""
    want, got = _prices(payoff, arm)
    assert got.shape == (len(STRIKES),) and got.dtype == torch.float64
    assert_close(got, want, rtol=0, atol=PRICE_TOL)
    if "digital" in payoff:
        assert float(got.min()) >= -1e-12 and float(got.max()) <= 1.0


@pytest.mark.parametrize("payoff", ["put", "digital_call", "up_out_call"])
def test_book_under_hv_matches_jax_scan(payoff):
    """The same under the Hundsdorfer-Verwer corrector, American with the
    golden dividends (the reaction rows n_react enter the corrector's L z2
    as well)."""
    solver = dataclasses.replace(SCAN, scheme="hv")
    want, got = _prices(payoff, "amer_div", solver=solver)
    assert_close(got, want, rtol=0, atol=PRICE_TOL)


# the cases where the JAX kernel's own handling of the payoff matters,
# against its Pallas kernel in interpret mode: the compensation remapped
# beside u (put, up-out with dividends), the projection (American digital)
KERNEL_CASES = [("put", "amer_div"), ("digital_call", "amer"),
                ("up_out_call", "amer_div")]


@pytest.mark.parametrize("payoff,arm", KERNEL_CASES)
def test_book_matches_jax_kernel(payoff, arm):
    """fused_price_batch against the JAX package's batched Pallas kernel
    in interpret mode, prices at 1e-10."""
    option_type = PAYOFFS[payoff][0]
    spec = _spec(payoff)
    want = jfd.fused_price_batch(spec, PALLAS, jnp.asarray(STRIKES), 100.0,
                                 *param_args(P, R_F), option_type=option_type,
                                 **ARMS[arm])
    got = fused_do.fused_price_batch(
        port_cfg(spec), port_cfg(PALLAS), t64(STRIKES), 100.0,
        *param_args(P, R_F), option_type=option_type, **_port_kw(ARMS[arm]))
    assert_close(got, np.asarray(want), rtol=0, atol=PRICE_TOL)


def test_mixed_put_book_matches_jax_kernel():
    """Per-lane step counts on an American put book with the golden
    dividends: one launch, each option stopping at its own count (events
    past a lane's count become identity rows of the separate u and
    compensation remaps), against the JAX kernel's one-launch book."""
    ks = np.array([88.0, 95.0, 103.0, 112.0])
    nst = np.array([6, 2, 4, 5])
    want = jfd.fused_price_batch(SPEC, PALLAS, jnp.asarray(ks), 100.0,
                                 *param_args(P, R_F), option_type="put",
                                 n_steps_per=jnp.asarray(nst),
                                 **ARMS["amer_div"])
    got = fused_do.fused_price_batch(
        port_cfg(SPEC), port_cfg(PALLAS), t64(ks), 100.0,
        *param_args(P, R_F), option_type="put",
        n_steps_per=torch.as_tensor(nst), **_port_kw(ARMS["amer_div"]))
    assert_close(got, np.asarray(want), rtol=0, atol=PRICE_TOL)


def test_batch_greeks_american_digital_matches_jax():
    """batch_greeks on an American digital call book with the golden
    dividends against the JAX package's fused engine (interpret mode):
    every RISK_KEYS column at rtol 1e-9 / atol 1e-10. The projection
    carries no multiplier, so theta rebuilds it on the active set (the
    nodes where the surface equals the payoff exactly), which is not
    empty here."""
    kw = dict(american=True, dividends=GOLDEN_DIVIDENDS,
              option_type="digital_call")
    strikes = np.linspace(85.0, 115.0, 5)
    want = jgreeks.batch_greeks(SPEC, PALLAS, jnp.asarray(strikes), 100.0,
                                *param_args(P, R_F), **kw)
    got = heston_tpu_torch.batch_greeks(
        port_cfg(SPEC), port_cfg(PALLAS), t64(strikes), 100.0,
        *param_args(P, R_F), **_port_kw(kw), device=CPU)
    for k in greeks.RISK_KEYS:
        assert_close(got[k], np.asarray(want[k]), rtol=1e-9, atol=1e-10,
                     err_msg=k)
    u, _, _, vec_s, _, _ = fused_do.fused_surface_batch(
        port_cfg(SPEC), port_cfg(PALLAS), t64(strikes), 100.0,
        *param_args(P, R_F), **_port_kw(kw))
    floor = fused_do.operators.grid_payoff(vec_s, t64(strikes)[:, None],
                                           "digital_call")
    assert bool((u == floor[:, :, None]).any())


@pytest.mark.parametrize("payoff", ["put", "up_out_call"])
def test_theta_jacobian_matches_jax_kernel(payoff):
    """fused_theta_jacobian on an American chain with the golden dividends
    (a put chain, an up-out call chain) against the JAX package's
    forward-mode kernel in interpret mode: base prices at 1e-10, the
    Jacobian [B, 5] at atol 1e-9; the card's route (packed_jacobian)
    gives the same numbers, bitwise."""
    option_type = PAYOFFS[payoff][0]
    spec = _spec(payoff, GridSpec(m1=8, m2=6))
    solver = dataclasses.replace(PALLAS, n_steps=3)
    tv = [P.kappa, P.eta, P.sigma, P.rho, P.v0]
    want_base, want_jac = jfd.fused_theta_jacobian(
        spec, solver, jnp.asarray(STRIKES), 100.0, jnp.asarray(tv), P.r_d,
        P.r_f, option_type=option_type, **ARMS["amer_div"])
    base, jac = fused_do.fused_theta_jacobian(
        port_cfg(spec), port_cfg(solver), t64(STRIKES), 100.0, t64(tv),
        P.r_d, P.r_f, option_type=option_type,
        **_port_kw(ARMS["amer_div"]))
    assert jac.shape == (len(STRIKES), 5)
    assert_close(base, np.asarray(want_base), rtol=0, atol=PRICE_TOL)
    assert_close(jac, np.asarray(want_jac), rtol=0, atol=JAC_TOL)
    # the card's route (packed_jacobian, its plain versions here): the
    # host route's numbers, bitwise
    packed = fused_do.packed_jacobian(
        port_cfg(spec), port_cfg(solver), t64(STRIKES), 100.0, t64(tv),
        P.r_d, P.r_f, option_type=option_type,
        **_port_kw(ARMS["amer_div"]))
    assert torch.equal(packed[0], base) and torch.equal(packed[1], jac)


def test_calibrate_device_put_chain():
    """calibrate_device on a European put chain priced by the port itself
    at known parameters: the Levenberg–Marquardt loop (one forward-mode
    and one primal launch of the plain version per iteration) cuts the
    SSE by orders of magnitude, and its fitted prices are the put
    pricer's at the fitted parameters."""
    strikes = t64(np.linspace(80.0, 120.0, 10))
    true = [2.0, 0.05, 0.35, -0.6, 0.045]
    args = (port_cfg(SPEC), port_cfg(PALLAS))
    market = heston_tpu_torch.price_batch(*args, strikes, 100.0, *true,
                                          P.r_d, 0.0, option_type="put",
                                          device=CPU)
    init = t64([1.5, 0.04, 0.3, -0.5, 0.04])
    cfg = port_cfg(CalibrationConfig(max_iter=12, tol=1e-14,
                                     jacobian_mode="ad"))
    start = heston_tpu_torch.price_batch(*args, strikes, 100.0,
                                         *npy(init).tolist(), P.r_d, 0.0,
                                         option_type="put", device=CPU)
    sse0 = float(((market - start) ** 2).sum())
    tv, info = heston_tpu_torch.calibrate_device(
        *args, strikes, market, 100.0, init, P.r_d, 0.0, cfg=cfg,
        option_type="put", device=CPU)
    assert float(info["final_error"]) < 1e-4 * sse0
    fitted = heston_tpu_torch.price_batch(*args, strikes, 100.0,
                                          *npy(tv).tolist(), P.r_d, 0.0,
                                          option_type="put", device=CPU)
    assert_close(info["fitted_prices"], fitted, rtol=0, atol=1e-12)


@pytest.mark.parametrize("payoff", ["put", "digital_put", "up_out_call",
                                    "double_out_digital_call"])
def test_assembled_fields_match_jax(payoff):
    """The JAX package's assembled time-loop fields of a payoff book (its
    `_assemble`, batch last), carried across with convert.fields_from_jax,
    equal the port's own `_assemble` field by field at 1e-12: the masked
    payoff, the put row-0 reaction, the zeroed boundary data of puts,
    digitals and top-knocked barriers. The remap fields of a dividend
    agree too (puts copy column 0; a top knock zeroes its weights)."""
    option_type = PAYOFFS[payoff][0]
    spec = _spec(payoff)
    jf, jvec_s, _, _, _ = jfd._assemble(spec, SCAN, jnp.asarray(STRIKES),
                                        100.0, *param_args(P, R_F),
                                        option_type)
    want = fields_from_jax({k: np.asarray(v) for k, v in jf.items()})
    got, vec_s, _, _, _ = assembly.assemble(
        port_cfg(spec), port_cfg(SCAN), t64(STRIKES), 100.0,
        *param_args(P, R_F), option_type=option_type)
    for k in (*assembly.BIG_KEYS, *assembly.S_KEYS, *assembly.V_KEYS,
              *assembly.SCALAR_KEYS):
        assert_close(got[k], want[k], err_msg=k)
    if PAYOFFS[payoff][1] is not None:
        for c in assembly.barrier_positions(port_cfg(spec)):
            assert bool((got["u"][:, c] == 0.0).all())
    events = assembly.dividend_plan(port_cfg(SCAN), port_cfg(GOLDEN_DIVIDENDS))
    mine = assembly.build_remap_fields(
        vec_s, events, option_type=option_type,
        knocked=assembly.barrier_positions(port_cfg(spec)))
    theirs = jfd._build_remap_fields(jvec_s, events, jnp.float64,
                                     option_type, barrier=spec.barrier)
    assert len(mine) == len(theirs)
    for rm, jrm in zip(mine, theirs):
        for x, y in zip(rm, jrm):
            if x.is_floating_point():
                assert_close(x, np.asarray(y), rtol=0, atol=1e-12)
            else:
                assert np.array_equal(npy(x), np.asarray(y))

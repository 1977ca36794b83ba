"""heston_tpu_torch.kernels.fused_single against heston_tpu.pallas.
fused_single: the plain single-option loop (PCR along s, the TPU kernel's
order of arithmetic) against the Pallas latency kernel in interpret mode,
the batch-of-one route of price_batch, the routing rule, and the wrapper's
checks. float64 on the CPU; the CUDA kernel itself is compared with the
plain version on the card in tests/test_torch_cuda.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heston_tpu.config import GOLDEN_DIVIDENDS, GridSpec, SolverConfig
from heston_tpu.models import douglas as jdouglas
import heston_tpu_torch
from heston_tpu_torch.kernels import fused_do, fused_single

from torch_parity import param_args, port_cfg, t64
from torch_parity import release_jax_executables  # noqa: F401

SPEC = GridSpec(m1=12, m2=8)
SOLVER = SolverConfig(n_steps=6, a2_variant="upwind", solver_engine="pallas")
# the bench's single-option arms and the Rannacher start-up (at N = 6 the
# golden dividends fall on steps 1-4: two in the damp phase, at its first
# sub-step and mid-phase, two in the main phase)
ARMS = {
    "euro": (0, {}),
    "amer": (0, dict(american=True)),
    "div": (0, dict(dividends=GOLDEN_DIVIDENDS)),
    "amer_div": (0, dict(american=True, dividends=GOLDEN_DIVIDENDS)),
    "rann": (2, {}),
    "rann_amer_div": (2, dict(american=True, dividends=GOLDEN_DIVIDENDS)),
}
STRIKES = (97.0, 113.0)


def _port_kw(kw):
    return {k: port_cfg(v) for k, v in kw.items()}


def _solver(arm):
    return dataclasses.replace(SOLVER, rannacher_steps=ARMS[arm][0])


@pytest.mark.parametrize("arm", sorted(ARMS))
def test_plain_single_matches_jax_kernel(params, arm):
    """A batch of one on both packages, float64: JAX's price_batch sends
    it to fused_single.fused_price_single, whose Pallas kernel runs in
    interpret mode on the CPU (heston_tpu/models/douglas.py:871-881);
    the port's fused_price_single runs the plain version, one launch per
    phase, and its price_batch(device="cpu") takes that route. Same
    algorithm, same order of arithmetic, so 1e-11."""
    solver = _solver(arm)
    kw = ARMS[arm][1]
    for strike in STRIKES:
        want = np.asarray(jdouglas.price_batch(
            SPEC, solver, jnp.asarray([strike]), 100.0,
            *param_args(params), **kw))
        args = (port_cfg(SPEC), port_cfg(solver), t64([strike]), 100.0,
                *param_args(params))
        got = fused_single.fused_price_single(*args, **_port_kw(kw))
        assert got.shape == (1,)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-11)
        routed = heston_tpu_torch.price_batch(*args, **_port_kw(kw),
                                              device="cpu")
        assert torch.equal(routed, got)


@pytest.mark.parametrize("rannacher", [0, 2])
@pytest.mark.parametrize("batch", [1, 2])
def test_batch_of_one_takes_the_single_route(monkeypatch, params, batch,
                                             rannacher):
    """A spy on both loops: a batch of one runs the latency kernel's loop
    and never the batched one, a batch of two the reverse; one launch per
    phase (two with Rannacher)."""
    calls = {"single": 0, "batched": 0}

    def spy(name, fn):
        def wrapped(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(fused_single, "fused_single_loop",
                        spy("single", fused_single.fused_single_loop))
    monkeypatch.setattr(fused_do, "fused_do_loop",
                        spy("batched", fused_do.fused_do_loop))
    solver = port_cfg(dataclasses.replace(SOLVER, rannacher_steps=rannacher))
    got = heston_tpu_torch.price_batch(
        port_cfg(GridSpec(m1=10, m2=8)), solver,
        t64([100.0, 110.0][:batch]), 100.0, *param_args(params),
        american=True, device="cpu")
    assert got.shape == (batch,)
    phases = 2 if rannacher else 1
    want = ({"single": phases, "batched": 0} if batch == 1
            else {"single": 0, "batched": phases})
    assert calls == want


@pytest.mark.parametrize("m1,m2,fits", [(12, 8, True), (100, 75, True),
                                        (120, 100, True), (150, 140, False)])
def test_use_single_capacity_rule(m1, m2, fits):
    """The routing rule: one option, the pallas engine, and the two
    [nv, ns] PCR buffers plus the coefficient rows in the 227 KB of
    shared memory in float64."""
    spec = heston_tpu_torch.GridSpec(m1=m1, m2=m2)
    solver = heston_tpu_torch.SolverConfig(solver_engine="pallas")
    assert fused_single.use_single(spec, solver, 1) is fits
    assert (fused_single.smem_bytes(m1 + 1, m2 + 1, 8)
            <= fused_single.SMEM_LIMIT) is fits
    small = heston_tpu_torch.GridSpec(m1=12, m2=8)
    assert not fused_single.use_single(small, solver, 2)
    assert not fused_single.use_single(
        small, dataclasses.replace(solver, solver_engine="scan"), 1)


def test_large_grid_batch_of_one_takes_the_batched_route(monkeypatch,
                                                          params):
    """A grid past the capacity rule prices a batch of one on the batched
    kernel, as the JAX package does past its VMEM budget."""
    monkeypatch.setattr(fused_single, "SMEM_LIMIT", 1000)
    one = heston_tpu_torch.price_batch(
        port_cfg(SPEC), port_cfg(SOLVER), t64([100.0]), 100.0,
        *param_args(params), device="cpu")
    book = fused_do.fused_price_batch(
        port_cfg(SPEC), port_cfg(SOLVER), t64([100.0]), 100.0,
        *param_args(params))
    assert torch.equal(one, book)


def _inputs(dtype=torch.float64, american=True):
    p = heston_tpu_torch.HestonParams()
    fields, phases, _ = fused_single.single_plan(
        port_cfg(SPEC), port_cfg(SOLVER), torch.tensor([100.0], dtype=dtype),
        100.0, p.kappa, p.eta, p.sigma, p.rho, p.v0, p.r_d, p.r_f,
        american=american, dividends=port_cfg(GOLDEN_DIVIDENDS))
    (steps, remaps, kw), = phases
    return fields, steps, remaps, kw


def test_single_loop_on_cpu_runs_the_plain_version():
    fields, steps, remaps, kw = _inputs()
    before = fused_single.fused_single_loop.launches
    got_u, got_lam = fused_single.fused_single_loop(fields, steps, remaps,
                                                    **kw)
    want_u, want_lam = fused_single.fused_single_reference(
        fields, steps, remaps, **kw)
    assert got_u.shape == (SPEC.m2 + 1, SPEC.m1 + 1)
    assert torch.equal(got_u, want_u) and torch.equal(got_lam, want_lam)
    assert fused_single.fused_single_loop.launches == before


def test_single_loop_on_other_devices_raises():
    fields, steps, remaps, kw = _inputs()
    meta = {k: v.to("meta") for k, v in fields.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_single.fused_single_loop(meta, steps, remaps, **kw)


@pytest.mark.parametrize("fault", ["dtype", "shape", "steps", "remap",
                                   "capacity"])
def test_single_launch_rejects_bad_inputs(monkeypatch, fault):
    """The wrapper checks dtype, shapes, the event list and the shared
    memory before it builds or launches anything."""
    fields, steps, remaps, kw = _inputs()
    err = ValueError
    if fault == "dtype":
        fields = {k: v.to(torch.float16) for k, v in fields.items()}
        err = TypeError
    elif fault == "shape":
        fields["al2"] = fields["al2"][:-1]
    elif fault == "steps":
        steps = [s + 10 for s in steps]
    elif fault == "remap":
        remaps = [(i0.to(torch.int32), w0, i1, w1)
                  for i0, w0, i1, w1 in remaps]
    else:
        monkeypatch.setattr(fused_single, "SMEM_LIMIT", 1000)
    with pytest.raises(err):
        fused_single._launch(fields, steps, remaps, **kw)


def test_single_and_batched_plain_loops_agree(params):
    """The same American-dividend option through both plain loops: PCR
    against Thomas, and the two kernels' orders of arithmetic, agree to
    rounding (the JAX package's own bar, tests/test_pallas.py:410)."""
    kw = dict(american=True, dividends=port_cfg(GOLDEN_DIVIDENDS))
    args = (port_cfg(SPEC), port_cfg(_solver("rann_amer_div")),
            t64([104.0]), 100.0, *param_args(params))
    single = fused_single.fused_price_single(*args, **kw)
    batched = fused_do.fused_price_batch(*args, **kw)
    np.testing.assert_allclose(single.numpy(), batched.numpy(), rtol=1e-10,
                               atol=1e-12)

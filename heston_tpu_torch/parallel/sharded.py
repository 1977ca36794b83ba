"""Option-book sharding and distributed LM reductions over a
`torch.distributed` group (PyTorch).

Counterpart of `heston_tpu.parallel.sharded`: the option batch is the
only axis worth sharding (one PDE is ~51x26..201x151 nodes), so each rank
prices its own slice of the book with no communication, and the
Levenberg–Marquardt normal equations reduce JᵀJ (5x5), Jᵀr (5) and the
SSE in one `all_reduce`.

The semantics are SPMD, as the JAX package's global arrays are: every
rank passes the whole book; each prices its contiguous slice of the book
padded to a multiple of the world size (the last option repeated, as
`_pad_to` pads in the JAX package), on its own device, through the same
entry points as one device (kernel 1 under "pallas"); an `all_gather`
hands every rank the whole result. Padded lanes carry zero weight in the
normal equations.

A `Mesh` (`make_mesh`) holds the group, this rank and its device. Without
an initialized process group it is a world of one on the default device
whose collectives are the identity — what the JAX package's mesh over
one device is. `ensure_distributed` initializes the group from the
`torchrun` environment: NCCL for a CUDA device, gloo for the CPU, or the
`backend` the caller names.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from heston_tpu_torch.config import (CalibrationConfig, DividendSchedule,
                                     GridSpec, SolverConfig)
from heston_tpu_torch.kernels import fused_do
from heston_tpu_torch.models import calibration, douglas, greeks
from heston_tpu_torch.models.calibration import (N_PARAMS,
                                                 _bumped_param_matrix,
                                                 lane_steps,
                                                 validate_group_steps)
from heston_tpu_torch.models.greeks import RISK_KEYS
from heston_tpu_torch.utils.checkpoint import LMState, problem_key
from heston_tpu_torch.utils.io import _host


def _auto_jacobian_mode(mode, dtype: torch.dtype) -> str:
    """None -> "fd" in float64 (reference parity), "ad" in float32 (a
    1e-6 bump is below one price ulp there)."""
    if mode is not None:
        return mode
    return "fd" if dtype == torch.float64 else "ad"


def ensure_distributed(device=None, **kwargs) -> None:
    """Initialize the default `torch.distributed` group exactly once.

    With no keyword arguments the group comes from the `torchrun`
    environment (RANK, WORLD_SIZE, MASTER_ADDR / MASTER_PORT, LOCAL_RANK;
    `init_method="env://"`); a world of one, or a process without that
    environment, is left alone. Keyword arguments go to
    `init_process_group` (an address, a store, the world size and rank).
    The backend is NCCL for a CUDA device (None: the card) and gloo for
    the CPU, unless `backend` is given. A CUDA rank binds to the card
    LOCAL_RANK names. A no-op when the group is already initialized."""
    if dist.is_initialized():
        return
    if not kwargs and int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    dev = douglas.resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    kwargs.setdefault("backend", "nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(**kwargs)


def _mesh_device(device) -> torch.device:
    dev = douglas.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def host_major_devices(device=None, group=None):
    """(host name, device) of every rank of the group, in rank order,
    validated host-major: each host's ranks are contiguous and every host
    contributes as many, so a contiguous slice of the book lies on one
    host per block of ranks (heston_tpu/parallel/sharded.py:88-102). A
    world of one without a process group is this process alone. A
    collective: every rank of the group calls it."""
    mine = (socket.gethostname(), str(_mesh_device(device)))
    if not dist.is_initialized():
        return [mine]
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, mine, group=group)
    hosts = [h for h, _ in out]
    order = list(dict.fromkeys(hosts))
    counts = {h: hosts.count(h) for h in order}
    if len(set(counts.values())) > 1:
        raise ValueError(f"uneven ranks per host: {counts} — the batch "
                         f"split assumes equal contributions")
    if hosts != [h for h in order for _ in range(counts[h])]:
        raise ValueError(f"ranks are not host-major: {hosts}")
    return out


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh over the ranks of a `torch.distributed` group: the
    group (None: a world of one without a process group), this rank, the
    world size and this rank's device."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x [..., b] joined in rank order along the last
        axis: [..., size * b]."""
        if self.group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=-1)

    def barrier(self) -> None:
        if self.group is not None:
            dist.barrier(group=self.group)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's x."""
        if self.group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x


def make_mesh(device=None, group=None) -> Mesh:
    """The 1-D mesh over the default process group (or `group`), this
    rank's device `device` (None: the card; "cpu" for the CPU); a world
    of one when no process group is initialized. Validates the ranks'
    layout (`host_major_devices`), a collective."""
    dev = _mesh_device(device)
    if not dist.is_initialized():
        if group is not None:
            raise ValueError("a group was given, but torch.distributed is "
                             "not initialized")
        return Mesh(None, 0, 1, dev)
    group = dist.group.WORLD if group is None else group
    host_major_devices(dev, group)
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                dev)


def _pad_to(x: torch.Tensor, mult: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[0]
    rem = (-n) % mult
    if rem:
        x = torch.cat([x, x[-1:].expand((rem,) + tuple(x.shape[1:]))])
    return x, n


def shard_batch(x, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of the batch x [n, ...] padded to a
    multiple of the world size (`_pad_to`), on the mesh's device."""
    padded, _ = _pad_to(torch.as_tensor(x).to(mesh.device), mesh.size)
    per = padded.shape[0] // mesh.size
    return padded[mesh.rank * per:(mesh.rank + 1) * per]


def _gather(mesh: Mesh, local: torch.Tensor, n: int) -> torch.Tensor:
    return mesh.all_gather(local)[..., :n]


def _book(mesh: Mesh, strikes, theta_vec):
    ks = douglas.as_strikes(strikes, mesh.device)
    tv = torch.as_tensor(theta_vec).to(device=mesh.device, dtype=ks.dtype)
    return ks, tv


def _lane_steps(group_steps, n: int, solver: SolverConfig) -> torch.Tensor:
    """[n] per-option step counts of (start, end, n_steps) groups that
    tile [0, n) in order, the launch's count the largest
    (heston_tpu/parallel/sharded.py:259-268)."""
    validate_group_steps(group_steps, n, n_steps=solver.n_steps)
    return lane_steps(group_steps)


def _local_prices(spec, solver, american, dividends, option_type, ks, tv,
                  s0, r_d, r_f, nst=None):
    """Prices of this rank's slice: `douglas.price_batch` (kernel 1 under
    "pallas"), or one per-lane launch of kernel 1 for a mixed book."""
    kw = dict(american=american, dividends=dividends,
              option_type=option_type)
    if nst is not None:
        return fused_do.fused_price_batch(spec, solver, ks, s0, *tv, r_d,
                                          r_f, n_steps_per=nst, **kw)
    return douglas.price_batch(spec, solver, ks, s0, *tv, r_d, r_f,
                               device=ks.device, **kw)


def _local_jac(spec, solver, american, dividends, eps, option_type,
               jacobian_mode, ks, tv, s0, r_d, r_f, nst=None):
    """(J [b, 5], base [b]) of this rank's slice
    (heston_tpu/parallel/sharded.py:160-218). "ad": the exact forward
    mode — one launch of kernel 1's forward mode under "pallas" (per-lane
    step counts for a mixed book), the eager loop linearized otherwise;
    "fd": the base and the five bumped rows priced as `_local_prices`
    prices."""
    kw = dict(american=american, dividends=dividends,
              option_type=option_type)
    if jacobian_mode == "ad":
        if nst is not None:
            base, jac = fused_do.fused_theta_jacobian(
                spec, solver, ks, s0, tv, r_d, r_f, n_steps_per=nst, **kw)
            return jac, base
        return calibration.jacobian_and_prices_ad(
            spec, solver, ks, s0, tv, r_d, r_f, device=ks.device, **kw)
    prices = torch.stack([
        _local_prices(spec, solver, american, dividends, option_type, ks,
                      row, s0, r_d, r_f, nst)
        for row in _bumped_param_matrix(tv, eps)])        # [6, b]
    base = prices[0]
    return ((prices[1:] - base[None, :]) / eps).T, base


def _normal_eq(mesh: Mesh, jac, base, mkt, w, lam):
    """The damped normal equations of the whole book: the local
    JᵀJ, Jᵀr and SSE (J and r weighted by w, zero on padded lanes) summed
    over the ranks in one all_reduce, Marquardt's damping, the 5x5 solve
    on every rank."""
    resid = (mkt - base) * w
    jac = jac * w[:, None]
    packed = mesh.all_reduce(torch.cat([(jac.T @ jac).reshape(-1),
                                        jac.T @ resid,
                                        (resid @ resid).reshape(1)]))
    jtj = packed[:N_PARAMS * N_PARAMS].reshape(N_PARAMS, N_PARAMS)
    jtr = packed[N_PARAMS * N_PARAMS:-1]
    jtj = jtj * (1.0 + lam * torch.eye(N_PARAMS, dtype=jtj.dtype,
                                       device=jtj.device))
    delta = torch.linalg.solve_ex(jtj, jtr[:, None])[0][:, 0]
    return delta, packed[-1]


def price_batch_sharded(
    mesh: Mesh,
    spec: GridSpec,
    solver: SolverConfig,
    strikes,
    s0,
    theta_vec,
    r_d,
    r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    group_steps=(),
) -> torch.Tensor:
    """Prices [n] of the book, each rank pricing its slice
    (heston_tpu/parallel/sharded.py:364-416); every rank gets the whole
    result. The dtype is the strikes'.

    group_steps: optional (start, end, n_steps) maturity-ladder slices.
    Under "pallas" each rank prices its slice of the whole mixed book in
    one per-lane launch of kernel 1; "scan" and "pcr" shard each
    maturity group in turn."""
    ks, tv = _book(mesh, strikes, theta_vec)
    n = int(ks.shape[0])
    args = (spec, solver, american, dividends, option_type)
    if group_steps:
        nst = _lane_steps(group_steps, n, solver)
        if solver.solver_engine == "pallas":
            return _gather(mesh, _local_prices(
                *args, shard_batch(ks, mesh), tv, s0, r_d, r_f,
                shard_batch(nst, mesh)), n)
        return torch.cat([
            price_batch_sharded(mesh, spec, greeks._group_solver(solver, g),
                                ks[a:e], s0, tv, r_d, r_f,
                                american=american, dividends=dividends,
                                option_type=option_type)
            for a, e, g in group_steps])
    return _gather(mesh, _local_prices(*args, shard_batch(ks, mesh), tv,
                                       s0, r_d, r_f), n)


def jacobian_normal_eq_sharded(
    mesh: Mesh,
    spec: GridSpec,
    solver: SolverConfig,
    strikes,
    market_prices,
    s0,
    theta_vec,
    r_d,
    r_f,
    lam,
    eps: float = 1e-6,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    jacobian_mode: Optional[str] = None,
    group_steps=(),
    weights=None,
):
    """One distributed LM linear-algebra step
    (heston_tpu/parallel/sharded.py:419-500): each rank's J and residual
    of its slice, JᵀJ, Jᵀr and the SSE summed over the ranks, Marquardt's
    damping JᵀJ_ii *= (1 + lam), the 5x5 solve on every rank. Padded
    lanes have zero weight. Returns (delta [5], base prices [n], sse),
    the same on every rank.

    jacobian_mode: "ad", "fd" or None (float64 "fd", float32 "ad").
    group_steps: optional (start, end, n_steps) slices of a maturity
    ladder; they need solver_engine "pallas" (each rank's slice of the
    whole ladder in one launch: forward mode for "ad", six bumped primal
    launches for "fd"). weights (optional [n]): least-squares weights;
    the normal equations and the SSE become JᵀWJ, JᵀWr and Σ w r²."""
    ks, tv = _book(mesh, strikes, theta_vec)
    n, dtype = int(ks.shape[0]), ks.dtype
    mkt = torch.as_tensor(market_prices).to(device=mesh.device, dtype=dtype)
    n_pad = n + (-n) % mesh.size
    valid = (torch.arange(n_pad, device=mesh.device) < n).to(dtype)
    if weights is not None:
        w = torch.as_tensor(weights).to(device=mesh.device, dtype=dtype)
        valid = valid * torch.sqrt(_pad_to(w, mesh.size)[0])
    per = n_pad // mesh.size
    valid = valid[mesh.rank * per:(mesh.rank + 1) * per]
    mode = _auto_jacobian_mode(jacobian_mode, dtype)
    nst = None
    if group_steps:
        nst = _lane_steps(group_steps, n, solver)
        if solver.solver_engine != "pallas":
            raise ValueError(
                "group_steps needs the fused engine (per-lane step "
                "counts); price each maturity group separately via "
                "calibrate(pricing_fns=sharded_pricing_fns(mesh)) "
                "otherwise")
        nst = shard_batch(nst, mesh)
    jac, base = _local_jac(spec, solver, american, dividends, eps,
                           option_type, mode, shard_batch(ks, mesh), tv, s0,
                           r_d, r_f, nst)
    delta, sse = _normal_eq(mesh, jac, base, shard_batch(mkt, mesh), valid,
                            lam)
    return delta, _gather(mesh, base, n), sse


def batch_greeks_sharded(
    mesh: Mesh,
    spec: GridSpec,
    solver: SolverConfig,
    strikes,
    s0,
    theta_vec,
    r_d,
    r_f,
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    group_steps=(),
):
    """Book risk (the RISK_KEYS columns of `greeks.batch_greeks`) with
    each rank taking its slice of the book
    (heston_tpu/parallel/sharded.py:551-606); a dict of [n] tensors, the
    whole book on every rank.

    group_steps: optional (start, end, n_steps) slices of a mixed book:
    under "pallas" each rank's slice of the whole book in one per-lane
    launch of kernel 1 (`greeks.fused_book_risk`), otherwise each
    maturity group sharded in turn."""
    ks, tv = _book(mesh, strikes, theta_vec)
    n = int(ks.shape[0])
    kw = dict(american=american, dividends=dividends,
              option_type=option_type)
    if group_steps:
        nst = _lane_steps(group_steps, n, solver)
        if solver.solver_engine == "pallas":
            out = greeks.fused_book_risk(
                spec, solver, shard_batch(ks, mesh), s0, *tv, r_d, r_f,
                nst=shard_batch(nst, mesh), **kw)
        else:
            parts = [batch_greeks_sharded(mesh, spec,
                                          greeks._group_solver(solver, g),
                                          ks[a:e], s0, tv, r_d, r_f, **kw)
                     for a, e, g in group_steps]
            return {k: torch.cat([p[k] for p in parts]) for k in RISK_KEYS}
    else:
        out = greeks.batch_greeks(spec, solver, shard_batch(ks, mesh), s0,
                                  *tv, r_d, r_f, device=mesh.device, **kw)
    cols = _gather(mesh, torch.stack([out[k] for k in RISK_KEYS]), n)
    return dict(zip(RISK_KEYS, cols))


def calibrate_sharded(
    mesh: Mesh,
    spec: GridSpec,
    solver: SolverConfig,
    strikes,
    market_prices,
    s0,
    init_vec,
    r_d,
    r_f,
    cfg: Optional[CalibrationConfig] = None,
    group_steps=(),
    american: bool = False,
    dividends: Optional[DividendSchedule] = None,
    option_type: str = "call",
    checkpoint_path: Optional[str] = None,
    weights=None,
):
    """Distributed Levenberg–Marquardt (heston_tpu/parallel/sharded.py:
    609-702): the chain, a maturity ladder included, stays sharded for
    every pass — a Jacobian pass and normal-equation reduction
    (`jacobian_normal_eq_sharded`: under "pallas" one launch of kernel
    1's forward mode per rank for "ad") and a trial pricing
    (`price_batch_sharded`: one launch per rank) — and the host runs the
    accept/reject loop, `calibration.lm_host_loop`, the same on every
    rank.

    The fit's dtype is the strikes' (float32 turns cfg.jacobian_mode
    "fd" into "ad": a 1e-6 bump drowns in float32 rounding).
    checkpoint_path: rank 0 writes the LM state after every iteration;
    every rank resumes from an existing file. weights (optional [n]):
    least-squares weights. Returns (theta_vec [5], info with iterations,
    final_error, converged, fitted_prices and history)."""
    cfg = cfg or CalibrationConfig()
    ks = douglas.as_strikes(strikes, mesh.device)
    if ks.dtype != torch.float64 and cfg.jacobian_mode == "fd":
        cfg = dataclasses.replace(cfg, jacobian_mode="ad")
    market = _host(market_prices, np.float64)
    w_np = None if weights is None else _host(weights, np.float64)
    if w_np is not None and (w_np.shape != market.shape
                             or np.any(w_np < 0)):
        raise ValueError(
            f"weights must be >= 0 with shape {market.shape}; got shape "
            f"{w_np.shape}")
    # fingerprints the problem, not the LM settings
    pkey = problem_key(ks, market, s0, r_d, r_f, american, option_type,
                       spec, solver, group_steps, w_np)
    if checkpoint_path:
        # rank 0 has written its last checkpoint of an earlier call
        mesh.barrier()
    state = LMState(_host(init_vec, np.float64), cfg.lambda_init, 0,
                    float("inf"), False, [],
                    key=pkey).maybe_resume(checkpoint_path)
    kw = dict(american=american, dividends=dividends,
              option_type=option_type, group_steps=group_steps)

    def price(tv):
        return _host(price_batch_sharded(mesh, spec, solver, ks, s0,
                                         torch.as_tensor(tv), r_d, r_f,
                                         **kw), np.float64)

    def eval_step(tv, lam_):
        delta, base, sse = jacobian_normal_eq_sharded(
            mesh, spec, solver, ks, market, s0, torch.as_tensor(tv), r_d,
            r_f, lam=lam_, eps=cfg.eps, jacobian_mode=cfg.jacobian_mode,
            weights=w_np, **kw)
        return (_host(delta, np.float64), _host(base, np.float64),
                float(sse))

    (theta_vec, _, iters, final_error, converged, history, fitted
     ) = calibration.lm_host_loop(
        market, cfg, state, eval_step, price,
        checkpoint_path=checkpoint_path if mesh.rank == 0 else None,
        pkey=pkey, weights=w_np)
    return (torch.as_tensor(theta_vec, device=mesh.device).to(ks.dtype),
            dict(iterations=iters, final_error=final_error,
                 converged=converged, fitted_prices=fitted,
                 history=history))


def sharded_pricing_fns(mesh: Mesh):
    """(jac_fn, price_fn) drop-ins for
    `calibration.calibrate(pricing_fns=...)` that run the book sharded
    over the mesh (heston_tpu/parallel/sharded.py:705-729); jac_fn's
    jacobian_mode None is "fd" in float64 and "ad" in float32."""

    def jac_fn(spec, solver, strikes, s0, theta_vec, r_d, r_f, eps=1e-6,
               american=False, dividends=None, option_type="call",
               jacobian_mode=None):
        ks, tv = _book(mesh, strikes, theta_vec)
        n = int(ks.shape[0])
        jac, base = _local_jac(
            spec, solver, american, dividends, eps, option_type,
            _auto_jacobian_mode(jacobian_mode, ks.dtype),
            shard_batch(ks, mesh), tv, s0, r_d, r_f)
        both = _gather(mesh, torch.cat([jac.T, base[None]]), n)
        return both[:N_PARAMS].T, both[N_PARAMS]

    def price_fn(spec, solver, strikes, s0, theta_vec, r_d, r_f,
                 american=False, dividends=None, option_type="call"):
        return price_batch_sharded(mesh, spec, solver, strikes, s0,
                                   theta_vec, r_d, r_f, american=american,
                                   dividends=dividends,
                                   option_type=option_type)

    return jac_fn, price_fn

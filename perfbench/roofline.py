"""The benchmark's yardstick for the ADI time-loop kernels: the operations
and bytes a launch needs, and the peaks of the card.

Frozen here so that a change to the program does not move it. The counts
are taken from the discretization, not from the emitted instructions:
each add, multiply, divide or compare counts one; every stencil of a
surface is formed once per point and step and its differences are
shared; products of coefficient rows alone (the A0 coefficient and its
tangents, the implicit bands, the American floor) are step-invariant and
counted once per launch; per tangent only the terms that involve that
tangent. Bytes: each input read once and each output written once,
whatever the kernel reads again. A share of this bound can therefore not
pass 100% unless the time leaves out work or the counts are too high.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit: float32 outside
# the tensor cores and the HBM rate
H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12

# Primal, per point and step: s-differences 2, beta_s 3, beta_v 5, A2 with
# reaction 13, A1 10, sum 3, dt-scale 1 (+ lam 1); Thomas 5, penta 9;
# update 4 (American 9: compensated sum, floor, multiplier).
FLOPS_STEP = {False: 55, True: 61}
# with tangents, once per point and step: z1's s-differences and A1
# P-term 5, z2's v-differences 4
FLOPS_STEP_TANGENT_SHARED = 9
# per tangent, point and step: tangent beta_v bands 3, the tangent
# surface's beta_s and beta_v 10, A0 term 4, dA1 u 1, A1 du 10, dA2 u 7,
# A2 du 13, sum and dt-scale 5, td dA1 z1 2 (+ dlam 1); Thomas 5; td dA2
# z2 8, penta 9; update 1 (American 2)
FLOPS_STEP_PER_TANGENT = {False: 78, True: 80}
# per point and launch: the Thomas factorization 14 and c_a0 1; per
# tangent its dc_a0 3
FLOPS_SETUP = 15
FLOPS_SETUP_PER_TANGENT = 3
# per point and dividend event: the fold 1, the 2-point remap 5, the 2Sum
# 6; per tangent the remap 5 and its sum 1
FLOPS_EVENT = 12
FLOPS_EVENT_PER_TANGENT = 6
# puts and barriers remap the compensation beside u instead of folding
# it: per point and event the second remap 5 and the add of u's rounding
# 1, less the fold 1. The American floor row, per s-node and launch: the
# intrinsic and its floor 2 (calls, puts), a digital's cell average 8
FLOPS_EVENT_APART = 5
FLOPS_FLOOR = {False: 2, True: 8}
# a corrector scheme, per point and step (its L u is the predictor's):
# CS A0 z2 11, rhs 2, Thomas 5, penta 9; MCS and HV L z2 36, rhs 4,
# Thomas 5, penta 9, HV's increment 1
FLOPS_STEP_CORRECTOR = {"do": 0, "cs": 27, "mcs": 54, "hv": 55}
FLOPS_STEP_CORRECTOR_TANGENT_SHARED = {"do": 0, "cs": 9, "mcs": 9, "hv": 9}
FLOPS_STEP_CORRECTOR_PER_TANGENT = {"do": 0, "cs": 44, "mcs": 81, "hv": 81}
# per step, the boundary terms beyond Douglas's on (each s-node, each
# v-node)
BOUNDARY_STEP_CORRECTOR = {"do": (0, 0), "cs": (2, 0), "mcs": (4, 2),
                           "hv": (2, 2)}


def kernel_bound(lane_steps, lane_events, ns, nv, n_events, itemsize,
                 american, n_tangents=0, per_lane=False, scheme="do",
                 option_type="call", knocked=()):
    """(bound_ms, bound_by, flops, bytes) of one launch of the batched
    kernel (or of the single-option kernel, lane_steps of length 1): the
    larger of the operations over the float32 peak and the bytes over the
    HBM rate. lane_steps, lane_events: per option, the steps it runs and
    the dividend events it applies (its own count in a mixed book);
    n_events: the events whose remap rows the launch reads; per_lane: the
    launch also reads the [B] int32 step counts."""
    b = len(lane_steps)
    steps, events = sum(lane_steps), sum(lane_events)
    npts = ns * nv
    step = FLOPS_STEP[american] + FLOPS_STEP_CORRECTOR[scheme]
    if n_tangents:
        step += (FLOPS_STEP_TANGENT_SHARED
                 + FLOPS_STEP_CORRECTOR_TANGENT_SHARED[scheme]
                 + n_tangents * (FLOPS_STEP_PER_TANGENT[american]
                                 + FLOPS_STEP_CORRECTOR_PER_TANGENT[scheme]))
    s_extra, v_extra = BOUNDARY_STEP_CORRECTOR[scheme]
    apart = option_type in ("put", "digital_put") or bool(knocked)
    flops = (npts * (b * (FLOPS_SETUP + n_tangents * FLOPS_SETUP_PER_TANGENT)
                     + steps * step
                     + events * (FLOPS_EVENT
                                 + (FLOPS_EVENT_APART if apart else 0)
                                 + n_tangents * FLOPS_EVENT_PER_TANGENT))
             # per step, the boundary injections: 4 on each s-node and 2
             # on each v-node, and the corrector's
             + steps * ((4 + s_extra) * ns + (2 + v_extra) * nv)
             + (b * ns * FLOPS_FLOOR["digital" in option_type]
                if american else 0))
    # u0 and u_out, the coefficient rows (11 s-rows, 9
    # v-rows, 2 scalars), the remap rows (int32 indices + weights);
    # tangents: their rows (1 s-row, 8 v-rows each) and their surfaces out
    values = b * (2 * npts + 11 * ns + 9 * nv + 2
                  + 2 * n_events * ns + n_tangents * (ns + 8 * nv + npts))
    nbytes = (values * itemsize + b * 2 * n_events * ns * 4
              + (4 * b if per_lane else 0))
    t_ops, t_bytes = flops / H100_FP32_FLOPS, nbytes / H100_HBM_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def dividend_steps(dividends, dt: float, n_steps: int):
    """The local steps (1..n_steps) before which each dividend of
    (date, amount, pct) is applied: n dt <= date < (n + 1) dt."""
    return [n for n in range(1, n_steps + 1)
            for date, _, _ in dividends if n * dt <= date < (n + 1) * dt]


def lane_events(event_steps, lane_steps):
    """Per option, the dividend events at or below its own step count."""
    return [sum(1 for s in event_steps if s <= n) for n in lane_steps]

"""Typed configuration layer of the PyTorch port.

The port's own copy of the JAX package's configuration dataclasses
(`heston_tpu.config`), field for field, so that `heston_tpu_torch`
imports nothing of the JAX package. Static (Python) fields set the
structure of a call: grid sizes, step counts, dividend schedules. Model
parameters, spot and strikes are plain floats or tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class HestonParams:
    """Heston model parameters (kappa, eta, sigma, rho, v0) + rates.

    Canonical test set matches the reference fixture
    (ref: src/solver.cpp:322-341): S0=K=100, v0=0.04, T=1, r_d=0.025,
    r_f=0, rho=-0.9, sigma=0.3, kappa=1.5, eta=0.04.
    """

    kappa: float = 1.5   # mean-reversion speed
    eta: float = 0.04    # long-run variance
    sigma: float = 0.3   # vol-of-vol
    rho: float = -0.9    # correlation
    v0: float = 0.04     # initial variance
    r_d: float = 0.025   # domestic rate
    r_f: float = 0.0     # foreign rate

    def bumpable(self) -> Tuple[float, float, float, float, float]:
        """The 5 calibrated parameters, in the reference's Jacobian column
        order (ref: src/jacobian_computation.cpp:299-303, param 4 = v0)."""
        return (self.kappa, self.eta, self.sigma, self.rho, self.v0)


@dataclasses.dataclass(frozen=True)
class Barrier:
    """Continuously-monitored knock-out barrier (static).

    A knock-out barrier is a DOMAIN truncation plus a Dirichlet-0
    boundary: "up-out" prices on S in [0, level] with U(level) = 0,
    "down-out" on [level, s_max_mult*K] with U(level) = 0, and
    "double-out" on [level, level_hi] with BOTH boundary values 0 —
    which is why it lives on GridSpec (the domain owner) and flows
    statically through every engine the way the grid shape does.
    Framework extension: the reference prices vanillas only.
    """

    kind: str            # "up-out" | "down-out" | "double-out"
    level: float         # the barrier (lower barrier for double-out)
    level_hi: float | None = None    # upper barrier (double-out only)

    def __post_init__(self):
        if self.kind not in ("up-out", "down-out", "double-out"):
            raise ValueError(
                f"barrier kind must be 'up-out', 'down-out' or "
                f"'double-out'; got {self.kind!r}")
        if not self.level > 0.0:
            raise ValueError(f"barrier level must be > 0; got {self.level}")
        if self.kind == "double-out":
            if self.level_hi is None or not self.level_hi > self.level:
                raise ValueError(
                    "double-out needs level_hi > level; got "
                    f"level={self.level}, level_hi={self.level_hi}")
        elif self.level_hi is not None:
            raise ValueError(
                f"level_hi is double-out only; got kind={self.kind!r}")

    @property
    def is_up(self) -> bool:
        return self.kind == "up-out"

    @property
    def knock_top(self) -> bool:
        """The TOP s node is a knocked (Dirichlet-0) barrier column."""
        return self.kind in ("up-out", "double-out")

    @property
    def knock_bottom(self) -> bool:
        """The BOTTOM s node is a knocked (Dirichlet-0) barrier column."""
        return self.kind in ("down-out", "double-out")

    def mask_payoff(self, u):
        """A copy of the payoff surface `u` (a tensor) with the knocked
        column(s) along the LAST axis (the s axis) zeroed — the masking
        rule every engine shares."""
        u = u.clone()
        if self.knock_top:
            u[..., -1] = 0.0
        if self.knock_bottom:
            u[..., 0] = 0.0
        return u

    @property
    def lo(self) -> float:
        """Lower end of the alive S domain (0 for up-out)."""
        return 0.0 if self.kind == "up-out" else self.level

    def hi(self, s_max: float) -> float:
        """Upper end of the alive S domain (s_max for down-out)."""
        if self.kind == "up-out":
            return self.level
        return s_max if self.kind == "down-out" else self.level_hi


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Non-uniform sinh grid specification.

    Defaults replicate `create_test_grid` / the per-strike grids used in
    calibration (ref: src/grid.cpp:99-110, src/heston_calibration.cpp:124):
    S_max = 8K, c = K/5, V_max = 5, d = V_max/500.

    barrier: optional knock-out barrier — truncates the S domain at
    barrier.level (up-out: [0, level]; down-out: [level, s_max_mult*K])
    and pins that boundary node to value 0 (payoff masked, boundary
    injection zeroed, dividend re-maps re-knocked).
    """

    m1: int = 50          # number of S intervals (m1+1 nodes)
    m2: int = 25          # number of V intervals (m2+1 nodes)
    s_max_mult: float = 8.0    # S domain upper bound = s_max_mult * K
    c_mult: float = 0.2        # sinh concentration c = c_mult * K
    v_max: float = 5.0         # V domain upper bound
    d_div: float = 500.0       # sinh concentration d = v_max / d_div
    barrier: "Barrier | None" = None   # knock-out domain truncation

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m2 + 1, self.m1 + 1)

    @property
    def total_size(self) -> int:
        return (self.m1 + 1) * (self.m2 + 1)


@dataclasses.dataclass(frozen=True)
class DividendSchedule:
    """Discrete dividend schedule (static).

    The reference threads host vectors of dates/amounts/percentages through
    the steppers and re-maps the surface inside the dividend window
    (ref: src/solver.hpp:310-474). Here the schedule is static so the
    per-time-step event table is computed before the time loop runs.
    """

    dates: Tuple[float, ...] = ()
    amounts: Tuple[float, ...] = ()
    percentages: Tuple[float, ...] = ()

    def __post_init__(self):
        if not (len(self.dates) == len(self.amounts) == len(self.percentages)):
            raise ValueError("dividend schedule fields must have equal length")

    def __len__(self) -> int:
        return len(self.dates)

    def events_for_step(self, n: int, delta_t: float) -> list:
        """Dividends processed before PDE step n (1-based).

        Window: n*dt <= date < (n+1)*dt, processed in date order — replicates
        the host while-loop (ref: src/solver.hpp:363) and the device window
        check (ref: src/device_solver.hpp:433-437).
        """
        t = n * delta_t
        out = []
        for date, amt, pct in zip(self.dates, self.amounts, self.percentages):
            if t <= date < (n + 1) * delta_t:
                out.append((amt, pct))
        return out


@dataclasses.dataclass(frozen=True)
class RateSchedule:
    """Piecewise-constant term structures for r_d and r_f (framework
    extension — the reference prices at flat rates only).

    `times` are strictly-increasing breakpoints in CALENDAR time from
    the valuation date (t = 0 today, t = maturity at expiry); segment i
    covers [times[i-1], times[i]) with rates r_d[i] / r_f[i], so
    len(r_d) == len(r_f) == len(times) + 1. The whole schedule is
    STATIC (plain floats, like DividendSchedule): per-step rates are
    resolved before the time loop runs, each PDE step sampling the curve at the
    step's calendar midpoint t = maturity - (n - 1/2)*delta_t — exact
    for curves whose breakpoints align with step boundaries, nearest-
    step rounding otherwise.

    NOTE the coordinate difference vs DividendSchedule: dividend dates
    live on the PDE's own step axis (the reference's window convention,
    ref: src/solver.hpp:363), while rate times are calendar — a mixed-
    maturity book shares ONE calendar curve, so the same schedule maps
    to different step windows per maturity group.

    When a RateSchedule is passed, the scalar r_d / r_f arguments of
    the pricing entry points are IGNORED for the PDE coefficients and
    discounting (they remain inert positional slots)."""

    times: Tuple[float, ...]
    r_d: Tuple[float, ...]
    r_f: Tuple[float, ...]

    def __post_init__(self):
        if not (len(self.r_d) == len(self.r_f) == len(self.times) + 1):
            raise ValueError(
                "RateSchedule needs len(r_d) == len(r_f) == "
                f"len(times) + 1; got times={len(self.times)}, "
                f"r_d={len(self.r_d)}, r_f={len(self.r_f)}")
        if any(t2 <= t1 for t1, t2 in zip(self.times, self.times[1:])):
            raise ValueError(
                f"RateSchedule times must be strictly increasing; "
                f"got {self.times}")
        if self.times and self.times[0] <= 0.0:
            raise ValueError(
                f"RateSchedule times must be > 0; got {self.times}")

    def value_at(self, t: float) -> Tuple[float, float]:
        """(r_d, r_f) at calendar time t (right-continuous; t < times[0]
        takes segment 0, t >= times[-1] the last segment)."""
        i = 0
        for brk in self.times:
            if t < brk:
                break
            i += 1
        return self.r_d[i], self.r_f[i]

    def step_rates(self, n_steps: int, delta_t: float,
                   maturity: float) -> Tuple[Tuple[float, float], ...]:
        """Per-PDE-step (r_d, r_f), index n = 1..n_steps (entry n-1).
        Step n marches tau (time-to-expiry) over [(n-1)*dt, n*dt] =
        calendar [maturity - n*dt, maturity - (n-1)*dt]; the curve is
        sampled at the step's calendar midpoint."""
        return tuple(
            self.value_at(maturity - (n - 0.5) * delta_t)
            for n in range(1, n_steps + 1))

    def step_segments(self, n_steps: int, delta_t: float,
                      maturity: float):
        """Group consecutive equal-rate steps: tuple of
        (n_lo, n_hi, r_d, r_f) with 1-based INCLUSIVE step ranges
        covering 1..n_steps in ascending order."""
        per = self.step_rates(n_steps, delta_t, maturity)
        segs = []
        lo = 1
        for n in range(2, n_steps + 1):
            if per[n - 1] != per[lo - 1]:
                segs.append((lo, n - 1) + per[lo - 1])
                lo = n
        segs.append((lo, n_steps) + per[lo - 1])
        return tuple(segs)

    def average_rates(self, maturity: float) -> Tuple[float, float]:
        """(1/T * integral of r_d, 1/T * integral of r_f) over calendar
        [0, maturity] — the flat-rate equivalents. For EUROPEAN payoffs
        under Heston, deterministic rates enter only through the
        discount factor and the forward, both functions of these
        integrals alone, so the continuum curve price EQUALS the
        flat-average price (the test oracle for this feature)."""
        knots = [0.0] + [min(t, maturity) for t in self.times
                         if t < maturity] + [maturity]
        i_d = i_f = 0.0
        for k, (t0, t1) in enumerate(zip(knots, knots[1:])):
            i_d += self.r_d[k] * (t1 - t0)
            i_f += self.r_f[k] * (t1 - t0)
        return i_d / maturity, i_f / maturity


# The golden-test dividend schedule (ref: src/solver.cpp:788-790)
GOLDEN_DIVIDENDS = DividendSchedule(
    dates=(0.2, 0.4, 0.6, 0.8),
    amounts=(0.5, 0.3, 0.2, 0.1),
    percentages=(0.02, 0.02, 0.02, 0.02),
)


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """ADI time-stepping configuration.

    theta = 0.8 is the reference's universal choice
    (ref: src/solver.cpp:342)."""

    n_steps: int = 20
    theta: float = 0.8
    maturity: float = 1.0
    # A2 v-direction operator variant:
    #   "central" — the v-major operator used by the single-option golden path
    #     (no upwinding; ref: src/hes_A2_mat.cpp:37-109)
    #   "upwind"  — the shuffled/production operator that adds backward-upwind
    #     convection rows where v > 1 (ref: src/hes_A2_mat.cpp:410-421,
    #     src/hes_a2_shuffled_kernels.hpp:129-138)
    a2_variant: str = "upwind"
    # Banded-solver engine: "scan" (sequential Thomas, exact reference
    # recurrence order), "pcr" (log-depth associative-scan), "pallas"
    # (fused TPU kernel).
    solver_engine: str = "scan"
    # Time scheme: "do" (Douglas, ref src/solver.hpp:19), "cs" (Craig-Sneyd
    # with the 1/2 mixed-term corrector, ref src/solver.hpp:678), "mcs"
    # (modified Craig-Sneyd; the reference's version is marked broken at
    # src/solver.hpp:915 — ours implements the textbook in 't Hout-Foulon
    # form) or "hv" (Hundsdorfer-Verwer — framework extension beyond the
    # reference's three; the scheme in 't Hout & Foulon 2010 recommend
    # for Heston. Order 2 in time for any theta; theta = 1/2 + sqrt(3)/6
    # ~ 0.7887 is the standard unconditionally-stable choice). All four
    # compose with American exercise, dividend schedules and
    # mixed-maturity books on every engine (the reference ships
    # American/dividend steppers for DO only).
    scheme: str = "do"
    # Rannacher start-up damping (framework extension — no reference
    # analog): replace each of the first `rannacher_steps` time steps by
    # TWO half-dt fully-implicit (theta = 1) Douglas sub-steps. The
    # nonsmooth payoff excites the weakly-damped high-frequency modes of
    # the second-order schemes (and of theta ~ 1/2 generally); a few
    # strongly-damping start-up steps restore clean convergence orders
    # and smooth greeks near the strike (Rannacher 1984; in 't Hout &
    # Wyns 2016 apply the same device to ADI on Heston). 0 disables;
    # values above n_steps damp the whole horizon (clamped — mixed-
    # maturity groups re-derive solvers with smaller n_steps).
    # Composes with every scheme, American exercise, dividend schedules
    # and mixed-maturity books on EVERY engine (the fused kernels run
    # the damped window as extra launches of the same kernel at static
    # theta=1, dt/2 constants; the native C++ engine runs the same
    # phase plan).
    rannacher_steps: int = 0

    @property
    def delta_t(self) -> float:
        return self.maturity / self.n_steps

    def damping_solver(self) -> "SolverConfig":
        """The start-up phase's solver view: Douglas at theta = 1 with
        2x the step count (so `delta_t` halves and sub-step k's boundary
        factors e^{rate*(dt/2)*k} land on the right absolute times)."""
        return dataclasses.replace(
            self, scheme="do", theta=1.0, n_steps=2 * self.n_steps,
            rannacher_steps=0)


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Levenberg–Marquardt settings (ref: src/heston_calibration.cpp:55-68,
    286-290, 398-408)."""

    max_iter: int = 15
    tol: float = 0.1
    eps: float = 1e-6          # FD bump size
    # Jacobian mode: "fd" (finite-difference bumps, reference-faithful,
    # ref: src/jacobian_computation.cpp:292-361) or "ad" (forward-mode
    # autodiff through the whole PDE solve — exact derivatives, required
    # for float32 where a 1e-6 bump drowns in rounding noise).
    jacobian_mode: str = "fd"
    lambda_init: float = 0.01
    lambda_down: float = 0.1
    lambda_up: float = 10.0
    lambda_min: float = 1e-7
    lambda_max: float = 1e7
    # parameter clamps (ref: src/heston_calibration.cpp:286-290)
    kappa_min: float = 1e-3
    eta_min: float = 1e-2
    sigma_min: float = 1e-2
    rho_min: float = -1.0
    rho_max: float = 1.0
    v0_min: float = 1e-2

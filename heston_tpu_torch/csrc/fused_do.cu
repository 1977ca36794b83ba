// Batched ADI time loop for the Heston PDE, one launch per book.
//
// Replaces heston_tpu/pallas/fused_do.py::_make_kernel (primal and forward
// mode, schemes "do", "cs", "mcs" and "hv", calls, puts and cash-or-nothing
// digitals, with or without a knock-out barrier, European or American, with
// or without discrete dividends). The host side is
// heston_tpu_torch/kernels/fused_do.py, whose fused_do_reference is the
// plain PyTorch version of exactly this arithmetic.
//
// What bounds it on an H100: the latency of the dependent sweeps. Every
// time step runs a Thomas solve along s and a pentadiagonal solve along v,
// each a forward and a backward recurrence, so 2*(ns + nv) rows follow one
// another per step (154 at the 51 x 26 production grid; twice that with a
// corrector scheme) — neither bytes nor FLOPs: one option's working set is
// a few tens of KB and the arithmetic per step is ~50 flops per grid point
// (~100 with a corrector). The design answers it with breadth: one thread
// block per option, the independent grid lines of each sweep spread over
// the block's threads, and the whole book in one launch (500 options are
// about one wave of blocks on 132 SMs, 4 blocks per SM). The working
// fields live in per-option global scratch that the wrapper allocates;
// keeping them in shared memory is later work.
//
// One launch runs one piece of the host's phase plan: the local steps
// first_step..n_steps at one (theta, dt, scheme, boundary rate rf) — the
// whole loop, or the Rannacher start-up phase (Douglas, theta = 1, dt/2)
// and then the main phase, each split at a rate curve's segment boundaries
// (heston_tpu/pallas/fused_do.py:1728-1742: a piece takes its segment's
// coefficient rows, boundary data and rf, so the same body serves it). The
// state crosses launches as u (compensation folded in) and the LCP
// multiplier unscaled: the kernel loads dt*lam0 and stores lam/dt; in
// forward mode the tangent surfaces du_k and multiplier tangents dlam_k
// cross the same way (du0, dlam0 in; du_out, dlam_out out; null inputs
// start them at zero; :1677-1690, :1159-1162, :1248-1252).
//
// Mixed-maturity books (per_lane_steps of the TPU kernel, :367-380,
// :424-434, :1088-1102, :1143-1205): with a non-null nst [B], block b runs
// the local steps first_step..min(n_steps, nst[b]) and applies only the
// dividend events at or below that bound, then writes its state as at the
// end of a full launch. The TPU kernel runs a tile to its largest count
// and freezes each lane past its own (state, compensation, multiplier and
// tangents kept; identity remap rows for later events); the block stops
// instead. The two agree bit for bit: an identity event folds the
// compensation into u by 2Sum and leaves (fl(u + comp), 0), the value the
// final fold writes, and passes lam and the tangents through unchanged.
// With a null nst every block runs the phase's full count.
//
// Each step (local n; the dividend events of step n are applied first):
//   1. point-parallel rhs1 = dt*(A0 + A1 + A2) u + injections (+ dt*lam),
//      every stencil in difference form with the analytic reaction rows;
//      a corrector scheme keeps L u;
//   2. Thomas solve of (I - theta dt A1) along s, one thread per v-line;
//   3./4. the b2 injection on v-row nv-1, then the pentadiagonal solve of
//      (I - theta dt A2) along v, one thread per s-line: d = z2;
//   C. the corrector (SCHEME != DO, TPU kernel :833-911), in delta form:
//      a point-parallel pass builds its stage-1 rhs into e from the kept
//      L u and the stencils of z2 = d (CS: + dt/2 A0 z2; MCS: + theta dt
//      A0 z2 + (1/2 - theta) dt (L z2 + the boundary growth); HV: + dt/2
//      L z2 - z2, its increment relative to y2 = u + z2), then both solves
//      again on e (HV without the b2 injection);
//   5. point-parallel Fast2Sum update u' = u + increment (d; e for CS and
//      MCS; d + e for HV) with the compensation carry, the American floor
//      and the dt-scaled multiplier.
// The scheme is a template parameter: the Douglas instantiation compiles
// to the same arithmetic with or without the corrector's code beside it.
// Both factorizations run once per launch. Build without fast-math: the
// compensation needs IEEE adds. The -fmad=false build keeps every rounding
// that of the plain version; the -fmad=true build contracts multiply-adds
// into FMAs, as XLA does for the TPU kernel (ROADMAP C9); the compensated
// sums are adds only, so both builds keep them exact.
//
// The payoff (TPU kernel flags put / digital / barrier_pos) comes as plain
// launch arguments, uniform over the launch, so its branches cost a warp
// nothing: `payoff` (call, put, digital call, digital put), `n_react` (the
// A2 rows with the -r_d/2 reaction: nv - 2 for calls, nv for puts,
// digitals and top-knocked barriers, :592-598), up to two knocked s
// columns and `apart` (the separate remap below). One template flag, GEN,
// keeps the other payoffs' branches out of the plain call's loop. The
// American floor is built once a launch into a row of ns values in shared
// memory: the call or put intrinsic, or a digital's clipped cell average
// (:506-534), zero at the knocked columns.
// An American digital is projected instead of penalized (:922-941, tangent
// :1058-1070): u is pinned to the floor where the floor is 1, else
// min(max(q, floor), 1); the compensation restarts where a bound binds and
// the multiplier is carried unchanged. Knocked columns stay exactly zero:
// the payoff and the boundary data arrive masked, every operator keeps a
// zero column at zero, and a top knock's remap rows are zero. For puts and
// barriers (`apart`) a dividend remaps u and the compensation separately,
// each in difference form, u's captured rounding added to the remapped
// compensation (:1221-1232); calls fold the compensation into u first.
//
// Forward-mode variant (TAN = true; entry points fused_do_tangent_*).
// Replaces the same TPU kernel built with n_tangents=K
// (heston_tpu/pallas/fused_do.py:328, tangent phase :961-1102), the
// calibration Jacobian's launch. K tangent surfaces du_k (and the
// American multiplier tangents dlam_k) go through every step beside the
// primal, each implicit solve reusing the primal factors:
// dz1 = T1^-1 (dR1 + td dA1 z1), dz2 = T2^-1 (dz1 + td dA2 z2). The
// tangent phase runs after the primal solves (and the corrector), before
// the update, the only point where u, z1 (copied in phase 3/4), z2, the
// corrector's z1c and e, lam and comp are all live; phase 5 then updates
// the tangents (XLA's maximum-JVP, 0.5 on ties, on the same compensated q
// and lam_arg) and the primal together. A corrector scheme differentiates
// its stage-1 rhs (the predictor's tangent rhs, kept, plus the tangents of
// its A0 z2 or L z2 terms) and solves again against z1c and e (:1008-1054).
// Dividend remaps move every tangent with the same 2-point weights.
// What bounds it: again the dependent sweeps, now 2*(ns + nv) primal rows
// plus the tangents' per step. The K tangent solves are independent of
// each other, so the design spreads the K*nv Thomas lines and the K*ns
// penta lines over a 256-thread block (104 and 204 at the 51 x 26 grid
// with K = 4): the dependent chain per step about doubles instead of
// growing (1 + K)-fold. The per-option tangent rows sit in shared memory
// beside the primal ones; du_k and dlam_k live in their output buffers, the
// tangent rhs and the z1 copies in per-option global scratch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// per-option coefficient rows, in the wrapper's packing order
enum SField { PL, QL, PD, QD, PU, QU, SFAC, BSM, BSP, B2R, VECS, NSF };
enum VField { VFL, VFAC, BVM, BVP, AL2, AL1, AD, AU1, AU2, NVF };
// per-option scratch fields [ns * nv]; LUW (the predictor's L u) and EW
// (the corrector's rhs and increment) only with a corrector scheme
enum Work { COMP, LAM, DW, TW, TI, LUW, EW };
// pentadiagonal factors [nv], in shared memory
enum Penta { PM, PGM, PHM, PC, PC2, NPF };
// per-option, per-tangent rows of the forward-mode variant: one s-row
// (the tangent of sfac) and these v-rows, in the wrapper's packing order
enum TVField { TVFL, TVFAC, TBVM, TBVP, TAL2, TAL1, TAU1, TAU2, NTVF };
// time-loop schemes, in the order of fused_do.SCHEMES
enum Scheme { DO, CS, MCS, HV };
// payoffs, in the order of operators.OPTION_TYPES
enum Payoff { CALL, PUT, DIGITAL_CALL, DIGITAL_PUT };

// Threads of a block: the forward-mode variant spreads its K*nv and K*ns
// sweep lines over twice the primal's. A corrector scheme's primal loop
// asks for 4 resident blocks an SM, which caps it at 128 registers a
// thread: left unbounded it takes 133-136 in float32, 3 blocks an SM, and
// a 500-option book then needs two waves on 132 SMs. Douglas keeps the
// compiler's own choice (80 registers in float32).
constexpr int kPrimalThreads = 128;
constexpr int kPrimalBlocksPerSm = 4;
constexpr int kTangentThreads = 256;

template <typename T> __device__ __forceinline__ T exp_t(T x);
template <> __device__ __forceinline__ float exp_t<float>(float x) {
  return expf(x);
}
template <> __device__ __forceinline__ double exp_t<double>(double x) {
  return exp(x);
}

// The American floor at s column i of the s-grid vs (TPU kernel :506-534):
// zero at a knocked column; max(s - K, 0) (calls) or max(K - s, 0) (puts);
// a digital's indicator averaged over the dual cell [lo, hi] around s_i,
// clipped to [0, 1] (operators.grid_payoff), with the den guard of a
// degenerate cell
template <typename T>
__device__ __forceinline__ T floor_at(const T* vs, int i, int ns, T kk,
                                      int payoff, int knock0, int knock1) {
  const T zero = T(0);
  const T one = T(1);
  if (i == knock0 || i == knock1) return zero;
  const bool put = payoff == PUT || payoff == DIGITAL_PUT;
  const T s = vs[i];
  if (payoff == CALL || payoff == PUT) {
    const T intrinsic = put ? kk - s : s - kk;
    return intrinsic > zero ? intrinsic : zero;
  }
  const T hi = i == ns - 1 ? s : T(0.5) * (s + vs[i + 1]);
  const T lo = i == 0 ? s : T(0.5) * (s + vs[i - 1]);
  const T den = hi == lo ? one : hi - lo;
  const T r = (put ? kk - lo : hi - kk) / den;
  return r < zero ? zero : (r > one ? one : r);
}

// The explicit operator's three parts at point (i, j) of the s-major
// surface x, in difference form with the analytic reactions:
// a0 = c_a0 * beta_v(beta_s x), a1 = A1 x, a2 = A2 x; L x = (a0 + a1) + a2.
template <typename T>
__device__ __forceinline__ void l_parts(const T* x, int i, int j, int ns,
                                        int nv, const T* sf, const T* vf,
                                        T react_row, int n_react, T& a0,
                                        T& a1, T& a2) {
  const T zero = T(0);
  const int m1 = ns - 1;
  const T* row = x + i * nv;
  const T* rlo = i > 0 ? row - nv : nullptr;
  const T* rhi = i < m1 ? row + nv : nullptr;
  const T xv = row[j];
  const T bsm = sf[BSM * ns + i];
  const T bsp = sf[BSP * ns + i];
  // beta_s stencil at column jj of this s-row (zero outside the grid)
  auto dsu_at = [&](int jj) -> T {
    if (jj < 0 || jj >= nv) return zero;
    const T c = row[jj];
    const T cm = rlo ? rlo[jj] : zero;
    const T cp = rhi ? rhi[jj] : zero;
    return bsm * (cm - c) + bsp * (cp - c);
  };
  const T dlo = (rlo ? rlo[j] : zero) - xv;
  const T dhi = (rhi ? rhi[j] : zero) - xv;
  const T dsu = bsm * dlo + bsp * dhi;
  const T dv = vf[BVM * nv + j] * (dsu_at(j - 1) - dsu)
               + vf[BVP * nv + j] * (dsu_at(j + 1) - dsu);
  const T xm2 = j >= 2 ? row[j - 2] : zero;
  const T xm1 = j >= 1 ? row[j - 1] : zero;
  const T xp1 = j + 1 < nv ? row[j + 1] : zero;
  const T xp2 = j + 2 < nv ? row[j + 2] : zero;
  const T react_v = j < n_react ? react_row : zero;
  a2 = vf[AL2 * nv + j] * (xm2 - xv) + vf[AL1 * nv + j] * (xm1 - xv)
       + vf[AU1 * nv + j] * (xp1 - xv) + vf[AU2 * nv + j] * (xp2 - xv)
       + react_v * xv;
  const T react_s = i == 0 ? sf[QD * ns] : react_row;
  const T pterm = sf[PL * ns + i] * dlo + sf[PU * ns + i] * dhi;
  const T qterm = sf[QL * ns + i] * dlo + sf[QU * ns + i] * dhi;
  a1 = vf[VFL * nv + j] * pterm + qterm + react_s * xv;
  a0 = (sf[SFAC * ns + i] * vf[VFAC * nv + j]) * dv;
}

// The tangent terms at point (i, j) of one direction (its rows tsf_k, tv)
// on the primal surface x and the tangent surface y:
// da0 = dA0 x + A0 y (coefficient and v-weight motion, then A0 on y);
// mtx = dA1 x (P rows times dvfl); a2tx = dA2 x (zero-sum bands);
// a1y = A1 y and a2y = A2 y, each with its reaction.
template <typename T>
__device__ __forceinline__ void tangent_parts(
    const T* x, const T* y, int i, int j, int ns, int nv, const T* sf,
    const T* vf, T tsfk, const T* tv, T react_row, int n_react, T& da0,
    T& mtx, T& a2tx, T& a1y, T& a2y) {
  const T zero = T(0);
  const int m1 = ns - 1;
  const int k = i * nv + j;
  const T bsm = sf[BSM * ns + i];
  const T bsp = sf[BSP * ns + i];
  // beta_s stencil of surface f at column jj of s-row i
  auto ds_at = [&](const T* f, int jj) -> T {
    if (jj < 0 || jj >= nv) return zero;
    const T c = f[i * nv + jj];
    const T cm = i > 0 ? f[(i - 1) * nv + jj] : zero;
    const T cp = i < m1 ? f[(i + 1) * nv + jj] : zero;
    return bsm * (cm - c) + bsp * (cp - c);
  };
  // primal x
  const T xv = x[k];
  const T dlo = (i > 0 ? x[k - nv] : zero) - xv;
  const T dhi = (i < m1 ? x[k + nv] : zero) - xv;
  const T dsu = bsm * dlo + bsp * dhi;
  const T dsm = ds_at(x, j - 1);
  const T dsp = ds_at(x, j + 1);
  const T dv = vf[BVM * nv + j] * (dsm - dsu) + vf[BVP * nv + j] * (dsp - dsu);
  const T dvt = tv[TBVM * nv + j] * (dsm - dsu)
                + tv[TBVP * nv + j] * (dsp - dsu);
  // tangent y
  const T yx = y[k];
  const T ydlo = (i > 0 ? y[k - nv] : zero) - yx;
  const T ydhi = (i < m1 ? y[k + nv] : zero) - yx;
  const T ydsu = bsm * ydlo + bsp * ydhi;
  const T ydv = vf[BVM * nv + j] * (ds_at(y, j - 1) - ydsu)
                + vf[BVP * nv + j] * (ds_at(y, j + 1) - ydsu);
  const T c_a0 = sf[SFAC * ns + i] * vf[VFAC * nv + j];
  const T dca0 = tsfk * vf[VFAC * nv + j] + sf[SFAC * ns + i] * tv[TVFAC * nv + j];
  da0 = (dca0 * dv + c_a0 * dvt) + c_a0 * ydv;
  const T dvfl = tv[TVFL * nv + j];
  mtx = (dvfl * sf[PL * ns + i]) * dlo + (dvfl * sf[PU * ns + i]) * dhi;
  const T react_s = i == 0 ? sf[QD * ns] : react_row;
  a1y = vf[VFL * nv + j] * (sf[PL * ns + i] * ydlo + sf[PU * ns + i] * ydhi)
        + (sf[QL * ns + i] * ydlo + sf[QU * ns + i] * ydhi) + react_s * yx;
  const T* row = x + i * nv;
  const T* yrow = y + i * nv;
  const T xm2 = j >= 2 ? row[j - 2] : zero;
  const T xm1 = j >= 1 ? row[j - 1] : zero;
  const T xp1 = j + 1 < nv ? row[j + 1] : zero;
  const T xp2 = j + 2 < nv ? row[j + 2] : zero;
  const T ym2 = j >= 2 ? yrow[j - 2] : zero;
  const T ym1 = j >= 1 ? yrow[j - 1] : zero;
  const T yp1 = j + 1 < nv ? yrow[j + 1] : zero;
  const T yp2 = j + 2 < nv ? yrow[j + 2] : zero;
  const T react_v = j < n_react ? react_row : zero;
  a2tx = tv[TAL2 * nv + j] * (xm2 - xv) + tv[TAL1 * nv + j] * (xm1 - xv)
         + tv[TAU1 * nv + j] * (xp1 - xv) + tv[TAU2 * nv + j] * (xp2 - xv);
  a2y = vf[AL2 * nv + j] * (ym2 - yx) + vf[AL1 * nv + j] * (ym1 - yx)
        + vf[AU1 * nv + j] * (yp1 - yx) + vf[AU2 * nv + j] * (yp2 - yx)
        + react_v * yx;
}

// dA1 x at point (i, j) (P rows times dvfl, difference form)
template <typename T>
__device__ __forceinline__ T tangent_a1(const T* x, int i, int j, int ns,
                                        int nv, const T* sf, T dvfl) {
  const int k = i * nv + j;
  const T xv = x[k];
  const T dlo = (i > 0 ? x[k - nv] : T(0)) - xv;
  const T dhi = (i < ns - 1 ? x[k + nv] : T(0)) - xv;
  return (dvfl * sf[PL * ns + i]) * dlo + (dvfl * sf[PU * ns + i]) * dhi;
}

// In-place Thomas solve of (I - td*A1) along s of v-line j of dd
template <typename T>
__device__ __forceinline__ void thomas_line(T* dd, const T* tw, const T* ti,
                                            const T* sf, T v, T td, int ns,
                                            int nv, int j) {
  const int m1 = ns - 1;
  T dprev = dd[j];
  for (int i = 1; i < ns; ++i) {
    dprev = dd[i * nv + j] - tw[i * nv + j] * dprev;
    dd[i * nv + j] = dprev;
  }
  T x = dd[m1 * nv + j] * ti[m1 * nv + j];
  dd[m1 * nv + j] = x;
  for (int i = ns - 2; i >= 0; --i) {
    const T iu = -td * (v * sf[PU * ns + i] + sf[QU * ns + i]);
    x = (dd[i * nv + j] - iu * x) * ti[i * nv + j];
    dd[i * nv + j] = x;
  }
}

// Pentadiagonal solve of (I - td*A2) along v into the s-line `row`, whose
// right-hand side at j is in(j) (read just before row[j] is written)
template <typename T, typename In>
__device__ __forceinline__ void penta_line(T* row, const T* pf, int nv,
                                           In in) {
  T dp1 = pf[PM * nv] * in(0);
  row[0] = dp1;
  T dp2 = T(0);
  for (int j = 1; j < nv; ++j) {
    const T dpj = pf[PM * nv + j] * in(j) - pf[PGM * nv + j] * dp1
                  - pf[PHM * nv + j] * dp2;
    row[j] = dpj;
    dp2 = dp1;
    dp1 = dpj;
  }
  T x1 = row[nv - 1];
  T x2 = T(0);
  for (int j = nv - 2; j >= 0; --j) {
    const T xj = row[j] - pf[PC * nv + j] * x1 - pf[PC2 * nv + j] * x2;
    row[j] = xj;
    x2 = x1;
    x1 = xj;
  }
}

// u0, lam0: the state in [B][ns*nv]; u_out, lam_out: the state out
// (lam_out written for American loops only); work [B][NW][ns*nv] with NW
// = 5 (DO) or 7; nst: null, or [B] per-lane last local steps.
// TAN = false: the primal loop (tsfields .. twork unused, K = 0).
// TAN = true: also K tangent surfaces; tsfields [B][K][ns], tvfields
// [B][K][NTVF][nv]; the tangent state in, du0 and dlam0 [B][K][ns*nv]
// (null: zero; dlam0 unscaled, read by American loops only), and out,
// du_out and dlam_out (dlam_out written by American loops only, null
// otherwise); twork [B][NT][ns*nv] with NT = K + 1 (DO: tangent rhs, z1)
// or 2K + 2 (then the corrector's tangent rhs and z1c).
// cm: (1/2 - theta)*dt, MCS's weight of L z2. payoff, n_react, knock0,
// knock1, apart: the payoff (Payoff), the reaction rows, the knocked s
// columns (-1: none) and whether a dividend remaps u and the compensation
// separately (fused_do.remaps_apart).
// GEN = false compiles the plain call's loop alone (the fold at a
// dividend, the multiplier update), which the launcher takes for a call
// with no separate remap: the call books' loop carries none of the other
// payoffs' code. With those branches in it, the float32 Douglas primal
// took 128 registers instead of 80 and its 5000-option books ran 6-8%
// slower on an H100, and capping it at 80 registers did not win the time
// back (scripts/torch_book_ab.py). GEN = true adds the branches, taken
// by the launch arguments.
#define KERNEL_PARAMS                                                       \
  const T *__restrict__ u0, const T *__restrict__ lam0,                     \
      T *__restrict__ u_out, T *__restrict__ lam_out, T *__restrict__ work, \
      const T *__restrict__ sfields, const T *__restrict__ vfields,         \
      const T *__restrict__ scalars, const int *__restrict__ ev_step,       \
      const int *__restrict__ ev_idx, const T *__restrict__ ev_w,           \
      const int *__restrict__ nst, const T *__restrict__ tsfields,          \
      const T *__restrict__ tvfields, const T *__restrict__ du0,            \
      const T *__restrict__ dlam0, T *__restrict__ du_out,                  \
      T *__restrict__ dlam_out, T *__restrict__ twork, int ns, int nv,      \
      int first_step, int n_steps,                                          \
      int american, int n_events, int K, int payoff, int n_react,           \
      int knock0, int knock1, int apart_flag, T dt, T td, T rf, T cm
#define KERNEL_ARGS                                                        \
  u0, lam0, u_out, lam_out, work, sfields, vfields, scalars, ev_step,      \
      ev_idx, ev_w, nst, tsfields, tvfields, du0, dlam0, du_out, dlam_out, \
      twork, ns, nv,                                                       \
      first_step, n_steps, american, n_events, K, payoff, n_react, knock0, \
      knock1, apart_flag, dt, td, rf, cm
template <typename T, bool TAN, int SCHEME, bool GEN>
__device__ __forceinline__ void fused_do_body(KERNEL_PARAMS) {
  constexpr bool CORR = SCHEME != DO;
  constexpr int kWork = CORR ? 7 : 5;
  extern __shared__ unsigned char smem_raw[];
  T* sf = reinterpret_cast<T*>(smem_raw);  // [NSF][ns]
  T* vf = sf + NSF * ns;                   // [NVF][nv]
  T* pf = vf + NVF * nv;                   // [NPF][nv]
  T* tsf = pf + NPF * nv;                  // [K][ns]        (TAN)
  T* tvf = tsf + K * ns;                   // [K][NTVF][nv]  (TAN)
  T* flr = tvf + K * NTVF * nv;            // [ns] the American floor

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int np = ns * nv;
  const int m1 = ns - 1;
  const T zero = T(0);
  const T one = T(1);
  const T hdt = T(0.5) * dt;
  // this block's last local step (block-uniform: the barriers below stay
  // reached by every thread)
  const int last = nst ? min(n_steps, nst[b]) : n_steps;
  const bool digital =
      GEN && (payoff == DIGITAL_CALL || payoff == DIGITAL_PUT);
  const bool apart = GEN && apart_flag;

  for (int k = tid; k < NSF * ns; k += nt)
    sf[k] = sfields[(size_t)b * NSF * ns + k];
  for (int k = tid; k < NVF * nv; k += nt)
    vf[k] = vfields[(size_t)b * NVF * nv + k];
  const T b1v = scalars[2 * b];
  const T kk = scalars[2 * b + 1];

  T* u = u_out + (size_t)b * np;
  T* wk = work + (size_t)b * kWork * np;
  T* comp = wk + COMP * np;
  T* lam = wk + LAM * np;
  T* d = wk + DW * np;
  T* tw = wk + TW * np;
  T* ti = wk + TI * np;
  T* luw = CORR ? wk + LUW * np : nullptr;
  T* e = CORR ? wk + EW * np : nullptr;
  const T* ub = u0 + (size_t)b * np;
  const T* lb = lam0 + (size_t)b * np;
  for (int k = tid; k < np; k += nt) {
    u[k] = ub[k];
    comp[k] = zero;
    lam[k] = dt * lb[k];  // the dt-scaled carry
  }
  // tangent state (TAN): du [K][np] and, American, dlam [K][np] (the
  // dt-scaled carry), in the output buffers; scratch: tbuf [K][np],
  // z1 [np], and with a corrector trb [K][np], z1c [np]
  T* du = nullptr;
  T* tbuf = nullptr;
  T* dlam = nullptr;
  T* z1 = nullptr;
  T* trb = nullptr;
  T* z1c = nullptr;
  if (TAN) {
    for (int k = tid; k < K * ns; k += nt)
      tsf[k] = tsfields[(size_t)b * K * ns + k];
    for (int k = tid; k < K * NTVF * nv; k += nt)
      tvf[k] = tvfields[(size_t)b * K * NTVF * nv + k];
    const size_t o = (size_t)b * K * np;
    du = du_out + o;
    if (american) dlam = dlam_out + o;
    tbuf = twork + (size_t)b * (CORR ? 2 * K + 2 : K + 1) * np;
    z1 = tbuf + (size_t)K * np;
    if (CORR) {
      trb = z1 + np;
      z1c = trb + (size_t)K * np;
    }
    for (int k = tid; k < K * np; k += nt) {
      du[k] = du0 ? du0[o + k] : zero;
      if (american) dlam[k] = dlam0 ? dt * dlam0[o + k] : zero;
    }
  }
  __syncthreads();

  const T* P_d = sf + PD * ns;
  const T* Q_d = sf + QD * ns;
  const T* P_l = sf + PL * ns;
  const T* Q_l = sf + QL * ns;
  const T* P_u = sf + PU * ns;
  const T* Q_u = sf + QU * ns;
  const T* vfl = vf + VFL * nv;

  // the American floor row, once a launch
  for (int i = tid; i < ns; i += nt)
    flr[i] = floor_at(sf + VECS * ns, i, ns, kk, payoff, knock0, knock1);

  // Thomas factorization of I - td*A1 along s, one thread per v-line;
  // the implicit rows are -td*(v_j*P[i] + Q[i]) (+1 on the diagonal);
  // both factorizations are skipped by a block that runs no step
  for (int j = tid; j < nv && first_step <= last; j += nt) {
    const T v = vfl[j];
    T temp = -td * (v * P_d[0] + Q_d[0]) + one;
    ti[j] = one / temp;
    tw[j] = zero;
    for (int i = 1; i < ns; ++i) {
      const T wi = (-td * (v * P_l[i] + Q_l[i])) / temp;
      temp = (-td * (v * P_d[i] + Q_d[i]) + one)
             - wi * (-td * (v * P_u[i - 1] + Q_u[i - 1]));
      tw[i * nv + j] = wi;
      ti[i * nv + j] = one / temp;
    }
  }
  // pentadiagonal factorization of I - td*A2 along v (1-D, one thread)
  if (tid == nt - 1 && first_step <= last) {
    T c1p = zero, c2p = zero, cc1p = zero, cc2p = zero;
    for (int j = 0; j < nv; ++j) {
      const T il2 = -td * vf[AL2 * nv + j];
      const T il1 = -td * vf[AL1 * nv + j];
      const T idd = one - td * vf[AD * nv + j];
      const T iu1 = -td * vf[AU1 * nv + j];
      const T iu2 = -td * vf[AU2 * nv + j];
      const T big_l = il1 - il2 * c2p;
      const T m = one / ((idd - big_l * c1p) - il2 * cc2p);
      const T c = (iu1 - big_l * cc1p) * m;
      const T c2 = iu2 * m;
      pf[PC * nv + j] = c;
      pf[PC2 * nv + j] = c2;
      pf[PGM * nv + j] = big_l * m;
      pf[PHM * nv + j] = il2 * m;
      pf[PM * nv + j] = m;
      cc2p = cc1p;
      c2p = c1p;
      c1p = c;
      cc1p = c2;
    }
  }
  __syncthreads();

  const T react_row = Q_d[ns - 1];  // -r_d/2
  // b1 sits at the v-major flat indices m1*(q+1), q = 0..nv-1 (the
  // reference's placement quirk); b2 on v-row nv-1, s >= 1
  auto b1_at = [&](int i, int j) -> T {
    const int flat = j * ns + i;
    return (flat >= m1 && flat <= m1 * nv && flat % m1 == 0) ? b1v : zero;
  };
  auto b2_at = [&](int i, int j) -> T {
    return (j == nv - 1 && i >= 1) ? sf[B2R * ns + i] : zero;
  };
  int ev = 0;
  for (int n = first_step; n <= last; ++n) {
    // ---- dividend events of step n: the 2-point difference-form remap;
    // calls fold comp into u first and restart the compensation from the
    // remap's captured rounding, puts and barriers remap u and comp
    // separately and add u's captured rounding to the remapped comp
    for (; ev < n_events && ev_step[ev] == n; ++ev) {
      const size_t base = ((size_t)b * n_events + ev) * 2 * ns;
      const int* idx = ev_idx + base;
      const T* w = ev_w + base;
      // the remap of the field x at point k: a = wsum*x[k] and the
      // correction acc = w0 (x[c0] - x[k]) + w1 (x[c1] - x[k]), with the
      // source columns clamped into the grid (in range by construction on
      // the host; the clamp keeps every read in bounds)
      auto remap_at = [&](const T* x, int k, T& a, T& acc) {
        const int i = k / nv;
        const int j = k - i * nv;
        const T w0 = w[i];
        const T w1 = w[ns + i];
        const int c0 = min(max(idx[i], 0), m1);
        const int c1 = min(max(idx[ns + i], 0), m1);
        const T xv = x[k];
        acc = w0 * (x[c0 * nv + j] - xv) + w1 * (x[c1 * nv + j] - xv);
        a = (w0 + w1 > T(0.5) ? one : zero) * xv;
      };
      if (apart) {
        for (int k = tid; k < np; k += nt) d[k] = comp[k];
      } else {
        for (int k = tid; k < np; k += nt) d[k] = u[k] + comp[k];
      }
      if (TAN)
        for (int k = tid; k < K * np; k += nt) tbuf[k] = du[k];
      __syncthreads();
      if (apart) {
        // the compensation's remap, then u's copy into d
        for (int k = tid; k < np; k += nt) {
          T a, acc;
          remap_at(d, k, a, acc);
          comp[k] = a + acc;
        }
        __syncthreads();
        for (int k = tid; k < np; k += nt) d[k] = u[k];
        __syncthreads();
      }
      for (int k = tid; k < np; k += nt) {
        T a, acc;
        remap_at(d, k, a, acc);
        const T s = a + acc;
        const T bb = s - a;
        const T e2 = (a - (s - bb)) + (acc - bb);
        u[k] = s;
        comp[k] = apart ? comp[k] + e2 : e2;
      }
      if (TAN) {
        // the remap is linear and parameter-free: each tangent takes
        // the value of the same sum, with no compensation
        for (int q = tid; q < K * np; q += nt) {
          const int kt = q / np;
          const int k = q - kt * np;
          const int i = k / nv;
          const int j = k - i * nv;
          const T w0 = w[i];
          const T w1 = w[ns + i];
          const int c0 = min(max(idx[i], 0), m1);
          const int c1 = min(max(idx[ns + i], 0), m1);
          const T* tb = tbuf + (size_t)kt * np;
          const T x = tb[k];
          const T acc = w0 * (tb[c0 * nv + j] - x) + w1 * (tb[c1 * nv + j] - x);
          du[q] = (w0 + w1 > T(0.5) ? one : zero) * x + acc;
        }
      }
      __syncthreads();
    }

    const T nf = T(n);
    const T e0 = exp_t<T>(rf * dt * (nf - one));
    const T e1 = exp_t<T>(rf * dt * nf);
    const T kb1 = dt * e0 + td * (e1 - e0);
    const T kb2a = dt * e0;
    const T kb2b = td * (e1 - e0);

    // ---- 1. rhs1 (point-parallel); a corrector keeps L u
    for (int k = tid; k < np; k += nt) {
      const int i = k / nv;
      const int j = k - i * nv;
      T a0, a1, a2;
      l_parts(u, i, j, ns, nv, sf, vf, react_row, n_react, a0, a1, a2);
      const T lu = a0 + a1 + a2;
      if (CORR) luw[k] = lu;
      T rhs = dt * lu + (kb1 * b1_at(i, j) + kb2a * b2_at(i, j));
      if (american) rhs = rhs + lam[k];
      d[k] = rhs;
    }
    __syncthreads();

    // ---- 2. Thomas solve along s, one thread per v-line
    for (int j = tid; j < nv; j += nt)
      thomas_line(d, tw, ti, sf, vfl[j], td, ns, nv, j);
    __syncthreads();

    // ---- 3./4. b2 injection and pentadiagonal solve along v, one thread
    // per s-line
    for (int i = tid; i < ns; i += nt) {
      T* row = d + i * nv;
      if (TAN)  // the tangent phase reads z1, the Thomas solution
        for (int j = 0; j < nv; ++j) z1[i * nv + j] = row[j];
      row[nv - 1] = row[nv - 1] + kb2b * sf[B2R * ns + i];
      penta_line(row, pf, nv, [&](int j) { return row[j]; });
    }
    __syncthreads();

    if (CORR) {
      // ---- C1. the corrector's stage-1 rhs into e (point-parallel) from
      // the kept L u and the stencils of the predictor increment z2 = d
      const T kmc = cm * (e1 - e0);
      const T khv = hdt * (e1 - e0);
      for (int k = tid; k < np; k += nt) {
        const int i = k / nv;
        const int j = k - i * nv;
        T a0, a1, a2;
        l_parts(d, i, j, ns, nv, sf, vf, react_row, n_react, a0, a1, a2);
        const T lu = luw[k];
        const T b1f = b1_at(i, j);
        const T b2f = b2_at(i, j);
        T rhs;
        if (SCHEME == CS) {
          rhs = dt * lu + hdt * a0 + kb1 * b1f + kb2a * b2f;
        } else if (SCHEME == MCS) {
          rhs = dt * lu + td * a0 + cm * (a0 + a1 + a2) + (kb1 + kmc) * b1f
                + (kb2a + kmc) * b2f;
        } else {
          rhs = dt * lu + hdt * (a0 + a1 + a2) - d[k]
                + (dt * e0 + khv) * (b1f + b2f);
        }
        if (american) rhs = rhs + lam[k];
        e[k] = rhs;
      }
      __syncthreads();
      // ---- C2. Thomas solve of e along s
      for (int j = tid; j < nv; j += nt)
        thomas_line(e, tw, ti, sf, vfl[j], td, ns, nv, j);
      __syncthreads();
      // ---- C3./C4. (CS, MCS) the b2 injection, then the penta solve of e
      for (int i = tid; i < ns; i += nt) {
        T* row = e + i * nv;
        if (TAN)
          for (int j = 0; j < nv; ++j) z1c[i * nv + j] = row[j];
        if (SCHEME != HV)
          row[nv - 1] = row[nv - 1] + kb2b * sf[B2R * ns + i];
        penta_line(row, pf, nv, [&](int j) { return row[j]; });
      }
      __syncthreads();
    }

    if (TAN) {
      // ---- T1. tangent rhs (point-parallel over K * np):
      // dt*(dA0 u + A0 du + dA1 u + A1 du + dA2 u + A2 du) [+ dlam]
      // + td*dA1 z1 (a corrector keeps the first part)
      for (int q = tid; q < K * np; q += nt) {
        const int kt = q / np;
        const int k = q - kt * np;
        const int i = k / nv;
        const int j = k - i * nv;
        const T* tv = tvf + kt * NTVF * nv;
        T da0, mtu, a2tu, a1y, a2y;
        tangent_parts(u, du + (size_t)kt * np, i, j, ns, nv, sf, vf,
                      tsf[kt * ns + i], tv, react_row, n_react, da0, mtu,
                      a2tu, a1y, a2y);
        T trhs = dt * (((da0 + mtu) + a1y) + (a2tu + a2y));
        if (american) trhs = trhs + dlam[q];
        if (CORR) trb[q] = trhs;
        tbuf[q] = trhs + td * tangent_a1(z1, i, j, ns, nv, sf, tv[TVFL * nv + j]);
      }
      __syncthreads();

      // ---- T2. tangent Thomas solves along s: K * nv lines
      for (int l = tid; l < K * nv; l += nt) {
        const int kt = l / nv;
        const int j = l - kt * nv;
        thomas_line(tbuf + (size_t)kt * np, tw, ti, sf, vfl[j], td, ns, nv,
                    j);
      }
      __syncthreads();

      // dz1 + td * dA2 x at s-line `row` of one direction, x the primal
      // increment the stage anchors at (formed as the forward sweep reads)
      auto stage2_in = [&](const T* row, const T* zr, const T* tv) {
        return [=](int j) -> T {
          const T x = zr[j];
          const T xm2 = j >= 2 ? zr[j - 2] : zero;
          const T xm1 = j >= 1 ? zr[j - 1] : zero;
          const T xp1 = j + 1 < nv ? zr[j + 1] : zero;
          const T xp2 = j + 2 < nv ? zr[j + 2] : zero;
          return row[j] + td * (tv[TAL2 * nv + j] * (xm2 - x)
                                + tv[TAL1 * nv + j] * (xm1 - x)
                                + tv[TAU1 * nv + j] * (xp1 - x)
                                + tv[TAU2 * nv + j] * (xp2 - x));
        };
      };
      // ---- T3. tangent penta solves along v: K * ns lines, on
      // dz1 + td * dA2 z2
      for (int l = tid; l < K * ns; l += nt) {
        const int kt = l / ns;
        const int i = l - kt * ns;
        T* row = tbuf + (size_t)kt * np + i * nv;
        penta_line(row, pf, nv, stage2_in(row, d + i * nv, tvf + kt * NTVF * nv));
      }
      __syncthreads();

      if (CORR) {
        // ---- T4. the corrector's tangent rhs into trb (point-parallel):
        // the kept trhs plus the tangent of its A0 z2 (CS) or L z2 (MCS,
        // HV) terms, z2 = d and dz2 = tbuf, plus td * dA1 z1c
        for (int q = tid; q < K * np; q += nt) {
          const int kt = q / np;
          const int k = q - kt * np;
          const int i = k / nv;
          const int j = k - i * nv;
          const T* tv = tvf + kt * NTVF * nv;
          const T* y = tbuf + (size_t)kt * np;
          T da0, mtz, a2tz, a1y, a2y;
          tangent_parts(d, y, i, j, ns, nv, sf, vf, tsf[kt * ns + i], tv,
                        react_row, n_react, da0, mtz, a2tz, a1y, a2y);
          T crhs;
          if (SCHEME == CS) {
            crhs = trb[q] + hdt * da0;
          } else {
            const T dlz = da0 + mtz + a2tz + a1y + a2y;
            crhs = SCHEME == MCS ? trb[q] + td * da0 + cm * dlz
                                 : trb[q] - y[k] + hdt * dlz;
          }
          trb[q] = crhs + td * tangent_a1(z1c, i, j, ns, nv, sf,
                                          tv[TVFL * nv + j]);
        }
        __syncthreads();
        // ---- T5. Thomas solves of trb along s
        for (int l = tid; l < K * nv; l += nt) {
          const int kt = l / nv;
          const int j = l - kt * nv;
          thomas_line(trb + (size_t)kt * np, tw, ti, sf, vfl[j], td, ns, nv,
                      j);
        }
        __syncthreads();
        // ---- T6. penta solves of trb + td * dA2 e along v (the stage
        // anchors at the corrector's own penta solution)
        for (int l = tid; l < K * ns; l += nt) {
          const int kt = l / ns;
          const int i = l - kt * ns;
          T* row = trb + (size_t)kt * np + i * nv;
          penta_line(row, pf, nv,
                     stage2_in(row, e + i * nv, tvf + kt * NTVF * nv));
        }
        __syncthreads();
      }
    }

    // ---- 5. compensated update (Fast2Sum), American floor + multiplier
    // (a digital: the projection onto [floor, 1]); the tangents first,
    // from the same compensated q and lam_arg (q and qm)
    for (int k = tid; k < np; k += nt) {
      const T z2 = SCHEME == DO ? d[k] : (SCHEME == HV ? d[k] + e[k] : e[k]);
      const T x = u[k];
      // the tangent increment of direction kt
      auto dinc = [&](size_t o) -> T {
        return SCHEME == DO ? tbuf[o]
                            : (SCHEME == HV ? tbuf[o] + trb[o] : trb[o]);
      };
      if (american && digital) {
        const T floor_ = flr[k / nv];
        const T t = z2 + comp[k];
        const T q = x + t;
        const T err = t - (q - x);
        const bool pin = floor_ == one;
        const T qm = q > floor_ ? q : floor_;
        if (TAN) {
          for (int kt = 0; kt < K; ++kt) {
            const size_t o = (size_t)kt * np + k;
            const T dub = du[o] + dinc(o);
            const T dm = q > floor_ ? dub : (q < floor_ ? zero : T(0.5) * dub);
            du[o] = pin ? zero
                        : (qm < one ? dm : (qm > one ? zero : T(0.5) * dm));
          }
        }
        u[k] = pin ? floor_ : (qm < one ? qm : one);
        comp[k] = (q > floor_ && qm < one && !pin) ? err : zero;
      } else if (american) {
        const int i = k / nv;
        const T floor_ = flr[i];
        const T t = (z2 - lam[k]) + comp[k];
        const T q = x + t;
        const T err = t - (q - x);
        const T la = (floor_ - q) - err;
        if (TAN) {
          for (int kt = 0; kt < K; ++kt) {
            const size_t o = (size_t)kt * np + k;
            const T dub = du[o] + dinc(o);
            const T dl = dlam[o];
            const T da = dub - dl;
            du[o] = q > floor_ ? da : (q < floor_ ? zero : T(0.5) * da);
            const T darg = dl - dub;
            const T nl = la > zero ? darg
                                   : (la < zero ? zero : T(0.5) * darg);
            dlam[o] = i != m1 ? nl : zero;
          }
        }
        u[k] = q > floor_ ? q : floor_;
        comp[k] = q > floor_ ? err : zero;
        lam[k] = (i != m1 && la > zero) ? la : zero;
      } else {
        if (TAN)
          for (int kt = 0; kt < K; ++kt) {
            const size_t o = (size_t)kt * np + k;
            du[o] = du[o] + dinc(o);
          }
        const T t = z2 + comp[k];
        const T q = x + t;
        comp[k] = t - (q - x);
        u[k] = q;
      }
    }
    __syncthreads();
  }

  T* lo = lam_out + (size_t)b * np;
  for (int k = tid; k < np; k += nt) {
    u[k] = u[k] + comp[k];
    if (american) lo[k] = lam[k] / dt;
  }
  if (TAN && american)
    for (int k = tid; k < K * np; k += nt) dlam[k] = dlam[k] / dt;
}

// Douglas, primal and forward mode, and every forward-mode scheme: no
// launch bounds (the compiler's own register choice)
template <typename T, bool TAN, int SCHEME, bool GEN>
__global__ void fused_do_kernel(KERNEL_PARAMS) {
  fused_do_body<T, TAN, SCHEME, GEN>(KERNEL_ARGS);
}

// a corrector scheme's primal loop: 4 resident blocks an SM
template <typename T, int SCHEME, bool GEN>
__global__ void __launch_bounds__(kPrimalThreads, kPrimalBlocksPerSm)
    fused_do_kernel_bounded(KERNEL_PARAMS) {
  fused_do_body<T, false, SCHEME, GEN>(KERNEL_ARGS);
}

// the kernel of one (T, TAN, SCHEME, GEN), instantiating only that one
template <typename T, bool TAN, int SCHEME, bool GEN>
constexpr auto kernel_for() {
  if constexpr (!TAN && SCHEME != DO)
    return fused_do_kernel_bounded<T, SCHEME, GEN>;
  else
    return fused_do_kernel<T, TAN, SCHEME, GEN>;
}

template <typename T, bool TAN, int SCHEME, bool GEN>
int launch_scheme(const void* u0, const void* lam0, void* u_out,
                  void* lam_out, void* work, const void* sfields,
                  const void* vfields, const void* scalars,
                  const void* ev_step, const void* ev_idx, const void* ev_w,
                  const void* nst, const void* tsfields,
                  const void* tvfields, const void* du0, const void* dlam0,
                  void* du_out, void* dlam_out, void* twork, int B,
                  int ns, int nv, int first_step, int n_steps, int american,
                  int n_events, int K, int payoff, int n_react, int knock0,
                  int knock1, int apart, double dt, double td, double rf,
                  double cm, void* stream) {
  const size_t smem =
      sizeof(T) * ((size_t)(NSF + 1) * ns + (size_t)(NVF + NPF) * nv +
                   (size_t)K * ns + (size_t)K * NTVF * nv);
  auto* kernel = kernel_for<T, TAN, SCHEME, GEN>();
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = TAN ? kTangentThreads : kPrimalThreads;
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u0), static_cast<const T*>(lam0),
      static_cast<T*>(u_out), static_cast<T*>(lam_out),
      static_cast<T*>(work), static_cast<const T*>(sfields),
      static_cast<const T*>(vfields), static_cast<const T*>(scalars),
      static_cast<const int*>(ev_step), static_cast<const int*>(ev_idx),
      static_cast<const T*>(ev_w), static_cast<const int*>(nst),
      static_cast<const T*>(tsfields), static_cast<const T*>(tvfields),
      static_cast<const T*>(du0), static_cast<const T*>(dlam0),
      static_cast<T*>(du_out), static_cast<T*>(dlam_out),
      static_cast<T*>(twork), ns, nv, first_step,
      n_steps, american, n_events, K, payoff, n_react, knock0, knock1, apart,
      static_cast<T>(dt), static_cast<T>(td), static_cast<T>(rf),
      static_cast<T>(cm));
  return (int)cudaGetLastError();
}

template <typename T, bool TAN>
int launch(const void* u0, const void* lam0, void* u_out, void* lam_out,
           void* work, const void* sfields, const void* vfields,
           const void* scalars, const void* ev_step, const void* ev_idx,
           const void* ev_w, const void* nst, const void* tsfields,
           const void* tvfields, const void* du0, const void* dlam0,
           void* du_out, void* dlam_out, void* twork, int B, int ns,
           int nv, int first_step, int n_steps, int american, int n_events,
           int scheme, int payoff, int n_react, int knock0, int knock1,
           int apart, int K, double dt, double td, double rf, double cm,
           void* stream) {
  if (B <= 0 || ns < 3 || nv < 3 || first_step < 1 || n_steps < 0 ||
      n_events < 0 || (TAN ? K < 1 : K != 0) || payoff < CALL ||
      payoff > DIGITAL_PUT || n_react < 0 || n_react > nv || knock0 < -1 ||
      knock0 >= ns || knock1 < -1 || knock1 >= ns || apart < 0 || apart > 1)
    return (int)cudaErrorInvalidValue;
  // the plain call's loop (GEN = false) unless another payoff's branch
  // can be taken
  const bool gen = payoff != CALL || apart;
#define LAUNCH_GEN(S, G)                                                   \
  launch_scheme<T, TAN, S, G>(                                             \
      u0, lam0, u_out, lam_out, work, sfields, vfields, scalars, ev_step,  \
      ev_idx, ev_w, nst, tsfields, tvfields, du0, dlam0, du_out, dlam_out, \
      twork, B, ns, nv,                                                    \
      first_step, n_steps, american, n_events, K, payoff, n_react, knock0, \
      knock1, apart, dt, td, rf, cm, stream)
#define LAUNCH_SCHEME(S) (gen ? LAUNCH_GEN(S, true) : LAUNCH_GEN(S, false))
  switch (scheme) {
    case DO:
      return LAUNCH_SCHEME(DO);
    case CS:
      return LAUNCH_SCHEME(CS);
    case MCS:
      return LAUNCH_SCHEME(MCS);
    case HV:
      return LAUNCH_SCHEME(HV);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LAUNCH_SCHEME
#undef LAUNCH_GEN
}

#undef KERNEL_PARAMS
#undef KERNEL_ARGS

}  // namespace

#define PRIMAL_ARGS                                                        \
  const void *u0, const void *lam0, void *u_out, void *lam_out, void *work, \
      const void *sfields, const void *vfields, const void *scalars,       \
      const void *ev_step, const void *ev_idx, const void *ev_w,           \
      const void *nst, int B, int ns, int nv, int first_step, int n_steps, \
      int american, int n_events, int scheme, int payoff, int n_react,     \
      int knock0, int knock1, int apart
#define TANGENT_ARGS                                                       \
  const void *u0, const void *lam0, void *u_out, void *lam_out, void *work, \
      const void *sfields, const void *vfields, const void *scalars,       \
      const void *ev_step, const void *ev_idx, const void *ev_w,           \
      const void *nst, const void *tsfields, const void *tvfields,         \
      const void *du0, const void *dlam0, void *du_out, void *dlam_out,    \
      void *twork, int B, int ns, int nv, int first_step,                  \
      int n_steps, int american, int n_events, int scheme, int payoff,     \
      int n_react, int knock0, int knock1, int apart, int K
#define SCALAR_ARGS double dt, double td, double rf, double cm, void *stream

extern "C" int fused_do_f32(PRIMAL_ARGS, SCALAR_ARGS) {
  return launch<float, false>(u0, lam0, u_out, lam_out, work, sfields,
                              vfields, scalars, ev_step, ev_idx, ev_w, nst,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, nullptr, B, ns, nv,
                              first_step, n_steps, american, n_events,
                              scheme, payoff, n_react, knock0, knock1, apart,
                              0, dt, td, rf, cm, stream);
}

extern "C" int fused_do_f64(PRIMAL_ARGS, SCALAR_ARGS) {
  return launch<double, false>(u0, lam0, u_out, lam_out, work, sfields,
                               vfields, scalars, ev_step, ev_idx, ev_w, nst,
                               nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, nullptr, B, ns, nv,
                               first_step, n_steps, american, n_events,
                               scheme, payoff, n_react, knock0, knock1, apart,
                               0, dt, td, rf, cm, stream);
}

extern "C" int fused_do_tangent_f32(TANGENT_ARGS, SCALAR_ARGS) {
  return launch<float, true>(u0, lam0, u_out, lam_out, work, sfields,
                             vfields, scalars, ev_step, ev_idx, ev_w, nst,
                             tsfields, tvfields, du0, dlam0, du_out,
                             dlam_out, twork, B, ns, nv,
                             first_step, n_steps, american, n_events, scheme,
                             payoff, n_react, knock0, knock1, apart, K, dt,
                             td, rf, cm, stream);
}

extern "C" int fused_do_tangent_f64(TANGENT_ARGS, SCALAR_ARGS) {
  return launch<double, true>(u0, lam0, u_out, lam_out, work, sfields,
                              vfields, scalars, ev_step, ev_idx, ev_w, nst,
                              tsfields, tvfields, du0, dlam0, du_out,
                              dlam_out, twork, B, ns, nv,
                              first_step, n_steps, american, n_events,
                              scheme, payoff, n_react, knock0, knock1, apart,
                              K, dt, td, rf, cm, stream);
}

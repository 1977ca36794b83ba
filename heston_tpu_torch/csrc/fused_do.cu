// Batched ADI time loop for the Heston PDE, one launch per book.
//
// Replaces heston_tpu/pallas/fused_do.py::_make_kernel (primal and forward
// mode, schemes "do", "cs", "mcs" and "hv", calls, puts and cash-or-nothing
// digitals, with or without a knock-out barrier, European or American, with
// or without discrete dividends). The host side is
// heston_tpu_torch/kernels/fused_do.py, whose fused_do_reference is the
// plain PyTorch version of exactly this arithmetic.
//
// What bounds it on an H100: latency, not bytes or FLOPs. One option's
// working set is a few tens of KB and a step's arithmetic ~50 flops a grid
// point (~100 with a corrector), but every time step runs a Thomas solve
// along s and a pentadiagonal solve along v, each a forward and a backward
// recurrence: 2*(ns + nv) rows follow one another (154 at the 51 x 26
// production grid, twice that with a corrector), each row two or three
// dependent operations; and its point-parallel phases (the explicit
// operator, the update, in forward mode the tangents' operators) run ~100
// instructions a point over the block's few warps. The design:
// - breadth: one thread block per option, the independent grid lines of
//   each sweep spread over the block's threads, the whole book in one
//   launch (500 options are one wave of blocks on 132 SMs, 4 an SM);
// - the working fields in shared memory (Field below) instead of
//   per-option global scratch, so that a sweep's operands are a
//   shared-memory load away. The host places them before the launch
//   (fused_do.launch_plan): in Field order, the sweeps' operands first,
//   until the budget that keeps the blocks an SM the launch needs is used;
//   the rest stay in per-block global scratch. The body takes a pointer per
//   field, so one body serves every placement; float32 launches with every
//   field in shared memory take an instantiation of their own (SMEM) that
//   addresses them as shared memory;
// - each sweep loads the operands of a chunk of rows into registers
//   before the recurrence runs through them, so within a chunk the
//   row-to-row chain is the recurrence's own operations (Thomas 2 forward
//   and 3 backward, penta 3);
// - each surface sits in a zero border (one s-row, two v-columns a side),
//   so the stencils read without bounds checks, at an odd s-row stride, so
//   that the penta sweep's threads, one s-row apart, fall on distinct
//   banks; u and the tangents keep the [B][ns*nv] layout in global memory;
// - the point-parallel phases walk a 2-D thread map (PointMap), no integer
//   division per point, and a book that leaves a block alone or in pairs
//   on an SM takes 256 threads a block (fused_do.launch_plan).
// What is left (scripts/torch_book_ab.py --phase-clock, PERF.md): at the
// flagship book the explicit operator and the update phases and the
// sweeps' rows (~30-45 cycles each: one shared-memory latency a chunk plus
// the chain) share the step about evenly; the launch's setup (both
// factorizations, a division a row) and the dividend events the rest.
// No tensor cores: a step has no tile product, and its compensated sums
// need IEEE adds, so wgmma and TF32 have no place here. No TMA: a block's
// start-of-launch loads (u0, the coefficient rows, du0) are a few KB to
// ~30 KB once a launch.
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
// the update, the only point where u, z1 (copied by the Thomas sweep), z2,
// the corrector's z1c and e, lam and comp are all live; phase 5 then
// updates the tangents (XLA's maximum-JVP, 0.5 on ties, on the same
// compensated q and lam_arg) and the primal together. A corrector scheme
// differentiates its stage-1 rhs (the predictor's tangent rhs, kept, plus
// the tangents of its A0 z2 or L z2 terms) and solves again against z1c
// and e (:1008-1054). Dividend remaps move every tangent with the same
// 2-point weights.
// What bounds it: again the dependent sweeps, the primal's and then the
// tangents', and the tangents' point-parallel phases (K*ns*nv points). The
// launch is a grid (B, G): block (b, g) runs option b's primal and its
// K/G tangents of group g (G = K when the B*K blocks fit in one wave,
// fused_do.tangent_groups), so the lm60 launch (60 options, K = 4) spreads
// over 240 blocks instead of 60 blocks on 60 of the 132 SMs. Every group
// recomputes the primal with the same operations in the same order, so its
// bits are the same; group 0 writes u and lam. A block with all K tangents
// (G = 1) has 256 threads, spreading its K*nv Thomas and K*ns penta lines;
// a group block 256 while two a SM hold the launch, else 128. Sharing the
// primal between a cluster's group blocks through distributed shared memory
// would save the recompute, but each group would then wait on the
// primal's block at every step: the recompute runs in parallel instead.

#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

// Phase-clock hooks, empty in this build: scripts/torch_book_ab.py
// --phase-clock compiles a copy of this source with them defined (clock64
// per phase, summed over the steps in block (0, 0), printed at its end)
#ifndef PHASE_CLOCK_BEGIN
#define PHASE_CLOCK_BEGIN
#define PHASE_MARK(id)
#define PHASE_CLOCK_END
#endif

namespace {

// per-option coefficient rows, in the wrapper's packing order
enum SField { PL, QL, PD, QD, PU, QU, SFAC, BSM, BSP, B2R, VECS, NSF };
enum VField { VFL, VFAC, BVM, BVP, AL2, AL1, AD, AU1, AU2, NVF };
// pentadiagonal factors [nv], in shared memory
enum Penta { PM, PGM, PHM, PC, PC2, NPF };
// per-option, per-tangent rows of the forward-mode variant: one s-row
// (the tangent of sfac) and these v-rows, in the wrapper's packing order
enum TVField { TVFL, TVFAC, TBVM, TBVP, TAL2, TAL1, TAU1, TAU2, NTVF };
// time-loop schemes, in the order of fused_do.SCHEMES
enum Scheme { DO, CS, MCS, HV };
// payoffs, in the order of operators.OPTION_TYPES
enum Payoff { CALL, PUT, DIGITAL_CALL, DIGITAL_PUT };
// The working fields of a block, in the host's placement order
// (fused_do.FIELDS): the sweeps' operands first — d (the rhs, then z2),
// the Thomas factors tw and ti, the corrector's rhs and increment e, the
// tangent rhs tbuf and the corrector's trb — then u, the compensation, the
// dt-scaled multiplier lam (American), the predictor's L u, the copies z1
// and z1c of the Thomas solutions, the tangents du and their multipliers
// dlam (American). Each is one bordered surface (surface() below), or
// (tbuf, trb, du, dlam) one per tangent of the block's group; bit f of the
// launch argument fmask puts field f in shared memory.
enum Field {
  FD, FTW, FTI, FE, FTBUF, FTRB, FU, FCOMP, FLAM, FLUW, FZ1, FZ1C, FDU,
  FDLAM, NFIELD
};
// phases of the clock hooks
enum PhaseId {
  PH_SETUP, PH_EVENTS, PH_RHS, PH_THOMAS, PH_PENTA, PH_CORR, PH_TRHS,
  PH_TTHOMAS, PH_TPENTA, PH_TCORR, PH_UPDATE, PH_OUT, NPHASE
};

// Threads of a block, the launch's argument (fused_do.launch_plan): 128,
// or 256 where a block has an SM to itself or shares it with one other (a
// Douglas primal book or a forward-mode launch of up to two blocks an SM,
// a forward-mode block with all K tangents), so that its point-parallel
// phases take half the passes. A primal loop of 128 threads whose
// registers would keep a 4th block off the SM asks for 4 resident blocks
// an SM, which caps it at 128 registers a thread (kernel_for): every
// corrector scheme (left unbounded it takes 133-136 in float32, 3 blocks
// an SM, and a 500-option book then needs two waves on 132 SMs), and
// float64 Douglas (131 unbounded, 3 blocks an SM where the launch plan
// budgets shared memory for 4). float32 Douglas (95 registers, 5 blocks an
// SM) and the 256-thread launches keep the compiler's own choice: a bound
// of 4 blocks would let the one grow to 128 registers and refuses the
// other.
constexpr int kPrimalThreads = 128;
constexpr int kPrimalBlocksPerSm = 4;
constexpr int kWideThreads = 256;
// rows of a sweep's chunk (below)
constexpr int kChunk = 8;
// Whether a launch with every field in shared memory takes a kernel of its
// own (SMEM = true), whose field pointers all derive from the shared array:
// the compiler then addresses them as shared memory (LDS/STS, 32-bit
// offsets) instead of generically (LD/ST on 64-bit addresses, which an
// H100 serves at about the latency of an L1 hit, scripts/torch_book_ab.py
// --phase-clock). float32 only: a float64 launch at the production grid
// rarely fits whole, and the extra instantiations cost build time.
template <typename T>
constexpr bool kSmemKernel = std::is_same<T, float>::value;

// A working surface is [ns][nv] inside a border of zeros: one s-row on
// each side and two v-columns on each side, read by the stencils as the
// zero outside the grid, so that they need no bounds checks. Its s-row
// stride is nv + 4 rounded up to an odd count (threads one s-row apart
// fall on distinct banks); a field pointer points at node (0, 0).
__host__ __device__ constexpr int row_stride(int nv) { return (nv + 4) | 1; }
__host__ __device__ constexpr int surface(int ns, int nv) {
  return (ns + 2) * row_stride(nv);
}

// surfaces [ns][ld] of field f in a block (0: the launch has no such field)
__host__ __device__ constexpr int field_count(int f, bool tan, bool corr,
                                              bool american, int kg) {
  switch (f) {
    case FD: case FTW: case FTI: case FU: case FCOMP:
      return 1;
    case FE: case FLUW:
      return corr ? 1 : 0;
    case FLAM:
      return american ? 1 : 0;
    case FTBUF: case FDU:
      return tan ? kg : 0;
    case FZ1:
      return tan ? 1 : 0;
    case FTRB:
      return tan && corr ? kg : 0;
    case FZ1C:
      return tan && corr ? 1 : 0;
    case FDLAM:
      return tan && american ? kg : 0;
    default:
      return 0;
  }
}

// values of T in a block's shared rows: the coefficient rows, the penta
// factors, the group's tangent rows and the American floor (the b1 node
// pairs follow as 2*nv ints, then the fields placed in shared memory)
__host__ __device__ constexpr size_t row_elems(int ns, int nv, int kg) {
  return (size_t)(NSF + 1) * ns + (size_t)(NVF + NPF) * nv +
         (size_t)kg * ((size_t)ns + (size_t)NTVF * nv);
}

// values of T of the fields a block keeps in shared memory (in_smem) or in
// global scratch
__host__ __device__ constexpr size_t field_elems(int ns, int nv, bool tan,
                                                 bool corr, bool american,
                                                 int kg, int fmask,
                                                 bool in_smem) {
  size_t n = 0;
  for (int f = 0; f < NFIELD; ++f)
    if (((fmask >> f) & 1) == (in_smem ? 1 : 0))
      n += (size_t)field_count(f, tan, corr, american, kg) * surface(ns, nv);
  return n;
}

// the bits of the fields a launch has
__host__ __device__ constexpr int fields_present(bool tan, bool corr,
                                                 bool american, int kg) {
  int mask = 0;
  for (int f = 0; f < NFIELD; ++f)
    if (field_count(f, tan, corr, american, kg)) mask |= 1 << f;
  return mask;
}

template <typename T>
size_t smem_bytes(int ns, int nv, bool tan, bool corr, bool american, int kg,
                  int fmask) {
  return sizeof(T) * (row_elems(ns, nv, kg) +
                      field_elems(ns, nv, tan, corr, american, kg, fmask,
                                  true)) +
         sizeof(int) * 2 * (size_t)nv;
}

template <typename T> __device__ __forceinline__ T exp_t(T x);
template <> __device__ __forceinline__ float exp_t<float>(float x) {
  return expf(x);
}
template <> __device__ __forceinline__ double exp_t<double>(double x) {
  return exp(x);
}

// A thread's points: (kt, i, j) over `reps` surfaces [ns][nv] in the flat
// order kt*ns*nv + i*nv + j, the block's threads striding it, with (i, j)
// advanced by the stride's own (di, dj) instead of dividing each index
struct PointMap {
  int i0, j0, di, dj;
};

__device__ __forceinline__ PointMap point_map(int ns, int nv) {
  PointMap m;
  m.di = blockDim.x / nv;
  m.dj = blockDim.x - m.di * nv;
  m.i0 = threadIdx.x / nv;
  m.j0 = threadIdx.x - m.i0 * nv;
  return m;
}

template <typename F>
__device__ __forceinline__ void for_points(const PointMap& m, int reps,
                                           int ns, int nv, F&& f) {
  int kt = 0, i = m.i0, j = m.j0;
  while (i >= ns) {
    i -= ns;
    ++kt;
  }
  while (kt < reps) {
    f(kt, i, j);
    i += m.di;
    j += m.dj;
    if (j >= nv) {
      j -= nv;
      ++i;
    }
    while (i >= ns) {
      i -= ns;
      ++kt;
    }
  }
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
// surface x (s-row stride ld, its zero border the values outside the
// grid), in difference form with the analytic reactions: a0 = c_a0 *
// beta_v(beta_s x), a1 = A1 x, a2 = A2 x; L x = (a0 + a1) + a2. (Outside
// the grid the beta_s stencil reads zeros and is zero: at most the sign
// of an exact zero differs from the plain version's constant.)
template <typename T>
__device__ __forceinline__ void l_parts(const T* x, int i, int j, int ns,
                                        int nv, int ld, const T* sf,
                                        const T* vf, T react_row,
                                        int n_react, T& a0, T& a1, T& a2) {
  const T zero = T(0);
  const T* row = x + i * ld;
  const T* rlo = row - ld;
  const T* rhi = row + ld;
  const T xv = row[j];
  const T bsm = sf[BSM * ns + i];
  const T bsp = sf[BSP * ns + i];
  // beta_s stencil at column jj of this s-row
  auto dsu_at = [&](int jj) -> T {
    const T c = row[jj];
    return bsm * (rlo[jj] - c) + bsp * (rhi[jj] - c);
  };
  const T dlo = rlo[j] - xv;
  const T dhi = rhi[j] - xv;
  const T dsu = bsm * dlo + bsp * dhi;
  const T dv = vf[BVM * nv + j] * (dsu_at(j - 1) - dsu)
               + vf[BVP * nv + j] * (dsu_at(j + 1) - dsu);
  const T xm2 = row[j - 2];
  const T xm1 = row[j - 1];
  const T xp1 = row[j + 1];
  const T xp2 = row[j + 2];
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
// on the primal surface x and the tangent surface y (s-row stride ld):
// da0 = dA0 x + A0 y (coefficient and v-weight motion, then A0 on y);
// mtx = dA1 x (P rows times dvfl); a2tx = dA2 x (zero-sum bands);
// a1y = A1 y and a2y = A2 y, each with its reaction.
template <typename T>
__device__ __forceinline__ void tangent_parts(
    const T* x, const T* y, int i, int j, int ns, int nv, int ld,
    const T* sf, const T* vf, T tsfk, const T* tv, T react_row, int n_react,
    T& da0, T& mtx, T& a2tx, T& a1y, T& a2y) {
  const T zero = T(0);
  const int k = i * ld + j;
  const T bsm = sf[BSM * ns + i];
  const T bsp = sf[BSP * ns + i];
  // beta_s stencil of surface f at column jj of s-row i
  auto ds_at = [&](const T* f, int jj) -> T {
    const T c = f[i * ld + jj];
    return bsm * (f[(i - 1) * ld + jj] - c) + bsp * (f[(i + 1) * ld + jj] - c);
  };
  // primal x
  const T xv = x[k];
  const T dlo = x[k - ld] - xv;
  const T dhi = x[k + ld] - xv;
  const T dsu = bsm * dlo + bsp * dhi;
  const T dsm = ds_at(x, j - 1);
  const T dsp = ds_at(x, j + 1);
  const T dv = vf[BVM * nv + j] * (dsm - dsu) + vf[BVP * nv + j] * (dsp - dsu);
  const T dvt = tv[TBVM * nv + j] * (dsm - dsu)
                + tv[TBVP * nv + j] * (dsp - dsu);
  // tangent y
  const T yx = y[k];
  const T ydlo = y[k - ld] - yx;
  const T ydhi = y[k + ld] - yx;
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
  const T* row = x + i * ld;
  const T* yrow = y + i * ld;
  const T xm2 = row[j - 2];
  const T xm1 = row[j - 1];
  const T xp1 = row[j + 1];
  const T xp2 = row[j + 2];
  const T ym2 = yrow[j - 2];
  const T ym1 = yrow[j - 1];
  const T yp1 = yrow[j + 1];
  const T yp2 = yrow[j + 2];
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
                                        int ld, const T* sf, T dvfl) {
  const int k = i * ld + j;
  const T xv = x[k];
  const T dlo = x[k - ld] - xv;
  const T dhi = x[k + ld] - xv;
  return (dvfl * sf[PL * ns + i]) * dlo + (dvfl * sf[PU * ns + i]) * dhi;
}

// The sweeps below walk a line in chunks of kChunk rows: a chunk's
// operands are all loaded first (independent loads, one memory latency),
// then the recurrence runs through the chunk in registers; the main loop
// carries no bounds check, and only the last chunk of a line (fewer than
// kChunk rows) loads and steps under a guard. A read-ahead ring
// carried from row to row costs more than it saves: the compiler rotates
// it with register moves that wait on the loads just issued.

// In-place Thomas solve of (I - td*A1) along s of v-line j of dd (s-row
// stride ld); `copy`, when not null, also takes the solution
template <typename T>
__device__ __forceinline__ void thomas_line(T* __restrict__ dd,
                                            const T* __restrict__ tw,
                                            const T* __restrict__ ti,
                                            const T* __restrict__ sf, T v,
                                            T td, int ns, int ld, int j,
                                            T* __restrict__ copy) {
  const int m1 = ns - 1;
  T* col = dd + j;
  const T* wc = tw + j;
  const T* ic = ti + j;
  // forward: rows 1..m1, chunk [i0, i0 + kChunk) (GUARD: the last, cut
  // at m1)
  T dprev = col[0];
  auto forward = [&](int i0, auto guard) {
    constexpr bool GUARD = decltype(guard)::value;
    T dq[kChunk], wq[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const bool ok = !GUARD || i0 + q <= m1;
      dq[q] = ok ? col[(i0 + q) * ld] : T(0);
      wq[q] = ok ? wc[(i0 + q) * ld] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (!GUARD || i0 + q <= m1) {
        dprev = dq[q] - wq[q] * dprev;
        col[(i0 + q) * ld] = dprev;
      }
    }
  };
  int i0 = 1;
  for (; i0 + kChunk - 1 <= m1; i0 += kChunk) forward(i0, std::false_type());
  if (i0 <= m1) forward(i0, std::true_type());
  // backward: rows m1 - 1 .. 0, chunk (i0 - kChunk, i0]
  T x = col[m1 * ld] * ic[m1 * ld];
  col[m1 * ld] = x;
  if (copy) copy[m1 * ld + j] = x;
  auto backward = [&](int i0, auto guard) {
    constexpr bool GUARD = decltype(guard)::value;
    T bq[kChunk], iq[kChunk], uq[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int i = i0 - q;
      const bool ok = !GUARD || i >= 0;
      bq[q] = ok ? col[i * ld] : T(0);
      iq[q] = ok ? ic[i * ld] : T(0);
      uq[q] = ok ? -td * (v * sf[PU * ns + i] + sf[QU * ns + i]) : T(0);
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int i = i0 - q;
      if (!GUARD || i >= 0) {
        x = (bq[q] - uq[q] * x) * iq[q];
        col[i * ld] = x;
        if (copy) copy[i * ld + j] = x;
      }
    }
  };
  i0 = m1 - 1;
  for (; i0 - kChunk + 1 >= 0; i0 -= kChunk) backward(i0, std::false_type());
  if (i0 >= 0) backward(i0, std::true_type());
}

// Pentadiagonal solve of (I - td*A2) along v into the s-line `row`, whose
// right-hand side at j is in(j) (formed before row[j] is written: in(j)
// may read row[j])
template <typename T, typename In>
__device__ __forceinline__ void penta_line(T* row, const T* __restrict__ pf,
                                           int nv, In in) {
  T dp1 = pf[PM * nv] * in(0);
  row[0] = dp1;
  T dp2 = T(0);
  // forward: columns 1..nv-1, chunk [j0, j0 + kChunk)
  auto forward = [&](int j0, auto guard) {
    constexpr bool GUARD = decltype(guard)::value;
    T aq[kChunk], mq[kChunk], gq[kChunk], hq[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int j = j0 + q;
      const bool ok = !GUARD || j < nv;
      aq[q] = ok ? in(j) : T(0);
      mq[q] = ok ? pf[PM * nv + j] : T(0);
      gq[q] = ok ? pf[PGM * nv + j] : T(0);
      hq[q] = ok ? pf[PHM * nv + j] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (!GUARD || j0 + q < nv) {
        const T dpj = mq[q] * aq[q] - gq[q] * dp1 - hq[q] * dp2;
        row[j0 + q] = dpj;
        dp2 = dp1;
        dp1 = dpj;
      }
    }
  };
  int j0 = 1;
  for (; j0 + kChunk <= nv; j0 += kChunk) forward(j0, std::false_type());
  if (j0 < nv) forward(j0, std::true_type());
  // backward: columns nv-2..0, chunk (j0 - kChunk, j0]
  T x1 = row[nv - 1];
  T x2 = T(0);
  auto backward = [&](int j0, auto guard) {
    constexpr bool GUARD = decltype(guard)::value;
    T bq[kChunk], cq[kChunk], c2q[kChunk];
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      const int j = j0 - q;
      const bool ok = !GUARD || j >= 0;
      bq[q] = ok ? row[j] : T(0);
      cq[q] = ok ? pf[PC * nv + j] : T(0);
      c2q[q] = ok ? pf[PC2 * nv + j] : T(0);
    }
#pragma unroll
    for (int q = 0; q < kChunk; ++q) {
      if (!GUARD || j0 - q >= 0) {
        const T xj = bq[q] - cq[q] * x1 - c2q[q] * x2;
        row[j0 - q] = xj;
        x2 = x1;
        x1 = xj;
      }
    }
  };
  j0 = nv - 2;
  for (; j0 - kChunk + 1 >= 0; j0 -= kChunk) backward(j0, std::false_type());
  if (j0 >= 0) backward(j0, std::true_type());
}

// u0, lam0: the state in [B][ns*nv]; u_out, lam_out: the state out
// (lam_out written for American loops only); work: the global scratch of
// the fields fmask leaves out of shared memory, wstride values a block;
// nst: null, or [B] per-lane last local steps.
// TAN = false: the primal loop (tsfields .. dlam_out unused, K = 0, one
// block per option).
// TAN = true: also K tangent surfaces over a grid (B, G), block (b, g)
// carrying tangents g*K/G .. (g+1)*K/G - 1; tsfields [B][K][ns], tvfields
// [B][K][NTVF][nv]; the tangent state in, du0 and dlam0 [B][K][ns*nv]
// (null: zero; dlam0 unscaled, read by American loops only), and out,
// du_out and dlam_out (dlam_out written by American loops only, null
// otherwise).
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
      T *__restrict__ dlam_out, int ns, int nv, int first_step,             \
      int n_steps, int american, int n_events, int K, int payoff,           \
      int n_react, int knock0, int knock1, int apart_flag, int fmask,       \
      long long wstride, T dt, T td, T rf, T cm
#define KERNEL_ARGS                                                         \
  u0, lam0, u_out, lam_out, work, sfields, vfields, scalars, ev_step,       \
      ev_idx, ev_w, nst, tsfields, tvfields, du0, dlam0, du_out, dlam_out,  \
      ns, nv, first_step, n_steps, american, n_events, K, payoff, n_react,  \
      knock0, knock1, apart_flag, fmask, wstride, dt, td, rf, cm
template <typename T, bool TAN, int SCHEME, bool GEN, bool SMEM>
__device__ __forceinline__ void fused_do_body(KERNEL_PARAMS) {
  constexpr bool CORR = SCHEME != DO;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int b = blockIdx.x;
  const int g = blockIdx.y;              // the tangent group (0: primal)
  const int kg = TAN ? K / gridDim.y : 0;  // the tangents of this block
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int np = ns * nv;
  const int ld = row_stride(nv);
  const int fs = surface(ns, nv);        // one working surface
  const int m1 = ns - 1;
  const T zero = T(0);
  const T one = T(1);
  const T hdt = T(0.5) * dt;
  PHASE_CLOCK_BEGIN
  T* sf = reinterpret_cast<T*>(smem_raw);  // [NSF][ns]
  T* vf = sf + NSF * ns;                   // [NVF][nv]
  T* pf = vf + NVF * nv;                   // [NPF][nv]
  T* tsf = pf + NPF * nv;                  // [kg][ns]        (TAN)
  T* tvf = tsf + kg * ns;                  // [kg][NTVF][nv]  (TAN)
  T* flr = tvf + kg * NTVF * nv;           // [ns] the American floor
  int* b1i = reinterpret_cast<int*>(flr + ns);  // [2][nv] the b1 nodes
  // the working fields: in shared memory where fmask says so (SMEM:
  // all of them), else in this block's global scratch
  T* fld[NFIELD];
  {
    const int origin = ld + 2;  // node (0, 0) of a surface
    T* sp = reinterpret_cast<T*>(b1i + 2 * nv) + origin;
    T* gp = work + (size_t)(b * gridDim.y + g) * (size_t)wstride + origin;
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) {
      const int n = field_count(f, TAN, CORR, american, kg);
      if (SMEM || (n && ((fmask >> f) & 1))) {
        fld[f] = sp;
        sp += (size_t)n * fs;
      } else {
        fld[f] = n ? gp : nullptr;
        gp += (size_t)n * fs;
      }
    }
    // the borders: rows -1 and ns, columns -2, -1, nv, nv + 1 of every
    // surface, zero for the whole launch (nothing writes outside the grid)
    const int per = 2 * ld + 4 * ns;
#pragma unroll
    for (int f = 0; f < NFIELD; ++f) {
      const int n = field_count(f, TAN, CORR, american, kg);
      for (int q = tid; q < n * per; q += nt) {
        const int sidx = q / per;
        const int r = q - sidx * per;
        int i, j;
        if (r < 2 * ld) {
          i = r < ld ? -1 : ns;
          j = (r < ld ? r : r - ld) - 2;
        } else {
          const int c = r - 2 * ld;
          i = c >> 2;
          j = (c & 3) < 2 ? (c & 3) - 2 : nv + (c & 3) - 2;
        }
        fld[f][sidx * fs + i * ld + j] = zero;
      }
    }
  }
  T* const d = fld[FD];
  T* const tw = fld[FTW];
  T* const ti = fld[FTI];
  T* const e = fld[FE];          // CORR
  T* const tbuf = fld[FTBUF];    // TAN: [kg] surfaces
  T* const trb = fld[FTRB];      // TAN && CORR: [kg]
  T* const u = fld[FU];
  T* const comp = fld[FCOMP];
  T* const lam = fld[FLAM];      // American
  T* const luw = fld[FLUW];      // CORR
  T* const z1 = fld[FZ1];        // TAN
  T* const z1c = fld[FZ1C];      // TAN && CORR
  T* const du = fld[FDU];        // TAN: [kg]
  T* const dlam = fld[FDLAM];    // TAN && American: [kg]
  const PointMap pm = point_map(ns, nv);

  // this block's last local step (block-uniform: the barriers below stay
  // reached by every thread)
  const int last = nst ? min(n_steps, nst[b]) : n_steps;
  const bool digital =
      GEN && (payoff == DIGITAL_CALL || payoff == DIGITAL_PUT);
  const bool apart = GEN && apart_flag;

  // the start-of-launch copies from global memory, four loads in flight
#pragma unroll 4
  for (int k = tid; k < NSF * ns; k += nt)
    sf[k] = sfields[(size_t)b * NSF * ns + k];
#pragma unroll 4
  for (int k = tid; k < NVF * nv; k += nt)
    vf[k] = vfields[(size_t)b * NVF * nv + k];
  const T b1v = scalars[2 * b];
  const T kk = scalars[2 * b + 1];

  const T* ub = u0 + (size_t)b * np;
  const T* lb = lam0 + (size_t)b * np;
#pragma unroll 4
  for (int p = tid; p < np; p += nt) {
    const int i = p / nv;
    const int k = i * ld + p - i * nv;
    u[k] = ub[p];
    comp[k] = zero;
    if (american) lam[k] = dt * lb[p];  // the dt-scaled carry
  }
  // this group's first tangent of option b, in [B][K]
  const size_t t0 = (size_t)b * K + (size_t)g * kg;
  if (TAN) {
#pragma unroll 4
    for (int k = tid; k < kg * ns; k += nt) tsf[k] = tsfields[t0 * ns + k];
#pragma unroll 4
    for (int k = tid; k < kg * NTVF * nv; k += nt)
      tvf[k] = tvfields[t0 * NTVF * nv + k];
#pragma unroll 4
    for (int p = tid; p < kg * np; p += nt) {
      const int kt = p / np;
      const int i = (p - kt * np) / nv;
      const int q = kt * fs + i * ld + p - kt * np - i * nv;
      du[q] = du0 ? du0[t0 * np + p] : zero;
      if (american) dlam[q] = dlam0 ? dt * dlam0[t0 * np + p] : zero;
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
  // b1 sits at the v-major flat indices m1*(q+1), q = 0..nv-1 (the
  // reference's placement quirk): in v-column j the s-rows i with
  // j*ns + i a multiple of m1 (i = r and r + m1, r = -j*ns mod m1) and in
  // range, found once a launch
  for (int j = tid; j < nv; j += nt) {
    int at0 = -1, at1 = -1;
    for (int i = (m1 - (j * ns) % m1) % m1; i < ns; i += m1) {
      const int flat = j * ns + i;
      if (flat >= m1 && flat <= m1 * nv) {
        if (at0 < 0)
          at0 = i;
        else
          at1 = i;
      }
    }
    b1i[j] = at0;
    b1i[nv + j] = at1;
  }

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
      tw[i * ld + j] = wi;
      ti[i * ld + j] = one / temp;
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
  PHASE_MARK(PH_SETUP)

  const T react_row = Q_d[ns - 1];  // -r_d/2
  // b1 on its nodes, b2 on v-row nv-1, s >= 1
  auto b1_at = [&](int i, int j) -> T {
    return (i == b1i[j] || i == b1i[nv + j]) ? b1v : zero;
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
      // the remap of the field x at point (i, j): a = wsum*x[i, j] and
      // the correction acc = w0 (x[c0, j] - x[i, j]) + w1 (x[c1, j] -
      // x[i, j]), with the source columns clamped into the grid (in range
      // by construction on the host; the clamp keeps every read in bounds)
      auto remap_at = [&](const T* x, int i, int j, T& a, T& acc) {
        const T w0 = w[i];
        const T w1 = w[ns + i];
        const int c0 = min(max(idx[i], 0), m1);
        const int c1 = min(max(idx[ns + i], 0), m1);
        const T xv = x[i * ld + j];
        acc = w0 * (x[c0 * ld + j] - xv) + w1 * (x[c1 * ld + j] - xv);
        a = (w0 + w1 > T(0.5) ? one : zero) * xv;
      };
      for_points(pm, 1, ns, nv, [&](int, int i, int j) {
        const int k = i * ld + j;
        d[k] = apart ? comp[k] : u[k] + comp[k];
      });
      if (TAN)
        for_points(pm, kg, ns, nv, [&](int kt, int i, int j) {
          const int q = kt * fs + i * ld + j;
          tbuf[q] = du[q];
        });
      __syncthreads();
      if (apart) {
        // the compensation's remap, then u's copy into d
        for_points(pm, 1, ns, nv, [&](int, int i, int j) {
          T a, acc;
          remap_at(d, i, j, a, acc);
          comp[i * ld + j] = a + acc;
        });
        __syncthreads();
        for_points(pm, 1, ns, nv, [&](int, int i, int j) {
          d[i * ld + j] = u[i * ld + j];
        });
        __syncthreads();
      }
      for_points(pm, 1, ns, nv, [&](int, int i, int j) {
        const int k = i * ld + j;
        T a, acc;
        remap_at(d, i, j, a, acc);
        const T s = a + acc;
        const T bb = s - a;
        const T e2 = (a - (s - bb)) + (acc - bb);
        u[k] = s;
        comp[k] = apart ? comp[k] + e2 : e2;
      });
      if (TAN) {
        // the remap is linear and parameter-free: each tangent takes
        // the value of the same sum, with no compensation
        for_points(pm, kg, ns, nv, [&](int kt, int i, int j) {
          const T w0 = w[i];
          const T w1 = w[ns + i];
          const int c0 = min(max(idx[i], 0), m1);
          const int c1 = min(max(idx[ns + i], 0), m1);
          const T* tb = tbuf + kt * fs;
          const T x = tb[i * ld + j];
          const T acc = w0 * (tb[c0 * ld + j] - x) + w1 * (tb[c1 * ld + j] - x);
          du[kt * fs + i * ld + j] = (w0 + w1 > T(0.5) ? one : zero) * x + acc;
        });
      }
      __syncthreads();
    }
    PHASE_MARK(PH_EVENTS)

    const T nf = T(n);
    const T e0 = exp_t<T>(rf * dt * (nf - one));
    const T e1 = exp_t<T>(rf * dt * nf);
    const T kb1 = dt * e0 + td * (e1 - e0);
    const T kb2a = dt * e0;
    const T kb2b = td * (e1 - e0);

    // ---- 1. rhs1 (point-parallel); a corrector keeps L u
    for_points(pm, 1, ns, nv, [&](int, int i, int j) {
      const int k = i * ld + j;
      T a0, a1, a2;
      l_parts(u, i, j, ns, nv, ld, sf, vf, react_row, n_react, a0, a1, a2);
      const T lu = a0 + a1 + a2;
      if (CORR) luw[k] = lu;
      T rhs = dt * lu + (kb1 * b1_at(i, j) + kb2a * b2_at(i, j));
      if (american) rhs = rhs + lam[k];
      d[k] = rhs;
    });
    __syncthreads();
    PHASE_MARK(PH_RHS)

    // ---- 2. Thomas solve along s, one thread per v-line (the tangent
    // phase reads its solution z1)
    for (int j = tid; j < nv; j += nt)
      thomas_line(d, tw, ti, sf, vfl[j], td, ns, ld, j, TAN ? z1 : nullptr);
    __syncthreads();
    PHASE_MARK(PH_THOMAS)

    // ---- 3./4. b2 injection and pentadiagonal solve along v, one thread
    // per s-line
    for (int i = tid; i < ns; i += nt) {
      T* row = d + i * ld;
      row[nv - 1] = row[nv - 1] + kb2b * sf[B2R * ns + i];
      penta_line(row, pf, nv, [&](int j) { return row[j]; });
    }
    __syncthreads();
    PHASE_MARK(PH_PENTA)

    if (CORR) {
      // ---- C1. the corrector's stage-1 rhs into e (point-parallel) from
      // the kept L u and the stencils of the predictor increment z2 = d
      const T kmc = cm * (e1 - e0);
      const T khv = hdt * (e1 - e0);
      for_points(pm, 1, ns, nv, [&](int, int i, int j) {
        const int k = i * ld + j;
        T a0, a1, a2;
        l_parts(d, i, j, ns, nv, ld, sf, vf, react_row, n_react, a0, a1,
                a2);
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
      });
      __syncthreads();
      // ---- C2. Thomas solve of e along s (z1c: its solution)
      for (int j = tid; j < nv; j += nt)
        thomas_line(e, tw, ti, sf, vfl[j], td, ns, ld, j,
                    TAN ? z1c : nullptr);
      __syncthreads();
      // ---- C3./C4. (CS, MCS) the b2 injection, then the penta solve of e
      for (int i = tid; i < ns; i += nt) {
        T* row = e + i * ld;
        if (SCHEME != HV)
          row[nv - 1] = row[nv - 1] + kb2b * sf[B2R * ns + i];
        penta_line(row, pf, nv, [&](int j) { return row[j]; });
      }
      __syncthreads();
      PHASE_MARK(PH_CORR)
    }

    if (TAN) {
      // ---- T1. tangent rhs (point-parallel over kg surfaces):
      // dt*(dA0 u + A0 du + dA1 u + A1 du + dA2 u + A2 du) [+ dlam]
      // + td*dA1 z1 (a corrector keeps the first part)
      for_points(pm, kg, ns, nv, [&](int kt, int i, int j) {
        const int q = kt * fs + i * ld + j;
        const T* tv = tvf + kt * NTVF * nv;
        T da0, mtu, a2tu, a1y, a2y;
        tangent_parts(u, du + kt * fs, i, j, ns, nv, ld, sf, vf,
                      tsf[kt * ns + i], tv, react_row, n_react, da0, mtu,
                      a2tu, a1y, a2y);
        T trhs = dt * (((da0 + mtu) + a1y) + (a2tu + a2y));
        if (american) trhs = trhs + dlam[q];
        if (CORR) trb[q] = trhs;
        tbuf[q] = trhs + td * tangent_a1(z1, i, j, ns, ld, sf,
                                         tv[TVFL * nv + j]);
      });
      __syncthreads();
      PHASE_MARK(PH_TRHS)

      // ---- T2. tangent Thomas solves along s: kg * nv lines
      for (int l = tid; l < kg * nv; l += nt) {
        const int kt = l / nv;
        const int j = l - kt * nv;
        thomas_line(tbuf + kt * fs, tw, ti, sf, vfl[j], td, ns, ld, j,
                    (T*)nullptr);
      }
      __syncthreads();
      PHASE_MARK(PH_TTHOMAS)

      // dz1 + td * dA2 x at s-line `row` of one direction, x the primal
      // increment the stage anchors at (formed as the forward sweep reads)
      auto stage2_in = [&](const T* row, const T* zr, const T* tv) {
        return [=](int j) -> T {
          const T x = zr[j];
          const T xm2 = zr[j - 2];
          const T xm1 = zr[j - 1];
          const T xp1 = zr[j + 1];
          const T xp2 = zr[j + 2];
          return row[j] + td * (tv[TAL2 * nv + j] * (xm2 - x)
                                + tv[TAL1 * nv + j] * (xm1 - x)
                                + tv[TAU1 * nv + j] * (xp1 - x)
                                + tv[TAU2 * nv + j] * (xp2 - x));
        };
      };
      // ---- T3. tangent penta solves along v: kg * ns lines, on
      // dz1 + td * dA2 z2
      for (int l = tid; l < kg * ns; l += nt) {
        const int kt = l / ns;
        const int i = l - kt * ns;
        T* row = tbuf + kt * fs + i * ld;
        penta_line(row, pf, nv,
                   stage2_in(row, d + i * ld, tvf + kt * NTVF * nv));
      }
      __syncthreads();
      PHASE_MARK(PH_TPENTA)

      if (CORR) {
        // ---- T4. the corrector's tangent rhs into trb (point-parallel):
        // the kept trhs plus the tangent of its A0 z2 (CS) or L z2 (MCS,
        // HV) terms, z2 = d and dz2 = tbuf, plus td * dA1 z1c
        for_points(pm, kg, ns, nv, [&](int kt, int i, int j) {
          const int k = i * ld + j;
          const int q = kt * fs + k;
          const T* tv = tvf + kt * NTVF * nv;
          const T* y = tbuf + kt * fs;
          T da0, mtz, a2tz, a1y, a2y;
          tangent_parts(d, y, i, j, ns, nv, ld, sf, vf, tsf[kt * ns + i],
                        tv, react_row, n_react, da0, mtz, a2tz, a1y, a2y);
          T crhs;
          if (SCHEME == CS) {
            crhs = trb[q] + hdt * da0;
          } else {
            const T dlz = da0 + mtz + a2tz + a1y + a2y;
            crhs = SCHEME == MCS ? trb[q] + td * da0 + cm * dlz
                                 : trb[q] - y[k] + hdt * dlz;
          }
          trb[q] = crhs + td * tangent_a1(z1c, i, j, ns, ld, sf,
                                          tv[TVFL * nv + j]);
        });
        __syncthreads();
        // ---- T5. Thomas solves of trb along s
        for (int l = tid; l < kg * nv; l += nt) {
          const int kt = l / nv;
          const int j = l - kt * nv;
          thomas_line(trb + kt * fs, tw, ti, sf, vfl[j], td, ns, ld, j,
                      (T*)nullptr);
        }
        __syncthreads();
        // ---- T6. penta solves of trb + td * dA2 e along v (the stage
        // anchors at the corrector's own penta solution)
        for (int l = tid; l < kg * ns; l += nt) {
          const int kt = l / ns;
          const int i = l - kt * ns;
          T* row = trb + kt * fs + i * ld;
          penta_line(row, pf, nv,
                     stage2_in(row, e + i * ld, tvf + kt * NTVF * nv));
        }
        __syncthreads();
        PHASE_MARK(PH_TCORR)
      }
    }

    // ---- 5. compensated update (Fast2Sum), American floor + multiplier
    // (a digital: the projection onto [floor, 1]); the tangents first,
    // from the same compensated q and lam_arg (q and qm)
    for_points(pm, 1, ns, nv, [&](int, int i, int j) {
      const int k = i * ld + j;
      const T z2 = SCHEME == DO ? d[k] : (SCHEME == HV ? d[k] + e[k] : e[k]);
      const T x = u[k];
      // the tangent increment of direction kt
      auto dinc = [&](int o) -> T {
        return SCHEME == DO ? tbuf[o]
                            : (SCHEME == HV ? tbuf[o] + trb[o] : trb[o]);
      };
      if (american && digital) {
        const T floor_ = flr[i];
        const T t = z2 + comp[k];
        const T q = x + t;
        const T err = t - (q - x);
        const bool pin = floor_ == one;
        const T qm = q > floor_ ? q : floor_;
        if (TAN) {
          for (int kt = 0; kt < kg; ++kt) {
            const int o = kt * fs + k;
            const T dub = du[o] + dinc(o);
            const T dm = q > floor_ ? dub : (q < floor_ ? zero : T(0.5) * dub);
            du[o] = pin ? zero
                        : (qm < one ? dm : (qm > one ? zero : T(0.5) * dm));
          }
        }
        u[k] = pin ? floor_ : (qm < one ? qm : one);
        comp[k] = (q > floor_ && qm < one && !pin) ? err : zero;
      } else if (american) {
        const T floor_ = flr[i];
        const T t = (z2 - lam[k]) + comp[k];
        const T q = x + t;
        const T err = t - (q - x);
        const T la = (floor_ - q) - err;
        if (TAN) {
          for (int kt = 0; kt < kg; ++kt) {
            const int o = kt * fs + k;
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
          for (int kt = 0; kt < kg; ++kt) {
            const int o = kt * fs + k;
            du[o] = du[o] + dinc(o);
          }
        const T t = z2 + comp[k];
        const T q = x + t;
        comp[k] = t - (q - x);
        u[k] = q;
      }
    });
    __syncthreads();
    PHASE_MARK(PH_UPDATE)
  }

  // the state out: u with its compensation folded in and lam unscaled
  // (group 0), the group's tangents
  if (g == 0) {
    T* uo = u_out + (size_t)b * np;
    T* lo = lam_out + (size_t)b * np;
    for_points(pm, 1, ns, nv, [&](int, int i, int j) {
      const int k = i * ld + j;
      uo[i * nv + j] = u[k] + comp[k];
      if (american) lo[i * nv + j] = lam[k] / dt;
    });
  }
  if (TAN)
    for_points(pm, kg, ns, nv, [&](int kt, int i, int j) {
      const size_t o = (t0 + kt) * np + i * nv + j;
      const int q = kt * fs + i * ld + j;
      du_out[o] = du[q];
      if (american) dlam_out[o] = dlam[q] / dt;
    });
  PHASE_MARK(PH_OUT)
  PHASE_CLOCK_END
}

// float32 Douglas, float64 Douglas at 256 threads, and the forward mode of
// every scheme: no launch bounds (the compiler's own register choice)
template <typename T, bool TAN, int SCHEME, bool GEN, bool SMEM>
__global__ void fused_do_kernel(KERNEL_PARAMS) {
  fused_do_body<T, TAN, SCHEME, GEN, SMEM>(KERNEL_ARGS);
}

// a corrector scheme's primal loop, and float64 Douglas's at 128 threads:
// 4 resident blocks an SM (kPrimalThreads above)
template <typename T, int SCHEME, bool GEN, bool SMEM>
__global__ void __launch_bounds__(kPrimalThreads, kPrimalBlocksPerSm)
    fused_do_kernel_bounded(KERNEL_PARAMS) {
  fused_do_body<T, false, SCHEME, GEN, SMEM>(KERNEL_ARGS);
}

// the kernel of one (T, TAN, SCHEME, GEN, SMEM) at `threads` a block,
// instantiating only what it can return (SMEM only where kSmemKernel<T>):
// the bounded kernel for a corrector's primal loop and for float64
// Douglas's primal at kPrimalThreads (fused_do.bounded_kernel)
template <typename T, bool TAN, int SCHEME, bool GEN, bool SMEM>
auto kernel_for(int threads) {
  constexpr bool smem = SMEM && kSmemKernel<T>;
  if constexpr (TAN)
    return &fused_do_kernel<T, true, SCHEME, GEN, smem>;
  else if constexpr (SCHEME != DO)
    return &fused_do_kernel_bounded<T, SCHEME, GEN, smem>;
  else if constexpr (std::is_same<T, double>::value)
    return threads == kPrimalThreads
               ? &fused_do_kernel_bounded<T, DO, GEN, smem>
               : &fused_do_kernel<T, false, DO, GEN, smem>;
  else
    return &fused_do_kernel<T, false, DO, GEN, smem>;
}

// the kernel of a launch of `threads` a block: its scheme, with gen the
// other payoffs' branches, with smem every field in shared memory (null
// for an unknown scheme)
template <typename T, bool TAN>
auto kernel_of(int scheme, bool gen, bool smem, int threads)
    -> decltype(kernel_for<T, TAN, DO, false, false>(threads)) {
#define KERNEL_OF_GEN(S, M)                             \
  (gen ? kernel_for<T, TAN, S, true, M>(threads)        \
       : kernel_for<T, TAN, S, false, M>(threads))
#define KERNEL_OF(S) \
  (smem ? KERNEL_OF_GEN(S, true) : KERNEL_OF_GEN(S, false))
  switch (scheme) {
    case DO:
      return KERNEL_OF(DO);
    case CS:
      return KERNEL_OF(CS);
    case MCS:
      return KERNEL_OF(MCS);
    case HV:
      return KERNEL_OF(HV);
    default:
      return nullptr;
  }
#undef KERNEL_OF
#undef KERNEL_OF_GEN
}

// A kernel's attributes for a launch with `smem` bytes of dynamic shared
// memory: the opt-in past 48 KB, and the largest shared-memory carveout
// when fields live there (else CUDA's default carveout, L1 for the global
// scratch)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem, bool fields_in_smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      fields_in_smem ? (int)cudaSharedmemCarveoutMaxShared
                     : (int)cudaSharedmemCarveoutDefault);
}

// the launch arguments the kernel takes, or false
bool valid(int B, int ns, int nv, int first_step, int n_steps, int n_events,
           bool tan, int scheme, int K, int G, int payoff, int n_react,
           int knock0, int knock1, int apart, int fmask, int threads) {
  return !(B <= 0 || ns < 3 || nv < 3 || first_step < 1 || n_steps < 0 ||
           (threads != kPrimalThreads && threads != kWideThreads) ||
           (!tan && scheme != DO && threads != kPrimalThreads) ||
           n_events < 0 || (tan ? K < 1 : K != 0) || G < 1 || G > 65535 ||
           (tan ? K % G != 0 : G != 1) || payoff < CALL ||
           payoff > DIGITAL_PUT || n_react < 0 || n_react > nv ||
           knock0 < -1 || knock0 >= ns || knock1 < -1 || knock1 >= ns ||
           apart < 0 || apart > 1 || fmask < 0 || fmask >= (1 << NFIELD));
}

template <typename T, bool TAN>
int launch(const void* u0, const void* lam0, void* u_out, void* lam_out,
           void* work, const void* sfields, const void* vfields,
           const void* scalars, const void* ev_step, const void* ev_idx,
           const void* ev_w, const void* nst, const void* tsfields,
           const void* tvfields, const void* du0, const void* dlam0,
           void* du_out, void* dlam_out, int B, int ns, int nv,
           int first_step, int n_steps, int american, int n_events,
           int scheme, int payoff, int n_react, int knock0, int knock1,
           int apart, int K, int G, int fmask, int threads, long long wstride,
           double dt, double td, double rf, double cm, void* stream) {
  if (!valid(B, ns, nv, first_step, n_steps, n_events, TAN, scheme, K, G,
             payoff, n_react, knock0, knock1, apart, fmask, threads))
    return (int)cudaErrorInvalidValue;
  const bool corr = scheme != DO;
  const int kg = TAN ? K / G : 0;
  // the wrapper sized the scratch by the same placement
  if ((size_t)wstride != field_elems(ns, nv, TAN, corr, american != 0, kg,
                                     fmask, false))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      smem_bytes<T>(ns, nv, TAN, corr, american != 0, kg, fmask);
  // the plain call's loop (GEN = false) unless another payoff's branch
  // can be taken; the kernel for every field in shared memory when the
  // placement puts them all there
  auto* kernel = kernel_of<T, TAN>(
      scheme, payoff != CALL || apart,
      fmask == fields_present(TAN, corr, american != 0, kg), threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const cudaError_t err = prepare(kernel, smem, fmask != 0);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(B, G), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u0), static_cast<const T*>(lam0),
      static_cast<T*>(u_out), static_cast<T*>(lam_out),
      static_cast<T*>(work), static_cast<const T*>(sfields),
      static_cast<const T*>(vfields), static_cast<const T*>(scalars),
      static_cast<const int*>(ev_step), static_cast<const int*>(ev_idx),
      static_cast<const T*>(ev_w), static_cast<const int*>(nst),
      static_cast<const T*>(tsfields), static_cast<const T*>(tvfields),
      static_cast<const T*>(du0), static_cast<const T*>(dlam0),
      static_cast<T*>(du_out), static_cast<T*>(dlam_out), ns, nv,
      first_step, n_steps, american, n_events, K, payoff, n_react, knock0,
      knock1, apart, fmask, wstride, static_cast<T>(dt), static_cast<T>(td),
      static_cast<T>(rf), static_cast<T>(cm));
  return (int)cudaGetLastError();
}

template <typename T, bool TAN>
int occupancy(int ns, int nv, int american, int scheme, int payoff,
              int apart, int K, int G, int fmask, int threads, int* blocks,
              int* regs, long long* smem_out) {
  if (!valid(1, ns, nv, 1, 0, 0, TAN, scheme, K, G, payoff, 0, -1, -1, apart,
             fmask, threads))
    return (int)cudaErrorInvalidValue;
  const int kg = TAN ? K / G : 0;
  const size_t smem =
      smem_bytes<T>(ns, nv, TAN, scheme != DO, american != 0, kg, fmask);
  auto* kernel = kernel_of<T, TAN>(
      scheme, payoff != CALL || apart,
      fmask == fields_present(TAN, scheme != DO, american != 0, kg),
      threads);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaError_t err = prepare(kernel, smem, fmask != 0);
  if (err != cudaSuccess) return (int)err;
  *smem_out = (long long)smem;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  *regs = attr.numRegs;
  return (int)err;
}

#undef KERNEL_PARAMS
#undef KERNEL_ARGS

// ---------------------------------------------------------------------------
// The plan of a book on the card: book_plan_kernel<T>
//
// One block per option (grid = B) builds every input of this kernel for its
// lane, in this kernel's packed layout, by the plan arithmetic that
// csrc/fused_single.cu's single_plan_kernel shares (plan.cuh's plan_lane):
// u0 and lam0 [B][ns][nv], the s-rows [B][NSF][ns], the v-columns
// [B][NVF][nv], the scalars [B][2], the price's node b*ns*nv + i*nv + j,
// and each phase's events as one block [B][count][2][ns] (what a launch of
// the phase reads); block 0 writes the events' steps. With per-lane step
// counts (nst_in, int32 [B]; null: every lane runs the solver's count) the
// lane's boundary data is scaled by its own count, an event past the
// lane's last step of its phase takes the identity row, and the first
// launch writes each phase's per-lane last step (nst_out [phases][B]:
// 2 min(n, R) for the damp phase, n for the main one).

#include "plan.cuh"

template <typename T>
__global__ void __launch_bounds__(kPlanThreads) book_plan_kernel(
    const PlanArgs a, const PlanEvents ev, const PlanPhases ph,
    const double* __restrict__ market, const T* __restrict__ strikes,
    const int* __restrict__ nst_in, T* __restrict__ u0,
    T* __restrict__ lam0, T* __restrict__ sf, T* __restrict__ vf,
    T* __restrict__ sc, int* __restrict__ ev_step, int* __restrict__ ev_idx,
    T* __restrict__ ev_w, int* __restrict__ nst_out,
    long long* __restrict__ at) {
  const int b = blockIdx.x, lanes = gridDim.x;
  const int ns = a.m1 + 1, nv = a.m2 + 1;
  const int n = nst_in ? nst_in[b] : a.n_steps;
  if (a.fields && nst_in && threadIdx.x < ph.n)
    nst_out[threadIdx.x * lanes + b] =
        !ph.damp[threadIdx.x] ? n
                              : 2 * (n < ph.rannacher ? n : ph.rannacher);
  const size_t surface = (size_t)b * ns * nv;
  const PlanLane<T> o = {strikes + b, u0 + surface, lam0 + surface, true,
                         sf + (size_t)b * NSF * ns, vf + (size_t)b * NVF * nv,
                         sc + 2 * (size_t)b, at + b, (long long)surface,
                         b == 0 ? ev_step : nullptr, ev_idx, ev_w, lanes, b,
                         n, nst_in != nullptr};
  plan_lane(a, ev, ph, plan_market(a, market), o);
}

// threads a block of the book plan: the warp multiple that covers the
// longer axis, at most kPlanThreads
inline int book_plan_threads(int ns, int nv) {
  const int n = ns > nv ? ns : nv;
  const int t = (n + 31) / 32 * 32;
  return t < kPlanThreads ? t : kPlanThreads;
}

template <typename T>
int launch_book_plan(const PlanArgs* args, const PlanEvents* ev,
                     const PlanPhases* ph, const void* market,
                     const void* strikes, const void* nst_in, void* u0,
                     void* lam0, void* sf, void* vf, void* sc, void* ev_step,
                     void* ev_idx, void* ev_w, void* nst_out, void* at, int B,
                     void* stream) {
  bool phases_ok = ph->n >= 1 && ph->n <= kPlanPhases && ph->rannacher >= 0;
  for (int p = 0; phases_ok && p < ph->n; ++p)
    phases_ok = ph->first[p] >= 0 && ph->count[p] >= 0
                && (p == 0 ? ph->first[p] == 0
                           : ph->first[p] == ph->first[p - 1]
                                                + ph->count[p - 1]);
  if (!phases_ok || B < 1 || args->m1 < 2 || args->m2 < 3
      || args->payoff < CALL || args->payoff > DIGITAL_PUT
      || args->barrier < NO_BARRIER || args->barrier > DOUBLE_OUT
      || ev->count < 0 || ev->count > kPlanEvents || ev->first < 0
      || ev->first + ev->count > ph->first[ph->n - 1] + ph->count[ph->n - 1]
      || (!args->fields && ev->count == 0) || (nst_in && !nst_out))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * (3 * (size_t)(args->m1 + 1) + 2 * (size_t)(args->m2 + 1));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  book_plan_kernel<T><<<B, book_plan_threads(args->m1 + 1, args->m2 + 1),
                        smem, static_cast<cudaStream_t>(stream)>>>(
      *args, *ev, *ph, static_cast<const double*>(market),
      static_cast<const T*>(strikes), static_cast<const int*>(nst_in),
      static_cast<T*>(u0), static_cast<T*>(lam0), static_cast<T*>(sf),
      static_cast<T*>(vf), static_cast<T*>(sc), static_cast<int*>(ev_step),
      static_cast<int*>(ev_idx), static_cast<T*>(ev_w),
      static_cast<int*>(nst_out), static_cast<long long*>(at));
  return (int)cudaGetLastError();
}

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
      int B, int ns, int nv, int first_step, int n_steps, int american,    \
      int n_events, int scheme, int payoff, int n_react, int knock0,       \
      int knock1, int apart, int K, int G
#define PLACE_ARGS int fmask, int threads, long long wstride
#define SCALAR_ARGS double dt, double td, double rf, double cm, void *stream

extern "C" int fused_do_f32(PRIMAL_ARGS, PLACE_ARGS, SCALAR_ARGS) {
  return launch<float, false>(u0, lam0, u_out, lam_out, work, sfields,
                              vfields, scalars, ev_step, ev_idx, ev_w, nst,
                              nullptr, nullptr, nullptr, nullptr, nullptr,
                              nullptr, B, ns, nv, first_step, n_steps,
                              american, n_events, scheme, payoff, n_react,
                              knock0, knock1, apart, 0, 1, fmask, threads,
                              wstride, dt, td, rf, cm, stream);
}

extern "C" int fused_do_f64(PRIMAL_ARGS, PLACE_ARGS, SCALAR_ARGS) {
  return launch<double, false>(u0, lam0, u_out, lam_out, work, sfields,
                               vfields, scalars, ev_step, ev_idx, ev_w, nst,
                               nullptr, nullptr, nullptr, nullptr, nullptr,
                               nullptr, B, ns, nv, first_step, n_steps,
                               american, n_events, scheme, payoff, n_react,
                               knock0, knock1, apart, 0, 1, fmask, threads,
                               wstride, dt, td, rf, cm, stream);
}

extern "C" int fused_do_tangent_f32(TANGENT_ARGS, PLACE_ARGS, SCALAR_ARGS) {
  return launch<float, true>(u0, lam0, u_out, lam_out, work, sfields,
                             vfields, scalars, ev_step, ev_idx, ev_w, nst,
                             tsfields, tvfields, du0, dlam0, du_out,
                             dlam_out, B, ns, nv, first_step, n_steps,
                             american, n_events, scheme, payoff, n_react,
                             knock0, knock1, apart, K, G, fmask, threads,
                             wstride, dt, td, rf, cm, stream);
}

extern "C" int fused_do_tangent_f64(TANGENT_ARGS, PLACE_ARGS, SCALAR_ARGS) {
  return launch<double, true>(u0, lam0, u_out, lam_out, work, sfields,
                              vfields, scalars, ev_step, ev_idx, ev_w, nst,
                              tsfields, tvfields, du0, dlam0, du_out,
                              dlam_out, B, ns, nv, first_step, n_steps,
                              american, n_events, scheme, payoff, n_react,
                              knock0, knock1, apart, K, G, fmask, threads,
                              wstride, dt, td, rf, cm, stream);
}

// The resources of the kernel a launch takes (fused_do.occupancy): its
// registers a thread, dynamic shared memory a block (with the fields of
// fmask) and resident blocks an SM of `threads` threads
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), with the attributes
// the launch sets
extern "C" int fused_do_occupancy(int f64, int tan, int ns, int nv,
                                  int american, int scheme, int payoff,
                                  int apart, int K, int G, int fmask,
                                  int threads, int* blocks, int* regs,
                                  long long* smem) {
  if (f64)
    return tan ? occupancy<double, true>(ns, nv, american, scheme, payoff,
                                         apart, K, G, fmask, threads, blocks,
                                         regs, smem)
               : occupancy<double, false>(ns, nv, american, scheme, payoff,
                                          apart, K, G, fmask, threads, blocks,
                                          regs, smem);
  return tan ? occupancy<float, true>(ns, nv, american, scheme, payoff,
                                      apart, K, G, fmask, threads, blocks,
                                      regs, smem)
             : occupancy<float, false>(ns, nv, american, scheme, payoff,
                                       apart, K, G, fmask, threads, blocks,
                                       regs, smem);
}

#define BOOK_PLAN_ARGS                                                     \
  const void *args, const void *ev, const void *ph, const void *market,   \
      const void *strikes, const void *nst_in, void *u0, void *lam0,      \
      void *sf, void *vf, void *sc, void *ev_step, void *ev_idx,          \
      void *ev_w, void *nst_out, void *at, int B, void *stream

// one launch of the book's plan kernel: every input of this kernel for the
// B options (args->fields) and the events ev->first.. of the schedule; the
// strikes, the per-lane step counts (nst_in, or null) and the market
// (where not null) are read on the card
extern "C" int book_plan_f32(BOOK_PLAN_ARGS) {
  return launch_book_plan<float>(
      static_cast<const PlanArgs*>(args), static_cast<const PlanEvents*>(ev),
      static_cast<const PlanPhases*>(ph), market, strikes, nst_in, u0, lam0,
      sf, vf, sc, ev_step, ev_idx, ev_w, nst_out, at, B, stream);
}

extern "C" int book_plan_f64(BOOK_PLAN_ARGS) {
  return launch_book_plan<double>(
      static_cast<const PlanArgs*>(args), static_cast<const PlanEvents*>(ev),
      static_cast<const PlanPhases*>(ph), market, strikes, nst_in, u0, lam0,
      sf, vf, sc, ev_step, ev_idx, ev_w, nst_out, at, B, stream);
}

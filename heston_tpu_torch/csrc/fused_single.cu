// Single-option ADI time loop for the Heston PDE: the latency kernel of a
// batch of one.
//
// Replaces heston_tpu/pallas/fused_single.py::_make_kernel (:110): schemes
// "do", "cs", "mcs" and "hv", calls, puts and cash-or-nothing digitals, with
// or without a knock-out barrier, European or American, with or without
// discrete dividends, flat rates. The host side is
// heston_tpu_torch/kernels/fused_single.py, whose fused_single_reference is
// the plain PyTorch version of exactly this arithmetic (not that of csrc/fused_do.cu: the
// two kernels order their sums differently and solve along s by different
// algorithms).
//
// What bounds it on an H100: the latency of one option's dependent chain
// on one SM. A batch of one has no breadth to spread over the card: the
// whole time loop is a sequence of dependent phases per step, and the
// card's bytes and FLOPs are idle (the 101 x 76 golden grid is 7,676
// points, ~60 operations a point and step). The design shortens the chain
// and keeps every phase on one block of 512 threads:
//   * the tridiagonal solve along s runs as parallel cyclic reduction
//     (PCR): ceil(log2 ns) levels, each one point-parallel pass, in place
//     of Thomas's 2*ns dependent rows. The level factors depend only on
//     the matrix, so they are built once a launch; they take 2*levels+1
//     fields (15 at ns = 101, 460 KB in f32), more than the 227 KB of
//     shared memory a block can use, so they live in global scratch that
//     the wrapper allocates and that stays in the 50 MB L2;
//   * each PCR level reads its neighbours at stride 2^l, so it needs a
//     second buffer and one __syncthreads: the two [nv, ns] ping-pong
//     buffers sit in shared memory (the host's routing rule,
//     fused_single.use_single, sends a grid here only when they fit);
//   * the pentadiagonal solve along v stays sequential, one thread per
//     s-column running its 2*nv dependent rows with no block barrier
//     inside; the five factor columns [nv] sit in shared memory;
//   * the state (u, compensation, dt-free multiplier) stays in global
//     scratch, point-parallel and L2-resident, as in csrc/fused_do.cu.
// Per step: the dividend remaps of the step, the explicit right-hand side,
// levels PCR passes, the scaling and b2 injection, the penta sweep and the
// compensated update — levels + 4 block barriers. A corrector scheme (a
// template parameter; TPU kernel :346-397) then builds its stage-1 rhs in
// one more point-parallel pass, from the predictor's L u (+ lam) and the
// stencils of its increment z2 (both kept in global scratch beside the
// state, so shared memory and the routing rule stay as they are), and runs
// the PCR passes, the scaling (and, but for HV, the b2 injection) and the
// penta sweep again: levels + 3 more barriers. HV's increment is z2 + w2.
//
// Layout: point k = j*ns + i, v row j, s column i (the TPU kernel's
// [nv, ns]). Arithmetic, in the TPU kernel's order:
//   lu = c_a0*dv(ds(u)) + a1mul(u) + a2mul(u), a1mul's bands v_j*P + Q,
//   the correctors' L z2 the same stencils on z2,
//   PCR with identity rows off the grid, the penta recurrence, 2Sum state
//   update; American: lu + lam, then (z2 - dt*lam) + comp, the floor
//   and lam' = max(0, ((floor - q) - err)/dt) with the s_max column masked
//   (lam crosses launches unscaled).
// The payoff comes as launch arguments, as in csrc/fused_do.cu: `payoff`,
// `n_react` (the A2 rows with the -r_d/2 reaction, :218-221) and up to two
// knocked s columns. The floor is one row of ns values in shared memory,
// built once a launch (:177-200): the call or put intrinsic, or a digital's
// clipped cell average, zero at the knocked columns. An American digital
// takes the static-pin + box projection (:402-414): 2Sum of u and
// z2 + comp, u pinned to the floor where it is 1, else min(max(q, floor),
// 1), the compensation kept only strictly inside, lam carried unchanged.
// Dividend remaps move u and the compensation separately and add u's
// captured rounding to the remapped compensation (fused_single.py:463-471);
// csrc/fused_do.cu instead folds the compensation into u first. Each
// remap is a 2-point gather in place of the TPU's O(ns^2) one-hot
// contraction, with the contraction's order of summation: ascending
// source column, one term of weight w0 + w1 where both sources coincide.
// Build without fast-math; -fmad=false keeps the plain version's roundings,
// -fmad=true contracts multiply-adds into FMAs, as csrc/fused_do.cu.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// coefficient rows, in the wrapper's packing order (the same as
// csrc/fused_do.cu's)
enum SField { PL, QL, PD, QD, PU, QU, SFAC, BSM, BSP, B2R, VECS, NSF };
enum VField { VFL, VFAC, BVM, BVP, AL2, AL1, AD, AU1, AU2, NVF };
// pentadiagonal factor columns [nv], in shared memory
enum Penta { PM, PGM, PHM, PC, PC2, NPF };
// global scratch [np] each: compensation, multiplier, then the PCR factors
// (alpha_l, gamma_l per level, then 1/b), then the six build buffers, then
// (a corrector scheme) the predictor's L u and increment z2
enum Work { COMP, LAM, FAC };
// time-loop schemes, in the order of fused_do.SCHEMES
enum Scheme { DO, CS, MCS, HV };
// payoffs, in the order of operators.OPTION_TYPES
enum Payoff { CALL, PUT, DIGITAL_CALL, DIGITAL_PUT };

constexpr int kThreads = 512;
constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's most on an H100

template <typename T> __device__ __forceinline__ T exp_t(T x);
template <> __device__ __forceinline__ float exp_t<float>(float x) {
  return expf(x);
}
template <> __device__ __forceinline__ double exp_t<double>(double x) {
  return exp(x);
}

// The American floor at s column i of the s-grid vs (TPU kernel :177-200):
// zero at a knocked column; the call or put intrinsic floored at 0; a
// digital's indicator averaged over the dual cell around s_i, clipped to
// [0, 1], with the den guard of a degenerate cell
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

// Knuth's 2Sum: s = fl(a + b), err = a + b - s exactly
template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& err) {
  s = a + b;
  const T bb = s - a;
  err = (a - (s - bb)) + (b - bb);
}

// 2-point difference-form remap of point (row, i) of the field x:
// two_sum(wsum*x_i, acc) with acc the contraction's terms in ascending
// source column
template <typename T>
__device__ __forceinline__ void remap_at(const T* x, int row, int i, int c0,
                                         int c1, T w0, T w1, T wsum, T& s,
                                         T& err) {
  const T xi = x[row + i];
  const T acc = c0 == c1 ? (w0 + w1) * (x[row + c0] - xi)
                         : w0 * (x[row + c0] - xi) + w1 * (x[row + c1] - xi);
  two_sum(wsum * xi, acc, s, err);
}

// The explicit operator's three parts at point (v row j, s column i) of
// the [nv, ns] field x, in the TPU kernel's order: a0 = c_a0*dv(ds(x)),
// a1 = a1mul(x), a2 = a2mul(x); L x = (a0 + a1) + a2.
template <typename T>
__device__ __forceinline__ void l_parts(const T* x, int j, int i, int ns,
                                        int nv, const T* sf, const T* vf,
                                        T react_row, int n_react, T& a0,
                                        T& a1, T& a2) {
  const T zero = T(0);
  const int m1 = ns - 1;
  const int k = j * ns + i;
  const T xv = x[k];
  const T bsm = sf[BSM * ns + i];
  const T bsp = sf[BSP * ns + i];
  // beta_s stencil of x at (v row jj, s column i), zero off the grid
  auto ds_at = [&](int jj) -> T {
    if (jj < 0 || jj >= nv) return zero;
    const T* r = x + jj * ns;
    const T c = r[i];
    return bsm * ((i > 0 ? r[i - 1] : zero) - c) +
           bsp * ((i < m1 ? r[i + 1] : zero) - c);
  };
  const T dsu = ds_at(j);
  const T dv = vf[BVM * nv + j] * (ds_at(j - 1) - dsu) +
               vf[BVP * nv + j] * (ds_at(j + 1) - dsu);
  const T v = vf[VFL * nv + j];
  const T dlo = (i > 0 ? x[k - 1] : zero) - xv;
  const T dhi = (i < m1 ? x[k + 1] : zero) - xv;
  const T react_s = i == 0 ? sf[QD * ns] : react_row;
  a1 = ((v * sf[PL * ns + i] + sf[QL * ns + i]) * dlo +
        (v * sf[PU * ns + i] + sf[QU * ns + i]) * dhi) +
       react_s * xv;
  const T xm2 = j >= 2 ? x[k - 2 * ns] : zero;
  const T xm1 = j >= 1 ? x[k - ns] : zero;
  const T xp1 = j + 1 < nv ? x[k + ns] : zero;
  const T xp2 = j + 2 < nv ? x[k + 2 * ns] : zero;
  const T react_v = j < n_react ? react_row : zero;
  a2 = (((vf[AL2 * nv + j] * (xm2 - xv) + vf[AL1 * nv + j] * (xm1 - xv)) +
         vf[AU1 * nv + j] * (xp1 - xv)) +
        vf[AU2 * nv + j] * (xp2 - xv)) +
       react_v * xv;
  a0 = (sf[SFAC * ns + i] * vf[VFAC * nv + j]) * dv;
}

// cm: (1/2 - theta)*dt, MCS's weight of L z2; payoff, n_react, knock0,
// knock1: the payoff (Payoff), the reaction rows, the knocked s columns
// (-1: none)
template <typename T, int SCHEME>
__global__ void __launch_bounds__(kThreads) fused_single_kernel(
    const T* __restrict__ u0, const T* __restrict__ lam0,
    T* __restrict__ u, T* __restrict__ lam_out, T* __restrict__ work,
    const T* __restrict__ sfields, const T* __restrict__ vfields,
    const T* __restrict__ scalars, const int* __restrict__ ev_step,
    const int* __restrict__ ev_idx, const T* __restrict__ ev_w, int ns,
    int nv, int levels, int first_step, int n_steps, int american,
    int n_events, int payoff, int n_react, int knock0, int knock1, T dt,
    T td, T rf, T cm) {
  extern __shared__ unsigned char smem_raw[];
  const int np = ns * nv;
  T* sf = reinterpret_cast<T*>(smem_raw);  // [NSF][ns]
  T* vf = sf + NSF * ns;                   // [NVF][nv]
  T* pf = vf + NVF * nv;                   // [NPF][nv]
  T* flr = pf + NPF * nv;                  // [ns] the American floor
  T* buf0 = flr + ns;                      // [np]
  T* buf1 = buf0 + np;                     // [np]

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m1 = ns - 1;
  const T zero = T(0);
  const T one = T(1);
  const T hdt = T(0.5) * dt;

  T* comp = work + (size_t)COMP * np;
  T* lam = work + (size_t)LAM * np;
  T* fac = work + (size_t)FAC * np;              // [2*levels + 1][np]
  T* binv = fac + (size_t)2 * levels * np;
  T* abc = fac + (size_t)(2 * levels + 1) * np;  // [2][3][np]
  T* luw = abc + (size_t)6 * np;                 // (corrector) L u [+ lam]
  T* z2w = luw + np;                             // (corrector) z2

  for (int k = tid; k < NSF * ns; k += nt) sf[k] = sfields[k];
  for (int k = tid; k < NVF * nv; k += nt) vf[k] = vfields[k];
  const T b1v = scalars[0];
  const T kk = scalars[1];
  const bool digital = payoff == DIGITAL_CALL || payoff == DIGITAL_PUT;
  __syncthreads();
  for (int i = tid; i < ns; i += nt)
    flr[i] = floor_at(sf + VECS * ns, i, ns, kk, payoff, knock0, knock1);

  const T* P_l = sf + PL * ns;
  const T* Q_l = sf + QL * ns;
  const T* P_d = sf + PD * ns;
  const T* Q_d = sf + QD * ns;
  const T* P_u = sf + PU * ns;
  const T* Q_u = sf + QU * ns;
  const T* vfl = vf + VFL * nv;

  // state in; the implicit A1 rows a, b, c of I - td*A1 (bands
  // v_j*P[i] + Q[i]) into the first PCR build buffers
  for (int k = tid; k < np; k += nt) {
    const int j = k / ns;
    const int i = k - j * ns;
    const T v = vfl[j];
    u[k] = u0[k];
    comp[k] = zero;
    lam[k] = lam0[k];
    abc[k] = -td * (v * P_l[i] + Q_l[i]);
    abc[np + k] = one - td * (v * P_d[i] + Q_d[i]);
    abc[2 * np + k] = -td * (v * P_u[i] + Q_u[i]);
  }
  // pentadiagonal factorization of I - td*A2 along v (1-D, one thread)
  if (tid == nt - 1) {
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

  // PCR factors, once a launch: level l eliminates the couplings at
  // stride s = 2^l; off-grid neighbours are identity rows (b = 1, a = c
  // = 0)
  for (int lev = 0; lev < levels; ++lev) {
    const int s = 1 << lev;
    const T* A = abc + (size_t)(lev & 1) * 3 * np;
    const T* B = A + np;
    const T* C = B + np;
    T* An = abc + (size_t)((lev + 1) & 1) * 3 * np;
    T* Bn = An + np;
    T* Cn = Bn + np;
    T* alpha = fac + (size_t)2 * lev * np;
    T* gamma = alpha + np;
    for (int k = tid; k < np; k += nt) {
      const int i = k % ns;
      const bool lo = i - s >= 0;
      const bool hi = i + s < ns;
      const T al = -A[k] / (lo ? B[k - s] : one);
      const T ga = -C[k] / (hi ? B[k + s] : one);
      Bn[k] = (B[k] + al * (lo ? C[k - s] : zero)) + ga * (hi ? A[k + s] : zero);
      An[k] = al * (lo ? A[k - s] : zero);
      Cn[k] = ga * (hi ? C[k + s] : zero);
      alpha[k] = al;
      gamma[k] = ga;
    }
    __syncthreads();
  }
  {
    const T* B = abc + (size_t)(levels & 1) * 3 * np + np;
    for (int k = tid; k < np; k += nt) binv[k] = one / B[k];
  }
  __syncthreads();

  // One stage's two solves on the rhs in the shared buffer `cur` (the
  // other shared buffer `nxt` is free): PCR along s (levels point-parallel
  // passes, ping-pong), the diagonal scaling with the b2 injection kb2b*b2
  // on v row nv-1 when `inject`, then the pentadiagonal solve along v, one
  // thread per s-column. Returns the buffer that holds the solution.
  auto solve = [&](T* cur, T* nxt, bool inject, T kb2b) -> T* {
    for (int lev = 0; lev < levels; ++lev) {
      const int s = 1 << lev;
      const T* alpha = fac + (size_t)2 * lev * np;
      const T* gamma = alpha + np;
      for (int k = tid; k < np; k += nt) {
        const int i = k % ns;
        const T dm = i - s >= 0 ? cur[k - s] : zero;
        const T dp = i + s < ns ? cur[k + s] : zero;
        nxt[k] = (cur[k] + alpha[k] * dm) + gamma[k] * dp;
      }
      __syncthreads();
      T* t = cur;
      cur = nxt;
      nxt = t;
    }
    for (int k = tid; k < np; k += nt) {
      const int j = k / ns;
      const int i = k - j * ns;
      const T z = cur[k] * binv[k];
      nxt[k] = (inject && j == nv - 1 && i >= 1)
                   ? z + kb2b * sf[B2R * ns + i] : z;
    }
    __syncthreads();
    T* z = nxt;
    for (int i = tid; i < ns; i += nt) {
      T dp1 = pf[PM * nv] * z[i];
      z[i] = dp1;
      T dp2 = zero;
      for (int j = 1; j < nv; ++j) {
        const T dpj = pf[PM * nv + j] * z[j * ns + i] -
                      pf[PGM * nv + j] * dp1 - pf[PHM * nv + j] * dp2;
        z[j * ns + i] = dpj;
        dp2 = dp1;
        dp1 = dpj;
      }
      T x1 = z[(nv - 1) * ns + i];
      T x2 = zero;
      for (int j = nv - 2; j >= 0; --j) {
        const T xj = z[j * ns + i] - pf[PC * nv + j] * x1 -
                     pf[PC2 * nv + j] * x2;
        z[j * ns + i] = xj;
        x2 = x1;
        x1 = xj;
      }
    }
    __syncthreads();
    return z;
  };

  const T react_row = Q_d[ns - 1];  // -r_d/2
  int e = 0;
  for (int n = first_step; n <= n_steps; ++n) {
    // ---- dividend events of step n: u and the compensation remapped
    // separately, u's captured rounding joins the remapped compensation
    for (; e < n_events && ev_step[e] == n; ++e) {
      for (int k = tid; k < np; k += nt) {
        buf0[k] = u[k];
        buf1[k] = comp[k];
      }
      __syncthreads();
      const int* idx = ev_idx + (size_t)e * 2 * ns;
      const T* w = ev_w + (size_t)e * 2 * ns;
      for (int k = tid; k < np; k += nt) {
        const int j = k / ns;
        const int i = k - j * ns;
        const T w0 = w[i];
        const T w1 = w[ns + i];
        // source columns, clamped into the grid (in range by construction
        // on the host; the clamp keeps every read in bounds)
        const int c0 = min(max(idx[i], 0), m1);
        const int c1 = min(max(idx[ns + i], 0), m1);
        const T wsum = w0 + w1 > T(0.5) ? one : zero;
        T uv, e2, cv, ce;
        remap_at(buf0, j * ns, i, c0, c1, w0, w1, wsum, uv, e2);
        remap_at(buf1, j * ns, i, c0, c1, w0, w1, wsum, cv, ce);
        u[k] = uv;
        comp[k] = cv + e2;
      }
      __syncthreads();
    }

    const T nf = T(n);
    const T e0 = exp_t<T>(rf * dt * (nf - one));
    const T e1 = exp_t<T>(rf * dt * nf);
    const T kb1 = dt * e0 + td * (e1 - e0);
    const T kb2a = dt * e0;
    const T kb2b = td * (e1 - e0);

    // ---- 1. rhs1 = dt*(L u [+ lam]) + bnd1 (point-parallel) into buf0;
    // a corrector keeps L u [+ lam]
    for (int k = tid; k < np; k += nt) {
      const int j = k / ns;
      const int i = k - j * ns;
      T a0, a1, a2;
      l_parts(u, j, i, ns, nv, sf, vf, react_row, n_react, a0, a1, a2);
      T lu = (a0 + a1) + a2;
      if (american) lu = lu + lam[k];
      if (SCHEME != DO) luw[k] = lu;
      // b1 at the v-major flat indices m1*(q+1), q = 0..nv-1 (the
      // reference's placement quirk; k is that flat index); b2 on v row
      // nv-1, s >= 1
      const T b1t = (k >= m1 && k <= m1 * nv && k % m1 == 0) ? kb1 * b1v
                                                              : zero;
      const T b2t = (j == nv - 1 && i >= 1) ? kb2a * sf[B2R * ns + i] : zero;
      buf0[k] = dt * lu + (b1t + b2t);
    }
    __syncthreads();

    // ---- 2.-4. PCR, the scaling and b2 injection, penta: z2
    T* z = solve(buf0, buf1, true, kb2b);

    if (SCHEME != DO) {
      // ---- C. the corrector's stage-1 rhs (point-parallel) from the
      // kept L u and the stencils of z2, into the other shared buffer;
      // z2 is kept in global scratch
      T* o = z == buf0 ? buf1 : buf0;
      const T kmc = cm * (e1 - e0);
      const T khv = hdt * (e1 - e0);
      for (int k = tid; k < np; k += nt) {
        const int j = k / ns;
        const int i = k - j * ns;
        T a0, a1, a2;
        l_parts(z, j, i, ns, nv, sf, vf, react_row, n_react, a0, a1, a2);
        const T lu = luw[k];
        const bool at_b1 = k >= m1 && k <= m1 * nv && k % m1 == 0;
        const bool at_b2 = j == nv - 1 && i >= 1;
        const T b2r = sf[B2R * ns + i];
        T rhs;
        if (SCHEME == CS) {
          rhs = (dt * lu + hdt * a0) +
                ((at_b1 ? kb1 * b1v : zero) + (at_b2 ? kb2a * b2r : zero));
        } else if (SCHEME == MCS) {
          rhs = dt * lu + td * a0 + cm * ((a0 + a1) + a2);
          rhs = rhs + (at_b1 ? (kb1 + kmc) * b1v : zero);
          rhs = rhs + (at_b2 ? (kb2a + kmc) * b2r : zero);
        } else {
          const T kb = dt * e0 + khv;
          rhs = dt * lu + hdt * ((a0 + a1) + a2) - z[k];
          rhs = rhs + (at_b1 ? kb * b1v : zero);
          rhs = rhs + (at_b2 ? kb * b2r : zero);
        }
        z2w[k] = z[k];
        o[k] = rhs;
      }
      __syncthreads();
      z = solve(o, z, SCHEME != HV, kb2b);
    }

    // ---- 5. compensated update (2Sum), American floor + multiplier (a
    // digital: the projection onto [floor, 1])
    for (int k = tid; k < np; k += nt) {
      const T z2 = SCHEME == HV ? z2w[k] + z[k] : z[k];
      const T x = u[k];
      T q, err;
      if (american && digital) {
        const T floor_ = flr[k % ns];
        two_sum(x, z2 + comp[k], q, err);
        const bool pin = floor_ == one;
        const T qm = q > floor_ ? q : floor_;
        u[k] = pin ? floor_ : (qm < one ? qm : one);
        comp[k] = (q > floor_ && qm < one && !pin) ? err : zero;
      } else if (american) {
        const int i = k % ns;
        const T floor_ = flr[i];
        two_sum(x, (z2 - dt * lam[k]) + comp[k], q, err);
        const T la = ((floor_ - q) - err) / dt;
        u[k] = q > floor_ ? q : floor_;
        comp[k] = q > floor_ ? err : zero;
        lam[k] = (i != m1 && la > zero) ? la : zero;
      } else {
        two_sum(x, z2 + comp[k], q, err);
        u[k] = q;
        comp[k] = err;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < np; k += nt) {
    u[k] = u[k] + comp[k];
    if (american) lam_out[k] = lam[k];
  }
}

template <typename T, int SCHEME>
int launch_scheme(const void* u0, const void* lam0, void* u_out,
                  void* lam_out, void* work, const void* sfields,
                  const void* vfields, const void* scalars,
                  const void* ev_step, const void* ev_idx, const void* ev_w,
                  int ns, int nv, int levels, int first_step, int n_steps,
                  int american, int n_events, int payoff, int n_react,
                  int knock0, int knock1, double dt, double td, double rf,
                  double cm, size_t smem, void* stream) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_single_kernel<T, SCHEME>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_single_kernel<T, SCHEME>
      <<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u0), static_cast<const T*>(lam0),
          static_cast<T*>(u_out), static_cast<T*>(lam_out),
          static_cast<T*>(work), static_cast<const T*>(sfields),
          static_cast<const T*>(vfields), static_cast<const T*>(scalars),
          static_cast<const int*>(ev_step), static_cast<const int*>(ev_idx),
          static_cast<const T*>(ev_w), ns, nv, levels, first_step, n_steps,
          american, n_events, payoff, n_react, knock0, knock1,
          static_cast<T>(dt), static_cast<T>(td), static_cast<T>(rf),
          static_cast<T>(cm));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u0, const void* lam0, void* u_out, void* lam_out,
           void* work, const void* sfields, const void* vfields,
           const void* scalars, const void* ev_step, const void* ev_idx,
           const void* ev_w, int ns, int nv, int levels, int first_step,
           int n_steps, int american, int n_events, int scheme, int payoff,
           int n_react, int knock0, int knock1, double dt, double td,
           double rf, double cm, void* stream) {
  // levels must be ceil(log2 ns): the wrapper sizes the scratch with it
  if (ns < 3 || nv < 3 || levels < 1 || levels > 30 || (1 << levels) < ns ||
      (1 << (levels - 1)) >= ns || first_step < 1 || n_steps < 0 ||
      n_events < 0 || payoff < CALL || payoff > DIGITAL_PUT || n_react < 0 ||
      n_react > nv || knock0 < -1 || knock0 >= ns || knock1 < -1 ||
      knock1 >= ns)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * ((size_t)(NSF + 1) * ns +
                                   (size_t)(NVF + NPF) * nv +
                                   2 * (size_t)ns * nv);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
#define LAUNCH_SCHEME(S)                                                   \
  launch_scheme<T, S>(u0, lam0, u_out, lam_out, work, sfields, vfields,    \
                      scalars, ev_step, ev_idx, ev_w, ns, nv, levels,      \
                      first_step, n_steps, american, n_events, payoff,     \
                      n_react, knock0, knock1, dt, td, rf, cm, smem, stream)
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
}

}  // namespace

#define SINGLE_ARGS                                                       \
  const void *u0, const void *lam0, void *u_out, void *lam_out,          \
      void *work, const void *sfields, const void *vfields,              \
      const void *scalars, const void *ev_step, const void *ev_idx,      \
      const void *ev_w, int ns, int nv, int levels, int first_step,      \
      int n_steps, int american, int n_events, int scheme, int payoff,   \
      int n_react, int knock0, int knock1, double dt, double td,         \
      double rf, double cm, void *stream

extern "C" int fused_single_f32(SINGLE_ARGS) {
  return launch<float>(u0, lam0, u_out, lam_out, work, sfields, vfields,
                       scalars, ev_step, ev_idx, ev_w, ns, nv, levels,
                       first_step, n_steps, american, n_events, scheme,
                       payoff, n_react, knock0, knock1, dt, td, rf, cm,
                       stream);
}

extern "C" int fused_single_f64(SINGLE_ARGS) {
  return launch<double>(u0, lam0, u_out, lam_out, work, sfields, vfields,
                        scalars, ev_step, ev_idx, ev_w, ns, nv, levels,
                        first_step, n_steps, american, n_events, scheme,
                        payoff, n_react, knock0, knock1, dt, td, rf, cm,
                        stream);
}

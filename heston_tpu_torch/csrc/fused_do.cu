// Batched Douglas ADI time loop for the Heston PDE, one launch per book.
//
// Replaces heston_tpu/pallas/fused_do.py::_make_kernel (primal, scheme
// "do", vanilla call, European or American, with or without discrete
// dividends, flat rates). The host side is heston_tpu_torch/kernels/
// fused_do.py, whose fused_do_reference is the plain PyTorch version of
// exactly this arithmetic.
//
// What bounds it on an H100: the latency of the dependent sweeps. Every
// time step runs a Thomas solve along s and a pentadiagonal solve along v,
// each a forward and a backward recurrence, so 2*(ns + nv) rows follow one
// another per step (154 at the 51 x 26 production grid) — neither bytes
// nor FLOPs: one option's working set is a few tens of KB and the
// arithmetic per step is ~50 flops per grid point. The design answers it
// with breadth: one thread block per option, the independent grid lines
// of each sweep spread over the block's threads, and the whole book in one
// launch (500 options are about one wave of blocks on 132 SMs, 4 blocks
// per SM). The working fields live in per-option global scratch that the
// wrapper allocates; keeping them in shared memory is later work.
//
// One launch runs one phase of the host's phase plan: the local steps
// first_step..n_steps at one (theta, dt) — the whole loop, or the Rannacher
// start-up phase (theta = 1, dt/2) and then the main phase. The state
// crosses launches as u (compensation folded in) and the LCP multiplier
// unscaled: the kernel loads dt*lam0 and stores lam/dt.
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
//   2. Thomas solve of (I - theta dt A1) along s, one thread per v-line;
//   3./4. the b2 injection on v-row nv-1, then the pentadiagonal solve of
//      (I - theta dt A2) along v, one thread per s-line;
//   5. point-parallel Fast2Sum update u' = u + z2 with the compensation
//      carry, the American floor and the dt-scaled multiplier.
// Both factorizations run once per launch. Build without fast-math and
// with -fmad=false: the compensation needs IEEE adds, and unfused
// multiply-adds keep the roundings those of the plain version.
//
// Forward-mode variant (TAN = true; entry points fused_do_tangent_*).
// Replaces the same TPU kernel built with n_tangents=K
// (heston_tpu/pallas/fused_do.py:328, tangent phase :961-1102), the
// calibration Jacobian's launch. K tangent surfaces du_k (and the
// American multiplier tangents dlam_k) go through every step beside the
// primal, each implicit solve reusing the primal factors:
// dz1 = T1^-1 (dR1 + td dA1 z1), dz2 = T2^-1 (dz1 + td dA2 z2). The
// tangent phase runs between the primal penta solve and the update, the
// only point where u, z1 (copied in phase 3/4), z2, lam and comp are all
// live; phase 5 then updates the tangents (XLA's maximum-JVP, 0.5 on
// ties, on the same compensated q and lam_arg) and the primal together.
// Dividend remaps move every tangent with the same 2-point weights.
// What bounds it: again the dependent sweeps, now 2*(ns + nv) primal rows
// plus the tangents' per step. The K tangent solves are independent of
// each other, so the design spreads the K*nv Thomas lines and the K*ns
// penta lines over a 256-thread block (104 and 204 at the 51 x 26 grid
// with K = 4): the dependent chain per step about doubles instead of
// growing (1 + K)-fold. The per-option tangent rows sit in shared memory
// beside the primal ones; du_k, dlam_k, the tangent rhs and the z1 copy
// live in per-option global scratch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

// per-option coefficient rows, in the wrapper's packing order
enum SField { PL, QL, PD, QD, PU, QU, SFAC, BSM, BSP, B2R, VECS, NSF };
enum VField { VFL, VFAC, BVM, BVP, AL2, AL1, AD, AU1, AU2, NVF };
// per-option scratch fields [ns * nv]
enum Work { COMP, LAM, DW, TW, TI, NWORK };
// pentadiagonal factors [nv], in shared memory
enum Penta { PM, PGM, PHM, PC, PC2, NPF };
// per-option, per-tangent rows of the forward-mode variant: one s-row
// (the tangent of sfac) and these v-rows, in the wrapper's packing order
enum TVField { TVFL, TVFAC, TBVM, TBVP, TAL2, TAL1, TAU1, TAU2, NTVF };

template <typename T> __device__ __forceinline__ T exp_t(T x);
template <> __device__ __forceinline__ float exp_t<float>(float x) {
  return expf(x);
}
template <> __device__ __forceinline__ double exp_t<double>(double x) {
  return exp(x);
}

// u0, lam0: the state in [B][ns*nv]; u_out, lam_out: the state out
// (lam_out written for American loops only); nst: null, or [B] per-lane
// last local steps.
// TAN = false: the primal loop (tsfields .. twork unused, K = 0).
// TAN = true: also K tangent surfaces; tsfields [B][K][ns], tvfields
// [B][K][NTVF][nv], du_out [B][K][ns*nv] (the tangent state, zero at the
// start), twork [B][2K+1][ns*nv] (tangent rhs, dlam, z1).
template <typename T, bool TAN>
__global__ void fused_do_kernel(
    const T* __restrict__ u0, const T* __restrict__ lam0,
    T* __restrict__ u_out, T* __restrict__ lam_out, T* __restrict__ work,
    const T* __restrict__ sfields, const T* __restrict__ vfields,
    const T* __restrict__ scalars, const int* __restrict__ ev_step,
    const int* __restrict__ ev_idx, const T* __restrict__ ev_w,
    const int* __restrict__ nst, const T* __restrict__ tsfields,
    const T* __restrict__ tvfields,
    T* __restrict__ du_out, T* __restrict__ twork, int ns, int nv,
    int first_step, int n_steps, int american, int n_events, int K, T dt,
    T td, T rf) {
  extern __shared__ unsigned char smem_raw[];
  T* sf = reinterpret_cast<T*>(smem_raw);  // [NSF][ns]
  T* vf = sf + NSF * ns;                   // [NVF][nv]
  T* pf = vf + NVF * nv;                   // [NPF][nv]
  T* tsf = pf + NPF * nv;                  // [K][ns]        (TAN)
  T* tvf = tsf + K * ns;                   // [K][NTVF][nv]  (TAN)

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int np = ns * nv;
  const int m1 = ns - 1;
  const T zero = T(0);
  const T one = T(1);
  // this block's last local step (block-uniform: the barriers below stay
  // reached by every thread)
  const int last = nst ? min(n_steps, nst[b]) : n_steps;

  for (int k = tid; k < NSF * ns; k += nt)
    sf[k] = sfields[(size_t)b * NSF * ns + k];
  for (int k = tid; k < NVF * nv; k += nt)
    vf[k] = vfields[(size_t)b * NVF * nv + k];
  const T b1v = scalars[2 * b];
  const T kk = scalars[2 * b + 1];

  T* u = u_out + (size_t)b * np;
  T* wk = work + (size_t)b * NWORK * np;
  T* comp = wk + COMP * np;
  T* lam = wk + LAM * np;
  T* d = wk + DW * np;
  T* tw = wk + TW * np;
  T* ti = wk + TI * np;
  const T* ub = u0 + (size_t)b * np;
  const T* lb = lam0 + (size_t)b * np;
  for (int k = tid; k < np; k += nt) {
    u[k] = ub[k];
    comp[k] = zero;
    lam[k] = dt * lb[k];  // the dt-scaled carry
  }
  // tangent state and scratch (TAN): du [K][np], tbuf [K][np],
  // dlam [K][np], z1 [np]
  T* du = nullptr;
  T* tbuf = nullptr;
  T* dlam = nullptr;
  T* z1 = nullptr;
  if (TAN) {
    for (int k = tid; k < K * ns; k += nt)
      tsf[k] = tsfields[(size_t)b * K * ns + k];
    for (int k = tid; k < K * NTVF * nv; k += nt)
      tvf[k] = tvfields[(size_t)b * K * NTVF * nv + k];
    du = du_out + (size_t)b * K * np;
    tbuf = twork + (size_t)b * (2 * K + 1) * np;
    dlam = tbuf + (size_t)K * np;
    z1 = dlam + (size_t)K * np;
    for (int k = tid; k < K * np; k += nt) {
      du[k] = zero;
      dlam[k] = zero;
    }
  }
  __syncthreads();

  const T* P_l = sf + PL * ns;
  const T* Q_l = sf + QL * ns;
  const T* P_d = sf + PD * ns;
  const T* Q_d = sf + QD * ns;
  const T* P_u = sf + PU * ns;
  const T* Q_u = sf + QU * ns;
  const T* vfl = vf + VFL * nv;

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
  int e = 0;
  for (int n = first_step; n <= last; ++n) {
    // ---- dividend events of step n: fold comp into u (2Sum value),
    // 2-point difference-form remap, compensation restarts from its
    // captured rounding
    for (; e < n_events && ev_step[e] == n; ++e) {
      for (int k = tid; k < np; k += nt) d[k] = u[k] + comp[k];
      if (TAN)
        for (int k = tid; k < K * np; k += nt) tbuf[k] = du[k];
      __syncthreads();
      const size_t base = ((size_t)b * n_events + e) * 2 * ns;
      const int* idx = ev_idx + base;
      const T* w = ev_w + base;
      for (int k = tid; k < np; k += nt) {
        const int i = k / nv;
        const int j = k - i * nv;
        const T w0 = w[i];
        const T w1 = w[ns + i];
        // source columns, clamped into the grid (in range by
        // construction on the host; the clamp keeps every read in bounds)
        const int c0 = min(max(idx[i], 0), m1);
        const int c1 = min(max(idx[ns + i], 0), m1);
        const T x = d[k];
        const T acc = w0 * (d[c0 * nv + j] - x) + w1 * (d[c1 * nv + j] - x);
        const T a = (w0 + w1 > T(0.5) ? one : zero) * x;
        const T s = a + acc;
        const T bb = s - a;
        u[k] = s;
        comp[k] = (a - (s - bb)) + (acc - bb);
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

    // ---- 1. rhs1 (point-parallel)
    for (int k = tid; k < np; k += nt) {
      const int i = k / nv;
      const int j = k - i * nv;
      const T* row = u + i * nv;
      const T* rlo = i > 0 ? row - nv : nullptr;
      const T* rhi = i < m1 ? row + nv : nullptr;
      const T x = row[j];
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
      const T dlo = (rlo ? rlo[j] : zero) - x;
      const T dhi = (rhi ? rhi[j] : zero) - x;
      const T dsu = bsm * dlo + bsp * dhi;
      const T dv = vf[BVM * nv + j] * (dsu_at(j - 1) - dsu)
                   + vf[BVP * nv + j] * (dsu_at(j + 1) - dsu);
      const T xm2 = j >= 2 ? row[j - 2] : zero;
      const T xm1 = j >= 1 ? row[j - 1] : zero;
      const T xp1 = j + 1 < nv ? row[j + 1] : zero;
      const T xp2 = j + 2 < nv ? row[j + 2] : zero;
      const T react_v = j < nv - 2 ? react_row : zero;
      const T a2r = vf[AL2 * nv + j] * (xm2 - x) + vf[AL1 * nv + j] * (xm1 - x)
                    + vf[AU1 * nv + j] * (xp1 - x)
                    + vf[AU2 * nv + j] * (xp2 - x) + react_v * x;
      const T react_s = i == 0 ? Q_d[0] : react_row;
      const T pterm = P_l[i] * dlo + P_u[i] * dhi;
      const T qterm = Q_l[i] * dlo + Q_u[i] * dhi;
      const T a1 = vfl[j] * pterm + qterm + react_s * x;
      const T c_a0 = sf[SFAC * ns + i] * vf[VFAC * nv + j];
      const T lu = c_a0 * dv + a1 + a2r;
      // b1 sits at the v-major flat indices m1*(q+1), q = 0..nv-1 (the
      // reference's placement quirk); b2 on v-row nv-1, s >= 1
      const int flat = j * ns + i;
      const T b1f = (flat >= m1 && flat <= m1 * nv && flat % m1 == 0)
                        ? b1v : zero;
      const T b2f = (j == nv - 1 && i >= 1) ? sf[B2R * ns + i] : zero;
      T rhs = dt * lu + (kb1 * b1f + kb2a * b2f);
      if (american) rhs = rhs + lam[k];
      d[k] = rhs;
    }
    __syncthreads();

    // ---- 2. Thomas solve along s, one thread per v-line
    for (int j = tid; j < nv; j += nt) {
      const T v = vfl[j];
      T dprev = d[j];
      for (int i = 1; i < ns; ++i) {
        dprev = d[i * nv + j] - tw[i * nv + j] * dprev;
        d[i * nv + j] = dprev;
      }
      T x = d[m1 * nv + j] * ti[m1 * nv + j];
      d[m1 * nv + j] = x;
      for (int i = ns - 2; i >= 0; --i) {
        const T iu = -td * (v * P_u[i] + Q_u[i]);
        x = (d[i * nv + j] - iu * x) * ti[i * nv + j];
        d[i * nv + j] = x;
      }
    }
    __syncthreads();

    // ---- 3./4. b2 injection and pentadiagonal solve along v, one thread
    // per s-line
    for (int i = tid; i < ns; i += nt) {
      T* row = d + i * nv;
      if (TAN)  // the tangent phase reads z1, the Thomas solution
        for (int j = 0; j < nv; ++j) z1[i * nv + j] = row[j];
      row[nv - 1] = row[nv - 1] + kb2b * sf[B2R * ns + i];
      T dp1 = pf[PM * nv] * row[0];
      row[0] = dp1;
      T dp2 = zero;
      for (int j = 1; j < nv; ++j) {
        const T dpj = pf[PM * nv + j] * row[j] - pf[PGM * nv + j] * dp1
                      - pf[PHM * nv + j] * dp2;
        row[j] = dpj;
        dp2 = dp1;
        dp1 = dpj;
      }
      T x1 = row[nv - 1];
      T x2 = zero;
      for (int j = nv - 2; j >= 0; --j) {
        const T xj = row[j] - pf[PC * nv + j] * x1 - pf[PC2 * nv + j] * x2;
        row[j] = xj;
        x2 = x1;
        x1 = xj;
      }
    }
    __syncthreads();

    if (TAN) {
      // ---- T1. tangent rhs (point-parallel over K * np):
      // dt*(dA0 u + A0 du + dA1 u + A1 du + dA2 u + A2 du) [+ dlam]
      // + td*dA1 z1, where dA1 x = dvfl*(P_l dlo + P_u dhi) and the
      // tangent A2 bands are zero-sum (no reaction term)
      for (int q = tid; q < K * np; q += nt) {
        const int kt = q / np;
        const int k = q - kt * np;
        const int i = k / nv;
        const int j = k - i * nv;
        const T* tv = tvf + kt * NTVF * nv;
        const T* y = du + (size_t)kt * np;
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
        // primal u
        const T x = u[k];
        const T dlo = (i > 0 ? u[k - nv] : zero) - x;
        const T dhi = (i < m1 ? u[k + nv] : zero) - x;
        const T dsu = bsm * dlo + bsp * dhi;
        const T dsm = ds_at(u, j - 1);
        const T dsp = ds_at(u, j + 1);
        const T dv = vf[BVM * nv + j] * (dsm - dsu)
                     + vf[BVP * nv + j] * (dsp - dsu);
        const T dvt = tv[TBVM * nv + j] * (dsm - dsu)
                      + tv[TBVP * nv + j] * (dsp - dsu);
        // tangent du_k
        const T yx = y[k];
        const T ydlo = (i > 0 ? y[k - nv] : zero) - yx;
        const T ydhi = (i < m1 ? y[k + nv] : zero) - yx;
        const T ydsu = bsm * ydlo + bsp * ydhi;
        const T ydv = vf[BVM * nv + j] * (ds_at(y, j - 1) - ydsu)
                      + vf[BVP * nv + j] * (ds_at(y, j + 1) - ydsu);
        const T c_a0 = sf[SFAC * ns + i] * vf[VFAC * nv + j];
        const T dca0 = tsf[kt * ns + i] * vf[VFAC * nv + j]
                       + sf[SFAC * ns + i] * tv[TVFAC * nv + j];
        const T a0t = (dca0 * dv + c_a0 * dvt) + c_a0 * ydv;
        const T dvfl = tv[TVFL * nv + j];
        const T mtu = (dvfl * P_l[i]) * dlo + (dvfl * P_u[i]) * dhi;
        const T react_s = i == 0 ? Q_d[0] : react_row;
        const T a1y = vfl[j] * (P_l[i] * ydlo + P_u[i] * ydhi)
                      + (Q_l[i] * ydlo + Q_u[i] * ydhi) + react_s * yx;
        const T* row = u + i * nv;
        const T* yrow = y + i * nv;
        const T xm2 = j >= 2 ? row[j - 2] : zero;
        const T xm1 = j >= 1 ? row[j - 1] : zero;
        const T xp1 = j + 1 < nv ? row[j + 1] : zero;
        const T xp2 = j + 2 < nv ? row[j + 2] : zero;
        const T ym2 = j >= 2 ? yrow[j - 2] : zero;
        const T ym1 = j >= 1 ? yrow[j - 1] : zero;
        const T yp1 = j + 1 < nv ? yrow[j + 1] : zero;
        const T yp2 = j + 2 < nv ? yrow[j + 2] : zero;
        const T react_v = j < nv - 2 ? react_row : zero;
        const T a2tu = tv[TAL2 * nv + j] * (xm2 - x)
                       + tv[TAL1 * nv + j] * (xm1 - x)
                       + tv[TAU1 * nv + j] * (xp1 - x)
                       + tv[TAU2 * nv + j] * (xp2 - x);
        const T a2y = vf[AL2 * nv + j] * (ym2 - yx)
                      + vf[AL1 * nv + j] * (ym1 - yx)
                      + vf[AU1 * nv + j] * (yp1 - yx)
                      + vf[AU2 * nv + j] * (yp2 - yx) + react_v * yx;
        T trhs = dt * (((a0t + mtu) + a1y) + (a2tu + a2y));
        if (american) trhs = trhs + dlam[q];
        const T zx = z1[k];
        const T zdlo = (i > 0 ? z1[k - nv] : zero) - zx;
        const T zdhi = (i < m1 ? z1[k + nv] : zero) - zx;
        const T mtz = (dvfl * P_l[i]) * zdlo + (dvfl * P_u[i]) * zdhi;
        tbuf[q] = trhs + td * mtz;
      }
      __syncthreads();

      // ---- T2. tangent Thomas solves along s: K * nv lines
      for (int l = tid; l < K * nv; l += nt) {
        const int kt = l / nv;
        const int j = l - kt * nv;
        T* dd = tbuf + (size_t)kt * np;
        const T v = vfl[j];
        T dprev = dd[j];
        for (int i = 1; i < ns; ++i) {
          dprev = dd[i * nv + j] - tw[i * nv + j] * dprev;
          dd[i * nv + j] = dprev;
        }
        T x = dd[m1 * nv + j] * ti[m1 * nv + j];
        dd[m1 * nv + j] = x;
        for (int i = ns - 2; i >= 0; --i) {
          const T iu = -td * (v * P_u[i] + Q_u[i]);
          x = (dd[i * nv + j] - iu * x) * ti[i * nv + j];
          dd[i * nv + j] = x;
        }
      }
      __syncthreads();

      // ---- T3. tangent penta solves along v: K * ns lines, on
      // dz1 + td * dA2 z2 (formed row by row as the forward sweep reads)
      for (int l = tid; l < K * ns; l += nt) {
        const int kt = l / ns;
        const int i = l - kt * ns;
        const T* tv = tvf + kt * NTVF * nv;
        T* row = tbuf + (size_t)kt * np + i * nv;
        const T* zr = d + i * nv;  // the primal z2
        auto e_at = [&](int j) -> T {
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
        T dp1 = pf[PM * nv] * e_at(0);
        row[0] = dp1;
        T dp2 = zero;
        for (int j = 1; j < nv; ++j) {
          const T dpj = pf[PM * nv + j] * e_at(j) - pf[PGM * nv + j] * dp1
                        - pf[PHM * nv + j] * dp2;
          row[j] = dpj;
          dp2 = dp1;
          dp1 = dpj;
        }
        T x1 = row[nv - 1];
        T x2 = zero;
        for (int j = nv - 2; j >= 0; --j) {
          const T xj = row[j] - pf[PC * nv + j] * x1 - pf[PC2 * nv + j] * x2;
          row[j] = xj;
          x2 = x1;
          x1 = xj;
        }
      }
      __syncthreads();
    }

    // ---- 5. compensated update (Fast2Sum), American floor + multiplier;
    // the tangents first, from the same compensated q and lam_arg
    for (int k = tid; k < np; k += nt) {
      const T z2 = d[k];
      const T x = u[k];
      if (american) {
        const int i = k / nv;
        const T intrinsic = sf[VECS * ns + i] - kk;
        const T floor_ = intrinsic > zero ? intrinsic : zero;
        const T t = (z2 - lam[k]) + comp[k];
        const T q = x + t;
        const T err = t - (q - x);
        const T la = (floor_ - q) - err;
        if (TAN) {
          for (int kt = 0; kt < K; ++kt) {
            const size_t o = (size_t)kt * np + k;
            const T dub = du[o] + tbuf[o];
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
            du[o] = du[o] + tbuf[o];
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
}

template <typename T, bool TAN>
int launch(const void* u0, const void* lam0, void* u_out, void* lam_out,
           void* work, const void* sfields, const void* vfields,
           const void* scalars, const void* ev_step, const void* ev_idx,
           const void* ev_w, const void* nst, const void* tsfields,
           const void* tvfields, void* du_out, void* twork, int B, int ns,
           int nv, int first_step, int n_steps, int american, int n_events,
           int K, double dt, double td, double rf, void* stream) {
  if (B <= 0 || ns < 3 || nv < 3 || first_step < 1 || n_steps < 0 ||
      n_events < 0 ||
      (TAN ? K < 1 : K != 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * ((size_t)NSF * ns + (size_t)(NVF + NPF) * nv +
                   (size_t)K * ns + (size_t)K * NTVF * nv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_do_kernel<T, TAN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // the tangent variant spreads its K*nv and K*ns sweep lines over twice
  // the threads
  const int threads = TAN ? 256 : 128;
  fused_do_kernel<T, TAN>
      <<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(u0), static_cast<const T*>(lam0),
          static_cast<T*>(u_out), static_cast<T*>(lam_out),
          static_cast<T*>(work), static_cast<const T*>(sfields),
          static_cast<const T*>(vfields), static_cast<const T*>(scalars),
          static_cast<const int*>(ev_step), static_cast<const int*>(ev_idx),
          static_cast<const T*>(ev_w), static_cast<const int*>(nst),
          static_cast<const T*>(tsfields), static_cast<const T*>(tvfields),
          static_cast<T*>(du_out),
          static_cast<T*>(twork), ns, nv, first_step, n_steps, american,
          n_events, K,
          static_cast<T>(dt), static_cast<T>(td), static_cast<T>(rf));
  return (int)cudaGetLastError();
}

}  // namespace

#define PRIMAL_ARGS                                                        \
  const void *u0, const void *lam0, void *u_out, void *lam_out, void *work, \
      const void *sfields, const void *vfields, const void *scalars,       \
      const void *ev_step, const void *ev_idx, const void *ev_w,           \
      const void *nst, int B, int ns, int nv, int first_step, int n_steps, \
      int american, int n_events
#define TANGENT_ARGS                                                       \
  const void *u0, const void *lam0, void *u_out, void *lam_out, void *work, \
      const void *sfields, const void *vfields, const void *scalars,       \
      const void *ev_step, const void *ev_idx, const void *ev_w,           \
      const void *nst, const void *tsfields, const void *tvfields,         \
      void *du_out, void *twork, int B, int ns, int nv, int first_step,    \
      int n_steps, int american, int n_events, int K

extern "C" int fused_do_f32(PRIMAL_ARGS, double dt, double td, double rf,
                            void* stream) {
  return launch<float, false>(u0, lam0, u_out, lam_out, work, sfields,
                              vfields, scalars, ev_step, ev_idx, ev_w, nst,
                              nullptr, nullptr, nullptr, nullptr, B, ns, nv,
                              first_step, n_steps, american, n_events, 0, dt,
                              td, rf, stream);
}

extern "C" int fused_do_f64(PRIMAL_ARGS, double dt, double td, double rf,
                            void* stream) {
  return launch<double, false>(u0, lam0, u_out, lam_out, work, sfields,
                               vfields, scalars, ev_step, ev_idx, ev_w, nst,
                               nullptr, nullptr, nullptr, nullptr, B, ns, nv,
                               first_step, n_steps, american, n_events, 0,
                               dt, td, rf, stream);
}

extern "C" int fused_do_tangent_f32(TANGENT_ARGS, double dt, double td,
                                    double rf, void* stream) {
  return launch<float, true>(u0, lam0, u_out, lam_out, work, sfields,
                             vfields, scalars, ev_step, ev_idx, ev_w, nst,
                             tsfields, tvfields, du_out, twork, B, ns, nv,
                             first_step, n_steps, american, n_events, K, dt,
                             td, rf, stream);
}

extern "C" int fused_do_tangent_f64(TANGENT_ARGS, double dt, double td,
                                    double rf, void* stream) {
  return launch<double, true>(u0, lam0, u_out, lam_out, work, sfields,
                              vfields, scalars, ev_step, ev_idx, ev_w, nst,
                              tsfields, tvfields, du_out, twork, B, ns, nv,
                              first_step, n_steps, american, n_events, K, dt,
                              td, rf, stream);
}

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
// Each step (1-based n; the dividend events of step n are applied first):
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

template <typename T> __device__ __forceinline__ T exp_t(T x);
template <> __device__ __forceinline__ float exp_t<float>(float x) {
  return expf(x);
}
template <> __device__ __forceinline__ double exp_t<double>(double x) {
  return exp(x);
}

template <typename T>
__global__ void fused_do_kernel(
    const T* __restrict__ u0, T* __restrict__ u_out, T* __restrict__ work,
    const T* __restrict__ sfields, const T* __restrict__ vfields,
    const T* __restrict__ scalars, const int* __restrict__ ev_step,
    const int* __restrict__ ev_idx, const T* __restrict__ ev_w, int ns,
    int nv, int n_steps, int american, int n_events, T dt, T td, T rf) {
  extern __shared__ unsigned char smem_raw[];
  T* sf = reinterpret_cast<T*>(smem_raw);  // [NSF][ns]
  T* vf = sf + NSF * ns;                   // [NVF][nv]
  T* pf = vf + NVF * nv;                   // [NPF][nv]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int np = ns * nv;
  const int m1 = ns - 1;
  const T zero = T(0);
  const T one = T(1);

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
  for (int k = tid; k < np; k += nt) {
    u[k] = ub[k];
    comp[k] = zero;
    lam[k] = zero;
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
  // the implicit rows are -td*(v_j*P[i] + Q[i]) (+1 on the diagonal)
  for (int j = tid; j < nv; j += nt) {
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

  const T react_row = Q_d[ns - 1];  // -r_d/2
  int e = 0;
  for (int n = 1; n <= n_steps; ++n) {
    // ---- dividend events of step n: fold comp into u (2Sum value),
    // 2-point difference-form remap, compensation restarts from its
    // captured rounding
    for (; e < n_events && ev_step[e] == n; ++e) {
      for (int k = tid; k < np; k += nt) d[k] = u[k] + comp[k];
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

    // ---- 5. compensated update (Fast2Sum), American floor + multiplier
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
        u[k] = q > floor_ ? q : floor_;
        comp[k] = q > floor_ ? err : zero;
        const T la = (floor_ - q) - err;
        lam[k] = (i != m1 && la > zero) ? la : zero;
      } else {
        const T t = z2 + comp[k];
        const T q = x + t;
        comp[k] = t - (q - x);
        u[k] = q;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < np; k += nt) u[k] = u[k] + comp[k];
}

template <typename T>
int launch(const void* u0, void* u_out, void* work, const void* sfields,
           const void* vfields, const void* scalars, const void* ev_step,
           const void* ev_idx, const void* ev_w, int B, int ns, int nv,
           int n_steps, int american, int n_events, double dt, double td,
           double rf, void* stream) {
  if (B <= 0 || ns < 3 || nv < 3 || n_steps < 0 || n_events < 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(T) * ((size_t)NSF * ns + (size_t)(NVF + NPF) * nv);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_do_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  fused_do_kernel<T><<<B, 128, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u0), static_cast<T*>(u_out),
      static_cast<T*>(work), static_cast<const T*>(sfields),
      static_cast<const T*>(vfields), static_cast<const T*>(scalars),
      static_cast<const int*>(ev_step), static_cast<const int*>(ev_idx),
      static_cast<const T*>(ev_w), ns, nv, n_steps, american, n_events,
      static_cast<T>(dt), static_cast<T>(td), static_cast<T>(rf));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_do_f32(const void* u0, void* u_out, void* work,
                            const void* sfields, const void* vfields,
                            const void* scalars, const void* ev_step,
                            const void* ev_idx, const void* ev_w, int B,
                            int ns, int nv, int n_steps, int american,
                            int n_events, double dt, double td, double rf,
                            void* stream) {
  return launch<float>(u0, u_out, work, sfields, vfields, scalars, ev_step,
                       ev_idx, ev_w, B, ns, nv, n_steps, american, n_events,
                       dt, td, rf, stream);
}

extern "C" int fused_do_f64(const void* u0, void* u_out, void* work,
                            const void* sfields, const void* vfields,
                            const void* scalars, const void* ev_step,
                            const void* ev_idx, const void* ev_w, int B,
                            int ns, int nv, int n_steps, int american,
                            int n_events, double dt, double td, double rf,
                            void* stream) {
  return launch<double>(u0, u_out, work, sfields, vfields, scalars, ev_step,
                        ev_idx, ev_w, B, ns, nv, n_steps, american, n_events,
                        dt, td, rf, stream);
}

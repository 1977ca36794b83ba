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
// What bounds it on an H100: the latency of one option's dependent chain.
// A batch of one has no breadth to spread over the card: the whole time
// loop is a sequence of dependent phases per step, and the card's bytes
// and FLOPs are idle (the 101 x 76 golden grid is 7,676 points, ~60
// operations a point and step). Per step, the tridiagonal solve along s
// runs as parallel cyclic reduction (PCR): ceil(log2 ns) levels, each one
// point-parallel pass, in place of Thomas's 2*ns dependent rows; the
// pentadiagonal solve along v stays the sequential recurrence, one thread
// per s column and 2*nv dependent rows; every other phase is one
// point-parallel pass.
//
// The design keeps the option's whole working set in shared memory by
// spreading it over a thread-block cluster of C blocks on C SMs (Hopper's
// distributed shared memory): block c owns the v rows [c*R, (c+1)*R),
// R = ceil(nv/C) >= 2, and holds for them u, the compensation, the
// multiplier, the two PCR ping-pong buffers, the 2*levels + 1 PCR factors
// (built once a launch) and, for a corrector, L u (and HV's z2), plus its
// own copies of the coefficient rows, the floor row and the penta factor
// columns, computed redundantly with the same arithmetic. At the golden
// grid that is 20 fields of 101 x 76 values, 614 KB in f32 — more than
// one SM's 227 KB. The host's fused_single.launch_plan picks C (the
// largest cluster that holds the most fields: 16 blocks of 5 rows at the
// golden grid, in f32 and f64; 8 where the card cannot schedule 16), the
// block's threads and which fields stay in shared memory (a prefix of the
// Field order below; the rest go to per-block global scratch), from
// sizes, before the launch. Then:
//   * the PCR cascade along s, the scaling, the b2 injection, the update
//     with its floor and multiplier, and the dividend remaps are row-local:
//     __syncthreads only;
//   * the explicit operator reads v neighbours +-2 rows. Each block keeps
//     two halo rows on each side of u, the compensation, the multiplier,
//     the ping-pong buffers and HV's z2, and computes the halo rows' update
//     and remaps itself, with the same arithmetic as their owner (so the
//     same bits); only the penta solution crosses blocks;
//   * the penta sweep along v: the scaling pass writes each value straight
//     into the column buffer of the block that owns its s column (block
//     i / W, W = ceil(ns/C) columns a block); the owner sweeps its columns
//     in its own shared memory, its loads read ahead in chunks; then the
//     block's threads store each result into the row's owner and into the
//     halo rows of its neighbours. These remote stores are asynchronous
//     (st.async) and count their bytes on an mbarrier of the receiving
//     block, which waits for the bytes it expects: no barrier of the whole
//     cluster in the time loop (a cluster barrier's fence at GPU scope cost
//     ~1.5k cycles). So with C > 1 both ping-pong buffers are in shared
//     memory; C = 1 sweeps in place.
// Per step: the dividend remaps of the step, the explicit right-hand side,
// levels PCR passes, the scaling and b2 injection, the penta sweep and the
// compensated update. A corrector scheme (a template parameter; TPU kernel
// :346-397) then builds its stage-1 rhs in one more point-parallel pass,
// from the predictor's L u (+ lam) and the stencils of its increment z2,
// and runs the PCR passes, the scaling (and, but for HV, the b2 injection)
// and the penta sweep again. HV's increment is z2 + w2.
//
// Layout: point k = j*ns + i, v row j, s column i (the TPU kernel's
// [nv, ns]); a block's fields are its rows [R(+halos)][ns]. Arithmetic, in
// the TPU kernel's order:
//   lu = c_a0*dv(ds(u)) + a1mul(u) + a2mul(u), a1mul's bands v_j*P + Q,
//   the correctors' L z2 the same stencils on z2,
//   PCR with identity rows off the grid, the penta recurrence, 2Sum state
//   update; American: lu + lam, then (z2 - dt*lam) + comp, the floor
//   and lam' = max(0, ((floor - q) - err)/dt) with the s_max column masked
//   (lam crosses launches unscaled).
// The b1 boundary term sits at the global flat indices k = m1*(q+1), the
// reference's placement quirk, whatever block holds them.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace cg = cooperative_groups;

// Phase-clock hooks, empty in this build: scripts/torch_book_ab.py
// --phase-clock compiles a copy of this source with them defined (clock64
// per phase, summed over the steps in block 0, printed at its end)
#ifndef PHASE_CLOCK_BEGIN
#define PHASE_CLOCK_BEGIN
#define PHASE_MARK(id)
#define PHASE_CLOCK_END
#endif

namespace {

// coefficient rows, in the wrapper's packing order (the same as
// csrc/fused_do.cu's)
enum SField { PL, QL, PD, QD, PU, QU, SFAC, BSM, BSP, B2R, VECS, NSF };
enum VField { VFL, VFAC, BVM, BVP, AL2, AL1, AD, AU1, AU2, NVF };
// pentadiagonal factors of each v row, in shared memory ([nv][NPF])
enum Penta { PM, PGM, PHM, PC, PC2, NPF };
// The working fields of a block, in the placement order
// (fused_single.fields): the PCR ping-pong buffers, u, the compensation,
// the multiplier, then (a corrector) the predictor's L u and (HV) its
// increment z2, then the PCR factors alpha_l, gamma_l of each level and
// 1/b, from position n_pre on.
enum Field { FB0, FB1, FU, FCOMP, FLAM, FLUW, FZ2W };
// time-loop schemes, in the order of fused_do.SCHEMES
enum Scheme { DO, CS, MCS, HV };
// payoffs, in the order of operators.OPTION_TYPES
enum Payoff { CALL, PUT, DIGITAL_CALL, DIGITAL_PUT };
// phases of the clock hooks
enum PhaseId {
  PH_SETUP, PH_EVENTS, PH_RHS, PH_PCR, PH_SCALE, PH_PENTA, PH_CORR,
  PH_UPDATE, PH_BARRIER, PH_OUT, PH_SCATTER, NPHASE
};

constexpr size_t kMaxSmem = 232448;  // 227 KB: a block's most on an H100
constexpr int kPortableCluster = 8;
constexpr int kMaxCluster = 16;      // with the non-portable attribute
constexpr int kHalo = 2;             // halo rows each side (A2's +-2 rows)
// the two mbarriers at the head of a block's shared memory (C > 1)
constexpr size_t kMbarBytes = 16;

// Threads a block at most: 512, so that a thread may take 128 registers
// (the f64 corrector bodies need ~120; at 1,024 threads the f32 sweeps'
// read-ahead spilled to the stack)
constexpr int kMaxThreads = 512;
// rows a chunk of the penta sweep reads ahead (two chunks in flight): 2;
// 4 ran no faster in f32 and 1.5x slower in f64, 8 spilled
constexpr int kChunk = 2;

// The placement of a launch's values, shared by the kernel and the host
// (fused_single.launch_plan computes the same sizes): C = cluster blocks
// of R rows, halo rows when C > 1; in shared memory the rows (coefficient
// rows, floor row, penta factor columns), the column buffer of the sweep
// (C > 1: W columns of nvp values, nvp = nv | 1 so that a warp's columns
// fall on distinct banks), then the first n_smem fields; the other fields
// in per-block global scratch of gstride values.
struct Layout {
  int ns, nv, levels, cluster, rows, halo, width, nvp, n_pre, n_fields;
  bool hv;
  __host__ __device__ Layout(int ns_, int nv_, int levels_, int scheme,
                             int cluster_)
      : ns(ns_), nv(nv_), levels(levels_), cluster(cluster_),
        rows((nv_ + cluster_ - 1) / cluster_),
        halo(cluster_ > 1 ? kHalo : 0),
        width((ns_ + cluster_ - 1) / cluster_), nvp(nv_ | 1),
        n_pre(5 + (scheme != DO) + (scheme == HV)),
        n_fields(5 + (scheme != DO) + (scheme == HV) + 2 * levels_ + 1),
        hv(scheme == HV) {}
  // fields with halo rows: the buffers, the state and HV's z2
  __host__ __device__ bool has_halo(int p) const {
    return p < 5 || (hv && p == FZ2W);
  }
  // values of the fields at positions [a, b)
  __host__ __device__ long long span(int a, int b) const {
    if (b <= a) return 0;
    const int lo = a > 0 ? a : 0;
    int nh = (b < 5 ? b : 5) - lo;
    if (nh < 0) nh = 0;
    if (hv && a <= FZ2W && FZ2W < b) ++nh;
    return ((long long)(b - a) * rows + (long long)nh * 2 * halo) * ns;
  }
  __host__ __device__ long long row_values() const {
    return (long long)(NSF + 1) * ns + (long long)(NVF + NPF) * nv +
           (cluster > 1 ? (long long)width * nvp : 0);
  }
  __host__ __device__ size_t smem_bytes(int n_smem, size_t itemsize) const {
    return kMbarBytes + itemsize * (size_t)(row_values() + span(0, n_smem));
  }
  __host__ __device__ long long gstride(int n_smem) const {
    return span(n_smem, n_fields);
  }
};

// ---- cluster messaging: a block's stores into another block's shared
// memory (st.async, Hopper's asynchronous remote store) count their bytes
// on an mbarrier of the receiving block, which waits for the bytes of the
// stage it expects instead of for a barrier of the whole cluster
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// an mbarrier of one arrival a phase (the receiving block's own)
__device__ __forceinline__ void mbar_init(unsigned long long* mb) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(mb))
               : "memory");
}

// makes the block's mbarrier inits visible to the cluster (before the
// cluster barrier that precedes every remote store)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the phase's one arrival, expecting `bytes` of remote stores (which may
// land before it)
__device__ __forceinline__ void mbar_expect(unsigned long long* mb,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(mb)),
               "r"(bytes)
               : "memory");
}

// waits for the phase of parity `parity` to complete; a phase that never
// completes fails the launch (trap) instead of hanging the card
__device__ __forceinline__ void mbar_wait(unsigned long long* mb,
                                          unsigned parity) {
  const unsigned a = smem_u32(mb);
  for (long long spin = 0;; ++spin) {
    unsigned done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster."
        "shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin > (1LL << 26)) __trap();
  }
}

// the address of shared address a's place in block `rank` of the cluster
// (a block's window of the cluster's shared memory is linear: the place
// of a + d is the place of a, plus d)
__device__ __forceinline__ unsigned mapa(unsigned a, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(a), "r"(rank));
  return r;
}

// stores v at the cluster address ra, counting its bytes on the mbarrier
// at the cluster address rm (of the same block)
template <typename T>
__device__ __forceinline__ void st_async(unsigned ra, T v, unsigned rm) {
  if (sizeof(T) == 4)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
        "[%2];" ::"r"(ra),
        "r"(__float_as_uint(static_cast<float>(v))), "r"(rm)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
        "[%2];" ::"r"(ra),
        "l"(__double_as_longlong(static_cast<double>(v))), "r"(rm)
        : "memory");
}
// ---- end of cluster messaging

// stores v at dst's place in the shared memory of block `rank` (dst: the
// same place in this block), counting its bytes on that block's mbarrier
// at mb's place
template <typename T>
__device__ __forceinline__ void st_remote(T* dst, unsigned rank, T v,
                                          unsigned long long* mb) {
  st_async(mapa(smem_u32(dst), rank), v, mapa(smem_u32(mb), rank));
}

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

// The explicit operator's three parts at point (v row j, s column i),
// xr the field's row j (rows j-2..j+2 at +-ns apart: a block's own rows
// and halo rows), in the TPU kernel's order: a0 = c_a0*dv(ds(x)),
// a1 = a1mul(x), a2 = a2mul(x); L x = (a0 + a1) + a2.
template <typename T>
__device__ __forceinline__ void l_parts(const T* xr, int j, int i, int ns,
                                        int nv, const T* sf, const T* vf,
                                        T react_row, int n_react, T& a0,
                                        T& a1, T& a2) {
  const T zero = T(0);
  const int m1 = ns - 1;
  const T xv = xr[i];
  const T bsm = sf[BSM * ns + i];
  const T bsp = sf[BSP * ns + i];
  // beta_s stencil of x at (v row j + dj, s column i), zero off the grid
  auto ds_at = [&](int dj) -> T {
    const int jj = j + dj;
    if (jj < 0 || jj >= nv) return zero;
    const T* r = xr + dj * ns;
    const T c = r[i];
    return bsm * ((i > 0 ? r[i - 1] : zero) - c) +
           bsp * ((i < m1 ? r[i + 1] : zero) - c);
  };
  const T dsu = ds_at(0);
  const T dv = vf[BVM * nv + j] * (ds_at(-1) - dsu) +
               vf[BVP * nv + j] * (ds_at(1) - dsu);
  const T v = vf[VFL * nv + j];
  const T dlo = (i > 0 ? xr[i - 1] : zero) - xv;
  const T dhi = (i < m1 ? xr[i + 1] : zero) - xv;
  const T react_s = i == 0 ? sf[QD * ns] : react_row;
  a1 = ((v * sf[PL * ns + i] + sf[QL * ns + i]) * dlo +
        (v * sf[PU * ns + i] + sf[QU * ns + i]) * dhi) +
       react_s * xv;
  const T xm2 = j >= 2 ? xr[i - 2 * ns] : zero;
  const T xm1 = j >= 1 ? xr[i - ns] : zero;
  const T xp1 = j + 1 < nv ? xr[i + ns] : zero;
  const T xp2 = j + 2 < nv ? xr[i + 2 * ns] : zero;
  const T react_v = j < n_react ? react_row : zero;
  a2 = (((vf[AL2 * nv + j] * (xm2 - xv) + vf[AL1 * nv + j] * (xm1 - xv)) +
         vf[AU1 * nv + j] * (xp1 - xv)) +
        vf[AU2 * nv + j] * (xp2 - xv)) +
       react_v * xv;
  a0 = (sf[SFAC * ns + i] * vf[VFAC * nv + j]) * dv;
}

// One chunk of the penta sweep: CH rows' values and factors, loaded
// before the recurrence over them runs
template <typename T, int CH>
struct Chunk {
  T z[CH], f0[CH], f1[CH], f2[CH];
};

// the forward elimination's loads of rows j0 .. j0+CH-1 (those < nv; with
// GUARD false all of them exist)
template <bool GUARD, typename T, int CH>
__device__ __forceinline__ void load_fwd(Chunk<T, CH>& ch, const T* col,
                                         int rs, int nv, const T* pf,
                                         int j0) {
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int j = j0 + q;
    if (!GUARD || j < nv) {
      const T* f = pf + j * NPF;
      ch.z[q] = col[j * rs];
      ch.f0[q] = f[PM];
      ch.f1[q] = f[PGM];
      ch.f2[q] = f[PHM];
    }
  }
}

template <bool GUARD, typename T, int CH>
__device__ __forceinline__ void run_fwd(const Chunk<T, CH>& ch, T* col,
                                        int rs, int nv, int j0, T& dp1,
                                        T& dp2) {
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int j = j0 + q;
    if (!GUARD || j < nv) {
      const T dpj = ch.f0[q] * ch.z[q] - ch.f1[q] * dp1 - ch.f2[q] * dp2;
      col[j * rs] = dpj;
      dp2 = dp1;
      dp1 = dpj;
    }
  }
}

// the back substitution's loads of rows j0, j0-1, .. j0-CH+1 (those >= 0)
template <bool GUARD, typename T, int CH>
__device__ __forceinline__ void load_bwd(Chunk<T, CH>& ch, const T* col,
                                         int rs, const T* pf, int j0) {
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int j = j0 - q;
    if (!GUARD || j >= 0) {
      const T* f = pf + j * NPF;
      ch.z[q] = col[j * rs];
      ch.f0[q] = f[PC];
      ch.f1[q] = f[PC2];
    }
  }
}

template <bool GUARD, typename T, int CH>
__device__ __forceinline__ void run_bwd(const Chunk<T, CH>& ch, T* col,
                                        int rs, int j0, T& x1, T& x2) {
#pragma unroll
  for (int q = 0; q < CH; ++q) {
    const int j = j0 - q;
    if (!GUARD || j >= 0) {
      const T xj = ch.z[q] - ch.f0[q] * x1 - ch.f1[q] * x2;
      col[j * rs] = xj;
      x2 = x1;
      x1 = xj;
    }
  }
}

// The pentadiagonal solve along v of one s column in place: col[j*rs],
// j = 0..nv-1, the forward elimination, then the back substitution; pf
// holds each row's factors together ([nv][NPF]). The rows go in chunks of
// CH, two chunks in flight: a chunk's loads are issued before the
// recurrence over the chunk before it, so their latency overlaps it (the
// next chunk's rows are not yet written). The main loop runs while three
// chunks lie inside the column, unguarded (no predicated rows, so the
// recurrence's operands stay in place); the last rows take the guarded
// loop.
template <typename T, int CH>
__device__ __forceinline__ void penta_column(T* col, int rs, int nv,
                                             const T* pf) {
  const T zero = T(0);
  T dp1 = pf[PM] * col[0];
  col[0] = dp1;
  T dp2 = zero;
  Chunk<T, CH> a, b;
  int j0 = 1;
  load_fwd<true>(a, col, rs, nv, pf, j0);
  for (; j0 + 3 * CH <= nv; j0 += 2 * CH) {
    load_fwd<false>(b, col, rs, nv, pf, j0 + CH);
    run_fwd<false>(a, col, rs, nv, j0, dp1, dp2);
    load_fwd<false>(a, col, rs, nv, pf, j0 + 2 * CH);
    run_fwd<false>(b, col, rs, nv, j0 + CH, dp1, dp2);
  }
  for (; j0 < nv; j0 += 2 * CH) {
    load_fwd<true>(b, col, rs, nv, pf, j0 + CH);
    run_fwd<true>(a, col, rs, nv, j0, dp1, dp2);
    load_fwd<true>(a, col, rs, nv, pf, j0 + 2 * CH);
    run_fwd<true>(b, col, rs, nv, j0 + CH, dp1, dp2);
  }
  T x1 = dp1;
  T x2 = zero;
  j0 = nv - 2;
  load_bwd<true>(a, col, rs, pf, j0);
  for (; j0 - 3 * CH + 1 >= 0; j0 -= 2 * CH) {
    load_bwd<false>(b, col, rs, pf, j0 - CH);
    run_bwd<false>(a, col, rs, j0, x1, x2);
    load_bwd<false>(a, col, rs, pf, j0 - 2 * CH);
    run_bwd<false>(b, col, rs, j0 - CH, x1, x2);
  }
  for (; j0 >= 0; j0 -= 2 * CH) {
    load_bwd<true>(b, col, rs, pf, j0 - CH);
    run_bwd<true>(a, col, rs, j0, x1, x2);
    load_bwd<true>(a, col, rs, pf, j0 - 2 * CH);
    run_bwd<true>(b, col, rs, j0 - CH, x1, x2);
  }
}

// the PCR factor field q (2*l: alpha_l, 2*l + 1: gamma_l, 2*levels: 1/b)
// of a block: the first nfs in shared memory from fac_s on, the rest in
// global scratch from fac_g on, rs values each (SMEM: all in shared memory)
template <bool SMEM, typename T>
__device__ __forceinline__ T* fac_at(T* fac_s, T* fac_g, int nfs,
                                     long long rs, int q) {
  return (SMEM || q < nfs) ? fac_s + q * rs : fac_g + (q - nfs) * rs;
}

// The points k = tid, tid + nt, ... of a [rows][w] block of values, with
// their row and column, stepped without a division (the thread's first
// point and the step computed once a launch)
struct Walk {
  int k, j, c;
  __device__ __forceinline__ Walk(int tid, int j0, int c0)
      : k(tid), j(j0), c(c0) {}
  __device__ __forceinline__ void next(int nt, int dj, int dc, int w) {
    k += nt;
    j += dj;
    c += dc;
    if (c >= w) {
      c -= w;
      ++j;
    }
  }
};

// Where a block's working fields are: field p's row 0 (its halo rows
// before it) in this block's shared memory or global scratch. SMEM: every
// field is in shared memory, and every field pointer derives from the
// shared array, so the compiler addresses them as shared memory (LDS/STS
// on 32-bit offsets) instead of generically (LD/ST on 64-bit addresses)
template <typename T, bool SMEM>
struct Fields {
  Layout lay;
  T* fbase;        // the shared fields
  T* gbase;        // this block's global scratch
  long long gstride;
  int n_smem;
  __device__ __forceinline__ T* at(int p) const {
    const long long lead =
        lay.has_halo(p) ? (long long)lay.halo * lay.ns : 0;
    return (SMEM || p < n_smem) ? fbase + lay.span(0, p) + lead
                                : gbase + lay.span(n_smem, p) + lead;
  }
};

// cm: (1/2 - theta)*dt, MCS's weight of L z2; payoff, n_react, knock0,
// knock1: the payoff (Payoff), the reaction rows, the knocked s columns
// (-1: none); n_smem: the fields (in Field order, then the factors) in
// shared memory (SMEM: all of them); scratch: the other fields, gstride
// values a block. The grid is one cluster of gridDim.x blocks.
template <typename T, int SCHEME, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads, 1) fused_single_kernel(
    const T* __restrict__ u0, const T* __restrict__ lam0,
    T* __restrict__ u_out, T* __restrict__ lam_out, T* __restrict__ scratch,
    const T* __restrict__ sfields, const T* __restrict__ vfields,
    const T* __restrict__ scalars, const int* __restrict__ ev_step,
    const int* __restrict__ ev_idx, const T* __restrict__ ev_w, int ns,
    int nv, int levels, int first_step, int n_steps, int american,
    int n_events, int payoff, int n_react, int knock0, int knock1,
    int n_smem, T dt, T td, T rf, T cm) {
  extern __shared__ unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ncl = (int)gridDim.x;
  const int rank = (int)cluster.block_rank();
  const Layout lay(ns, nv, levels, SCHEME, ncl);
  // the mbarriers of the column buffer and of the rows' solution (C > 1)
  unsigned long long* mbar_col =
      reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned long long* mbar_row = mbar_col + 1;
  T* sf = reinterpret_cast<T*>(smem_raw + kMbarBytes);  // [NSF][ns]
  T* vf = sf + NSF * ns;                   // [NVF][nv]
  T* pf = vf + NVF * nv;                   // [nv][NPF]
  T* flr = pf + NPF * nv;                  // [ns] the American floor
  T* colbuf = flr + ns;                    // [W][nvp] (C > 1)
  const long long gstride = lay.gstride(n_smem);
  const Fields<T, SMEM> fs{lay, sf + lay.row_values(),
                     scratch + (long long)rank * gstride, gstride, n_smem};

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int m1 = ns - 1;
  const T zero = T(0);
  const T one = T(1);
  const T hdt = T(0.5) * dt;
  const int R = lay.rows;
  const int W = lay.width;
  const int nvp = lay.nvp;
  const int n_pre = lay.n_pre;
  const int r0 = rank * R;
  const int own = max(0, min(R, nv - r0));  // rows this block owns
  const int npl = own * ns;                 // ... and their points
  // the rows a block updates: its own and the halo rows on the grid
  const int jlo = own ? max(-lay.halo, -r0) : 0;
  const int jhi = own ? min(own + lay.halo, nv - r0) : 0;
  const int next = (jhi - jlo) * ns;
  // the point walk over [rows][ns]: the thread's first point, the step
  const int tj = tid / ns, ti = tid - tj * ns;
  const int dj = nt / ns, di = nt - dj * ns;
  // the sweep's columns: rank*W .. rank*W + wb - 1
  const int wb = max(0, min(W, ns - rank * W));
  PHASE_CLOCK_BEGIN

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

  // the PCR build's two sets of rows a, b, c (own rows): set 0 in the
  // ping-pong buffers and u, set 1 in the compensation, 1/b and the
  // multiplier, which the build leaves free until the state comes in
  const long long rsz = (long long)R * ns;  // values of a factor field
  const int nfs = max(0, min(n_smem - n_pre, 2 * levels + 1));
  T* const fac_s = fs.at(n_pre);
  T* const fac_g = fs.at(n_pre + nfs);
  T* const a0s = fs.at(FB0);
  T* const b0s = fs.at(FB1);
  T* const c0s = fs.at(FU);
  T* const a1s = fs.at(FCOMP);
  T* const b1s = fac_at<SMEM>(fac_s, fac_g, nfs, rsz, 2 * levels);
  T* const c1s = fs.at(FLAM);
  // the implicit A1 rows a, b, c of I - td*A1 (bands v_j*P[i] + Q[i])
  for (Walk w(tid, tj, ti); w.k < npl; w.next(nt, dj, di, ns)) {
    const int i = w.c;
    const T v = vfl[r0 + w.j];
    a0s[w.k] = -td * (v * P_l[i] + Q_l[i]);
    b0s[w.k] = one - td * (v * P_d[i] + Q_d[i]);
    c0s[w.k] = -td * (v * P_u[i] + Q_u[i]);
  }
  // pentadiagonal factorization of I - td*A2 along v (1-D, one thread of
  // every block)
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
      T* f = pf + j * NPF;
      f[PC] = c;
      f[PC2] = c2;
      f[PGM] = big_l * m;
      f[PHM] = il2 * m;
      f[PM] = m;
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
    const bool odd = lev & 1;
    const T* A = odd ? a1s : a0s;
    const T* B = odd ? b1s : b0s;
    const T* C = odd ? c1s : c0s;
    T* An = odd ? a0s : a1s;
    T* Bn = odd ? b0s : b1s;
    T* Cn = odd ? c0s : c1s;
    T* alpha = fac_at<SMEM>(fac_s, fac_g, nfs, rsz, 2 * lev);
    T* gamma = fac_at<SMEM>(fac_s, fac_g, nfs, rsz, 2 * lev + 1);
    for (Walk w(tid, tj, ti); w.k < npl; w.next(nt, dj, di, ns)) {
      const int kl = w.k;
      const bool lo = w.c - s >= 0;
      const bool hi = w.c + s < ns;
      const T al = -A[kl] / (lo ? B[kl - s] : one);
      const T ga = -C[kl] / (hi ? B[kl + s] : one);
      Bn[kl] = (B[kl] + al * (lo ? C[kl - s] : zero)) +
               ga * (hi ? A[kl + s] : zero);
      An[kl] = al * (lo ? A[kl - s] : zero);
      Cn[kl] = ga * (hi ? C[kl + s] : zero);
      alpha[kl] = al;
      gamma[kl] = ga;
    }
    __syncthreads();
  }
  T* const binv = b1s;
  {
    const T* B = (levels & 1) ? b1s : b0s;
    for (int kl = tid; kl < npl; kl += nt) binv[kl] = one / B[kl];
  }
  __syncthreads();

  // state in, the halo rows too
  T* const u = c0s;
  T* const comp = a1s;
  T* const lam = c1s;
  for (int kx = tid; kx < next; kx += nt) {
    const int x = jlo * ns + kx;  // the local flat index (rows from jlo)
    const long long k = (long long)r0 * ns + x;
    u[x] = u0[k];
    comp[x] = zero;
    lam[x] = lam0[k];
  }
  // every block of the cluster runs, its mbarriers ready, before any
  // block writes another's shared memory
  if (ncl > 1 && tid == 0) {
    mbar_init(mbar_col);
    mbar_init(mbar_row);
    mbar_init_fence();
  }
  if (ncl > 1)
    cluster.sync();
  else
    __syncthreads();
  PHASE_MARK(PH_SETUP);

  constexpr int kStages = SCHEME == DO ? 1 : 2;
  T* const luw = SCHEME != DO ? fs.at(FLUW) : nullptr;
  T* const z2w = SCHEME == HV ? fs.at(FZ2W) : nullptr;
  T* const buf0 = a0s;
  T* const buf1 = b0s;
  const T react_row = Q_d[ns - 1];  // -r_d/2
  int e = 0;
  unsigned parity = 0;  // of the stage's mbarrier phases
  for (int n = first_step; n <= n_steps; ++n) {
    // ---- dividend events of step n: u and the compensation remapped
    // separately, u's captured rounding joins the remapped compensation
    // (own and halo rows: a row-local gather)
    for (; e < n_events && ev_step[e] == n; ++e) {
      for (int kx = tid; kx < next; kx += nt) {
        const int x = jlo * ns + kx;
        buf0[x] = u[x];
        buf1[x] = comp[x];
      }
      __syncthreads();
      const int* idx = ev_idx + (size_t)e * 2 * ns;
      const T* w = ev_w + (size_t)e * 2 * ns;
      for (Walk p(tid, jlo + tj, ti); p.k < next; p.next(nt, dj, di, ns)) {
        const int i = p.c;
        const int row = p.j * ns;
        const T w0 = w[i];
        const T w1 = w[ns + i];
        // source columns, clamped into the grid (in range by construction
        // on the host; the clamp keeps every read in bounds)
        const int c0 = min(max(idx[i], 0), m1);
        const int c1 = min(max(idx[ns + i], 0), m1);
        const T wsum = w0 + w1 > T(0.5) ? one : zero;
        T uv, e2, cv, ce;
        remap_at(buf0, row, i, c0, c1, w0, w1, wsum, uv, e2);
        remap_at(buf1, row, i, c0, c1, w0, w1, wsum, cv, ce);
        u[row + i] = uv;
        comp[row + i] = cv + e2;
      }
      __syncthreads();
    }
    PHASE_MARK(PH_EVENTS);

    const T nf = T(n);
    const T e0 = exp_t<T>(rf * dt * (nf - one));
    const T e1 = exp_t<T>(rf * dt * nf);
    const T kb1 = dt * e0 + td * (e1 - e0);
    const T kb2a = dt * e0;
    const T kb2b = td * (e1 - e0);

    // the stages: the predictor, then (a corrector scheme) the corrector;
    // each builds its rhs in the buffer at pc and leaves its solution
    // (own and halo rows) in the buffer pz
    int pz = FB1;
    for (int stage = 0; stage < kStages; ++stage) {
      int pc, pn;
      bool inject;
      if (stage == 0) {
        // ---- 1. rhs1 = dt*(L u [+ lam]) + bnd1 (own rows) into buf0;
        // a corrector keeps L u [+ lam]
        for (Walk p(tid, tj, ti); p.k < npl; p.next(nt, dj, di, ns)) {
          const int kl = p.k;
          const int i = p.c;
          const int j = r0 + p.j;
          const int k = j * ns + i;
          T a0, a1, a2;
          l_parts(u + p.j * ns, j, i, ns, nv, sf, vf, react_row, n_react,
                  a0, a1, a2);
          T lu = (a0 + a1) + a2;
          if (american) lu = lu + lam[kl];
          if (SCHEME != DO) luw[kl] = lu;
          // b1 at the v-major flat indices m1*(q+1), q = 0..nv-1 (the
          // reference's placement quirk; k is that flat index); b2 on v
          // row nv-1, s >= 1
          const T b1t = (k >= m1 && k <= m1 * nv && k % m1 == 0)
                            ? kb1 * b1v : zero;
          const T b2t = (j == nv - 1 && i >= 1) ? kb2a * sf[B2R * ns + i]
                                                : zero;
          buf0[kl] = dt * lu + (b1t + b2t);
        }
        pc = FB0;
        pn = FB1;
        inject = true;
        __syncthreads();
        PHASE_MARK(PH_RHS);
      } else {
        // ---- C. the corrector's stage-1 rhs (own rows) from the kept
        // L u and the stencils of z2, into the other buffer; HV keeps z2
        // (own and halo rows)
        const int po = pz == FB0 ? FB1 : FB0;
        const T* z = pz == FB0 ? buf0 : buf1;
        T* o = po == FB0 ? buf0 : buf1;
        const T kmc = cm * (e1 - e0);
        const T khv = hdt * (e1 - e0);
        for (Walk p(tid, tj, ti); p.k < npl; p.next(nt, dj, di, ns)) {
          const int kl = p.k;
          const int i = p.c;
          const int j = r0 + p.j;
          const int k = j * ns + i;
          T a0, a1, a2;
          l_parts(z + p.j * ns, j, i, ns, nv, sf, vf, react_row, n_react,
                  a0, a1, a2);
          const T lu = luw[kl];
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
            rhs = dt * lu + hdt * ((a0 + a1) + a2) - z[kl];
            rhs = rhs + (at_b1 ? kb * b1v : zero);
            rhs = rhs + (at_b2 ? kb * b2r : zero);
          }
          o[kl] = rhs;
        }
        if (SCHEME == HV)
          for (int kx = tid; kx < next; kx += nt) {
            const int x = jlo * ns + kx;
            z2w[x] = z[x];
          }
        pc = po;
        pn = pz;
        inject = SCHEME != HV;
        __syncthreads();
        PHASE_MARK(PH_CORR);
      }

      // ---- 2. PCR along s (levels row-local passes, ping-pong)
      for (int lev = 0; lev < levels; ++lev) {
        const int s = 1 << lev;
        const T* alpha = fac_at<SMEM>(fac_s, fac_g, nfs, rsz, 2 * lev);
        const T* gamma = fac_at<SMEM>(fac_s, fac_g, nfs, rsz, 2 * lev + 1);
        const T* cur = pc == FB0 ? buf0 : buf1;
        T* nxt = pn == FB0 ? buf0 : buf1;
        for (Walk p(tid, tj, ti); p.k < npl; p.next(nt, dj, di, ns)) {
          const int kl = p.k;
          const T dm = p.c - s >= 0 ? cur[kl - s] : zero;
          const T dp = p.c + s < ns ? cur[kl + s] : zero;
          nxt[kl] = (cur[kl] + alpha[kl] * dm) + gamma[kl] * dp;
        }
        __syncthreads();
        const int t = pc;
        pc = pn;
        pn = t;
      }
      PHASE_MARK(PH_PCR);

      // ---- 3.-4. the diagonal scaling with the b2 injection kb2b*b2 on
      // v row nv-1, then the pentadiagonal solve along v into pn
      const T* cur = pc == FB0 ? buf0 : buf1;
      T* nxt = pn == FB0 ? buf0 : buf1;
      if (ncl == 1) {
        for (Walk p(tid, tj, ti); p.k < npl; p.next(nt, dj, di, ns)) {
          const int kl = p.k;
          const int i = p.c;
          const T z = cur[kl] * binv[kl];
          nxt[kl] = (inject && p.j == nv - 1 && i >= 1)
                        ? z + kb2b * sf[B2R * ns + i] : z;
        }
        __syncthreads();
        PHASE_MARK(PH_SCALE);
        for (int i = tid; i < ns; i += nt)
          penta_column<T, kChunk>(nxt + i, ns, nv, pf);
        __syncthreads();
        PHASE_MARK(PH_PENTA);
      } else {
        // the scaled rhs straight into the column buffer of its column's
        // owner, block i / W, counted on the owner's mbarrier
        if (tid == 0 && wb > 0)
          mbar_expect(mbar_col, (unsigned)(wb * nv * sizeof(T)));
        for (Walk p(tid, tj, ti); p.k < npl; p.next(nt, dj, di, ns)) {
          const int kl = p.k;
          const int i = p.c;
          const int j = r0 + p.j;
          const T z = cur[kl] * binv[kl];
          const int owner = i / W;
          st_remote(colbuf + (i - owner * W) * nvp + j, (unsigned)owner,
                    (inject && j == nv - 1 && i >= 1)
                        ? z + kb2b * sf[B2R * ns + i] : z,
                    mbar_col);
        }
        PHASE_MARK(PH_SCALE);
        if (tid < wb) mbar_wait(mbar_col, parity);
        PHASE_MARK(PH_BARRIER);
        // the block's columns, each swept in place
        for (int c = tid; c < wb; c += nt)
          penta_column<T, kChunk>(colbuf + c * nvp, 1, nv, pf);
        __syncthreads();
        PHASE_MARK(PH_PENTA);
        // each row's solution to its owner's buffer pn and to the halo
        // rows of the owner's neighbours (remote stores: they do not wait;
        // a remote load here, pulling the rows instead, waits its latency)
        if (tid == 0 && own > 0)
          mbar_expect(mbar_row, (unsigned)(next * sizeof(T)));
        if (wb > 0) {
          const int sj = nt / wb, sc = nt - sj * wb;
          Walk p(tid, tid / wb, tid % wb);
          int b = p.j / R;
          for (; p.k < wb * nv; p.next(nt, sj, sc, wb)) {
            while (p.j - b * R >= R) ++b;
            const int jl = p.j - b * R;
            const int i = rank * W + p.c;
            const T x = colbuf[p.c * nvp + p.j];
            st_remote(nxt + jl * ns + i, (unsigned)b, x, mbar_row);
            if (jl < kHalo && b > 0)
              st_remote(nxt + (R + jl) * ns + i, (unsigned)(b - 1), x,
                        mbar_row);
            if (jl >= R - kHalo && b + 1 < ncl && (b + 1) * R < nv)
              st_remote(nxt + (jl - R) * ns + i, (unsigned)(b + 1), x,
                        mbar_row);
          }
        }
        PHASE_MARK(PH_SCATTER);
        if (own > 0) mbar_wait(mbar_row, parity);
        PHASE_MARK(PH_BARRIER);
        parity ^= 1;
      }
      pz = pn;
    }

    // ---- 5. compensated update (2Sum), American floor + multiplier (a
    // digital: the projection onto [floor, 1]); own and halo rows
    const T* z = pz == FB0 ? buf0 : buf1;
    for (Walk p(tid, tj, ti); p.k < next; p.next(nt, dj, di, ns)) {
      const int x = jlo * ns + p.k;
      const int i = p.c;
      const T z2 = SCHEME == HV ? z2w[x] + z[x] : z[x];
      const T xu = u[x];
      T q, err;
      if (american && digital) {
        const T floor_ = flr[i];
        two_sum(xu, z2 + comp[x], q, err);
        const bool pin = floor_ == one;
        const T qm = q > floor_ ? q : floor_;
        u[x] = pin ? floor_ : (qm < one ? qm : one);
        comp[x] = (q > floor_ && qm < one && !pin) ? err : zero;
      } else if (american) {
        const T floor_ = flr[i];
        two_sum(xu, (z2 - dt * lam[x]) + comp[x], q, err);
        const T la = ((floor_ - q) - err) / dt;
        u[x] = q > floor_ ? q : floor_;
        comp[x] = q > floor_ ? err : zero;
        lam[x] = (i != m1 && la > zero) ? la : zero;
      } else {
        two_sum(xu, z2 + comp[x], q, err);
        u[x] = q;
        comp[x] = err;
      }
    }
    __syncthreads();
    PHASE_MARK(PH_UPDATE);
  }

  // a block leaves once every block has its last stage's rows: nothing
  // is stored into its shared memory after it has left
  if (ncl > 1) cluster.sync();
  for (int kl = tid; kl < npl; kl += nt) {
    const long long k = (long long)r0 * ns + kl;
    u_out[k] = u[kl] + comp[kl];
    if (american) lam_out[k] = lam[kl];
  }
  PHASE_MARK(PH_OUT);
  PHASE_CLOCK_END
}

// the launch's checks: 0, or the CUDA error the wrapper raises
int check_args(int ns, int nv, int levels, int first_step, int n_steps,
               int n_events, int scheme, int payoff, int n_react, int knock0,
               int knock1) {
  // levels must be ceil(log2 ns): the wrapper sizes the fields with it
  if (ns < 3 || nv < 3 || levels < 1 || levels > 30 || (1 << levels) < ns ||
      (1 << (levels - 1)) >= ns || first_step < 1 || n_steps < 0 ||
      n_events < 0 || scheme < DO || scheme > HV || payoff < CALL ||
      payoff > DIGITAL_PUT || n_react < 0 || n_react > nv || knock0 < -1 ||
      knock0 >= ns || knock1 < -1 || knock1 >= ns)
    return (int)cudaErrorInvalidValue;
  return 0;
}

// the plan's checks (fused_single.launch_plan): the cluster's size and
// rows (a cluster keeps both ping-pong buffers in shared memory), the
// threads, the fields in shared memory and the block's bytes; sets *smem
template <typename T>
int check_plan(const Layout& lay, int threads, int n_smem, size_t* smem) {
  if (lay.cluster < 1 || lay.cluster > kMaxCluster ||
      (lay.cluster > 1 && (lay.rows < 2 || n_smem <= FB1)) || threads < 32 ||
      threads > kMaxThreads || threads % 32 || n_smem < 0 ||
      n_smem > lay.n_fields)
    return (int)cudaErrorInvalidValue;
  *smem = lay.smem_bytes(n_smem, sizeof(T));
  if (*smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  return 0;
}

// the instantiation of a plan: SMEM where every field is in shared memory
template <typename T, int SCHEME>
decltype(&fused_single_kernel<T, SCHEME, false>) kernel_of(
    const Layout& lay, int n_smem) {
  return n_smem == lay.n_fields ? fused_single_kernel<T, SCHEME, true>
                                : fused_single_kernel<T, SCHEME, false>;
}

// the kernel's attributes for a launch of `smem` bytes in a cluster of
// `cluster` blocks (past 8 only with the non-portable attribute)
template <typename K>
int set_attributes(K kern, int cluster, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > kPortableCluster)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return (int)err;
}

// a launch configuration of one cluster of `cluster` blocks; `attr` holds
// its cluster attribute
cudaLaunchConfig_t cluster_config(int cluster, int threads, size_t smem,
                                  void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <typename T, int SCHEME>
int launch_scheme(const void* u0, const void* lam0, void* u_out,
                  void* lam_out, void* scratch, const void* sfields,
                  const void* vfields, const void* scalars,
                  const void* ev_step, const void* ev_idx, const void* ev_w,
                  int ns, int nv, int levels, int first_step, int n_steps,
                  int american, int n_events, int payoff, int n_react,
                  int knock0, int knock1, int cluster, int threads,
                  int n_smem, const Layout& lay, size_t smem, double dt,
                  double td, double rf, double cm, void* stream) {
  const auto kern = kernel_of<T, SCHEME>(lay, n_smem);
  const int rc = set_attributes(kern, cluster, smem);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(cluster, threads, smem, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kern, static_cast<const T*>(u0),
      static_cast<const T*>(lam0), static_cast<T*>(u_out),
      static_cast<T*>(lam_out), static_cast<T*>(scratch),
      static_cast<const T*>(sfields), static_cast<const T*>(vfields),
      static_cast<const T*>(scalars), static_cast<const int*>(ev_step),
      static_cast<const int*>(ev_idx), static_cast<const T*>(ev_w), ns, nv,
      levels, first_step, n_steps, american, n_events, payoff, n_react,
      knock0, knock1, n_smem, static_cast<T>(dt), static_cast<T>(td),
      static_cast<T>(rf), static_cast<T>(cm));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* u0, const void* lam0, void* u_out, void* lam_out,
           void* scratch, const void* sfields, const void* vfields,
           const void* scalars, const void* ev_step, const void* ev_idx,
           const void* ev_w, int ns, int nv, int levels, int first_step,
           int n_steps, int american, int n_events, int scheme, int payoff,
           int n_react, int knock0, int knock1, int cluster, int threads,
           int n_smem, long long scratch_elems, double dt, double td,
           double rf, double cm, void* stream) {
  int rc = check_args(ns, nv, levels, first_step, n_steps, n_events, scheme,
                      payoff, n_react, knock0, knock1);
  if (rc != 0) return rc;
  const Layout lay(ns, nv, levels, scheme, cluster);
  size_t smem = 0;
  rc = check_plan<T>(lay, threads, n_smem, &smem);
  if (rc != 0) return rc;
  // the wrapper's scratch is the plan's: every block's global fields
  if (scratch_elems != (long long)cluster * lay.gstride(n_smem))
    return (int)cudaErrorInvalidValue;
#define LAUNCH_SCHEME(S)                                                   \
  launch_scheme<T, S>(u0, lam0, u_out, lam_out, scratch, sfields, vfields, \
                      scalars, ev_step, ev_idx, ev_w, ns, nv, levels,      \
                      first_step, n_steps, american, n_events, payoff,     \
                      n_react, knock0, knock1, cluster, threads, n_smem,   \
                      lay, smem, dt, td, rf, cm, stream)
  switch (scheme) {
    case DO:
      return LAUNCH_SCHEME(DO);
    case CS:
      return LAUNCH_SCHEME(CS);
    case MCS:
      return LAUNCH_SCHEME(MCS);
    default:
      return LAUNCH_SCHEME(HV);
  }
#undef LAUNCH_SCHEME
}

// resources of the instantiation a plan takes: clusters of `cluster`
// blocks of `threads` threads the card can hold at once
// (cudaOccupancyMaxActiveClusters; 0: it cannot be scheduled), registers
// and local (spill) bytes a thread, the block's dynamic shared bytes
template <typename T, int SCHEME>
int occupancy_scheme(const Layout& lay, int threads, int n_smem,
                     int* clusters, int* regs, int* local,
                     long long* smem_out) {
  size_t smem = 0;
  int rc = check_plan<T>(lay, threads, n_smem, &smem);
  if (rc != 0) return rc;
  const auto kern = kernel_of<T, SCHEME>(lay, n_smem);
  rc = set_attributes(kern, lay.cluster, smem);
  if (rc != 0) return rc;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cattr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(lay.cluster, threads, smem, nullptr, cattr);
  err = cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *local = (int)attr.localSizeBytes;
  *smem_out = (long long)smem;
  return 0;
}

template <typename T>
int occupancy(int scheme, int ns, int nv, int levels, int cluster,
              int threads, int n_smem, int* clusters, int* regs, int* local,
              long long* smem) {
  const Layout lay(ns, nv, levels, scheme, cluster);
  switch (scheme) {
    case DO:
      return occupancy_scheme<T, DO>(lay, threads, n_smem, clusters, regs,
                                     local, smem);
    case CS:
      return occupancy_scheme<T, CS>(lay, threads, n_smem, clusters, regs,
                                     local, smem);
    case MCS:
      return occupancy_scheme<T, MCS>(lay, threads, n_smem, clusters, regs,
                                      local, smem);
    case HV:
      return occupancy_scheme<T, HV>(lay, threads, n_smem, clusters, regs,
                                     local, smem);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The single-option plan on the card: single_plan_kernel<T>
//
// One block builds every input of kernel 2 for one option, in kernel 2's
// packed layout, with the host plan's arithmetic (fused_single.single_plan:
// fused_do._assemble and fused_do._build_remap_fields) operation for
// operation, each operation rounded as PyTorch's elementwise kernel rounds
// it on the card:
//   * every add, subtract, multiply and divide is an explicit
//     round-to-nearest intrinsic (rn_*), so no build contracts them;
//   * a Python number meets a tensor rounded to T (of(), after Python's
//     own double arithmetic, which the kernel repeats in double);
//   * a tensor divided by a Python number is multiplied by the reciprocal
//     PyTorch forms on the host in T (rcp of the number);
//   * `number / tensor` is the tensor's reciprocal times the number
//     (torch.Tensor.__rdiv__);
//   * `x -= y` and `t - number` round once, as x + (-1)*y does;
//   * an in-place `+=` onto a zero field adds to +0 (so -0 becomes +0).
// Geometry: the sinh s-grid with S0 inserted and the largest node dropped
// (the 1e-12 duplicate rule; a knock-out domain pinned at its ends, S0
// inserted among the lower m1 nodes under a top knock), the sinh v-grid
// with v0 inserted; then per s node the rank-2 A1 bands, the A0 factor,
// the beta weights, the boundary row and the payoff, per v node the A2
// bands (central, and upwind's extra row below) and the beta weights, the
// boundary scalar, the node of the price, and per dividend event the
// 2-point remap of the s axis (searchsorted's upper bound).
// The market comes by value, or from a float64 [8] buffer on the card
// (s0, kappa, eta, sigma, rho, v0, r_d, r_f) where the caller holds it in
// tensors; the events come by value, kPlanEvents a launch; a launch with
// `fields` = 0 writes only its events, reading the s-grid back from the
// VECS row the first launch wrote.

// events a launch of the plan kernel takes (fused_single.PLAN_EVENTS)
constexpr int kPlanEvents = 32;
constexpr int kPlanThreads = 256;

// knock-out barriers (fused_single._BARRIERS)
enum BarrierKind { NO_BARRIER, UP_OUT, DOWN_OUT, DOUBLE_OUT };

// the host plan's Python numbers (fused_single._PlanArgs)
struct PlanArgs {
  double s0, kappa, eta, sigma, rho, v0, r_d, r_f;
  double s_max_mult, c_mult, v_max, d_div, delta_t;
  double b_level, b_level_hi;
  int m1, m2, n_steps, payoff, upwind, barrier, fields;
};

// the market the plan is built in
struct PlanMarket {
  double s0, kappa, eta, sigma, rho, v0, r_d, r_f;
};

// the market by value (a), or from the caller's float64 [8] on the card
// (market, where not null), in PlanMarket's order
__device__ __forceinline__ PlanMarket plan_market(const PlanArgs& a,
                                                  const double* market) {
  if (market)
    return {market[0], market[1], market[2], market[3],
            market[4], market[5], market[6], market[7]};
  return {a.s0, a.kappa, a.eta, a.sigma, a.rho, a.v0, a.r_d, a.r_f};
}

// one launch's dividend events: global index first.., in processing order
// (fused_single._PlanEvents)
struct PlanEvents {
  double amount[kPlanEvents];
  double pct[kPlanEvents];
  int step[kPlanEvents];
  int first, count;
};

__device__ __forceinline__ float rn_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double rn_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float rn_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double rn_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float rn_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double rn_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float rn_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double rn_div(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float sinh_t(float x) { return sinhf(x); }
__device__ __forceinline__ double sinh_t(double x) { return sinh(x); }
__device__ __forceinline__ float asinh_t(float x) { return asinhf(x); }
__device__ __forceinline__ double asinh_t(double x) { return asinh(x); }

// a Python number as it meets a tensor of type T
template <typename T>
__device__ __forceinline__ T of(double x) {
  return static_cast<T>(x);
}

// torch.reciprocal
template <typename T>
__device__ __forceinline__ T rcp(T x) {
  return rn_div(T(1), x);
}

// coeff.w_beta: central first derivative (-1, 0, +1)
template <typename T>
__device__ __forceinline__ void plan_beta(T h0, T h1, T& m, T& z, T& p) {
  const T s = rn_add(h0, h1);
  m = rn_div(-h1, rn_mul(h0, s));
  z = rn_div(rn_sub(h1, h0), rn_mul(h0, h1));
  p = rn_div(h0, rn_mul(h1, s));
}

// coeff.w_delta: central second derivative (-1, 0, +1)
template <typename T>
__device__ __forceinline__ void plan_delta(T h0, T h1, T& m, T& z, T& p) {
  const T s = rn_add(h0, h1);
  m = rn_mul(rcp(rn_mul(h0, s)), T(2));
  z = rn_mul(rcp(rn_mul(h0, h1)), T(-2));
  p = rn_mul(rcp(rn_mul(h1, s)), T(2));
}

// coeff.w_alpha: backward upwind first derivative (-2, -1, 0)
template <typename T>
__device__ __forceinline__ void plan_alpha(T hm, T h0, T& m, T& z, T& p) {
  const T s = rn_add(hm, h0);
  m = rn_div(h0, rn_mul(hm, s));
  z = rn_div(rn_sub(-hm, h0), rn_mul(hm, h0));
  p = rn_div(rn_add(hm, rn_mul(h0, T(2))), rn_mul(h0, s));
}

// coeff.w_gamma: forward one-sided first derivative (0, +1, +2)
template <typename T>
__device__ __forceinline__ void plan_gamma(T h1, T h2, T& m, T& z, T& p) {
  const T s = rn_add(h1, h2);
  m = rn_div(rn_sub(rn_mul(h1, T(-2)), h2), rn_mul(h1, s));
  z = rn_div(s, rn_mul(h1, h2));
  p = rn_div(-h1, rn_mul(h2, s));
}

// grid._insert_and_crop of `value` into raw[0..n) -> out[0..n): the
// insertion point is count(raw <= value); a value within 1e-12 relative
// of a node leaves the nodes as they are. cnt and dup: zeroed shared ints.
// Every thread of the block calls it.
template <typename T>
__device__ void plan_insert(const T* raw, T* out, int n, T value, int* cnt,
                            int* dup) {
  const T mag = value < T(0) ? -value : value;
  const T tol = rn_mul(mag < T(1) ? T(1) : mag, of<T>(1e-12));
  int c = 0, d = 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    c += raw[k] <= value;
    const T gap = rn_sub(raw[k], value);
    d |= (gap < T(0) ? -gap : gap) <= tol;
  }
  if (c) atomicAdd(cnt, c);
  if (d) atomicOr(dup, 1);
  __syncthreads();
  const int at = *cnt;
  const bool keep = *dup != 0;
  for (int k = threadIdx.x; k < n; k += blockDim.x)
    out[k] = keep || k < at ? raw[k] : (k == at ? value : raw[k - 1]);
}

// grid.find_node's hit: |node - value| < 1e-10 (the first such node wins)
template <typename T>
__device__ __forceinline__ bool plan_hit(T node, T value) {
  const T gap = rn_sub(node, value);
  return (gap < T(0) ? -gap : gap) < of<T>(1e-10);
}

// torch.searchsorted(vs, x, right=True) on the card: the first node > x
template <typename T>
__device__ __forceinline__ int plan_upper(const T* vs, int n, T x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (!(vs[mid] > x))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <typename T>
__global__ void __launch_bounds__(kPlanThreads) single_plan_kernel(
    const PlanArgs a, const PlanEvents ev,
    const double* __restrict__ market, const T* __restrict__ strike,
    T* __restrict__ u0, T* __restrict__ lam0, T* __restrict__ sf,
    T* __restrict__ vf, T* __restrict__ sc, int* __restrict__ ev_step,
    int* __restrict__ ev_idx, T* __restrict__ ev_w,
    long long* __restrict__ at) {
  const PlanMarket mk = plan_market(a, market);
  const int m1 = a.m1, m2 = a.m2, ns = m1 + 1, nv = m2 + 1;
  const int tid = threadIdx.x, nt = blockDim.x;
  extern __shared__ __align__(16) unsigned char plan_smem[];
  T* vs = reinterpret_cast<T*>(plan_smem);  // the s-grid [ns]
  T* vv = vs + ns;                           // the v-grid [nv]
  T* raw_s = vv + nv;                        // raw s nodes, then the payoff
  T* raw_v = raw_s + ns;                     // raw v nodes
  __shared__ int cnt_s, dup_s, cnt_v, dup_v, hit_s, hit_v;
  const bool put = a.payoff == PUT || a.payoff == DIGITAL_PUT;
  const bool knock_top = a.barrier == UP_OUT || a.barrier == DOUBLE_OUT;
  const bool knock_bottom = a.barrier == DOWN_OUT || a.barrier == DOUBLE_OUT;

  if (a.fields) {
    const T kk = strike[0];
    if (tid == 0) {
      cnt_s = dup_s = cnt_v = dup_v = 0;
      hit_s = ns;
      hit_v = nv;
    }
    // grid.make_grid: the raw sinh nodes of both axes
    const T s_max = rn_mul(kk, of<T>(a.s_max_mult));
    const T c = rn_mul(kk, of<T>(a.c_mult));
    const double s_lo = a.barrier == NO_BARRIER || a.barrier == UP_OUT
                            ? 0.0
                            : a.b_level;
    const T s_hi = a.barrier == NO_BARRIER || a.barrier == DOWN_OUT
                       ? s_max
                       : of<T>(a.barrier == UP_OUT ? a.b_level
                                                   : a.b_level_hi);
    const T xlo = asinh_t(rn_div(rn_sub(of<T>(s_lo), kk), c));
    const T xhi = asinh_t(rn_div(rn_sub(s_hi, kk), c));
    const T dxi = rn_mul(rn_sub(xhi, xlo), rcp(T(m1)));
    for (int i = tid; i < ns; i += nt)
      raw_s[i] = a.barrier != NO_BARRIER && i == 0
                     ? of<T>(s_lo)
                     : rn_add(kk, rn_mul(c, sinh_t(rn_add(
                                                xlo, rn_mul(T(i), dxi)))));
    const double d = __ddiv_rn(a.v_max, a.d_div);
    const T deta = rn_mul(asinh_t(rn_mul(of<T>(a.v_max), rcp(of<T>(d)))),
                          rcp(T(m2)));
    for (int j = tid; j < nv; j += nt)
      raw_v[j] = rn_mul(sinh_t(rn_mul(T(j), deta)), of<T>(d));
    __syncthreads();
    plan_insert(raw_s, vs, knock_top ? m1 : ns, of<T>(mk.s0), &cnt_s,
                &dup_s);
    plan_insert(raw_v, vv, nv, of<T>(mk.v0), &cnt_v, &dup_v);
    if (knock_top && tid == 0)
      vs[m1] = of<T>(a.barrier == UP_OUT ? a.b_level : a.b_level_hi);
    __syncthreads();

    // s rows (_prepare_batched, build_operators, boundary_data), the
    // payoff row (grid_payoff, Barrier.mask_payoff) and the spot's node
    const bool full = a.payoff != CALL || knock_top;
    const double rate = a.payoff == CALL ? mk.r_f : mk.r_d;
    const T efac = exp_t(rn_mul(rn_sub(T(a.n_steps), T(1)),
                                of<T>(__dmul_rn(-rate, a.delta_t))));
    const T rdf = of<T>(__dsub_rn(mk.r_d, mk.r_f));
    const T half_rd = of<T>(__dmul_rn(0.5, mk.r_d));
    const T mhalf_rd = of<T>(__dmul_rn(-0.5, mk.r_d));
    const T q_left = put ? mhalf_rd : T(0);
    const T rho_sigma = of<T>(__dmul_rn(mk.rho, mk.sigma));
    const T s0 = of<T>(mk.s0);
    for (int i = tid; i < ns; i += nt) {
      const T s = vs[i];
      T pl = T(0), ql = T(0), pd = T(0), pu = T(0), qu = T(0);
      T qd = rn_add(T(0), i == 0 ? q_left : mhalf_rd);
      T bsm = T(0), bsp = T(0), sfac = T(0);
      if (i > 0 && i < m1) {
        const T h0 = rn_sub(s, vs[i - 1]);
        const T h1 = rn_sub(vs[i + 1], s);
        T dm, d0, dp, bm, b0, bp;
        plan_delta(h0, h1, dm, d0, dp);
        plan_beta(h0, h1, bm, b0, bp);
        const T aa = rn_mul(rn_mul(s, T(0.5)), s);
        const T bb = rn_mul(s, rdf);
        pl = rn_mul(aa, dm);
        ql = rn_mul(bb, bm);
        pd = rn_mul(aa, d0);
        qd = rn_sub(rn_mul(bb, b0), half_rd);
        pu = rn_mul(aa, dp);
        qu = rn_mul(bb, bp);
        bsm = bm;
        bsp = bp;
        sfac = rn_mul(s, rho_sigma);
      }
      const T b2r = full || i == 0 ? T(0) : rn_mul(rn_mul(s, mhalf_rd), efac);
      const T row[NSF] = {pl, ql, pd, qd, pu, qu, sfac, bsm, bsp, b2r, s};
      for (int f = 0; f < NSF; ++f) sf[f * ns + i] = row[f];
      T pay;
      if (a.payoff == CALL || a.payoff == PUT) {
        const T intrinsic = put ? rn_sub(kk, s) : rn_sub(s, kk);
        pay = intrinsic > T(0) ? intrinsic : T(0);
      } else {
        const T hi =
            i == m1 ? s : rn_mul(rn_add(s, vs[i + 1]), T(0.5));
        const T lo = i == 0 ? s : rn_mul(rn_add(s, vs[i - 1]), T(0.5));
        const T den = hi == lo ? T(1) : rn_sub(hi, lo);
        const T r = rn_div(put ? rn_sub(kk, lo) : rn_sub(hi, kk), den);
        pay = r > T(0) ? (r < T(1) ? r : T(1)) : T(0);
      }
      if ((knock_top && i == m1) || (knock_bottom && i == 0)) pay = T(0);
      raw_s[i] = pay;
      if (plan_hit(s, s0)) atomicMin(&hit_s, i);
    }

    // v columns (build_operators, build_a2_bands) and the v0 node
    const int n_react = full ? nv : nv - 2;
    const T eta = of<T>(mk.eta);
    const T kappa = of<T>(mk.kappa);
    const T half_s2 = of<T>(__dmul_rn(__dmul_rn(0.5, mk.sigma), mk.sigma));
    const T v0 = of<T>(mk.v0);
    for (int j = tid; j < nv; j += nt) {
      const T v = vv[j];
      T bvm = T(0), bvp = T(0);
      T l2 = T(0), l1 = T(0), u1 = T(0), u2 = T(0);
      T dd = j < n_react ? rn_add(T(0), mhalf_rd) : T(0);
      if (j > 0 && j < m2) {
        T z;
        plan_beta(rn_sub(v, vv[j - 1]), rn_sub(vv[j + 1], v), bvm, z, bvp);
      }
      if (j == 0) {
        T g0, g1, g2;
        plan_gamma(rn_sub(vv[2], vv[1]), rn_sub(vv[3], vv[2]), g0, g1, g2);
        const T temp0 = rn_mul(rn_sub(eta, v), kappa);
        dd = rn_add(dd, rn_mul(temp0, g0));
        u1 = rn_add(T(0), rn_mul(temp0, g1));
        u2 = rn_add(T(0), rn_mul(temp0, g2));
      }
      if (j >= 1 && j <= m2 - 2) {
        // the central row of node j
        T dm, d0, dp, bm, b0, bp;
        const T h0 = rn_sub(v, vv[j - 1]), h1 = rn_sub(vv[j + 1], v);
        plan_delta(h0, h1, dm, d0, dp);
        plan_beta(h0, h1, bm, b0, bp);
        const T temp = rn_mul(rn_sub(eta, v), kappa);
        const T temp2 = rn_mul(v, half_s2);
        l1 = rn_add(T(0), rn_add(rn_mul(temp, bm), rn_mul(temp2, dm)));
        dd = rn_add(dd, rn_add(rn_mul(temp, b0), rn_mul(temp2, d0)));
        u1 = rn_add(T(0), rn_add(rn_mul(temp, bp), rn_mul(temp2, dp)));
      }
      if (a.upwind && j >= 2 && j <= m2 - 1) {
        // upwind's terms of node q = j - 1, one row below it
        const int q = j - 1;
        const T vq = vv[q];
        T dm, d0, dp, am, a1, a0;
        const T h0 = rn_sub(vq, vv[q - 1]), h1 = rn_sub(vv[q + 1], vq);
        plan_delta(h0, h1, dm, d0, dp);
        plan_alpha(h0, h1, am, a1, a0);
        const T temp = rn_mul(rn_sub(eta, vq), kappa);
        const T temp2 = rn_mul(vq, half_s2);
        const T mask = vq > T(1) ? T(1) : T(0);
        l2 = rn_add(T(0), rn_mul(rn_mul(mask, temp), am));
        l1 = rn_add(l1, rn_mul(mask, rn_add(rn_mul(temp, a1),
                                            rn_mul(temp2, dm))));
        dd = rn_add(dd, rn_mul(mask, rn_add(rn_mul(temp, a0),
                                            rn_mul(temp2, d0))));
        u1 = rn_add(u1, rn_mul(rn_mul(mask, temp2), dp));
      }
      const T vfac = j == 0 || j == m2 ? T(0) : v;
      const T col[NVF] = {v, vfac, bvm, bvp, l2, l1, dd, u1, u2};
      for (int f = 0; f < NVF; ++f) vf[f * nv + j] = col[f];
      if (plan_hit(v, v0)) atomicMin(&hit_v, j);
    }
    if (tid == 0)
      sc[0] = full ? T(0) : rn_mul(rn_mul(vs[m1], rdf), efac);
    if (tid == 1) sc[1] = kk;
    __syncthreads();
    for (int k = tid; k < nv * ns; k += nt) {
      u0[k] = raw_s[k % ns];
      lam0[k] = T(0);
    }
    if (tid == 0)
      at[0] = (long long)(hit_v < nv ? hit_v : 0) * ns
              + (hit_s < ns ? hit_s : 0);
  } else {
    for (int i = tid; i < ns; i += nt) vs[i] = sf[VECS * ns + i];
    __syncthreads();
  }

  // the dividend remaps (_build_remap_fields), one per event
  for (int e = 0; e < ev.count; ++e) {
    const int g = ev.first + e;
    const T keep = of<T>(__dsub_rn(1.0, ev.pct[e]));
    const T amount = of<T>(ev.amount[e]);
    if (tid == 0) ev_step[g] = ev.step[e];
    for (int i = tid; i < ns; i += nt) {
      const T new_s = rn_sub(rn_mul(vs[i], keep), amount);
      int idx = plan_upper(vs, ns, new_s);
      if (idx > m1) idx = 0;
      const int lo = idx - 1 > 0 ? idx - 1 : 0;
      const T s_lo = vs[lo], s_hi = vs[idx];
      const T w = rn_div(rn_sub(new_s, s_lo),
                         s_hi == s_lo ? T(1) : rn_sub(s_hi, s_lo));
      const T valid = put || new_s > T(0) ? T(1) : T(0);
      const bool left = idx == 0;
      const T w0i = rn_sub(T(1), w);
      const T w1i = w >= T(0.5) ? w : rn_sub(T(1), w0i);
      T w0 = rn_mul(valid, left ? T(1) : w0i);
      T w1 = rn_mul(valid, left ? T(0) : w1i);
      if (knock_top && i == m1) w0 = w1 = T(0);
      ev_idx[(2 * g) * ns + i] = left ? 0 : lo;
      ev_idx[(2 * g + 1) * ns + i] = left ? 0 : idx;
      ev_w[(2 * g) * ns + i] = w0;
      ev_w[(2 * g + 1) * ns + i] = w1;
    }
  }
}

template <typename T>
int launch_plan_kernel(const PlanArgs* args, const PlanEvents* ev,
                       const void* market, const void* strike, void* u0,
                       void* lam0, void* sf, void* vf, void* sc,
                       void* ev_step, void* ev_idx, void* ev_w, void* at,
                       void* stream) {
  if (args->m1 < 2 || args->m2 < 3 || args->payoff < CALL
      || args->payoff > DIGITAL_PUT || args->barrier < NO_BARRIER
      || args->barrier > DOUBLE_OUT || ev->count < 0
      || ev->count > kPlanEvents || ev->first < 0
      || (!args->fields && ev->count == 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * (3 * (size_t)(args->m1 + 1) + 2 * (size_t)(args->m2 + 1));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  single_plan_kernel<T><<<1, kPlanThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      *args, *ev, static_cast<const double*>(market),
      static_cast<const T*>(strike), static_cast<T*>(u0),
      static_cast<T*>(lam0), static_cast<T*>(sf), static_cast<T*>(vf),
      static_cast<T*>(sc), static_cast<int*>(ev_step),
      static_cast<int*>(ev_idx), static_cast<T*>(ev_w),
      static_cast<long long*>(at));
  return (int)cudaGetLastError();
}

}  // namespace

#define PLAN_ARGS                                                          \
  const void *args, const void *ev, const void *market,                   \
      const void *strike, void *u0, void *lam0, void *sf, void *vf,       \
      void *sc, void *ev_step, void *ev_idx, void *ev_w, void *at,        \
      void *stream

// one launch of the plan kernel: every input of kernel 2 for one option
// (args->fields) and the events ev->first.. of its schedule; the strike,
// and the market where `market` is not null, are read on the card
extern "C" int single_plan_f32(PLAN_ARGS) {
  return launch_plan_kernel<float>(static_cast<const PlanArgs*>(args),
                                   static_cast<const PlanEvents*>(ev), market,
                                   strike, u0, lam0, sf, vf, sc, ev_step,
                                   ev_idx, ev_w, at, stream);
}

extern "C" int single_plan_f64(PLAN_ARGS) {
  return launch_plan_kernel<double>(static_cast<const PlanArgs*>(args),
                                    static_cast<const PlanEvents*>(ev),
                                    market, strike, u0, lam0, sf, vf, sc,
                                    ev_step, ev_idx, ev_w, at, stream);
}

#define SINGLE_ARGS                                                       \
  const void *u0, const void *lam0, void *u_out, void *lam_out,          \
      void *scratch, const void *sfields, const void *vfields,           \
      const void *scalars, const void *ev_step, const void *ev_idx,      \
      const void *ev_w, int ns, int nv, int levels, int first_step,      \
      int n_steps, int american, int n_events, int scheme, int payoff,   \
      int n_react, int knock0, int knock1, int cluster, int threads,     \
      int n_smem, long long scratch_elems, double dt, double td,         \
      double rf, double cm, void *stream

extern "C" int fused_single_f32(SINGLE_ARGS) {
  return launch<float>(u0, lam0, u_out, lam_out, scratch, sfields, vfields,
                       scalars, ev_step, ev_idx, ev_w, ns, nv, levels,
                       first_step, n_steps, american, n_events, scheme,
                       payoff, n_react, knock0, knock1, cluster, threads,
                       n_smem, scratch_elems, dt, td, rf, cm, stream);
}

extern "C" int fused_single_f64(SINGLE_ARGS) {
  return launch<double>(u0, lam0, u_out, lam_out, scratch, sfields, vfields,
                        scalars, ev_step, ev_idx, ev_w, ns, nv, levels,
                        first_step, n_steps, american, n_events, scheme,
                        payoff, n_react, knock0, knock1, cluster, threads,
                        n_smem, scratch_elems, dt, td, rf, cm, stream);
}

// f64, scheme, ns, nv, levels, cluster, threads, n_smem; out: clusters the
// card holds at once, registers, local bytes a thread, shared bytes a block
extern "C" int fused_single_occupancy(int f64, int scheme, int ns, int nv,
                                      int levels, int cluster, int threads,
                                      int n_smem, int* clusters, int* regs,
                                      int* local, long long* smem) {
  if (scheme < DO || scheme > HV || levels < 1 || levels > 30)
    return (int)cudaErrorInvalidValue;
  return f64 ? occupancy<double>(scheme, ns, nv, levels, cluster, threads,
                                 n_smem, clusters, regs, local, smem)
             : occupancy<float>(scheme, ns, nv, levels, cluster, threads,
                                n_smem, clusters, regs, local, smem);
}

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

}  // namespace

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

// The plan of an option on the card: the per-lane arithmetic shared by
// single_plan_kernel (csrc/fused_single.cu: one option in kernel 2's
// layout) and book_plan_kernel (csrc/fused_do.cu: one block per option of
// a book in kernel 1's layout).
//
// One block builds every input of the time loop for one option (a lane),
// with the host plan's arithmetic (fused_do._assemble and
// fused_do._build_remap_fields) operation for operation, each operation
// rounded as PyTorch's elementwise kernel rounds it on the card:
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
// the beta weights, the boundary row (scaled by the lane's own step count)
// and the payoff, per v node the A2 bands (central, and upwind's extra row
// below) and the beta weights, the boundary scalar, the node of the price,
// and per dividend event the 2-point remap of the s axis (searchsorted's
// upper bound), the identity row where the lane's count for the event's
// phase stops before the event's step (a mixed-maturity book).
// The market comes by value, or from a float64 [8] buffer on the card
// (s0, kappa, eta, sigma, rho, v0, r_d, r_f) where the caller holds it in
// tensors; the events come by value, kPlanEvents a launch; a launch with
// `fields` = 0 writes only its events, reading the s-grid back from the
// VECS row the first launch wrote.
//
// Included inside the anonymous namespace of each source, after its SField,
// VField and Payoff enums and its exp_t, which it reads; a source's build
// hashes it with the source (fused_do.build).

#pragma once

// events a launch of a plan kernel takes (fused_do.PLAN_EVENTS)
constexpr int kPlanEvents = 32;
// phases a plan holds (fused_do.PLAN_PHASES): a damp phase and the main one
constexpr int kPlanPhases = 2;
// threads a block at most
constexpr int kPlanThreads = 256;

// knock-out barriers (fused_do.PLAN_BARRIERS)
enum BarrierKind { NO_BARRIER, UP_OUT, DOWN_OUT, DOUBLE_OUT };

// the host plan's Python numbers (fused_do.PlanArgs)
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
// (fused_do.PlanEvents)
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

// the phases of a plan (fused_do.phase_plan; fused_do.PlanPhases): each
// phase's first event, its event count and whether it is the Rannacher damp
// phase, and R = min(rannacher_steps, n_steps)
struct PlanPhases {
  int first[kPlanPhases], count[kPlanPhases], damp[kPlanPhases];
  int n, rannacher;
};

// where one lane's plan goes, and what it reads of the lane
template <typename T>
struct PlanLane {
  const T* strike;   // the lane's strike
  T* u0;             // the payoff on every node: [nv][ns], or [ns][nv]
  T* lam0;           //   (s_major, kernel 1's); zeros in lam0's layout
  bool s_major;
  T* sf;             // [NSF][ns] s-rows
  T* vf;             // [NVF][nv] v-columns
  T* sc;             // [2] b1v, kk
  long long* at;     // the price's flat node: at_base + its index in u0
  long long at_base;
  int* ev_step;      // [n_ev] each event's local step (null: not this lane)
  // the events of phase p, for `lanes` lanes, one block [lanes][count][2][ns]
  // after the blocks of the phases before it (one lane: [n_ev][2][ns])
  int* ev_idx;
  T* ev_w;
  int lanes, lane;
  int n_steps;       // the lane's step count (the boundary data's scaling)
  bool per_lane;     // identity rows past the lane's count of each phase
};

// one lane's plan, by every thread of its block; smem: 3 ns + 2 nv values
template <typename T>
__device__ void plan_lane(const PlanArgs& a, const PlanEvents& ev,
                          const PlanPhases& ph, const PlanMarket& mk,
                          const PlanLane<T>& o) {
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
  T* const sf = o.sf;
  T* const vf = o.vf;
  T* const sc = o.sc;

  if (a.fields) {
    const T kk = o.strike[0];
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
    const T efac = exp_t(rn_mul(rn_sub(T(o.n_steps), T(1)),
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
      o.u0[k] = raw_s[o.s_major ? k / nv : k % ns];
      o.lam0[k] = T(0);
    }
    if (tid == 0) {
      const long long is = hit_s < ns ? hit_s : 0;
      const long long iv = hit_v < nv ? hit_v : 0;
      o.at[0] = o.at_base + (o.s_major ? is * nv + iv : iv * ns + is);
    }
  } else {
    for (int i = tid; i < ns; i += nt) vs[i] = sf[VECS * ns + i];
    __syncthreads();
  }

  // the dividend remaps (_build_remap_fields), one per event
  for (int e = 0; e < ev.count; ++e) {
    const int g = ev.first + e;
    const T keep = of<T>(__dsub_rn(1.0, ev.pct[e]));
    const T amount = of<T>(ev.amount[e]);
    if (tid == 0 && o.ev_step) o.ev_step[g] = ev.step[e];
    int p = 0;
    while (p + 1 < ph.n && ph.first[p + 1] <= g) ++p;
    const size_t row = 2 * ((size_t)o.lanes * ph.first[p]
                            + (size_t)o.lane * ph.count[p]
                            + (g - ph.first[p]));
    // the lane's last local step of the phase (fused_do.phase_plan's nst)
    const int last = !ph.damp[p] ? o.n_steps
                     : 2 * (o.n_steps < ph.rannacher ? o.n_steps
                                                     : ph.rannacher);
    const bool frozen = o.per_lane && last < ev.step[e];
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
      o.ev_idx[row * ns + i] = frozen ? i : left ? 0 : lo;
      o.ev_idx[(row + 1) * ns + i] = frozen ? i : left ? 0 : idx;
      o.ev_w[row * ns + i] = frozen ? T(1) : w0;
      o.ev_w[(row + 1) * ns + i] = frozen ? T(0) : w1;
    }
  }
}

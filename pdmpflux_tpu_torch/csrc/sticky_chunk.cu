// K6: K fused Sticky Zig-Zag transitions per chain, one CTA per chain.
//
// Replaces pdmpflux_tpu/ops/pallas/zigzag_chunk.py:run_chunk (line 854, body
// _make_kernel) with kind="zigzag", sticky=True, in mode "events" and
// "horizon" (K7: lane_live in pdmp_common.cuh; a frozen chain emits its
// frozen row, as at the event cap).  The plain
// PyTorch version is run_chunk_plain in ops/cuda/zigzag_chunk.py (its sticky
// branches); both draw the Pallas kernel's Threefry counters (key (seed +
// (b / tile) * 7919, salt), counter row * tile + b % tile; salts k,
// 0x80000000 + k for the Exp clock and 0xC0000000 + k for the thaw clock),
// so trajectories agree to rounding.
//
// The transition is K1's (envelope, clock inversion, thinning, flip) with the
// sticky branches: every rate and flow uses the masked velocity va = v * act;
// the axis-crossing probe at min(tp, tt, h) and the stick time
// t_togo = min_j(-x_j / v_j) (first index on ties, as jnp.argmin) decide a
// stick; a thaw clock tt below tp decides a thaw; the thaw coordinate is drawn
// in proportion to kappa over the frozen coordinates; after every reset the
// thaw clock is redrawn as Exp(1) / sum(kappa[frozen]) (or inf).
//
// What bounds it on an H100: latency.  The d = 1000 deployment runs B = 128
// chains, one CTA each on 132 SMs, and almost every transition is an event,
// so a transition's time is its chain of dependent steps and barriers.  The
// first design ran 256 threads (8 warps per SM, four coordinates a thread,
// box[] and cum[] in local memory) and about 22 barriers per jump, with
// serial loops over the warps between them.
//
// Design.  blockDim = min(1024, roundup(d, 32)) threads: up to d = 1024 each
// thread owns one coordinate, i = tid (32 warps per SM at d = 1000); past
// it, coordinates i = tid, tid + blockDim, ... (tiles of blockDim).  x, v,
// act (a byte) and kappa sit in shared memory, loaded once per launch and
// written back at the end, beside a buffer of d prefix sums.  The per-chain
// scalars are replicated in every thread.  Every reduction is two levels:
// a warp's xor butterfly, one shared write per warp, one barrier, then every
// warp reads the warp partials one per lane and reduces them with the same
// butterfly, so every thread computes every total from the same values in
// the same order and holds the same bits, and the block takes uniform
// branches (a reduction whose order differed between warps would give
// divergent decisions and a hang at the next barrier).  The rounds:
//  A  the envelope: per grid segment, the segment maxima of the thread's
//     coordinates summed by the warp butterfly into the warp's shared row of
//     segment partials (tile by tile); with them the frozen-kappa sum of the
//     previous transition's reset (the thaw clock is needed first at this
//     transition's thinning, so its reduction rides on this barrier); after
//     the barrier lane l of every warp adds the warp partials of segments l
//     and l + 32 in warp order (one pass for all segments), and the boxes go
//     by shuffle, in grid order, into the clock inversion (EnvelopeWalk);
//  B  thinning: the rate at tp, the min/argmin of the stick times and the OR
//     of the crossings (__syncthreads_or is the barrier);
//  C  on a jump (or a thaw) the categorical draw: a warp inclusive scan, the
//     warp totals scanned by a warp scan in every warp (one barrier per tile
//     of blockDim coordinates, two buffers alternating), then c <= u * c[d-1]
//     counted (__syncthreads_count up to d = blockDim, else a two-level sum)
//     and clamped to d - 1, as _categorical_rows does.
// A transition so takes 2 barriers (stick, horizon move, rejection), or 4 on
// a jump or a thaw up to d = blockDim (one more per further tile); the first
// design took about 22 on a jump.  The funnels add one: their coordinate 0
// reads sums over the chain's other coordinates (pdmp_common.cuh:
// ChainSums), so each transition starts with a two-level reduction of the
// moments x_j^2, x_j va_j and va_j^2 over coordinates 1..d-1 on the masked
// velocity (a stuck coordinate adds its x, 0.0, and nothing else); the
// linear flow gives S and P from them at every time the transition
// evaluates, and the flip's rates read coordinate 0 flowed in registers.  Only threads 0 and 1 read another
// coordinate (Banana's y0 and y1), both in warp 0, so the flow and the
// flip, stick and thaw updates need a __syncwarp, not a barrier.  A
// potential generated from a user's gradient that reads other coordinates
// (reads_others: 0 and 1, a neighbour, which sits in another warp at every
// 32nd coordinate and in another tile past 1024, or any fixed coordinate,
// all read through the accessor point_at) takes one more barrier at the
// start of each transition, before any thread reads them, and without a
// point context one more on a jump, between the flow and round C's rates.  A
// generated potential whose stages the moments do not give (a product
// with a constant matrix, a sum past degree 2: Pot::point) forms them at
// every point with the whole block (Pot::fill: a stage's positions across
// the threads, a product's input and output in the dynamic shared memory
// past the chain's arrays, a barrier after each, sums by the two-level
// reduction), at each grid point of round A (the grid outer, each tile's
// previous pair in registers), at tp in round B and at the flowed x in
// round C.  Warp 0's
// lanes 0-4 draw the transition's five uniforms and clocks
// (transition_draw) into shared memory before barrier A, one Threefry block
// each in the same instructions.
//
// Shared memory: d * (4 * sizeof(T) + 1) bytes of dynamic shared memory plus
// the static reduction rows (a row of 64 segment partials per warp: 8 KB in
// float32, 16 KB in float64) and a point potential's context
// (Pot::shared_bytes) must fit the 227 KB a block can have, so
// d <= sticky_chunk_max_dim(f64), which reads the static size from the
// built kernel: 13,113 in float32, 6,475 in float64 on the H100 for the
// tags.  The
// event rows go out in the chain-minor (K, d, B) fill that K2 and the
// driver read, 3 stores per coordinate at stride B; at the d = 1000
// deployment they take about a quarter of a launch (chip_ab.py --probe).

#include "pdmp_common.cuh"

namespace {

using namespace pdmp;

constexpr int MAXT = 1024, MAXW = MAXT / 32;
constexpr int POINT_TILES = 16;  // tiles of MAXT coordinates a point potential's envelope keeps
constexpr long SMEM_BLOCK = 232448;  // bytes of shared memory one block may use

template <typename T>
__host__ __device__ constexpr long bytes_per_coord() {
  return 4 * (long)sizeof(T) + 1;
}

// Offset of a point potential's context in dynamic shared memory, past the
// chain's x, v, kappa, scan buffer and activity bytes, 16-byte aligned.
template <typename T>
__host__ __device__ constexpr long ctx_offset(int d) {
  return (d * bytes_per_coord<T>() + 15) / 16 * 16;
}

// Masked velocity va_i = v_i * act_i of the chain's shared-memory copy.
template <typename T>
__device__ __forceinline__ T masked(const T* v, const uint8_t* act, int i) {
  return vel(v, act, 1, i);
}

template <typename U>
__device__ __forceinline__ U warp_sum(U v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Inclusive prefix sum over the warp's lanes in lane order.
template <typename T>
__device__ __forceinline__ T warp_scan(T v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(FULL_MASK, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// The second level of a block sum: every warp adds the nw warp partials, one
// per lane, with the same butterfly, so every thread returns the same bits.
template <typename U>
__device__ __forceinline__ U across_warps(const U* part, int nw) {
  return warp_sum((int)(threadIdx.x & 31) < nw ? part[threadIdx.x & 31] : (U)0);
}

// The block's total of segment j from the warps' rows of segment partials:
// the nw partials added in warp order, four interleaved sums for latency
// (zero past the grid).
template <typename T>
__device__ __forceinline__ T segment_total(const T* segr, int j, int G, int nw) {
  if (j >= G) return (T)0;
  T s[4] = {(T)0, (T)0, (T)0, (T)0};
#pragma unroll
  for (int w = 0; w < MAXW; ++w)
    if (w < nw) s[w & 3] += segr[w * MAXG + j];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// (value, index) minimum, the smaller index on equal values; the same result
// whichever side merges (the values are never NaN).
template <typename T>
__device__ __forceinline__ void argmin_merge(T& v, int& i, T ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

template <typename T>
__device__ __forceinline__ void warp_argmin(T& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    argmin_merge(v, i, __shfl_xor_sync(FULL_MASK, v, o), __shfl_xor_sync(FULL_MASK, i, o));
}

// Inclusive prefix sums of sw[0..d) in coordinate order, in place; returns
// c[d - 1], in the same bits as sw[d - 1].  Tile q holds coordinates
// q * nt .. q * nt + nt - 1, coordinate q * nt + tid in thread tid, which alone
// reads and writes it.  Within a tile c = carry + (pre_w + incl): incl the
// warp's inclusive scan, pre_w the scan of the warp totals below warp w; the
// warp holding the tile's last coordinate posts its incl there, so the tile's
// total is that coordinate's own sum.  One barrier per tile: the warp totals
// alternate between two rows.
template <typename T>
__device__ T block_scan(T* sw, int d, T (*wtot)[MAXW], int nw) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5;
  T carry = (T)0;
  for (int q0 = 0, q = 0; q0 < d; q0 += nt, ++q) {
    const int i = q0 + tid, last = min(d - q0, nt) - 1, wl = last >> 5;
    const T incl = warp_scan(i < d ? sw[i] : (T)0);
    T* wt = wtot[q & 1];
    if (lane == (w == wl ? (last & 31) : 31)) wt[w] = incl;
    __syncthreads();
    const T a = lane < nw ? wt[lane] : (T)0;
    const T ai = warp_scan(a);
    const T pre_w = __shfl_sync(FULL_MASK, ai, (w + 31) & 31);  // lane w - 1's
    const T pre_l = __shfl_sync(FULL_MASK, ai, (wl + 31) & 31);
    const T tot_l = __shfl_sync(FULL_MASK, a, wl);
    if (i < d) sw[i] = carry + ((w > 0 ? pre_w : (T)0) + incl);
    carry = carry + ((wl > 0 ? pre_l : (T)0) + tot_l);
  }
  return carry;
}

// Inverse-CDF draw over the prefix sums of sw[0..d) (_categorical_rows):
// count c <= u * c[d - 1] and clamp to d - 1.
template <typename T>
__device__ int categorical(T* sw, int d, T u, T (*wtot)[MAXW], int* red, int nw) {
  const int nt = blockDim.x;
  const T thresh = u * block_scan(sw, d, wtot, nw);
  int n_le = 0;
  for (int i = threadIdx.x; i < d; i += nt) n_le += sw[i] <= thresh;
  if (d <= nt) {
    n_le = __syncthreads_count(n_le);
  } else {
    n_le = warp_sum(n_le);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = n_le;
    __syncthreads();
    n_le = across_warps(red, nw);
  }
  return n_le < d - 1 ? n_le : d - 1;
}

template <typename T, class Pot>
__global__ void __launch_bounds__(MAXT)
sticky_chunk_kernel(Params p, const T* __restrict__ prm, T* __restrict__ x, T* __restrict__ v, T* __restrict__ fs,
                    int* __restrict__ iscal, T* __restrict__ ring,
                    uint8_t* __restrict__ act, const T* __restrict__ kappa,
                    int* __restrict__ ev_kind, T* __restrict__ ev_x, T* __restrict__ ev_v,
                    T* __restrict__ ev_fs, T* __restrict__ ev_ring,
                    uint8_t* __restrict__ ev_act) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T segr[MAXW * MAXG];  // round A: each warp's row of segment partials
  __shared__ T r_kf[MAXW], r_lam[MAXW], r_min[MAXW], wtot[2][MAXW], draws[5];
  __shared__ T r_mom[Pot::Moments::N][MAXW];  // the chain moments, per warp
  __shared__ int r_imin[MAXW], r_cnt[MAXW];

  const int d = p.d, n_grid = p.n_grid, G = p.n_grid - 1;
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int lane_w = tid & 31, warp = tid >> 5, s1 = d > 1 ? 1 : 0;
  const long B = p.B, b = blockIdx.x;
  T* sx = (T*)smem;
  T* sv = sx + d;
  T* skap = sv + d;
  T* sw = skap + d;
  uint8_t* sact = (uint8_t*)(sw + d);
  T* ctx = (T*)(smem + ctx_offset<T>(d));  // a point potential's context

  for (int i = tid; i < d; i += nt) {
    sx[i] = x[i * B + b];
    sv[i] = v[i * B + b];
    sact[i] = act[i * B + b];
    skap[i] = kappa[i];
  }
  T t_s = fs[F_T * B + b], tc_s = fs[F_TC * B + b], ts_s = fs[F_TS * B + b];
  T h_s = fs[F_H * B + b], bh_s = fs[F_BH * B + b], exp_s = fs[F_EXP * B + b];
  T ar_s = fs[F_AR * B + b], tt_s = fs[F_TT * B + b];
  int mode = iscal[I_MODE * B + b], rej = iscal[I_REJ * B + b];
  int err = iscal[I_ERR * B + b], hit = iscal[I_HIT * B + b];
  int cnt = iscal[I_CNT * B + b];
  T rg[RING];
#pragma unroll
  for (int r = 0; r < RING; ++r) rg[r] = ring[r * B + b];
  __syncthreads();

  const uint32_t seed = (uint32_t)p.seed + (uint32_t)(b / p.tile) * 7919u;
  const uint32_t lane = (uint32_t)(b % p.tile);
  const T inf = (T)INFINITY, zero = (T)0;
  // the frozen-kappa sum of the current mask, after a thread-local partial
  // that every thread posts for its warp
  auto frozen_kappa_partial = [&]() {
    T kf = zero;
    for (int i = tid; i < d; i += nt) kf += sact[i] ? zero : skap[i];
    kf = warp_sum(kf);
    if (lane_w == 0) r_kf[warp] = kf;
  };
  bool redraw_tt = false;  // a reset awaits its thaw clock (next round A)
  T e_tt = zero;           // the reset's Exp(1) draw

  for (int k = 0; k < p.K; ++k) {
    const bool live = lane_live(p, cnt, t_s);  // t_s is the same in every thread
    int kval = 0;
    if (live) {
      if (warp == 0 && lane_w < 5)
        draws[lane_w] = transition_draw<T>(seed, (uint32_t)k, (uint32_t)p.tile, lane, lane_w);
      if (redraw_tt) frozen_kappa_partial();
      if constexpr (Pot::reads_others) {
        // every warp reads other threads' coordinates below (0 and 1, a
        // neighbour across a warp or a tile, a fixed coordinate): wait for
        // their flow, flip, stick and thaw of the previous transition
        __syncthreads();
      }
      // the potential's chain moments (the funnels': over coordinates
      // 1..d-1) on the masked velocity (a stuck coordinate adds its x, 0.0,
      // and nothing else), by a two-level reduction: one more barrier per
      // transition
      typename Pot::Moments mom = Pot::moments_zero(d);
      if constexpr (Pot::chain && !Pot::point) {
        // coordinates 0 and 1, which only a potential with reads_others reads
        const T x0m = sx[0], v0m = masked(sv, sact, 0), x1m = sx[s1];
        const T v1m = masked(sv, sact, s1);
        for (int i = tid; i < d; i += nt)
          Pot::moment_add(mom, i, sx[i], masked(sv, sact, i), x0m, v0m, x1m, v1m, prm);
#pragma unroll
        for (int q = 0; q < Pot::Moments::N; ++q) mom.m[q] = warp_sum(mom.m[q]);
        if (lane_w == 0) {
#pragma unroll
          for (int q = 0; q < Pot::Moments::N; ++q) r_mom[q][warp] = mom.m[q];
        }
        __syncthreads();
#pragma unroll
        for (int q = 0; q < Pot::Moments::N; ++q) mom.m[q] = across_warps(r_mom[q], nw);
      }

      // the point x + va t, read by coordinate (the accessor a potential's
      // fill and at take)
      auto point_at = [&](T t) {
        return [&, t](int j, T& y, T& w) {
          w = masked(sv, sact, j);
          y = sx[j] + w * t;
        };
      };
      // the potential's sums at time t: from the moments, or for a point
      // potential every sum and product formed at x + va t by the block
      // (every thread calls it: the branches around it are uniform)
      auto sums_at = [&](T t) {
        if constexpr (Pot::point) {
          return Pot::fill(d, prm, ctx, point_at(t));
        } else {
          return mom.at(t);
        }
      };

      // ---- round A: envelope on [0, bh], tangent-intersection segment maxima ----
      const T step = bh_s / (T)G;
      // coordinates 0 and 1 (masked velocities), read once: Banana and the
      // funnels read them
      const T x0 = sx[0], v0 = masked(sv, sact, 0), x1 = sx[s1], v1 = masked(sv, sact, s1);
      // coordinate i's rate pair at time tj with the sums cs at tj
      auto pair_at = [&](int i, T xi, T va, T tj, const typename Pot::Sums& cs, T& f, T& gd) {
        T g, dg;
        Pot::at(i, xi, va, x0, v0, x1, v1, tj, prm, cs, point_at(tj), g, dg);
        f = g * va;
        gd = dg * va;
        if (!p.signed_bound) {
          // d/dt max(r, 0): JAX's JVP takes half the tangent at r == 0
          const T coef = f > zero ? (T)1 : (f == zero ? (T)0.5 : zero);
          gd = gd * coef;
          f = nmax(f, zero);
        }
      };
      // A point potential takes the grid outer, to form its context once a
      // grid point; the tags and the moment potentials keep the tiles
      // outer: the grid-outer loop, with POINT_TILES pairs live across the
      // grid, took K6 at sticky_zigzag_d1000 (d = 1000, one tile) from
      // 0.406 to 0.600 ms a K=32 launch on the H100 (chip_ab.py).  Both add
      // each coordinate's terms and each segment's partials in the same
      // order, so they give the same bits.
      if constexpr (Pot::point) {
        // a point potential: its context at each grid point by the block,
        // then every coordinate's pair; each tile's previous pair is kept
        T f_prev[POINT_TILES], g_prev[POINT_TILES];
        for (int j = 0; j < n_grid; ++j) {
          const T tj = step * (T)j;
          const auto cs = sums_at(tj);
#pragma unroll
          for (int q = 0; q < POINT_TILES; ++q) {
            const int q0 = q * nt, i = q0 + tid;
            if (q0 >= d) break;  // the same in every thread
            T f = zero, gd = zero;
            if (i < d) pair_at(i, sx[i], masked(sv, sact, i), tj, cs, f, gd);
            if (j > 0) {
              const T seg = warp_sum(i < d ? segment_max(f_prev[q], g_prev[q], f, gd, step)
                                           : zero);
              if (lane_w == 0) {
                T& r = segr[warp * MAXG + j - 1];
                r = q0 == 0 ? seg : r + seg;
              }
            }
            f_prev[q] = f;
            g_prev[q] = gd;
          }
        }
      } else for (int q0 = 0; q0 < d; q0 += nt) {
        const int i = q0 + tid;
        const bool on = i < d;
        const T xi = on ? sx[i] : zero, va = on ? masked(sv, sact, i) : zero;
        T f_prev = zero, g_prev = zero;
        for (int j = 0; j < n_grid; ++j) {
          T f = zero, gd = zero;
          if (on) {
            const T tj = step * (T)j;
            pair_at(i, xi, va, tj, sums_at(tj), f, gd);
          }
          if (j > 0) {
            const T seg = warp_sum(on ? segment_max(f_prev, g_prev, f, gd, step) : zero);
            if (lane_w == 0) {
              T& r = segr[warp * MAXG + j - 1];
              r = q0 == 0 ? seg : r + seg;
            }
          }
          f_prev = f;
          g_prev = gd;
        }
      }
      __syncthreads();
      // every thread takes the draws now: warp 0 rewrites them after round B
      const T u_acc = draws[0], u_flip = draws[1], u_thaw = draws[2], e_draw = draws[3];
      const T e_tt_k = draws[4];
      if (redraw_tt) {  // the previous reset's thaw clock, on its updated mask
        const T rate_thaw = across_warps(r_kf, nw);
        tt_s = rate_thaw > zero ? e_tt / rate_thaw : inf;
        redraw_tt = false;
      }

      // ---- invert the envelope at the Exp clock, segments in grid order ----
      // lane l adds the warp partials of segments l and l + 32 in warp order,
      // the same in every warp; the walk takes them by shuffle
      const T ta = segment_total(segr, lane_w, G, nw);
      const T tb = segment_total(segr, lane_w + 32, G, nw);
      EnvelopeWalk<T> walk(step, exp_s);
      for (int j = 0; j < G; ++j)
        walk.add(__shfl_sync(FULL_MASK, j < 32 ? ta : tb, j & 31) + (T)p.refresh, j);
      T tp, lam_bar;
      bool overflow;
      walk.finish(n_grid, tp, lam_bar, overflow);
      const bool fresh = mode == MODE_FRESH, erroneous = mode == MODE_ERRONEOUS;
      const T tp_safe = overflow ? zero : tp;

      // ---- round B: thinning rate at tp; crossing probe and stick times ----
      const T min_pt = tp < tt_s ? tp : tt_s;
      const T event_time = min_pt < h_s ? min_pt : h_s;
      T lam = zero, tmin = inf;
      int imin = 0x7fffffff, cross = 0;
      const auto cs_tp = sums_at(tp_safe);
      for (int i = tid; i < d; i += nt) {
        T g, dg;
        const T va = masked(sv, sact, i), xi = sx[i], vi = sv[i];
        Pot::at(i, xi, va, x0, v0, x1, v1, tp_safe, prm, cs_tp, point_at(tp_safe), g, dg);
        lam += nmax(g * va, zero);
        cross |= xi * (xi + va * event_time) < zero;
        const T tj = (sact[i] && xi * vi < zero && va != zero) ? -xi / vi : inf;
        argmin_merge(tmin, imin, tj, i);
      }
      lam = warp_sum(lam);
      warp_argmin(tmin, imin);
      if (lane_w == 0) {
        r_lam[warp] = lam;
        r_min[warp] = tmin;
        r_imin[warp] = imin;
      }
      const bool any_cross = __syncthreads_or(cross) != 0;
      const T lam_t = across_warps(r_lam, nw);
      T t_togo = lane_w < nw ? r_min[lane_w] : inf;
      int i_stick = lane_w < nw ? r_imin[lane_w] : 0x7fffffff;
      warp_argmin(t_togo, i_stick);
      const T ar_new = lam_t / lam_bar;

      // ---- decisions (uniform over the block) ----
      const bool p_stick = fresh && any_cross && isfinite(t_togo);
      const bool beyond = min_pt > h_s;
      const bool p_moveh = !p_stick && beyond && !erroneous;
      const bool p_erreset = !p_stick && beyond && erroneous;
      const bool thin = !p_stick && !beyond;
      const bool p_thaw = thin && tt_s <= tp;
      const bool p_ac = thin && tp < tt_s;
      const bool p_err = p_ac && (ar_new > (T)1);
      const bool p_proxy = p_ac && !p_err;
      const bool acc = u_acc < ar_new;
      const bool p_acc = p_proxy && acc;
      const bool p_rej = p_proxy && !acc;

      // ---- flow on the masked velocity; the latent v survives ----
      const T flow_t = p_stick ? t_togo
                       : p_thaw ? tt_s
                       : p_moveh ? h_s
                       : p_acc ? tp_safe : zero;
      for (int i = tid; i < d; i += nt) sx[i] = sx[i] + masked(sv, sact, i) * flow_t;
      __syncwarp();  // Banana's y0 and y1, flowed by threads 0 and 1

      // ---- round C: inverse-CDF coordinate flip on the masked rates ----
      if (p_acc) {
        // coordinates 0 and 1 flowed: the funnels and a generated potential
        // with reads_others read them in every warp, so each thread flows
        // them in registers as threads 0 and 1 flow them; Banana reads them
        // in warp 0 after the __syncwarp
        constexpr bool every_warp = Pot::chain || Pot::reads_others;
        const T x0n = every_warp ? x0 + v0 * flow_t : sx[0];
        const T x1n = every_warp ? x1 + v1 * flow_t : sx[s1];
        // a point potential forms its sums at the flowed x (the block's
        // barrier in fill publishes the flow)
        const auto cs_fl = [&] {
          if constexpr (Pot::point) {
            return sums_at(zero);
          } else {
            return mom.at(flow_t);
          }
        }();
        if constexpr (Pot::reads_others && !Pot::point) {
          // the flowed x of other threads' coordinates, read through the
          // accessor (a point potential's fill took this barrier)
          __syncthreads();
        }
        for (int i = tid; i < d; i += nt) {
          T g, dg;
          const T va = masked(sv, sact, i);
          Pot::at(i, sx[i], va, x0n, v0, x1n, v1, zero, prm, cs_fl, point_at(zero), g, dg);
          sw[i] = nmax(g * va, zero);
        }
        const int m = categorical(sw, d, u_flip, wtot, r_cnt, nw);
        if (m % nt == tid) sv[m] = -sv[m];
      }

      // ---- stick and thaw updates of the activity mask ----
      if (p_stick && i_stick % nt == tid) sact[i_stick] = 0;
      if (p_thaw) {
        for (int i = tid; i < d; i += nt) sw[i] = sact[i] ? zero : skap[i];
        const int i_thaw = categorical(sw, d, u_thaw, wtot, r_cnt, nw);
        if (i_thaw % nt == tid) sact[i_thaw] = 1;
      }

      // ---- Kahan time commit, horizon adaptation ----
      const T inc = (p_stick ? t_togo : (p_thaw ? tt_s : tp_safe)) + ts_s;
      const T y = inc - tc_s;
      const T s_sum = t_s + y;
      const T tc_k = (s_sum - t_s) - y;
      const bool is_event = p_acc || p_stick || p_thaw;
      T h_new = h_s;
      if (p.adaptive) {
        if (p_moveh && fresh) h_new = h_new * (T)1.01;
        if (p_err) h_new = h_new * (T)0.5;
        if (p_rej) h_new = h_new / (T)1.04;
      }

      // ---- counters, error ring, proposal bookkeeping, thaw clock ----
      hit += p_moveh;
      rej += p_rej;
      err += p_err;
      const int ring_idx = err % RING;
#pragma unroll
      for (int r = 0; r < RING; ++r)
        if (p_err && ring_idx == r) rg[r] = ar_new;
      const bool reset = p_stick || p_moveh || p_erreset || p_thaw || p_acc;
      if (reset) {
        // a fresh thaw clock Exp(1) / sum(kappa[frozen]) on the updated mask,
        // reduced in the next round A (or after the last transition)
        redraw_tt = true;
        e_tt = e_tt_k;
      }
      exp_s = (reset || p_err) ? e_draw : (p_rej ? exp_s + e_draw : exp_s);
      mode = reset ? MODE_FRESH
                   : (p_err ? MODE_ERRONEOUS : (p_rej ? MODE_REJECTED : mode));
      bh_s = reset ? h_new : (p_err ? h_s * (T)0.5 : bh_s);
      if (p_ac) ar_s = ar_new;
      if (is_event) {
        t_s = s_sum;
        tc_s = tc_k;
        ts_s = zero;
      } else if (p_moveh) {
        ts_s = ts_s + h_s;
      }
      h_s = h_new;
      kval = p_acc ? EV_JUMP : (p_stick ? EV_STICK : (p_thaw ? EV_THAW : 0));
      cnt += kval > 0;
      __syncwarp();  // Banana's v and act of coordinates 0 and 1, for the next envelope
    }

    // ---- emit the event row (a finished chain repeats its frozen row) ----
    const long row = (long)k;
    for (int i = tid; i < d; i += nt) {
      const long e = (row * d + i) * B + b;
      ev_x[e] = sx[i];
      ev_v[e] = sv[i];
      ev_act[e] = sact[i];
    }
    if (tid == 0) {
      ev_kind[(row * 4 + 0) * B + b] = kval;
      ev_kind[(row * 4 + 1) * B + b] = rej;
      ev_kind[(row * 4 + 2) * B + b] = err;
      ev_kind[(row * 4 + 3) * B + b] = hit;
      ev_fs[(row * 3 + 0) * B + b] = t_s + ts_s;
      ev_fs[(row * 3 + 1) * B + b] = h_s;
      ev_fs[(row * 3 + 2) * B + b] = ar_s;
#pragma unroll
      for (int r = 0; r < RING; ++r) ev_ring[(row * RING + r) * B + b] = rg[r];
    }

    // counters reset after a recorded event
    if (kval > 0) {
      rej = err = hit = 0;
#pragma unroll
      for (int r = 0; r < RING; ++r) rg[r] = zero;
    }
  }
  if (redraw_tt) {  // the last reset's thaw clock
    frozen_kappa_partial();
    __syncthreads();
    const T rate_thaw = across_warps(r_kf, nw);
    tt_s = rate_thaw > zero ? e_tt / rate_thaw : inf;
  }

  for (int i = tid; i < d; i += nt) {
    x[i * B + b] = sx[i];
    v[i * B + b] = sv[i];
    act[i * B + b] = sact[i];
  }
  if (tid == 0) {
    fs[F_T * B + b] = t_s;
    fs[F_TC * B + b] = tc_s;
    fs[F_TS * B + b] = ts_s;
    fs[F_H * B + b] = h_s;
    fs[F_BH * B + b] = bh_s;
    fs[F_EXP * B + b] = exp_s;
    fs[F_AR * B + b] = ar_s;
    fs[F_TT * B + b] = tt_s;
    iscal[I_MODE * B + b] = mode;
    iscal[I_REJ * B + b] = rej;
    iscal[I_ERR * B + b] = err;
    iscal[I_HIT * B + b] = hit;
    iscal[I_CNT * B + b] = cnt;
#pragma unroll
    for (int r = 0; r < RING; ++r) ring[r * B + b] = rg[r];
  }
}

// Largest d whose dynamic shared memory fits beside the kernel's static
// reduction rows (16 bytes kept for the alignment of the dynamic part).
template <typename T>
long max_dim() {
  cudaFuncAttributes a;  // the funnels' kernels carry the largest static rows
#ifdef PDMPFLUX_USER_POTENTIAL
  using Pot = UserPotential<T>;
  if constexpr (!user_scalar<T>) {
    return 0;  // a generated potential's library runs its own dtype alone
  } else {
#else
  using Pot = Funnel<T>;
  {
#endif
    if (cudaFuncGetAttributes(&a, sticky_chunk_kernel<T, Pot>) != cudaSuccess) return 0;
    // a point potential's context follows the chain's arrays (16 bytes more
    // for its alignment), and its envelope keeps POINT_TILES tiles
    const long ctx = Pot::shared_bytes > 0 ? Pot::shared_bytes + 16 : 0;
    const long m = (SMEM_BLOCK - (long)a.sharedSizeBytes - 16 - ctx) / bytes_per_coord<T>();
    return Pot::point && m > (long)POINT_TILES * MAXT ? (long)POINT_TILES * MAXT : m;
  }
}

template <typename T, class Pot>
int launch(const Params& p, const void* prm, void* x, void* v, void* fs, void* iscal,
           void* ring, void* act, void* kappa, void* ev_kind, void* ev_x, void* ev_v,
           void* ev_fs, void* ev_ring, void* ev_act, cudaStream_t stream) {
  if (p.d > max_dim<T>()) return (int)cudaErrorInvalidValue;
  const int threads = p.d >= MAXT ? MAXT : (p.d + 31) / 32 * 32;
  const size_t smem = Pot::shared_bytes > 0 ? (size_t)(ctx_offset<T>(p.d) + Pot::shared_bytes)
                                            : (size_t)(p.d * bytes_per_coord<T>());
  auto kern = sticky_chunk_kernel<T, Pot>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<p.B, threads, smem, stream>>>(
      p, (const T*)prm, (T*)x, (T*)v, (T*)fs, (int*)iscal, (T*)ring, (uint8_t*)act,
      (const T*)kappa, (int*)ev_kind, (T*)ev_x, (T*)ev_v, (T*)ev_fs, (T*)ev_ring, (uint8_t*)ev_act);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int potential, const Params& p, const void* prm, void* x, void* v, void* fs,
             void* iscal, void* ring, void* act, void* kappa, void* ev_kind, void* ev_x,
             void* ev_v, void* ev_fs, void* ev_ring, void* ev_act, cudaStream_t s) {
  return with_potential<T>(potential, prm, [&](auto pot) {
    return launch<T, decltype(pot)>(p, prm, x, v, fs, iscal, ring, act, kappa, ev_kind,
                                    ev_x, ev_v, ev_fs, ev_ring, ev_act, s);
  });
}

}  // namespace

extern "C" long sticky_chunk_max_dim(int f64) {
  return f64 ? max_dim<double>() : max_dim<float>();
}

extern "C" int sticky_chunk_launch(int f64, int potential, int d, int B, int K, int n_grid,
                                   int adaptive, int signed_bound, double refresh, int cap,
                                   int tile, int seed, int horizon, float t_target,
                                   const void* prm, void* x, void* v, void* fs,
                                   void* iscal, void* ring, void* act, void* kappa,
                                   void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
                                   void* ev_ring, void* ev_act, void* stream) {
  if (n_grid < 2 || n_grid > MAXG || d < 1 || B < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  Params p{d, B, K, n_grid, adaptive, signed_bound, cap, tile, seed, refresh,
           horizon, t_target};
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? dispatch<double>(potential, p, prm, x, v, fs, iscal, ring, act, kappa,
                                ev_kind, ev_x, ev_v, ev_fs, ev_ring, ev_act, s)
             : dispatch<float>(potential, p, prm, x, v, fs, iscal, ring, act, kappa,
                               ev_kind, ev_x, ev_v, ev_fs, ev_ring, ev_act, s);
}

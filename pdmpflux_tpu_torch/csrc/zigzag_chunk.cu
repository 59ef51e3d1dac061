// K1: K fused Zig-Zag transitions per chain, a group of L lanes per chain.
//
// Replaces pdmpflux_tpu/ops/pallas/zigzag_chunk.py:run_chunk (body
// _make_kernel) with kind="zigzag", sticky=False, in both modes: "events"
// and "horizon" (K7: a chain also freezes once its committed clock reaches
// the float32 target, lane_live in pdmp_common.cuh).  The plain PyTorch
// version is run_chunk_plain in ops/cuda/zigzag_chunk.py; both draw the same
// Threefry-2x32 counters as the Pallas kernel (key (seed + tile * 7919,
// salt), counter row * tile + lane), so trajectories agree to rounding.
//
// What bounds it on an H100: latency and issue.  Per transition a chain
// evaluates the gradient at 2 (n_grid - 1) + 2 points per coordinate, takes
// n_grid - 1 segment maxima per coordinate (one IEEE divide each) and draws
// three Threefry blocks, against (2 d + 12) * sizeof(T) bytes of event row.
// The first design gave each chain one thread: 100 dependent segment maxima
// per transition at d = 10, box[] and cum[] in local memory, x and v re-read
// from device memory, and at B = 8192 two warps per SM (one at B = 4096),
// too few to hide a dependent chain.
//
// Design.  A group of L consecutive lanes (L a power of two, 32 / L chains to
// a warp) owns one chain for all K transitions; the chain's x and v sit in
// the group's slice of shared memory beside its row of segment boxes (read
// in place in the (d, B) state where a block's copies pass 227 KB, so d has
// no limit).  Each lane of a group:
//  - envelope: takes segments lg, lg + L, ... of the grid; for the linear
//    flow a segment's two ends are independent evaluations at x + v t_j and
//    x + v t_{j+1}, so the lane needs nothing from its neighbours; it adds
//    the segment's maxima over the coordinates in coordinate order, as the
//    first design did, and posts the box to the row;
//  - clock inversion: every lane walks the row in grid order, adding the
//    cumulative sum (EnvelopeWalk in pdmp_common.cuh), so tp, lam_bar and
//    the overflow, and every decision after them, come out the same in
//    every lane of the group;
//  - thinning, the flip's rates and the flow: take a contiguous run of
//    ceil(d / L) coordinates; sums over the group go by an xor butterfly
//    (the same bits in every lane), the flip's prefix sums by a group scan of
//    the lanes' totals, then c <= u * c[d - 1] is counted and clamped to
//    d - 1, as _categorical_rows does;
//  - draws: lane 0 draws the acceptance uniform, lane 1 the flip uniform and
//    lane 2 the Exp clock (transition_draw), one Threefry block in the same
//    instructions, and shuffles them to the group (L = 2: every lane draws
//    the clock itself).
// The funnels' coordinate 0 reads sums over the chain's other coordinates
// at every time a transition evaluates (pdmp_common.cuh: ChainSums): at the
// start of a transition each lane adds x_j^2, x_j v_j and v_j^2 over its
// run [i0, i1) less coordinate 0 and group_sum gives the group their
// totals (ChainMoments), from which the linear flow gives S and P at every
// grid point, at tp and at flow_t in a few operations; the plain version
// sums at each point itself, so the two agree to rounding.  A potential
// generated from a user's gradient (ops/cuda/lower.py) reduces the Taylor
// terms of each of its sums' summands the same way (moment_add) where they
// are of degree at most 2 in t.  Its products with a constant matrix whose
// input is affine in the point (Pot::NP > 0) are affine in t along the
// flow, so the group forms them once per transition, beside the moments:
// each lane forms its run of every product's rows, c0 = M u(x) and
// c1 = M du(x; v), each row added in column order as the plain version
// adds it (Pot::form), into the group's shared copy beside x and v (or the
// (NP, B) scratch at stride B where x and v are read in place), and after a
// __syncwarp every point reads element r as c0[r] + t c1[r] through the
// point's accessor (Transition).  Splitting the rows over the group pays
// because the product serves every point of the transition.  Any other
// stage (a sum of higher degree, a product after a nonlinearity:
// Pot::point) is formed at each point by the lane that evaluates it
// (Pot::sums, every element added in index order as the plain version adds
// it): a lane's envelope points are its own, and thinning and the flip,
// where every lane of the group reads the same point, take 2 of the
// transition's 2 (n_grid - 1) + 2 points, so each lane forms those itself
// rather than splitting their rows and reducing d partial gradients over
// the group at each of them.
// A generated potential reads a neighbour or a fixed coordinate through
// the accessor of the point (linear_point), from the group's copy of x and
// v (or the state at stride B): another lane's coordinate, which the
// __syncwarp after the previous flow published and which no lane writes
// before the __syncwarp ahead of this transition's flow.
// For the tags and the moment potentials no array is indexed at run time,
// so nothing lands in local memory.  A point potential's context (a
// segment's two Sums, alive at once, and its per-point products' inputs)
// is indexed in loops past lower.UNROLL steps and then lives in the lane's
// local memory (Lowered.lane_bytes, at most lower.LANE_BYTES).  Every
// shuffle and __syncwarp names only the group's lanes, so a group that is
// frozen, or past B at the ragged end of the last warp, skips its
// transitions or leaves without stalling the other groups of its warp.  The
// plain version sums with torch.sum, so the kernel agrees with it to
// rounding, not bit for bit.
//
// Lanes per chain (lanes_for): the fewest that give the card 12 warps per
// SM.  Measured per K=32 launch on the H100 (chip_ab.py --lanes), L = 2, 4,
// 8, 16: B = 8192 (flagship) 0.241, 0.180, 0.183, 0.237 ms; B = 4096
// (horizon) 0.240, 0.162, 0.140, 0.125 ms.  The rule takes 8 and 16 there,
// within 2% of the best at B = 8192 and the best at B = 4096; more lanes
// split the envelope further but repeat the walk, the draws and the
// scalar tail in more lanes, so past enough warps they cost issue slots.

#define PDMPFLUX_ERROR_STRING  // the kernels' library takes its message function from here
#include "pdmp_common.cuh"

namespace {

using namespace pdmp;

constexpr long SMEM_BLOCK = 232448;  // bytes of shared memory one block may use
constexpr long SMEM_SM = 233472;     // bytes of shared memory an SM may carve out of L1

// Sum over the group's L lanes; every lane gets the same bits (each step
// adds two values that both lanes of the pair hold).
template <int L, typename U>
__device__ __forceinline__ U group_sum(U v, unsigned mask) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(mask, v, o, L);
  return v;
}

// Inclusive prefix sum over the group's lanes in lane order.
template <int L, typename T>
__device__ __forceinline__ T group_scan(T v, unsigned mask, int lg) {
#pragma unroll
  for (int o = 1; o < L; o <<= 1) {
    const T y = __shfl_up_sync(mask, v, o, L);
    if (lg >= o) v += y;
  }
  return v;
}

// Bytes of dynamic shared memory a block of `threads` lanes takes: each
// chain's box row and, where they fit, its x and v and the np values its
// potential forms once per transition.
template <typename T, int L>
long smem_bytes(int d, int np, int threads, bool xv) {
  return (long)(threads / L) * (MAXG + (xv ? 2L * d + np : 0)) * (long)sizeof(T);
}

template <typename T, class Pot, int L>
__global__ void zigzag_chunk_kernel(Params p, int in_smem, const T* __restrict__ prm,
                                    T* __restrict__ x,
                                    T* __restrict__ v, T* __restrict__ fs,
                                    int* __restrict__ iscal, T* __restrict__ ring,
                                    int* __restrict__ ev_kind, T* __restrict__ ev_x,
                                    T* __restrict__ ev_v, T* __restrict__ ev_fs,
                                    T* __restrict__ ev_ring, T* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long B = p.B;
  const long b = ((long)blockIdx.x * blockDim.x + threadIdx.x) / L;
  if (b >= B) return;  // a whole group leaves: its shuffles name only its lanes
  const int lg = threadIdx.x & (L - 1), cg = threadIdx.x / L;
  const unsigned gmask = ((1u << L) - 1) << ((threadIdx.x & 31) & ~(L - 1));
  const int d = p.d, n_grid = p.n_grid, G = p.n_grid - 1;
  // the chain's box row, then its x and v and its per-transition values: the
  // group's shared copy, or in place in the (d, B) state and the (NP, B)
  // scratch at stride B
  T* box = (T*)smem + (long)cg * (MAXG + (in_smem ? 2 * d + Pot::NP : 0));
  const long sx = in_smem ? 1 : B;
  T* xb = in_smem ? box + MAXG : x + b;
  T* vb = in_smem ? xb + d : v + b;
  T* pv = in_smem ? vb + d : scratch + b;
  const long s1 = d > 1 ? sx : 0;  // coordinate 1's offset (Banana reads it)
  // this lane's coordinates [i0, i1) for thinning, the flip and the flow
  const int per = (d + L - 1) / L;
  const int i0 = min(d, lg * per), i1 = min(d, i0 + per);
  if (in_smem) {
    for (int i = i0; i < i1; ++i) {
      xb[i] = x[i * B + b];
      vb[i] = v[i * B + b];
    }
    __syncwarp(gmask);
  }

  T t_s = fs[F_T * B + b], tc_s = fs[F_TC * B + b], ts_s = fs[F_TS * B + b];
  T h_s = fs[F_H * B + b], bh_s = fs[F_BH * B + b], exp_s = fs[F_EXP * B + b];
  T ar_s = fs[F_AR * B + b];
  int mode = iscal[I_MODE * B + b], rej = iscal[I_REJ * B + b];
  int err = iscal[I_ERR * B + b], hit = iscal[I_HIT * B + b];
  int cnt = iscal[I_CNT * B + b];
  T rg[RING];
#pragma unroll
  for (int r = 0; r < RING; ++r) rg[r] = ring[r * B + b];

  // chunk seed + tile * 7919 in int32 (wrapping), as a uint32 key word
  const uint32_t seed = (uint32_t)p.seed + (uint32_t)(b / p.tile) * 7919u;
  const uint32_t lane = (uint32_t)(b % p.tile);
  const T zero = (T)0, refresh = (T)p.refresh;

  for (int k = 0; k < p.K; ++k) {
    const bool live = lane_live(p, cnt, t_s);  // the same in every lane of the group
    int kval = 0;
    if (live) {
      // ---- the transition's draws, one Threefry block per lane ----
      const T mine = transition_draw<T>(seed, (uint32_t)k, (uint32_t)p.tile, lane,
                                        L >= 4 ? (lg < 2 ? lg : 3) : lg);
      const T u_acc = __shfl_sync(gmask, mine, 0, L);
      const T u_flip = __shfl_sync(gmask, mine, 1, L);
      const T e_draw = L >= 4 ? __shfl_sync(gmask, mine, 2, L)
                              : transition_draw<T>(seed, (uint32_t)k, (uint32_t)p.tile,
                                                   lane, 3);
      const T x0 = xb[0], v0 = vb[0], x1 = xb[s1], v1 = vb[s1];
      // the products formed once per transition: this lane's run of their
      // rows, read by every lane of the group after the __syncwarp
      if constexpr (Pot::NP > 0) {
        Pot::form(d, lg, L, prm, start_point(xb, vb, sx), pv, sx);
        __syncwarp(gmask);
      }
      const Transition<T> tr = transition(pv, sx);
      // the potential's chain moments (the funnels': over coordinates
      // 1..d-1), summed over the group (the same bits in every lane); its
      // sums at time t follow
      typename Pot::Moments mom = Pot::moments_zero(d);
      if constexpr (Pot::chain && !Pot::point) {
        for (int i = i0; i < i1; ++i)
          Pot::moment_add(mom, i, xb[i * sx], vb[i * sx], x0, v0, x1, v1, prm);
#pragma unroll
        for (int q = 0; q < Pot::Moments::N; ++q) mom.m[q] = group_sum<L>(mom.m[q], gmask);
      }
      using Sums = typename Pot::Sums;
      // the potential's sums at time t: from the moments, or for a point
      // potential every stage formed at x + v t by this lane
      auto sums_at = [&](T t) -> Sums {
        if constexpr (Pot::point) {
          return Pot::sums(d, prm, linear_point(xb, vb, sx, t, tr.at(t)));
        } else {
          return mom.at(t);
        }
      };
      // coordinate i's rate along v and its time derivative at time t, with
      // the chain sums cs at t; a neighbour the potential reads is another
      // lane's coordinate, which the __syncwarp after the last flow published
      auto rate = [&](int i, T xi, T vi, T t, const Sums& cs, T& f, T& gd) {
        T g, dg;
        Pot::at(i, xi, vi, x0, v0, x1, v1, t, prm, cs, linear_point(xb, vb, sx, t, tr.at(t)), g,
                dg);
        f = g * vi;
        gd = dg * vi;
      };

      // ---- envelope on [0, bh]: this lane's segments, coordinates in order ----
      const T step = bh_s / (T)G;
      for (int j = lg; j < G; j += L) {  // segment j: grid points j and j + 1
        const T t0 = step * (T)j, t1 = step * (T)(j + 1);
        const Sums cs0 = sums_at(t0), cs1 = sums_at(t1);
        T sum = zero;
        for (int i = 0; i < d; ++i) {
          const T xi = xb[i * sx], vi = vb[i * sx];
          T f0, g0, f1, g1;
          rate(i, xi, vi, t0, cs0, f0, g0);
          rate(i, xi, vi, t1, cs1, f1, g1);
          if (!p.signed_bound) {
            // d/dt max(r, 0): JAX's JVP takes half the tangent at r == 0
            g0 = g0 * (f0 > zero ? (T)1 : (f0 == zero ? (T)0.5 : zero));
            g1 = g1 * (f1 > zero ? (T)1 : (f1 == zero ? (T)0.5 : zero));
            f0 = nmax(f0, zero);
            f1 = nmax(f1, zero);
          }
          sum += segment_max(f0, g0, f1, g1, step);
        }
        box[j] = sum + refresh;
      }
      __syncwarp(gmask);  // every box of the chain is in its row

      // ---- invert the envelope at the Exp clock, boxes in grid order ----
      EnvelopeWalk<T> walk(step, exp_s);
      for (int j = 0; j < G; ++j) walk.add(box[j], j);
      T tp, lam_bar;
      bool overflow;
      walk.finish(n_grid, tp, lam_bar, overflow);
      const bool fresh = mode == MODE_FRESH, erroneous = mode == MODE_ERRONEOUS;
      const T tp_safe = overflow ? zero : tp;

      // ---- thinning at tp on the unsigned rate ----
      T lam = zero;
      const Sums cs_tp = sums_at(tp_safe);
      for (int i = i0; i < i1; ++i) {
        T f, gd;
        rate(i, xb[i * sx], vb[i * sx], tp_safe, cs_tp, f, gd);
        lam += nmax(f, zero);
      }
      const T lam_t = group_sum<L>(lam, gmask);
      const T ar_new = lam_t / lam_bar;

      const bool beyond = tp > h_s;
      const bool p_moveh = beyond && !erroneous;
      const bool p_erreset = beyond && erroneous;
      const bool p_ac = !beyond;
      const bool p_err = p_ac && (ar_new > (T)1);
      const bool p_proxy = p_ac && !p_err;
      const bool acc = u_acc < ar_new;
      const bool p_acc = p_proxy && acc;
      const bool p_rej = p_proxy && !acc;

      // ---- the inverse-CDF flip coordinate on the rates at flow_t ----
      const T flow_t = p_moveh ? h_s : (p_acc ? tp_safe : zero);
      int m = -1;
      if (p_acc) {  // the same in every lane of the group
        const Sums cs_fl = sums_at(flow_t);
        T own = zero;  // this lane's rates, added in coordinate order
        for (int i = i0; i < i1; ++i) {
          T f, gd;
          rate(i, xb[i * sx], vb[i * sx], flow_t, cs_fl, f, gd);
          own += nmax(f, zero);
        }
        // c_i = pre + (this lane's rates up to i): pre sums the lower lanes
        const T incl = group_scan<L>(own, gmask, lg);
        T pre = __shfl_up_sync(gmask, incl, 1, L);
        if (lg == 0) pre = zero;
        const T total = __shfl_sync(gmask, pre + own, (d - 1) / per, L);  // c[d - 1]
        const T thresh = u_flip * total;
        T c = zero;
        int n_le = 0;
        for (int i = i0; i < i1; ++i) {
          T f, gd;
          rate(i, xb[i * sx], vb[i * sx], flow_t, cs_fl, f, gd);
          c += nmax(f, zero);
          n_le += pre + c <= thresh;
        }
        n_le = group_sum<L>(n_le, gmask);
        m = n_le < d - 1 ? n_le : d - 1;
      }

      // ---- flow, then the flip, on this lane's coordinates ----
      __syncwarp(gmask);  // the group has read x and v (every lane's) for this transition
      for (int i = i0; i < i1; ++i) {
        const T vi = vb[i * sx];
        xb[i * sx] = xb[i * sx] + vi * flow_t;
        if (i == m) vb[i * sx] = -vi;
      }

      // ---- Kahan time commit, horizon adaptation ----
      const T inc = tp_safe + ts_s;
      const T y = inc - tc_s;
      const T s_sum = t_s + y;
      const T tc_k = (s_sum - t_s) - y;
      T h_new = h_s;
      if (p.adaptive) {
        if (p_moveh && fresh) h_new = h_new * (T)1.01;
        if (p_err) h_new = h_new * (T)0.5;
        if (p_rej) h_new = h_new / (T)1.04;
      }

      // ---- counters, error ring, proposal bookkeeping ----
      hit += p_moveh;
      rej += p_rej;
      err += p_err;
      const int ring_idx = err % RING;
#pragma unroll
      for (int r = 0; r < RING; ++r)
        if (p_err && ring_idx == r) rg[r] = ar_new;
      const bool reset = p_moveh || p_erreset || p_acc;
      exp_s = (reset || p_err) ? e_draw : (p_rej ? exp_s + e_draw : exp_s);
      mode = reset ? MODE_FRESH
                   : (p_err ? MODE_ERRONEOUS : (p_rej ? MODE_REJECTED : mode));
      bh_s = reset ? h_new : (p_err ? h_s * (T)0.5 : bh_s);
      if (p_ac) ar_s = ar_new;
      if (p_acc) {
        t_s = s_sum;
        tc_s = tc_k;
        ts_s = zero;
      } else if (p_moveh) {
        ts_s = ts_s + h_s;
      }
      h_s = h_new;
      kval = p_acc ? EV_JUMP : 0;
      cnt += kval > 0;
    }

    // ---- emit the event row (a finished chain repeats its frozen row) ----
    const long row = (long)k;
    for (int i = i0; i < i1; ++i) {
      ev_x[(row * d + i) * B + b] = xb[i * sx];
      ev_v[(row * d + i) * B + b] = vb[i * sx];
    }
    if (lg == 0) {
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
    __syncwarp(gmask);  // x and v as the group wrote them, for the next envelope
  }

  if (in_smem) {
    for (int i = i0; i < i1; ++i) {
      x[i * B + b] = xb[i];
      v[i * B + b] = vb[i];
    }
  }
  if (lg == 0) {
    fs[F_T * B + b] = t_s;
    fs[F_TC * B + b] = tc_s;
    fs[F_TS * B + b] = ts_s;
    fs[F_H * B + b] = h_s;
    fs[F_BH * B + b] = bh_s;
    fs[F_EXP * B + b] = exp_s;
    fs[F_AR * B + b] = ar_s;
    iscal[I_MODE * B + b] = mode;
    iscal[I_REJ * B + b] = rej;
    iscal[I_ERR * B + b] = err;
    iscal[I_HIT * B + b] = hit;
    iscal[I_CNT * B + b] = cnt;
#pragma unroll
    for (int r = 0; r < RING; ++r) ring[r * B + b] = rg[r];
  }
}

int forced_lanes = 0;  // zigzag_chunk_set_lanes: 0 keeps the rule

// Lanes per chain: the fewest (from 2, at most 16) with B * L >= 132 * 12 *
// 32, 12 warps on each of the card's SMs (readings in the note above).
int lanes_for(int B) {
  if (forced_lanes) return forced_lanes;
  int L = 2;
  while (L < 16 && (long)B * L < 132L * 12 * 32) L *= 2;
  return L;
}

template <typename T, class Pot, int L>
int launch_lanes(const Params& p, const void* prm, void* x, void* v, void* fs, void* iscal,
                 void* ring, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
                 void* ev_ring, void* scratch, cudaStream_t stream) {
  const long lanes = (long)p.B * L;
  // 128-thread blocks where they fill the card's 132 SMs, else one warp each
  const int threads = lanes >= 132L * 128 ? 128 : 32;
  const int blocks = (int)((lanes + threads - 1) / threads);
  const bool in_smem = smem_bytes<T, L>(p.d, Pot::NP, threads, true) <= SMEM_BLOCK;
  if (!in_smem && Pot::NP > 0 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  const long smem = smem_bytes<T, L>(p.d, Pot::NP, threads, in_smem);
  auto kern = zigzag_chunk_kernel<T, Pot, L>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (Pot::NP > 0) {
    // the per-transition values make a block's shared memory large, and by
    // default the card carves out enough for every block an SM could hold,
    // leaving little L1 for the parameters each point reads (a data matrix;
    // the logistic regression's launch ran 1.4x slower so, PERF.md): ask for
    // the blocks this launch puts on an SM at once, and no more
    int dev = 0, sms = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
    if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return (int)e;
    const long per_sm = ((blocks + sms - 1) / sms) * (smem + 1024);
    const int pct = (int)(per_sm >= SMEM_SM ? 100 : (per_sm * 100 + SMEM_SM - 1) / SMEM_SM);
    e = cudaFuncSetAttribute(kern, cudaFuncAttributePreferredSharedMemoryCarveout, pct);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<blocks, threads, smem, stream>>>(
      p, (int)in_smem, (const T*)prm, (T*)x, (T*)v, (T*)fs, (int*)iscal, (T*)ring, (int*)ev_kind,
      (T*)ev_x, (T*)ev_v, (T*)ev_fs, (T*)ev_ring, (T*)scratch);
  return (int)cudaGetLastError();
}

template <typename T, class Pot>
int launch(const Params& p, const void* prm, void* x, void* v, void* fs, void* iscal,
           void* ring, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs, void* ev_ring,
           void* scratch, cudaStream_t s) {
  switch (lanes_for(p.B)) {
    case 2:
      return launch_lanes<T, Pot, 2>(p, prm, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v,
                                     ev_fs, ev_ring, scratch, s);
    case 4:
      return launch_lanes<T, Pot, 4>(p, prm, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v,
                                     ev_fs, ev_ring, scratch, s);
    case 8:
      return launch_lanes<T, Pot, 8>(p, prm, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v,
                                     ev_fs, ev_ring, scratch, s);
    case 16:
      return launch_lanes<T, Pot, 16>(p, prm, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v,
                                      ev_fs, ev_ring, scratch, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch(int potential, const Params& p, const void* prm, void* x, void* v, void* fs,
             void* iscal, void* ring, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
             void* ev_ring, void* scratch, cudaStream_t s) {
  return with_potential<T>(potential, prm, [&](auto pot) {
    return launch<T, decltype(pot)>(p, prm, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v,
                                    ev_fs, ev_ring, scratch, s);
  });
}

}  // namespace

extern "C" int zigzag_chunk_launch(int f64, int potential, int d, int B, int K,
                                   int n_grid, int adaptive, int signed_bound,
                                   double refresh, int cap, int tile, int seed,
                                   int horizon, float t_target, const void* prm,
                                   void* x, void* v, void* fs, void* iscal, void* ring,
                                   void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
                                   void* ev_ring, void* scratch, void* stream) {
  if (n_grid < 2 || n_grid > MAXG || d < 1 || B < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  Params p{d, B, K, n_grid, adaptive, signed_bound, cap, tile, seed, refresh,
           horizon, t_target};
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? dispatch<double>(potential, p, prm, x, v, fs, iscal, ring, ev_kind, ev_x,
                                ev_v, ev_fs, ev_ring, scratch, s)
             : dispatch<float>(potential, p, prm, x, v, fs, iscal, ring, ev_kind, ev_x,
                               ev_v, ev_fs, ev_ring, scratch, s);
}

// The lanes per chain K1 takes at B chains.
extern "C" int zigzag_chunk_lanes(int B) { return lanes_for(B); }

// Force L lanes per chain (2, 4, 8 or 16; 0 restores the rule), for timing
// the choices against each other (chip_ab.py); returns the previous setting.
extern "C" int zigzag_chunk_set_lanes(int L) {
  if (L != 0 && L != 2 && L != 4 && L != 8 && L != 16) return -1;
  const int prev = forced_lanes;
  forced_lanes = L;
  return prev;
}

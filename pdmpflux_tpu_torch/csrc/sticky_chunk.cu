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
// Design.  K1 runs one thread per chain; the d = 1000 deployment has only
// B = 128 chains, which would be 4 warps on 132 SMs, each thread walking
// (n_grid + 2) * d gradient terms per transition.  Here one CTA owns one chain
// for all K transitions: blockDim = min(256, roundup(d, 32)) threads take the
// coordinates i = tid, tid + blockDim, ...  x, v, act (a byte) and kappa sit
// in shared memory, loaded once per launch and written back at the end; a
// scan buffer of d values beside them holds prefix sums.  The per-chain
// scalars (clocks, horizon, counters, error ring) are replicated in every
// thread, and every decision is taken from reduced values that every thread
// reads from shared memory in the same order, so all threads hold the same
// bits and the block takes uniform branches.  Per transition the reductions
// are: the n_grid - 1 segment sums of the envelope (one pass for all
// segments), the rate sum at tp with the min/argmin of the stick times and
// the OR of the crossings, then on a jump the flip rates' prefix sum and
// count, on a thaw the thaw weights' prefix sum and count, and on every reset
// the sum of kappa over frozen coordinates.  A categorical draw needs the
// inclusive prefix sum in coordinate order: tiles of blockDim consecutive
// coordinates (the strided map puts tile q's coordinate q * blockDim + tid in
// thread tid), each scanned with cub::WarpScan, the warp totals combined
// across warps, plus a running carry; then c <= u * total is counted and
// clamped to d - 1, as _categorical_rows does.  Composing the block scan from
// warp scans lets one instantiation serve every blockDim.
//
// What bounds it on an H100: latency.  A transition carries about ten
// __syncthreads-separated reductions whatever d is, and its event row goes
// out as 4-byte (1-byte for act) stores at stride B per coordinate into the
// chain-minor (K, d, B) fill that K2 and the driver read, one 32-byte sector
// per element unless L2 merges the neighbouring chains' stores.  The design
// keeps everything else on chip (no global traffic inside a transition but
// the row), keeps the reductions to one warp-shuffle tree plus one shared
// exchange each, and folds the crossing OR into __syncthreads_or.  Packing
// several chains per CTA at small d, staging rows for coalesced stores, and
// CUDA graphs over the chunk loop are later work.
//
// Shared memory: d * (4 * sizeof(T) + 1) bytes of dynamic shared memory plus
// a few KB of reduction scratch must fit the 227 KB a block can have, so
// d <= sticky_chunk_max_dim(f64): about 13k in float32, 6.8k in float64.

#include <cub/warp/warp_scan.cuh>

#include "pdmp_common.cuh"

namespace {

using namespace pdmp;

constexpr int MAXT = 256, MAXW = MAXT / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr long SMEM_BLOCK = 232448;   // bytes of shared memory one block may use
constexpr long SMEM_STATIC = 8192;    // reserved for the static reduction scratch

template <typename T>
__host__ __device__ constexpr long bytes_per_coord() {
  return 4 * (long)sizeof(T) + 1;
}

// Masked velocity va_i = v_i * act_i of the chain's shared-memory copy.
template <typename T>
__device__ __forceinline__ T masked(const T* v, const uint8_t* act, int i) {
  return vel(v, act, 1, i);
}

template <typename U>
__device__ __forceinline__ U warp_sum(U v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Sum over the block; every thread returns the same bits (per-warp partials
// added in warp order).  The leading barrier protects red from the previous
// reduction's readers.
template <typename U>
__device__ __forceinline__ U block_sum(U v, U* red, int nw) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  U s = red[0];
  for (int w = 1; w < nw; ++w) s += red[w];
  return s;
}

// (value, index) minimum, the smaller index on equal values.
template <typename T>
__device__ __forceinline__ void argmin_merge(T& v, int& i, T ov, int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Inclusive prefix sum of sw[0..d) in coordinate order, in place; returns
// sw[d - 1].  Thread tid owns coordinate q * blockDim + tid of tile q, which
// it alone reads and writes.
template <typename T>
__device__ T block_scan(T* sw, int d, T* wtot, typename cub::WarpScan<T>::TempStorage* ws,
                        int nw) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, w = tid >> 5;
  T carry = (T)0;
  for (int q0 = 0; q0 < d; q0 += nt) {
    const int i = q0 + tid;
    T incl, agg;
    cub::WarpScan<T>(ws[w]).InclusiveSum(i < d ? sw[i] : (T)0, incl, agg);
    if (lane == 0) wtot[w] = agg;
    __syncthreads();
    T pre = carry, tile_end = carry;
    for (int u = 0; u < nw; ++u) {
      if (u < w) pre += wtot[u];
      tile_end += wtot[u];
    }
    if (i < d) sw[i] = pre + incl;
    carry = tile_end;
    __syncthreads();  // wtot is reused by the next tile; sw[d - 1] is visible
  }
  return sw[d - 1];
}

template <typename T, class Pot>
__global__ void __launch_bounds__(MAXT)
sticky_chunk_kernel(Params p, T* __restrict__ x, T* __restrict__ v, T* __restrict__ fs,
                    int* __restrict__ iscal, T* __restrict__ ring,
                    uint8_t* __restrict__ act, const T* __restrict__ kappa,
                    int* __restrict__ ev_kind, T* __restrict__ ev_x, T* __restrict__ ev_v,
                    T* __restrict__ ev_fs, T* __restrict__ ev_ring,
                    uint8_t* __restrict__ ev_act) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ T red[MAXG * MAXW];
  __shared__ int ired[MAXW];
  __shared__ T wtot[MAXW];
  __shared__ typename cub::WarpScan<T>::TempStorage wscan[MAXW];

  const int d = p.d, n_grid = p.n_grid, G = p.n_grid - 1;
  const int tid = threadIdx.x, nt = blockDim.x, nw = nt >> 5;
  const int lane_w = tid & 31, warp = tid >> 5;
  const long B = p.B, b = blockIdx.x;
  T* sx = (T*)smem;
  T* sv = sx + d;
  T* skap = sv + d;
  T* sw = skap + d;
  uint8_t* sact = (uint8_t*)(sw + d);

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

  for (int k = 0; k < p.K; ++k) {
    const bool live = lane_live(p, cnt, t_s);  // t_s is the same in every thread
    int kval = 0;
    if (live) {
      // ---- envelope on [0, bh]: tangent-intersection segment maxima ----
      const T step = bh_s / (T)G;
      T box[MAXG];
      for (int j = 0; j < G; ++j) box[j] = zero;
      for (int i = tid; i < d; i += nt) {
        const T vi = masked(sv, sact, i);
        T f_prev = zero, g_prev = zero;
        for (int j = 0; j < n_grid; ++j) {
          T g, dg;
          Pot::eval(sx, sv, sact, 1, i, step * (T)j, g, dg);
          T f = g * vi, gd = dg * vi;
          if (!p.signed_bound) {
            // d/dt max(r, 0): JAX's JVP takes half the tangent at r == 0
            const T coef = f > zero ? (T)1 : (f == zero ? (T)0.5 : zero);
            gd = gd * coef;
            f = nmax(f, zero);
          }
          if (j > 0) {
            const T den = gd - g_prev;
            const T num = f_prev - f + gd * step;
            T ip = den == zero ? zero : num / den;
            if (isnan(ip)) ip = zero;
            ip = ip > zero ? ip : zero;
            ip = ip < step ? ip : step;
            const T inter = f_prev + g_prev * ip;
            box[j - 1] += nmax(nmax(f_prev, f), nmax(inter, zero));
          }
          f_prev = f;
          g_prev = gd;
        }
      }
      __syncthreads();
      for (int j = 0; j < G; ++j) {
        const T s = warp_sum(box[j]);
        if (lane_w == 0) red[j * MAXW + warp] = s;
      }
      __syncthreads();
      T cum[MAXG];
      cum[0] = zero;
      for (int j = 0; j < G; ++j) {
        T s = red[j * MAXW];
        for (int w = 1; w < nw; ++w) s += red[j * MAXW + w];
        box[j] = s + (T)p.refresh;
        cum[j + 1] = cum[j] + box[j] * step;
      }

      // ---- invert the envelope at the Exp clock ----
      int idx = 0;
      for (int j = 0; j < n_grid; ++j) idx += cum[j] < exp_s;
      const bool overflow = idx >= n_grid;
      T tp = inf, lam_bar = box[G - 1];
      if (idx >= 1 && idx < n_grid) {
        const T lo = cum[idx - 1], hi = cum[idx];
        const T denom = hi == lo ? (T)1 : hi - lo;
        tp = step * (T)(idx - 1) + (exp_s - lo) / denom * step;
        lam_bar = box[idx - 1];
      }
      const bool fresh = mode == MODE_FRESH, erroneous = mode == MODE_ERRONEOUS;
      const T tp_safe = overflow ? zero : tp;

      // ---- thinning rate at tp; crossing probe and stick times ----
      const T min_pt = tp < tt_s ? tp : tt_s;
      const T event_time = min_pt < h_s ? min_pt : h_s;
      T lam = zero, tmin = inf;
      int imin = 0x7fffffff, cross = 0;
      for (int i = tid; i < d; i += nt) {
        T g, dg;
        Pot::eval(sx, sv, sact, 1, i, tp_safe, g, dg);
        const T va = masked(sv, sact, i), xi = sx[i], vi = sv[i];
        lam += nmax(g * va, zero);
        cross |= xi * (xi + va * event_time) < zero;
        const T tj = (sact[i] && xi * vi < zero && va != zero) ? -xi / vi : inf;
        argmin_merge(tmin, imin, tj, i);
      }
      const T lam_t = block_sum(lam, red, nw);
      const bool any_cross = __syncthreads_or(cross) != 0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        argmin_merge(tmin, imin, __shfl_xor_sync(FULL, tmin, o),
                     __shfl_xor_sync(FULL, imin, o));
      if (lane_w == 0) {
        red[warp] = tmin;
        ired[warp] = imin;
      }
      __syncthreads();
      T t_togo = red[0];
      int i_stick = ired[0];
      for (int w = 1; w < nw; ++w) argmin_merge(t_togo, i_stick, red[w], ired[w]);
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
      const uint32_t salt = (uint32_t)k;
      const T u_acc = uniform<T>(seed, salt, 1u * p.tile + lane);
      const bool acc = u_acc < ar_new;
      const bool p_acc = p_proxy && acc;
      const bool p_rej = p_proxy && !acc;

      // ---- flow on the masked velocity; the latent v survives ----
      const T flow_t = p_stick ? t_togo
                       : p_thaw ? tt_s
                       : p_moveh ? h_s
                       : p_acc ? tp_safe : zero;
      for (int i = tid; i < d; i += nt) sx[i] = sx[i] + masked(sv, sact, i) * flow_t;
      __syncthreads();

      // ---- inverse-CDF coordinate flip on the masked rates ----
      if (p_acc) {
        const T u_flip = uniform<T>(seed, salt, 2u * p.tile + lane);
        for (int i = tid; i < d; i += nt) {
          T g, dg;
          Pot::eval(sx, sv, sact, 1, i, zero, g, dg);
          sw[i] = nmax(g * masked(sv, sact, i), zero);
        }
        const T thresh = u_flip * block_scan(sw, d, wtot, wscan, nw);
        int n_le = 0;
        for (int i = tid; i < d; i += nt) n_le += sw[i] <= thresh;
        n_le = block_sum(n_le, ired, nw);
        const int m = n_le < d - 1 ? n_le : d - 1;
        if (m % nt == tid) sv[m] = -sv[m];
      }

      // ---- stick and thaw updates of the activity mask ----
      if (p_stick && i_stick % nt == tid) sact[i_stick] = 0;
      if (p_thaw) {
        const T u_thaw = uniform<T>(seed, salt, 3u * p.tile + lane);
        for (int i = tid; i < d; i += nt) sw[i] = sact[i] ? zero : skap[i];
        const T thresh = u_thaw * block_scan(sw, d, wtot, wscan, nw);
        int n_le = 0;
        for (int i = tid; i < d; i += nt) n_le += sw[i] <= thresh;
        n_le = block_sum(n_le, ired, nw);
        const int i_thaw = n_le < d - 1 ? n_le : d - 1;
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
        // fresh thaw clock Exp(1) / sum(kappa[frozen]) on the updated mask
        T kf = zero;
        for (int i = tid; i < d; i += nt) kf += sact[i] ? zero : skap[i];
        const T rate_thaw = block_sum(kf, red, nw);
        const T e_tt = exponential<T>(seed, 0xC0000000u + salt, lane);
        tt_s = rate_thaw > zero ? e_tt / rate_thaw : inf;
      }
      const T e_draw = exponential<T>(seed, 0x80000000u + salt, lane);
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
      __syncthreads();  // v and act updates visible to every thread
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

template <typename T>
long max_dim() {
  return (SMEM_BLOCK - SMEM_STATIC) / bytes_per_coord<T>();
}

template <typename T, class Pot>
int launch(const Params& p, void* x, void* v, void* fs, void* iscal, void* ring, void* act,
           void* kappa, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs, void* ev_ring,
           void* ev_act, cudaStream_t stream) {
  if (p.d > max_dim<T>()) return (int)cudaErrorInvalidValue;
  const int threads = p.d >= MAXT ? MAXT : (p.d + 31) / 32 * 32;
  const size_t smem = (size_t)(p.d * bytes_per_coord<T>());
  auto kern = sticky_chunk_kernel<T, Pot>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<p.B, threads, smem, stream>>>(
      p, (T*)x, (T*)v, (T*)fs, (int*)iscal, (T*)ring, (uint8_t*)act, (const T*)kappa,
      (int*)ev_kind, (T*)ev_x, (T*)ev_v, (T*)ev_fs, (T*)ev_ring, (uint8_t*)ev_act);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" long sticky_chunk_max_dim(int f64) {
  return f64 ? max_dim<double>() : max_dim<float>();
}

extern "C" int sticky_chunk_launch(int f64, int potential, int d, int B, int K, int n_grid,
                                   int adaptive, int signed_bound, double refresh, int cap,
                                   int tile, int seed, int horizon, float t_target,
                                   void* x, void* v, void* fs,
                                   void* iscal, void* ring, void* act, void* kappa,
                                   void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
                                   void* ev_ring, void* ev_act, void* stream) {
  if (n_grid < 2 || n_grid > MAXG || d < 1 || B < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  Params p{d, B, K, n_grid, adaptive, signed_bound, cap, tile, seed, refresh,
           horizon, t_target};
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) {
    if (potential == 0)
      return launch<double, Gauss<double>>(p, x, v, fs, iscal, ring, act, kappa, ev_kind,
                                           ev_x, ev_v, ev_fs, ev_ring, ev_act, s);
    if (potential == 1)
      return launch<double, Banana<double>>(p, x, v, fs, iscal, ring, act, kappa, ev_kind,
                                            ev_x, ev_v, ev_fs, ev_ring, ev_act, s);
  } else {
    if (potential == 0)
      return launch<float, Gauss<float>>(p, x, v, fs, iscal, ring, act, kappa, ev_kind,
                                         ev_x, ev_v, ev_fs, ev_ring, ev_act, s);
    if (potential == 1)
      return launch<float, Banana<float>>(p, x, v, fs, iscal, ring, act, kappa, ev_kind,
                                          ev_x, ev_v, ev_fs, ev_ring, ev_act, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K1: K fused Zig-Zag transitions per chain, one thread per chain.
//
// Replaces pdmpflux_tpu/ops/pallas/zigzag_chunk.py:run_chunk (body
// _make_kernel) with kind="zigzag", sticky=False, in both modes: "events"
// and "horizon" (K7: a lane also freezes once its committed clock reaches the
// float32 target, lane_live in pdmp_common.cuh).  The plain
// PyTorch version is run_chunk_plain in ops/cuda/zigzag_chunk.py; both draw
// the same Threefry-2x32 counters as the Pallas kernel (key (seed + tile *
// 7919, salt), counter row * tile + lane), so trajectories agree to rounding.
//
// Design.  One thread owns one chain for all K transitions: its scalars
// (clock, horizon, Exp clock, counters, error ring) live in registers; x and
// v stay in device memory in the (d, B) chain-minor layout and are updated
// in place, so a warp's loads and the (K, d, B) event-row stores coalesce
// for every d.  The envelope is built coordinate-outer, grid-inner: each
// coordinate's rate and tangent at consecutive grid points give that
// coordinate's segment maxima, summed into a per-thread box[] of n_grid - 1
// segments, so no (n_grid, d) array is ever held.  A finished chain (count
// >= cap, or in horizon mode clock >= target) skips the transition and emits
// its frozen row.  The fill loop over
// chunks stays on the host (one launch per chunk, one count check between
// chunks), exactly as the JAX driver loops.
//
// What bounds it on an H100: arithmetic and latency, not bytes.  Per
// transition a thread evaluates the gradient (n_grid + 2) * d times and
// draws three Threefry blocks (~20 integer rounds each), against
// (2 d + 12) * sizeof(T) bytes of event row written.  box[]/cum[] are
// dynamically indexed and sit in local memory (L1); at d = 10 the x/v
// re-reads hit L1 too.  The first cost to attack is the gradient re-evaluation
// per grid point (the rate of the linear flow is affine in t for gauss).
//
// The gradient cannot be traced into CUDA the way Pallas traces jax.jvp, so
// the kernel takes a device potential: the gradient component at x + v t and
// its directional derivative along v (the Hessian-vector product), from
// which the rate's time derivative follows.  Gauss and Banana are provided
// (pdmp_common.cuh, shared with K6).

#include "pdmp_common.cuh"

namespace {

using namespace pdmp;

template <typename T, class Pot>
__global__ void zigzag_chunk_kernel(Params p, T* __restrict__ x, T* __restrict__ v,
                                    T* __restrict__ fs, int* __restrict__ iscal,
                                    T* __restrict__ ring, int* __restrict__ ev_kind,
                                    T* __restrict__ ev_x, T* __restrict__ ev_v,
                                    T* __restrict__ ev_fs, T* __restrict__ ev_ring) {
  const long B = p.B;
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int d = p.d, n_grid = p.n_grid, G = p.n_grid - 1;
  T* xb = x + b;
  T* vb = v + b;

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
  const T inf = (T)INFINITY, zero = (T)0;

  for (int k = 0; k < p.K; ++k) {
    const bool live = lane_live(p, cnt, t_s);
    int kval = 0;
    if (live) {
      // ---- envelope on [0, bh]: tangent-intersection segment maxima ----
      const T step = bh_s / (T)G;
      T box[MAXG];
      for (int j = 0; j < G; ++j) box[j] = zero;
      for (int i = 0; i < d; ++i) {
        const T vi = vb[i * B];
        T f_prev = zero, g_prev = zero;
        for (int j = 0; j < n_grid; ++j) {
          T g, dg;
          Pot::eval(xb, vb, nullptr, B, i, step * (T)j, g, dg);
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
      T cum[MAXG];
      cum[0] = zero;
      for (int j = 0; j < G; ++j) {
        box[j] = box[j] + (T)p.refresh;
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

      // ---- thinning at tp on the unsigned rate ----
      T lam_t = zero;
      for (int i = 0; i < d; ++i) {
        T g, dg;
        Pot::eval(xb, vb, nullptr, B, i, tp_safe, g, dg);
        lam_t += nmax(g * vb[i * B], zero);
      }
      const T ar_new = lam_t / lam_bar;

      const bool beyond = tp > h_s;
      const bool p_moveh = beyond && !erroneous;
      const bool p_erreset = beyond && erroneous;
      const bool p_ac = !beyond;
      const bool p_err = p_ac && (ar_new > (T)1);
      const bool p_proxy = p_ac && !p_err;
      const uint32_t salt = (uint32_t)k;
      const T u_acc = uniform<T>(seed, salt, 1u * p.tile + lane);
      const bool acc = u_acc < ar_new;
      const bool p_acc = p_proxy && acc;
      const bool p_rej = p_proxy && !acc;

      // ---- flow, then the inverse-CDF coordinate flip ----
      const T flow_t = p_moveh ? h_s : (p_acc ? tp_safe : zero);
      int m = -1;
      if (p_acc) {
        const T u_flip = uniform<T>(seed, salt, 2u * p.tile + lane);
        T total = zero;
        for (int i = 0; i < d; ++i) {
          T g, dg;
          Pot::eval(xb, vb, nullptr, B, i, flow_t, g, dg);
          total += nmax(g * vb[i * B], zero);
        }
        const T thresh = u_flip * total;
        T c = zero;
        int n_le = 0;
        for (int i = 0; i < d; ++i) {
          T g, dg;
          Pot::eval(xb, vb, nullptr, B, i, flow_t, g, dg);
          c += nmax(g * vb[i * B], zero);
          n_le += c <= thresh;
        }
        m = n_le < d - 1 ? n_le : d - 1;
      }
      for (int i = 0; i < d; ++i) {
        const T vi = vb[i * B];
        xb[i * B] = xb[i * B] + vi * flow_t;
        if (i == m) vb[i * B] = -vi;
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
      const T e_draw = exponential<T>(seed, 0x80000000u + salt, lane);
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
    ev_kind[(row * 4 + 0) * B + b] = kval;
    ev_kind[(row * 4 + 1) * B + b] = rej;
    ev_kind[(row * 4 + 2) * B + b] = err;
    ev_kind[(row * 4 + 3) * B + b] = hit;
    for (int i = 0; i < d; ++i) {
      ev_x[(row * d + i) * B + b] = xb[i * B];
      ev_v[(row * d + i) * B + b] = vb[i * B];
    }
    ev_fs[(row * 3 + 0) * B + b] = t_s + ts_s;
    ev_fs[(row * 3 + 1) * B + b] = h_s;
    ev_fs[(row * 3 + 2) * B + b] = ar_s;
#pragma unroll
    for (int r = 0; r < RING; ++r) ev_ring[(row * RING + r) * B + b] = rg[r];

    // counters reset after a recorded event
    if (kval > 0) {
      rej = err = hit = 0;
#pragma unroll
      for (int r = 0; r < RING; ++r) rg[r] = zero;
    }
  }

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

template <typename T, class Pot>
void launch(const Params& p, void* x, void* v, void* fs, void* iscal, void* ring,
            void* ev_kind, void* ev_x, void* ev_v, void* ev_fs, void* ev_ring,
            cudaStream_t stream) {
  const int threads = 32;  // spread B = 8192 chains over every SM
  const int blocks = (p.B + threads - 1) / threads;
  zigzag_chunk_kernel<T, Pot><<<blocks, threads, 0, stream>>>(
      p, (T*)x, (T*)v, (T*)fs, (int*)iscal, (T*)ring, (int*)ev_kind, (T*)ev_x,
      (T*)ev_v, (T*)ev_fs, (T*)ev_ring);
}

}  // namespace

extern "C" int zigzag_chunk_launch(int f64, int potential, int d, int B, int K,
                                   int n_grid, int adaptive, int signed_bound,
                                   double refresh, int cap, int tile, int seed,
                                   int horizon, float t_target, void* x, void* v,
                                   void* fs, void* iscal, void* ring,
                                   void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
                                   void* ev_ring, void* stream) {
  if (n_grid < 2 || n_grid > MAXG || d < 1 || B < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  Params p{d, B, K, n_grid, adaptive, signed_bound, cap, tile, seed, refresh,
           horizon, t_target};
  cudaStream_t s = (cudaStream_t)stream;
  if (f64) {
    if (potential == 0)
      launch<double, Gauss<double>>(p, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else if (potential == 1)
      launch<double, Banana<double>>(p, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    if (potential == 0)
      launch<float, Gauss<float>>(p, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else if (potential == 1)
      launch<float, Banana<float>>(p, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* pdmpflux_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

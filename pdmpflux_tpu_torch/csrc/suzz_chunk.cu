// K4: K fused Speed-Up Zig-Zag transitions per chain, one thread per chain.
//
// Replaces pdmpflux_tpu/ops/pallas/zigzag_chunk.py:run_chunk (line 854, body
// _make_kernel) with kind="suzz": K1's vectorized machinery (vect, :257) on
// the speed-change flow (flows.make_suzz_flow) and the effective gradient
// grad_eff(x) = s grad U(x) - x / s, s = sqrt(1 + |x|^2) (driver.py:450-456):
// the per-coordinate signed rates grad_eff(x_t) v (:320-323), their tangents
// (jax.jvp at every grid point, :371), thinning at tp (:424-426), the flow at
// flow_t (:495-500) and the inverse-CDF flip on max(grad_eff(x_new) v, 0)
// (:507-519), in mode "events" and "horizon" (K7, lane_live in
// pdmp_common.cuh).  The plain PyTorch version is run_chunk_plain in
// ops/cuda/zigzag_chunk.py with kind "suzz"; both draw K1's Threefry counters,
// so trajectories agree to rounding.
//
// The flow of one chain: x_t = y + v0 x1(t) v with y = x - v0 x0 v,
// x1(t) = (b^2 - a) / (2 b) - c / d and b = base exp(sqrt(d) v0 t); c, a and
// base are sums over the chain's coordinates that do not depend on t, so a
// flow evaluation costs one exp and two operations per coordinate.  The
// tangent cannot be traced as Pallas traces jax.jvp; it is written out:
// dx_t/dt = phi v with phi = v0 sqrt(d) v0 (b^2 + a) / (2 b), and
// d grad_eff(x_t)/dt = phi (s H v + g (x.v) / s - v / s + x (x.v) / s^3) at
// x_t, from the device potential's gradient g and H v evaluated at x_t.
//
// Design.  One thread owns one chain for all K transitions, as in K1, with
// K1's scalars in registers, x and v in place in the (d, B) chain-minor
// layout, 32-thread blocks and K1's rows.  x_t couples the coordinates, so the
// envelope is built grid-outer, coordinate-inner (K1 goes coordinate-outer):
// per grid point the chain's x_t, then |x_t|^2 and x_t . v, then each
// coordinate's rate pair against that coordinate's pair at the previous grid
// point.  A (3, d, B) scratch from the wrapper, coalesced like x, holds x_t
// (where Banana reads coordinates 0 and 1) and the previous pairs; box[j] is
// summed over coordinates in coordinate order.  Every live lane flows, at
// flow_t = 0 too, since the speed-change flow is the identity there only up
// to rounding (JAX flows every live lane); the flip rates are read at the
// flowed x.  Every sum over coordinates is added in coordinate order, and
// this file is compiled with -fmad=false (ops/cuda/build.py), so that
// products round before they are added as torch's elementwise ops round them:
// y0 + sqrt(y0^2 + a) cancels for y0 << 0, and the plain version and the
// kernel then round alike.  The tail (Kahan commit, adaptation, counters,
// ring, row) is K1's.
//
// What bounds it on an H100: latency.  Per transition a chain evaluates the
// flow n_grid + 2 times (one exp, two ordered O(d) sums each, a sqrt) and
// n_grid * d rate pairs with three IEEE divides each, draws three Threefry
// blocks, against (2 d + 12) * sizeof(T) bytes of event row.  B = 512 chains
// fill 16 of the 132 SMs with one warp each.  Later work: several threads per
// chain (K3's warp layout), the chain's vectors in shared memory.

#include "pdmp_common.cuh"

namespace {

using namespace pdmp;

// The t-independent terms of one chain's speed-change flow
// (flows._suzz_at), from x and v at stride B.
template <typename T>
struct SuzzFlow {
  T v0, w, c_d, a, base, rate;

  __device__ __forceinline__ SuzzFlow(const T* x, const T* v, long B, int d) {
    v0 = v[0];
    w = v0 * x[0];
    T svy = 0, syy = 0;
    for (int i = 0; i < d; ++i) {  // sums in coordinate order
      const T vi = v[i * B];
      const T yi = x[i * B] - w * vi;
      svy = i == 0 ? yi * vi : svy + yi * vi;
      syy = i == 0 ? yi * yi : syy + yi * yi;
    }
    const T c = v0 * svy;
    a = ((T)1 + syy) / (T)d - (c * c) / (T)(d * d);
    c_d = c / (T)d;
    const T y0 = x[0] + c_d;
    base = y0 + sqrt(y0 * y0 + a);
    // sqrt(float(dim)) is the double rounded to T, as JAX rounds it
    rate = (T)sqrt((double)d) * v0;
  }

  // x1(t) and the speed factor phi(t) of dx_t/dt = phi v
  __device__ __forceinline__ void at(T t, T& x1, T& phi) const {
    const T b = base * exp(rate * t);
    x1 = (b * b - a) / ((T)2 * b) - c_d;
    phi = v0 * (rate * ((b * b + a) / ((T)2 * b)));
  }
};

// x_t = y + (v0 x1) v into out (stride B; out may be x itself, each
// coordinate is read before it is written), and the ordered sums |x_t|^2 and
// x_t . v.
template <typename T>
__device__ __forceinline__ void flow_to(const SuzzFlow<T>& f, T x1, const T* x, const T* v,
                                        T* out, long B, int d, T& s2, T& xv) {
  const T m = f.v0 * x1;
  for (int i = 0; i < d; ++i) {
    const T vi = v[i * B];
    const T xi = (x[i * B] - f.w * vi) + m * vi;
    out[i * B] = xi;
    s2 = i == 0 ? xi * xi : s2 + xi * xi;
    xv = i == 0 ? xi * vi : xv + xi * vi;
  }
}

// The signed rate grad_eff_i(x_t) v_i, x_t at stride B with s = s(x_t).
template <typename T, class Pot>
__device__ __forceinline__ T eff_rate(const T* xt, const T* v, long B, int i, T s) {
  T g, hv;
  Pot::eval(xt, v, nullptr, B, i, (T)0, g, hv);
  return (s * g - xt[i * B] / s) * v[i * B];
}

template <typename T, class Pot>
__global__ void suzz_chunk_kernel(Params p, T* __restrict__ x, T* __restrict__ v,
                                  T* __restrict__ fs, int* __restrict__ iscal,
                                  T* __restrict__ ring, T* __restrict__ scratch,
                                  int* __restrict__ ev_kind, T* __restrict__ ev_x,
                                  T* __restrict__ ev_v, T* __restrict__ ev_fs,
                                  T* __restrict__ ev_ring) {
  const long B = p.B;
  const long b = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int d = p.d, n_grid = p.n_grid, G = p.n_grid - 1;
  T* xb = x + b;
  T* vb = v + b;
  T* xt = scratch + b;                  // x_t at the point being evaluated
  T* fp = scratch + (long)d * B + b;    // each coordinate's rate at the previous grid point
  T* gp = scratch + 2L * d * B + b;     // and its tangent

  T t_s = fs[F_T * B + b], tc_s = fs[F_TC * B + b], ts_s = fs[F_TS * B + b];
  T h_s = fs[F_H * B + b], bh_s = fs[F_BH * B + b], exp_s = fs[F_EXP * B + b];
  T ar_s = fs[F_AR * B + b];
  int mode = iscal[I_MODE * B + b], rej = iscal[I_REJ * B + b];
  int err = iscal[I_ERR * B + b], hit = iscal[I_HIT * B + b];
  int cnt = iscal[I_CNT * B + b];
  T rg[RING];
#pragma unroll
  for (int r = 0; r < RING; ++r) rg[r] = ring[r * B + b];

  const uint32_t seed = (uint32_t)p.seed + (uint32_t)(b / p.tile) * 7919u;
  const uint32_t lane = (uint32_t)(b % p.tile);
  const T inf = (T)INFINITY, zero = (T)0;

  for (int k = 0; k < p.K; ++k) {
    const bool live = lane_live(p, cnt, t_s);
    int kval = 0;
    if (live) {
      const SuzzFlow<T> fl(xb, vb, B, d);

      // ---- envelope on [0, bh], grid-outer: tangent-intersection maxima ----
      const T step = bh_s / (T)G;
      T box[MAXG];
      for (int j = 0; j < n_grid; ++j) {
        T x1, phi, s2 = zero, xv = zero;
        fl.at(step * (T)j, x1, phi);
        flow_to(fl, x1, xb, vb, xt, B, d, s2, xv);
        const T s = sqrt((T)1 + s2);
        const T xvs = xv / s, xvs3 = xvs / (s * s);
        T seg_sum = zero;
        for (int i = 0; i < d; ++i) {
          const T vi = vb[i * B], xi = xt[i * B];
          T g, hv;
          Pot::eval(xt, vb, nullptr, B, i, zero, g, hv);
          T f = (s * g - xi / s) * vi;
          T gd = (phi * (s * hv + g * xvs - vi / s + xi * xvs3)) * vi;
          if (!p.signed_bound) {
            // d/dt max(r, 0): JAX's JVP takes half the tangent at r == 0
            const T coef = f > zero ? (T)1 : (f == zero ? (T)0.5 : zero);
            gd = gd * coef;
            f = nmax(f, zero);
          }
          if (j > 0) {
            const T f_prev = fp[i * B], g_prev = gp[i * B];
            const T den = gd - g_prev;
            const T num = f_prev - f + gd * step;
            T ip = den == zero ? zero : num / den;
            if (isnan(ip)) ip = zero;
            ip = ip > zero ? ip : zero;
            ip = ip < step ? ip : step;
            const T inter = f_prev + g_prev * ip;
            const T seg = nmax(nmax(f_prev, f), nmax(inter, zero));
            seg_sum = i == 0 ? seg : seg_sum + seg;
          }
          fp[i * B] = f;
          gp[i * B] = gd;
        }
        if (j > 0) box[j - 1] = seg_sum;
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

      // ---- thinning at tp on the unsigned rate, along the flow ----
      T lam_t = zero;
      {
        T x1, phi, s2 = zero, xv = zero;
        fl.at(tp_safe, x1, phi);
        flow_to(fl, x1, xb, vb, xt, B, d, s2, xv);
        const T s = sqrt((T)1 + s2);
        for (int i = 0; i < d; ++i) {
          const T r = nmax(eff_rate<T, Pot>(xt, vb, B, i, s), zero);
          lam_t = i == 0 ? r : lam_t + r;
        }
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

      // ---- flow every live lane in place, then the inverse-CDF flip ----
      const T flow_t = p_moveh ? h_s : (p_acc ? tp_safe : zero);
      T s_new;
      {
        T x1, phi, s2 = zero, xv = zero;
        fl.at(flow_t, x1, phi);
        flow_to(fl, x1, xb, vb, xb, B, d, s2, xv);
        s_new = sqrt((T)1 + s2);
      }
      if (p_acc) {
        const T u_flip = uniform<T>(seed, salt, 2u * p.tile + lane);
        T total = zero;
        for (int i = 0; i < d; ++i) {
          const T r = nmax(eff_rate<T, Pot>(xb, vb, B, i, s_new), zero);
          total = i == 0 ? r : total + r;
        }
        const T thresh = u_flip * total;
        T c = zero;
        int n_le = 0;
        for (int i = 0; i < d; ++i) {
          const T r = nmax(eff_rate<T, Pot>(xb, vb, B, i, s_new), zero);
          c = i == 0 ? r : c + r;
          n_le += c <= thresh;
        }
        const int m = n_le < d - 1 ? n_le : d - 1;
        vb[m * B] = -vb[m * B];
      }

      // ---- Kahan time commit, horizon adaptation (K1's) ----
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
            void* scratch, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
            void* ev_ring, cudaStream_t stream) {
  const int threads = 32;
  const int blocks = (p.B + threads - 1) / threads;
  suzz_chunk_kernel<T, Pot><<<blocks, threads, 0, stream>>>(
      p, (T*)x, (T*)v, (T*)fs, (int*)iscal, (T*)ring, (T*)scratch, (int*)ev_kind,
      (T*)ev_x, (T*)ev_v, (T*)ev_fs, (T*)ev_ring);
}

}  // namespace

extern "C" int suzz_chunk_launch(int f64, int potential, int d, int B, int K, int n_grid,
                                 int adaptive, int signed_bound, double refresh, int cap,
                                 int tile, int seed, int horizon, float t_target, void* x,
                                 void* v, void* fs, void* iscal, void* ring, void* scratch,
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
      launch<double, Gauss<double>>(p, x, v, fs, iscal, ring, scratch, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else if (potential == 1)
      launch<double, Banana<double>>(p, x, v, fs, iscal, ring, scratch, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else
      return (int)cudaErrorInvalidValue;
  } else {
    if (potential == 0)
      launch<float, Gauss<float>>(p, x, v, fs, iscal, ring, scratch, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else if (potential == 1)
      launch<float, Banana<float>>(p, x, v, fs, iscal, ring, scratch, ev_kind, ev_x, ev_v, ev_fs, ev_ring, s);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4: K fused Speed-Up Zig-Zag transitions per chain, one warp per chain, the
// envelope's grid points across its lanes.
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
// Design.  One warp owns one chain for all K transitions, four warps to a
// block (B = 512 gives 128 blocks), K1's scalars replicated in all 32 lanes,
// and the chain's x and v copied into the warp's slice of shared memory
// (read in place in the (d, B) chain-minor state where the 4 * 2 * d values
// do not fit a block's 227 KB, so d has no limit).  The flow's t-free terms
// are computed once per transition, by every lane.  x_t couples the
// coordinates, so each grid point takes its own passes over the chain, and
// the grid points go across the lanes: lane l evaluates grid points l and
// l + 32 (flow_point: the flow at t_j, one exp, then |x_t|^2 and x_t . v in
// coordinate order), then walks the coordinates in lockstep with the other
// lanes, recomputing x_t's coordinate with the flow's expression (no
// scratch), taking each coordinate's rate pair and the pair of point j - 1
// for the same coordinate from the neighbouring lane by __shfl_up_sync, and
// adding its segment maxima in coordinate order.  Every lane then gathers the
// boxes by __shfl_sync and builds the cumulative sum in grid order
// (pdmp_common.cuh: invert_envelope), so tp and every decision after it come
// out the same in all lanes.  Thinning, the flow and the flip evaluate once
// per transition, each lane taking the same ordered sums (the same bits); the
// flow's stores and the event rows spread the coordinates over the lanes.
// Every live lane flows, at flow_t = 0 too, since the speed-change flow is the
// identity there only up to rounding (JAX flows every live lane); the flip
// rates are read at the flowed x.  Every sum over coordinates is added in
// coordinate order, and this file is compiled with -fmad=false
// (ops/cuda/build.py), so that products round before they are added as
// torch's elementwise ops round them: y0 + sqrt(y0^2 + a) cancels for
// y0 << 0, and the plain version and the kernel then round alike.  The
// funnels' sums over x_t's coordinates 1..d-1 (pdmp_common.cuh: ChainSums)
// take a pass of their own at each flow point, in coordinate order, and the
// flip's one more pass over the flowed x, as the plain version adds them.  The tail
// (Kahan commit, adaptation, counters, ring, row) is K1's.
//
// What bounds it on an H100: latency.  Per transition the critical path is
// about eight ordered O(d) passes in one lane (the flow's terms; a grid
// point's two sums and its rate pairs, with three IEEE divides and two
// shuffles per coordinate; thinning's flow and rates; the flow; the flip's two
// passes), n_grid - 1 dependent shuffles and adds of the cumulative sum and
// three Threefry blocks, against (2 d + 12) * sizeof(T) bytes of event row;
// the bound (chip_smoke.py) counts the operations.  At n_grid = 10, 22 of the
// 32 lanes idle in the envelope.  Later work: spread the single evaluations'
// coordinates over the idle lanes, several chains per warp at small d.

#include "pdmp_common.cuh"

namespace {

using namespace pdmp;

constexpr int WARPS = 4;  // chains per block
constexpr long SMEM_BLOCK = 232448;  // bytes of shared memory one block may use

// The t-independent terms of one chain's speed-change flow
// (flows._suzz_at), from x and v at stride sx.
template <typename T>
struct SuzzFlow {
  T v0, w, c_d, a, base, rate;

  __device__ __forceinline__ SuzzFlow(const T* x, const T* v, long sx, int d) {
    v0 = v[0];
    w = v0 * x[0];
    T svy = 0, syy = 0;
    for (int i = 0; i < d; ++i) {  // sums in coordinate order
      const T vi = v[i * sx];
      const T yi = x[i * sx] - w * vi;
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

  // a coordinate of x_t = y + (v0 x1) v from the coordinate's x and v and
  // m = v0 x1(t)
  __device__ __forceinline__ T coord(T xi, T vi, T m) const {
    return (xi - w * vi) + m * vi;
  }

  // the chain at x_t, read by coordinate (x and v at stride sx): the
  // accessor a potential's sums and at take
  __device__ __forceinline__ auto point(const T* x, const T* v, long sx, T m) const {
    return [this, x, v, sx, m](int j, T& y, T& vj) {
      vj = v[j * sx];
      y = coord(x[j * sx], vj, m);
    };
  }
};

// The chain flowed to one time: m = v0 x1(t), the speed factor phi,
// s = sqrt(1 + |x_t|^2), xvs = x_t . v / s and xvs3 = xvs / s^2 (the sums in
// coordinate order), x_t's coordinates 0 and 1, which Banana and the
// funnels read, and the sums Pot reads over x_t's coordinates (the
// funnels': over 1..d-1, pdmp_common.cuh: ChainSums), added in coordinate
// order in a pass of their own.
template <typename T, class Pot>
struct FlowPoint {
  T m, phi, s, xvs, xvs3, x0, x1;
  typename Pot::Sums cs;
};

template <class Pot, typename T>
__device__ __forceinline__ FlowPoint<T, Pot> flow_point(const SuzzFlow<T>& fl, const T* x,
                                                        const T* v, long sx, int d, T t,
                                                        const T* prm) {
  FlowPoint<T, Pot> q;
  T x1;
  fl.at(t, x1, q.phi);
  q.m = fl.v0 * x1;
  T s2 = 0, xv = 0;
  for (int i = 0; i < d; ++i) {
    const T vi = v[i * sx];
    const T xi = fl.coord(x[i * sx], vi, q.m);
    s2 = i == 0 ? xi * xi : s2 + xi * xi;
    xv = i == 0 ? xi * vi : xv + xi * vi;
  }
  q.cs = Pot::sums(d, prm, fl.point(x, v, sx, q.m));
  q.s = sqrt((T)1 + s2);
  q.xvs = xv / q.s;
  q.xvs3 = q.xvs / (q.s * q.s);
  const long s1 = d > 1 ? sx : 0;
  q.x0 = fl.coord(x[0], v[0], q.m);
  q.x1 = fl.coord(x[s1], v[s1], q.m);
  return q;
}

// The effective gradient's signed rate (s g - x_i / s) v_i at a point with
// speed s, from grad U_i there.
template <typename T>
__device__ __forceinline__ T eff_rate(T g, T xi, T vi, T s) {
  return (s * g - xi / s) * vi;
}

template <typename T, class Pot>
__global__ void __launch_bounds__(32 * WARPS)
suzz_chunk_kernel(Params p, int in_smem, const T* __restrict__ prm, T* __restrict__ x, T* __restrict__ v,
                  T* __restrict__ fs, int* __restrict__ iscal, T* __restrict__ ring,
                  int* __restrict__ ev_kind, T* __restrict__ ev_x, T* __restrict__ ev_v,
                  T* __restrict__ ev_fs, T* __restrict__ ev_ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d, n_grid = p.n_grid, G = p.n_grid - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long B = p.B, b = (long)blockIdx.x * WARPS + warp;
  if (b >= B) return;  // a whole warp leaves: no block-wide barrier follows
  // the chain's x and v: the warp's shared copy, or in place at stride B
  const long sx = in_smem ? 1 : B;
  T* X = in_smem ? (T*)smem + (long)warp * 2 * d : x + b;
  T* V = in_smem ? X + d : v + b;
  const long s1 = d > 1 ? sx : 0;  // coordinate 1's offset
  if (in_smem) {
    for (int i = lane; i < d; i += 32) {
      X[i] = x[i * B + b];
      V[i] = v[i * B + b];
    }
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
  __syncwarp();

  const uint32_t seed = (uint32_t)p.seed + (uint32_t)(b / p.tile) * 7919u;
  const uint32_t ln = (uint32_t)(b % p.tile);
  const uint32_t tile = (uint32_t)p.tile;
  const T zero = (T)0, refresh = (T)p.refresh;

  for (int k = 0; k < p.K; ++k) {
    const bool live = lane_live(p, cnt, t_s);  // t_s is the same in every lane
    int kval = 0;
    if (live) {
      const SuzzFlow<T> fl(X, V, sx, d);
      const T v0 = V[0], v1 = V[s1];

      // coordinate i's signed rate at the flowed chain q, grad U_i and
      // (H v)_i read at x_t's coordinate (recomputed from x_i), a neighbour
      // or a fixed coordinate read on the same flow
      auto rate_at = [&](const FlowPoint<T, Pot>& q, int i, T xi, T vi, T& g, T& hv) -> T {
        const T xt = fl.coord(xi, vi, q.m);
        Pot::at(i, xt, vi, q.x0, v0, q.x1, v1, zero, prm, q.cs, fl.point(X, V, sx, q.m), g,
                hv);
        return xt;
      };

      // ---- envelope on [0, bh], grid points across lanes ----
      const T step = bh_s / (T)G;
      const bool two = n_grid > 32;  // the same in every lane
      const bool on_a = lane < n_grid, on_b = lane + 32 < n_grid;
      FlowPoint<T, Pot> qa{}, qb{};
      if (on_a) qa = flow_point<Pot>(fl, X, V, sx, d, step * (T)lane, prm);
      if (on_b) qb = flow_point<Pot>(fl, X, V, sx, d, step * (T)(lane + 32), prm);
      // coordinate i's rate pair at a grid point (zeros past the grid)
      auto pair = [&](const FlowPoint<T, Pot>& q, bool on, int i, T xi, T vi, T& f, T& gd) {
        f = gd = zero;
        if (!on) return;
        T g, hv;
        const T xt = rate_at(q, i, xi, vi, g, hv);
        f = eff_rate(g, xt, vi, q.s);
        gd = (q.phi * (q.s * hv + g * q.xvs - vi / q.s + xt * q.xvs3)) * vi;
        if (!p.signed_bound) {
          // d/dt max(r, 0): JAX's JVP takes half the tangent at r == 0
          const T coef = f > zero ? (T)1 : (f == zero ? (T)0.5 : zero);
          gd = gd * coef;
          f = nmax(f, zero);
        }
      };
      T sa = zero, sb = zero;  // this lane's sums of segment maxima
      for (int i = 0; i < d; ++i) {  // every lane, in lockstep
        const T xi = X[i * sx], vi = V[i * sx];
        T fa, ga;
        pair(qa, on_a, i, xi, vi, fa, ga);
        const T fpa = __shfl_up_sync(FULL_MASK, fa, 1), gpa = __shfl_up_sync(FULL_MASK, ga, 1);
        const T seg_a = segment_max(fpa, gpa, fa, ga, step);
        sa = i == 0 ? seg_a : sa + seg_a;
        if (two) {
          T fb, gb;
          pair(qb, on_b, i, xi, vi, fb, gb);
          T fpb = __shfl_up_sync(FULL_MASK, fb, 1), gpb = __shfl_up_sync(FULL_MASK, gb, 1);
          const T f31 = __shfl_sync(FULL_MASK, fa, 31), g31 = __shfl_sync(FULL_MASK, ga, 31);
          if (lane == 0) {  // point 32's predecessor is lane 31's first point
            fpb = f31;
            gpb = g31;
          }
          const T seg_b = segment_max(fpb, gpb, fb, gb, step);
          sb = i == 0 ? seg_b : sb + seg_b;
        }
      }

      // ---- invert the envelope at the Exp clock ----
      // box[j - 1] of this lane's grid point j, read where 1 <= j < n_grid
      T tp, lam_bar;
      bool overflow;
      invert_envelope(sa + refresh, sb + refresh, step, exp_s, n_grid, lane, tp, lam_bar,
                      overflow);
      const bool fresh = mode == MODE_FRESH, erroneous = mode == MODE_ERRONEOUS;
      const T tp_safe = overflow ? zero : tp;

      // ---- thinning at tp on the unsigned rate, along the flow ----
      T lam_t = zero;
      {
        const FlowPoint<T, Pot> q = flow_point<Pot>(fl, X, V, sx, d, tp_safe, prm);
        for (int i = 0; i < d; ++i) {
          const T vi = V[i * sx];
          T g, hv;
          const T xt = rate_at(q, i, X[i * sx], vi, g, hv);
          const T r = nmax(eff_rate(g, xt, vi, q.s), zero);
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
      const T u_acc = uniform<T>(seed, salt, 1u * tile + ln);
      const bool acc = u_acc < ar_new;
      const bool p_acc = p_proxy && acc;
      const bool p_rej = p_proxy && !acc;

      // ---- flow every live lane in place, then the inverse-CDF flip ----
      const T flow_t = p_moveh ? h_s : (p_acc ? tp_safe : zero);
      T s_new;
      {
        T x1, phi;
        fl.at(flow_t, x1, phi);
        const T m = fl.v0 * x1;
        T s2 = zero;
        for (int i = 0; i < d; ++i) {
          const T xt = fl.coord(X[i * sx], V[i * sx], m);
          s2 = i == 0 ? xt * xt : s2 + xt * xt;
        }
        s_new = sqrt((T)1 + s2);
        __syncwarp();  // every lane has read x before the lanes rewrite it
        for (int i = lane; i < d; i += 32) X[i * sx] = fl.coord(X[i * sx], V[i * sx], m);
        __syncwarp();
      }
      if (p_acc) {  // the same in every lane
        const T u_flip = uniform<T>(seed, salt, 2u * tile + ln);
        const T x0 = X[0], x1 = X[s1];
        const auto flowed = [&](int j, T& y, T& w) {  // the flowed x, read by coordinate
          y = X[j * sx];
          w = V[j * sx];
        };
        const auto cs = Pot::sums(d, prm, flowed);
        auto flip_rate = [&](int i) -> T {
          const T xi = X[i * sx], vi = V[i * sx];
          T g, hv;
          Pot::at(i, xi, vi, x0, v0, x1, v1, zero, prm, cs, flowed, g, hv);
          return nmax(eff_rate(g, xi, vi, s_new), zero);
        };
        T total = zero;
        for (int i = 0; i < d; ++i) {
          const T r = flip_rate(i);
          total = i == 0 ? r : total + r;
        }
        const T thresh = u_flip * total;
        T c = zero;
        int n_le = 0;
        for (int i = 0; i < d; ++i) {
          const T r = flip_rate(i);
          c = i == 0 ? r : c + r;
          n_le += c <= thresh;
        }
        const int m = n_le < d - 1 ? n_le : d - 1;
        __syncwarp();  // every lane has read v before one lane flips it
        if (lane == 0) V[m * sx] = -V[m * sx];
        __syncwarp();
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
      const T e_draw = exponential<T>(seed, 0x80000000u + salt, ln);
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
    for (int i = lane; i < d; i += 32) {
      ev_x[(row * d + i) * B + b] = X[i * sx];
      ev_v[(row * d + i) * B + b] = V[i * sx];
    }
    if (lane == 0) {
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

  if (in_smem) {
    for (int i = lane; i < d; i += 32) {
      x[i * B + b] = X[i];
      v[i * B + b] = V[i];
    }
  }
  if (lane == 0) {
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

template <typename T, class Pot>
int launch(const Params& p, const void* prm, void* x, void* v, void* fs, void* iscal,
           void* ring, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs, void* ev_ring,
           cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * 2 * p.d * sizeof(T);
  const bool in_smem = smem <= (size_t)SMEM_BLOCK;
  auto kern = suzz_chunk_kernel<T, Pot>;
  if (in_smem) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (p.B + WARPS - 1) / WARPS;
  kern<<<blocks, 32 * WARPS, in_smem ? smem : 0, stream>>>(
      p, (int)in_smem, (const T*)prm, (T*)x, (T*)v, (T*)fs, (int*)iscal, (T*)ring, (int*)ev_kind,
      (T*)ev_x, (T*)ev_v, (T*)ev_fs, (T*)ev_ring);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int potential, const Params& p, const void* prm, void* x, void* v, void* fs,
             void* iscal, void* ring, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
             void* ev_ring, cudaStream_t s) {
  return with_potential<T>(potential, prm, [&](auto pot) {
    return launch<T, decltype(pot)>(p, prm, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v,
                                    ev_fs, ev_ring, s);
  });
}

}  // namespace

extern "C" int suzz_chunk_launch(int f64, int potential, int d, int B, int K, int n_grid,
                                 int adaptive, int signed_bound, double refresh, int cap,
                                 int tile, int seed, int horizon, float t_target,
                                 const void* prm, void* x, void* v, void* fs, void* iscal,
                                 void* ring, void* ev_kind, void* ev_x, void* ev_v,
                                 void* ev_fs, void* ev_ring, void* stream) {
  if (n_grid < 2 || n_grid > MAXG || d < 1 || B < 1 || tile < 1)
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  Params p{d, B, K, n_grid, adaptive, signed_bound, cap, tile, seed, refresh,
           horizon, t_target};
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? dispatch<double>(potential, p, prm, x, v, fs, iscal, ring, ev_kind, ev_x,
                                ev_v, ev_fs, ev_ring, s)
             : dispatch<float>(potential, p, prm, x, v, fs, iscal, ring, ev_kind, ev_x,
                               ev_v, ev_fs, ev_ring, s);
}

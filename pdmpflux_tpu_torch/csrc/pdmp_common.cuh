// Device helpers shared by the fused chunk kernels (zigzag_chunk.cu, K1,
// sticky_chunk.cu, K6, suzz_chunk.cu, K4, and scalar_chunk.cu, K3/K5): the
// Threefry-2x32 counter RNG of the Pallas kernel (pdmpflux_tpu/ops/pallas/
// zigzag_chunk.py: _threefry2x32, _mant24, _uniform, _exponential,
// _box_muller), a NaN-propagating max, the device potentials and the chain
// sums the funnels read, the warp-wide envelope of K3/K5 and K4 (one grid
// point per lane), and the grid-order clock inversion of K1 and K6
// (EnvelopeWalk).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace pdmp {

constexpr int RING = 5, MAXG = 64;
constexpr int F_T = 0, F_TC = 1, F_TS = 2, F_H = 3, F_BH = 4, F_EXP = 5, F_AR = 6, F_TT = 7;
constexpr int I_MODE = 0, I_REJ = 1, I_ERR = 2, I_HIT = 3, I_CNT = 4;
constexpr int MODE_FRESH = 0, MODE_REJECTED = 1, MODE_ERRONEOUS = 2;
constexpr int EV_JUMP = 2, EV_STICK = 3, EV_THAW = 4;

// horizon != 0 is mode="horizon": the lane also freezes once its committed
// clock reaches t_target, the float32 scalar the Pallas kernel reads.
struct Params {
  int d, B, K, n_grid, adaptive, signed_bound, cap, tile, seed;
  double refresh;
  int horizon;
  float t_target;
};

// Whether a lane runs its next transition (zigzag_chunk.py:341-343): below
// its event cap and, in horizon mode, its clock below t_target (a NaN clock
// freezes, as there; events mode never reads the clock).
template <typename T>
__device__ __forceinline__ bool lane_live(const Params& p, int cnt, T t) {
  return cnt < p.cap && (!p.horizon || t < (T)p.t_target);
}

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (zigzag_chunk._threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[8] = {13, 15, 26, 6, 17, 29, 16, 24};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[(block & 1) * 4 + i]);
      x1 ^= x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
}

template <typename T>
__device__ __forceinline__ T mant24(uint32_t bits) {
  return (T)(int)(bits >> 8) * (T)(1.0 / 16777216.0);
}

// (0, 1) uniform from a Threefry block's first word (zigzag_chunk._uniform).
template <typename T>
__device__ __forceinline__ T uniform_bits(uint32_t b0) {
  return mant24<T>(b0) + (T)(0.5 / 16777216.0);
}

// Exp(1) with the 48-bit-deep tail from a Threefry block
// (zigzag_chunk._exponential).
template <typename T>
__device__ __forceinline__ T exponential_bits(uint32_t b0, uint32_t b1) {
  const T u_hi = mant24<T>(b0);
  const T u_lo = mant24<T>(b1) + (T)(0.5 / 16777216.0);
  const bool deep = u_hi == (T)0;
  T u = deep ? u_lo : u_hi + u_lo * (T)(1.0 / 16777216.0);
  const T top = (T)(1.0 - 1.0 / 16777216.0);
  u = u < top ? u : top;
  return (deep ? (T)16.635532333438686 : (T)0) - log(u);
}

// (0, 1) uniform at one counter.
template <typename T>
__device__ __forceinline__ T uniform(uint32_t seed, uint32_t salt, uint32_t counter) {
  uint32_t b0 = counter, b1 = 0;
  threefry2x32(seed, salt, b0, b1);
  return uniform_bits<T>(b0);
}

// Exp(1) at one counter.
template <typename T>
__device__ __forceinline__ T exponential(uint32_t seed, uint32_t salt, uint32_t counter) {
  uint32_t b0 = counter, b1 = 0;
  threefry2x32(seed, salt, b0, b1);
  return exponential_bits<T>(b0, b1);
}

// Draw r of a Zig-Zag-family transition k of the chain at RNG lane ln of its
// tile: r = 0, 1, 2 the uniforms at counters (r + 1) * tile + ln (acceptance,
// flip coordinate, thaw coordinate), r = 3 the Exp clock (salt 0x80000000 +
// k), r = 4 the thaw clock (salt 0xC0000000 + k).  Lanes that take different
// r run one Threefry block each in the same instructions, where one lane
// drawing all of them would run them one after another.
template <typename T>
__device__ __forceinline__ T transition_draw(uint32_t seed, uint32_t k, uint32_t tile,
                                             uint32_t ln, int r) {
  const bool unif = r < 3;
  uint32_t b0 = unif ? (uint32_t)(r + 1) * tile + ln : ln, b1 = 0;
  threefry2x32(seed, unif ? k : (r == 3 ? 0x80000000u : 0xC0000000u) + k, b0, b1);
  return unif ? uniform_bits<T>(b0) : exponential_bits<T>(b0, b1);
}

// A standard normal from two (0, 1) uniforms (zigzag_chunk._box_muller); the
// angle factor is the double 2 * pi rounded to T, as JAX rounds the Python
// float.
template <typename T>
__device__ __forceinline__ T box_muller(T u1, T u2) {
  return sqrt((T)-2 * log(u1)) * cos((T)(2.0 * 3.141592653589793) * u2);
}

// max that propagates NaN, as jnp.maximum does
template <typename T>
__device__ __forceinline__ T nmax(T a, T b) {
  return (isnan(a) || a > b) ? a : b;
}

// The values a potential forms once per transition (Pot::form: each product
// with a constant matrix whose input u is affine in the point, c0 = M u(x)
// and c1 = M du(x; v) at the transition's start, its rows split over the
// chain's lanes), read at time tau of the transition: value q of the chain
// at p[q * ps], a product's c0 rows at offset o, its c1 rows at o + R.  Along
// the linear flow element r is c0[r] + tau c1[r], its tangent c1[r]; along
// the Boomerang's elliptic flow (y = x cos tau + v sin tau) it is
// a cos tau + c1[r] sin tau + mc[r], its tangent c1[r] cos tau - a sin tau,
// with a = c0[r] - mc[r] and mc = M u(0) the constant part (a parameter of
// the potential).  The tags form none (p is null).
template <typename T>
struct Transition {
  const T* p;
  long ps;
  T tau, c, s;
  bool elliptic;

  // the values at time t along the linear flow
  __device__ __forceinline__ Transition at(T t) const {
    return {p, ps, t, (T)1, (T)0, false};
  }
  // the values where the elliptic flow has turned by cos tau = c_, sin tau = s_
  __device__ __forceinline__ Transition turned(T c_, T s_) const {
    return {p, ps, (T)0, c_, s_, true};
  }
  __device__ __forceinline__ void prod(int o, int R, int r, const T* mc, T& val,
                                       T& dval) const {
    const T c0 = p[(long)(o + r) * ps], c1 = p[(long)(o + R + r) * ps];
    if (elliptic) {
      const T m = mc[r];
      const T a = c0 - m;
      val = a * c + c1 * s + m;
      dval = c1 * c - a * s;
    } else {
      val = c0 + tau * c1;
      dval = c1;
    }
  }
};

template <typename T>
__device__ __forceinline__ Transition<T> transition(const T* p, long ps) {
  return {p, ps, (T)0, (T)1, (T)0, false};
}

// The accessor of the point x + v t (coordinate j at x[j * stride], v[j *
// stride]) that the kernels hand a potential's at and sums: yw(j, y, w) gives
// coordinate j's position y = x_j + v_j t and velocity w = v_j, and
// yw.prod(o, R, r, mc, val, dval) a per-transition product's element r there
// (tr: the transition's values at the point's time).
template <typename T>
struct LinearPoint {
  const T* x;
  const T* v;
  long stride;
  T t;
  Transition<T> tr;

  __device__ __forceinline__ void operator()(int j, T& y, T& w) const {
    w = v[j * stride];
    y = x[j * stride] + w * t;
  }
  __device__ __forceinline__ void prod(int o, int R, int r, const T* mc, T& val,
                                       T& dval) const {
    tr.prod(o, R, r, mc, val, dval);
  }
};

template <typename T>
__device__ __forceinline__ LinearPoint<T> linear_point(const T* x, const T* v, long stride,
                                                       T t,
                                                       Transition<T> tr = transition<T>(nullptr,
                                                                                        0)) {
  return {x, v, stride, t, tr};
}

// The accessor of a transition's start that Pot::form reads: yw(j, y, w)
// gives x_j and v_j as they lie.
template <typename T>
__device__ __forceinline__ auto start_point(const T* x, const T* v, long stride) {
  return [=](int j, T& y, T& w) {
    y = x[j * stride];
    w = v[j * stride];
  };
}

// Velocity of coordinate i, va_i = v_i * act_i: x and v point at the chain's
// coordinate 0 with coordinates `stride` apart (K1: a column of the (d, B)
// state, stride B; K6: the chain's shared-memory copy, stride 1); act is the
// chain's activity mask (stride 1), or nullptr where every coordinate moves.
template <typename T>
__device__ __forceinline__ T vel(const T* v, const uint8_t* act, long stride, int i) {
  return (act == nullptr || act[i]) ? v[i * stride] : (T)0;
}

// Sums over a chain's coordinates 1..d-1 that the funnels' coordinate 0
// reads at the evaluation point y: S = sum y_j^2, P = sum y_j va_j, and
// n = d - 1.  A potential says with chain = true that it reads sums, and
// only then does a kernel form them; it forms them through the potential,
// in one of two ways chosen by the kernel's layout:
//  - K3/K5 and K4, where one lane walks the chain: Pot::sums, the sums at
//    the evaluation point itself in coordinate order, as the plain versions
//    add them (utils/potentials.chain_sums), so they agree bit for bit;
//  - K1 and K6, where a chain's coordinates lie across lanes: Pot::Moments,
//    reduced once per transition (after the previous flow, flip, stick or
//    thaw) from Pot::moments_zero by Pot::moment_add over the coordinates,
//    from which the linear flow gives the sums at every time the transition
//    evaluates (Moments::at); these agree with the plain versions to
//    rounding.  The funnels' moments are A = sum x_j^2, Bm = sum x_j va_j and
//    C = sum va_j^2 of the transition's starting point, so
//    S(t) = A + t (2 Bm + t C) and P(t) = Bm + t C.
template <typename T>
struct ChainSums {
  T S, P, n;
};

template <typename T>
struct ChainMoments {
  static constexpr int N = 3;  // the moments a kernel reduces: A, Bm, C
  T m[N];
  T n;

  __device__ __forceinline__ ChainSums<T> at(T t) const {
    return {m[0] + t * ((T)2 * m[1] + t * m[2]), m[1] + t * m[2], n};
  }
};

// A tag that reads no sums: zeros, and no moments.  reads_others says that
// the potential reads coordinates other than the evaluated one (0 and 1, a
// neighbour, any fixed coordinate) through values other threads wrote, so a
// kernel must make the chain visible to every thread before it evaluates
// (K6 takes barriers); a tag reads coordinates 0 and 1 only where its own
// threads flowed them (Banana at coordinates 0 and 1, the funnels from
// registers).  A potential generated from a user's gradient
// (UserPotential, below) brings its own Sums, Moments and reads_others, and
// with point = true a context formed at every point a kernel evaluates (its
// sums and its products with constant matrices): K1 calls Pot::sums there
// from the lane that evaluates the point, as K3/K5 and K4 do everywhere,
// and K6 calls Pot::fill with its whole block, which keeps the context in
// shared_bytes of dynamic shared memory.  With NP > 0 it also forms NP
// values per chain once per transition (Pot::form, on K1 and K3/K5: the
// products whose input is affine in the point), which the kernels keep
// beside the chain's x and v and hand to at and sums inside the point's
// accessor (Transition, above).  A tag's context is its sums alone.
template <typename T>
struct TagPotential {
  static constexpr bool chain = false;
  static constexpr bool point = false;
  static constexpr bool reads_others = false;
  static constexpr long shared_bytes = 0;
  static constexpr int NP = 0;  // values formed once per transition: none
  using Sums = ChainSums<T>;
  using Moments = ChainMoments<T>;

  // the values formed once per transition (K1, K3/K5), run `part` of `parts`
  // from the transition's start yw(j, y, w), into pv at stride ps: none
  template <class F>
  __device__ __forceinline__ static void form(int, int, int, const T*, F, T*, long) {}
  // the sums at one point, one lane walking the chain (K3/K5, K4):
  // yw(j, y, w) gives coordinate j's point and velocity
  template <class F>
  __device__ __forceinline__ static Sums sums(int d, const T*, F) {
    return {(T)0, (T)0, (T)(d - 1)};
  }
  __device__ __forceinline__ static Moments moments_zero(int d) {
    return {{(T)0, (T)0, (T)0}, (T)(d - 1)};
  }
  // coordinate i's terms at the transition's start (y, w), with coordinates
  // 0 and 1 (y0, w0, y1, w1), added to a lane's moments (K1, K6)
  __device__ __forceinline__ static void moment_add(Moments&, int, T, T, T, T, T, T,
                                                    const T*) {}
};

// The funnels' S and P over coordinates 1..d-1.
template <typename T>
struct FunnelSums : TagPotential<T> {
  static constexpr bool chain = true;

  template <class F>
  __device__ __forceinline__ static ChainSums<T> sums(int d, const T*, F yw) {
    ChainSums<T> cs{(T)0, (T)0, (T)(d - 1)};
    for (int j = 1; j < d; ++j) {
      T y, w;
      yw(j, y, w);
      cs.S = j == 1 ? y * y : cs.S + y * y;
      cs.P = j == 1 ? y * w : cs.P + y * w;
    }
    return cs;
  }
  __device__ __forceinline__ static void moment_add(ChainMoments<T>& m, int i, T y, T w, T,
                                                    T, T, T, const T*) {
    if (i == 0) return;  // coordinate 0 left out
    m.m[0] += y * y;
    m.m[1] += y * w;
    m.m[2] += w * w;
  }
};

// Device potentials (utils/potentials.py tags): gradient component i at
// x + va t and its derivative along va, from values: coordinate i's own
// (xi, vi), coordinates 0 and 1 (Banana and the funnels read them), the
// potential's parameters (Aniso's scales) and the chain sums at the same
// point (the funnels).  Every potential's at also takes the kernel's
// accessor yw(j, y, w) of the same point (any coordinate's position and
// velocity there, as Pot::sums takes it); the tags ignore it, a generated
// potential reads its neighbours and fixed coordinates through it.  Each
// tag is written as the plain version (utils/potentials.LANE_POTENTIALS)
// writes it, in jax.grad's order of operations where the formula allows.
template <typename T>
struct Gauss : TagPotential<T> {
  template <class F>
  __device__ __forceinline__ static void at(int, T xi, T vi, T, T, T, T, T t, const T*,
                                            const ChainSums<T>&, F, T& g, T& dg) {
    g = xi + vi * t;
    dg = vi;
  }
};

template <typename T>
struct Banana : TagPotential<T> {  // U = (x0^2 + (x1 - x0^2 + 1)^2 + sum_{k>=2} x_k^2) / 2
  template <class F>
  __device__ __forceinline__ static void at(int i, T xi, T vi, T x0, T v0, T x1, T v1, T t,
                                            const T*, const ChainSums<T>& cs, F yw, T& g,
                                            T& dg) {
    if (i >= 2) {
      Gauss<T>::at(i, xi, vi, x0, v0, x1, v1, t, nullptr, cs, yw, g, dg);
      return;
    }
    const T y0 = x0 + v0 * t, y1 = x1 + v1 * t;
    const T r1 = y1 - (y0 * y0 - (T)1);
    if (i == 0) {
      g = y0 - (T)2 * y0 * r1;
      dg = ((T)1 - (T)2 * r1 + (T)4 * y0 * y0) * v0 - (T)2 * y0 * v1;
    } else {
      g = r1;
      dg = v1 - (T)2 * y0 * v0;
    }
  }
};

// U = sum((x_k / s_k)^2) / 2 with per-coordinate scales s (the "aniso" tag's
// parameters): jax.grad evaluates (x / s) / s, and its derivative along v is
// (v / s) / s.
template <typename T>
struct Aniso : TagPotential<T> {
  template <class F>
  __device__ __forceinline__ static void at(int i, T xi, T vi, T, T, T, T, T t, const T* s,
                                            const ChainSums<T>&, F, T& g, T& dg) {
    const T si = s[i];
    g = (xi + vi * t) / si / si;
    dg = vi / si / si;
  }
};

// U = sum log(1 + x_k^2) (the "cauchy" tag): g = 2 (y q) with
// q = 1 / (y^2 + 1), and along v 2 (v q + y p), p = -(2 (v y)) / (y^2 + 1)^2.
template <typename T>
struct Cauchy : TagPotential<T> {
  template <class F>
  __device__ __forceinline__ static void at(int, T xi, T vi, T, T, T, T, T t, const T*,
                                            const ChainSums<T>&, F, T& g, T& dg) {
    const T y = xi + vi * t;
    const T j = y * y + (T)1;
    const T q = (T)1 / j;
    const T p = -((T)2 * (vi * y)) * ((T)1 / (j * j));
    g = (T)2 * (y * q);
    dg = (T)2 * (vi * q + y * p);
  }
};

// U = sum x_k^2 / 2 + 0.1 sum sin(10 x_k) (the "ridged" tag), as XLA
// compiles jax.grad (the factors 0.1 and 10 folded away):
// g = (cos(10 y) + y / 2) + y / 2, and along v
// (-((10 v) sin(10 y)) + v / 2) + v / 2.
template <typename T>
struct Ridged : TagPotential<T> {
  template <class F>
  __device__ __forceinline__ static void at(int, T xi, T vi, T, T, T, T, T t, const T*,
                                            const ChainSums<T>&, F, T& g, T& dg) {
    const T y = xi + vi * t;
    const T z = (T)10 * y;
    g = (cos(z) + (T)0.5 * y) + (T)0.5 * y;
    dg = (-(((T)10 * vi) * sin(z)) + (T)0.5 * vi) + (T)0.5 * vi;
  }
};

// U = c^2 / 2 + (d - 1) log c + S / (2 c^2), c = y_0 (the "funnel" tag):
// g_0 = (-((S / c^4) c) + (d - 1) / c) + c, g_j = y_j / c^2; along v
// dg_0 = (-(2 P c / c^4 - 3 (S / c^4) v_0) - (d - 1) v_0 / c^2) + v_0 and
// dg_j = v_j / c^2 - 2 v_0 (c / c^4) y_j.
template <typename T>
struct Funnel : FunnelSums<T> {
  template <class F>
  __device__ __forceinline__ static void at(int i, T xi, T vi, T x0, T v0, T, T, T t,
                                            const T*, const ChainSums<T>& cs, F, T& g,
                                            T& dg) {
    const T c = x0 + v0 * t;
    const T c2 = c * c;
    const T r4 = (T)1 / (c2 * c2);
    if (i == 0) {
      g = (-((r4 * cs.S) * c) + cs.n / c) + c;
      const T a1 = (r4 * ((T)2 * cs.P)) * c;
      const T a2 = (T)3 * ((r4 * cs.S) * v0);
      dg = (-(a1 - a2) - (cs.n * v0) / c2) + v0;
    } else {
      const T y = xi + vi * t;
      const T ic2 = (T)1 / c2;
      g = ic2 * y;
      dg = ic2 * vi + ((T)-2 * v0) * (c * r4) * y;
    }
  }
};

// U = c^2 / 18 + (d - 1) c / 2 + S e^{-c} / 2, c = y_0 (the "neal_funnel"
// tag), e = exp(-c), k = 1 / 18, e' = -v_0 e:
// g_0 = ((-((S / 2) e) + (d - 1) / 2) + c k) + c k, g_j = e y_j; along v
// dg_0 = (-(P e + (S / 2) e') + v_0 k) + v_0 k and dg_j = e' y_j + e v_j.
template <typename T>
struct NealFunnel : FunnelSums<T> {
  template <class F>
  __device__ __forceinline__ static void at(int i, T xi, T vi, T x0, T v0, T, T, T t,
                                            const T*, const ChainSums<T>& cs, F, T& g,
                                            T& dg) {
    const T c = x0 + v0 * t;
    const T e = exp(-c);
    const T ed = -v0 * e;
    if (i == 0) {
      const T k = (T)(1.0 / 18.0), half_s = (T)0.5 * cs.S;
      g = ((-(half_s * e) + (T)0.5 * cs.n) + c * k) + c * k;
      dg = (-(cs.P * e + half_s * ed) + v0 * k) + v0 * k;
    } else {
      const T y = xi + vi * t;
      g = e * y;
      dg = ed * y + e * vi;
    }
  }
};

#ifdef PDMPFLUX_USER_POTENTIAL
// A gradient of the user's own, lowered by ops/cuda/lower.py into
// UserPotential<T>: the header is generated per gradient and dtype, and a
// library built with it (ops/cuda/build.user_library:
// -DPDMPFLUX_USER_POTENTIAL and the header's directory on the include path)
// takes potential id 7 alone, in the header's UserScalar alone (the kernels
// are instantiated for that type only).
#include "pdmpflux_user_potential.cuh"

template <typename T>
constexpr bool user_scalar = std::is_same<T, UserScalar>::value;
#endif

// The message of a launcher's CUDA error, exported once per library: by K1's
// source in the kernels' own library, and by the one source of a library
// built with a generated potential.
#if defined(PDMPFLUX_ERROR_STRING) || defined(PDMPFLUX_USER_POTENTIAL)
extern "C" const char* pdmpflux_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
#endif

// f(Pot{}) for the potential of a launcher's id (DEVICE_POTENTIALS in
// utils/potentials.py); "aniso" needs its scales.
template <typename T, class F>
int with_potential(int potential, const void* prm, F&& f) {
#ifdef PDMPFLUX_USER_POTENTIAL
  if constexpr (user_scalar<T>) {
    return potential == 7 ? f(UserPotential<T>{}) : (int)cudaErrorInvalidValue;
  } else {
    (void)potential;
    return (int)cudaErrorInvalidValue;
  }
#else
  switch (potential) {
    case 0: return f(Gauss<T>{});
    case 1: return f(Banana<T>{});
    case 2: return prm != nullptr ? f(Aniso<T>{}) : (int)cudaErrorInvalidValue;
    case 3: return f(Cauchy<T>{});
    case 4: return f(Ridged<T>{});
    case 5: return f(Funnel<T>{});
    case 6: return f(NealFunnel<T>{});
  }
  return (int)cudaErrorInvalidValue;
#endif
}

// ---- the warp-wide envelope of K3/K5 and K4 ----
//
// One warp owns a chain; lane l evaluates the grid points l and l + 32 (for
// those below n_grid, n_grid <= MAXG = 64).  A value of grid point j lies in
// lane j % 32, in the lane's first slot for j < 32 and its second above.

constexpr unsigned FULL_MASK = 0xffffffffu;

// The value of grid point j (the same j in every lane) from the slots a and b.
template <typename T>
__device__ __forceinline__ T at_point(T a, T b, int j) {
  return __shfl_sync(FULL_MASK, j < 32 ? a : b, j & 31);
}

// The tangent-intersection maximum of a rate over one grid segment of length
// step, from its values and time derivatives at both ends (the Pallas
// kernel's segment maxima).
template <typename T>
__device__ __forceinline__ T segment_max(T f_prev, T g_prev, T f, T gd, T step) {
  const T zero = (T)0;
  const T den = gd - g_prev;
  const T num = f_prev - f + gd * step;
  T ip = den == zero ? zero : num / den;
  if (isnan(ip)) ip = zero;
  ip = ip > zero ? ip : zero;
  ip = ip < step ? ip : step;
  const T inter = f_prev + g_prev * ip;
  return nmax(nmax(f_prev, f), nmax(inter, zero));
}

// The clock inversion of the envelope whose box heights are spread over the
// warp: box[j - 1] (segment j - 1, ending at grid point j) lies at grid point
// j in the slots (ba, bb).  Every lane adds cum[j] = cum[j - 1] + box[j - 1] *
// step in grid order, the plain version's order, and counts idx = #{j :
// cum[j] < exp}; each lane keeps cum at its own grid points, and the lanes
// owning idx - 1 and idx hand their values to all.  So tp, lam_bar and the
// overflow come out the same in every lane and every decision after them
// stays warp-uniform.  Every lane must call it.
template <typename T>
__device__ __forceinline__ void invert_envelope(T ba, T bb, T step, T exp_s, int n_grid,
                                                int lane, T& tp, T& lam_bar, bool& overflow) {
  T c = (T)0, ca = (T)0, cb = (T)0;
  int idx = c < exp_s;
  for (int j = 1; j < n_grid; ++j) {
    c = c + at_point(ba, bb, j) * step;
    idx += c < exp_s;
    if (j == lane) ca = c;
    if (j == lane + 32) cb = c;
  }
  overflow = idx >= n_grid;
  tp = (T)INFINITY;
  lam_bar = at_point(ba, bb, n_grid - 1);
  if (idx >= 1 && idx < n_grid) {  // idx is the same in every lane
    const T lo = at_point(ca, cb, idx - 1), hi = at_point(ca, cb, idx);
    const T denom = hi == lo ? (T)1 : hi - lo;
    tp = step * (T)(idx - 1) + (exp_s - lo) / denom * step;
    lam_bar = at_point(ba, bb, idx);
  }
}

// The clock inversion for a caller that reads every box itself, in grid
// order (K1 from its group's shared row of boxes, K6 by shuffle after its
// block reduction): add(box[j]) for j = 0 .. n_grid - 2, then finish().  It adds
// cum[j + 1] = cum[j] + box[j] * step and counts idx = #{j : cum[j] < exp}
// as invert_envelope does.  Every box is >= 0 or NaN, so the points below
// exp are a prefix of the grid: lo = cum[idx - 1] is the last of them, and hi
// = cum[idx] and lam_bar = box[idx - 1] come from the add that follows it.
// No array is kept, so nothing lands in local memory.
template <typename T>
struct EnvelopeWalk {
  T step, exp_s, c = (T)0, lo = (T)0, hi = (T)0, lam_at = (T)0, last = (T)0;
  int idx;

  __device__ __forceinline__ EnvelopeWalk(T step_, T exp_) : step(step_), exp_s(exp_) {
    idx = c < exp_s;
  }

  // box[j], the next segment in grid order; j + 1 points are counted so far
  __device__ __forceinline__ void add(T box, int j) {
    c = c + box * step;
    if (idx == j + 1) {  // every point so far lies below exp: cum[j + 1] is hi
      hi = c;
      lam_at = box;
    }
    if (c < exp_s) {
      lo = c;
      ++idx;
    }
    last = box;
  }

  __device__ __forceinline__ void finish(int n_grid, T& tp, T& lam_bar, bool& overflow) const {
    overflow = idx >= n_grid;
    tp = (T)INFINITY;
    lam_bar = last;
    if (idx >= 1 && idx < n_grid) {
      const T denom = hi == lo ? (T)1 : hi - lo;
      tp = step * (T)(idx - 1) + (exp_s - lo) / denom * step;
      lam_bar = lam_at;
    }
  }
};

}  // namespace pdmp

// Device helpers shared by the fused chunk kernels (zigzag_chunk.cu, K1,
// sticky_chunk.cu, K6, and scalar_chunk.cu, K3/K5): the Threefry-2x32 counter
// RNG of the Pallas kernel (pdmpflux_tpu/ops/pallas/zigzag_chunk.py:
// _threefry2x32, _mant24, _uniform, _exponential, _box_muller), a
// NaN-propagating max, and the device potentials.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

// (0, 1) uniform at one counter (zigzag_chunk._uniform).
template <typename T>
__device__ __forceinline__ T uniform(uint32_t seed, uint32_t salt, uint32_t counter) {
  uint32_t b0 = counter, b1 = 0;
  threefry2x32(seed, salt, b0, b1);
  return mant24<T>(b0) + (T)(0.5 / 16777216.0);
}

// Exp(1) with the 48-bit-deep tail (zigzag_chunk._exponential).
template <typename T>
__device__ __forceinline__ T exponential(uint32_t seed, uint32_t salt, uint32_t counter) {
  uint32_t b0 = counter, b1 = 0;
  threefry2x32(seed, salt, b0, b1);
  const T u_hi = mant24<T>(b0);
  const T u_lo = mant24<T>(b1) + (T)(0.5 / 16777216.0);
  const bool deep = u_hi == (T)0;
  T u = deep ? u_lo : u_hi + u_lo * (T)(1.0 / 16777216.0);
  const T top = (T)(1.0 - 1.0 / 16777216.0);
  u = u < top ? u : top;
  return (deep ? (T)16.635532333438686 : (T)0) - log(u);
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

// Velocity of coordinate i, va_i = v_i * act_i: x and v point at the chain's
// coordinate 0 with coordinates `stride` apart (K1: a column of the (d, B)
// state, stride B; K6: the chain's shared-memory copy, stride 1); act is the
// chain's activity mask (stride 1), or nullptr where every coordinate moves.
template <typename T>
__device__ __forceinline__ T vel(const T* v, const uint8_t* act, long stride, int i) {
  return (act == nullptr || act[i]) ? v[i * stride] : (T)0;
}

// Device potentials (utils/potentials.py tags): gradient component i at
// x + va t and its derivative along va, the layout as in vel().
template <typename T>
struct Gauss {
  __device__ __forceinline__ static void eval(const T* x, const T* v, const uint8_t* act,
                                              long stride, int i, T t, T& g, T& dg) {
    const T vi = vel(v, act, stride, i);
    g = x[i * stride] + vi * t;
    dg = vi;
  }
};

template <typename T>
struct Banana {  // U = (x0^2 + (x1 - x0^2 + 1)^2 + sum_{k>=2} x_k^2) / 2
  __device__ __forceinline__ static void eval(const T* x, const T* v, const uint8_t* act,
                                              long stride, int i, T t, T& g, T& dg) {
    if (i >= 2) {
      Gauss<T>::eval(x, v, act, stride, i, t, g, dg);
      return;
    }
    const T v0 = vel(v, act, stride, 0), v1 = vel(v, act, stride, 1);
    const T x0 = x[0] + v0 * t, x1 = x[stride] + v1 * t;
    const T r1 = x1 - (x0 * x0 - (T)1);
    if (i == 0) {
      g = x0 - (T)2 * x0 * r1;
      dg = ((T)1 - (T)2 * r1 + (T)4 * x0 * x0) * v0 - (T)2 * x0 * v1;
    } else {
      g = r1;
      dg = v1 - (T)2 * x0 * v0;
    }
  }
};

// U = sum((x_k / s_k)^2) / 2 with per-coordinate scales s (the "aniso" tag's
// parameters): jax.grad evaluates (x / s) / s, and its derivative along v is
// (v / s) / s.
template <typename T>
struct Aniso {
  __device__ __forceinline__ static void eval(const T* x, const T* v, const uint8_t* act,
                                              long stride, int i, T t, const T* s, T& g,
                                              T& dg) {
    const T vi = vel(v, act, stride, i);
    const T si = s[i];
    g = (x[i * stride] + vi * t) / si / si;
    dg = vi / si / si;
  }
};

}  // namespace pdmp

// K3 and K5: K fused scalar-rate transitions per chain, one warp per chain,
// the envelope's grid points across its lanes.
//
// Replaces pdmpflux_tpu/ops/pallas/zigzag_chunk.py:run_chunk (line 854, body
// _make_kernel) with kind="bps" or "boomerang" (K3: :349-358, :391-395,
// :424-432, :587-616) or kind="ecmc" (K5: :520-586), in mode "events" and
// "horizon" (K7: lane_live in pdmp_common.cuh; every lane of a chain's warp
// reads the same clock, so the freeze stays warp-uniform).  The
// plain PyTorch version is run_chunk_plain in ops/cuda/scalar_chunk.py; both
// draw the Pallas kernel's Threefry counters (key (seed + (b / tile) * 7919,
// k), counter row * tile + b % tile; the Exp clock on salt 0x80000000 + k), so
// trajectories agree to rounding.
//
// The transition: the scalar rate f(t) = <g(x_t), v_t> and its time derivative
// (<dg, v_t>, plus <g, -x_t> on the elliptic flow, whose dv_t/dt = -x_t) at the
// n_grid grid times give the tangent-intersection envelope (signed: refresh
// added once after the max with 0; unsigned: f = max(f, 0) + refresh with the
// derivative halved where f == 0, as JAX's max JVP); the clock inversion,
// thinning on max(0, <g, v>) + refresh, flow, jump, Kahan commit and horizon
// adaptation are K1's.  g is grad U (BPS, ECMC) or grad U(x) - x (Boomerang).
// The jumps: K3 reflects v on g with probability max(0, <g, v>) / (that +
// refresh) (uniform row 2) or refreshes from the Box-Muller rows 3 .. 3 + 2d,
// normalized unless gaussian_velocity; K5 is the Forward-ECMC gradient-frame
// jump (rows 2-5: radial pair, mix, angle; Box-Muller blocks from row 6).
//
// Design.  The repo's deployments of these samplers run a few hundred chains
// (B = 512 at d = 10): K1's thread per chain would occupy 4 of 132 SMs.  Here
// one warp owns one chain for all K transitions, four chains to a block
// (B = 512 gives 128 blocks); the chain's vectors (x, v, the jump's g and
// normals, three reduction rows, ECMC's frame vectors) sit in the warp's slice
// of shared memory, and every per-chain scalar is replicated in all 32 lanes.
// The envelope's grid points are independent until the cumulative sum, so
// they go across the lanes: lane l evaluates the rate and its derivative at
// grid points l and l + 32 (pdmp_common.cuh: invert_envelope), adding the
// coordinates 0, 1, ..., d - 1 in order in registers; takes the previous
// point's pair from its neighbour by __shfl_up_sync for its segment maximum;
// then every lane gathers the boxes by __shfl_sync and adds the cumulative sum
// in grid order, so tp and the envelope's height come out the same in every
// lane and every decision (thinning, bounce, degenerate frame, sign) is taken
// alike without a broadcast.  Thinning at tp and the jumps spread the
// coordinates over the lanes (i = lane, lane + 32, ...): a dot product writes
// its terms to a reduction row and after __syncwarp every lane sums the row
// in coordinate order (for thinning this measured 5% faster on the BPS
// deployment than every lane's own pass, which gives the same bits).  The
// plain version adds in the same orders, and this file is compiled with
// -fmad=false (ops/cuda/build.py), so products round before they are added as
// torch's elementwise ops round them: on the card the kernel and the plain
// version differ only where a math function does (none of log, cos, sin, sqrt
// or pow does, as both call CUDA's), which keeps BPS reflections, which
// amplify any difference along a trajectory, from drifting apart.  Scalar
// uniforms are drawn by every lane; per-coordinate ones by the lane owning the
// coordinate.  The funnels' coordinate 0 reads sums over the chain's other
// coordinates at the evaluation point (pdmp_common.cuh: ChainSums): every
// lane adds them in coordinate order before its pass over a grid point,
// and before thinning and the jump, as the plain version adds them.  A
// potential generated from a user's gradient forms its products with a
// constant matrix whose input is affine in the point once per transition
// (Pot::NP > 0, Pot::form): at the transition's start the lanes split their
// rows, each row added in column order, c0 = M u(x) and c1 = M du(x; v) into
// the chain's shared slice beside X and V; after a __syncwarp every point
// (a grid point, thinning's, the jump's after the flow) reads element r
// through its accessor at its time t of the transition, c0 + t c1 on the
// linear flow and from cos t and sin t on the elliptic one (Transition in
// pdmp_common.cuh), as the plain version reads them (Lowered.along).
//
// What bounds it on an H100: latency.  Per transition the critical path is
// one lane's ordered O(d) pass over its grid point (the gradient, two products
// and two dependent adds per coordinate), n_grid - 1 dependent shuffles and
// adds of the cumulative sum, thinning's and the jump's ordered sums through
// shared memory and three Threefry blocks, against (2 d + 12) *
// sizeof(T) bytes of event row; the bound (chip_smoke.py) counts the
// operations.  At n_grid = 10, 22 of the 32 lanes idle in the envelope.
// Later work: several chains per warp at small d, K5's jump (about twelve
// ordered sums), staged row stores (a lane's row store goes to stride B).
//
// Shared memory: a chain's NVEC * d + Pot::NP values (its vectors, then the
// values its potential forms once per transition), 4 chains to a block, must
// fit the 227 KB a block can have, so d <= scalar_chunk_max_dim(f64): 1210
// in f32, 605 in f64 for the tags.  A generated potential with NP > 0 takes
// as many chains per block as fit, from 4 down to 1, so its d reaches
// (227 KB / sizeof(T) - NP) / NVEC (read from its own build: 2088 in f64
// beside the 4000 values of a dense quadratic form's two products at
// d = 1000).

#include "pdmp_common.cuh"

namespace {

using namespace pdmp;

constexpr int WARPS = 4;   // chains per block
constexpr int NVEC = 12;   // shared vectors of d values per chain
constexpr long SMEM_BLOCK = 232448;  // bytes of shared memory one block may use
constexpr int KIND_BOOMERANG = 1, KIND_ECMC = 2;
constexpr double TWO_PI = 2.0 * 3.141592653589793;

struct Jump {
  int kind, gaussian_velocity, ran_p, switch_, positive, normal;
  double mix_p, sf;
};

// The sums Pot reads (the funnels': over coordinates 1..d-1) at x + v t, x
// and v the chain's d shared values, in coordinate order as the plain
// version adds them (pdmp_common.cuh: Pot::sums); zeros for a potential that
// does not read them.
template <typename T, class Pot>
__device__ __forceinline__ typename Pot::Sums sums_at(const T* x, const T* v, int d, T t,
                                                      const T* prm, const Transition<T>& tr) {
  return Pot::sums(d, prm, linear_point(x, v, 1, t, tr));
}

// Gradient component i at x + v t and its derivative along v, x and v the
// chain's d shared values; the "aniso" potential reads its scales from prm,
// the funnels their chain sums cs at the same point, a generated potential
// its neighbours, fixed coordinates and per-transition products (tr, at the
// point's time of the transition) through the point's accessor.
template <typename T, class Pot>
__device__ __forceinline__ void grad_at(const T* x, const T* v, int d, int i, T t,
                                        const T* prm, const typename Pot::Sums& cs,
                                        const Transition<T>& tr, T& g, T& dg) {
  const int i1 = d > 1 ? 1 : 0;
  Pot::at(i, x[i], v[i], x[0], v[0], x[i1], v[i1], t, prm, cs, linear_point(x, v, 1, t, tr), g,
          dg);
}

// The point of the elliptic flow turned by cos t = c, sin t = s from the
// chain's x and v: yw(j, y, w) gives y = x_j c + v_j s and w = -x_j s + v_j c,
// yw.prod a per-transition product there.
template <typename T>
struct EllipticPoint {
  const T* X;
  const T* V;
  T c, s;
  Transition<T> tr;

  __device__ __forceinline__ void operator()(int j, T& y, T& w) const {
    y = X[j] * c + V[j] * s;
    w = -X[j] * s + V[j] * c;
  }
  __device__ __forceinline__ void prod(int o, int R, int r, const T* mc, T& val,
                                       T& dval) const {
    tr.prod(o, R, r, mc, val, dval);
  }
};

// Values of one chain's shared slice: its NVEC vectors of d, then the values
// its potential forms once per transition.
template <class Pot>
__host__ __device__ __forceinline__ long chain_values(int d) {
  return (long)NVEC * d + Pot::NP;
}

// Chains per block: WARPS, or for a potential that forms values once per
// transition as many as fit the block's shared memory (at least 1 where d is
// at most max_dim).
template <typename T, class Pot>
int chains_per_block(int d) {
  if (Pot::NP == 0) return WARPS;
  const long fit = SMEM_BLOCK / (chain_values<Pot>(d) * (long)sizeof(T));
  return (int)(fit < WARPS ? (fit < 1 ? 1 : fit) : WARPS);
}

// Sum of r[0..d) in coordinate order, r[0] + r[1] + ..., the same bits in
// every lane and in the plain version.  The leading __syncwarp publishes the
// lanes' terms; the trailing one keeps r from being rewritten before every
// lane has read it.
template <typename T>
__device__ __forceinline__ T row_sum(const T* r, int d) {
  __syncwarp();
  T s = r[0];
  for (int i = 1; i < d; ++i) s += r[i];
  __syncwarp();
  return s;
}

template <typename T>
__device__ __forceinline__ T nonzero(T a) {
  return a > (T)0 ? a : (T)1;
}

template <typename T, class Pot>
__global__ void __launch_bounds__(32 * WARPS)
scalar_chunk_kernel(Params p, Jump jp, const T* __restrict__ prm, T* __restrict__ x,
                    T* __restrict__ v, T* __restrict__ fs, int* __restrict__ iscal,
                    T* __restrict__ ring, int* __restrict__ ev_kind, T* __restrict__ ev_x,
                    T* __restrict__ ev_v, T* __restrict__ ev_fs, T* __restrict__ ev_ring) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int d = p.d, n_grid = p.n_grid, G = p.n_grid - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the block's chains: WARPS, or as many as chains_per_block fitted
  const int chains = Pot::NP == 0 ? WARPS : (int)(blockDim.x >> 5);
  const long B = p.B, b = (long)blockIdx.x * chains + warp;
  if (b >= B) return;  // a whole warp leaves: no block-wide barrier follows
  const bool elliptic = jp.kind == KIND_BOOMERANG;

  T* X = (T*)smem + (long)warp * chain_values<Pot>(d);
  T* V = X + d;
  T* Y = V + d;    // thinning's flowed position, then K3's g
  T* W = Y + d;    // thinning's flowed velocity, then K3's refresh normals
  T* R0 = W + d;   // reduction rows
  T* R1 = R0 + d;
  T* R2 = R1 + d;
  T* N = R2 + d;   // ECMC: the unit gradient
  T* VO = N + d;   // ECMC: the orthogonal component
  T* E1 = VO + d;  // ECMC: the switch plane (or the refreshed direction)
  T* E2 = E1 + d;
  T* VP = E2 + d;  // ECMC: fresh orthogonal draw, then the proposal
  T* PV = VP + d;  // the values the potential forms once per transition

  for (int i = lane; i < d; i += 32) {
    X[i] = x[i * B + b];
    V[i] = v[i * B + b];
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

  // the chain's per-transition values (Pot::form), read at a point's time
  const Transition<T> tr = transition<T>(PV, 1);

  // <g(x_t), v_t> at time t and its time derivative df, taken by this lane
  // alone from the shared x and v: per coordinate the gradient at the flowed
  // state (grad U(y) - y at y = x cos t + v sin t on the elliptic flow, whose
  // dv_t/dt = -x_t), the products, and the adds in coordinate order, as
  // row_sum and the plain version add.
  auto lane_rate = [&](T t, T& df) -> T {
    T f = zero;
    df = zero;
    if (elliptic) {
      const T c = cos(t), s = sin(t);
      const int i1 = d > 1 ? 1 : 0;
      const T y0 = X[0] * c + V[0] * s, w0 = -X[0] * s + V[0] * c;
      const T y1 = X[i1] * c + V[i1] * s, w1 = -X[i1] * s + V[i1] * c;
      // the point on the elliptic flow, read by coordinate
      const EllipticPoint<T> point{X, V, c, s, tr.turned(c, s)};
      const auto cs = Pot::sums(d, prm, point);
      for (int i = 0; i < d; ++i) {
        const T yi = X[i] * c + V[i] * s, wi = -X[i] * s + V[i] * c;
        T g, dg;
        Pot::at(i, yi, wi, y0, w0, y1, w1, zero, prm, cs, point, g, dg);
        g = g - yi;   // grad U_eff = grad U(x) - x
        dg = dg - wi;
        const T r0 = g * wi, r1 = dg * wi + g * -yi;
        f = i == 0 ? r0 : f + r0;
        df = i == 0 ? r1 : df + r1;
      }
    } else {
      const auto cs = sums_at<T, Pot>(X, V, d, t, prm, tr.at(t));
      for (int i = 0; i < d; ++i) {
        T g, dg;
        grad_at<T, Pot>(X, V, d, i, t, prm, cs, tr.at(t), g, dg);
        const T r0 = g * V[i], r1 = dg * V[i];
        f = i == 0 ? r0 : f + r0;
        df = i == 0 ? r1 : df + r1;
      }
    }
    return f;
  };

  // The rate pair at grid point j of step (zeros past the grid); unsigned:
  // max(f, 0) + refresh, JAX's JVP of max taking half the tangent at f == 0.
  auto grid_pair = [&](int j, T step, T& f, T& gd) {
    f = gd = zero;
    if (j >= n_grid) return;
    f = lane_rate(step * (T)j, gd);
    if (!p.signed_bound) {
      const T coef = f > zero ? (T)1 : (f == zero ? (T)0.5 : zero);
      gd = gd * coef;
      f = nmax(f, zero) + refresh;
    }
  };

  for (int k = 0; k < p.K; ++k) {
    const bool live = lane_live(p, cnt, t_s);  // t_s is the same in every lane
    int kval = 0;
    if (live) {
      // ---- the products formed once per transition, rows across lanes ----
      if constexpr (Pot::NP > 0) {
        Pot::form(d, lane, 32, prm, start_point(X, V, 1), PV, 1);
        __syncwarp();
      }

      // ---- envelope of the scalar rate on [0, bh], grid points across lanes ----
      const T step = bh_s / (T)G;
      const bool two = n_grid > 32;  // the same in every lane
      T fa, ga, fb = zero, gb = zero;
      grid_pair(lane, step, fa, ga);
      T fpa = __shfl_up_sync(FULL_MASK, fa, 1), gpa = __shfl_up_sync(FULL_MASK, ga, 1);
      // box[j - 1] of this lane's grid point j, read where 1 <= j < n_grid
      T ba = segment_max(fpa, gpa, fa, ga, step), bb = zero;
      if (two) {
        grid_pair(lane + 32, step, fb, gb);
        T fpb = __shfl_up_sync(FULL_MASK, fb, 1), gpb = __shfl_up_sync(FULL_MASK, gb, 1);
        const T f31 = __shfl_sync(FULL_MASK, fa, 31), g31 = __shfl_sync(FULL_MASK, ga, 31);
        if (lane == 0) {  // point 32's predecessor is lane 31's first point
          fpb = f31;
          gpb = g31;
        }
        bb = segment_max(fpb, gpb, fb, gb, step);
      }
      if (p.signed_bound) {
        ba = ba + refresh;
        bb = bb + refresh;
      }

      // ---- invert the envelope at the Exp clock ----
      T tp, lam_bar;
      bool overflow;
      invert_envelope(ba, bb, step, exp_s, n_grid, lane, tp, lam_bar, overflow);
      const bool fresh = mode == MODE_FRESH, erroneous = mode == MODE_ERRONEOUS;
      const T tp_safe = overflow ? zero : tp;

      // ---- thinning at tp on max(0, <g, v>) + refresh, coordinates across lanes ----
      if (elliptic) {
        const T c = cos(tp_safe), s = sin(tp_safe);
        for (int i = lane; i < d; i += 32) {
          Y[i] = X[i] * c + V[i] * s;
          W[i] = -X[i] * s + V[i] * c;
        }
        __syncwarp();
        const Transition<T> at_tp = tr.turned(c, s);
        const auto cs = sums_at<T, Pot>(Y, W, d, zero, prm, at_tp);
        for (int i = lane; i < d; i += 32) {
          T g, dg;
          grad_at<T, Pot>(Y, W, d, i, zero, prm, cs, at_tp, g, dg);
          R0[i] = (g - Y[i]) * W[i];
        }
      } else {
        const auto cs = sums_at<T, Pot>(X, V, d, tp_safe, prm, tr.at(tp_safe));
        for (int i = lane; i < d; i += 32) {
          T g, dg;
          grad_at<T, Pot>(X, V, d, i, tp_safe, prm, cs, tr.at(tp_safe), g, dg);
          R0[i] = g * V[i];
        }
      }
      const T lam_t = nmax(zero, row_sum(R0, d)) + refresh;
      const T ar_new = lam_t / lam_bar;

      const bool beyond = tp > h_s;
      const bool p_moveh = beyond && !erroneous;
      const bool p_erreset = beyond && erroneous;
      const bool p_ac = !beyond;
      const bool p_err = p_ac && (ar_new > (T)1);
      const bool p_proxy = p_ac && !p_err;
      const uint32_t salt = (uint32_t)k;
      const bool acc = uniform<T>(seed, salt, 1u * tile + ln) < ar_new;
      const bool p_acc = p_proxy && acc;
      const bool p_rej = p_proxy && !acc;

      // ---- flow (v too on the elliptic flow); flow_t == 0 keeps x, v ----
      const T flow_t = p_moveh ? h_s : (p_acc ? tp_safe : zero);
      __syncwarp();  // every lane has read x and v before the lanes rewrite them
      if (elliptic) {
        const T c = cos(flow_t), s = sin(flow_t);
        for (int i = lane; i < d; i += 32) {
          const T xi = X[i], vi = V[i];
          X[i] = xi * c + vi * s;
          V[i] = -xi * s + vi * c;
        }
      } else {
        for (int i = lane; i < d; i += 32) X[i] = X[i] + V[i] * flow_t;
      }
      __syncwarp();

      // ---- velocity jump at x_new (uniform over the warp) ----
      // the per-transition values at flow_t, where the flow took x and v
      Transition<T> tr_new = tr;
      if constexpr (Pot::NP > 0)
        tr_new = elliptic ? tr.turned(cos(flow_t), sin(flow_t)) : tr.at(flow_t);
      typename Pot::Sums cs_new{};  // read only on a jump
      if (p_acc) cs_new = sums_at<T, Pot>(X, V, d, zero, prm, tr_new);
      if (p_acc && jp.kind != KIND_ECMC) {
        // K3: bounce or refresh
        for (int i = lane; i < d; i += 32) {
          T g, dg;
          grad_at<T, Pot>(X, V, d, i, zero, prm, cs_new, tr_new, g, dg);
          if (elliptic) g = g - X[i];
          const T z = box_muller(uniform<T>(seed, salt, (3u + i) * tile + ln),
                                 uniform<T>(seed, salt, (3u + d + i) * tile + ln));
          Y[i] = g;
          W[i] = z;
          R0[i] = g * V[i];
          R1[i] = g * g;
          R2[i] = z * z;
        }
        const T gv = row_sum(R0, d), gg = row_sum(R1, d), zz = row_sum(R2, d);
        const T br = nmax(zero, gv);
        const T denom_b = br + refresh;
        const T prob = denom_b > zero ? br / denom_b : zero;
        const T scale = (T)2 * gv / nonzero(gg);
        const bool bounce = uniform<T>(seed, salt, 2u * tile + ln) < prob;
        const T nrm = jp.gaussian_velocity ? (T)1 : nonzero(sqrt(zz));
        for (int i = lane; i < d; i += 32) {
          const T reflect = gg > zero ? V[i] - scale * Y[i] : V[i];
          V[i] = bounce ? reflect : W[i] / nrm;
        }
      } else if (p_acc) {
        // K5: the gradient-frame jump
        const T u_rho = uniform<T>(seed, salt, 2u * tile + ln);
        const T u_mix = uniform<T>(seed, salt, 4u * tile + ln);
        auto bm = [&](int block, int i) {  // Box-Muller block `block` from row 6
          const uint32_t r1 = 6u + (uint32_t)(2 * block) * d + i;
          return box_muller(uniform<T>(seed, salt, r1 * tile + ln),
                            uniform<T>(seed, salt, (r1 + d) * tile + ln));
        };
        for (int i = lane; i < d; i += 32) {
          T g, dg;
          grad_at<T, Pot>(X, V, d, i, zero, prm, cs_new, tr_new, g, dg);
          N[i] = g;
          R0[i] = g * g;
        }
        const T gn = sqrt(row_sum(R0, d));
        for (int i = lane; i < d; i += 32) {
          const T n = gn > zero ? N[i] / gn : zero;
          const T fo = bm(0, i);
          N[i] = n;
          VP[i] = fo;
          R0[i] = V[i] * n;
          R1[i] = fo * n;
        }
        const T vp = row_sum(R0, d), fn = row_sum(R1, d);
        for (int i = lane; i < d; i += 32) {
          const T vo = V[i] - vp * N[i];
          VO[i] = vo;
          VP[i] = VP[i] - fn * N[i];
          R0[i] = vo * vo;
        }
        if (sqrt(row_sum(R0, d)) < (T)1e-10)  // degenerate orthogonal component
          for (int i = lane; i < d; i += 32) VO[i] = VP[i];
        if (jp.switch_) {
          // orthogonal switch: rotate v_o within a random plane orthogonal to n
          for (int i = lane; i < d; i += 32) {
            E1[i] = bm(1, i);
            E2[i] = bm(2, i);
            R0[i] = E1[i] * N[i];
            R1[i] = E2[i] * N[i];
          }
          const T s1 = row_sum(R0, d), s2 = row_sum(R1, d);
          for (int i = lane; i < d; i += 32) {
            E1[i] = E1[i] - s1 * N[i];
            E2[i] = E2[i] - s2 * N[i];
            R0[i] = E1[i] * E1[i];
          }
          const T n1 = nonzero(sqrt(row_sum(R0, d)));
          for (int i = lane; i < d; i += 32) {
            E1[i] = E1[i] / n1;
            R0[i] = E2[i] * E1[i];
          }
          const T s3 = row_sum(R0, d);
          for (int i = lane; i < d; i += 32) {
            E2[i] = E2[i] - s3 * E1[i];
            R0[i] = E2[i] * E2[i];
          }
          const T n2 = nonzero(sqrt(row_sum(R0, d)));
          for (int i = lane; i < d; i += 32) {
            E2[i] = E2[i] / n2;
            R0[i] = VO[i] * E1[i];
            R1[i] = VO[i] * E2[i];
          }
          const T c1 = row_sum(R0, d), c2 = row_sum(R1, d);
          T ct = zero, st = zero;
          if (jp.ran_p) {
            const T theta = uniform<T>(seed, salt, 5u * tile + ln) * (T)TWO_PI;
            ct = cos(theta);
            st = sin(theta);
          }
          for (int i = lane; i < d; i += 32) {
            const T e1 = E1[i], e2 = E2[i];
            const T v_r = VO[i] - c1 * e1 - c2 * e2;
            const T prop = jp.ran_p ? v_r + (ct * e1 + st * e2) * c1 + (st * e1 - ct * e2) * c2
                                    : v_r + e2 * c1 + e1 * c2;
            VP[i] = prop;
            R0[i] = VO[i] * prop;
          }
          if (jp.positive) {
            const T dot = row_sum(R0, d);
            const T sgn = dot > zero ? (T)1 : (dot < zero ? (T)-1 : dot);  // jnp.sign
            const T mult = sgn == zero ? (T)1 : sgn;
            for (int i = lane; i < d; i += 32) VP[i] = VP[i] * mult;
          }
        } else {
          // full orthogonal refresh
          for (int i = lane; i < d; i += 32) {
            E1[i] = bm(1, i);
            R0[i] = E1[i] * E1[i];
          }
          const T ng = nonzero(sqrt(row_sum(R0, d)));
          for (int i = lane; i < d; i += 32) {
            E1[i] = E1[i] / ng;
            R0[i] = E1[i] * N[i];
          }
          const T sg = row_sum(R0, d);
          for (int i = lane; i < d; i += 32) VP[i] = E1[i] - sg * N[i];
        }
        __syncwarp();
        const bool do_ref = u_mix < (T)jp.mix_p;
        for (int i = lane; i < d; i += 32) {
          const T sel = do_ref ? VP[i] : VO[i];
          VP[i] = sel;
          R0[i] = sel * sel;
        }
        const T mag2 = row_sum(R0, d);
        const T nrm = nonzero(sqrt(mag2));
        const T sf = (T)jp.sf, sf2 = (T)(jp.sf * jp.sf);
        T rho, tang;
        if (jp.normal) {
          rho = sf * -fabs(box_muller(u_rho, uniform<T>(seed, salt, 3u * tile + ln)));
          tang = sqrt(nmax(zero, sf2 * mag2 - rho * rho));
        } else {
          // torch's pow squares for the exponent 2 and takes sqrt for 0.5
          const T e = (T)(2.0 / (d - 1));
          const T pw = e == (T)2 ? u_rho * u_rho : (e == (T)0.5 ? sqrt(u_rho) : pow(u_rho, e));
          rho = sf * -sqrt((T)1 - pw);
          tang = sqrt(nmax(zero, sf2 - rho * rho));
        }
        for (int i = lane; i < d; i += 32) V[i] = VP[i] / nrm * tang + rho * N[i];
      }
      __syncwarp();

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
      ev_x[(row * d + i) * B + b] = X[i];
      ev_v[(row * d + i) * B + b] = V[i];
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

  for (int i = lane; i < d; i += 32) {
    x[i * B + b] = X[i];
    v[i * B + b] = V[i];
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

// The largest d whose chain slices fit a block: 4 chains of NVEC vectors for
// a potential that forms no values per transition, else one chain of NVEC
// vectors and its NP values.
template <typename T, class Pot>
long max_dim() {
  return Pot::NP == 0 ? SMEM_BLOCK / ((long)WARPS * NVEC * sizeof(T))
                      : (SMEM_BLOCK / (long)sizeof(T) - Pot::NP) / NVEC;
}

template <typename T, class Pot>
int launch(const Params& p, const Jump& jp, const void* prm, void* x, void* v, void* fs,
           void* iscal, void* ring, void* ev_kind, void* ev_x, void* ev_v, void* ev_fs,
           void* ev_ring, cudaStream_t stream) {
  if (p.d > max_dim<T, Pot>()) return (int)cudaErrorInvalidValue;
  const int chains = chains_per_block<T, Pot>(p.d);
  const size_t smem = (size_t)chains * chain_values<Pot>(p.d) * sizeof(T);
  auto kern = scalar_chunk_kernel<T, Pot>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (p.B + chains - 1) / chains;
  kern<<<blocks, 32 * chains, smem, stream>>>(
      p, jp, (const T*)prm, (T*)x, (T*)v, (T*)fs, (int*)iscal, (T*)ring, (int*)ev_kind,
      (T*)ev_x, (T*)ev_v, (T*)ev_fs, (T*)ev_ring);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int potential, const Params& p, const Jump& jp, const void* prm, void* x,
             void* v, void* fs, void* iscal, void* ring, void* ev_kind, void* ev_x,
             void* ev_v, void* ev_fs, void* ev_ring, cudaStream_t s) {
  return with_potential<T>(potential, prm, [&](auto pot) {
    return launch<T, decltype(pot)>(p, jp, prm, x, v, fs, iscal, ring, ev_kind, ev_x, ev_v,
                                    ev_fs, ev_ring, s);
  });
}

}  // namespace

// The largest d of the library's potential: the tags', or a generated
// potential's, which its own build reports for its one dtype.
extern "C" long scalar_chunk_max_dim(int f64) {
#ifdef PDMPFLUX_USER_POTENTIAL
  if (f64 == (int)std::is_same<UserScalar, double>::value)
    return max_dim<UserScalar, UserPotential<UserScalar>>();
#endif
  return f64 ? max_dim<double, TagPotential<double>>() : max_dim<float, TagPotential<float>>();
}

extern "C" int scalar_chunk_launch(int f64, int kind, int potential, int d, int B, int K,
                                   int n_grid, int adaptive, int signed_bound,
                                   double refresh, int cap, int tile, int seed,
                                   int horizon, float t_target, int gaussian_velocity,
                                   int ran_p, double mix_p,
                                   int switch_, int positive, double sf, int normal,
                                   const void* prm, void* x, void* v, void* fs, void* iscal,
                                   void* ring, void* ev_kind, void* ev_x, void* ev_v,
                                   void* ev_fs, void* ev_ring, void* stream) {
  if (n_grid < 2 || n_grid > MAXG || d < 1 || B < 1 || tile < 1 || kind < 0 ||
      kind > KIND_ECMC || (kind == KIND_ECMC && d < 2))
    return (int)cudaErrorInvalidValue;
  cudaGetLastError();  // clear a stale error so the check below is this launch's
  Params p{d, B, K, n_grid, adaptive, signed_bound, cap, tile, seed, refresh,
           horizon, t_target};
  Jump jp{kind, gaussian_velocity, ran_p, switch_, positive, normal, mix_p, sf};
  cudaStream_t s = (cudaStream_t)stream;
  return f64 ? dispatch<double>(potential, p, jp, prm, x, v, fs, iscal, ring, ev_kind, ev_x,
                                ev_v, ev_fs, ev_ring, s)
             : dispatch<float>(potential, p, jp, prm, x, v, fs, iscal, ring, ev_kind, ev_x,
                               ev_v, ev_fs, ev_ring, s);
}

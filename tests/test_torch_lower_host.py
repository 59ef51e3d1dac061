"""The generated ``UserPotential<T>`` compiled for the host and run there.

No ``nvcc`` runs on the CPU, so the CUDA kernels' generated potential is
otherwise first compiled on the card.  Here the header of a lowered gradient
is compiled with the host's C++ compiler inside a small stand-in for the
CUDA names it uses (one lane of one chain: ``threadIdx`` 0, shuffles and
barriers that return their own value), with ``-ffp-contract=off`` as the
kernels build with ``-fmad=false``, and its lane path is run on the CPU:
``form`` at the transition's start (one part), ``sums`` at the point and
``at`` for every coordinate, exactly as K1 in point mode, K3/K5 and K4 call
them.  Its pair is held against the plain version's (``Lowered.along`` or
``grad_jvp``) bit for bit in float64, on gradients whose arithmetic the host
and torch round alike (adds, products, divides, ``exp``).  K6's block
``fill`` needs threads; its header is compiled, not run.  Skipped where
there is no ``g++``.
"""

import hashlib
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pdmpflux_tpu_torch.models.base import resolve_potential  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from test_torch_lower_regression import STAGE_READS, TARGETS  # noqa: E402

PRELUDE = r'''
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <vector>
#define __device__
#define __forceinline__ inline
#define __shared__ static
using std::max;
using std::min;
struct Dim3 { unsigned x; };
static Dim3 threadIdx{0}, blockDim{1};
inline void __syncthreads() {}
inline void __syncwarp(unsigned = 0xffffffffu) {}
template <class T> T __shfl_sync(unsigned, T v, int, int = 32) { return v; }
template <class T> T __shfl_xor_sync(unsigned, T, int, int = 32) { return (T)0; }
template <class T> T __shfl_up_sync(unsigned, T v, int, int = 32) { return v; }
namespace pdmp {
template <typename T>
struct Transition {  // csrc/pdmp_common.cuh's, on the linear flow
  const T* p;
  long ps;
  T tau;
  void prod(int o, int R, int r, const T*, T& val, T& dval) const {
    val = p[(long)(o + r) * ps] + tau * p[(long)(o + R + r) * ps];
    dval = p[(long)(o + R + r) * ps];
  }
};
template <typename T>
struct LinearPoint {  // csrc/pdmp_common.cuh's
  const T* x;
  const T* v;
  T t;
  Transition<T> tr;
  void operator()(int j, T& y, T& w) const { w = v[j]; y = x[j] + w * t; }
  void prod(int o, int R, int r, const T* mc, T& val, T& dval) const {
    tr.prod(o, R, r, mc, val, dval);
  }
};
#include "potential.h"
}
'''

RUN = r'''
int main(int argc, char** argv) {
  using Pot = pdmp::UserPotential<double>;
  FILE* f = fopen(argv[1], "rb");
  int d, np, B;
  if (fread(&d, 4, 1, f) + fread(&np, 4, 1, f) + fread(&B, 4, 1, f) != 3) return 1;
  std::vector<double> prm(np), X(d * B), V(d * B), tt(B), out(2 * d * B);
  std::vector<double> pv(Pot::NP > 0 ? Pot::NP : 1);
  if (fread(prm.data(), 8, np, f) + fread(X.data(), 8, d * B, f) + fread(V.data(), 8, d * B, f)
      + fread(tt.data(), 8, B, f) != (size_t)(np + 2 * d * B + B)) return 1;
  fclose(f);
  for (int b = 0; b < B; ++b) {
    std::vector<double> x(d), v(d);
    for (int i = 0; i < d; ++i) {
      x[i] = X[i * B + b];
      v[i] = V[i * B + b];
    }
#if FORM  // the values formed once per transition
    auto start = [&](int j, double& y, double& w) { y = x[j]; w = v[j]; };
    Pot::form(d, 0, 1, prm.data(), start, pv.data(), 1);
#endif
    pdmp::LinearPoint<double> pt{x.data(), v.data(), tt[b], {pv.data(), 1, tt[b]}};
    const auto cs = Pot::sums(d, prm.data(), pt);
    const int i1 = d > 1 ? 1 : 0;
    for (int i = 0; i < d; ++i)
      Pot::at(i, x[i], v[i], x[0], v[0], x[i1], v[i1], tt[b], prm.data(), cs, pt,
              out[i * B + b], out[(d + i) * B + b]);
  }
  f = fopen(argv[2], "wb");
  fwrite(out.data(), 8, 2 * d * B, f);
  fclose(f);
  return 0;
}
'''

COMPILE_ONLY = r'''
template <class T> void instantiate() {
  using P = pdmp::UserPotential<T>;
  T prm[4] = {}, shm[4] = {}, g, dg;
  auto yw = [&](int j, T& y, T& w) { y = prm[j]; w = prm[j]; };
  const auto cs = P::fill(4, prm, shm, yw);
  P::at(0, prm[0], prm[0], prm[0], prm[0], prm[0], prm[0], prm[0], prm, cs, yw, g, dg);
}
int main() { instantiate<double>(); instantiate<float>(); return 0; }
'''

LANE_KERNELS = ("zigzag", "suzz", "bps", "ecmc")


@pytest.fixture(scope="module")
def cxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("no g++ on this host to compile the generated header with")
    return path


def _build(cxx, low, main, folder, run=True):
    text = low.header()
    src = folder / f"{hashlib.sha256(text.encode()).hexdigest()[:16]}.cpp"
    (folder / "potential.h").write_text(text)
    src.write_text(PRELUDE + main)
    exe = src.with_suffix("")
    flags = ([f"-DFORM={int(bool(low.trans))}", "-O1", "-o", str(exe)] if run
             else ["-fsyntax-only"])
    res = subprocess.run([cxx, "-std=c++17", "-ffp-contract=off", *flags, str(src)],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    return exe


def _lane_pair(cxx, low, folder, seed=5, B=5):
    """The header's lane path and the plain version's pair at ``x + v t``."""
    d = low.d
    rs = np.random.default_rng(seed)
    x, v = (torch.as_tensor(rs.normal(size=(d, B))) for _ in range(2))
    t = torch.as_tensor(rs.uniform(0.0, 0.3, size=B))
    exe = _build(cxx, low, RUN, folder)
    prm = low.params.to(torch.float64).numpy()
    with open(folder / "in.bin", "wb") as f:
        np.array([d, prm.size, B], np.int32).tofile(f)
        for a in (prm, x.numpy(), v.numpy(), t.numpy()):
            a.astype(np.float64).tofile(f)
    subprocess.run([str(exe), str(folder / "in.bin"), str(folder / "out.bin")], check=True)
    got = torch.as_tensor(np.fromfile(folder / "out.bin", np.float64).reshape(2, d, B))
    if low.trans:
        want = low.along(x, v, parts=1)(x + v * t, v, t)
    else:
        want = low.grad_jvp(x + v * t, v)
    return got, want


CASES = {**{name: TARGETS[name] for name in ("radon_x", "radon_x_fixed", "gauss_slice")},
         **{name: (9, STAGE_READS[name]) for name in (
             "product_gather_sq", "cumsum_gather", "product_shift", "product_flip",
             "cumsum_roll")}}


def _lowered(name, kernel):
    d, make = CASES[name]
    grad = resolve_potential(make(torch), d)[1] if name in TARGETS else make
    return lower.lower_gradient(grad, kernel, d, torch.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lane_path_compiled_for_the_host_matches_the_plain_pair(cxx, tmp_path, name):
    """K1's point path (one part), K4's, K3's and K5's generated ``form``,
    ``sums`` and ``at`` against the plain version, bit for bit."""
    for kernel in LANE_KERNELS:
        low = _lowered(name, kernel)
        if kernel == "zigzag" and not low.point:
            continue  # K1's chain moments: no lane path
        folder = tmp_path / kernel
        folder.mkdir()
        (g, dg), (wg, wdg) = _lane_pair(cxx, low, folder)
        assert torch.equal(g, wg) and torch.equal(dg, wdg), (kernel, float((g - wg).abs().max()))


@pytest.mark.parametrize("name", sorted(CASES))
def test_k6_header_compiles_for_the_host(cxx, tmp_path, name):
    """K6's generated ``fill`` and ``at`` compile (float64 and float32)."""
    low = _lowered(name, "sticky")
    assert low.point
    _build(cxx, low, COMPILE_ONLY, tmp_path, run=False)

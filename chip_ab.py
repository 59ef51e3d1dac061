"""Per-launch times of the scalar-rate (K3, K5) and Speed-Up (K4) chunk kernels of one checkout.

    python3 chip_ab.py [TREE]

Times one K=32 launch of K3 at the ``bps_anisotropic_gauss_d10`` shape, K5
at ``ecmc_gauss_d10``'s and K4 at ``suzz_gauss_d10``'s (float32, CUDA
events, mean of 50 launches after one warm launch) with the kernels and the
``chip_smoke.py`` of TREE: a checkout of the repository, this one by
default.  To compare two commits on one card, unpack the other with
``git archive`` into a git-ignored directory and run parent, change,
change, parent one after another on that card: each run is its own process
and builds its own kernels.  Prints one line with the three times and the
card's name and power limit.
"""

import os
import sys

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(__file__))
os.chdir(TREE)
sys.path.insert(0, TREE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as k3  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1  # noqa: E402

REPS = 50


def launch_ms(sampler, x0, v0, run):
    """Mean time of one K=32 launch of ``run`` from ``sampler``'s float32
    state at (x0, v0)."""
    B, d = x0.shape
    state = sampler.init_state_batch(x0, v0, 0, torch.float32, cs.DEV)
    cfg = cs.scalar_config(sampler, 32, 1 << 30, torch.float32)
    st = cs.driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=cs.DEV))
    fill = k1.empty_fill(32, d, B, torch.float32, cs.DEV)
    return cs.cuda_ms(lambda: run(7, st, fill, 0, cfg), REPS)


def main():
    bps, _, x0, v0 = cs.bps_deployment()
    d, B, _ = cs.ECMC_D10
    ecmc = cs.pt.ForwardECMCAD(d, cs.pt.potentials.gauss)
    x_ecmc = np.random.default_rng(12).normal(size=(B, d))
    suzz, x_s, v_s = cs.suzz_deployment()
    times = {"K3 BPS": launch_ms(bps, x0, v0, k3.run_chunk),
             "K5 ECMC": launch_ms(ecmc, x_ecmc, np.full((B, d), d ** -0.5), k3.run_chunk),
             "K4 suzz": launch_ms(suzz, x_s, v_s, k1.run_chunk)}
    print(f"{TREE}: " + "; ".join(f"{k} {v:.5f} ms" for k, v in times.items())
          + f" per K=32 launch ({cs.card()})", flush=True)


if __name__ == "__main__":
    main()

"""Per-launch times of the chunk kernels K1, K6, K3, K5 and K4 of one checkout.

    python3 chip_ab.py [TREE] [--lanes] [--probe]

Times one K=32 launch (float32, CUDA events, mean of 50 launches after one
warm launch) of K1 at the flagship's shape (B = 8192, d = 10), K1 in
horizon mode at ``zigzag_gauss_d10_horizon``'s (B = 4096, target 500), K6 at
``sticky_zigzag_d1000``'s (B = 128, d = 1000), K3 at
``bps_anisotropic_gauss_d10``'s, K5 at ``ecmc_gauss_d10``'s and K4 at
``suzz_gauss_d10``'s, with the kernels and the ``chip_smoke.py`` of TREE: a
checkout of the repository, this one by default.  With ``--lanes``, K1's
two shapes are also timed at every lane count its kernel offers (2, 4, 8 and
16 lanes per chain), forced one after another, beside the count its rule
picks; with ``--probe``, K6 is also timed at other shapes and without its
event-row stores (``probe_k6``).  To compare two commits on one card, unpack the other with ``git
archive`` into a git-ignored directory and run parent, change, change,
parent one after another on that card: each run is its own process and
builds its own kernels.  Prints one line with the times and the card's name
and power limit.
"""

import os
import shutil
import sys

args = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = os.path.abspath(args[0] if args else os.path.dirname(__file__))
os.chdir(TREE)
sys.path.insert(0, TREE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import build  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as k3  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1  # noqa: E402

REPS = 50


def launch_ms(sampler, x0, v0, run, config=cs.scalar_config, sticky=False, t_target=None):
    """Mean time of one K=32 launch of ``run`` from ``sampler``'s float32
    state at (x0, v0), in horizon mode at ``t_target`` when given."""
    B, d = x0.shape
    state = sampler.init_state_batch(x0, v0, 0, torch.float32, cs.DEV)
    cfg = config(sampler, 32, 1 << 30, torch.float32)
    if t_target is not None:
        cfg = cfg._replace(t_target=k1.f32_target(t_target))
    st = cs.driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=cs.DEV), sticky)
    fill = k1.empty_fill(32, d, B, torch.float32, cs.DEV, sticky)
    return cs.cuda_ms(lambda: run(7, st, fill, 0, cfg), REPS)


def main():
    d, B, _ = cs.MAIN
    flagship = cs.pt.ZigZag(d, cs.pt.potentials.grad_gauss)
    x_f, v_f = np.zeros((B, d)), np.ones((B, d))
    hz, x_h, v_h = cs.horizon_deployment()
    T = cs.HORIZON_D10[2]
    d_s, B_s, _, kappa = cs.STICKY
    sticky = cs.pt.StickyZigZagAD(d_s, cs.pt.potentials.gauss, np.full(d_s, kappa))
    bps, _, x0, v0 = cs.bps_deployment()
    d_e, B_e, _ = cs.ECMC_D10
    ecmc = cs.pt.ForwardECMCAD(d_e, cs.pt.potentials.gauss)
    x_ecmc = np.random.default_rng(12).normal(size=(B_e, d_e))
    suzz, x_s, v_s = cs.suzz_deployment()

    def k1_pair():
        return (launch_ms(flagship, x_f, v_f, k1.run_chunk),
                launch_ms(hz, x_h, v_h, k1.run_chunk, t_target=T))

    times = {}
    times["K1 flagship"], times["K1 horizon"] = k1_pair()
    times["K6 sticky"] = launch_ms(sticky, np.full((B_s, d_s), 0.3), np.ones((B_s, d_s)),
                                   k1.run_chunk, cs.sticky_config, sticky=True)
    times["K3 BPS"] = launch_ms(bps, x0, v0, k3.run_chunk)
    times["K5 ECMC"] = launch_ms(ecmc, x_ecmc, np.full((B_e, d_e), d_e ** -0.5), k3.run_chunk)
    times["K4 suzz"] = launch_ms(suzz, x_s, v_s, k1.run_chunk)
    text = "; ".join(f"{k} {v:.5f} ms" for k, v in times.items())
    lib = build.library()
    if "--lanes" in sys.argv and hasattr(lib, "zigzag_chunk_set_lanes"):
        rule = f"rule: L={lib.zigzag_chunk_lanes(B)} at B={B}, " \
               f"L={lib.zigzag_chunk_lanes(x_h.shape[0])} at B={x_h.shape[0]}"
        sweep = []
        for L in (2, 4, 8, 16):
            lib.zigzag_chunk_set_lanes(L)
            f, h = k1_pair()
            sweep.append(f"L={L}: flagship {f:.5f} horizon {h:.5f}")
        lib.zigzag_chunk_set_lanes(0)
        text += f"; K1 lanes ({rule}): " + ", ".join(sweep)
    print(f"{TREE}: {text} ms per K=32 launch ({cs.card()})", flush=True)
    if "--probe" in sys.argv:
        probe_k6()


def probe_k6():
    """K6 at the sticky deployment's shape against grid_size 2 and 20, at
    d = 32, 256 and 512 (one coordinate per thread of 1, 8 and 16 warps), at
    one chain, and built without its event-row stores (a copy of the
    sources in the git-ignored ``_build`` directory; the rows stay
    unwritten), to place its time: the envelope's cost per grid segment,
    the one-warp transition, the block's width and the rows."""
    def k6(d=cs.STICKY[0], B=cs.STICKY[1], grid=10):
        s = cs.pt.StickyZigZagAD(d, cs.pt.potentials.gauss, np.full(d, cs.STICKY[3]),
                                 grid_size=grid)
        return launch_ms(s, np.full((B, d), 0.3), np.ones((B, d)), k1.run_chunk,
                         cs.sticky_config, sticky=True)

    text = (f"K6 probe: deployment {k6():.5f}, grid_size 2 {k6(grid=2):.5f}, 20 "
            f"{k6(grid=20):.5f}; d=32 {k6(32):.5f}, d=256 {k6(256):.5f}, d=512 "
            f"{k6(512):.5f}; one chain {k6(B=1):.5f}")
    src = (build.CSRC / "sticky_chunk.cu").read_text()
    stores = "      ev_x[e] = sx[i];\n      ev_v[e] = sv[i];\n      ev_act[e] = sact[i];\n"
    if stores not in src:
        raise RuntimeError("chip_ab --probe: K6's row stores are not where it looks")
    var = build.BUILD_DIR / "no_row_stores"
    shutil.rmtree(var, ignore_errors=True)
    shutil.copytree(build.CSRC, var / "csrc")
    (var / "csrc" / "sticky_chunk.cu").write_text(src.replace(stores, "      (void)e;\n"))
    build.CSRC, build.BUILD_DIR, build._lib = var / "csrc", var / "_build", None
    text += f"; without the row stores {k6():.5f}"
    print(f"{text} ms per K=32 launch ({cs.card()})", flush=True)


if __name__ == "__main__":
    main()

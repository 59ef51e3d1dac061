"""K3/K5 and K4 built with and without FMA contraction, side by side on one card.

    python3 chip_fmad_ab.py

Builds the kernel library twice, with ``-fmad=false`` on
``csrc/scalar_chunk.cu`` and ``csrc/suzz_chunk.cu`` (the default build) and
without it, and in the order no-FMA, FMA, FMA, no-FMA times one K=32 launch
of K3/K5 and K4 (CUDA events, mean of 50 launches after one warm launch, each
variant from the same float32 state) at the shapes of the
``bps_anisotropic_gauss_d10``, ``boomerang_gauss_d10``, ``ecmc_gauss_d10``
and ``suzz_gauss_d10`` deployments (``chip_smoke.py`` phases 10-12 and 17).
Then, for the FMA build, the float64 parity against the plain version in the
cases of ``chip_smoke.py`` phases 9 and 16: the chains whose integer outputs
differ and the largest absolute and relative float differences over the
rest; and K4's float32 agreement at the ``suzz_gauss_d10`` shape (one K=32
chunk from phase 16's random state): the share of chains whose integer
outputs and velocities equal the plain version's.  Prints one line per reading and the card's name and power
limit.
"""

import sys

import numpy as np
import torch

import chip_smoke as cs
from pdmpflux_tpu_torch.ops.cuda import build
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as k3
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1

VARIANTS = {"no-FMA": {"scalar_chunk.cu": ["-fmad=false"], "suzz_chunk.cu": ["-fmad=false"]},
            "FMA": {}}
REPS = 50


def use(variant):
    """Load (building if needed) the library of one variant."""
    build.SOURCE_FLAGS = VARIANTS[variant]
    build._lib = None
    build.library()


def shapes():
    """(name, sampler, float32 initial state) of the three deployments."""
    bps, _, x0, v0 = cs.bps_deployment()
    d, B = x0.shape[1], x0.shape[0]
    boom = cs.pt.Boomerang(d, cs.pt.potentials.grad_gauss, refresh_rate=0.5)
    ecmc = cs.pt.ForwardECMCAD(d, cs.pt.potentials.gauss)
    x_ecmc = np.random.default_rng(12).normal(size=(B, d))
    out = []
    suzz, x_s, v_s = cs.suzz_deployment()
    for name, sampler, x, v in (("K3 BPS", bps, x0, v0), ("K3 Boomerang", boom, x0, v0),
                                ("K5 ECMC", ecmc, x_ecmc, np.full((B, d), d ** -0.5)),
                                ("K4 suzz", suzz, x_s, v_s)):
        out.append((name, sampler, sampler.init_state_batch(x, v, 0, torch.float32, cs.DEV)))
    return out


def run_of(cfg):
    return k1.run_chunk if cfg.kind == "suzz" else k3.run_chunk


def time_launch(sampler, state, K=32, seed=7):
    B, d = state.x.shape
    cfg = cs.scalar_config(sampler, K, 1 << 30, torch.float32)
    st = cs.driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=cs.DEV))
    fill = k1.empty_fill(K, d, B, torch.float32, cs.DEV)
    run = run_of(cfg)
    return cs.cuda_ms(lambda: run(seed, st, fill, 0, cfg), REPS)


def same_chains(outs_k, outs_p, B, velocities=False):
    """Chains whose integer outputs (and, when asked, velocities: the +-1
    Zig-Zag velocities record the flips) equal the plain version's."""
    same = torch.ones(B, dtype=torch.bool, device=cs.DEV)
    for (name, a), (_, b) in zip(outs_k, outs_p):
        if not a.is_floating_point() or (velocities and name in ("v", "ev_v")):
            same &= (a == b).reshape(-1, B).all(dim=0)
    return same


def parity(st_k, fill_k, st_p, fill_p):
    """A kernel and its plain version from one f64 state: (chains with
    differing integer outputs, max absolute and max relative float
    difference on the others)."""
    B = st_k.x.shape[1]
    outs_k, outs_p = cs.chunk_outputs(st_k, fill_k), cs.chunk_outputs(st_p, fill_p)
    same = same_chains(outs_k, outs_p, B)
    err = rel = 0.0
    for (_, a), (_, b) in zip(outs_k, outs_p):
        if a.is_floating_point():
            a, b = a[..., same], b[..., same]
            fin = torch.isfinite(b) & torch.isfinite(a)
            diff = (a[fin] - b[fin]).abs()
            if diff.numel():
                err = max(err, float(diff.max()))
                rel = max(rel, float((diff / b[fin].abs().clamp_min(1e-12)).max()))
    return int((~same).sum()), err, rel


def main():
    card = cs.card()
    cases = shapes()
    times = {name: [] for name, _, _ in cases}
    for variant in ("no-FMA", "FMA", "FMA", "no-FMA"):
        use(variant)
        for name, sampler, state in cases:
            ms = time_launch(sampler, state)
            times[name].append((variant, ms))
            print(f"{variant:7s} {name}: {ms:.5f} ms per K=32 launch (B={state.x.shape[0]}, "
                  f"d={state.x.shape[1]}, f32, mean of {REPS}) ({card})", flush=True)
    for name, runs in times.items():
        mean = {v: float(np.mean([ms for w, ms in runs if w == v])) for v in VARIANTS}
        print(f"{name}: no-FMA {mean['no-FMA']:.5f} ms, FMA {mean['FMA']:.5f} ms, "
              f"FMA / no-FMA = {mean['FMA'] / mean['no-FMA']:.4f} ({card})", flush=True)
    use("FMA")
    runs = [(f"{kind} {pot} d={d} B={B} {kw or ''}", cs.k3_runs(kind, pot, d, B, kw)[:4])
            for kind, pot, d, B, kw in cs.K3_CASES]
    runs += [(f"K4 {pot} d=10 B=1024", cs.k1_runs(10, 1024, 32, 2, pot, suzz=True)[:4])
             for pot in ("gauss", "banana")]
    for what, outs in runs:
        n_diff, err, rel = parity(*outs)
        B = outs[0].x.shape[1]
        print(f"FMA build f64 parity, {what}: {n_diff} of {B} chains with other integer "
              f"outputs; on the others max float difference {err:.3e} "
              f"absolute, {rel:.3e} relative (2 x K=32)", flush=True)
    d, B, _ = cs.SUZZ_D10
    st_k, fill_k, st_p, fill_p, _ = cs.k1_runs(d, B, 32, 1, "gauss", suzz=True,
                                               dtype=torch.float32)
    same = same_chains(cs.chunk_outputs(st_k, fill_k), cs.chunk_outputs(st_p, fill_p), B,
                       velocities=True)
    print(f"FMA build f32, K4 gauss d={d} B={B} (one K=32 chunk): {float(same.double().mean()):.4f} "
          f"of the chains take the plain version's decisions", flush=True)
    print(card)


if __name__ == "__main__":
    sys.exit(main())

"""On-card smoke run of the PyTorch/CUDA port (pdmpflux_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA card (Hopper: the kernels build for sm_90a) and ``nvcc``.
Phases, one line each; any failure raises and exits non-zero:

1. build the kernels (K1 fused Zig-Zag chunk, K2 event-row compaction) from
   ``pdmpflux_tpu_torch/csrc`` with nvcc;
2. K1 against its plain PyTorch version on the card, float64, from the same
   state: integer outputs equal, floats to rtol 1e-9 (atol 1e-12 for values
   near zero such as the Kahan compensation), at d=10/B=8192 (gauss),
   d=10/B=1024 (banana) and d=1000/B=256;
3. K2 against its plain version: random fills with offsets and an init
   record at d=10 and d=1000, outputs bit-identical;
4. the main path: ``sample_skeleton`` of ZigZag(10, grad_gauss), 8192
   chains x 2048 points, float32, warm then timed; every chain complete,
   both kernels launched, pooled moments in bench.py's bands; then (4b) the
   fill and the compaction timed apart, and each kernel checked against its
   plain version at exactly these shapes and float32 (K2 bit-identical, K1
   as ``k1_compare_f32`` states) and timed beside it;
5. a large-d run: ZigZag(1000), 256 chains x 512 points, float32, started
   in stationarity; complete, coordinate-pooled moments in band.

Then one JSON line of per-kernel results (launches counted in the timed
main-path run only), the card's name and power limit, and the status line.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is False; nothing to run",
          file=sys.stderr)
    sys.exit(2)

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import api  # noqa: E402
from pdmpflux_tpu_torch.core.types import EV_INIT, event_from_state  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import build  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import compact as k2  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1  # noqa: E402

DEV = torch.device("cuda")
RTOL, ATOL = 1e-9, 1e-12
MAIN = (10, 8192, 2048)    # d, chains, skeleton points: the bench flagship
LARGE = (1000, 256, 512)   # the large-d run


def sync():
    torch.cuda.synchronize(DEV)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` calls (after one warm call)."""
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    sync()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def random_state(sampler, B, dtype, seed):
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(B, sampler.dim))
    v0 = rs.choice([-1.0, 1.0], size=(B, sampler.dim))
    return sampler.init_state_batch(x0, v0, seed, dtype, DEV)


def clone_state(st):
    return k1.ChunkState(*(a.clone() for a in st))


def phase_build():
    t0 = time.perf_counter()
    build.library()
    secs = time.perf_counter() - t0
    regs = [ln.strip() for ln in build.BUILD_INFO.get("log", "").splitlines()
            if "registers" in ln]
    print(f"phase 1 build: {secs:.2f} s ({build.BUILD_INFO['path']}); "
          f"ptxas: {' | '.join(regs)}", flush=True)


K1_NAMES = ("x", "v", "fs", "iscal", "ring") + tuple("ev_" + f for f in k1.RawFill._fields)


def float_err(what, name, a, b, rtol, atol):
    """Max abs difference of two float tensors with the same non-finite
    pattern; raises past ``rtol``/``atol``."""
    fin = torch.isfinite(b)
    if not torch.equal(fin, torch.isfinite(a)) or not torch.equal(a[~fin], b[~fin]):
        raise AssertionError(f"{what}: non-finite pattern of {name} differs")
    if not torch.allclose(a[fin], b[fin], rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: {name} off by "
                             f"{float((a[fin] - b[fin]).abs().max())}")
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def k1_compare(d, B, K, n_chunks, pot):
    """Kernel and plain version from the same f64 state; returns max abs err."""
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    sampler = pt.ZigZag(d, grad)
    state = random_state(sampler, B, torch.float64, d + B)
    counts = torch.zeros(B, dtype=torch.int32, device=DEV)
    counts[::5] = 40  # some chains freeze inside the run
    cfg = driver.chunk_config(sampler, K, 48, 128)
    st_k = driver.chunk_state(state, counts)
    st_p = clone_state(st_k)
    fill_k = k1.empty_fill(K * n_chunks, d, B, torch.float64, DEV)
    fill_p = k1.empty_fill(K * n_chunks, d, B, torch.float64, DEV)
    for it in range(n_chunks):
        seed = -1234567 + it * 1000003
        k1.run_chunk(seed, st_k, fill_k, it * K, cfg)
        k1.run_chunk_plain(seed, st_p, fill_p, it * K, cfg)
    sync()
    err = 0.0
    for name, a, b in zip(K1_NAMES, (*st_k, *fill_k), (*st_p, *fill_p)):
        if a.dtype == torch.int32:
            if not torch.equal(a, b):
                raise AssertionError(f"K1 d={d}: integer output {name} differs "
                                     f"at {int((a != b).sum())} places")
        else:
            err = max(err, float_err(f"K1 d={d}", name, a, b, RTOL, ATOL))
    n_ev = int((fill_k.kind[:, 0] > 0).sum())
    if n_ev < B:
        raise AssertionError(f"K1 d={d}: only {n_ev} events in the check")
    return err, n_ev


def phase_k1():
    e10, n10 = k1_compare(10, 8192, 32, 3, "gauss")
    eb, nb = k1_compare(10, 1024, 32, 2, "banana")
    e1k, n1k = k1_compare(1000, 256, 32, 2, "gauss")
    err = max(e10, eb, e1k)
    print(f"phase 2 K1 vs plain (f64): d=10 B=8192 max_abs_err={e10:.3e} "
          f"({n10} events); banana d=10 B=1024 {eb:.3e} ({nb}); d=1000 B=256 "
          f"{e1k:.3e} ({n1k}); ints equal, rtol {RTOL} atol {ATOL}", flush=True)
    return err


def k1_compare_f32(st_k, fill_k, st_p, fill_p):
    """K1 against its plain version from one f32 state: a rounding difference
    may flip a thinning decision and send a chain down another valid path, so
    event kinds must agree on at least 99% of (transition, chain) pairs, and
    the chains whose integer outputs all agree must agree in their floats to
    rtol 1e-3, atol 1e-4 (f32 rounding order over 32 transitions).  Returns
    (kind agreement, max abs err on those chains)."""
    agree = float((fill_k.kind[:, 0] == fill_p.kind[:, 0]).float().mean())
    if agree < 0.99:
        raise AssertionError(f"K1 f32: event kinds agree on only {agree:.4f}")
    same = ((fill_k.kind == fill_p.kind).flatten(0, 1).all(dim=0)
            & (st_k.iscal == st_p.iscal).all(dim=0))
    err = 0.0
    for name, a, b in zip(K1_NAMES, (*st_k, *fill_k), (*st_p, *fill_p)):
        if a.dtype != torch.int32:
            err = max(err, float_err("K1 f32", name, a[..., same], b[..., same],
                                     1e-3, 1e-4))
    return agree, err


def random_fill(T, d, B, dtype, seed):
    g = torch.Generator(device=DEV).manual_seed(seed)
    kind = torch.where(torch.rand((T, 4, B), generator=g, device=DEV) < 0.6, 2, 0)
    kind[:, 1:] = torch.randint(0, 50, (T, 3, B), generator=g, device=DEV)
    kind = kind.to(torch.int32)
    kind[:, 0, 0] = 0  # a chain without events
    f = lambda *s: torch.randn(s, generator=g, device=DEV, dtype=dtype)  # noqa: E731
    return k1.RawFill(kind=kind, x=f(T, d, B), v=f(T, d, B), fs=f(T, 3, B),
                      ring=f(T, 5, B))


def random_init(d, B, dtype, seed):
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    return event_from_state(random_state(sampler, B, dtype, seed), EV_INIT)


def k2_outputs_equal(what, out_k, out_p):
    """K2 is exact: every field bit-identical.  Returns the max abs
    difference of the float fields (0.0 when it passes)."""
    err = 0.0
    for name, a, b in zip(pt.Skeleton._fields, out_k, out_p):
        if not torch.equal(a, b):
            raise AssertionError(f"K2 {what}: {name} differs")
        if a.is_floating_point() and a.numel():
            err = max(err, float((a - b).abs().max()))
    return err


def k2_compare(d, B, T, W, dtype):
    fill = random_fill(T, d, B, dtype, d)
    init = random_init(d, B, dtype, d + 1)
    err = 0.0
    for off, ini in ((torch.ones(B, dtype=torch.int32, device=DEV), init),
                     (None, None),
                     (torch.randint(1, W // 2, (B,), dtype=torch.int32, device=DEV), None)):
        base = k2.empty_rows(B, W, d, dtype, DEV)
        for a in base[:-1]:
            a.zero_()  # merges keep the columns below the offsets
        outs = []
        for fn in (k2.compact_rows, k2.compact_rows_plain):
            out = pt.Skeleton(*(a.clone() for a in base))
            kind, specs = k2.fill_specs(fill, out, ini)
            fn(kind, specs, off)
            outs.append(out)
        sync()
        err = max(err, k2_outputs_equal(
            f"d={d} off={off is not None} init={ini is not None}", *outs))
    return err


def phase_k2():
    err = max(k2_compare(10, 512, 700, 480, torch.float32),
              k2_compare(10, 256, 300, 200, torch.float64),
              k2_compare(1000, 64, 300, 200, torch.float32))
    print("phase 3 K2 vs plain: d=10 (f32, f64) and d=1000 with offsets and "
          f"init, bit-identical (max_abs_err={err})", flush=True)
    return err


def moments_ok(mean, var):
    return bool((mean.abs() < 0.2).all()) and bool(((var - 1.0).abs() < 0.3).all())


def card():
    """The card's name and power limit, as nvidia-smi reports them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def phase_main(card_name):
    d, B, n_sk = MAIN
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    kw = dict(seed=0, dtype=torch.float32, device=DEV)
    pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)  # warm: build, allocator
    sync()
    build.reset_launches()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, x0, v0, **kw)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    nv = skel.n_valid.cpu()
    if not bool((nv == n_sk).all()):
        raise AssertionError(f"main path incomplete: n_valid min {int(nv.min())}")
    if min(launches.values()) < 1:
        raise AssertionError(f"main path missed a kernel: {launches}")
    if not bool(torch.isfinite(skel.x).all() and torch.isfinite(skel.t).all()):
        raise AssertionError("main path produced non-finite values")
    mean, var = pt.pooled_moments(skel, sampler, 256)
    if not moments_ok(mean, var):
        raise AssertionError(f"main path moments off: mean {mean.tolist()} "
                             f"var {var.tolist()}")
    events = int(nv.sum()) - B
    print(f"phase 4 main path: ZigZag({d}) B={B} n_sk={n_sk} f32 wall={wall:.4f} s "
          f"events={events} events/s={events / wall:.1f} launches={launches} "
          f"max|mean|={float(mean.abs().max()):.4f} "
          f"max|var-1|={float((var - 1).abs().max()):.4f} ({card_name})", flush=True)
    del skel
    return sampler, launches


def phase_breakdown(sampler):
    """Fill and compaction timed apart at the main-path shapes, and each
    kernel checked and timed against its plain version there."""
    d, B, n_sk = MAIN
    target = n_sk - 1
    dtype = torch.float32
    t_cap = api.fill_rows(sampler, target, B, d, dtype, DEV)
    state = sampler.init_state_batch(np.zeros((B, d)), np.ones((B, d)), 0, dtype, DEV)
    init = event_from_state(state, EV_INIT)
    run = driver.make_stream_runner(sampler, t_cap, target)
    sync()
    t0 = time.perf_counter()
    res = run(state, torch.zeros(B, dtype=torch.int32, device=DEV))
    sync()
    fill_s = time.perf_counter() - t0
    off = torch.ones(B, dtype=torch.int32, device=DEV)
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = k2.empty_rows(B, target + 1, d, dtype, DEV)
        kind, specs = k2.fill_specs(res.fill, out, init)
        fn(kind, specs, off)
        outs.append(out)
    sync()
    k2_err = k2_outputs_equal("main path", *outs)
    del outs, out
    k2_ms = cuda_ms(lambda: k2.compact_rows(kind, specs, off), 5)
    k2_plain_ms = cuda_ms(lambda: k2.compact_rows_plain(kind, specs, off), 2)
    del res, specs, kind

    K = 32
    cfg = driver.chunk_config(sampler, K, 1 << 30, 128)
    st = driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=DEV))
    st_p = clone_state(st)
    fill, fill_p = (k1.empty_fill(K, d, B, dtype, DEV) for _ in range(2))
    k1.run_chunk(7, st, fill, 0, cfg)
    k1.run_chunk_plain(7, st_p, fill_p, 0, cfg)
    sync()
    k1_agree, k1_err = k1_compare_f32(st, fill, st_p, fill_p)
    del st_p, fill_p
    k1_ms = cuda_ms(lambda: k1.run_chunk(7, st, fill, 0, cfg), 20)
    k1_plain_ms = cuda_ms(lambda: k1.run_chunk_plain(7, st, fill, 0, cfg), 3)
    print(f"phase 4b breakdown (B={B}, d={d}, f32): fill {fill_s:.4f} s over "
          f"{t_cap} rows ({t_cap // K} K1 launches); K1 chunk (K={K}) "
          f"{k1_ms:.4f} ms vs plain {k1_plain_ms:.4f} ms, kinds agree on "
          f"{k1_agree:.6f}, max_abs_err {k1_err:.3e} on agreeing chains; K2 "
          f"compaction (T={t_cap}, W={target + 1}) {k2_ms:.4f} ms vs plain "
          f"{k2_plain_ms:.4f} ms, bit-identical", flush=True)
    return k1_ms, k1_plain_ms, k2_ms, k2_plain_ms, k2_err


def phase_large_d():
    d, B, n_sk = LARGE
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    rs = np.random.default_rng(1)
    x0 = rs.normal(size=(B, d))  # stationary start: 511 events barely move a d=1000 chain
    v0 = rs.choice([-1.0, 1.0], size=(B, d))
    sync()
    t0 = time.perf_counter()
    skel = pt.sample_skeleton(sampler, n_sk, x0, v0, seed=1, dtype=torch.float32,
                              device=DEV)
    sync()
    wall = time.perf_counter() - t0
    if not bool((skel.n_valid == n_sk).all()):
        raise AssertionError("large-d run incomplete")
    mean, var = pt.pooled_moments(skel, sampler, 256)
    m, v = float(mean.mean()), float(var.mean())
    if not (abs(m) < 0.05 and abs(v - 1.0) < 0.1):
        raise AssertionError(f"large-d pooled moments off: mean {m} var {v}")
    print(f"phase 5 large d: ZigZag({d}) B={B} n_sk={n_sk} f32 wall={wall:.4f} s "
          f"(first call, includes allocation) coordinate-pooled mean={m:.4f} "
          f"var={v:.4f}", flush=True)


def main():
    card_name = card()
    phase_build()
    k1_err = phase_k1()
    k2_err = phase_k2()
    sampler, launches = phase_main(card_name)
    k1_ms, k1_plain_ms, k2_ms, k2_plain_ms, k2_main_err = phase_breakdown(sampler)
    phase_large_d()
    kernels = [
        {"name": "zigzag_chunk", "route": "cuda",
         "source": "pdmpflux_tpu_torch/csrc/zigzag_chunk.cu",
         "replaces": "pdmpflux_tpu/ops/pallas/zigzag_chunk.py:854",
         "launches": launches["zigzag_chunk"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "compact_rows", "route": "cuda",
         "source": "pdmpflux_tpu_torch/csrc/compact.cu",
         "replaces": "pdmpflux_tpu/ops/pallas/compact.py:132",
         "launches": launches["compact_rows"], "max_abs_err": max(k2_err, k2_main_err),
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_name)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

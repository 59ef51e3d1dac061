"""Per-launch times of the chunk kernels K1, K6, K3, K5 and K4 and of the
compaction K2 of one checkout.

    python3 chip_ab.py [TREE] [--lanes] [--probe] [--probe-k2]
    python3 chip_ab.py [TREE] --engine
    python3 chip_ab.py [TREE] --lane-context
    python3 chip_ab.py [TREE] --block-max-barrier
    python3 chip_ab.py [TREE] --cuts

Times one K=32 launch (float32, CUDA events, mean of 50 launches after one
warm launch) of K1 at the flagship's shape (B = 8192, d = 10), K1 in
horizon mode at ``zigzag_gauss_d10_horizon``'s (B = 4096, target 500), K6 at
``sticky_zigzag_d1000``'s (B = 128, d = 1000), K3 at
``bps_anisotropic_gauss_d10``'s, K5 at ``ecmc_gauss_d10``'s and K4 at
``suzz_gauss_d10``'s, with the kernels and the ``chip_smoke.py`` of TREE: a
checkout of the repository, this one by default.  Then K2, one
``compact_rows`` call (mean of 10 after one warm call), on a real first fill
of each of the five deployments (the sampler warmed by one
``sample_skeleton`` call, as in ``chip_smoke.py``'s breakdowns), with its
bound from TREE's ``chip_smoke.k2_bound``; beside the flagship's and the
sticky fill's, PyTorch's ``permute(2, 0, 1).contiguous()`` of the fill's
``x``, as context for what a transposing copy costs on the card.  With ``--lanes``, K1's
two shapes are also timed at every lane count its kernel offers (2, 4, 8 and
16 lanes per chain), forced one after another, beside the count its rule
picks; with ``--probe``, K6 is also timed at other shapes and without its
event-row stores (``probe_k6``); with ``--probe-k2``, K2 on the flagship's,
the sticky and the BPS fill is also timed built without its copy's stores and
without its copy's loads (``probe_k2``).  Last, each of the five
deployments' ``sample_skeleton`` calls is timed (``call_times``: the median
of five warm calls, and one call traced by ``torch.profiler`` for the
card's busy time and K2's kernels inside the call).  With ``--engine``,
none of that: the transition engine's cells instead (``engine_ab``), the
torch ops one transition dispatches for each family of TREE's phase 22 and
TREE's phases 23 and 24.  With ``--lane-context``, none of that either:
a generated potential's context per lane at growing sizes on K3 and K1
(``probe_lane_context``).  With ``--block-max-barrier``, none of that:
K6's block max (``lower._BLOCK_MAX``) built with and without the barrier
between the warps' partials and their reads, odd warps delayed 20 us
before they write theirs, each against its plain version on ``|x|^2 / 2 +
logsumexp(x)`` at d = 100 (``probe_block_max``).  With ``--cuts``, none of
that: phases 22 and 33 of TREE's ``chip_smoke.py`` at their depth and at
twice it, the depth before their cuts for its time (``probe_cuts``).  To
compare two commits on one card, unpack the other with ``git archive``
into a git-ignored directory and run parent, change, change, parent one
after another on that card: each run is its own process and
builds its own kernels.  Prints one line with the kernels' times and one
line per deployment's call, each with the card's name and power limit.
"""

import ctypes
import os
import shutil
import subprocess
import sys
import time

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
CALLS = 5  # timed warm calls of each deployment


def launch_ms(sampler, x0, v0, run, config=cs.card_config, sticky=False, t_target=None):
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


def engine_ab(n=20):
    """The engine's cells of TREE: for each family of its phase 22
    (``ENGINE_FAMILIES``, f64, B = 256, d = 10, seeded inits), the torch ops
    dispatched per transition over ``n`` transitions on the card and a digest
    of their names (sorted, so that two trees dispatching the same ops in
    another order agree), then its phases 23 (``rhmc_gauss_d10``) and 24
    (``zigzag_banana_d10_fd`` and ``_jvp``), which print their times."""
    import hashlib
    from collections import Counter

    from torch.utils._python_dispatch import TorchDispatchMode

    class Names(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(str(func))
            return func(*args, **(kwargs or {}))

    build.library()
    B, d = 256, 10
    rs = np.random.default_rng(22)
    texts = []
    for name, make in cs.ENGINE_FAMILIES.items():
        sampler = make(d)
        x0 = rs.normal(size=(B, d))
        if name.startswith(("zigzag", "sticky", "suzz")):
            v0 = rs.choice([-1.0, 1.0], size=(B, d))
        else:
            v0 = rs.normal(size=(B, d))
            v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
        state = sampler.init_state_batch(x0, v0, 22, torch.float64, cs.DEV)
        transition = cs.engine.make_transition(sampler)
        t_max = cs.run_t_max(sampler, state, n)
        with Names() as rec:
            for _ in range(n):
                state, _ = transition(state, t_max)
        cs.sync()
        digest = hashlib.sha1(repr(sorted(Counter(rec.names).items())).encode()).hexdigest()
        texts.append(f"{name} {len(rec.names) / n:.1f} ({digest[:10]})")
    print(f"{TREE} engine: torch ops dispatched per transition (digest of the op "
          f"names): {', '.join(texts)} ({cs.card()})", flush=True)
    card_name = cs.card()
    cs.phase_rhmc(card_name)
    for tderiv in ("fd", "jvp"):
        cs.phase_banana_engine(card_name, tderiv)


def main():
    if "--engine" in sys.argv:
        engine_ab()
        return
    if "--lane-context" in sys.argv:
        probe_lane_context()
        return
    if "--block-max-barrier" in sys.argv:
        probe_block_max()
        return
    if "--cuts" in sys.argv:
        probe_cuts()
        return
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
                                   k1.run_chunk, cs.card_config, sticky=True)
    times["K3 BPS"] = launch_ms(bps, x0, v0, k3.run_chunk)
    times["K5 ECMC"] = launch_ms(ecmc, x_ecmc, np.full((B_e, d_e), d_e ** -0.5), k3.run_chunk)
    times["K4 suzz"] = launch_ms(suzz, x_s, v_s, k1.run_chunk)
    text = "; ".join(f"{k} {v:.5f} ms" for k, v in times.items())
    text += "; " + k2_times(flagship, (x_f, v_f), sticky, bps, (x0, v0), hz, (x_h, v_h),
                            suzz, (x_s, v_s))
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
    print(f"{TREE}: {text} (chunk kernels per K=32 launch, K2 per call) ({cs.card()})",
          flush=True)
    if "--probe" in sys.argv:
        probe_k6()
    if "--probe-k2" in sys.argv:
        probe_k2(flagship, (x_f, v_f), sticky, bps, (x0, v0))
    call_times([
        ("flagship", flagship, cs.MAIN[2], x_f, v_f),
        ("sticky", sticky, cs.STICKY[2], np.full((B_s, d_s), 0.3), np.ones((B_s, d_s))),
        ("BPS", bps, cs.BPS_D10[2], x0, v0),
        ("horizon", hz, T, x_h, v_h),
        ("Speed-Up", suzz, cs.SUZZ_D10[2], x_s, v_s)])


def call_times(cells):
    """Each deployment's ``sample_skeleton`` call (float32, seed 0): the
    wall times of CALLS synchronised warm calls after one warm call, then
    one more call traced by ``torch.profiler``: its wall time, the card's
    busy time in it (the sum of the trace's kernels, copies and sets, which
    run one after another on the one stream) and so its idle share, K2's
    kernels' time in it and the kernels that took the most.  One line per
    deployment."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for name, sampler, n_or_T, x0, v0 in cells:
        def call():
            cs.pt.sample_skeleton(sampler, n_or_T, x0, v0, seed=0, dtype=torch.float32,
                                  device=cs.DEV)
            cs.sync()

        call()
        walls = []
        for _ in range(CALLS):
            t0 = time.perf_counter()
            call()
            walls.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            traced = (time.perf_counter() - t0) * 1e3
        kernels = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                k = cs.kernel_name(e.name)
                ms, n = kernels.get(k, (0.0, 0))
                kernels[k] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy = sum(ms for ms, _ in kernels.values())
        # K2's kernels by name: the four of compact.cu, and the one kernel of
        # a tree that predates them (timed as the parent of a comparison)
        k2_names = set(cs.K2_KERNELS) | {"compact_rows_kernel"}
        k2_ms = sum(ms for k, (ms, _) in kernels.items() if k in k2_names)
        med = float(np.median(walls))
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:6]
        print(f"{TREE} call {name}: {CALLS} warm calls "
              f"{' '.join(f'{w:.3f}' for w in walls)} ms, median "
              f"{med:.3f} ms; traced call {traced:.3f} ms, card busy {busy:.3f} ms (idle "
              f"{1 - busy / traced:.1%} of the traced call, {1 - busy / med:.1%} of the "
              f"median), K2's kernels {k2_ms:.4f} ms; "
              f"most time: " + ", ".join(f"{k} {ms:.4f} ms x {n}" for k, (ms, n) in top)
              + f" ({cs.card()})", flush=True)


def k2_fill(sampler, x0, v0, n_sk=None, T=None, cap=None):
    """(kind, specs, off, fill, counts, W): K2's arguments for the first
    float32 fill of a deployment, an event-count one (``n_sk``) after one
    warm call, or a time-horizon one (``T``, ``cap`` rows) behind its init
    row."""
    B, d = x0.shape
    dtype = torch.float32
    state = sampler.init_state_batch(x0, v0, 0, dtype, cs.DEV)
    zeros = torch.zeros(B, dtype=torch.int32, device=cs.DEV)
    if T is None:
        cs.pt.sample_skeleton(sampler, n_sk, x0, v0, seed=0, dtype=dtype, device=cs.DEV)
        t_cap = cs.api.fill_rows(sampler, n_sk - 1, B, d, dtype, cs.DEV)
        res = cs.driver.make_stream_runner(sampler, t_cap, n_sk - 1)(state, zeros)
        W = n_sk
    else:
        res = cs.driver.make_stream_runner(sampler, cap, cap, mode="horizon")(state, zeros, T)
        W = 1 + cap
    out = cs.k2.empty_rows(B, W, d, dtype, cs.DEV)
    kind, specs = cs.k2.fill_specs(res.fill, out, cs.event_from_state(state, cs.EV_INIT))
    return kind, specs, torch.ones(B, dtype=torch.int32, device=cs.DEV), res.fill, res.counts, W


def k2_times(flagship, xv_f, sticky, bps, xv_b, hz, xv_h, suzz, xv_s):
    """K2 per call on the five deployments' real fills, and the context
    copies; one text."""
    n_f, n_s, n_b, n_z = cs.MAIN[2], cs.STICKY[2], cs.BPS_D10[2], cs.SUZZ_D10[2]
    B_s, d_s = cs.STICKY[1], cs.STICKY[0]
    cells = [
        ("flagship", lambda: k2_fill(flagship, *xv_f, n_sk=n_f), True),
        ("sticky", lambda: k2_fill(sticky, np.full((B_s, d_s), 0.3), np.ones((B_s, d_s)),
                                   n_sk=n_s), True),
        ("BPS", lambda: k2_fill(bps, *xv_b, n_sk=n_b), False),
        ("horizon", lambda: k2_fill(hz, *xv_h, T=cs.HORIZON_D10[2], cap=cs.HORIZON_D10[3]),
         False),
        ("Speed-Up", lambda: k2_fill(suzz, *xv_s, n_sk=n_z), False),
    ]
    texts = []
    for name, make, context in cells:
        kind, specs, off, fill, counts, W = make()
        ms = cs.cuda_ms(lambda: cs.k2.compact_rows(kind, specs, off), 10)
        b = cs.k2_bound(fill, counts, W)
        text = (f"K2 {name} (T={fill.rows}, W={W}, B={kind.shape[1]}) {ms:.5f} ms, bound "
                f"{b[0]:.5f} ms ({b[0] / ms:.1%})")
        if context:
            x = fill.x
            copy_ms = cs.cuda_ms(lambda: x.permute(2, 0, 1).contiguous(), 10)
            text += f", x.permute(2, 0, 1).contiguous() {copy_ms:.5f} ms"
        texts.append(text)
        del kind, specs, fill, counts
        torch.cuda.empty_cache()
    return "; ".join(texts)


K2_PROBES = {
    "without the copy's stores": [
        ("for (int e = first + lane; e < n; e += 32) dst[e] = f.src ? run[e] : (V)1;",
         "(void)dst;"),
        ("dst[e + (long)div(e) * gap] = f.src ? run[e] : (V)1;", "(void)e;")],
    "without the copy's loads": [
        ("copy_async(d + col, s + col * f.field_stride);", "(void)d;"),
        ("if (c0 + u < sg.nf) v[u] = s[(c0 + u) * f.field_stride];", "v[u] = (V)u;")],
}


def probe_k2(flagship, xv_f, sticky, bps, xv_b):
    """K2 per call on the flagship's, the sticky and the BPS deployment's
    real fills,
    as built and built (``compact.cu`` alone, in the git-ignored ``_build``
    directory) without its copy kernel's stores or loads: how the copy's
    time splits between reading the fill and writing the skeleton."""
    lib = build.library()
    src = (build.CSRC / "compact.cu").read_text()
    variants = {"as built": lib}
    for name, edits in K2_PROBES.items():
        text = src
        for a, b in edits:
            if a not in text:
                raise RuntimeError(f"chip_ab --probe-k2: {a!r} is not in compact.cu")
            text = text.replace(a, b)
        d = build.BUILD_DIR / f"k2_probe_{len(variants)}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "compact.cu").write_text(text)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(d / "k2.so"),
                        str(d / "compact.cu")], check=True, capture_output=True)
        k2lib = ctypes.CDLL(str(d / "k2.so"))
        for fn in ("compact_rows_launch", "compact_rows_scratch"):
            getattr(k2lib, fn).restype = getattr(lib, fn).restype
            getattr(k2lib, fn).argtypes = getattr(lib, fn).argtypes
        k2lib.pdmpflux_cuda_error_string = lib.pdmpflux_cuda_error_string
        variants[name] = k2lib
    B_s, d_s, n_s = cs.STICKY[1], cs.STICKY[0], cs.STICKY[2]
    texts = []
    for cell, make in (("flagship", lambda: k2_fill(flagship, *xv_f, n_sk=cs.MAIN[2])),
                       ("sticky", lambda: k2_fill(sticky, np.full((B_s, d_s), 0.3),
                                                  np.ones((B_s, d_s)), n_sk=n_s)),
                       ("BPS", lambda: k2_fill(bps, *xv_b, n_sk=cs.BPS_D10[2]))):
        kind, specs, off, fill, _, _ = make()
        times = []
        for name, variant in variants.items():
            build._lib = variant
            times.append(f"{name} {cs.cuda_ms(lambda: cs.k2.compact_rows(kind, specs, off), 10):.5f}")
        build._lib = lib
        texts.append(f"{cell} (T={fill.rows}): " + ", ".join(times))
        del kind, specs, fill
        torch.cuda.empty_cache()
    print(f"K2 probe, ms per call: {'; '.join(texts)} ({cs.card()})", flush=True)


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
                         cs.card_config, sticky=True)

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


LANE_DIMS = {"bps": (128, 512, 1024, 2048, 3072), "zigzag": (128, 512, 1024, 2048)}
"""The dimensions of ``probe_lane_context``'s dense quadratic forms in
``tanh(x)``: float32 contexts from 4 to 96 KB per lane
(``Lowered.lane_bytes``)."""


def tanh_form(P):
    """``U = tanh(x) P tanh(x) / 2``: products after a nonlinearity, which the
    kernels form at each point (a product of ``x`` itself is formed once per
    transition and keeps no context in the lane)."""
    Pt = torch.as_tensor(P, device=cs.DEV)
    return lambda x: 0.5 * torch.tanh(x) @ (Pt.to(x) @ torch.tanh(x))


def probe_lane_context(B=512, K=2, reps=3, slow_ms=5000.0):
    """Where a generated potential's context per lane stops launching or
    collapses in speed: :func:`tanh_form` (``P`` the AR(1) precision, rho
    0.5, dense) on BPS (K3) and Zig-Zag (K1) at each d of :data:`LANE_DIMS`,
    float32, B chains from a random state, one K-transition launch timed
    (the mean of ``reps`` after a warm one), the lowering's
    ``lower.LANE_BYTES`` lifted so that every size is tried.  Per (kernel,
    d): the bytes of context the lowering counts per lane, the stack frame
    ptxas reports for the kernel (its local memory per thread), the card
    memory the first launch takes (the driver reserves a thread's local
    memory for every thread the card can hold), ms per launch and ps per
    operation (``chunk_ops``), or the launch's error.  A kernel whose
    launch passes ``slow_ms`` is not tried at larger d."""
    from concurrent.futures import ThreadPoolExecutor
    from pdmpflux_tpu_torch.ops.cuda import lower
    lower.LANE_BYTES = 1 << 40
    cases = []
    for kind, dims in LANE_DIMS.items():
        for d in dims:
            if kind == "bps" and d > k3.scalar_max_dim(torch.float32):
                continue
            U = tanh_form(cs.ar1_precision(d, 0.5))
            s = cs.pt.BPSAD(d, U, refresh_rate=0.5) if kind == "bps" else cs.pt.ZigZagAD(d, U)
            cases.append((kind, d, s, lower.lower_sampler(s, kind, d, torch.float32, cs.DEV)))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(cases)) as ex:
        libs = list(ex.map(lambda c: c[3].library(), cases))
    texts, slow = [], set()
    for (kind, d, s, low), lib in zip(cases, libs):
        frames = {f for _, f, _, _ in cs.ptxas_kernels(
            build.BUILD_INFO["user"][lib._name]["log"]).values()}
        head = f"{kind} d={d}: {low.lane_bytes()} B counted, ptxas frame {sorted(frames)} B"
        if kind in slow:
            texts.append(f"{head}, not launched (a smaller d passed {slow_ms:.0f} ms)")
            continue
        state = cs.random_state(s, B, torch.float32, d)
        if kind == "bps":
            state = state._replace(v=state.v / state.v.norm(dim=1, keepdim=True))
        cfg = cs.user_config(s, K, 1 << 30, torch.float32)
        run, _ = cs.chunk_fns(cfg)
        st = cs.driver.chunk_state(state, torch.zeros(B, dtype=torch.int32, device=cs.DEV),
                                   False)
        fill = k1.empty_fill(K, d, B, torch.float32, cs.DEV, False)
        torch.cuda.empty_cache()
        free0 = torch.cuda.mem_get_info()[0]
        try:
            run(7, st, fill, 0, cfg)
            cs.sync()
        except RuntimeError as e:
            texts.append(f"{head}, launch failed: {e}")
            slow.add(kind)
            continue
        taken = (free0 - torch.cuda.mem_get_info()[0]) / 2 ** 20
        ms = cs.cuda_ms(lambda: run(7, st, fill, 0, cfg), reps)
        b = cs.chunk_bound(cfg, st, fill, K * B)
        ops = b[3] / 1e3 * cs.H100_F32_OPS_S
        texts.append(f"{head}, the launch took {taken:.0f} MiB of card memory, {ms:.3f} ms "
                     f"per K={K} launch, {ms * 1e9 / ops:.3f} ps per operation (bound "
                     f"{b[0]:.3f} ms by {b[1]})")
        if ms > slow_ms:
            slow.add(kind)
        del st, fill, state
    print(f"lane context probe (B={B}, float32, {len(cases)} libraries built in "
          f"{time.perf_counter() - t0:.1f} s): {'; '.join(texts)} ({cs.card()})", flush=True)


def probe_block_max(d=100, Bs=(64, 96, 128)):
    """K6's block max without its barrier: a mutant of the generated
    ``block_max`` that drops the ``__syncthreads`` between the warps'
    partials and their reads, and a control that keeps it, both with odd
    warps delayed 20 us before they write their partials, so that a read
    before the barrier finds the last reduction's partials.  Each is held
    against the plain version (``chip_smoke.user_compare``: f64, two chunks
    of 16) at three chain counts on ``|x|^2 / 2 + logsumexp(x)``, a max over
    the coordinates across the block's four warps; the mutant must fail."""
    from concurrent.futures import ThreadPoolExecutor

    lower = cs.lower
    orig = list(lower._BLOCK_MAX)
    write = orig.index("    if ((threadIdx.x & 31) == 0) {")
    control = orig[:write] + ["    if ((threadIdx.x >> 5) & 1) __nanosleep(20000);"] + orig[write:]
    mutant = [line for line in control if line != "    __syncthreads();"]
    variants = {}
    for tag, block in (("control", control), ("mutant", mutant)):
        lower._BLOCK_MAX = block
        s = cs.pt.StickyZigZagAD(d, lambda x: x @ x / 2 + torch.logsumexp(x, 0), np.ones(d))
        low = lower.lower_sampler(s, "zigzag", d, torch.float64, cs.DEV)
        variants[tag] = (s, low, low.header())  # the header as patched
    lower._BLOCK_MAX = orig
    with ThreadPoolExecutor(2) as ex:
        libs = {tag: ex.submit(build.user_library, lower.SOURCES["sticky"], hdr)
                for tag, (_, _, hdr) in variants.items()}
    texts = []
    for tag, (s, low, _) in variants.items():
        low._lib = libs[tag].result()
        fails = []
        for B in Bs:
            try:
                err, n_ev, _ = cs.user_compare(f"K6 block max {tag} B={B}", s, B, False,
                                               n_chunks=2, K=16)
            except AssertionError as e:
                fails.append(f"B={B}: {str(e)[:120]}")
        texts.append(f"{tag}: {len(fails)} of {len(Bs)} checks fail"
                     f"{' (' + '; '.join(fails) + ')' if fails else ''}")
    if not texts[1].startswith(f"mutant: {len(Bs)} of"):
        print("block max probe: the mutant did not fail every check", flush=True)
    print(f"block max barrier probe (d={d}, f64, odd warps delayed 20 us): {'; '.join(texts)} "
          f"({cs.card()})", flush=True)


def probe_cuts():
    """The seconds that the depth cuts of phases 22 (``ENGINE_AGREE``'s
    transitions) and 33 (``TAG_CHUNKS``, the chunks of K1 at d = 1000 and of
    K6) save: each phase at its depth and at twice it, one after another,
    the kernels built first."""
    lib_s = time.perf_counter()
    build.library()
    texts = [f"kernels built in {time.perf_counter() - lib_s:.1f} s"]
    B, d, n = cs.ENGINE_AGREE
    for depth in (n, 2 * n):
        cs.ENGINE_AGREE = (B, d, depth)
        t0 = time.perf_counter()
        cs.phase_engine_agreement()
        texts.append(f"phase 22 at {depth} transitions {time.perf_counter() - t0:.1f} s")
    cs.ENGINE_AGREE = (B, d, n)
    chunks = cs.TAG_CHUNKS
    for depth in (chunks, 2 * chunks):
        cs.TAG_CHUNKS = depth
        t0 = time.perf_counter()
        cs.phase_tags()
        texts.append(f"phase 33 at {depth} chunks {time.perf_counter() - t0:.1f} s")
    cs.TAG_CHUNKS = chunks
    print(f"depth cuts: {'; '.join(texts)} ({cs.card()})", flush=True)


if __name__ == "__main__":
    main()

"""On-card checks of the port's kernels K1, K2, K3/K5, K4 and K6, and of
their horizon mode K7 (marker ``cuda``).

They skip where ``torch.cuda.is_available()`` is false (the CPU tier-1
run); on a Hopper card run them with ``python -m pytest tests/test_torch_cuda.py
-m cuda``.  ``chip_smoke.py`` makes the same checks at the main path's shapes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.core.types import EV_INIT, event_from_state  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import build  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import compact as k2  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as k3  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels compile for sm_90a with nvcc)")
    return torch.device("cuda")


@pytest.mark.parametrize("pot,signed", [("gauss", True), ("banana", False)])
def test_k1_kernel_matches_plain_f64(dev, pot, signed):
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    sampler = pt.ZigZag(6, grad, signed_bound=signed)
    rs = np.random.default_rng(0)
    state = sampler.init_state_batch(rs.normal(size=(300, 6)),
                                     rs.choice([-1.0, 1.0], size=(300, 6)),
                                     3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, 16, 20, 128)
    st_k = driver.chunk_state(state, torch.zeros(300, dtype=torch.int32, device=dev))
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(32, 6, 300, torch.float64, dev) for _ in range(2)]
    n0 = build.LAUNCHES["zigzag_chunk"]
    for it in range(2):
        k1.run_chunk(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        k1.run_chunk_plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["zigzag_chunk"] == n0 + 2
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:  # no activity: not sticky
            continue
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("pot,d,B,kw", [
    ("gauss", 10, 512, dict(grid_size=2)),     # one segment
    ("banana", 10, 512, dict(grid_size=33)),   # segments past a group's lanes
    ("gauss", 10, 512, dict(grid_size=64, signed_bound=False)),
    ("gauss", 10, 1001, {}),                   # a ragged last warp
    ("gauss", 1000, 256, {}),                  # long runs of coordinates per lane
    ("gauss", 8000, 3, dict(tmax=0.01)),       # x and v read in place
])
def test_k1_kernel_matches_plain_f64_at_edges(dev, pot, d, B, kw):
    """K1's lane groups at the grid's edges, a B that leaves part of the
    last warp without a chain, d = 1000, and d = 8000, where two chains' f64
    x and v exceed a block's shared memory and K1 reads them in place,
    against the plain version over two chunks from one f64 state with some
    chains capped."""
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    sampler = pt.ZigZag(d, grad, **kw)
    rs = np.random.default_rng(d + B)
    state = sampler.init_state_batch(rs.normal(size=(B, d)),
                                     rs.choice([-1.0, 1.0], size=(B, d)), 3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, 16, 20, 128)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 17
    st_k = driver.chunk_state(state, counts)
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(32, d, B, torch.float64, dev) for _ in range(2)]
    for it in range(2):
        k1.run_chunk(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        k1.run_chunk_plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:
            continue
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    assert int((fills[0].kind[:, 0] == pt.EV_JUMP).sum()) > B
    assert (st_k.iscal[k1.I_CNT] == 20).any()


@pytest.mark.parametrize("dtype,act,B,T,d,W,mode", [
    ("f32", False, 40, 90, 7, 60, "merge"),
    ("f32", True, 1, 1, 1, 1, "init"),         # W = 1: the init record alone
    ("f64", False, 31, 33, 10, 20, "merge"),   # off + kept past W: the clamp
    ("f32", True, 33, 300, 10, 200, "init"),   # a chain group of one chain
    ("f64", True, 1001, 33, 10, 40, "merge"),
    ("f32", False, 1001, 300, 1, 250, "zero"),
    ("f32", True, 33, 33, 1000, 30, "merge"),  # 8-row tiles, fields split
    ("f64", True, 31, 300, 1000, 320, "init"),  # 8-byte lines at d = 1000, a tail
    ("f64", False, 1, 300, 1000, 100, "merge"),
    ("f32", True, 33, 300, 10, 1, "zero"),     # W = 1 without init: a kept row
    ("f32", False, 1001, 1, 10, 1, "init"),
    ("f64", True, 33, 33, 1, 50, "zero"),
])
def test_k2_kernel_matches_plain(dev, dtype, act, B, T, d, W, mode):
    """K2 against its plain version, bit for bit in every field: with a
    null or a real activity source, ragged chain groups and row tiles, W = 1
    and W below off + kept, behind an init record (``init``), at random
    per-chain offsets into an accumulator (``merge``) and from column 0
    (``zero``)."""
    dt = {"f32": torch.float32, "f64": torch.float64}[dtype]
    g = torch.Generator(device=dev).manual_seed(T + d + B)
    kind = torch.randint(0, 3, (T, 4, B), generator=g, device=dev, dtype=torch.int32)
    f = lambda *s: torch.randn(s, generator=g, device=dev, dtype=dt)  # noqa: E731
    a = (torch.rand((T, d, B), generator=g, device=dev) < 0.7) if act else None
    fill = k1.RawFill(kind, f(T, d, B), f(T, d, B), f(T, 3, B), f(T, 5, B), a)
    init, off = None, None
    if mode == "init":
        sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
        rs = np.random.default_rng(d)
        state = sampler.init_state_batch(rs.normal(size=(B, d)),
                                         rs.choice([-1.0, 1.0], size=(B, d)), 1, dt, dev)
        init = event_from_state(state, EV_INIT)
        off = torch.ones(B, dtype=torch.int32, device=dev)
    elif mode == "merge":
        off = torch.randint(1, max(2, W // 2 + 1), (B,), generator=g, device=dev,
                            dtype=torch.int32)
    base = [torch.randint(-3, 3, x.shape, generator=g, device=dev).to(x.dtype)
            for x in k2.empty_rows(B, W, d, dt, dev)]  # kept below the offsets
    outs = []
    for fn in (k2.compact_rows, k2.compact_rows_plain):
        out = pt.Skeleton(*(x.clone() for x in base))
        kind0, specs = k2.fill_specs(fill, out, init)
        fn(kind0, specs, off)
        outs.append(out)
    torch.cuda.synchronize()
    for name, x, y in zip(pt.Skeleton._fields, *outs):
        assert torch.equal(x, y), name


def test_sample_skeleton_on_card(dev):
    sampler = pt.ZigZag(5, pt.potentials.grad_gauss)
    build.reset_launches()
    skel = pt.sample_skeleton(sampler, 400, np.zeros((512, 5)), np.ones((512, 5)),
                              seed=0, dtype=torch.float32)
    assert (skel.n_valid == 400).all()
    assert build.LAUNCHES["zigzag_chunk"] >= 1 and build.LAUNCHES["compact_rows"] >= 1
    mean, var = pt.pooled_moments(skel, sampler, 200)
    assert (mean.abs() < 0.2).all() and ((var - 1).abs() < 0.3).all()


@pytest.mark.parametrize("pot,d", [("gauss", 6), ("banana", 6), ("gauss", 200)])
def test_k6_kernel_matches_plain_f64(dev, pot, d):
    """K6 against its plain version over two chunks from one f64 state with
    chains near the axes (sticks and thaws) and some chains capped."""
    _k6_matches_plain(dev, pot, d)


@pytest.mark.parametrize("pot,d,B,kw", [
    ("gauss", 10, 300, dict(grid_size=2)),
    ("banana", 10, 300, dict(grid_size=33)),
    ("gauss", 10, 300, dict(grid_size=64, signed_bound=False)),
    ("gauss", 1, 300, {}),       # one coordinate
    ("banana", 33, 300, {}),     # a warp and one lane
    ("gauss", 1000, 64, {}),     # a coordinate per thread
    ("gauss", 1500, 16, {}),     # two tiles of 1024 coordinates
])
def test_k6_kernel_matches_plain_f64_at_edges(dev, pot, d, B, kw):
    """K6 at the grid's edges and at the block's: d = 1 and 33, one
    coordinate per thread of a 1024-thread block (d = 1000), and the strided
    map past it (d = 1500)."""
    _k6_matches_plain(dev, pot, d, B, **kw)


def test_k6_kernel_runs_at_its_largest_d(dev):
    """At the largest d whose copy fits a block's shared memory (float64) K6
    runs and matches its plain version; one coordinate more raises."""
    d = k1.sticky_max_dim(torch.float64)
    _k6_matches_plain(dev, "gauss", d, 4, n_chunks=1, events=False)
    big = pt.StickyZigZag(d + 1, pt.potentials.grad_gauss)
    state = big.init_state_batch(np.zeros((2, d + 1)), np.ones((2, d + 1)), 0,
                                 torch.float64, dev)
    cfg = driver.chunk_config(big, 4, 10, 128)
    cfg = cfg._replace(kappa=cfg.kappa.to(dev))
    st = driver.chunk_state(state, torch.zeros(2, dtype=torch.int32, device=dev), sticky=True)
    fill = k1.empty_fill(4, d + 1, 2, torch.float64, dev, sticky=True)
    with pytest.raises(ValueError, match="shared memory"):
        k1.run_chunk(0, st, fill, 0, cfg)


def _k6_matches_plain(dev, pot, d, B=300, n_chunks=2, events=True, **kw):
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    sampler = pt.StickyZigZag(d, grad, np.full(d, 3.0), **kw)
    rs = np.random.default_rng(d)
    state = sampler.init_state_batch(rs.normal(size=(B, d)) * 0.05,
                                     rs.choice([-1.0, 1.0], size=(B, d)),
                                     3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, 16, 40, 128)
    cfg = cfg._replace(kappa=cfg.kappa.to(dev))
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 37
    st_k = driver.chunk_state(state, counts, sticky=True)
    st_p = k1.ChunkState(*(a.clone() for a in st_k))
    fills = [k1.empty_fill(16 * n_chunks, d, B, torch.float64, dev, sticky=True)
             for _ in range(2)]
    n0 = build.LAUNCHES["sticky_chunk"]
    for it in range(n_chunks):
        k1.run_chunk(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        k1.run_chunk_plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sticky_chunk"] == n0 + n_chunks
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    kinds = fills[0].kind[:, 0]
    assert (kinds == pt.EV_STICK).any()
    if events:
        assert (kinds == pt.EV_THAW).any()


def ar1_band(x):
    """The AR(1) prior (rho 0.5) in its innovation form: every coordinate's
    gradient reads its neighbours ``x[i - 1]`` and ``x[i + 1]``."""
    return x[0] ** 2 / 2 + torch.sum((x[1:] - 0.5 * x[:-1]) ** 2) / 1.5


def neal_last(x):
    """Neal's funnel with its scale at ``x[-1]``, which every coordinate reads."""
    return (x[-1] * x[-1] / 18.0 + 0.5 * (x.shape[0] - 1) * x[-1]
            + 0.5 * torch.sum(x[:-1] ** 2) * torch.exp(-x[-1]))


@pytest.mark.parametrize("U,d,B", [
    (ar1_band, 70, 64),      # neighbours across the warps of one tile
    (ar1_band, 1500, 16),    # and across the strided tiles past 1024
    (neal_last, 1500, 16),   # a fixed coordinate in the last warp, read by every warp
])
def test_k6_reads_other_coordinates_as_plain_f64(dev, U, d, B):
    """K6 on a generated potential that reads other threads' coordinates,
    against its plain version fed the IR's pair, two chunks from one f64
    state near the axes: a read before the barriers that publish the flow,
    flip, stick and thaw would part the two."""
    sampler = pt.StickyZigZagAD(d, U, np.full(d, 3.0))
    rs = np.random.default_rng(d)
    x0 = rs.normal(size=(B, d)) * 0.05
    if U is neal_last:
        x0[:, -1] = 0.5
    state = sampler.init_state_batch(x0, rs.choice([-1.0, 1.0], size=(B, d)), 3,
                                     torch.float64, dev)
    cfg = driver.chunk_config(sampler, 16, 40, 128)
    cfg = driver.lowered_config(cfg._replace(kappa=cfg.kappa.to(dev)), sampler, d,
                                torch.float64, dev)
    assert "reads_others = true" in cfg.user.header() and not cfg.user.point
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 37
    st_k = driver.chunk_state(state, counts, sticky=True)
    st_p = k1.ChunkState(*(a.clone() for a in st_k))
    fills = [k1.empty_fill(32, d, B, torch.float64, dev, sticky=True) for _ in range(2)]
    n0 = build.LAUNCHES["sticky_chunk"]
    for it in range(2):
        k1.run_chunk(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        k1.run_chunk_plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES["sticky_chunk"] == n0 + 2
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    kinds = fills[0].kind[:, 0]
    assert (kinds == pt.EV_JUMP).any() and (kinds == pt.EV_STICK).any()


def shifted_quadratic(d, dev):
    """``U = (x - mu) P (x - mu) / 2`` for a seeded SPD ``P``: two products
    of the affine ``x - mu`` (constant part ``-P mu``), which K1 and K3/K5
    form once per transition."""
    rs = np.random.default_rng(d + 1)
    a = rs.normal(size=(d, d)) / np.sqrt(d)
    P = torch.as_tensor(a @ a.T + np.eye(d), device=dev)
    mu = torch.as_tensor(rs.normal(size=d) * 0.3, device=dev)
    return lambda x: 0.5 * (x - mu.to(x)) @ (P.to(x) @ (x - mu.to(x)))


@pytest.mark.parametrize("kind,d,B", [
    ("zigzag", 200, 300),   # past the old per-lane cap in f64 (d ~ 85)
    ("bps", 200, 300),      # past the old per-lane cap in f64 (d ~ 128)
    ("boomerang", 200, 300),  # the elliptic read: cos, sin and -P mu
    ("ecmc", 200, 300),
    ("zigzag", 2500, 16),   # the group's copy past shared memory: the (NP, B) scratch
])
def test_transition_products_match_plain_f64(dev, kind, d, B):
    """A dense quadratic form whose products K1 and K3/K5 form once per
    transition, against the plain version fed the IR's pair along the
    transition (``Lowered.along``), two chunks from one f64 state: K1 to
    rtol 1e-9, K3/K5 bit for bit (no math function parts the two)."""
    make = {"zigzag": pt.ZigZagAD, "bps": pt.BPSAD, "boomerang": pt.BoomerangAD,
            "ecmc": pt.ForwardECMCAD}[kind]
    sampler = make(d, shifted_quadratic(d, dev))
    rs = np.random.default_rng(d)
    x0 = rs.normal(size=(B, d))
    if kind == "zigzag":
        v0 = rs.choice([-1.0, 1.0], size=(B, d))
    else:
        v0 = rs.normal(size=(B, d))
        if kind != "boomerang":
            v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    state = sampler.init_state_batch(x0, v0, 3, torch.float64, dev)
    cfg = driver.lowered_config(driver.chunk_config(sampler, 16, 20, 128), sampler, d,
                                torch.float64, dev)
    assert cfg.user.n_trans == 4 * d and cfg.per_transition is not None
    assert cfg.user.lane_bytes() == 0
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 17
    st_k = driver.chunk_state(state, counts)
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(32, d, B, torch.float64, dev) for _ in range(2)]
    scalar = kind in k3.KINDS
    run, plain = ((k3.run_chunk, k3.run_chunk_plain) if scalar
                  else (k1.run_chunk, k1.run_chunk_plain))
    name = k3.launch_name(kind) if scalar else "zigzag_chunk"
    n0 = build.LAUNCHES[name]
    for it in range(2):
        run(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:
            continue
        if a.dtype == torch.int32 or scalar:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    assert int((fills[0].kind[:, 0] == pt.EV_JUMP).sum()) > B


def test_sticky_sample_skeleton_on_card(dev):
    kappa = 1.0
    sampler = pt.StickyZigZag(4, pt.potentials.grad_gauss, np.full(4, kappa))
    build.reset_launches()
    skel = pt.sample_skeleton(sampler, 1000, np.full((256, 4), 0.3), np.ones((256, 4)),
                              seed=0, dtype=torch.float32)
    assert (skel.n_valid == 1000).all()
    assert build.LAUNCHES["sticky_chunk"] >= 1 and build.LAUNCHES["compact_rows"] >= 1
    assert build.LAUNCHES["zigzag_chunk"] == 0
    assert not bool(skel.is_active.all())
    xs = pt.sample_from_skeleton_batch(sampler, 500, skel)
    phi0 = 1.0 / np.sqrt(2 * np.pi)
    frozen = float((xs == 0.0).double().mean())
    assert abs(frozen - phi0 / (kappa + phi0)) < 0.05


DENSE = torch.tensor([[2.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 3.0]])
"""A dense coupling (``A @ x``): the kernels form the product at every point."""


def running_product(x):
    """A gradient the lowering refuses: a running product (``aten.cumprod``)."""
    return x + 0.1 * torch.cumprod(torch.tanh(x), 0)


def test_k6_refuses_what_it_cannot_run(dev):
    """A sticky sampler on CUDA launches K6 or raises: past the shared-memory
    limit on d, and for a gradient the lowering cannot express (a gradient of
    the user's own that it can runs on K6)."""
    d = k1.sticky_max_dim(torch.float32) + 1
    big = pt.StickyZigZag(d, pt.potentials.grad_gauss)
    state = big.init_state_batch(np.zeros((2, d)), np.ones((2, d)), 0, torch.float32, dev)
    cfg = driver.chunk_config(big, 4, 10, 128)
    cfg = cfg._replace(kappa=cfg.kappa.to(dev, torch.float32))
    st = driver.chunk_state(state, torch.zeros(2, dtype=torch.int32, device=dev), sticky=True)
    fill = k1.empty_fill(4, d, 2, torch.float32, dev, sticky=True)
    with pytest.raises(ValueError, match="shared memory"):
        k1.run_chunk(0, st, fill, 0, cfg)
    untagged = pt.StickyZigZag(3, lambda x: x)  # lowered: K6 on a generated potential
    n0 = build.LAUNCHES["sticky_chunk"]
    skel = pt.sample_skeleton(untagged, 10, np.zeros((2, 3)), np.ones((2, 3)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["sticky_chunk"] > n0
    dense = pt.StickyZigZag(3, lambda x: DENSE.to(x) @ x)  # K6 forms A @ x at each point
    n0 = build.LAUNCHES["sticky_chunk"]
    skel = pt.sample_skeleton(dense, 10, np.zeros((2, 3)), np.ones((2, 3)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["sticky_chunk"] > n0
    with pytest.raises(lower.LoweringError, match="aten.cumprod"):
        pt.sample_skeleton(pt.StickyZigZag(3, running_product), 10, np.zeros((2, 3)),
                           np.ones((2, 3)))


def scalar_sampler(kind, pot, d, **kw):
    if pot == "aniso":
        U = pt.potentials.anisotropic_gauss(np.linspace(0.5, 3.0, d))
        return {"bps": pt.BPSAD, "boomerang": pt.BoomerangAD,
                "ecmc": pt.ForwardECMCAD}[kind](d, U, **kw)
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    return {"bps": pt.BPS, "boomerang": pt.Boomerang, "ecmc": pt.ForwardECMC}[kind](
        d, grad, **kw)


@pytest.mark.parametrize("kind,pot,d,kw", [
    ("bps", "gauss", 10, {}),
    ("bps", "aniso", 10, dict(signed_bound=False, gaussian_velocity=True)),
    ("boomerang", "banana", 10, dict(refresh_rate=0.3)),
    ("ecmc", "gauss", 10, dict(ran_p=True, positive=False)),
    ("ecmc", "aniso", 3, dict(switch=False, normal=True)),
    ("bps", "banana", 70, dict(refresh_rate=0.5)),
])
def test_k3_k5_kernel_matches_plain_f64(dev, kind, pot, d, kw):
    """K3/K5 against their plain version over two chunks from one f64 state,
    some chains capped, a few starting with x parallel to v."""
    _k3_k5_matches_plain(dev, kind, pot, d, kw)


@pytest.mark.parametrize("grid", [2, 33, 64])
@pytest.mark.parametrize("kind,pot,kw", [
    ("bps", "aniso", dict(signed_bound=False)),
    ("boomerang", "banana", dict(refresh_rate=0.3)),
    ("ecmc", "gauss", dict(ran_p=True)),
])
def test_k3_k5_kernel_matches_plain_f64_at_grid_edges(dev, kind, pot, kw, grid):
    """The envelope's edges across the warp: one grid point per lane (2), and
    lanes owning two grid points with lane 31 handing its pair across (33,
    64)."""
    _k3_k5_matches_plain(dev, kind, pot, 10, dict(kw, grid_size=grid))


def _k3_k5_matches_plain(dev, kind, pot, d, kw):
    B = 300
    sampler = scalar_sampler(kind, pot, d, **kw)
    rs = np.random.default_rng(d)
    x0, v0 = rs.normal(size=(B, d)), rs.normal(size=(B, d))
    if kind != "boomerang":
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    x0[::13] = 0.5 * v0[::13]
    state = sampler.init_state_batch(x0, v0, 3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, 16, 20, 128)
    if cfg.pot_params is not None:
        cfg = cfg._replace(pot_params=cfg.pot_params.to(dev))
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 17
    st_k = driver.chunk_state(state, counts)
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(32, d, B, torch.float64, dev) for _ in range(2)]
    name = k3.launch_name(kind)
    n0 = build.LAUNCHES[name]
    for it in range(2):
        k3.run_chunk(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        k3.run_chunk_plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:
            continue
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    assert int((fills[0].kind[:, 0] == pt.EV_JUMP).sum()) > B


def test_scalar_samplers_on_card(dev):
    """BPS, Boomerang and Forward ECMC through ``sample_skeleton`` on the
    card: complete, their kernel launched, moments of their targets."""
    s = np.linspace(0.5, 3.0, 5)
    cases = [(pt.BPSAD(5, pt.potentials.anisotropic_gauss(s), refresh_rate=0.5), s ** 2, 1.0),
             (pt.Boomerang(5, pt.potentials.grad_gauss, refresh_rate=0.5), np.ones(5), 1.0),
             (pt.ForwardECMCAD(5, pt.potentials.gauss), np.ones(5), 1 / np.sqrt(5))]
    for sampler, var_true, speed in cases:
        build.reset_launches()
        skel = pt.sample_skeleton(sampler, 1000, np.zeros((512, 5)),
                                  np.full((512, 5), speed), seed=0, dtype=torch.float32)
        assert (skel.n_valid == 1000).all()
        assert build.LAUNCHES[k3.launch_name(driver.kernel_kind(sampler))] >= 1
        assert build.LAUNCHES["zigzag_chunk"] == 0 and build.LAUNCHES["compact_rows"] >= 1
        mean, var = pt.pooled_moments(skel, sampler, 200)
        rel = (var.cpu().numpy() / var_true) - 1
        assert (mean.abs().cpu().numpy() < 0.15 * np.sqrt(var_true)).all(), mean
        assert (np.abs(rel) < 0.15).all(), var


@pytest.mark.parametrize("kind", ["zigzag", "sticky", "bps", "boomerang", "ecmc"])
def test_k7_kernels_match_plain_f64(dev, kind):
    """K1, K6 and K3/K5 in horizon mode (K7) against their plain version over
    two chunks from one f64 state, the float32 target at the median clock an
    event-count run reaches, so that about half of the lanes freeze inside;
    K3/K5 bit for bit, K1/K6 (built with FMA contraction) to rtol 1e-9."""
    B, d = 300, 6
    rs = np.random.default_rng(7)
    x0 = rs.normal(size=(B, d)) * (0.1 if kind == "sticky" else 1.0)
    if kind in ("zigzag", "sticky"):
        v0 = rs.choice([-1.0, 1.0], size=(B, d))
        sampler = (pt.StickyZigZag(d, pt.potentials.grad_gauss, np.full(d, 3.0))
                   if kind == "sticky" else pt.ZigZag(d, pt.potentials.grad_gauss))
        run, plain = k1.run_chunk, k1.run_chunk_plain
    else:
        v0 = rs.normal(size=(B, d))
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
        sampler = scalar_sampler(kind, "banana" if kind == "boomerang" else "gauss", d,
                                 **({} if kind == "ecmc" else dict(refresh_rate=0.3)))
        run, plain = k3.run_chunk, k3.run_chunk_plain
    sticky = kind == "sticky"
    state = sampler.init_state_batch(x0, v0, 3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, 16, 1 << 30, 128)
    if sticky:
        cfg = cfg._replace(kappa=cfg.kappa.to(dev))
    zeros = torch.zeros(B, dtype=torch.int32, device=dev)
    probe = driver.chunk_state(state, zeros, sticky)
    for it in range(2):
        plain(11 + it * 1000003, probe, k1.empty_fill(16, d, B, torch.float64, dev, sticky),
              0, cfg)
    cfg = cfg._replace(t_target=k1.f32_target(float(probe.fs[k1.F_T].median())))
    st_k = driver.chunk_state(state, zeros, sticky)
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(32, d, B, torch.float64, dev, sticky) for _ in range(2)]
    name = ("sticky_chunk" if sticky else "zigzag_chunk" if kind == "zigzag"
            else k3.launch_name(kind)) + "_horizon"
    n0 = build.LAUNCHES[name]
    for it in range(2):
        run(11 + it * 1000003, st_k, fills[0], 16 * it, cfg)
        plain(11 + it * 1000003, st_p, fills[1], 16 * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    exact = kind not in ("zigzag", "sticky")
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:
            continue
        if a.dtype in (torch.int32, torch.bool) or exact:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    froze = float((st_k.fs[k1.F_T] >= cfg.t_target).double().mean())
    assert 0.2 < froze < 0.9, froze


def test_horizon_sample_skeleton_on_card(dev):
    """A time-horizon skeleton on the card: K1 in horizon mode and K2
    launched, every chain ends at exactly T with a terminal row, no kept row
    past T, t non-decreasing, moments of N(0, I)."""
    T, B, d = 150.0, 512, 5
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    build.reset_launches()
    skel = pt.sample_skeleton(sampler, T, np.zeros((B, d)), np.ones((B, d)), seed=0,
                              dtype=torch.float32, init_capacity=512)
    assert build.LAUNCHES["zigzag_chunk_horizon"] >= 1 and build.LAUNCHES["compact_rows"] >= 1
    assert build.LAUNCHES["zigzag_chunk"] == 0
    nv = skel.n_valid.long()
    rows = torch.arange(B, device=dev)
    assert bool((skel.t[rows, nv - 1] == T).all())
    assert bool((skel.kind[rows, nv - 1] == pt.EV_TERMINAL).all())
    valid = torch.arange(skel.t.shape[1], device=dev)[None, :] < nv[:, None]
    assert bool((skel.t[valid] <= T).all())
    assert bool(((skel.t[:, 1:] >= skel.t[:, :-1]) | ~valid[:, 1:]).all())
    mean, var = pt.pooled_moments(skel, sampler, 200)
    assert (mean.abs() < 0.2).all() and ((var - 1).abs() < 0.3).all()


def test_k3_k5_refuse_what_they_cannot_run(dev):
    """On CUDA tensors the scalar-rate kernel launches or raises: a gradient
    the lowering cannot express, past the shared-memory limit on d (an
    untagged one it can runs on K3); K1 runs every tag, the ``aniso`` tag
    that only K3/K5 took before included."""
    untagged = pt.BPS(3, lambda x: x)  # lowered: K3 on a generated potential
    n0 = build.LAUNCHES["bps_chunk"]
    skel = pt.sample_skeleton(untagged, 10, np.zeros((2, 3)), np.ones((2, 3)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["bps_chunk"] > n0
    with pytest.raises(lower.LoweringError, match="aten.cumprod"):
        pt.sample_skeleton(pt.BPS(3, running_product), 10, np.zeros((2, 3)),
                           np.ones((2, 3)))
    n0 = build.LAUNCHES["bps_chunk"]  # K3 forms A @ x at each grid point
    skel = pt.sample_skeleton(pt.BPS(3, lambda x: DENSE.to(x) @ x), 10, np.zeros((2, 3)),
                              np.ones((2, 3)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["bps_chunk"] > n0
    d = k3.scalar_max_dim(torch.float64) + 1
    big = pt.BPS(d, pt.potentials.grad_gauss)
    state = big.init_state_batch(np.zeros((2, d)), np.ones((2, d)), 0, torch.float64, dev)
    st = driver.chunk_state(state, torch.zeros(2, dtype=torch.int32, device=dev))
    fill = k1.empty_fill(4, d, 2, torch.float64, dev)
    with pytest.raises(ValueError, match="shared memory"):
        k3.run_chunk(0, st, fill, 0, driver.chunk_config(big, 4, 10, 128))
    aniso_zz = pt.ZigZagAD(4, pt.potentials.anisotropic_gauss(np.ones(4)))
    n0 = build.LAUNCHES["zigzag_chunk"]
    skel = pt.sample_skeleton(aniso_zz, 10, np.zeros((2, 4)), np.ones((2, 4)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["zigzag_chunk"] > n0


@pytest.mark.parametrize("pot,signed,horizon", [("gauss", True, False), ("banana", False, False),
                                                ("gauss", True, True), ("banana", True, True)])
def test_k4_kernel_matches_plain_f64(dev, pot, signed, horizon):
    """K4 (the Speed-Up Zig-Zag chunk) against its plain version over two
    chunks from one f64 state, some chains capped; in horizon mode the
    float32 target at the median clock an event-count run reaches."""
    _k4_matches_plain(dev, pot, horizon, signed_bound=signed)


@pytest.mark.parametrize("pot,kw", [("gauss", dict(grid_size=2, tmax=0.1)),
                                    ("banana", dict(grid_size=33)),
                                    ("gauss", dict(grid_size=64, signed_bound=False)),
                                    ("banana", dict(grid_size=64))])
def test_k4_kernel_matches_plain_f64_at_grid_edges(dev, pot, kw):
    """K4 at the envelope's edges across the warp (see the K3/K5 test); at
    two grid points a shorter tmax, or a run this short sees no event."""
    _k4_matches_plain(dev, pot, False, **kw)


def test_k4_kernel_reads_x_and_v_in_place_past_shared_memory(dev):
    """At d = 3700 four chains' f64 x and v exceed a block's shared memory,
    and K4 reads them in place in the chain-minor state."""
    _k4_matches_plain(dev, "gauss", False, d=3700, B=8, K=4, n_chunks=1, tmax=0.01)


def _k4_matches_plain(dev, pot, horizon, d=6, B=300, K=16, n_chunks=2, **kw):
    grad = {"gauss": pt.potentials.grad_gauss, "banana": pt.potentials.grad_banana}[pot]
    sampler = pt.SpeedUpZigZag(d, grad, **kw)
    rs = np.random.default_rng(9)
    state = sampler.init_state_batch(rs.normal(size=(B, d)), rs.choice([-1.0, 1.0], size=(B, d)),
                                     3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, K, 20, 128)
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 17
    if horizon:
        probe = driver.chunk_state(state, counts)
        for it in range(n_chunks):
            k1.run_chunk_plain(11 + it * 1000003, probe,
                               k1.empty_fill(K, d, B, torch.float64, dev), 0, cfg)
        cfg = cfg._replace(t_target=k1.f32_target(float(probe.fs[k1.F_T].median())))
    st_k = driver.chunk_state(state, counts)
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(K * n_chunks, d, B, torch.float64, dev) for _ in range(2)]
    name = k1.launch_name(cfg)
    n0 = build.LAUNCHES[name]
    for it in range(n_chunks):
        k1.run_chunk(11 + it * 1000003, st_k, fills[0], K * it, cfg)
        k1.run_chunk_plain(11 + it * 1000003, st_p, fills[1], K * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + n_chunks
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:
            continue
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    assert int((fills[0].kind[:, 0] == pt.EV_JUMP).sum()) > B
    if horizon:
        froze = float((st_k.fs[k1.F_T] >= cfg.t_target).double().mean())
        assert 0.2 < froze < 0.9, froze


def test_suzz_sample_skeleton_on_card(dev):
    """The Speed-Up Zig-Zag through ``sample_skeleton`` on the card, in both
    modes: K4 and K2 launched, moments of N(0, I)."""
    sampler = pt.SpeedUpZigZagAD(5, pt.potentials.gauss)
    build.reset_launches()
    skel = pt.sample_skeleton(sampler, 600, np.zeros((512, 5)), np.ones((512, 5)),
                              seed=0, dtype=torch.float32)
    assert (skel.n_valid == 600).all()
    assert build.LAUNCHES["suzz_chunk"] >= 1 and build.LAUNCHES["compact_rows"] >= 1
    assert build.LAUNCHES["zigzag_chunk"] == 0
    mean, var = pt.pooled_moments(skel, sampler, 200)
    assert (mean.abs() < 0.2).all() and ((var - 1).abs() < 0.3).all()
    T = 40.0
    skel = pt.sample_skeleton(sampler, T, np.zeros((512, 5)), np.ones((512, 5)), seed=1,
                              dtype=torch.float32, init_capacity=512)
    assert build.LAUNCHES["suzz_chunk_horizon"] >= 1
    nv = skel.n_valid.long()
    rows = torch.arange(512, device=dev)
    assert bool((skel.t[rows, nv - 1] == T).all())
    assert bool((skel.kind[rows, nv - 1] == pt.EV_TERMINAL).all())


def test_k4_refuses_what_it_cannot_run(dev):
    """On CUDA tensors K4 launches or raises: a gradient the lowering cannot
    express raises, an untagged one it can runs on K4; every tag runs,
    ``aniso`` (which it lacked before) included."""
    untagged = pt.SpeedUpZigZag(4, lambda x: x)  # lowered: K4 on a generated potential
    n0 = build.LAUNCHES["suzz_chunk"]
    skel = pt.sample_skeleton(untagged, 10, np.zeros((2, 4)), np.ones((2, 4)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["suzz_chunk"] > n0
    dense = torch.block_diag(DENSE, torch.ones(1, 1))  # K4 forms A @ x at each point
    n0 = build.LAUNCHES["suzz_chunk"]
    skel = pt.sample_skeleton(pt.SpeedUpZigZag(4, lambda x: dense.to(x) @ x), 10,
                              np.zeros((2, 4)), np.ones((2, 4)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["suzz_chunk"] > n0
    with pytest.raises(lower.LoweringError, match="aten.cumprod"):
        pt.sample_skeleton(pt.SpeedUpZigZag(4, running_product), 10, np.zeros((2, 4)),
                           np.ones((2, 4)))
    aniso = pt.SpeedUpZigZagAD(4, pt.potentials.anisotropic_gauss(np.ones(4)))
    n0 = build.LAUNCHES["suzz_chunk"]
    skel = pt.sample_skeleton(aniso, 10, np.zeros((2, 4)), np.ones((2, 4)))
    assert bool((skel.n_valid == 10).all()) and build.LAUNCHES["suzz_chunk"] > n0


TAG_POTENTIALS = {"cauchy": "cauchy", "ridged": "ridged_gauss", "funnel": "funnel",
                  "neal_funnel": "neal_funnel"}


@pytest.mark.parametrize("tag", list(TAG_POTENTIALS) + ["aniso"])
@pytest.mark.parametrize("kind", ["zigzag", "sticky", "suzz", "bps", "boomerang", "ecmc"])
def test_every_tag_on_every_kernel_matches_plain_f64(dev, kind, tag):
    """Each chunk kernel on each test potential the port tagged for it
    (``cauchy``, ``ridged_gauss``, ``funnel``, ``neal_funnel`` and
    ``anisotropic_gauss``) against its plain version over two chunks from one
    f64 state, some chains capped: integers equal, floats to rtol 1e-9."""
    d, B, K = 6, 300, 16
    U = (pt.potentials.anisotropic_gauss(np.linspace(0.5, 3.0, d)) if tag == "aniso"
         else getattr(pt.potentials, TAG_POTENTIALS[tag]))
    sticky = kind == "sticky"
    sampler = {"zigzag": lambda: pt.ZigZagAD(d, U),
               "sticky": lambda: pt.StickyZigZagAD(d, U, np.full(d, 3.0)),
               "suzz": lambda: pt.SpeedUpZigZagAD(d, U),
               "bps": lambda: pt.BPSAD(d, U, refresh_rate=0.5),
               "boomerang": lambda: pt.BoomerangAD(d, U, refresh_rate=0.5),
               "ecmc": lambda: pt.ForwardECMCAD(d, U)}[kind]()
    rs = np.random.default_rng(d)
    x0 = rs.normal(size=(B, d)) * (0.05 if sticky else 1.0)
    if tag == "funnel":
        x0[:, 0] = 0.5 + np.abs(x0[:, 0])
    if kind in ("zigzag", "sticky", "suzz"):
        v0 = rs.choice([-1.0, 1.0], size=(B, d))
    else:
        v0 = rs.normal(size=(B, d))
        if kind != "boomerang":
            v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    state = sampler.init_state_batch(x0, v0, 3, torch.float64, dev)
    cfg = driver.chunk_config(sampler, K, 20, 128)
    cfg = cfg._replace(
        kappa=None if cfg.kappa is None else cfg.kappa.to(dev),
        pot_params=None if cfg.pot_params is None else cfg.pot_params.to(dev))
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 17
    st_k = driver.chunk_state(state, counts, sticky)
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(2 * K, d, B, torch.float64, dev, sticky) for _ in range(2)]
    scalar = kind in k3.KINDS
    run, plain = ((k3.run_chunk, k3.run_chunk_plain) if scalar
                  else (k1.run_chunk, k1.run_chunk_plain))
    name = k3.launch_name(kind) if scalar else k1.launch_name(cfg)
    n0 = build.LAUNCHES[name]
    for it in range(2):
        run(11 + it * 1000003, st_k, fills[0], K * it, cfg)
        plain(11 + it * 1000003, st_p, fills[1], K * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:
            continue
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    assert int((fills[0].kind[:, 0] > 0).sum()) > B


def _batch_skeleton(dtype, device, B=7, N=40, d=3, seed=0):
    """A padded chain-batch skeleton with irregular clocks and n_valid."""
    rs = np.random.default_rng(seed)
    nv = rs.integers(5, N + 1, size=B).astype(np.int32)
    t = np.cumsum(rs.exponential(0.37, size=(B, N)), axis=1)
    t[:, 0] = 0.0
    t[np.arange(N)[None, :] >= nv[:, None]] = 0.0
    fields = dict(x=rs.normal(size=(B, N, d)), v=rs.choice([-1.0, 1.0], size=(B, N, d)), t=t,
                  horizon=np.ones((B, N)), ar=np.zeros((B, N)),
                  is_active=np.ones((B, N, d), bool), rejected=np.zeros((B, N), np.int32),
                  errored_bound=np.zeros((B, N), np.int32),
                  hitting_horizon=np.zeros((B, N), np.int32),
                  error_value_ar=np.zeros((B, N, 5)), kind=np.full((B, N), 2, np.int32),
                  n_valid=nv)
    fields = {f: a.astype(dtype) if a.dtype == np.float64 else a for f, a in fields.items()}
    return convert.skeleton_from_numpy(fields, device=device)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_sample_times_match_cpu_bit_for_bit(dev, dtype):
    """Equal-time sample times at n = 300 per chain, t_end / 300, are the
    CPU's bit for bit: the port divides by a tensor, as JAX divides, where
    torch's CUDA division by a Python number multiplies by its rounded
    reciprocal."""
    sampler = pt.ZigZag(3, pt.potentials.grad_gauss)
    got = pt.sample_from_skeleton_batch(sampler, 300, _batch_skeleton(dtype, dev),
                                        discard_vt=False)
    want = pt.sample_from_skeleton_batch(sampler, 300, _batch_skeleton(dtype, "cpu"),
                                         discard_vt=False)
    assert torch.equal(got[..., -1].cpu(), want[..., -1])


def _stream_sampler(kind, d):
    if kind == "zigzag":
        return pt.ZigZag(d, pt.potentials.grad_gauss)
    return pt.StickyZigZag(d, pt.potentials.grad_gauss, np.full(d, 5.0))


STREAM_KW = dict(n_samples=512, n_batches=8, seed=7, t_cap=64, grid_chunk=128,
                 dtype=torch.float64)


@pytest.mark.parametrize("kind", ["zigzag", "sticky"])
def test_streaming_run_on_card_matches_cpu(dev, kind):
    """A small streaming run on the card (K1 or K6 in horizon mode, the fold
    in torch on the card) against the same run on the CPU, f64: counts and
    events equal, sums to rtol 1e-9 (K1 and K6 keep FMA).  The card groups
    fills by 8 and the CPU by 2; fills past the horizon fold nothing."""
    d, B = 5, 32
    rs = np.random.default_rng(1)
    x0, v0 = rs.normal(size=(B, d)) * 0.4, rs.choice([-1.0, 1.0], size=(B, d))
    cpu = pt.sample_streaming_stats(_stream_sampler(kind, d), 40.0, x0, v0, device="cpu",
                                    **STREAM_KW)
    launch = "zigzag_chunk_horizon" if kind == "zigzag" else "sticky_chunk_horizon"
    n0 = build.LAUNCHES[launch]
    gpu = pt.sample_streaming_stats(_stream_sampler(kind, d), 40.0, x0, v0, device=dev,
                                    **STREAM_KW)
    torch.cuda.synchronize()
    assert build.LAUNCHES[launch] > n0 and gpu.stats.bsum.is_cuda
    assert gpu.events == cpu.events and gpu.fills % 8 == 0
    for f, a, b in zip(pt.streaming.StreamingStats._fields, gpu.stats, cpu.stats):
        if a.dtype == torch.int32:
            assert torch.equal(a.cpu(), b), f
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12, msg=f)


@pytest.mark.parametrize("mode", ["events", "horizon", "streaming"])
@pytest.mark.parametrize("kind", ["zigzag", "sticky"])
def test_checkpoint_resume_on_card_is_bit_for_bit(dev, tmp_path, monkeypatch, kind, mode):
    """A run interrupted by PDMPFLUX_FAIL_AFTER_FILLS and resumed from its
    file equals the unbroken run on the card bit for bit (float32).  The
    unbroken run checkpoints too, so that both group fills alike."""
    d, B = 20, 64
    x0, v0 = np.full((B, d), 0.3), np.ones((B, d))
    kw = dict(seed=3, dtype=torch.float32, device=dev)

    def run(path):
        s = _stream_sampler(kind, d)
        ck = dict(checkpoint_path=path, checkpoint_every=1)
        if mode == "events":
            return pt.sample_skeleton(s, 400, x0, v0, t_cap=64, **ck, **kw)
        if mode == "horizon":
            return pt.sample_skeleton(s, 30.0, x0, v0, t_cap=64, **ck, **kw)
        return pt.sample_streaming_stats(s, 30.0, x0, v0, n_samples=4096, n_batches=16,
                                         t_cap=256, **ck, **kw)

    ref = run(str(tmp_path / "ref.npz"))
    path = str(tmp_path / "run.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        run(path)
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    got = run(path)
    if mode == "streaming":
        assert (got.events, got.fills) == (ref.events, ref.fills) and ref.fills > 2
        got, ref = got.stats, ref.stats
    for a, b in zip(got, ref):
        assert a.is_cuda and torch.equal(a, b)


ENGINE_CASES = {
    "zigzag_scalar": lambda d: pt.ZigZagAD(d, pt.potentials.gauss, vectorized_bound=False),
    "zigzag_fd": lambda d: pt.ZigZagAD(d, pt.potentials.banana, AD_backend="FiniteDiff"),
    "sticky_scalar": lambda d: pt.StickyZigZagAD(d, pt.potentials.gauss, np.full(d, 0.7),
                                                 vectorized_bound=False),
    "bps": lambda d: pt.BPSAD(d, pt.potentials.gauss, refresh_rate=0.5),
    "ecmc_normal": lambda d: pt.ForwardECMCAD(d, pt.potentials.gauss, normal=True),
    "rhmc": lambda d: pt.RHMCAD(d, pt.potentials.gauss),
    "rhmc_untagged": lambda d: pt.RHMCAD(d, lambda x: torch.sum(x * x) / 2),
}


@pytest.mark.parametrize("family", list(ENGINE_CASES))
def test_engine_on_the_card_matches_cpu(dev, family):
    """``chip_smoke.py`` phase 22 at a small size: 64 engine transitions of
    64 chains from one f64 state on the card and on the CPU; every chain
    takes the same decisions with its event rows within rtol 1e-9 (1e-6 with
    finite-difference tangents, which turn the card's last-bit differences
    from the CPU in log1p, log and the sums over d, as phase 22 traces them,
    into an envelope difference of about 1e-8)."""
    from pdmpflux_tpu_torch.core import engine

    d, B, n = 6, 64, 64
    sampler = ENGINE_CASES[family](d)
    rs = np.random.default_rng(1)
    x0 = rs.normal(size=(B, d))
    v0 = (rs.choice([-1.0, 1.0], size=(B, d)) if family.startswith(("zigzag", "sticky"))
          else rs.normal(size=(B, d)))
    if family.startswith("ecmc"):
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    outs = []
    for device in ("cpu", dev):
        st = sampler.init_state_batch(x0, v0, 2, torch.float64, device)
        tr = engine.make_transition(sampler)
        evs = []
        for _ in range(n):
            st, ev = tr(st)
            evs.append(ev)
        outs.append([torch.stack(f).cpu() for f in zip(*evs)])
    rtol = 1e-6 if family == "zigzag_fd" else 1e-9
    for a, b in zip(*outs):
        if a.dtype in (torch.int32, torch.bool):
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(b, a, rtol=rtol, atol=1e-12, equal_nan=True)


def test_backend_routing_on_the_card(dev):
    """``chip_smoke.py`` phase 25 at a small size."""
    from pdmpflux_tpu_torch.core import engine

    x0, v0 = np.zeros((32, 4)), np.ones((32, 4))
    kw = dict(seed=1, dtype=torch.float32, device=dev)
    build.reset_launches()
    engine.reset_counts()
    pt.sample_skeleton(pt.ZigZag(4, pt.potentials.grad_gauss), 64, x0, v0, **kw)
    assert build.LAUNCHES["zigzag_chunk"] > 0 and engine.COUNTS["transitions"] == 0
    for s in (pt.RHMC(4, pt.potentials.grad_gauss),
              pt.ZigZag(4, pt.potentials.grad_gauss, vectorized_bound=False)):
        build.reset_launches()
        engine.reset_counts()
        skel = pt.sample_skeleton(s, 64, x0, v0, **kw)
        assert bool((skel.n_valid == 64).all())
        assert engine.COUNTS["transitions"] > 0 and build.LAUNCHES["compact_rows"] > 0
        assert build.LAUNCHES["zigzag_chunk"] == 0
    with pytest.raises(ValueError, match="backend='xla'"):
        pt.sample_skeleton(pt.RHMC(4, pt.potentials.grad_gauss), 64, x0, v0, **kw,
                           backend="pallas")
    untagged = pt.ZigZag(4, lambda x: x)  # lowered: K1 on a generated potential
    build.reset_launches()
    engine.reset_counts()
    skel = pt.sample_skeleton(untagged, 64, x0, v0, **kw)
    assert bool((skel.n_valid == 64).all()) and build.LAUNCHES["zigzag_chunk"] > 0
    assert engine.COUNTS["transitions"] == 0
    dense4 = torch.block_diag(DENSE, torch.ones(1, 1))
    dense = pt.ZigZag(4, lambda x: dense4.to(x) @ x)  # K1 forms A @ x at each point
    build.reset_launches()
    engine.reset_counts()
    skel = pt.sample_skeleton(dense, 64, x0, v0, **kw)
    assert bool((skel.n_valid == 64).all()) and build.LAUNCHES["zigzag_chunk"] > 0
    assert engine.COUNTS["transitions"] == 0
    refused = pt.ZigZag(4, running_product)
    build.reset_launches()
    with pytest.raises(lower.LoweringError, match="backend='xla_stream'"):
        pt.sample_skeleton(refused, 64, x0, v0, **kw)
    assert not any(build.LAUNCHES.values())  # refused before any launch
    engine.reset_counts()
    skel = pt.sample_skeleton(refused, 64, x0, v0, **kw, backend="xla_stream")
    assert bool((skel.n_valid == 64).all()) and engine.COUNTS["transitions"] > 0
    hz = pt.sample_skeleton(pt.RHMC(4, pt.potentials.grad_gauss), 20.0, x0, v0, **kw)
    last = hz.n_valid.long() - 1
    assert bool((hz.t[torch.arange(32, device=dev), last] == 20.0).all())


@pytest.mark.parametrize("n_or_T", [400, 30.0])
@pytest.mark.parametrize("kind", ["zigzag", "sticky"])
def test_host_accumulation_on_card_equals_device_path(dev, monkeypatch, kind, n_or_T):
    """Host accumulation (K1 or K6 fills, K2 on the card, one copy per fill)
    returns CPU tensors equal to the device path's bit for bit up to
    ``n_valid`` (float32, 64-row fills, so chains straggle)."""
    d, B = 20, 64
    x0, v0 = np.full((B, d), 0.3), np.ones((B, d))
    kw = dict(seed=3, dtype=torch.float32, device=dev, t_cap=64)
    ref = pt.sample_skeleton(_stream_sampler(kind, d), n_or_T, x0, v0, **kw)
    monkeypatch.setenv("PDMPFLUX_STREAM_HOST_ACC", "1")
    n0 = build.LAUNCHES["compact_rows"]
    got = pt.sample_skeleton(_stream_sampler(kind, d), n_or_T, x0, v0, **kw)
    assert build.LAUNCHES["compact_rows"] > n0 + 1 and got.t.device.type == "cpu"
    W = got.t.shape[1]
    for f, a, b in zip(got._fields, got, ref):
        assert torch.equal(a, (b if f == "n_valid" else b[:, :W]).cpu()), f


@pytest.mark.parametrize("n_or_T", [300, 20.0])
def test_sharded_run_on_card_equals_sample_skeleton(dev, n_or_T):
    """``sample_skeleton_sharded`` on a one-card mesh (K1, K2 on the card)
    equals ``sample_skeleton`` bit for bit, and its stats are the
    skeleton's."""
    d, B = 10, 1024
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    x0, v0 = np.zeros((B, d)), np.ones((B, d))
    kw = dict(seed=1, dtype=torch.float32)
    ref = pt.sample_skeleton(sampler, n_or_T, x0, v0, device=dev, **kw)
    n0 = build.LAUNCHES["zigzag_chunk" + ("_horizon" if isinstance(n_or_T, float) else "")]
    run = pt.parallel.sample_skeleton_sharded(sampler, n_or_T, x0, v0,
                                              mesh=pt.parallel.make_mesh(1), **kw)
    assert build.LAUNCHES["zigzag_chunk" + ("_horizon" if isinstance(n_or_T, float)
                                            else "")] > n0
    for f, a, b in zip(ref._fields, run.skeleton, ref):
        assert a.is_cuda and torch.equal(a, b), f
    assert run.stats["events"] == int(ref.n_valid.sum()) and len(run.transitions) == 1


HOST_FLOWS = {
    "bps_aniso": lambda d: pt.BPSAD(d, pt.potentials.anisotropic_gauss(np.linspace(0.5, 2, d)),
                                    refresh_rate=0.5),
    "boomerang": lambda d: pt.Boomerang(d, pt.potentials.grad_gauss, refresh_rate=0.5),
    "ecmc": lambda d: pt.ForwardECMCAD(d, pt.potentials.gauss),
    "suzz": lambda d: pt.SpeedUpZigZagAD(d, pt.potentials.gauss),
    "rhmc": lambda d: pt.RHMCAD(d, pt.potentials.gauss),
}


@pytest.mark.parametrize("name", list(HOST_FLOWS))
def test_host_skeleton_samples_on_the_cpu(dev, monkeypatch, name):
    """Every other sampler's host-accumulated skeleton (CPU tensors, from a
    run on the card) equals the device path's, and its samples come from
    the sampler's flow on the CPU: within rtol 1e-12 of the card's (f64;
    the card's sin, cos and sqrt differ by an ulp)."""
    d, B = 4, 32
    rs = np.random.default_rng(5)
    x0, v0 = rs.normal(size=(B, d)), rs.normal(size=(B, d))
    if name == "ecmc":
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    if name == "suzz":
        v0 = np.sign(v0)
    kw = dict(seed=2, dtype=torch.float64, device=dev, t_cap=256)
    ref = pt.sample_skeleton(HOST_FLOWS[name](d), 300, x0, v0, **kw)
    monkeypatch.setenv("PDMPFLUX_STREAM_HOST_ACC", "1")
    sampler = HOST_FLOWS[name](d)
    got = pt.sample_skeleton(sampler, 300, x0, v0, **kw)
    for f, a, b in zip(got._fields, got, ref):
        assert not a.is_cuda and torch.equal(a, b.cpu()), f
    xs = pt.sample_from_skeleton_batch(sampler, 64, got)
    mean, var = pt.pooled_moments(got, sampler, 64)
    assert not xs.is_cuda and not mean.is_cuda
    torch.testing.assert_close(xs, pt.sample_from_skeleton_batch(sampler, 64, ref).cpu(),
                               rtol=1e-12, atol=1e-12)
    for a, b in zip((mean, var), pt.pooled_moments(ref, sampler, 64)):
        torch.testing.assert_close(a, b.cpu(), rtol=1e-12, atol=1e-12)


def _mixture_means(d):
    mu = np.zeros((4, d))
    mu[:, :2] = 2.0 * np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]])
    return mu


def lse_target(name, dev):
    """(d, U) of the log-sum-exp targets at card-test size: the 4-component
    mixture (mu_k = (+-2, +-2, 0, ...)) as the broadcast ``x[None, :] - MU``
    and as ``MU @ x``, a 3-class softmax regression (``X`` 200 x 6) as
    ``log_softmax(X @ x.reshape(6, 3), 1)`` and ``X @ x.reshape(3, 6).T`` with
    ``logsumexp``, and ``|x|^2 / 2 + logsumexp(x)`` at d = 100 (a max over
    the coordinates: K6's block max across its four warps)."""
    if name == "lse_coords":
        return 100, lambda x: x @ x / 2 + torch.logsumexp(x, 0)
    if name.startswith("mix"):
        d = 30
        M = torch.as_tensor(_mixture_means(d), device=dev)
        half = (M * M).sum(1) / 2
        if name == "mix_broadcast":
            return d, lambda x: -torch.logsumexp(-((x[None, :] - M.to(x)) ** 2).sum(1) / 2, 0)
        return d, lambda x: x @ x / 2 - torch.logsumexp(M.to(x) @ x - half.to(x), 0)
    rs = np.random.default_rng(18)
    n, p, k = 200, 6, 3
    X = np.concatenate([np.ones((n, 1)), rs.normal(size=(n, p - 1))], 1)
    Y = np.eye(k)[rs.integers(0, k, n)]
    Xt, Yt = (torch.as_tensor(a, device=dev) for a in (X, Y))
    if name == "softmax_pk":
        return p * k, lambda x: (-(Yt.to(x) * torch.log_softmax(
            Xt.to(x) @ x.reshape(p, k), 1)).sum() + x @ x / 200)

    def U(x):
        Z = Xt.to(x) @ x.reshape(k, p).T
        return -(Yt.to(x) * Z).sum() + torch.logsumexp(Z, 1).sum() + x @ x / 200

    return p * k, U


LSE_KINDS = {"zigzag": pt.ZigZagAD, "sticky": None, "suzz": pt.SpeedUpZigZagAD,
             "bps": pt.BPSAD, "boomerang": pt.BoomerangAD, "ecmc": pt.ForwardECMCAD}


def _lse_matches_plain(dev, kind, target, horizon=False, B=128, targets=None, K=16):
    """Two chunks of ``K`` transitions of the kernel and its plain version
    from one f64 state on a log-sum-exp target (or one of ``targets(name,
    dev)``): K3/K5 and K4 bit for bit, K1 and K6 to rtol 1e-9, integers
    equal; in horizon mode a target at the median clock after the first
    chunk of a probe."""
    d, U = (targets or lse_target)(target, dev)
    if kind == "sticky":
        sampler = pt.StickyZigZagAD(d, U, np.ones(d))
    elif kind in ("bps", "boomerang"):
        sampler = LSE_KINDS[kind](d, U, refresh_rate=1.0)
    else:
        sampler = LSE_KINDS[kind](d, U)
    rs = np.random.default_rng(d + len(target))
    x0 = rs.normal(size=(B, d)) * (0.3 if kind == "sticky" else 1.0)
    if kind in ("zigzag", "sticky", "suzz"):
        v0 = rs.choice([-1.0, 1.0], size=(B, d))
    else:
        v0 = rs.normal(size=(B, d))
        if kind != "boomerang":
            v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    state = sampler.init_state_batch(x0, v0, 5, torch.float64, dev)
    cfg = driver.lowered_config(driver.chunk_config(sampler, K, 40, 128), sampler, d,
                                torch.float64, dev)
    if cfg.kappa is not None:
        cfg = cfg._replace(kappa=cfg.kappa.to(dev, torch.float64))
    counts = torch.zeros(B, dtype=torch.int32, device=dev)
    counts[::7] = 30
    scalar = kind in k3.KINDS
    run, plain = ((k3.run_chunk, k3.run_chunk_plain) if scalar
                  else (k1.run_chunk, k1.run_chunk_plain))
    sticky = kind == "sticky"
    if horizon:
        probe = driver.chunk_state(state, counts, sticky)
        plain(11, probe, k1.empty_fill(K, d, B, torch.float64, dev, sticky), 0, cfg)
        cfg = cfg._replace(t_target=k1.f32_target(float(torch.median(probe.fs[k1.F_T]))))
    st_k = driver.chunk_state(state, counts, sticky)
    st_p = k1.ChunkState(*(None if a is None else a.clone() for a in st_k))
    fills = [k1.empty_fill(2 * K, d, B, torch.float64, dev, sticky) for _ in range(2)]
    name = (k3.launch_name(kind) + ("_horizon" if horizon else "") if scalar
            else k1.launch_name(cfg))
    n0 = build.LAUNCHES[name]
    for it in range(2):
        run(11 + it * 1000003, st_k, fills[0], K * it, cfg)
        plain(11 + it * 1000003, st_p, fills[1], K * it, cfg)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == n0 + 2
    bitwise = scalar or kind == "suzz"
    for a, b in zip((*st_k, *fills[0]), (*st_p, *fills[1])):
        if a is None:
            continue
        if not a.is_floating_point() or bitwise:
            assert torch.equal(a, b)
        else:
            torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12, equal_nan=True)
    assert int((fills[0].kind[:, 0] > 0).sum()) > B
    return st_k, cfg


@pytest.mark.parametrize("kind", list(LSE_KINDS))
@pytest.mark.parametrize("target", ["mix_broadcast", "mix_matrix", "softmax_pk", "softmax_kp",
                                    "lse_coords"])
def test_log_sum_exp_targets_match_plain_f64(dev, kind, target):
    """The 4-component mixture in both forms, the softmax regression in both
    layouts and a log-sum-exp over the coordinates on every chunk kernel: K1
    and K6 (the mixture's broadcast form on their chain moments, a max stage
    and K6's block max on ``MU @ x`` and over the coordinates), K4 and K3/K5
    bit for bit."""
    _lse_matches_plain(dev, kind, target)


@pytest.mark.parametrize("kind", ["zigzag", "bps"])
def test_per_transition_route_in_horizon_mode_matches_plain_f64(dev, kind):
    """K1 and K3 in horizon mode (K7) on the softmax regression, whose K
    products of ``x.reshape(p, K)``'s columns they form once per transition:
    against the plain version fed the pair along the transition; a share of
    the lanes frozen at the target."""
    st, cfg = _lse_matches_plain(dev, kind, "softmax_pk", horizon=True)
    assert cfg.user.trans and cfg.per_transition is not None
    froze = (st.fs[k1.F_T] >= cfg.t_target).double().mean()
    assert 0.05 < float(froze) < 1.0


def scan_target(name, dev):
    """(d, U) of the running-sum and lattice targets at card-test size: the
    non-centred local level model at d = 100 (``sqrt(q) cumsum(z)``, q =
    1469.1 / 15099; a prefix and a suffix running sum of affine inputs), the
    Poisson walk at d = 100 (a suffix running sum of ``exp``) and the phi^4
    action of Albergo et al. on an 8 x 8 periodic lattice (``roll``)."""
    import math
    rs = np.random.default_rng(19)
    if name == "phi4_2d":
        def U(x):
            p = x.reshape(8, 8)
            a = -4.0 * p * p + 8.0 * p ** 4
            for mu in (0, 1):
                a = a + 2 * p * p - p * torch.roll(p, -1, mu) - p * torch.roll(p, 1, mu)
            return torch.sum(a)
        return 64, U
    d, s = 100, math.sqrt(1469.1 / 15099.0)
    if name == "local_level":
        y = torch.as_tensor(s * np.cumsum(rs.normal(size=d)) + rs.normal(size=d), device=dev)
        return d, lambda z: z @ z / 2 + torch.sum((y.to(z) - s * torch.cumsum(z, 0)) ** 2) / 2
    y = torch.as_tensor(rs.poisson(np.exp(math.log(5.0) + 0.05 * np.cumsum(
        rs.normal(size=d)))).astype(float), device=dev)

    def U(z):
        eta = math.log(5.0) + 0.05 * torch.cumsum(z, 0)
        return z @ z / 2 + torch.sum(torch.exp(eta) - y.to(z) * eta)

    return d, U


SCAN_TARGETS = ["local_level", "poisson_rw", "phi4_2d"]


@pytest.fixture(scope="module")
def scan_libraries():
    """Every f64 library of the scan tests, built at once (one nvcc each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels compile for sm_90a with nvcc)")
    from concurrent.futures import ThreadPoolExecutor

    lows = []
    for target in SCAN_TARGETS:
        d, U = scan_target(target, "cuda")
        for kind, make in LSE_KINDS.items():
            sampler = (pt.StickyZigZagAD(d, U, np.ones(d)) if kind == "sticky" else
                       make(d, U, refresh_rate=1.0) if kind in ("bps", "boomerang")
                       else make(d, U))
            lows.append(lower.lower_sampler(sampler, driver.kernel_kind(sampler), d,
                                            torch.float64, "cuda"))
    with ThreadPoolExecutor(len(lows)) as ex:
        list(ex.map(lambda low: low.library(), lows))


@pytest.mark.parametrize("kind", list(LSE_KINDS))
@pytest.mark.parametrize("target", SCAN_TARGETS)
def test_scan_targets_match_plain_f64(dev, scan_libraries, kind, target):
    """The local level model (two running sums: per transition on K1 and
    K3/K5, at every point on K6, by its block scan, and on K4), the Poisson
    walk (a running sum after ``exp``, at the point) and the phi^4 lattice
    (neighbours by ``roll``) on every chunk kernel: K4 and K3/K5 bit for
    bit, K1 and K6 to rtol 1e-9; K4, whose events are rarer, over two
    chunks of 64 transitions."""
    st, cfg = _lse_matches_plain(dev, kind, target, targets=scan_target,
                                 K=64 if kind == "suzz" else 16)
    low = cfg.user
    assert [pr.scan for _, pr in sorted(low.products.items())] == (
        [] if target == "phi4_2d" else ["prefix", "suffix"])


@pytest.mark.parametrize("kind", ["zigzag", "bps"])
def test_scan_per_transition_route_in_horizon_mode_matches_plain_f64(dev, scan_libraries,
                                                                   kind):
    """K1 and K3 in horizon mode (K7) on the local level model, whose two
    running sums they form once per transition (K1 in its group's lanes,
    K3 in the warp): against the plain version; a share of the lanes frozen
    at the target."""
    st, cfg = _lse_matches_plain(dev, kind, "local_level", horizon=True, targets=scan_target)
    assert len(cfg.user.trans) == 2 and cfg.per_transition is not None
    froze = (st.fs[k1.F_T] >= cfg.t_target).double().mean()
    assert 0.05 < float(froze) < 1.0


def test_k6_block_scan_needs_its_barrier(dev, monkeypatch):
    """K6's block scan (``lower._BLOCK_SCAN``) with odd warps delayed 20 us
    before they write their runs' totals: with the barrier between those
    writes and the reads of the warps before, K6 on the local level model at
    d = 100 (four warps) matches its plain version; without it, the reads
    find the last scan's totals and it does not."""
    orig = list(lower._BLOCK_SCAN)
    write = orig.index("    if (l == 31) {")
    control = orig[:write] + ["    if (wp & 1) __nanosleep(20000);"] + orig[write:]
    barrier = control.index("    __syncthreads();")
    mutant = control[:barrier] + control[barrier + 1:]
    for block, fails in ((control, False), (mutant, True)):
        monkeypatch.setattr(lower, "_BLOCK_SCAN", block)
        if fails:
            with pytest.raises(AssertionError):
                _lse_matches_plain(dev, "sticky", "local_level", targets=scan_target)
        else:
            _lse_matches_plain(dev, "sticky", "local_level", targets=scan_target)


def gather_target(name, dev):
    """(d, U) of the gather targets at card-test size, on the data
    ``chip_smoke.py`` draws: the ICAR prior of Morris et al. (``0.5
    sum((phi[node1] - phi[node2])^2)``, the soft sum-to-zero at sd ``0.001
    d``, unit-noise observations) on ``icar_graph(10)`` (d = 100: its edges
    cross K6's four warps), and the radon model of Gelman & Hill with free
    scales on ``radon_data(12, 120)`` (d = 16); ``icar_weak`` the same graph
    with the sum-to-zero at sd 10, whose flows between jumps (about 0.01, not
    1e-4) let a stale read move a flip."""
    from chip_smoke import icar_graph, radon_data

    if name.startswith("icar"):
        sd = 10.0 if name == "icar_weak" else 0.001 * 100
        edges, y = icar_graph(10)
        E, y = torch.as_tensor(edges, device=dev), torch.as_tensor(y, device=dev)

        def U(phi):
            Ed = E.to(phi.device)
            dphi = phi[Ed[:, 0]] - phi[Ed[:, 1]]
            return (0.5 * torch.sum(dphi ** 2) + 0.5 * (torch.sum(phi) / sd) ** 2
                    + 0.5 * torch.sum((y.to(phi) - phi) ** 2))
        return len(y), U
    J, n = 12, 120
    county, floor, y = (torch.as_tensor(a, device=dev) for a in radon_data(J, n))

    def U(x):
        a, mu, b, lsa, lsy = x[:J], x[J], x[J + 1], x[J + 2], x[J + 3]
        r = y.to(x) - a[county.to(x.device)] - b * floor.to(x)
        return (0.5 * torch.sum(r * r) * torch.exp(-2 * lsy) + n * lsy
                + 0.5 * torch.sum((a - mu) ** 2) * torch.exp(-2 * lsa) + J * lsa
                + (mu * mu + b * b) / 200 + 0.5 * (lsa * lsa + lsy * lsy))
    return J + 4, U


GATHER_TARGETS = ["icar", "radon"]


@pytest.fixture(scope="module")
def gather_libraries():
    """Every f64 library of the gather tests, built at once (one nvcc each)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels compile for sm_90a with nvcc)")
    from concurrent.futures import ThreadPoolExecutor

    lows = []
    for target in GATHER_TARGETS:
        d, U = gather_target(target, "cuda")
        for kind, make in LSE_KINDS.items():
            sampler = (pt.StickyZigZagAD(d, U, np.ones(d)) if kind == "sticky" else
                       make(d, U, refresh_rate=1.0) if kind in ("bps", "boomerang")
                       else make(d, U))
            lows.append(lower.lower_sampler(sampler, driver.kernel_kind(sampler), d,
                                            torch.float64, "cuda"))
    with ThreadPoolExecutor(len(lows)) as ex:
        list(ex.map(lambda low: low.library(), lows))


@pytest.mark.parametrize("kind", list(LSE_KINDS))
@pytest.mark.parametrize("target", GATHER_TARGETS)
def test_gather_targets_match_plain_f64(dev, gather_libraries, kind, target):
    """The ICAR prior (two scatter-adds walked at every coordinate; K1 and K6
    on the chain moments of its sum-to-zero) and the radon model (a gather
    of the intercepts, sums over the houses: a point potential) on every
    chunk kernel: K4 and K3/K5 bit for bit, K1 and K6 to rtol 1e-9."""
    st, cfg = _lse_matches_plain(dev, kind, target, targets=gather_target,
                                 K=64 if kind == "suzz" else 16)
    assert "// scatter-add rows" in cfg.user.header()


def test_k6_scatter_reads_need_their_barrier(dev, tmp_path, monkeypatch):
    """K6's barrier between the flow and round C's reads of other threads'
    coordinates (``reads_others`` without a point context), with odd warps
    delayed 20 us before they flow their coordinates: with the barrier K6
    on the ICAR at d = 100 (its segment walks read coordinates of all four
    warps; the sum-to-zero weak, so that a flow moves the coordinates by
    about 0.01) matches its plain version; without it, round C reads the
    odd warps' coordinates before their flow and it does not."""
    src = (build.CSRC / "sticky_chunk.cu").read_text()
    flow = "      for (int i = tid; i < d; i += nt) sx[i] = sx[i] + masked(sv, sact, i) * flow_t;\n"
    barrier = ("          // accessor (a point potential's fill took this barrier)\n"
               "          __syncthreads();\n")
    assert src.count(flow) == 1 and src.count(barrier) == 1
    control = src.replace(flow, "      if (warp & 1) __nanosleep(20000);\n" + flow)
    mutant = control.replace(barrier, barrier.replace("__syncthreads();", "(void)0;"))
    for name, text, fails in (("control", control, False), ("mutant", mutant, True)):
        folder = tmp_path / name
        folder.mkdir()
        for f in build.CSRC.iterdir():
            (folder / f.name).write_bytes(f.read_bytes())
        (folder / "sticky_chunk.cu").write_text(text)
        monkeypatch.setattr(build, "CSRC", folder)
        if fails:
            with pytest.raises(AssertionError):
                _lse_matches_plain(dev, "sticky", "icar_weak", targets=gather_target, B=256)
        else:
            st, cfg = _lse_matches_plain(dev, "sticky", "icar_weak", targets=gather_target,
                                         B=256)
            assert not cfg.user.point and "reads_others = true" in cfg.user.header()

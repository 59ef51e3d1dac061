"""The Speed-Up Zig-Zag of the port (K4, ``kind="suzz"``) against the JAX package.

* (a) K4's plain PyTorch version against the Pallas kernel with
  ``kind="suzz"`` in interpret mode, in both modes, from one JAX state carried
  over with ``pdmpflux_tpu_torch.convert`` and the same chunk seed.  B = 256
  with an RNG lane tile of 128; the event cap of 10 inside a 16-transition
  chunk freezes every seventh chain.  In horizon mode the float32 target is
  the median of the lanes' clocks after an event-count chunk.  float64:
  integer outputs equal, floats to ``rtol 1e-10, atol 1e-12`` (the plain
  version writes the envelope's tangent in closed form where JAX takes
  ``jax.jvp``, and adds in another order: rounding only); float32: event
  kinds equal on at least 99% of (transition, chain) pairs.
* (b) ``ops.flows.suzz_flow`` and its tangent against ``make_suzz_flow`` and
  ``jax.jvp`` of it, on ``(d, B)`` chains and on rows, at ``t = 0`` and at
  random ``t``: float64 to 1e-12.
* (c) the whole ``sample_skeleton`` against the JAX fused path: JAX's
  init states and stream fills of ``make_pallas_stream_runner(...,
  interpret=True)``, each fill's event rows appended to its chain in numpy
  (as ``tests/test_torch_scalar_slice.py`` and ``tests/test_torch_horizon.py``
  do), cut at ``n_sk`` rows in event-count mode and passed to
  ``engine.finalize_horizon_rows`` in time-horizon mode.  float64: every
  Skeleton field to 1e-10 and ``n_valid`` exactly; samples of both skeletons
  equal JAX's.
* (d) constructors and kernel selection, and (e) the law: pooled moments of
  N(0, I) on the plain path in the bands of ``tests/test_pallas.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core import engine  # noqa: E402
from pdmpflux_tpu.core.types import EV_INIT, Skeleton  # noqa: E402
from pdmpflux_tpu.ops.flows import make_suzz_flow  # noqa: E402
from pdmpflux_tpu.ops.pallas import driver as pdrv  # noqa: E402
from pdmpflux_tpu.ops.pallas import zigzag_chunk as zc  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.ops import flows as tflows  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402

B, K, TILE, CAP = 256, 16, 128, 10
NAMES = ("x", "v", "fs", "iscal", "ring", "ev_kind", "ev_x", "ev_v", "ev_fs", "ev_ring")


def _samplers(pot, d, grid=10, signed=True, **extra):
    kw = dict(grid_size=grid, signed_bound=signed, **extra)
    if pot == "gauss":
        return (pf.SpeedUpZigZag(d, lambda x: x, **kw),
                pt.SpeedUpZigZag(d, pt.potentials.grad_gauss, **kw))
    if pot == "banana":
        return (pf.SpeedUpZigZagAD(d, pf.utils.potentials.banana, **kw),
                pt.SpeedUpZigZagAD(d, pt.potentials.banana, **kw))
    # an untagged potential: the plain version differentiates it itself
    return (pf.SpeedUpZigZagAD(d, lambda x: jnp.sum(x * x) / 2, **kw),
            pt.SpeedUpZigZagAD(d, lambda x: torch.sum(x * x) / 2, **kw))


def _to_port(jst):
    fields = {f: np.asarray(getattr(jst, f)) for f in jst._fields if f != "key"}
    fields["key"] = np.asarray(jax.random.key_data(jst.key))
    return convert.state_from_numpy(fields, device="cpu")


def _run_both(pot, d, grid, signed, jdt, seed, horizon=False, **extra):
    """The interpreted Pallas ``kind="suzz"`` chunk and K4's plain version
    from one state (``extra`` goes to both samplers); returns both outputs
    and the float32 target (None in events mode)."""
    js, ts = _samplers(pot, d, grid, signed, **extra)
    assert (ts.device_potential is None) == (pot == "gauss_untagged")
    assert pdrv.kernel_kind(js) == tdrv.kernel_kind(ts) == "suzz"
    rs = np.random.default_rng(d + grid)
    x0 = rs.normal(size=(B, d))
    v0 = rs.choice([-1.0, 1.0], size=(B, d))
    st = js.init_state_batch(x0, v0, 11, dtype=jdt)
    counts0 = np.zeros(B, np.int32)
    counts0[::7] = CAP - 2  # some chains reach the cap inside the chunk
    cfg = tdrv.chunk_config(ts, K, CAP, TILE)
    t_target = None
    if horizon:  # a target inside the chunk: the median clock after it
        probe = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0))
        tzc.run_chunk(seed, probe, tzc.empty_fill(K, d, B, probe.x.dtype, "cpu"), 0, cfg)
        t_target = tzc.f32_target(float(torch.median(probe.fs[tzc.F_T])))

    # JAX: the Pallas kernel, interpreted
    n_grid = js.grid_size if js.grid_size >= 2 else pdrv.PALLAS_CONST_GRID
    gc, gcs = pdrv.convert_grad(js, d, TILE, jdt, "suzz")
    fc, fcs = pdrv.convert_flow(js, d, TILE, jdt)
    fs = jnp.stack([st.t, st.t_comp, st.ts, st.horizon, st.bound_h,
                    st.exp_rv, st.ar, st.tt]).astype(jdt)
    isc = jnp.stack([st.mode, st.rejected, st.errored_bound,
                     st.hitting_horizon, jnp.asarray(counts0)]).astype(jnp.int32)
    outs = zc.run_chunk(
        seed, st.x.T, st.v.T, fs, isc, st.error_value_ar.T.astype(jdt),
        grad_vec=gc, grad_consts=gcs, flow_vec=fc, flow_consts=fcs,
        n_grid=n_grid, K=K, adaptive=True, signed=signed, refresh_rate=0.0,
        cap=CAP, tile=TILE, interpret=True, kind="suzz",
        mode="horizon" if horizon else "events", t_target=t_target,
    )
    outs = [np.asarray(o) for o in outs]

    # port: K4's plain version through the wrapper (CPU tensors)
    tst = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0))
    fill = tzc.empty_fill(K, d, B, tst.x.dtype, "cpu")
    tzc.run_chunk(seed, tst, fill, 0, cfg._replace(t_target=t_target))
    mine = [a.numpy() for a in (*tst, *fill) if a is not None]
    return outs, mine, t_target


def _assert_f64_equal(outs, mine):
    for name, a, b in zip(NAMES, outs, mine):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12, err_msg=name)
    kinds, cnt = outs[5][:, 0], outs[3][tzc.I_CNT]
    assert (kinds == 2).sum() > B  # many events
    assert (cnt == CAP).any()  # some chains froze at the cap


@pytest.mark.parametrize("pot,d,grid,signed,seed,horizon", [
    ("gauss", 4, 10, True, 12345, False),
    ("banana", 10, 0, False, -777, False),
    ("gauss_untagged", 10, 10, False, 99, False),
    ("gauss", 4, 10, True, 12345, True),
    ("banana", 10, 0, False, -777, True),
])
def test_plain_k4_matches_pallas_f64(pot, d, grid, signed, seed, horizon):
    outs, mine, t_target = _run_both(pot, d, grid, signed, jnp.float64, seed, horizon)
    _assert_f64_equal(outs, mine)
    if horizon:  # the target freezes about half of the lanes
        froze = outs[2][tzc.F_T] >= np.float32(t_target)
        assert 0.3 < froze.mean() < 0.8, froze.mean()


@pytest.mark.parametrize("grid", [2, 33, 64])
@pytest.mark.parametrize("pot", ["gauss", "banana"])
def test_plain_k4_matches_pallas_f64_at_grid_edges(pot, grid):
    """The envelope's edges in K4's layout: one grid point per lane (2), and
    lanes owning two grid points with lane 31 handing its pairs across (33,
    64).  At two grid points the default horizon leaves the envelope so loose
    that a chunk sees no event, hence the shorter tmax."""
    extra = dict(tmax=0.1) if grid == 2 else {}
    outs, mine, _ = _run_both(pot, 10, grid, pot == "gauss", jnp.float64, 7 * grid, **extra)
    _assert_f64_equal(outs, mine)


@pytest.mark.parametrize("horizon", [False, True], ids=["events", "horizon"])
def test_plain_k4_matches_pallas_f32(horizon):
    outs, mine, _ = _run_both("banana", 10, 10, True, jnp.float32, 4242, horizon)
    assert mine[0].dtype == np.float32
    agree = np.mean(outs[5][:, 0] == mine[5][:, 0])
    assert agree >= 0.99, agree


def test_suzz_flow_matches_jax():
    """The flow in both layouts and its closed-form tangent against
    ``make_suzz_flow`` and ``jax.jvp`` through it, one chain at a time."""
    d, n = 7, 40
    rs = np.random.default_rng(3)
    x = rs.normal(size=(n, d)) * 2.0
    v = rs.choice([-1.0, 1.0], size=(n, d))
    jflow = make_suzz_flow(d)
    for t in (np.zeros(n), rs.uniform(-0.5, 1.5, size=n)):
        want = np.asarray(jax.vmap(jflow)(jnp.asarray(x), jnp.asarray(v), jnp.asarray(t))[0])
        tangent = np.asarray(jax.vmap(lambda a, b, s: jax.jvp(
            lambda u: jflow(a, b, u)[0], (s,), (jnp.ones_like(s),))[1])(
                jnp.asarray(x), jnp.asarray(v), jnp.asarray(t)))
        X, V, Tt = (torch.as_tensor(a) for a in (x, v, t))
        rows, v_rows = tflows.suzz_flow(X, V, Tt[:, None], dim_axis=-1)
        cols, phi = tflows.suzz_flow_tangent(X.T, V.T, Tt, dim_axis=0)
        np.testing.assert_allclose(rows.numpy(), want, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(v_rows.numpy(), v)
        np.testing.assert_allclose(cols.T.numpy(), want, rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose((phi * V.T).T.numpy(), tangent, rtol=1e-12, atol=1e-12)
    # t = 0 moves x only by rounding
    np.testing.assert_allclose(tflows.suzz_flow(X, V, 0.0)[0].numpy(), x, rtol=0, atol=1e-13)


def test_rates_and_tangents_match_jax_jvp():
    """The plain K4's grid rates and their closed-form tangents against
    ``jax.jvp`` of the Pallas kernel's rate map, on gauss and banana."""
    d, Bc, n_grid = 5, 16, 6
    rs = np.random.default_rng(5)
    x = rs.normal(size=(d, Bc))
    v = rs.choice([-1.0, 1.0], size=(d, Bc))
    step = rs.uniform(0.05, 0.3, size=Bc)
    for pot in ("gauss", "banana"):
        for signed in (True, False):
            js, ts = _samplers(pot, d, n_grid, signed)
            cfg = tdrv.chunk_config(ts, K, CAP, TILE)
            r, dr = tzc._grid_rates(cfg, torch.as_tensor(x), torch.as_tensor(v),
                                    torch.as_tensor(step), n_grid)

            def f(t, xc, vc):
                xt, vt = js.flow(xc, vc, t)
                rate = js._grad_eff(xt) * vt
                return rate if signed else jnp.maximum(rate, 0.0)

            t = jnp.asarray(step[None, :] * np.arange(n_grid)[:, None])   # (n_grid, B)
            want, dwant = jax.vmap(jax.vmap(lambda t_, a, b: jax.jvp(
                lambda u: f(u, a, b), (t_,), (jnp.ones_like(t_),)),
                in_axes=(0, 1, 1), out_axes=1), in_axes=(0, None, None))(
                    t, jnp.asarray(x), jnp.asarray(v))
            np.testing.assert_allclose(r.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(dr.numpy(), np.asarray(dwant), rtol=1e-11, atol=1e-12)


D, BS, N_SK, CHUNK, SEED = 4, 128, 48, 16, 5


def _initial(Bc=BS, seed=0):
    rs = np.random.default_rng(seed)
    return rs.normal(size=(Bc, D)), rs.choice([-1.0, 1.0], size=(Bc, D))


def _assert_equal(got, ref):
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        assert got[f].shape == a.shape and got[f].dtype == a.dtype, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[f], a, rtol=1e-10, atol=1e-10, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)


def test_sample_skeleton_matches_jax_fused_path():
    """Event count, with fills of 32 rows: straggler fills merge.  The JAX
    side is its init states and stream fills, each fill's event rows
    appended to its chain in numpy (JAX's own merge, even in its two steps
    jitted apart, zeroes rows of chain 0 at these shapes on XLA's CPU
    backend; ROADMAP Queue 3)."""
    js, ts = _samplers("gauss", D)
    x0, v0 = _initial()
    t_cap, target = 32, N_SK - 1
    st = js.init_state_batch(x0, v0, SEED, dtype=jnp.float64)
    init = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(st)
    run = jax.jit(pdrv.make_pallas_stream_runner(
        js, t_cap, target, chunk=CHUNK, tile=TILE, interpret=True))
    rows = {f: [[np.asarray(getattr(init, f))[b]] for b in range(BS)] for f in init._fields}
    counts, fills = jnp.zeros((BS,), jnp.int32), 0
    while not bool((np.asarray(counts) >= target).all()):
        res = run(st, engine.empty_stream(t_cap, D, jnp.float64, BS), counts)
        st, counts, fills = res.state, res.counts, fills + 1
        stream = {f: np.asarray(getattr(res.stream, f)) for f in init._fields}
        for b in range(BS):
            ev = stream["kind"][b] > 0
            for f in init._fields:
                rows[f][b].extend(stream[f][b][ev])
    ref = Skeleton(**{f: np.stack([np.stack(r[:N_SK]) for r in rows[f]])
                      for f in init._fields},
                   n_valid=1 + np.minimum(np.asarray(counts), target).astype(np.int32))
    assert fills > 1

    skel = pt.sample_skeleton(ts, N_SK, x0, v0, seed=SEED, dtype=torch.float64,
                              device="cpu", t_cap=t_cap, chunk=CHUNK, tile=TILE)
    got = convert.skeleton_to_numpy(skel)
    assert (got["n_valid"] == N_SK).all()
    _assert_equal(got, ref)
    np.testing.assert_array_equal(convert.state_to_numpy(ts.state)["key"],
                                  np.asarray(jax.random.key_data(st.key)))
    # samples of one chain's skeleton, along the speed-change flow
    one = pt.Skeleton(*(a[3] for a in skel))
    jone = Skeleton(**{f: jnp.asarray(getattr(ref, f)[3]) for f in ref._fields})
    for n_or_dt, kw in ((30, {}), (0.25, {}), (20, dict(dt=0.1))):
        np.testing.assert_allclose(
            pt.sample_from_skeleton(ts, n_or_dt, one, discard_vt=False, **kw).numpy(),
            np.asarray(pf.sample_from_skeleton(js, n_or_dt, jone, discard_vt=False, **kw)),
            rtol=1e-10, atol=1e-12)


def test_sample_skeleton_horizon_matches_jax_fused_path():
    """Time horizon T = 3 with fills of 8 rows: stragglers and a grown
    accumulator; then samples of the padded batch."""
    js, ts = _samplers("banana", D, signed=False)
    x0, v0 = _initial(seed=1)
    T, t_cap = 3.0, 8
    st = js.init_state_batch(x0, v0, SEED, dtype=jnp.float64)
    init = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(st)
    run = jax.jit(pdrv.make_pallas_stream_runner(
        js, t_cap, t_cap, chunk=8, tile=TILE, interpret=True, mode="horizon"))
    fields = [f for f in Skeleton._fields if f != "n_valid"]
    rows = {f: [[] for _ in range(BS)] for f in fields}
    total, W, fills = np.zeros(BS, np.int64), t_cap, 0
    while True:
        res = run(st, engine.empty_stream(t_cap, D, jnp.float64, BS),
                  jnp.zeros((BS,), jnp.int32), jnp.asarray(T, jnp.float64))
        st, fills = res.state, fills + 1
        counts = np.asarray(res.counts).astype(np.int64)
        if fills > 1 and (total + counts).max() > W:  # grow_rows, as JAX widens
            W += max(t_cap, int((total + counts).max()) - W)
        stream = {f: np.asarray(getattr(res.stream, f)) for f in fields}
        for b in range(BS):
            ev = stream["kind"][b] > 0
            for f in fields:
                rows[f][b].extend(stream[f][b][ev])
        total += counts
        if (np.asarray(st.t) >= T).all():
            break
    assert fills >= 2
    dense = {}
    for f in fields:
        proto = np.asarray(getattr(res.stream, f))
        a = np.zeros((BS, W) + proto.shape[2:], proto.dtype)
        for b in range(BS):
            if rows[f][b]:
                a[b, :len(rows[f][b])] = np.stack(rows[f][b])
        dense[f] = jnp.asarray(a)
    out_w = min(W + 2, -(-(2 + int(total.max())) // 256) * 256)
    ref = engine.finalize_horizon_rows(
        js.flow, Skeleton(**dense, n_valid=jnp.asarray(total, jnp.int32)), init,
        jnp.asarray(total, jnp.int32), T, out_width=out_w)

    skel = pt.sample_skeleton(ts, T, x0, v0, seed=SEED, dtype=torch.float64, device="cpu",
                              t_cap=t_cap, chunk=8, tile=TILE)
    got = convert.skeleton_to_numpy(skel)
    _assert_equal(got, ref)
    nv = got["n_valid"]
    assert (got["t"][np.arange(BS), nv - 1] == T).all()
    assert (got["kind"][np.arange(BS), nv - 1] == pt.EV_TERMINAL).all()
    np.testing.assert_allclose(
        pt.sample_from_skeleton_batch(ts, 25, skel, discard_vt=False).numpy(),
        np.asarray(pf.parallel.sample_from_skeleton_batch(js, 25, ref, discard_vt=False)),
        rtol=1e-10, atol=1e-12)


def test_constructors_and_kind_selection():
    g = pt.potentials.grad_gauss
    for js, ts in ((pf.SpeedUpZigZag(3, lambda x: x), pt.SpeedUpZigZag(3, g)),
                   (pf.SpeedUpZigZagAD(3, pf.utils.potentials.gauss),
                    pt.SpeedUpZigZagAD(3, pt.potentials.gauss)),
                   (pf.SpeedUpZigZag(3, lambda x: x, grid_size=0, tmax=0.0),
                    pt.SpeedUpZigZag(3, g, grid_size=0, tmax=0.0))):
        for k in ("grid_size", "tmax", "refresh_rate", "vectorized_bound", "signed_bound",
                  "adaptive"):
            assert getattr(ts, k) == getattr(js, k), k
        assert tdrv.kernel_kind(ts) == pdrv.kernel_kind(js) == "suzz"
    assert isinstance(pt.SpeedUpZigZag(3, g), pt.ZigZag)
    assert pt.SpeedUpZigZagAD(3, pt.potentials.gauss).device_potential == "gauss"
    assert pt.SpeedUpZigZagAD(3, pt.potentials.banana).device_potential == "banana"
    assert pt.SpeedUpZigZagAD(3, lambda x: torch.sum(x * x) / 2).device_potential is None
    with pytest.warns(UserWarning, match="switching to unsigned bound"):
        scalar = pt.SpeedUpZigZag(3, g, vectorized_bound=False)
    assert tdrv.kernel_kind(scalar) is None
    assert pdrv.kernel_kind(pf.SpeedUpZigZag(3, lambda x: x, vectorized_bound=False)) is None
    with pytest.raises(ValueError, match="SpeedUpZigZag with vectorized_bound=True"):
        tdrv.chunk_config(scalar, 32, 10, 128)
    # no kernel covers scalar bounds: the transition engine runs them
    from pdmpflux_tpu_torch.core import engine

    engine.reset_counts()
    skel = pt.sample_skeleton(scalar, 10, np.zeros(3), np.ones(3), device="cpu")
    assert engine.COUNTS["transitions"] > 0 and int(skel.n_valid) == 10
    # the effective gradient of one chain equals JAX's
    x = np.array([0.3, -1.2, 2.0])
    js = pf.SpeedUpZigZagAD(3, pf.utils.potentials.banana)
    ts = pt.SpeedUpZigZagAD(3, pt.potentials.banana)
    np.testing.assert_allclose(ts._grad_eff(torch.as_tensor(x)).numpy(),
                               np.asarray(js._grad_eff(jnp.asarray(x))), rtol=1e-13)


def test_gaussian_moments():
    d, Bc = 4, 64
    sampler = pt.SpeedUpZigZagAD(d, pt.potentials.gauss)
    skel = pt.sample_skeleton(sampler, 600, np.zeros((Bc, d)), np.ones((Bc, d)), seed=6,
                              dtype=torch.float64, device="cpu")
    assert (skel.n_valid == 600).all() and (torch.diff(skel.t, dim=1) > 0).all()
    mean, var = pt.pooled_moments(skel, sampler, 300)
    assert (mean.abs() < 0.25).all(), mean
    assert ((var - 1).abs() < 0.35).all(), var
    xs = pt.sample(sampler, 100, 20, np.zeros((8, d)), np.ones((8, d)), seed=3,
                   dtype=torch.float64, device="cpu")
    assert xs.shape == (8, 20, d) and bool(torch.isfinite(xs).all())

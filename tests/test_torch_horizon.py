"""Time-horizon sampling of the port (K7, ``mode="horizon"``) against the JAX
package.

* (a) the plain chunk versions in horizon mode (K1, K6, K3/K5) against the
  Pallas kernel's ``mode="horizon"`` in interpret mode, in every kind, from
  one JAX state carried over with ``pdmpflux_tpu_torch.convert``.  The target
  is the median of the lanes' end clocks after an event-count chunk, so that
  about half of the lanes freeze inside the chunk; every seventh lane also
  reaches its event cap.  float64: integer outputs and the activity mask
  equal; floats to ``rtol 1e-10, atol 1e-12`` (rounding order only).
* (b) the whole time-horizon ``sample_skeleton`` against the JAX fused
  composition (``api.py:1085-1242``): per fill
  ``make_pallas_stream_runner(..., mode="horizon", interpret=True)``, each
  fill's event rows appended to its chain in numpy (JAX's own merge zeroes
  rows on XLA's CPU backend, see ``tests/test_torch_scalar_slice.py``) into an
  accumulator widened as the JAX driver widens it (``api.py:1175-1188``),
  then ``engine.finalize_horizon_rows``.  float64: every Skeleton field to
  1e-10, widths and ``n_valid`` exactly, and the carried state.  Fills of 8
  rows make stragglers; ``T = 3.0`` is a float32, ``T = 0.7`` rounds down to
  one (``t_target`` is float32 in both packages); ``T = 0`` and a single
  chain (RNG lane tile 1, as the Pallas kernel needs B to be a multiple of
  it) too.
* (c) samples of horizon skeletons, a padded batch and a single chain,
  equal JAX's.
* (d) the law on the plain path: Zig-Zag N(0, I) pooled moments in bench.py's
  bands.
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
from pdmpflux_tpu.ops.pallas import driver as pdrv  # noqa: E402
from pdmpflux_tpu.ops.pallas import zigzag_chunk as zc  # noqa: E402
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402

B, K, TILE, CAP, SEED = 128, 16, 128, 10, 9
KAPPA = 2.0


def _pair(name, d, signed=True):
    """The same sampler in both packages."""
    kw = dict(signed_bound=signed)
    scales = np.linspace(0.5, 3.0, d)
    if name == "zigzag":
        return pf.ZigZag(d, lambda x: x, **kw), pt.ZigZag(d, pt.potentials.grad_gauss, **kw)
    if name == "zigzag_banana":
        return (pf.ZigZagAD(d, pf.utils.potentials.banana, **kw),
                pt.ZigZagAD(d, pt.potentials.banana, **kw))
    if name == "sticky":
        kappa = np.full(d, KAPPA)
        return (pf.StickyZigZag(d, lambda x: x, kappa, **kw),
                pt.StickyZigZag(d, pt.potentials.grad_gauss, kappa, **kw))
    if name == "bps":
        return (pf.BPSAD(d, pf.utils.potentials.anisotropic_gauss(scales), refresh_rate=0.5, **kw),
                pt.BPSAD(d, pt.potentials.anisotropic_gauss(scales), refresh_rate=0.5, **kw))
    if name == "boomerang":
        return (pf.BoomerangAD(d, pf.utils.potentials.banana, refresh_rate=0.5, tmax=1.0, **kw),
                pt.BoomerangAD(d, pt.potentials.banana, refresh_rate=0.5, tmax=1.0, **kw))
    return (pf.ForwardECMCAD(d, pf.utils.potentials.gauss, **kw),
            pt.ForwardECMCAD(d, pt.potentials.gauss, **kw))


def _initial(name, Bc, d, seed):
    """Positions N(0, I) (near the axes for the sticky sampler); velocities
    +-1 for the Zig-Zag family, unit for BPS and ECMC, N(0, I) for the
    Boomerang."""
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(Bc, d)) * (0.3 if name == "sticky" else 1.0)
    if name.startswith(("zigzag", "sticky")):
        return x0, rs.choice([-1.0, 1.0], size=(Bc, d))
    v0 = rs.normal(size=(Bc, d))
    if name != "boomerang":
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, v0


def _to_port(jst):
    fields = {f: np.asarray(getattr(jst, f)) for f in jst._fields if f != "key"}
    fields["key"] = np.asarray(jax.random.key_data(jst.key))
    return convert.state_from_numpy(fields, device="cpu")


@pytest.mark.parametrize("name,d,signed,seed", [
    ("zigzag", 4, True, 12345),
    ("zigzag_banana", 6, False, -777),
    ("sticky", 4, True, 2**31 - 5),
    ("bps", 4, False, 4321),
    ("boomerang", 4, True, 99),
    ("ecmc", 6, False, 2024),
])
def test_plain_k7_matches_pallas_f64(name, d, signed, seed):
    js, ts = _pair(name, d, signed)
    kind, sticky = pdrv.kernel_kind(js), name == "sticky"
    assert tdrv.kernel_kind(ts) == kind
    x0, v0 = _initial(name, B, d, d)
    st = js.init_state_batch(x0, v0, 11, dtype=jnp.float64)
    counts0 = np.zeros(B, np.int32)
    counts0[::7] = CAP - 2
    cfg = tdrv.chunk_config(ts, K, CAP, TILE)
    run_chunk = tzc.run_chunk if kind == "zigzag" else tsc.run_chunk

    # a target inside the chunk: the median clock after an event-count chunk
    probe = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0), sticky)
    run_chunk(seed, probe, tzc.empty_fill(K, d, B, torch.float64, "cpu", sticky), 0, cfg)
    t_target = float(torch.median(probe.fs[tzc.F_T]))

    # JAX: the Pallas kernel in horizon mode, interpreted
    gc, gcs = pdrv.convert_grad(js, d, TILE, jnp.float64, kind)
    fc, fcs = pdrv.convert_flow(js, d, TILE, jnp.float64)
    fs = jnp.stack([st.t, st.t_comp, st.ts, st.horizon, st.bound_h, st.exp_rv, st.ar,
                    st.tt]).astype(jnp.float64)
    isc = jnp.stack([st.mode, st.rejected, st.errored_bound, st.hitting_horizon,
                     jnp.asarray(counts0)]).astype(jnp.int32)
    n_grid = js.grid_size if js.grid_size >= 2 else pdrv.PALLAS_CONST_GRID
    outs = zc.run_chunk(
        seed, st.x.T, st.v.T, fs, isc, st.error_value_ar.T,
        grad_vec=gc, grad_consts=gcs, flow_vec=fc, flow_consts=fcs, n_grid=n_grid, K=K,
        adaptive=True, signed=signed, refresh_rate=float(js.refresh_rate), cap=CAP,
        tile=TILE, interpret=True, kind=kind,
        gaussian_velocity=pdrv._kernel_gaussian_velocity(js, kind),
        ecmc_params=pdrv._ecmc_params(js, kind), sticky=sticky,
        act=st.is_active.T.astype(jnp.float64) if sticky else None,
        kappa=jnp.full((d,), KAPPA) if sticky else None,
        mode="horizon", t_target=t_target)
    ref = [np.asarray(o) for o in outs]

    # port: the plain version in horizon mode, through the wrapper
    tst = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0), sticky)
    fill = tzc.empty_fill(K, d, B, torch.float64, "cpu", sticky)
    run_chunk(seed, tst, fill, 0, cfg._replace(t_target=tzc.f32_target(t_target)))
    mine = [a.numpy() for a in (*tst, *fill) if a is not None]

    assert len(ref) == len(mine)
    for i, (a, b) in enumerate(zip(ref, mine)):
        if b.dtype == np.bool_:  # JAX keeps the activity 0/1 in the state dtype
            np.testing.assert_array_equal(a > 0, b, err_msg=str(i))
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12, err_msg=str(i))
    t_end, cnt = ref[2][tzc.F_T], ref[3][tzc.I_CNT]
    froze = t_end >= np.float32(t_target)
    assert 0.3 < froze.mean() < 0.8, froze.mean()  # the target freezes about half
    ev_kind = ref[len(ref) // 2][:, 0]
    assert (cnt == CAP).any() and (ev_kind > 0).sum() > B


def _jax_horizon(js, x0, v0, T, t_cap, chunk, squeeze=False, tile=TILE):
    """JAX's time-horizon skeleton, composed as its on-device stream path
    composes it, and its carried state and number of fills."""
    Bc, d = x0.shape
    st = js.init_state_batch(x0, v0, SEED, dtype=jnp.float64)
    init = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(st)
    run = jax.jit(pdrv.make_pallas_stream_runner(
        js, t_cap, t_cap, chunk=chunk, tile=tile, interpret=True, mode="horizon"))
    fields = [f for f in Skeleton._fields if f != "n_valid"]
    rows = {f: [[] for _ in range(Bc)] for f in fields}
    total, W, fills, proto = np.zeros(Bc, np.int64), t_cap, 0, None
    while True:
        res = run(st, engine.empty_stream(t_cap, d, jnp.float64, Bc),
                  jnp.zeros((Bc,), jnp.int32), jnp.asarray(T, jnp.float64))
        st, fills = res.state, fills + 1
        counts = np.asarray(res.counts).astype(np.int64)
        if fills > 1 and (total + counts).max() > W:  # grow_rows, as JAX widens
            W += max(t_cap, int((total + counts).max()) - W)
        stream = {f: np.asarray(getattr(res.stream, f)) for f in fields}
        proto = proto or {f: stream[f] for f in fields}
        for b in range(Bc):
            ev = stream["kind"][b] > 0
            for f in fields:
                rows[f][b].extend(stream[f][b][ev])
        total += counts
        if (np.asarray(st.t) >= T).all():
            break
        assert int(res.transitions) > 0
    dense = {}
    for f in fields:
        a = np.zeros((Bc, W) + proto[f].shape[2:], proto[f].dtype)
        for b in range(Bc):
            if rows[f][b]:
                a[b, :len(rows[f][b])] = np.stack(rows[f][b])
        dense[f] = jnp.asarray(a)
    acc = Skeleton(**dense, n_valid=jnp.asarray(total, jnp.int32))
    out_w = None if squeeze else min(W + 2, -(-(2 + max(1, int(total.max()))) // 256) * 256)
    skel = engine.finalize_horizon_rows(js.flow, acc, init, jnp.asarray(total, jnp.int32),
                                        T, out_width=out_w)
    ref = {f: np.asarray(getattr(skel, f)) for f in Skeleton._fields}
    if squeeze:  # the exact trim of a single chain (api.py:1074-1083)
        n0 = int(ref["n_valid"][0])
        ref = {f: a[0, :n0] for f, a in ref.items() if f != "n_valid"}
        ref["n_valid"] = np.asarray(n0, np.int32)
    return ref, st, fills


def _assert_skeletons_equal(got, ref):
    for f, a in ref.items():
        assert got[f].shape == a.shape and got[f].dtype == a.dtype, (f, got[f].shape, a.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[f], a, rtol=1e-10, atol=1e-10, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)


def _horizon_contracts(skel, T):
    """Every chain ends at exactly T with a terminal row; no kept row past T;
    t non-decreasing over the valid rows; zeros past n_valid."""
    t, kind, nv = skel["t"], skel["kind"], skel["n_valid"]
    for b in range(t.shape[0]):
        n = int(nv[b])
        assert t[b, n - 1] == T and kind[b, n - 1] == pt.EV_TERMINAL
        assert (np.diff(t[b, :n]) >= 0).all() and (t[b, :n] <= T).all()
        assert (t[b, n:] == 0).all() and (kind[b, n:] == 0).all()


CASES = [("zigzag", 3.0), ("zigzag", 0.7), ("sticky", 3.0), ("bps", 3.0), ("boomerang", 3.0),
         ("ecmc", 10.0)]  # ECMC's events come slower: a longer horizon makes stragglers
D, T_CAP, CHUNK = 4, 8, 8


@pytest.fixture(scope="module")
def jax_cases():
    """A case's samplers, initial values and JAX result, computed once per
    module (the samples test reuses the Zig-Zag one)."""
    cases = {}

    def get(name, T):
        if (name, T) not in cases:
            js, ts = _pair(name, D)
            x0, v0 = _initial(name, B, D, 3)
            cases[name, T] = (js, ts, x0, v0, *_jax_horizon(js, x0, v0, T, T_CAP, CHUNK))
        return cases[name, T]

    return get


def _port(ts, T, x0, v0, tile=TILE):
    return pt.sample_skeleton(ts, T, x0, v0, seed=SEED, dtype=torch.float64, device="cpu",
                              t_cap=T_CAP, chunk=CHUNK, tile=tile)


@pytest.mark.parametrize("name,T", CASES)
def test_sample_skeleton_horizon_matches_jax_fused_path(jax_cases, name, T):
    js, ts, x0, v0, ref, ref_state, fills = jax_cases(name, T)
    if T > 1:
        assert fills >= 2  # straggler fills merged, the accumulator grown

    skel = _port(ts, T, x0, v0)
    got = convert.skeleton_to_numpy(skel)
    _assert_skeletons_equal(got, ref)
    _horizon_contracts(got, T)
    if name == "sticky":  # frozen coordinates stay at exactly 0.0 at the terminal row
        last = got["n_valid"] - 1
        term_x = got["x"][np.arange(B), last]
        frozen = ~got["is_active"][np.arange(B), last]
        assert frozen.any() and (term_x[frozen] == 0.0).all()
    st = convert.state_to_numpy(ts.state)
    np.testing.assert_array_equal(st["key"], np.asarray(jax.random.key_data(ref_state.key)))
    for f in ("x", "v", "t"):
        np.testing.assert_allclose(st[f], np.asarray(getattr(ref_state, f)), rtol=1e-10,
                                   atol=1e-10, err_msg=f)
    # a clock at or past float32(T) but short of T would have stopped the run
    assert (st["t"] >= T).all()


def test_single_chain_and_samples_match_jax(jax_cases):
    """A single chain is trimmed exactly and ends at t == T with a terminal
    row; samples of a padded horizon batch (chains with different n_valid)
    and of the single chain equal JAX's."""
    T = 3.0
    js, ts, x0, v0, batch_ref, _, _ = jax_cases("zigzag", T)
    ref, _, _ = _jax_horizon(js, x0[:1], v0[:1], T, T_CAP, CHUNK, squeeze=True, tile=1)
    one = _port(ts, T, x0[0], v0[0], tile=1)
    got = convert.skeleton_to_numpy(one)
    _assert_skeletons_equal(got, ref)
    assert got["t"].shape == (int(got["n_valid"]),) and got["t"][-1] == T
    assert got["kind"][-1] == pt.EV_TERMINAL and got["kind"][0] == pt.EV_INIT
    jref = Skeleton(**{f: jnp.asarray(a) for f, a in ref.items()})
    np.testing.assert_allclose(pt.sample_from_skeleton(ts, 40, one).numpy(),
                               np.asarray(pf.sample_from_skeleton(js, 40, jref)), rtol=1e-10,
                               atol=1e-12)

    assert len(set(batch_ref["n_valid"].tolist())) > 3
    batch = _port(ts, T, x0, v0)
    jbatch = Skeleton(**{f: jnp.asarray(a) for f, a in batch_ref.items()})
    got = pt.sample_from_skeleton_batch(ts, 30, batch, discard_vt=False).numpy()
    want = np.asarray(pf.parallel.sample_from_skeleton_batch(js, 30, jbatch, discard_vt=False))
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("n_or_T", [40, 3.0])
def test_single_chain_keeps_the_callers_arrays(n_or_T):
    """One chain's state in the kernel layout is a copy: the kernels update
    it in place, and neither the caller's arrays nor the initial record may
    change (both modes)."""
    x0, v0 = np.array([0.5, -1.0, 2.0]), np.array([1.0, -1.0, 1.0])
    keep = x0.copy(), v0.copy()
    skel = pt.sample_skeleton(pt.ZigZag(3, pt.potentials.grad_gauss), n_or_T, x0, v0,
                              seed=1, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(x0, keep[0])
    np.testing.assert_array_equal(v0, keep[1])
    np.testing.assert_array_equal(skel.x[0].numpy(), keep[0])
    np.testing.assert_array_equal(skel.v[0].numpy(), keep[1])


def test_zero_horizon_is_the_initial_record():
    js, ts = _pair("zigzag", 4)
    x0, v0 = _initial("zigzag", 8, 4, 7)
    for xs, vs in ((x0, v0), (x0[0], v0[0])):
        ref = pf.sample_skeleton(js, 0.0, xs, vs, seed=SEED, dtype=jnp.float64)
        got = convert.skeleton_to_numpy(pt.sample_skeleton(
            ts, 0.0, xs, vs, seed=SEED, dtype=torch.float64, device="cpu"))
        _assert_skeletons_equal(got, {f: np.asarray(getattr(ref, f)) for f in ref._fields})
        assert (got["kind"][..., 0] == pt.EV_INIT).all() and (got["n_valid"] == 1).all()
        np.testing.assert_array_equal(convert.state_to_numpy(ts.state)["key"],
                                      np.asarray(jax.random.key_data(js.state.key)))


def test_clock_short_of_a_target_float32_rounds_down():
    """The kernels freeze a lane at float32(T): a float64 clock in
    [float32(0.7), 0.7) runs no transition, and the next fill makes no
    progress (JAX's text).  Such a clock is a measure-zero event in a run."""
    sampler = pt.ZigZag(3, pt.potentials.grad_gauss)
    t32 = tzc.f32_target(0.7)
    assert t32 < 0.7
    init = sampler.init_state_batch

    def stuck(*a, **kw):
        return init(*a, **kw)._replace(t=torch.full((2,), t32, dtype=torch.float64))

    sampler.init_state_batch = stuck
    with pytest.raises(RuntimeError, match="time-horizon sampling made no progress"):
        pt.sample_skeleton(sampler, 0.7, np.zeros((2, 3)), np.ones((2, 3)),
                           dtype=torch.float64, device="cpu")


@pytest.mark.parametrize("name", ["zigzag", "sticky", "bps", "boomerang", "ecmc"])
def test_flows_take_rows_and_times(name):
    """Each ported sampler's flow, as finalize calls it on ``(B, d)`` rows and
    ``(B, 1)`` times, equals JAX's per-chain flow (linear, or elliptic for
    the Boomerang)."""
    js, ts = _pair(name, 5)
    rs = np.random.default_rng(0)
    x, v, t = rs.normal(size=(6, 5)), rs.normal(size=(6, 5)), rs.uniform(0, 3, size=6)
    want = jax.vmap(js.flow)(jnp.asarray(x), jnp.asarray(v), jnp.asarray(t))
    got = ts.flow(torch.as_tensor(x), torch.as_tensor(v), torch.as_tensor(t)[:, None])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-14, atol=1e-14)


def test_horizon_memory_budget_raises(monkeypatch):
    """A budget below one fill no longer raises: the time-horizon run takes
    host accumulation (JAX ``host_loop`` and ``_assemble_horizon``) and
    equals the on-device run bit for bit up to each chain's ``n_valid``;
    its width is the longest chain's, and every chain ends at t == T."""
    sampler = pt.ZigZag(3, pt.potentials.grad_gauss)
    rs = np.random.default_rng(3)
    x0, v0 = rs.normal(size=(8, 3)), rs.choice([-1.0, 1.0], size=(8, 3))
    kw = dict(seed=2, dtype=torch.float64, device="cpu", init_capacity=64)
    dev = pt.sample_skeleton(sampler, 100.0, x0, v0, **kw)
    monkeypatch.setenv("PDMPFLUX_DEVICE_BYTES", "100000")
    tapi.HOST_ACC.clear()
    host = pt.sample_skeleton(sampler, 100.0, x0, v0, **kw)
    assert tapi.HOST_ACC["fills"] > 1  # straggler fills of 64 rows
    nv = host.n_valid
    assert torch.equal(nv, dev.n_valid) and host.t.shape[1] == int(nv.max()) < dev.t.shape[1]
    for f, a, b in zip(host._fields, host, dev):
        if f != "n_valid":
            assert torch.equal(a, b[:, :a.shape[1]]), f
    last = nv.long() - 1
    rows = torch.arange(8)
    assert (host.t[rows, last] == 100.0).all() and (host.kind[rows, last] == pt.EV_TERMINAL).all()


def test_zigzag_horizon_moments():
    d, Bc = 5, 64
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    skel = pt.sample_skeleton(sampler, 150.0, np.zeros((Bc, d)), np.ones((Bc, d)), seed=1,
                              dtype=torch.float64, device="cpu", init_capacity=256)
    _horizon_contracts(convert.skeleton_to_numpy(skel), 150.0)
    mean, var = pt.pooled_moments(skel, sampler, 200)
    assert (mean.abs() < 0.2).all() and ((var - 1).abs() < 0.3).all(), (mean, var)

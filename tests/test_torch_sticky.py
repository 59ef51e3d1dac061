"""The Sticky Zig-Zag path of the port against the JAX package.

* (a) K6's plain PyTorch version against the Pallas kernel with
  ``sticky=True`` in interpret mode, from one JAX state carried over with
  ``pdmpflux_tpu_torch.convert``, over two chained chunks (sticks happen in
  the first, thaws of those coordinates follow).  float64: integer outputs
  and the activity mask equal; floats to ``rtol 1e-10, atol 1e-12`` (the two
  sides differ only by summation order: torch sums and a sequential cumsum
  against Mosaic's log-shift prefix sums).
* (b) the whole ``sample_skeleton`` against the JAX fused-kernel composition
  of ``tests/test_torch_slice.py`` with a sticky sampler: every Skeleton
  field, ``is_active`` included, to 1e-10, ``n_valid`` exactly, and the
  carried state (key, x, ``is_active``).
* (c) constructors: ``kappa`` validation texts and initial states equal the
  JAX package's.
* (d) the law on the plain path: the pooled frozen fraction of equal-time
  samples of N(0, I) is p(0) / (kappa + p(0)) (``tests/test_sticky.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core import engine  # noqa: E402
from pdmpflux_tpu.core.types import EV_INIT  # noqa: E402
from pdmpflux_tpu.ops.pallas import driver as pdrv  # noqa: E402
from pdmpflux_tpu.ops.pallas import zigzag_chunk as zc  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402
from test_torch_slice import _jax_merge  # noqa: E402

K, TILE, CAP = 16, 128, 40

NAMES = ("x", "v", "fs", "iscal", "ring", "act", "ev_kind", "ev_x", "ev_v",
         "ev_fs", "ev_ring", "ev_act")


def _samplers(pot, d, kappa, signed, grid=10):
    kw = dict(signed_bound=signed, grid_size=grid)
    if pot == "gauss":
        return (pf.StickyZigZag(d, lambda x: x, kappa, **kw),
                pt.StickyZigZag(d, pt.potentials.grad_gauss, kappa, **kw))
    return (pf.StickyZigZagAD(d, pf.utils.potentials.banana, kappa, **kw),
            pt.StickyZigZagAD(d, pt.potentials.banana, kappa, **kw))


def _run_both(pot, d, B, kappa, signed, x_scale, seed, grid=10):
    js, ts = _samplers(pot, d, kappa, signed, grid)
    assert ts.device_potential == pot
    rs = np.random.default_rng(d + B)
    x0 = rs.normal(size=(B, d)) * x_scale  # near the axes: sticks come early
    v0 = rs.choice([-1.0, 1.0], size=(B, d))
    st = js.init_state_batch(x0, v0, 11, dtype=jnp.float64)
    fields = {f: np.asarray(getattr(st, f)) for f in st._fields if f != "key"}
    fields["key"] = np.asarray(jax.random.key_data(st.key))
    tstate = convert.state_from_numpy(fields, device="cpu")
    counts0 = np.zeros(B, np.int32)
    counts0[::7] = CAP - 3  # some chains reach the cap inside the run

    # JAX: the Pallas kernel, interpreted, two chunks
    gc, gcs = pdrv.convert_grad(js, d, TILE, jnp.float64)
    fc, fcs = pdrv.convert_flow(js, d, TILE, jnp.float64)
    carry = (st.x.T, st.v.T,
             jnp.stack([st.t, st.t_comp, st.ts, st.horizon, st.bound_h,
                        st.exp_rv, st.ar, st.tt]).astype(jnp.float64),
             jnp.stack([st.mode, st.rejected, st.errored_bound,
                        st.hitting_horizon, jnp.asarray(counts0)]).astype(jnp.int32),
             st.error_value_ar.T, st.is_active.T.astype(jnp.float64))
    rows = []
    for it in range(2):
        x, v, fs, isc, ring, act = carry
        outs = zc.run_chunk(
            seed + it * 1000003, x, v, fs, isc, ring,
            grad_vec=gc, grad_consts=gcs, flow_vec=fc, flow_consts=fcs,
            n_grid=js.grid_size, K=K, adaptive=True, signed=signed,
            refresh_rate=0.0, cap=CAP, tile=TILE, interpret=True,
            sticky=True, act=act, kappa=jnp.asarray(kappa),
        )
        carry = outs[:6]
        rows.append([np.asarray(o) for o in outs[6:]])
    ref = [np.asarray(a) for a in carry]
    ref += [np.concatenate([r[i] for r in rows]) for i in range(6)]

    # port: the plain version through the wrapper (CPU tensors)
    tst = tdrv.chunk_state(tstate, torch.as_tensor(counts0), sticky=True)
    fill = tzc.empty_fill(2 * K, d, B, torch.float64, "cpu", sticky=True)
    cfg = tdrv.chunk_config(ts, K, CAP, TILE)
    for it in range(2):
        tzc.run_chunk(seed + it * 1000003, tst, fill, it * K, cfg)
    mine = [a.numpy() for a in (*tst, *fill)]
    return ref, mine


@pytest.mark.parametrize("pot,d,B,kappa,signed,x_scale,seed", [
    ("gauss", 4, 256, 5.0, True, 0.05, 12345),
    ("banana", 6, 128, 2.0, False, 0.1, -777),
    ("gauss", 130, 128, 1.0, True, 0.02, 2**31 - 5),
])
def test_plain_k6_matches_pallas_f64(pot, d, B, kappa, signed, x_scale, seed):
    ref, mine = _run_both(pot, d, B, np.full(d, kappa), signed, x_scale, seed)
    _assert_f64_equal(ref, mine)


@pytest.mark.parametrize("pot,grid,signed", [("gauss", 2, True), ("banana", 33, False),
                                             ("gauss", 64, False)])
def test_plain_k6_matches_pallas_f64_at_grid_edges(pot, grid, signed):
    """The envelope's edges: a single segment (2), and more segments than a
    warp has lanes (33, 64), whose totals the kernel reduces one by one."""
    ref, mine = _run_both(pot, 6, 128, np.full(6, 2.0), signed, 0.1, 11 * grid, grid)
    _assert_f64_equal(ref, mine)


def _assert_f64_equal(ref, mine):
    for name, a, b in zip(NAMES, ref, mine):
        if name in ("act", "ev_act"):  # JAX keeps 0/1 in the state dtype
            assert b.dtype == np.bool_ and a.shape == b.shape, name
            np.testing.assert_array_equal(a > 0, b, err_msg=name)
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12, err_msg=name)
    kinds = ref[6][:, 0]
    assert (kinds == pt.EV_STICK).sum() > 0 and (kinds == pt.EV_THAW).sum() > 0
    assert (kinds == pt.EV_JUMP).sum() > 0
    assert (ref[3][4] == CAP).any()  # some chains froze


D, B_SLICE, N_SK, CHUNK, SEED = 4, 128, 64, 16, 5
KAPPA = np.array([0.5, 1.0, 2.0, 4.0])


def _jax_path(x0, v0, t_cap):
    sampler = pf.StickyZigZag(D, lambda x: x, KAPPA)
    target = N_SK - 1
    keys = jax.random.split(jax.random.key(SEED), B_SLICE)
    st = jax.vmap(lambda a, b, k: sampler.init_state(a, b, k, dtype=jnp.float64))(
        jnp.asarray(x0), jnp.asarray(v0), keys)
    iv = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(st)
    run = jax.jit(pdrv.make_pallas_stream_runner(
        sampler, t_cap, target, chunk=CHUNK, tile=TILE, interpret=True))
    compact = jax.jit(lambda s, e: engine.compact_stream_rows_with_init(s, target, e))
    merge = _jax_merge(target + 1)
    counts = jnp.zeros((B_SLICE,), jnp.int32)
    acc, fills = None, 0
    while True:
        prev = counts
        res = run(st, engine.empty_stream(t_cap, D, jnp.float64, B_SLICE), counts)
        st, counts = res.state, res.counts
        fills += 1
        acc = compact(res.stream, iv) if acc is None else merge(acc, res.stream, 1 + prev)
        if bool((np.asarray(counts) >= target).all()):
            break
    acc = acc._replace(n_valid=(1 + jnp.minimum(counts, target)).astype(jnp.int32))
    return acc, st, fills


@pytest.mark.parametrize("t_cap", [128, 48])  # 48 rows force straggler fills
def test_sticky_sample_skeleton_matches_jax_fused_path(t_cap):
    rs = np.random.default_rng(t_cap)
    x0 = rs.normal(size=(B_SLICE, D)) * 0.3
    v0 = rs.choice([-1.0, 1.0], size=(B_SLICE, D))
    ref, ref_state, fills = _jax_path(x0, v0, t_cap)
    if t_cap < N_SK:
        assert fills > 1

    sampler = pt.StickyZigZag(D, pt.potentials.grad_gauss, KAPPA)
    skel = pt.sample_skeleton(sampler, N_SK, x0, v0, seed=SEED,
                              dtype=torch.float64, device="cpu", t_cap=t_cap,
                              chunk=CHUNK, tile=TILE)
    got = convert.skeleton_to_numpy(skel)
    np.testing.assert_array_equal(got["n_valid"], np.asarray(ref.n_valid))
    assert (got["n_valid"] == N_SK).all()
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        assert got[f].shape == a.shape and got[f].dtype == a.dtype, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[f], a, rtol=1e-10, atol=1e-10, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)
    kinds = got["kind"]
    assert (kinds == pt.EV_STICK).any() and (kinds == pt.EV_THAW).any()
    assert not got["is_active"].all()
    # the carried state continues the same stream
    st = convert.state_to_numpy(sampler.state)
    np.testing.assert_array_equal(st["key"], np.asarray(jax.random.key_data(ref_state.key)))
    np.testing.assert_allclose(st["x"], np.asarray(ref_state.x), rtol=1e-10, atol=1e-10)
    np.testing.assert_array_equal(st["is_active"], np.asarray(ref_state.is_active))
    np.testing.assert_allclose(st["tt"], np.asarray(ref_state.tt), rtol=1e-10)


@pytest.mark.parametrize("kappa", [np.ones(2), -np.ones(3)])
def test_kappa_validation_matches_jax(kappa):
    with pytest.raises(ValueError) as ej:
        pf.StickyZigZag(3, lambda x: x, kappa)
    with pytest.raises(ValueError) as et:
        pt.StickyZigZag(3, pt.potentials.grad_gauss, kappa)
    assert str(et.value) == str(ej.value)


def test_sticky_constructors_and_init_state_match_jax():
    js = pf.StickyZigZag(4, lambda x: x)
    ts = pt.StickyZigZag(4, pt.potentials.grad_gauss)
    np.testing.assert_array_equal(ts.kappa.numpy(), np.asarray(js.kappa))  # 0.5 each
    assert ts.sticky and tdrv.kernel_kind(ts) == "zigzag"
    assert pt.StickyZigZagAD(4, pt.potentials.gauss, np.ones(4)).device_potential == "gauss"
    assert pt.StickyZigZagAD(4, lambda x: torch.sum(x * x) / 2).device_potential is None
    assert tdrv.kernel_kind(pt.StickyZigZag(4, pt.potentials.grad_gauss,
                                            vectorized_bound=False)) is None
    rs = np.random.default_rng(0)
    x0, v0 = rs.normal(size=(6, 4)), rs.choice([-1.0, 1.0], size=(6, 4))
    jst = js.init_state_batch(x0, v0, 17, dtype=jnp.float64)
    tst = ts.init_state_batch(x0, v0, 17, dtype=torch.float64, device="cpu")
    got = convert.state_to_numpy(tst)
    assert np.isinf(got["tt"]).all() and got["is_active"].all()
    for f in jst._fields:
        a = (np.asarray(jax.random.key_data(jst.key)) if f == "key"
             else np.asarray(getattr(jst, f)))
        assert got[f].dtype == a.dtype and got[f].shape == a.shape, f
        if f == "exp_rv":  # XLA's CPU log1p vs a correctly rounded one
            np.testing.assert_allclose(got[f], a, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)


def test_sticky_frozen_fraction_matches_theory():
    kappa = 1.0
    sampler = pt.StickyZigZag(4, pt.potentials.grad_gauss, np.full(4, kappa))
    skel = pt.sample_skeleton(sampler, 1000, np.full((64, 4), 0.3), np.ones((64, 4)),
                              seed=3, dtype=torch.float64, device="cpu")
    assert (skel.n_valid == 1000).all()
    xs = pt.sample_from_skeleton_batch(sampler, 500, skel)
    phi0 = 1.0 / np.sqrt(2 * np.pi)
    expected = phi0 / (kappa + phi0)  # 0.2852
    frozen = float((xs == 0.0).double().mean())
    assert abs(frozen - expected) < 0.05, (frozen, expected)
    assert abs(float(xs.var()) - (1 - expected)) < 0.1

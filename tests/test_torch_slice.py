"""The port's event-count path end to end against the JAX fused-kernel path.

``pdmpflux_tpu_torch.sample_skeleton(..., device="cpu")`` runs the stream
driver with K1's and K2's plain versions.  The JAX side is composed as its
one-shot program does it (``api.py:532-553``): ``init_state`` on split keys,
``make_pallas_stream_runner(interpret=True)`` and
``compact_stream_rows_with_init``; stragglers merge further fills with
``merge_stream_at_offsets`` (``api.py:725-736``), in its two steps.  Same
seed, fill rows, chunk and RNG tile, float64: every Skeleton field must
agree to 1e-10 (rounding order only) and ``n_valid`` exactly.
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
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402

D, B, N_SK, CHUNK, TILE, SEED = 4, 128, 64, 16, 128, 5


def _jax_merge(width):
    """``engine.merge_stream_at_offsets`` below the gather threshold, as its
    two steps (``compact_stream_rows``, then ``merge_rows_at_offsets``), each
    jitted on its own.  Jitted as one program, XLA's CPU backend returns a
    different result for about one call in ten on the straggler fill of
    ``t_cap=48`` (chain 0's merged rows), and run op by op it has aborted
    with heap corruption; the two programs apart gave one result in 1200
    calls."""
    rows = jax.jit(lambda s: engine.compact_stream_rows(s, min(s.kind.shape[1], width)))
    place = jax.jit(lambda a, r, o: engine.merge_rows_at_offsets(a, r, o, width))
    return lambda acc, stream, off: place(acc, rows(stream), jnp.asarray(off, jnp.int32))


def _jax_path(x0, v0, t_cap):
    sampler = pf.ZigZag(D, lambda x: x)
    target = N_SK - 1
    keys = jax.random.split(jax.random.key(SEED), B)
    st = jax.vmap(lambda a, b, k: sampler.init_state(a, b, k, dtype=jnp.float64))(
        jnp.asarray(x0), jnp.asarray(v0), keys)
    iv = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(st)
    run = jax.jit(pdrv.make_pallas_stream_runner(
        sampler, t_cap, target, chunk=CHUNK, tile=TILE, interpret=True))
    compact = jax.jit(lambda s, e: engine.compact_stream_rows_with_init(s, target, e))
    merge = _jax_merge(target + 1)
    counts = jnp.zeros((B,), jnp.int32)
    acc, fills = None, 0
    while True:
        prev = counts
        res = run(st, engine.empty_stream(t_cap, D, jnp.float64, B), counts)
        st, counts = res.state, res.counts
        fills += 1
        if acc is None:
            acc = compact(res.stream, iv)
        else:
            acc = merge(acc, res.stream, 1 + prev)
        if bool((np.asarray(counts) >= target).all()):
            break
    acc = acc._replace(n_valid=(1 + jnp.minimum(counts, target)).astype(jnp.int32))
    return acc, st, fills


@pytest.mark.parametrize("t_cap", [128, 48])  # 48 rows force straggler fills
def test_sample_skeleton_matches_jax_fused_path(t_cap):
    rs = np.random.default_rng(t_cap)
    x0 = rs.normal(size=(B, D))
    v0 = rs.choice([-1.0, 1.0], size=(B, D))
    ref, ref_state, fills = _jax_path(x0, v0, t_cap)
    assert (fills > 1) == (t_cap < N_SK)

    sampler = pt.ZigZag(D, pt.potentials.grad_gauss)
    skel = pt.sample_skeleton(sampler, N_SK, x0, v0, seed=SEED,
                              dtype=torch.float64, device="cpu", t_cap=t_cap,
                              chunk=CHUNK, tile=TILE)
    got = convert.skeleton_to_numpy(skel)
    np.testing.assert_array_equal(got["n_valid"], np.asarray(ref.n_valid))
    assert (got["n_valid"] == N_SK).all()
    for f in ref._fields:
        a = np.asarray(getattr(ref, f))
        assert got[f].shape == a.shape and got[f].dtype == a.dtype, f
        if a.dtype.kind in "f":
            np.testing.assert_allclose(got[f], a, rtol=1e-10, atol=1e-10, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)
    # the carried state, key included, continues the same stream
    st = convert.state_to_numpy(sampler.state)
    np.testing.assert_array_equal(st["key"], np.asarray(jax.random.key_data(ref_state.key)))
    np.testing.assert_allclose(st["x"], np.asarray(ref_state.x), rtol=1e-10, atol=1e-10)


def test_errors_match_jax_texts():
    sampler = pt.ZigZag(3, pt.potentials.grad_gauss)
    js = pf.ZigZag(3, lambda x: x)
    cases = [
        dict(n=0, x=np.zeros(3), v=np.ones(3)),
        dict(n=10, x=np.zeros(4), v=np.ones(4)),
        dict(n=10, x=np.array([0.0, np.nan, 0.0]), v=np.ones(3)),
    ]
    for c in cases:
        with pytest.raises(ValueError) as ej:
            pf.sample_skeleton(js, c["n"], c["x"], c["v"])
        with pytest.raises(ValueError) as et:
            pt.sample_skeleton(sampler, c["n"], c["x"], c["v"], device="cpu")
        assert str(et.value) == str(ej.value)
    for T in (-1.0, float("inf"), float("nan")):  # time horizons JAX refuses
        with pytest.raises(ValueError) as ej:
            pf.sample_skeleton(js, T, np.zeros(3), np.ones(3))
        with pytest.raises(ValueError) as et:
            pt.sample_skeleton(sampler, T, np.zeros(3), np.ones(3), device="cpu")
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as ej:
        pf.sample_from_skeleton(js, 0, pf.sample_skeleton(js, 5, np.zeros(3), np.ones(3)))
    skel = pt.sample_skeleton(sampler, 5, np.zeros(3), np.ones(3), device="cpu")
    with pytest.raises(ValueError) as et:
        pt.sample_from_skeleton(sampler, 0, skel)
    assert str(et.value) == str(ej.value)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        pt.sample_skeleton(pt.ZigZag(2, pt.potentials.grad_gauss), 5,
                           np.zeros(2), np.ones(2))


def test_device_budget_caps_fill_and_raises(monkeypatch, capsys):
    """A memory budget with room for the accumulator and ~200 rows of fill
    caps the fill at 128 rows, so the call completes through straggler
    merges; a budget below the accumulator no longer raises: the run takes
    host accumulation and equals the on-device run of the same fill rows
    bit for bit (JAX ``test_stream.py:105-128``)."""
    d, Bc, n_sk = 3, 8, 400
    row_bytes = (2 * d + 20) * 8 + d
    monkeypatch.setenv("PDMPFLUX_DEVICE_BYTES", str(Bc * row_bytes * (n_sk + 200)))
    sampler = pt.ZigZag(d, pt.potentials.grad_gauss)
    assert tapi.fill_rows(sampler, n_sk - 1, Bc, d, torch.float64,
                          torch.device("cpu")) == 128
    skel = pt.sample_skeleton(sampler, n_sk, np.zeros((Bc, d)), np.ones((Bc, d)),
                              seed=4, dtype=torch.float64, device="cpu", verbose=True)
    assert len(capsys.readouterr().out.splitlines()) > 3  # one line per fill
    assert (skel.n_valid == n_sk).all()
    assert (skel.kind[:, 1:] == pt.EV_JUMP).all() and (torch.diff(skel.t, dim=1) > 0).all()
    monkeypatch.setenv("PDMPFLUX_DEVICE_BYTES", "1000")
    tapi.HOST_ACC.clear()
    host = pt.sample_skeleton(sampler, n_sk, np.zeros((Bc, d)), np.ones((Bc, d)), seed=4,
                              dtype=torch.float64, device="cpu", t_cap=128)
    assert tapi.HOST_ACC["fills"] > 3  # 64-row budget fills would be too; 128 kept here
    monkeypatch.delenv("PDMPFLUX_DEVICE_BYTES")
    for a, b in zip(host, skel):
        assert a.device.type == "cpu" and a.shape == b.shape and torch.equal(a, b)


def test_readme_quick_start_moments():
    """The reference README workflow at test size: a single chain, a
    potential differentiated by autodiff, samples from the skeleton."""
    dim = 10
    sampler = pt.ZigZagAD(dim, lambda x: torch.sum(x ** 2) / 2)
    skel = pt.sample_skeleton(sampler, 1000, np.zeros(dim), np.ones(dim),
                              seed=2024, dtype=torch.float64, device="cpu")
    assert skel.t.shape == (1000,) and int(skel.n_valid) == 1000
    assert int(skel.kind[0]) == pt.EV_INIT and (skel.kind[1:] == pt.EV_JUMP).all()
    assert (torch.diff(skel.t) > 0).all()
    s = pt.sample_from_skeleton(sampler, 3000, skel).numpy()
    assert s.shape == (3000, dim)
    assert abs(s.mean()) < 0.15 and 0.75 < s.var() < 1.25
    svt = pt.sample_from_skeleton(sampler, 100, skel, discard_vt=False)
    assert svt.shape == (100, 2 * dim + 1)
    assert pt.sample_from_skeleton(sampler, 0.5, skel).shape[1] == dim
    assert pt.sample_from_skeleton(sampler, 50, skel, dt=0.1).shape[1] == dim


def test_batch_moments_and_sample():
    dim, Bc = 5, 64
    sampler = pt.ZigZag(dim, pt.potentials.grad_gauss)
    skel = pt.sample_skeleton(sampler, 300, np.zeros((Bc, dim)),
                              np.ones((Bc, dim)), seed=1, dtype=torch.float64,
                              device="cpu")
    assert (skel.n_valid == 300).all()
    mean, var = pt.pooled_moments(skel, sampler, 200)
    assert (mean.abs() < 0.2).all() and ((var - 1).abs() < 0.3).all()
    xs = pt.sample(sampler, 50, 20, np.zeros((8, dim)), np.ones((8, dim)),
                   seed=3, dtype=torch.float64, device="cpu")
    assert xs.shape == (8, 20, dim)

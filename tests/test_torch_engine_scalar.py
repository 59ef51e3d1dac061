"""The port's transition engine against the JAX package's XLA engine on the
scalar-rate samplers, and whole engine runs, float64 on the CPU.

* Transitions of BPS, the Boomerang and Forward ECMC in its three jump
  variants (orthogonal switch, full refresh, the normal radial draw with a
  random rotation), 300 transitions of 16 chains at d = 10 on the Gaussian
  and the banana, as ``test_torch_engine.py`` holds the Zig-Zag family.
* Whole runs: ``sample_skeleton(..., backend="xla_stream", device="cpu")``
  against JAX's stream engine in both modes: JAX's
  ``engine.make_stream_runner`` fills (the runner its ``backend="xla_stream"``
  path jits), their event rows gathered in numpy, and
  ``engine.finalize_horizon_rows`` for a time horizon.  JAX's own compaction
  and merge programs return wrong rows on XLA's CPU backend (ROADMAP Queue
  3: a zeroed row here too, in the fused one-fill horizon program), so the
  composition leaves them out.  The port runs once with one fill and once
  with fills small enough to merge stragglers through K2, which must not
  change the skeleton, since an engine chain's trajectory does not depend on
  where fills end.  Every field to rtol 1e-10, ``n_valid`` exactly, and the
  carried state's key equal.
* Checkpoint/resume of an engine run, bit for bit; streaming statistics of
  an engine run against JAX's ``sample_streaming_stats``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core import engine as je  # noqa: E402
from pdmpflux_tpu.core.types import EV_INIT, Skeleton as JSkeleton  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.core import engine as te  # noqa: E402
from test_torch_engine import SCALAR_FAMILIES, check_transitions, pair  # noqa: E402

RUN_RTOL = 1e-10


@pytest.mark.parametrize("pot", ["gauss", "banana"])
@pytest.mark.parametrize("family", SCALAR_FAMILIES)
def test_scalar_transitions_match_jax(family, pot):
    kinds, rejected = check_transitions(family, pot)
    assert (kinds == pt.EV_JUMP).sum() > 100
    if pot == "banana":
        assert rejected.sum() > 0  # thinning rejected some proposals


def jax_engine_skeleton(js, x0, v0, n_or_T, seed, t_cap):
    """JAX's stream-engine skeleton, its fills gathered in numpy (see the
    module docstring), and its final state."""
    Bc, d = x0.shape
    horizon = isinstance(n_or_T, float)
    st = js.init_state_batch(x0, v0, seed, dtype=jnp.float64)
    init = jax.vmap(lambda s: je.event_from_state(s, EV_INIT))(st)
    run = jax.jit(je.make_stream_runner(js, t_cap, chunk=64,
                                        mode="horizon" if horizon else "events"))
    fields = [f for f in JSkeleton._fields if f != "n_valid"]
    rows = {f: [[] for _ in range(Bc)] for f in fields}
    target = n_or_T if horizon else n_or_T - 1
    counts = jnp.zeros((Bc,), jnp.int32)
    while True:
        res = run(st, je.empty_stream(t_cap, d, jnp.float64, Bc),
                  jnp.zeros((Bc,), jnp.int32) if horizon else counts,
                  jnp.asarray(target, jnp.float64) if horizon else target)
        st, counts = res.state, res.counts
        stream = {f: np.asarray(getattr(res.stream, f)) for f in fields}
        for b in range(Bc):
            ev = stream["kind"][b] > 0
            for f in fields:
                rows[f][b].extend(stream[f][b][ev])
        done = (np.asarray(st.t) >= target) if horizon else (np.asarray(counts) >= target)
        if done.all():
            break
    n = np.array([len(rows["t"][b]) for b in range(Bc)])
    W = n.max() if horizon else target
    dense = {}
    for f in fields:
        proto = np.asarray(getattr(init, f))
        a = np.zeros((Bc, W) + proto.shape[1:], proto.dtype)
        for b in range(Bc):
            k = min(len(rows[f][b]), W)
            if k:
                a[b, :k] = np.stack(rows[f][b][:k])
        dense[f] = a
    if horizon:
        acc = JSkeleton(**{f: jnp.asarray(a) for f, a in dense.items()},
                        n_valid=jnp.asarray(n, jnp.int32))
        out_w = min(W + 2, -(-(2 + max(1, int(n.max()))) // 256) * 256)
        skel = je.finalize_horizon_rows(js.flow, acc, init, jnp.asarray(n, jnp.int32),
                                        n_or_T, out_width=out_w)
        return {f: np.asarray(getattr(skel, f)) for f in JSkeleton._fields}, st
    out = {f: np.concatenate([np.asarray(getattr(init, f))[:, None], a], 1)
           for f, a in dense.items()}
    out["n_valid"] = (1 + np.minimum(n, target)).astype(np.int32)
    return out, st


def assert_skeletons_close(got, want, rtol=RUN_RTOL):
    """Every field of the port's skeleton against a dict of JAX arrays; a
    wider skeleton's extra columns must be zero."""
    g = convert.skeleton_to_numpy(got)
    for f, a in want.items():
        b = g[f]
        if f != "n_valid" and b.shape[1] > a.shape[1]:
            assert not b[:, a.shape[1]:].any(), f
            b = b[:, :a.shape[1]]
        assert b.shape == a.shape and b.dtype == a.dtype, (f, b.shape, a.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=rtol, atol=rtol, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


RUNS = {  # family, potential, B, d, n_sk or T, the port's small fill
    "zigzag_scalar": ("zigzag_scalar", "banana", 8, 4, 200, 64),
    "sticky_scalar": ("sticky_scalar", "gauss", 8, 4, 200, 64),
    "zigzag_scalar_horizon": ("zigzag_scalar", "banana", 8, 4, 40.0, 64),
    "boomerang_horizon": ("boomerang", "gauss", 8, 4, 30.0, 64),
}


@pytest.mark.parametrize("case", list(RUNS))
def test_sample_skeleton_matches_jax_stream_engine(case):
    family, pot, Bc, d, n_or_T, small = RUNS[case]
    js, ts = pair(family, pot, d)
    rs = np.random.default_rng(4)
    x0 = rs.normal(size=(Bc, d))
    v0 = (rs.choice([-1.0, 1.0], size=(Bc, d)) if family != "boomerang"
          else rs.normal(size=(Bc, d)))
    horizon = isinstance(n_or_T, float)
    ref, ref_state = jax_engine_skeleton(js, x0, v0, n_or_T, 9, 4096 if horizon else 512)
    kw = dict(init_capacity=4096) if horizon else {}
    te.reset_counts()
    got = pt.sample_skeleton(ts, n_or_T, x0, v0, seed=9, dtype=torch.float64,
                             device="cpu", backend="xla_stream", **kw)
    assert te.COUNTS["transitions"] > 0
    assert_skeletons_close(got, ref)
    np.testing.assert_array_equal(convert.state_to_numpy(ts.state)["key"],
                                  np.asarray(jax.random.key_data(ref_state.key)))
    # small fills: stragglers merged behind each chain's earlier events
    small_kw = dict(init_capacity=small) if horizon else dict(t_cap=small)
    merged = pt.sample_skeleton(ts, n_or_T, x0, v0, seed=9, dtype=torch.float64,
                                device="cpu", backend="xla_stream", **small_kw)
    assert_skeletons_close(merged, ref)


@pytest.mark.parametrize("mode", ["events", "horizon"])
def test_engine_resume_is_bit_for_bit(monkeypatch, tmp_path, mode):
    _, ts = pair("zigzag_scalar", "banana", 3)
    rs = np.random.default_rng(6)
    x0, v0 = rs.normal(size=(6, 3)), rs.choice([-1.0, 1.0], size=(6, 3))
    n_or_T, kw = (160, dict(t_cap=64)) if mode == "events" else (40.0, dict(init_capacity=64))

    def run(**extra):
        return pt.sample_skeleton(ts, n_or_T, x0, v0, seed=5, dtype=torch.float64,
                                  device="cpu", backend="xla_stream", **kw, **extra)

    ref = run()
    path = str(tmp_path / "run.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        run(checkpoint_path=path, checkpoint_every=1)
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    got = run(checkpoint_path=path, checkpoint_every=1)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)

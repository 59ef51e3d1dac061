"""Streaming statistics of the port (``pdmpflux_tpu_torch.streaming``)
against the JAX package (``pdmpflux_tpu.streaming``).

* (a) the port's fold, reading a raw fill chains minor, equals JAX's
  ``make_fold_chunk`` on the same fill in JAX's ``(B, W, ...)`` layout:
  float64, Zig-Zag and Sticky Zig-Zag, burn-in inside the window, the anchor
  covering the grid points before the fill's first row.  Sums to rtol
  1e-12, ``n_half`` and ``bcount`` exactly.
* (b) a whole run on the CPU equals a JAX run composed from
  ``make_pallas_stream_runner(..., interpret=True, mode="horizon")``, the
  cap and cursor logic of ``streaming.py:371-413`` and
  ``streaming.make_fold_chunk``, in groups of two fills as JAX groups them
  off the TPU.  Accumulators to rtol 1e-12 (the plain chunk versions follow
  the interpreted kernel to rounding order); events and fills equal.
* (c) ``streaming_summary`` equals JAX's on the same accumulators.
* (d) the materialized check of ``tests/test_streaming.py``: the port's own
  recorded fills, interpolated at the grid, reproduce the accumulators, and
  split-R-hat equals ``diagnostics.split_rhat`` of those samples.
* (e) checkpoint resume bit for bit; a file of another configuration
  (including the port's manifest keys ``x_ref``, ``shape`` and ``seed``)
  raises JAX's message.
* (f) early stop; (g) bad arguments raise JAX's text.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu import streaming as jstream  # noqa: E402
from pdmpflux_tpu.core import engine  # noqa: E402
from pdmpflux_tpu.core.types import Skeleton as JSkeleton  # noqa: E402
from pdmpflux_tpu.ops.pallas import driver as pdrv  # noqa: E402
from pdmpflux_tpu_torch import api, streaming  # noqa: E402
from pdmpflux_tpu_torch.core.types import Skeleton  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402

B, D, TILE, CHUNK = 4, 3, 4, 32
KAPPA = 5.0
RTOL = 1e-12


def _pair(name):
    if name == "zigzag":
        return pf.ZigZag(D, lambda x: x), pt.ZigZag(D, pt.potentials.grad_gauss)
    kappa = np.full(D, KAPPA)
    return (pf.StickyZigZag(D, lambda x: x, kappa),
            pt.StickyZigZag(D, pt.potentials.grad_gauss, kappa))


def _init(Bc=B, seed=0):
    rs = np.random.default_rng(seed)
    return rs.normal(size=(Bc, D)) * 0.4, rs.choice([-1.0, 1.0], size=(Bc, D))


def _stats_equal(got, ref, exact=False):
    for f in pt.streaming.StreamingStats._fields:
        a = getattr(got, f).cpu().numpy()
        b = np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        if a.dtype.kind == "i" or exact:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0, err_msg=f)


# ---------------------------------------------------------------------------
# (a) the fold on one raw fill
# ---------------------------------------------------------------------------

def _jax_stream(fill, t_cap):
    """The port's chains-minor fill as JAX's (B, t_cap, ...) stream, rows past
    the fill zero (the fold masks them to +inf)."""
    rows, d, Bc = fill.x.shape

    def pad(a):  # (rows, ..., B) -> (B, t_cap, ...)
        a = a.permute(-1, 0, *range(1, a.dim() - 1)).numpy()
        out = np.zeros((Bc, t_cap) + a.shape[2:], a.dtype)
        out[:, :rows] = a
        return jnp.asarray(out)

    act = (pad(fill.act) if fill.act is not None
           else jnp.ones((Bc, t_cap, d), bool))
    return JSkeleton(
        x=pad(fill.x), v=pad(fill.v), t=pad(fill.fs[:, 0]), horizon=pad(fill.fs[:, 1]),
        ar=pad(fill.fs[:, 2]), is_active=act, rejected=pad(fill.kind[:, 1]),
        errored_bound=pad(fill.kind[:, 2]), hitting_horizon=pad(fill.kind[:, 3]),
        error_value_ar=pad(fill.ring), kind=pad(fill.kind[:, 0]),
        n_valid=jnp.full((Bc,), rows, jnp.int32))


@pytest.mark.parametrize("name", ["zigzag", "sticky"])
def test_fold_matches_jax_on_a_raw_fill(name):
    _, ts = _pair(name)
    Bc, t_cap, G, n_samples, n_batches = 8, 96, 64, 4096, 16
    T = 40.0
    dt_grid = T / n_samples
    x0, v0 = _init(Bc, 1)
    x_ref = np.asarray(x0.mean(axis=0), np.float32)
    run = tdrv.make_stream_runner(ts, t_cap, t_cap, chunk=CHUNK, tile=TILE, mode="horizon")
    state = ts.init_state_batch(x0, v0, 3, torch.float64, "cpu")
    zeros = torch.zeros(Bc, dtype=torch.int32)
    state = run(state, zeros, 1.5).state         # a carried anchor past t = 0
    anchor = streaming._anchor_from_state(state)
    res = run(state, zeros, 4.0)
    fill = res.fill
    assert res.transitions > 0
    if name == "sticky":
        assert not bool(fill.act.all()) and not bool(anchor[3].all())
    j_start = torch.floor(anchor[0] / dt_grid).to(torch.int32)
    traj = res.state.t + res.state.ts
    j_hi = torch.minimum(torch.floor(traj / dt_grid).to(torch.int32), j_start + G)
    n_burnin = int(j_start.min()) + 10           # the burn-in ends inside the windows
    stats0 = streaming.empty_stats(Bc, D, n_batches, torch.float64, "cpu")
    fold = streaming.make_fold_chunk(ts, G, n_samples, n_batches, n_burnin, dt_grid, x_ref)
    got = fold(stats0, fill, anchor, res.transitions, j_start, j_hi)

    js, _ = _pair(name)
    jfold = jax.jit(jstream.make_fold_chunk(js, t_cap, G, n_samples, n_batches, n_burnin,
                                            dt_grid, x_ref))
    janchor = tuple(jnp.asarray(a.numpy()) for a in anchor)
    ref = jfold(jstream.empty_stats(Bc, D, n_batches, jnp.float64), _jax_stream(fill, t_cap),
                janchor, jnp.asarray(res.transitions, jnp.int32),
                jnp.asarray(j_start.numpy()), jnp.asarray(j_hi.numpy()))
    _stats_equal(got, ref)
    # the check covered what it claims: anchored points, burn-in, live points
    tm = fill.fs[:, 0].T
    first = ((j_start + 1).double() * dt_grid < tm[:, 0]) & (j_start + 1 >= n_burnin)
    assert bool(first.any()) and int(got.n_half.sum()) > 0
    assert bool((j_start < n_burnin).any())


# ---------------------------------------------------------------------------
# (b) a whole run against a composed JAX run
# ---------------------------------------------------------------------------

def _jax_streaming(js, x0, v0, T, *, n_samples, n_batches, seed, t_cap, G,
                   burnin_frac=0.25, K=2):
    """JAX's streaming run composed as its fill program composes it
    (``streaming.py:371-413``), fills grouped by ``K``."""
    Bc, d = x0.shape
    n_burnin = int(burnin_frac * n_samples)
    dt_grid = T / n_samples
    x_ref = np.asarray(x0.mean(axis=0), np.float32)
    st = js.init_state_batch(x0, v0, seed, dtype=jnp.float64)
    run = jax.jit(pdrv.make_pallas_stream_runner(js, t_cap, t_cap, chunk=CHUNK, tile=TILE,
                                                 interpret=True, mode="horizon"))
    fold = jax.jit(jstream.make_fold_chunk(js, t_cap, G, n_samples, n_batches, n_burnin,
                                           dt_grid, x_ref))
    stats = jstream.empty_stats(Bc, d, n_batches, jnp.float64)
    j_done = jnp.zeros((Bc,), jnp.int32)
    Tv = jnp.asarray(T, jnp.float32)
    events = fills = 0
    while True:
        for _ in range(K):
            anchor = jstream._anchor_from_state(st)
            cap_pts = (jnp.min(j_done) + G - max(1, G // 4)).astype(jnp.float32)
            tt_eff = jnp.minimum(Tv, cap_pts * jnp.asarray(dt_grid, jnp.float32))
            res = run(st, engine.empty_stream(t_cap, d, jnp.float64, Bc),
                      jnp.zeros((Bc,), jnp.int32), tt_eff)
            ns = res.state
            traj = ns.t + ns.ts
            done = ns.t >= Tv.astype(ns.t.dtype)
            j_hi = jnp.minimum(jnp.floor(traj / jnp.asarray(dt_grid, traj.dtype))
                               .astype(jnp.int32), n_samples)
            j_hi = jnp.maximum(jnp.where(done, n_samples, j_hi), j_done)
            stats = fold(stats, res.stream, anchor, res.transitions, j_done, j_hi)
            assert not bool(jnp.any(j_hi > j_done + G))
            j_done = jnp.minimum(j_hi, j_done + G)
            events += int(jnp.sum(res.counts))
            st = ns
        fills += K
        if (np.asarray(st.t) >= T).all() and int(jnp.min(j_done)) >= n_samples:
            return stats, st, events, fills


RUN = dict(n_samples=512, n_batches=8, seed=7, t_cap=64, G=128)


@pytest.fixture(scope="module")
def jax_runs():
    cache = {}

    def get(name):
        if name not in cache:
            js, _ = _pair(name)
            x0, v0 = _init()
            cache[name] = _jax_streaming(js, x0, v0, 60.0, **RUN)
        return cache[name]

    return get


def _port_run(ts, T=60.0, x0=None, v0=None, **kw):
    if x0 is None:
        x0, v0 = _init()
    args = dict(n_samples=RUN["n_samples"], n_batches=RUN["n_batches"], seed=RUN["seed"],
                t_cap=RUN["t_cap"], grid_chunk=RUN["G"], dtype=torch.float64,
                device="cpu", tile=TILE, chunk=CHUNK)
    args.update(kw)
    return pt.sample_streaming_stats(ts, T, x0, v0, **args)


@pytest.mark.parametrize("name", ["zigzag", "sticky"])
def test_streaming_run_matches_composed_jax_run(jax_runs, name):
    stats, st, events, fills = jax_runs(name)
    _, ts = _pair(name)
    run = _port_run(ts)
    assert fills >= 4 and run.fills == fills and run.events == events
    _stats_equal(run.stats, stats)
    np.testing.assert_allclose(run.state.t.numpy(), np.asarray(st.t), rtol=1e-10)
    np.testing.assert_array_equal(run.state.is_active.numpy(), np.asarray(st.is_active))
    np.testing.assert_array_equal(run.state.key.numpy(),
                                  np.asarray(jax.random.key_data(st.key)))


# ---------------------------------------------------------------------------
# (c) the summary
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("partial", [False, True])
def test_streaming_summary_matches_jax(partial):
    rs = np.random.default_rng(5)
    Bc, M, d = 6, 8, 4
    n_half = rs.integers(40, 60, size=(Bc, 2)).astype(np.int32)
    bcount = np.full((Bc, M), 12, np.int32)
    if partial:  # an early-stopped run: empty and partial trailing windows
        bcount[:, -2:] = 0
        bcount[::2, -3] = 5
    sum_half = rs.normal(size=(Bc, 2, d)) * 5
    sumsq_half = sum_half ** 2 / n_half[:, :, None] + rs.uniform(30, 60, size=(Bc, 2, d))
    bsum = rs.normal(size=(Bc, M, d)) * 3
    arrays = (n_half, sum_half, sumsq_half, bsum, bcount)
    x_ref = rs.normal(size=d).astype(np.float32)
    tstats = pt.streaming.StreamingStats(*(torch.tensor(a) for a in arrays))
    jstats = jstream.StreamingStats(*(jnp.asarray(a) for a in arrays))
    got = pt.streaming_summary(streaming.StreamingRun(tstats, None, 0, 0, 96, 32, x_ref))
    ref = pf.streaming_summary(jstream.StreamingRun(jstats, None, 0, 0, 96, 32, x_ref))
    assert got.keys() == ref.keys()
    for k, a in ref.items():
        if isinstance(a, (bool, float)):
            assert got[k] == a, k
        else:
            np.testing.assert_allclose(got[k], a, rtol=RTOL, atol=0, err_msg=k)
    for thr in (1.5, 1.0001):  # the gate's threshold passed through
        assert (pt.streaming_summary(streaming.StreamingRun(tstats, None, 0, 0, 96, 32, x_ref),
                                     rhat_threshold=thr)["converged"]
                == pf.streaming_summary(jstream.StreamingRun(jstats, None, 0, 0, 96, 32, x_ref),
                                        rhat_threshold=thr)["converged"])


# ---------------------------------------------------------------------------
# (d) the materialized check on the port's own fills
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zigzag", "sticky"])
def test_streaming_matches_materialized_fills(monkeypatch, name):
    _, ts = _pair(name)
    recorded = []
    make = tdrv.make_stream_runner

    def recording(*a, **k):
        inner = make(*a, **k)

        def run(state, counts, t_target=None):
            res = inner(state, counts, t_target)
            recorded.append(res.fill)
            return res

        return run

    monkeypatch.setattr(tdrv, "make_stream_runner", recording)
    x0, v0 = _init()
    T, n_samples, n_batches = 60.0, RUN["n_samples"], RUN["n_batches"]
    run = _port_run(ts, T, x0, v0)
    summ = pt.streaming_summary(run)

    # every chain's skeleton: its initial point, then every raw row in order
    n_burnin = int(0.25 * n_samples)
    tm = (torch.arange(n_samples, dtype=torch.float64) + 1) * (T / n_samples)
    xs = []
    for b in range(B):
        t = torch.cat([torch.zeros(1, dtype=torch.float64)] + [f.fs[:, 0, b] for f in recorded])
        x = torch.cat([torch.tensor(x0[b])[None]] + [f.x[:, :, b] for f in recorded])
        v = torch.cat([torch.tensor(v0[b])[None]] + [f.v[:, :, b] for f in recorded])
        act = torch.cat([torch.ones(1, D, dtype=torch.bool)]
                        + [(f.act[:, :, b] if f.act is not None
                            else torch.ones(f.rows, D, dtype=torch.bool)) for f in recorded])
        n = t.shape[0]
        zero = torch.zeros(n, dtype=torch.int32)
        skel = Skeleton(x=x, v=v, t=t, horizon=t, ar=t, is_active=act, rejected=zero,
                        errored_bound=zero, hitting_horizon=zero, error_value_ar=x,
                        kind=zero, n_valid=torch.tensor(n))
        xs.append(api._interp_times(ts, skel, tm, True))
    samples = torch.stack(xs)[:, n_burnin:].numpy()            # (B, n_post, d)
    n_post = n_samples - n_burnin
    win = np.arange(n_post) * n_batches // n_post
    half = np.arange(n_post) * 2 // n_post
    np.testing.assert_array_equal(run.stats.bcount.numpy(),
                                  np.tile(np.bincount(win, minlength=n_batches), (B, 1)))
    np.testing.assert_array_equal(run.stats.n_half.numpy(),
                                  np.tile(np.bincount(half, minlength=2), (B, 1)))
    bsum = np.stack([samples[:, win == m].sum(axis=1) for m in range(n_batches)], axis=1)
    x_ref = np.asarray(x0.mean(axis=0), np.float32).astype(np.float64)
    np.testing.assert_allclose(run.stats.bsum.numpy(),
                               bsum - run.stats.bcount.numpy()[:, :, None] * x_ref,
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(summ["mean"], samples.mean(axis=1), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(summ["var"], samples.var(axis=1, ddof=1), rtol=1e-10)
    np.testing.assert_allclose(summ["rhat"], pt.diagnostics.split_rhat(samples), rtol=1e-10)


# ---------------------------------------------------------------------------
# (e) checkpoint resume
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["zigzag", "sticky"])
def test_streaming_checkpoint_resume_bit_for_bit(monkeypatch, tmp_path, name):
    _, ts = _pair(name)
    ref = _port_run(ts)
    assert ref.fills >= 6
    ck = str(tmp_path / "stream.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "4")
    with pytest.raises(RuntimeError, match="fault injection"):
        _port_run(ts, checkpoint_path=ck, checkpoint_every=2)
    assert (tmp_path / "stream.npz").exists()
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    resumed = _port_run(ts, checkpoint_path=ck, checkpoint_every=2)
    _stats_equal(resumed.stats, ref.stats, exact=True)
    assert (resumed.events, resumed.fills) == (ref.events, ref.fills)
    for a, b in zip(resumed.state, ref.state):
        assert torch.equal(a, b)


def test_streaming_checkpoint_refuses_another_run(monkeypatch, tmp_path):
    """A file written for another configuration raises the JAX package's
    message, for JAX's keys and for the port's ``x_ref``, ``shape`` and
    ``seed``; JAX's loader raises the same text on the same file."""
    _, ts = _pair("zigzag")
    ck = str(tmp_path / "stream.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "4")
    with pytest.raises(RuntimeError, match="fault injection"):
        _port_run(ts, checkpoint_path=ck, checkpoint_every=2)
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    assert (tmp_path / "stream.npz").exists()
    x0, v0 = _init()
    x_ref = np.asarray(x0.mean(axis=0), np.float32).tolist()
    base = {"T": 60.0, "n_samples": 512, "n_batches": 8, "n_burnin": 128, "x_ref": x_ref,
            "shape": [B, D], "seed": 7}
    cases = [("n_samples", 1024, dict(n_samples=1024)),
             ("x_ref", None, dict(x0=x0 + 0.5, v0=v0)),
             ("shape", [B + 1, D], dict(x0=np.vstack([x0, x0[:1]]),
                                        v0=np.vstack([v0, v0[:1]]))),
             ("seed", 8, dict(seed=8))]
    for key, val, kw in cases:
        with pytest.raises(ValueError, match="delete it to start fresh") as got:
            _port_run(ts, checkpoint_path=ck, **kw)
        assert f"was written for {key}=" in str(got.value)
        expect = dict(base)
        expect[key] = (np.asarray((x0 + 0.5).mean(axis=0), np.float32).tolist()
                       if key == "x_ref" else val)
        with pytest.raises(ValueError) as ref:
            jstream._load_streaming_checkpoint(ck, expect)
        assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# (f) early stop, (g) arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("min_ess", [0.0, 100.0])
def test_streaming_early_stop(min_ess):
    """``T`` as a budget: the run stops at the split-R-hat gate (and the
    worst coordinate's pooled ESS, when asked) long before the budget."""
    sampler = pt.ZigZag(2, pt.potentials.grad_gauss)
    n_samples, G, T = 2048, 128, 2000.0
    kw = dict(n_samples=n_samples, n_batches=16, t_cap=128, grid_chunk=G, seed=3,
              dtype=torch.float64, device="cpu")
    run = pt.sample_streaming_stats(sampler, T, np.zeros((8, 2)), np.ones((8, 2)),
                                    stop_when_converged=True, check_every=1,
                                    min_ess=min_ess, **kw)
    summ = pt.streaming_summary(run)
    assert summ["converged"], summ["rhat_max"]
    assert summ["ess_total_worst_coord"] >= min_ess
    assert int(run.stats.bcount[:, -1].max()) == 0      # the last window never filled
    # a fill advances the grid by at most G - G // 4 points: the whole budget
    # needs twice the fills the run took
    assert run.fills < 0.5 * n_samples / (G - G // 4)
    assert bool((run.state.t < T).all())
    assert np.all((summ["pooled_var"] > 0.5) & (summ["pooled_var"] < 2.0))


@pytest.mark.parametrize("T,kw", [(-1.0, {}), (float("inf"), {}), (0, {}),
                                  (10.0, dict(n_samples=16, n_batches=64))])
def test_streaming_rejects_bad_args_with_jax_text(T, kw):
    with pytest.raises(ValueError) as ref:
        pf.sample_streaming_stats(pf.ZigZagAD(2, lambda x: jnp.sum(x * x) / 2), T,
                                  np.zeros(2), np.ones(2), **kw)
    with pytest.raises(ValueError) as got:
        pt.sample_streaming_stats(pt.ZigZagAD(2, pt.potentials.gauss), T, np.zeros(2),
                                  np.ones(2), device="cpu", **kw)
    assert str(got.value) == str(ref.value)


def test_streaming_without_a_kernel_names_the_engine():
    """A sampler no chunk kernel covers streams on the transition engine."""
    from pdmpflux_tpu_torch.core import engine as te

    sampler = pt.ZigZag(2, pt.potentials.grad_gauss, vectorized_bound=False,
                        signed_bound=False)
    assert api.pick_backend(sampler, "auto", 2, torch.float64, "cpu") == "engine"
    te.reset_counts()
    run = pt.sample_streaming_stats(sampler, 10.0, np.zeros((4, 2)), np.ones((4, 2)),
                                    n_samples=128, n_batches=4, t_cap=256,
                                    grid_chunk=128, dtype=torch.float64, device="cpu")
    assert te.COUNTS["transitions"] > 0 and run.events > 0
    assert bool((run.state.t >= 10.0).all())

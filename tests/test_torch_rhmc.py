"""RHMC on the port's transition engine against the JAX package, float64 on
the CPU, and the five other test potentials.

* Constructors: the defaults (the automatic ``tmax``), the flags and the
  error texts of ``RHMC``/``RHMCAD`` equal JAX's.
* The velocity-Verlet flow (``ops/flows.make_verlet_flow``) on rows of any
  leading shape against ``make_verlet_flow`` mapped over them, with and
  without a host bound on the times: rtol 1e-12.
* 300 transitions of 16 chains at d = 10, Gaussian and banana, as
  ``test_torch_engine.py`` holds the other families; the Horowitz jump on
  equal keys.
* Whole runs in both modes against JAX's stream engine
  (``test_torch_engine_scalar.jax_engine_skeleton``), ``sample`` and
  ``sample_from_skeleton`` on them, a resumed run bit for bit, and
  ``sample_streaming_stats`` against JAX's (``PDMPFLUX_FORCE_STREAM=1``,
  which runs JAX's engine in horizon mode on the CPU).
* ``gauss_1d``, ``funnel``, ``neal_funnel``, ``ridged_gauss`` and ``cauchy``:
  their device tags, values and ``torch.func.grad`` against ``jax.grad``;
  each runs through ``sample_skeleton`` and ``sample_from_skeleton_batch``
  on the engine (RHMC has no chunk kernel), which takes the tag's closed
  form.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.models.rhmc import _auto_horizon as j_auto_horizon  # noqa: E402
from pdmpflux_tpu.ops.flows import make_verlet_flow as j_verlet  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.core import engine as te  # noqa: E402
from pdmpflux_tpu_torch.models.rhmc import _auto_horizon  # noqa: E402
from pdmpflux_tpu_torch.ops.flows import make_verlet_flow  # noqa: E402
from test_torch_engine import check_transitions, pair  # noqa: E402
from test_torch_engine_scalar import assert_skeletons_close, jax_engine_skeleton  # noqa: E402

RTOL = ATOL = 1e-12
RHMC = ("RHMCAD", {})


@pytest.mark.parametrize("kw", [dict(), dict(refresh_rate=2.5, step_size=0.02),
                                dict(mean_duration=0.5, phi=0.7), dict(tmax=10.0)])
def test_rhmc_defaults_match_jax(kw):
    js = pf.RHMCAD(4, pf.utils.potentials.gauss, **kw)
    ts = pt.RHMCAD(4, pt.potentials.gauss, **kw)
    for f in ("tmax", "refresh_rate", "phi", "step_size", "grid_size", "adaptive",
              "vectorized_bound", "signed_bound"):
        assert getattr(ts, f) == getattr(js, f), f
    for lam, h in ((1.0, 0.05), (0.3, 0.1), (4.0, 0.01)):
        assert _auto_horizon(lam, h) == j_auto_horizon(lam, h)
    assert ts.device_potential == "gauss" and ts.flow_takes_bound


@pytest.mark.parametrize("kw", [dict(mean_duration=0.0), dict(refresh_rate=-1.0),
                                dict(phi=2.0), dict(step_size=0.0), dict(tmax=-1.0),
                                dict(refresh_rate=float("inf"))])
def test_rhmc_errors_match_jax(kw):
    with pytest.raises(ValueError) as ej:
        pf.RHMC(3, lambda x: x, **kw)
    with pytest.raises(ValueError) as et:
        pt.RHMC(3, pt.potentials.grad_gauss, **kw)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("pot", ["gauss", "banana"])
def test_verlet_flow_matches_jax(pot):
    grad_j = jax.grad(getattr(pf.utils.potentials, pot))
    ts = pt.RHMCAD(5, getattr(pt.potentials, pot))
    h = 0.05
    rs = np.random.default_rng(8)
    x, v = rs.normal(size=(4, 6, 5)), rs.normal(size=(4, 6, 5))
    t = rs.uniform(0, 1.3, size=(4, 6, 1))
    t[0, :4, 0] = [0.0, 0.03, 0.5, 1.0]  # none, a remainder only, whole steps
    jf = j_verlet(grad_j, h)
    want = jax.vmap(jax.vmap(jf))(jnp.asarray(x), jnp.asarray(v), jnp.asarray(t[..., 0]))
    flow = make_verlet_flow(ts.grad_rows, h)
    for t_max in (None, 1.3, 4.0):
        got = flow(torch.as_tensor(x), torch.as_tensor(v), torch.as_tensor(t), t_max)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)
    # the sampler's flow on (B, d) rows, as finalize_horizon_rows calls it
    got = ts.flow(torch.as_tensor(x[0]), torch.as_tensor(v[0]), torch.as_tensor(t[0]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0][0]), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("pot", ["gauss", "banana"])
def test_rhmc_transitions_match_jax(pot):
    kinds, _ = check_transitions(RHMC, pot)
    assert (kinds == pt.EV_JUMP).sum() > 100 and (kinds == pt.EV_NONE).sum() > 100


@pytest.mark.parametrize("phi", [math.pi / 2, 0.7])
def test_rhmc_velocity_jump_matches_jax(phi):
    js, ts = pair(("RHMCAD", dict(phi=phi)), "gauss", 6)
    rs = np.random.default_rng(2)
    x, v = rs.normal(size=(32, 6)), rs.normal(size=(32, 6))
    keys = jax.random.split(jax.random.key(3), 32)
    act = np.ones((32, 6), bool)
    want = jax.vmap(js.velocity_jump)(jnp.asarray(x), jnp.asarray(v), keys, jnp.asarray(act))
    got = ts.velocity_jump(torch.as_tensor(x), torch.as_tensor(v),
                           torch.as_tensor(np.asarray(jax.random.key_data(keys)).astype(np.int64)),
                           torch.as_tensor(act))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def _init(Bc, d, seed):
    rs = np.random.default_rng(seed)
    return rs.normal(size=(Bc, d)), rs.normal(size=(Bc, d))


@pytest.mark.parametrize("n_or_T", [120, 80.0])
def test_rhmc_runs_match_jax(n_or_T):
    js, ts = pair(RHMC, "banana", 4)
    x0, v0 = _init(6, 4, 5)
    horizon = isinstance(n_or_T, float)
    ref, ref_state = jax_engine_skeleton(js, x0, v0, n_or_T, 2, 256)
    kw = dict(init_capacity=64) if horizon else dict(t_cap=64)  # several fills
    te.reset_counts()
    got = pt.sample_skeleton(ts, n_or_T, x0, v0, seed=2, dtype=torch.float64,
                             device="cpu", **kw)
    assert te.COUNTS["chunks"] > 1
    assert_skeletons_close(got, ref)
    np.testing.assert_array_equal(convert.state_to_numpy(ts.state)["key"],
                                  np.asarray(jax.random.key_data(ref_state.key)))
    if horizon:
        return
    # skeleton -> samples through the Verlet flow, against JAX's on one chain
    one = pt.Skeleton(*(a[1] for a in got[:-1]), n_valid=got.n_valid[1])
    jone = pf.core.types.Skeleton(**{f: jnp.asarray(ref[f][1]) for f in ref if f != "n_valid"},
                                  n_valid=jnp.asarray(ref["n_valid"][1]))
    np.testing.assert_allclose(pt.sample_from_skeleton(ts, 50, one).numpy(),
                               np.asarray(pf.sample_from_skeleton(js, 50, jone)),
                               rtol=1e-10, atol=1e-10)
    xs = pt.sample(ts, n_or_T, 40, x0, v0, seed=2, dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(
        xs.numpy(), pt.sample_from_skeleton_batch(ts, 40, got).numpy(), rtol=0, atol=0)


def test_rhmc_resume_is_bit_for_bit(monkeypatch, tmp_path):
    ts = pt.RHMCAD(3, pt.potentials.banana)
    x0, v0 = _init(5, 3, 7)

    def run(**extra):
        return pt.sample_skeleton(ts, 150, x0, v0, seed=4, dtype=torch.float64,
                                  device="cpu", t_cap=64, **extra)

    ref = run()
    path = str(tmp_path / "rhmc.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        run(checkpoint_path=path, checkpoint_every=1)
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    got = run(checkpoint_path=path, checkpoint_every=1)
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)


def test_rhmc_streaming_matches_jax(monkeypatch):
    js, ts = pair(RHMC, "gauss", 3)
    x0, v0 = _init(4, 3, 9)
    kw = dict(n_samples=256, n_batches=8, seed=3, t_cap=256, grid_chunk=128)
    monkeypatch.setenv("PDMPFLUX_FORCE_STREAM", "1")
    ref = pf.sample_streaming_stats(js, 40.0, x0, v0, dtype=jnp.float64, **kw)
    te.reset_counts()
    got = pt.sample_streaming_stats(ts, 40.0, x0, v0, dtype=torch.float64, device="cpu", **kw)
    assert te.COUNTS["transitions"] > 0
    assert got.fills == ref.fills and got.events == ref.events
    for f in ref.stats._fields:
        a, b = np.asarray(getattr(ref.stats, f)), getattr(got.stats, f).numpy()
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f)
    summ, jsumm = pt.streaming_summary(got), pf.streaming_summary(ref)
    np.testing.assert_allclose(np.asarray(summ["mean"]), np.asarray(jsumm["mean"]), rtol=1e-10)


POTENTIALS = ["gauss_1d", "funnel", "neal_funnel", "ridged_gauss", "cauchy"]


@pytest.mark.parametrize("name", POTENTIALS)
def test_test_potentials_match_jax_and_run(name):
    d = 1 if name == "gauss_1d" else 4
    rs = np.random.default_rng(1)
    x = rs.normal(size=(16, d))
    if name == "funnel":
        x[:, 0] = np.abs(x[:, 0]) + 0.5  # the funnel needs x[0] > 0
    jU, tU = getattr(pf.utils.potentials, name), getattr(pt.potentials, name)
    # tagged: the kernels take it on CUDA, the engine its closed form
    assert tU.device_potential == {"gauss_1d": "gauss", "ridged_gauss": "ridged"}.get(name, name)
    for row in x:
        np.testing.assert_allclose(float(tU(torch.as_tensor(row))), float(jU(jnp.asarray(row))),
                                   rtol=1e-14)
        np.testing.assert_allclose(torch.func.grad(tU)(torch.as_tensor(row)).numpy(),
                                   np.asarray(jax.grad(jU)(jnp.asarray(row))), rtol=1e-12)
    sampler = pt.RHMCAD(d, tU)
    x0 = np.abs(x[:4]) + 0.5 if name == "funnel" else x[:4]
    skel = pt.sample_skeleton(sampler, 30, x0, np.zeros_like(x0), seed=0,
                              dtype=torch.float64, device="cpu")
    assert bool((skel.n_valid == 30).all())
    xs = pt.sample_from_skeleton_batch(sampler, 20, skel)
    assert xs.shape == (4, 20, d) and bool(torch.isfinite(xs).all())

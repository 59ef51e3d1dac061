"""The scalar-rate samplers of the port (BPS, Boomerang, Forward ECMC)
against the JAX package.

* (a) ``pdmpflux_tpu_torch.sample_skeleton(..., device="cpu")`` (K3/K5's and
  K2's plain versions) against the JAX fused-kernel path: the stream fills of
  ``make_pallas_stream_runner`` with the Pallas kernel interpreted, at fill
  sizes that force straggler fills (the Boomerang needs several transitions
  per event, so its calls merge several), each fill's event rows appended to
  its chain in numpy.  JAX's own ``merge_stream_at_offsets``, even in the two
  steps ``tests/test_torch_slice.py`` jits apart, zeroed one position row of
  chain 0 on XLA's CPU backend at these shapes (ROADMAP Queue 3); K2 is held
  to the JAX compaction in ``tests/test_torch_compact.py``.  float64: every
  Skeleton field to 1e-10, ``n_valid`` exactly, and the carried state.  The
  two sides add sums in other orders, and BPS and ECMC jumps amplify that
  along a trajectory (on the worst chain tenfold every five events, and every
  three on the banana Boomerang), so chains run 31 events here (15 on the
  Boomerang).
* (b) constructors: defaults, forced settings and error texts equal the JAX
  package's, and ``init_state_batch`` gives the JAX package's states.
* (c) laws on the plain path: BPS on an anisotropic Gaussian, the Boomerang
  and Forward ECMC on N(0, I) (ECMC keeps |v| = 1).
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
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402

D, B, N_SK, CHUNK, TILE, SEED = 4, 128, 32, 16, 128, 9
SCALES = np.array([0.5, 1.0, 2.0, 3.0])


def _pair(name):
    """(JAX sampler, port sampler, v0 speed) of a deployment at test size."""
    if name == "bps_aniso":
        return (pf.BPSAD(D, pf.utils.potentials.anisotropic_gauss(SCALES), refresh_rate=0.5),
                pt.BPSAD(D, pt.potentials.anisotropic_gauss(SCALES), refresh_rate=0.5), 1.0)
    if name == "boomerang_banana":
        return (pf.BoomerangAD(D, pf.utils.potentials.banana, refresh_rate=0.5, tmax=1.0),
                pt.BoomerangAD(D, pt.potentials.banana, refresh_rate=0.5, tmax=1.0), 1.0)
    return (pf.ForwardECMCAD(D, pf.utils.potentials.gauss),
            pt.ForwardECMCAD(D, pt.potentials.gauss), 1.0 / np.sqrt(D))


def _jax_path(sampler, x0, v0, t_cap, n_sk):
    """JAX's init states and stream fills; per chain, the init record and then
    every fill's event rows in order, cut at ``n_sk`` rows."""
    target = n_sk - 1
    keys = jax.random.split(jax.random.key(SEED), B)
    st = jax.vmap(lambda a, b, k: sampler.init_state(a, b, k, dtype=jnp.float64))(
        jnp.asarray(x0), jnp.asarray(v0), keys)
    init = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(st)
    run = jax.jit(pdrv.make_pallas_stream_runner(
        sampler, t_cap, target, chunk=CHUNK, tile=TILE, interpret=True))
    rows = {f: [[np.asarray(getattr(init, f))[b]] for b in range(B)]
            for f in init._fields}
    counts = jnp.zeros((B,), jnp.int32)
    fills = 0
    while not bool((np.asarray(counts) >= target).all()):
        res = run(st, engine.empty_stream(t_cap, D, jnp.float64, B), counts)
        st, counts = res.state, res.counts
        fills += 1
        stream = {f: np.asarray(getattr(res.stream, f)) for f in init._fields}
        for b in range(B):
            ev = stream["kind"][b] > 0
            for f in init._fields:
                rows[f][b].extend(stream[f][b][ev])
    ref = {f: np.stack([np.stack(r[:n_sk]) for r in rows[f]]) for f in init._fields}
    ref["n_valid"] = 1 + np.minimum(np.asarray(counts), target).astype(np.int32)
    return ref, st, fills


@pytest.mark.parametrize("name,t_cap,n_sk", [("bps_aniso", 32, N_SK),
                                             ("boomerang_banana", 32, 16),
                                             ("ecmc", 32, N_SK)])
def test_sample_skeleton_matches_jax_fused_path(name, t_cap, n_sk):
    js, ts, speed = _pair(name)
    rs = np.random.default_rng(t_cap)
    x0 = rs.normal(size=(B, D))
    v0 = rs.normal(size=(B, D))
    v0 *= speed / np.linalg.norm(v0, axis=1, keepdims=True)
    ref, ref_state, fills = _jax_path(js, x0, v0, t_cap, n_sk)
    assert fills >= 2  # straggler fills merged

    skel = pt.sample_skeleton(ts, n_sk, x0, v0, seed=SEED, dtype=torch.float64,
                              device="cpu", t_cap=t_cap, chunk=CHUNK, tile=TILE)
    got = convert.skeleton_to_numpy(skel)
    np.testing.assert_array_equal(got["n_valid"], ref["n_valid"])
    assert (got["n_valid"] == n_sk).all()
    for f, a in ref.items():
        assert got[f].shape == a.shape and got[f].dtype == a.dtype, f
        if a.dtype.kind in "f":
            np.testing.assert_allclose(got[f], a, rtol=1e-10, atol=1e-10, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)
    st = convert.state_to_numpy(ts.state)
    np.testing.assert_array_equal(st["key"], np.asarray(jax.random.key_data(ref_state.key)))
    np.testing.assert_allclose(st["v"], np.asarray(ref_state.v), rtol=1e-10, atol=1e-10)


def _config(s):
    keys = ("grid_size", "tmax", "refresh_rate", "vectorized_bound", "signed_bound",
            "adaptive", "gaussian_velocity", "ran_p", "mix_p", "switch", "positive",
            "speed_factor", "normal")
    return {k: getattr(s, k) for k in keys if hasattr(s, k)}


def test_constructors_match_jax():
    g = pt.potentials.grad_gauss
    pairs = [
        (pf.BPS(3, lambda x: x), pt.BPS(3, g)),
        (pf.BPS(3, lambda x: x, vectorized_bound=True, gaussian_velocity=True),
         pt.BPS(3, g, vectorized_bound=True, gaussian_velocity=True)),
        (pf.BPSAD(3, pf.utils.potentials.gauss), pt.BPSAD(3, pt.potentials.gauss)),
        (pf.Boomerang(3, lambda x: x), pt.Boomerang(3, g)),
        (pf.BoomerangAD(3, pf.utils.potentials.gauss), pt.BoomerangAD(3, pt.potentials.gauss)),
        (pf.ForwardECMC(3, lambda x: x), pt.ForwardECMC(3, g)),
        (pf.ForwardECMC(2, lambda x: x, mix_p=0.9), pt.ForwardECMC(2, g, mix_p=0.9)),
        (pf.ForwardECMCAD(5, pf.utils.potentials.gauss, ran_p=True, switch=False),
         pt.ForwardECMCAD(5, pt.potentials.gauss, ran_p=True, switch=False)),
    ]
    for js, ts in pairs:
        assert _config(ts) == _config(js), type(ts).__name__
        assert tdrv.kernel_kind(ts) == pdrv.kernel_kind(js)
    assert pt.ForwardECMC(2, g).mix_p == 0.0 and pt.ForwardECMC(3, g).refresh_rate == 0.0
    assert pt.BPSAD(3, pt.potentials.banana).device_potential == "banana"
    assert pt.BoomerangAD(3, lambda x: torch.sum(x * x) / 2).device_potential is None
    aniso = pt.BPSAD(3, pt.potentials.anisotropic_gauss([1.0, 2.0, 3.0]))
    assert aniso.device_potential == "aniso"
    np.testing.assert_array_equal(aniso.device_params.numpy(), [1.0, 2.0, 3.0])
    with pytest.raises(ValueError) as ej:
        pf.ForwardECMC(1, lambda x: x)
    with pytest.raises(ValueError) as et:
        pt.ForwardECMC(1, g)
    assert str(et.value) == str(ej.value)
    for pkg in (pf, pt):  # the reference's spelling is not accepted by either
        with pytest.raises(TypeError):
            pkg.BPS(3, g, Gaussian_velocity=True)


@pytest.mark.parametrize("name", ["bps_aniso", "boomerang_banana", "ecmc"])
def test_init_state_batch_matches_jax(name):
    js, ts, speed = _pair(name)
    rs = np.random.default_rng(1)
    x0, v0 = rs.normal(size=(6, D)), speed * rs.normal(size=(6, D))
    jst = js.init_state_batch(x0, v0, 17, dtype=jnp.float64)
    got = convert.state_to_numpy(ts.init_state_batch(x0, v0, 17, torch.float64, "cpu"))
    for f in jst._fields:
        a = (np.asarray(jax.random.key_data(jst.key)) if f == "key"
             else np.asarray(getattr(jst, f)))
        assert got[f].dtype == a.dtype and got[f].shape == a.shape, f
        if f == "exp_rv":  # XLA's CPU log1p vs a correctly rounded one
            np.testing.assert_allclose(got[f], a, rtol=1e-12)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)


def test_bps_anisotropic_variances():
    s = np.array([0.5, 1.5, 3.0])
    sampler = pt.BPSAD(3, pt.potentials.anisotropic_gauss(s), refresh_rate=0.5)
    skel = pt.sample_skeleton(sampler, 1500, np.zeros((64, 3)), np.ones((64, 3)),
                              seed=4, dtype=torch.float64, device="cpu")
    assert (skel.n_valid == 1500).all() and (torch.diff(skel.t, dim=1) >= 0).all()
    mean, var = pt.pooled_moments(skel, sampler, 500)
    assert (mean.abs().numpy() < 0.15 * s).all(), mean
    np.testing.assert_allclose(var.numpy() / s ** 2, 1.0, atol=0.15)


@pytest.mark.parametrize("name", ["boomerang", "ecmc"])
def test_standard_gaussian_moments(name):
    d = 4
    if name == "boomerang":
        sampler, speed = pt.Boomerang(d, pt.potentials.grad_gauss, refresh_rate=0.5), 1.0
    else:
        sampler, speed = pt.ForwardECMCAD(d, pt.potentials.gauss), 1 / np.sqrt(d)
    skel = pt.sample_skeleton(sampler, 800, np.zeros((64, d)), np.full((64, d), speed),
                              seed=5, dtype=torch.float64, device="cpu")
    assert (skel.n_valid == 800).all()
    mean, var = pt.pooled_moments(skel, sampler, 400)
    assert (mean.abs() < 0.12).all(), mean
    assert ((var - 1).abs() < 0.12).all(), var
    if name == "ecmc":
        np.testing.assert_allclose(torch.linalg.norm(skel.v, dim=-1).numpy(), 1.0, atol=1e-12)

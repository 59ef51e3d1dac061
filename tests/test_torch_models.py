"""The port's sampler construction against the JAX package's: flag
resolution, error texts, potential handling, initial states, converters."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.core import engine  # noqa: E402
from pdmpflux_tpu_torch.models.base import resolve_potential  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as k3  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as k1  # noqa: E402

FLAGS = ("dim", "grid_size", "tmax", "refresh_rate", "vectorized_bound",
         "signed_bound", "adaptive", "tderiv")


@pytest.mark.parametrize("kw", [
    dict(),
    dict(tmax=0.0, adaptive=False),
    dict(vectorized_bound=False),
    dict(grid_size=0, refresh_rate=0.5),
    dict(AD_backend="FiniteDiff"),
])
def test_flag_resolution_matches_jax(kw):
    with warnings.catch_warnings(record=True) as wj:
        warnings.simplefilter("always")
        js = pf.ZigZag(3, lambda x: x, **kw)
    with warnings.catch_warnings(record=True) as wt:
        warnings.simplefilter("always")
        ts = pt.ZigZag(3, pt.potentials.grad_gauss, **kw)
    assert [str(w.message) for w in wt] == [str(w.message) for w in wj]
    for f in FLAGS:
        assert getattr(ts, f) == getattr(js, f), f


@pytest.mark.parametrize("kw", [dict(dim=0), dict(dim=2, grid_size=-1)])
def test_constructor_errors_match_jax(kw):
    d = kw.pop("dim")
    with pytest.raises(ValueError) as ej:
        pf.ZigZag(d, lambda x: x, **kw)
    with pytest.raises(ValueError) as et:
        pt.ZigZag(d, pt.potentials.grad_gauss, **kw)
    assert str(et.value) == str(ej.value)


def test_resolve_potential_rules():
    x = torch.tensor([0.3, -1.2, 2.0], dtype=torch.float64)
    # a (dim,) output is already a gradient
    U_vec, g = resolve_potential(lambda z: 2 * z, 3)
    assert U_vec is None and torch.equal(g(x), 2 * x)
    # scalar potential: autodiff
    U_vec, g = resolve_potential(pt.potentials.banana, 3)
    np.testing.assert_allclose(g(x).numpy(), pt.potentials.grad_banana(x).numpy(),
                               rtol=1e-14)
    jg = jax.grad(pf.utils.potentials.banana)(jnp.asarray(x.numpy()))
    np.testing.assert_allclose(g(x).numpy(), np.asarray(jg), rtol=1e-14)
    # d = 1: a scalar potential, and a (1,)-output read as a potential,
    # exactly as the JAX package reads them
    from pdmpflux_tpu.models.base import resolve_potential as jresolve

    for tU, jU in ((lambda s: torch.sum(s * s) / 2, lambda s: jnp.sum(s * s) / 2),
                   (lambda s: torch.reshape(3 * s ** 2, (1,)),
                    lambda s: jnp.reshape(3 * s ** 2, (1,)))):
        _, g1 = resolve_potential(tU, 1)
        _, jg1 = jresolve(jU, 1)
        assert float(g1(torch.tensor([1.5], dtype=torch.float64))[0]) == float(
            jg1(jnp.asarray([1.5]))[0])
    with pytest.raises(ValueError, match="Could not interpret potential"):
        resolve_potential(lambda z: torch.ones(2, 2), 3)


def test_device_potential_tags():
    assert pt.ZigZag(3, pt.potentials.grad_gauss).device_potential == "gauss"
    assert pt.ZigZagAD(3, pt.potentials.gauss).device_potential == "gauss"
    assert pt.ZigZagAD(3, pt.potentials.banana).device_potential == "banana"
    assert pt.ZigZag(3, lambda x: x).device_potential is None


def test_kernel_coverage_errors():
    ok = pt.ZigZag(3, pt.potentials.grad_gauss)
    assert tdrv.kernel_kind(ok) == "zigzag"
    with pytest.raises(ValueError, match="vectorized_bound=True"):
        tdrv.chunk_config(pt.ZigZag(3, pt.potentials.grad_gauss,
                                    vectorized_bound=False), 32, 10, 128)
    # no kernel covers scalar bounds: sample_skeleton takes the transition
    # engine for them and runs
    scalar = pt.ZigZag(3, pt.potentials.grad_gauss, vectorized_bound=False)
    assert tapi.pick_backend(scalar, "auto", 3, torch.float64, "cpu") == "engine"
    engine.reset_counts()
    skel = pt.sample_skeleton(scalar, 5, np.zeros(3), np.ones(3), seed=1,
                              dtype=torch.float64, device="cpu")
    assert engine.COUNTS["transitions"] > 0 and int(skel.n_valid) == 5


def test_engine_route_takes_its_fixed_chunk():
    """The engine runs chunks of ``engine.CHUNK`` transitions whatever
    ``chunk`` the caller gives; a ``t_cap`` that is not a multiple of it
    raises naming that chunk, and a multiple of it runs."""
    scalar = pt.ZigZag(3, pt.potentials.grad_gauss, vectorized_bound=False)
    kw = dict(seed=1, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match=f"chunks of {engine.CHUNK} transitions"):
        pt.sample_skeleton(scalar, 5, np.zeros(3), np.ones(3), t_cap=96, **kw)
    engine.reset_counts()
    skel = pt.sample_skeleton(scalar, 5, np.zeros(3), np.ones(3), t_cap=128, chunk=16, **kw)
    assert int(skel.n_valid) == 5
    assert engine.COUNTS["transitions"] == engine.COUNTS["chunks"] * engine.CHUNK > 0


def _route_samplers(d):
    g = pt.potentials.grad_gauss
    return {
        "zigzag": pt.ZigZag(d, g),
        "zigzag_scalar": pt.ZigZag(d, g, vectorized_bound=False),
        "sticky": pt.StickyZigZag(d, g, np.ones(d)),
        "sticky_scalar": pt.StickyZigZag(d, g, np.ones(d), vectorized_bound=False),
        "suzz": pt.SpeedUpZigZag(d, g),
        "suzz_scalar": pt.SpeedUpZigZag(d, g, vectorized_bound=False),
        "bps": pt.BPS(d, g),
        "boomerang": pt.Boomerang(d, g),
        "ecmc": pt.ForwardECMC(d, g),
        "rhmc": pt.RHMC(d, g),
    }


KERNEL_ROUTES = {"zigzag", "sticky", "suzz", "bps", "boomerang", "ecmc"}


@pytest.mark.parametrize("backend", ["auto", "xla", "xla_stream", "pallas"])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_pick_backend_routes_every_sampler(backend, device, monkeypatch):
    """Every sampler under every backend value, on the CPU and (decided
    without a card) on CUDA, with the shared-memory limits the built kernels
    report there (K3/K5: 1210 in float32, K6: 1500)."""
    monkeypatch.setattr(k3, "scalar_max_dim", lambda dt, user=None: 1210)
    monkeypatch.setattr(k1, "sticky_max_dim", lambda dt: 1500)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        samplers = _route_samplers(4)
    for name, s in samplers.items():
        kernel = name in KERNEL_ROUTES
        if backend in ("xla", "xla_stream"):
            want = "engine"
        elif backend == "pallas" and not kernel:
            with pytest.raises(ValueError) as err:
                tapi.pick_backend(s, backend, 4, torch.float32, device)
            assert str(err.value) == (
                "backend='pallas' covers ZigZag/StickyZigZag/SpeedUpZigZag "
                "(vectorized bounds), BPS, Boomerang and ForwardECMC; "
                f"{type(s).__name__} runs on backend='xla'")
            continue
        else:
            want = "kernel" if kernel else "engine"
        assert tapi.pick_backend(s, backend, 4, torch.float32, device) == want, name


def test_pallas_refusal_matches_jax_text():
    js = pf.RHMC(3, lambda x: x)
    with pytest.raises(ValueError) as ej:
        pf.sample_skeleton(js, 5, np.zeros(3), np.ones(3), backend="pallas")
    with pytest.raises(ValueError) as et:
        pt.sample_skeleton(pt.RHMC(3, pt.potentials.grad_gauss), 5, np.zeros(3),
                           np.ones(3), device="cpu", backend="pallas")
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="backend must be one of"):
        tapi.pick_backend(pt.ZigZag(3, pt.potentials.grad_gauss), "triton", 3,
                          torch.float32, "cpu")


def test_pick_backend_shape_limits_on_cuda(monkeypatch):
    """On CUDA the kernels' shared memory and grid limits send "auto" to the
    engine and make "pallas" raise; the CPU's plain versions have none."""
    monkeypatch.setattr(k3, "scalar_max_dim",
                        lambda dt, user=None: 1210 if dt == torch.float32 else 605)
    monkeypatch.setattr(k1, "sticky_max_dim", lambda dt: 1500 if dt == torch.float32 else 1200)
    g = pt.potentials.grad_gauss
    cases = [(pt.BPS(700, g), 700, torch.float32, "kernel"),
             (pt.BPS(700, g), 700, torch.float64, "engine"),
             (pt.ForwardECMC(1211, g), 1211, torch.float32, "engine"),
             (pt.StickyZigZag(1300, g), 1300, torch.float32, "kernel"),
             (pt.StickyZigZag(1300, g), 1300, torch.float64, "engine"),
             (pt.ZigZag(5000, g), 5000, torch.float64, "kernel"),
             (pt.SpeedUpZigZag(5000, g), 5000, torch.float64, "kernel"),
             (pt.ZigZag(4, g, grid_size=64), 4, torch.float32, "kernel"),
             (pt.ZigZag(4, g, grid_size=65), 4, torch.float32, "engine")]
    for s, d, dt, want in cases:
        assert tapi.pick_backend(s, "auto", d, dt, "cuda") == want, (type(s), d, dt)
        assert tapi.pick_backend(s, "auto", d, dt, "cpu") == "kernel"
        if want == "engine":
            with pytest.raises(ValueError, match="backend='xla_stream' here"):
                tapi.pick_backend(s, "pallas", d, dt, "cuda")
        else:
            assert tapi.pick_backend(s, "pallas", d, dt, "cuda") == "kernel"


def test_untagged_gradient_on_cuda_names_the_engine(monkeypatch):
    """An untagged gradient that a kernel covers is lowered into a generated
    potential and takes the kernel on CUDA under "auto" and "pallas", a
    dense ``A @ x`` included; one the lowering cannot express (a running
    product, ``cumprod``) raises there, naming the aten op and backend="xla_stream";
    that backend, and the CPU, run all three.  Every tag runs on every
    kernel: ``aniso`` on K1 and K3."""
    monkeypatch.setattr(k3, "scalar_max_dim", lambda dt, user=None: 1210)
    A = torch.tensor([[2.0, 0.5, 0.0], [0.5, 1.0, 0.2], [0.0, 0.2, 3.0]], dtype=torch.float64)
    for make in (lambda g: pt.ZigZag(3, g), lambda g: pt.BPS(3, g),
                 lambda g: pt.SpeedUpZigZag(3, g)):
        s, dense = make(lambda x: x), make(lambda x: A.to(x) @ x)
        refused = make(lambda x: x + 0.1 * torch.cumprod(torch.tanh(x), 0))
        for backend in ("auto", "pallas"):
            for g in (s, dense):
                assert tapi.pick_backend(g, backend, 3, torch.float32, "cuda") == "kernel"
            with pytest.raises(ValueError, match="aten.cumprod") as err:
                tapi.pick_backend(refused, backend, 3, torch.float32, "cuda")
            assert "backend='xla_stream'" in str(err.value)
        for g in (s, dense, refused):
            assert tapi.pick_backend(g, "xla_stream", 3, torch.float32, "cuda") == "engine"
            assert tapi.pick_backend(g, "auto", 3, torch.float32, "cpu") == "kernel"
    for aniso in (pt.BPSAD(3, pt.potentials.anisotropic_gauss([1.0, 2.0, 3.0])),
                  pt.ZigZagAD(3, pt.potentials.anisotropic_gauss([1.0, 2.0, 3.0]))):
        assert tapi.pick_backend(aniso, "auto", 3, torch.float32, "cuda") == "kernel"


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_init_state_batch_matches_jax(dtype):
    B, d = 6, 4
    rs = np.random.default_rng(0)
    x0, v0 = rs.normal(size=(B, d)), rs.choice([-1.0, 1.0], size=(B, d))
    js = pf.ZigZag(d, lambda x: x, tmax=1.5)
    ts = pt.ZigZag(d, pt.potentials.grad_gauss, tmax=1.5)
    jst = js.init_state_batch(x0, v0, 17, dtype=getattr(jnp, dtype))
    tst = ts.init_state_batch(x0, v0, 17, dtype=getattr(torch, dtype), device="cpu")
    got = convert.state_to_numpy(tst)
    for f in jst._fields:
        a = (np.asarray(jax.random.key_data(jst.key)) if f == "key"
             else np.asarray(getattr(jst, f)))
        assert got[f].dtype == a.dtype and got[f].shape == a.shape, f
        if f == "exp_rv":  # XLA's CPU log1p vs a correctly rounded one
            np.testing.assert_allclose(got[f], a, rtol=1e-6 if dtype == "float32" else 1e-12)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)
    # one chain's init_state equals the batch's chain
    from pdmpflux_tpu_torch.core import rng

    one = ts.init_state(x0[2], v0[2], rng.split(rng.key(17), B)[2],
                        dtype=getattr(torch, dtype), device="cpu")
    assert torch.equal(one.exp_rv, tst.exp_rv[2])
    # round trip through the converters
    back = convert.state_to_numpy(convert.state_from_numpy(got, device="cpu"))
    for f in got:
        np.testing.assert_array_equal(back[f], got[f])


def test_types_helpers_match_jax():
    from pdmpflux_tpu.core import types as jt
    from pdmpflux_tpu_torch.core import types as tt

    for name in ("MODE_FRESH", "MODE_REJECTED", "MODE_ERRONEOUS", "EV_NONE",
                 "EV_INIT", "EV_JUMP", "EV_STICK", "EV_THAW", "EV_TERMINAL",
                 "ERROR_RING_SIZE"):
        assert getattr(tt, name) == getattr(jt, name), name
    for name in ("PDMPState", "Event", "Skeleton"):
        assert getattr(tt, name)._fields == getattr(jt, name)._fields, name
    js = jt.empty_skeleton(7, 3, jnp.float64, batch_shape=(2,))
    ts = tt.empty_skeleton(7, 3, torch.float64, batch_shape=(2,))
    got = convert.skeleton_to_numpy(ts)
    for f in js._fields:
        a = np.asarray(getattr(js, f))
        assert got[f].dtype == a.dtype and got[f].shape == a.shape, f
        np.testing.assert_array_equal(got[f], a)
    back = convert.skeleton_to_numpy(convert.skeleton_from_numpy(got, device="cpu"))
    for f in got:
        np.testing.assert_array_equal(back[f], got[f])
    tot, comp = np.float32(1.0), np.float32(0.0)
    s_t, c_t = tt.kahan_add(torch.tensor(tot), torch.tensor(comp), torch.tensor(np.float32(1e-8)))
    s_j, c_j = jt.kahan_add(jnp.float32(tot), jnp.float32(comp), jnp.float32(1e-8))
    assert float(s_t) == float(s_j) and float(c_t) == float(c_j)


def test_init_state_defaults_to_the_card():
    """``init_state`` and ``init_state_batch`` default to ``device="cuda"``,
    as every entry point of the port does, and raise without a card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sampler = pt.BPS(3, pt.potentials.grad_gauss)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sampler.init_state_batch(np.zeros((2, 3)), np.ones((2, 3)), 0)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        sampler.init_state(np.zeros(3), np.ones(3), 0)


def test_converters_default_to_the_card():
    """``convert.state_from_numpy`` and ``skeleton_from_numpy`` carry the JAX
    package's records onto the card by default, and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sampler = pt.ZigZag(3, pt.potentials.grad_gauss)
    state = convert.state_to_numpy(sampler.init_state_batch(
        np.zeros((2, 3)), np.ones((2, 3)), 0, torch.float64, "cpu"))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        convert.state_from_numpy(state)
    from pdmpflux_tpu_torch.core.types import empty_skeleton

    skel = convert.skeleton_to_numpy(empty_skeleton(4, 3, torch.float64))
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        convert.skeleton_from_numpy(skel)

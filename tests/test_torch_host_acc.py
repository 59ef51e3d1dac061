"""Host accumulation of ``sample_skeleton`` (``api._HostRows``) against the
JAX package's host path and against the port's own on-device path, float64
on the CPU.

* Against JAX: ``PDMPFLUX_STREAM_HOST_ACC=1`` with ``PDMPFLUX_FORCE_STREAM=1``
  (JAX's stream paths off the TPU run its XLA engine), against the port's
  transition engine (``backend="xla_stream"``), for the Zig-Zag, the Sticky
  Zig-Zag and RHMC, in both modes; ``PDMPFLUX_DEVICE_BYTES=1000`` makes both
  packages size 64-row fills, so chains straggle across fills.  Integers
  equal, floats to rtol 1e-12 (rounding order only, as
  ``test_torch_engine_scalar.py`` holds the engine); a time horizon's width
  is JAX's ``n_valid.max()``.
* Against the device path: the chunk kernels' plain versions (K1, K6, K3),
  the same fill rows, every field bit for bit up to ``n_valid``.
* A resume on the host path after ``PDMPFLUX_FAIL_AFTER_FILLS`` is bit for
  bit, and a checkpoint of either path resumes on the other.
* A CUDA out-of-memory error on the device path reruns on the host path
  with JAX's warning and gives the same skeleton.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402

RTOL = ATOL = 1e-12
F64 = dict(dtype=torch.float64, device="cpu")


def _pair(name, d):
    """The same sampler in both packages."""
    if name == "zigzag":
        return pf.ZigZag(d, lambda x: x), pt.ZigZag(d, pt.potentials.grad_gauss)
    if name == "sticky":
        kappa = np.full(d, 2.0)
        return (pf.StickyZigZag(d, lambda x: x, kappa),
                pt.StickyZigZag(d, pt.potentials.grad_gauss, kappa))
    if name == "bps":
        return None, pt.BPS(d, pt.potentials.grad_gauss, refresh_rate=0.5)
    return pf.RHMCAD(d, pf.utils.potentials.gauss), pt.RHMCAD(d, pt.potentials.gauss)


def _init(name, B, d, seed=0):
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(B, d)) * (0.3 if name == "sticky" else 1.0)
    v0 = rs.normal(size=(B, d)) if name == "rhmc" else rs.choice([-1.0, 1.0], size=(B, d))
    return x0, v0


def _assert_matches_jax(got, want):
    g = convert.skeleton_to_numpy(got)
    for f in want._fields:
        a, b = np.asarray(getattr(want, f)), g[f]
        assert a.shape == b.shape and a.dtype == b.dtype, (f, a.shape, b.shape)
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)


CASES = [("zigzag", 60), ("sticky", 150), ("rhmc", 40), ("zigzag", 40.0), ("rhmc", 60.0)]


@pytest.mark.parametrize("name,n_or_T", CASES)
def test_host_path_matches_jax_host_path(monkeypatch, name, n_or_T):
    d, B = 3, 6
    js, ts = _pair(name, d)
    x0, v0 = _init(name, B, d)
    monkeypatch.setenv("PDMPFLUX_STREAM_HOST_ACC", "1")
    monkeypatch.setenv("PDMPFLUX_FORCE_STREAM", "1")
    monkeypatch.setenv("PDMPFLUX_DEVICE_BYTES", "1000")
    want = pf.sample_skeleton(js, n_or_T, x0, v0, seed=4, dtype=jnp.float64, init_capacity=64)
    tapi.HOST_ACC.clear()
    got = pt.sample_skeleton(ts, n_or_T, x0, v0, seed=4, backend="xla_stream",
                             init_capacity=64, **F64)
    assert tapi.HOST_ACC["fills"] > 1 and got.t.device.type == "cpu"
    _assert_matches_jax(got, want)
    if isinstance(n_or_T, float):
        assert got.t.shape[1] == int(got.n_valid.max())
    np.testing.assert_array_equal(convert.state_to_numpy(ts.state)["key"],
                                  np.asarray(jax.random.key_data(js.state.key)))


@pytest.mark.parametrize("n_or_T", [160, 40.0])
@pytest.mark.parametrize("name", ["zigzag", "sticky", "bps"])
def test_host_path_equals_device_path_bit_for_bit(monkeypatch, name, n_or_T):
    """The chunk kernels' plain versions, fills of 64 rows (stragglers):
    each field equal up to ``n_valid``; the event-count skeletons are equal
    whole, and the samples drawn from them too."""
    d, B = 4, 16
    _, ts = _pair(name, d)
    x0, v0 = _init(name, B, d, seed=1)
    kw = dict(seed=7, t_cap=64, **F64)
    dev = pt.sample_skeleton(ts, n_or_T, x0, v0, **kw)
    monkeypatch.setenv("PDMPFLUX_STREAM_HOST_ACC", "1")
    tapi.HOST_ACC.clear()
    host = pt.sample_skeleton(ts, n_or_T, x0, v0, **kw)
    assert tapi.HOST_ACC["fills"] > 1
    assert torch.equal(host.n_valid, dev.n_valid)
    W = host.t.shape[1]
    for f, a, b in zip(host._fields, host, dev):
        assert torch.equal(a, b if f == "n_valid" else b[:, :W]), f
    if isinstance(n_or_T, int):
        assert W == dev.t.shape[1]
        assert torch.equal(pt.sample_from_skeleton_batch(ts, 50, host),
                           pt.sample_from_skeleton_batch(ts, 50, dev))
    else:
        assert W == int(host.n_valid.max()) and not dev.t[:, W:].any()


def _run(ts, path=None, **kw):
    x0, v0 = _init("zigzag", 8, 3, seed=2)
    ck = dict(checkpoint_path=path, checkpoint_every=1) if path else {}
    return pt.sample_skeleton(ts, 200, x0, v0, seed=5, t_cap=64, **ck, **kw, **F64)


@pytest.mark.parametrize("writer,reader", [("host", "host"), ("device", "host"),
                                           ("host", "device")])
def test_resume_across_accumulations_is_bit_for_bit(monkeypatch, tmp_path, writer, reader):
    """Interrupted after two fills on one accumulation, resumed on the
    other (or the same): the skeleton of the unbroken run, bit for bit."""
    _, ts = _pair("zigzag", 3)
    ref = _run(ts)
    path = str(tmp_path / "run.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    monkeypatch.setenv("PDMPFLUX_STREAM_HOST_ACC", "1" if writer == "host" else "0")
    with pytest.raises(RuntimeError, match="fault injection"):
        _run(ts, path)
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    monkeypatch.setenv("PDMPFLUX_STREAM_HOST_ACC", "1" if reader == "host" else "0")
    tapi.HOST_ACC.clear()
    got = _run(ts, path)
    assert (tapi.HOST_ACC["fills"] > 0) == (reader == "host")
    for a, b in zip(got, ref):
        assert a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("n_or_T", [200, 40.0])
def test_device_oom_retries_on_the_host(monkeypatch, n_or_T):
    """A CUDA out-of-memory error during on-device accumulation: JAX's
    warning, and the host path's skeleton, equal to the device path's."""
    _, ts = _pair("zigzag", 3)
    x0, v0 = _init("zigzag", 8, 3, seed=3)
    kw = dict(seed=6, t_cap=64, **F64)
    ref = pt.sample_skeleton(ts, n_or_T, x0, v0, **kw)
    name = "_events_fill" if isinstance(n_or_T, int) else "_horizon_fills"

    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")

    monkeypatch.setattr(tapi, name, oom)
    tapi.HOST_ACC.clear()
    with pytest.warns(UserWarning, match="device OOM during on-device .* retrying with host "
                                         "accumulation"):
        got = pt.sample_skeleton(ts, n_or_T, x0, v0, **kw)
    assert tapi.HOST_ACC["fills"] > 1
    W = got.t.shape[1]
    for f, a, b in zip(got._fields, got, ref):
        assert torch.equal(a, b if f == "n_valid" else b[:, :W]), f


def test_other_errors_are_not_retried(monkeypatch):
    _, ts = _pair("zigzag", 3)

    def broken(*a, **k):
        raise RuntimeError("not an out-of-memory error")

    monkeypatch.setattr(tapi, "_events_fill", broken)
    with pytest.raises(RuntimeError, match="not an out-of-memory"):
        _run(ts)

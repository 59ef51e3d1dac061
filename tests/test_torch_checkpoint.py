"""Checkpoint/resume of the port (``pdmpflux_tpu_torch.parallel.checkpoint``
and ``sample_skeleton(checkpoint_path=...)``) against the JAX package.

* A run interrupted by ``PDMPFLUX_FAIL_AFTER_FILLS`` and resumed from its
  file equals the unbroken run bit for bit (float64), for the Zig-Zag and
  the Sticky Zig-Zag, in event-count and time-horizon modes.
* A file written for another run raises the JAX package's message (JAX's
  own loader raises the same text on the same file).
* The files are the JAX package's: a file the port writes loads through
  ``pdmpflux_tpu.parallel.checkpoint.load_checkpoint`` with equal arrays,
  the key's uint32 words included, and a file JAX writes loads in the port.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.parallel import checkpoint as jckpt  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.core.types import PDMPState, Skeleton  # noqa: E402
from pdmpflux_tpu_torch.parallel import checkpoint as tckpt  # noqa: E402

B, D = 6, 3


def _sampler(name):
    if name == "zigzag":
        return pt.ZigZag(D, pt.potentials.grad_gauss)
    return pt.StickyZigZag(D, pt.potentials.grad_gauss, np.full(D, 2.0))


def _init():
    rs = np.random.default_rng(2)
    return rs.normal(size=(B, D)) * 0.4, rs.choice([-1.0, 1.0], size=(B, D))


# event count: 64-row fills for 160 events; time horizon: 32-row fills to T = 40
TARGETS = {"events": (160, dict(t_cap=64)), "horizon": (40.0, dict(t_cap=32))}


def _run(name, mode, **kw):
    n_or_T, extra = TARGETS[mode]
    x0, v0 = _init()
    return pt.sample_skeleton(_sampler(name), n_or_T, x0, v0, seed=5, dtype=torch.float64,
                              device="cpu", **extra, **kw)


@pytest.mark.parametrize("mode", ["events", "horizon"])
@pytest.mark.parametrize("name", ["zigzag", "sticky"])
def test_resume_after_injected_failure_is_bit_for_bit(monkeypatch, tmp_path, name, mode):
    ref = _run(name, mode)
    path = str(tmp_path / "run.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        _run(name, mode, checkpoint_path=path, checkpoint_every=1)
    _, _, meta = tckpt.load_checkpoint(path, "cpu")
    target = TARGETS[mode][0] - 1 if mode == "events" else TARGETS[mode][0]
    assert meta == {"mode": mode, "target": target, "fills": 2}
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    got = _run(name, mode, checkpoint_path=path, checkpoint_every=1)
    for f in Skeleton._fields:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.shape == b.shape and torch.equal(a, b), f


@pytest.mark.parametrize("mode", ["events", "horizon"])
def test_checkpoint_of_another_run_raises_jax_message(monkeypatch, tmp_path, mode):
    path = str(tmp_path / "run.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        _run("zigzag", mode, checkpoint_path=path, checkpoint_every=1)
    monkeypatch.delenv("PDMPFLUX_FAIL_AFTER_FILLS")
    other = 150 if mode == "events" else 41.0
    x0, v0 = _init()
    with pytest.raises(ValueError, match="delete it to start fresh") as got:
        pt.sample_skeleton(_sampler("zigzag"), other, x0, v0, seed=5, dtype=torch.float64,
                           device="cpu", checkpoint_path=path, **TARGETS[mode][1])
    # JAX's target is the event count beyond the initial record, or T
    with pytest.raises(ValueError) as ref:
        pf.api._load_stream_checkpoint(path, mode, other - 1 if mode == "events" else other)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("mode", ["events", "horizon"])
def test_port_checkpoint_loads_in_jax(monkeypatch, tmp_path, mode):
    """The port's stream-loop file loads through JAX's loader: every state
    and accumulator array equal, the key as JAX's uint32 words."""
    path = str(tmp_path / "run.npz")
    monkeypatch.setenv("PDMPFLUX_FAIL_AFTER_FILLS", "2")
    with pytest.raises(RuntimeError, match="fault injection"):
        _run("sticky", mode, checkpoint_path=path, checkpoint_every=1)
    state, acc, meta = tckpt.load_checkpoint(path, "cpu")
    jstate, jacc, jmeta = jckpt.load_checkpoint(path)
    assert jmeta == meta
    for f in PDMPState._fields:
        a = getattr(state, f).numpy()
        b = np.asarray(jax.random.key_data(jstate.key)) if f == "key" else np.asarray(
            getattr(jstate, f))
        if f == "key":
            assert b.dtype == np.uint32
            a = a.astype(np.uint32)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in Skeleton._fields:
        a, b = getattr(acc, f).numpy(), np.asarray(getattr(jacc, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    # the accumulator's layout is JAX's: the event count's keeps the initial
    # record in column 0, the horizon's holds events only
    assert (acc.n_valid.numpy() > 0).all()
    if mode == "events":
        assert (acc.kind[:, 0] == pt.EV_INIT).all()
    else:
        assert (acc.kind[:, 0] > pt.EV_INIT).all()


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """``save_checkpoint``/``load_checkpoint`` round trips, both ways."""
    js = pf.ZigZag(D, lambda x: x)
    x0, v0 = _init()
    jstate = js.init_state_batch(x0, v0, 9, dtype=jnp.float64)
    jskel = pf.sample_skeleton(js, 20, x0, v0, seed=9)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, jstate, jskel, meta={"round": 1})
    state, skel, meta = tckpt.load_checkpoint(path, "cpu")
    assert meta == {"round": 1}
    ref = convert.state_from_numpy(
        {f: (np.asarray(jax.random.key_data(jstate.key)) if f == "key"
             else np.asarray(getattr(jstate, f))) for f in PDMPState._fields}, "cpu")
    for a, b in zip(state, ref):
        assert torch.equal(a, b)
    for f in Skeleton._fields:
        np.testing.assert_array_equal(getattr(skel, f).numpy(), np.asarray(getattr(jskel, f)))
    path2 = str(tmp_path / "port.npz")
    tckpt.save_checkpoint(path2, state)
    state2, skel2, meta2 = tckpt.load_checkpoint(path2, "cpu")
    assert skel2 is None and meta2 == {}
    for a, b in zip(state2, state):
        assert torch.equal(a, b)


def test_load_checkpoint_defaults_to_the_card(tmp_path):
    path = str(tmp_path / "s.npz")
    s = _sampler("zigzag")
    x0, v0 = _init()
    tckpt.save_checkpoint(path, s.init_state_batch(x0, v0, 1, torch.float64, "cpu"))
    if torch.cuda.is_available():
        state, _, _ = tckpt.load_checkpoint(path)
        assert state.x.is_cuda
    else:
        with pytest.raises(RuntimeError, match="asked for CUDA"):
            tckpt.load_checkpoint(path)

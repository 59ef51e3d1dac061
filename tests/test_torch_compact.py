"""K2's plain PyTorch version against the JAX package's compactions.

K2 must be exactly equal (bit for bit, every field) to both JAX
formulations of ``engine.compact_stream_rows`` — the XLA log-shift at
d = 10 and the row gather at d = 128 — to ``compact_stream_rows_with_init``,
to ``merge_stream_at_offsets``, and to the Pallas ``compact.compact_field``
in interpret mode.  The raw fill is random, in the JAX ``(B, T, ...)``
layout, and handed to the port in its chain-minor fill layout.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pdmpflux_tpu.core import engine  # noqa: E402
from pdmpflux_tpu.core.types import Event, Skeleton as JSkeleton  # noqa: E402
from pdmpflux_tpu.ops.pallas import compact as pc  # noqa: E402
from pdmpflux_tpu_torch.core.types import Event as TEvent  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import compact as k2  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda.zigzag_chunk import RawFill  # noqa: E402
from test_torch_slice import _jax_merge  # noqa: E402

B, T = 9, 40
FIELDS = [f for f in JSkeleton._fields if f != "n_valid"]


def _stream(d, seed, active="ones", B=B, T=T):
    """A random raw fill (kinds 0 or 2; chain 0 has no event, chain 1 only
    events) as a JAX stream and as the port's RawFill (with the activity
    stream when it is random)."""
    rs = np.random.default_rng(seed)
    kind = np.where(rs.random((B, T)) < 0.55, 2, 0).astype(np.int32)
    kind[0] = 0
    kind[1] = 2
    f = lambda *s: rs.normal(size=(B, T) + s)  # noqa: E731
    i = lambda: rs.integers(0, 50, size=(B, T)).astype(np.int32)  # noqa: E731
    act = (np.ones((B, T, d), bool) if active == "ones"
           else rs.random((B, T, d)) < 0.5)
    s = dict(x=f(d), v=f(d), t=f(), horizon=f(), ar=f(), is_active=act,
             rejected=i(), errored_bound=i(), hitting_horizon=i(),
             error_value_ar=f(5), kind=kind)
    stream = JSkeleton(**{k: jnp.asarray(a) for k, a in s.items()},
                       n_valid=jnp.full((B,), T, jnp.int32))
    tt = lambda a: torch.tensor(np.ascontiguousarray(np.moveaxis(a, 0, -1)))  # noqa: E731
    fill = RawFill(
        kind=tt(np.stack([kind, s["rejected"], s["errored_bound"],
                          s["hitting_horizon"]], axis=2)),
        x=tt(s["x"]), v=tt(s["v"]),
        fs=tt(np.stack([s["t"], s["horizon"], s["ar"]], axis=2)),
        ring=tt(s["error_value_ar"]),
        act=None if active == "ones" else tt(act),
    )
    return stream, fill, s


def _init(d, seed, B=B):
    rs = np.random.default_rng(seed + 1)
    e = dict(kind=np.full(B, 1, np.int32), x=rs.normal(size=(B, d)),
             v=rs.normal(size=(B, d)), t=np.zeros(B), horizon=rs.random(B),
             ar=rs.random(B), is_active=np.ones((B, d), bool),
             rejected=np.zeros(B, np.int32), errored_bound=np.ones(B, np.int32),
             hitting_horizon=np.zeros(B, np.int32),
             error_value_ar=rs.normal(size=(B, 5)))
    return (Event(**{k: jnp.asarray(a) for k, a in e.items()}),
            TEvent(**{k: torch.tensor(a) for k, a in e.items()}))


def _assert_equal(jskel, tskel):
    for f in FIELDS:
        a = np.asarray(getattr(jskel, f))
        b = getattr(tskel, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("d", [10, 128])
@pytest.mark.parametrize("n_keep", [T, 25, 64])
def test_compact_stream_rows(d, n_keep):
    stream, fill, _ = _stream(d, d + n_keep)
    ref = engine.compact_stream_rows(stream, n_keep)
    out = k2.compact_fill(fill, k2.empty_rows(B, n_keep, d, torch.float64, "cpu"))
    _assert_equal(ref, out)


# (B, T, activity stream, merge width, offsets below 1 + this): the base
# size, and the kernel's edges: 33 chains (a group of 32 and one of 1), 70
# rows (not a row-tile multiple), a random activity stream, and W below
# off + kept behind the init record (30 columns for about 38 kept rows) and
# at per-chain offsets into an accumulator (up to 40 + 70 columns into 56).
SIZES = {"base": (B, T, "ones", 48, 30), "edge": (33, 70, "random", 56, 40)}


@pytest.mark.parametrize("d", [10, 128])
@pytest.mark.parametrize("size", SIZES)
def test_compact_stream_rows_with_init(d, size):
    b, t, active, _, _ = SIZES[size]
    stream, fill, _ = _stream(d, 3 * d, active, b, t)
    j_init, t_init = _init(d, d, b)
    n_keep = 30
    ref = engine.compact_stream_rows_with_init(stream, n_keep, j_init)
    out = k2.compact_fill(fill, k2.empty_rows(b, n_keep + 1, d, torch.float64, "cpu"),
                          off=torch.ones(b, dtype=torch.int32), init=t_init)
    _assert_equal(ref, out)


@pytest.mark.parametrize("d", [10, 128])
@pytest.mark.parametrize("size", SIZES)
def test_merge_stream_at_offsets(d, size):
    b, t, active, target, max_off = SIZES[size]
    acc_stream, acc_fill, _ = _stream(d, 5 + d, active, b, t)
    j_init, t_init = _init(d, d, b)
    acc_j = engine.compact_stream_rows_with_init(acc_stream, target - 1, j_init)
    acc_t = k2.compact_fill(acc_fill, k2.empty_rows(b, target, d, torch.float64, "cpu"),
                            off=torch.ones(b, dtype=torch.int32), init=t_init)
    _assert_equal(acc_j, acc_t)
    stream, fill, _ = _stream(d, 7 + d, active, b, t)
    offsets = 1 + np.random.default_rng(d).integers(0, max_off, size=b).astype(np.int32)
    if d < engine.GATHER_DIM_THRESHOLD:
        ref = _jax_merge(target)(acc_j, stream, offsets)
    else:
        ref = engine.merge_stream_at_offsets(acc_j, stream, jnp.asarray(offsets), target)
    out = k2.compact_fill(fill, acc_t, off=torch.tensor(offsets))
    _assert_equal(ref, out)


@pytest.mark.parametrize("d", [10, 128])
@pytest.mark.parametrize("with_init", [False, True])
def test_compact_field_pallas_interpret(d, with_init):
    stream, fill, s = _stream(d, 11 * d, active="random")
    nbits = max(1, int(T - 1).bit_length())
    masks = pc.shift_masks(stream.kind, nbits)
    n_keep = 33
    init_row = (jnp.asarray(np.random.default_rng(d).normal(size=(B, 1, d)))
                if with_init else None)
    ref = pc.compact_field(stream.x, masks, n_keep, init_row=init_row,
                           interpret=True)
    W = n_keep + int(with_init)
    specs = [k2.FieldSpec(fill.x, torch.empty((B, W, d), dtype=torch.float64),
                          torch.tensor(np.asarray(init_row)[:, 0]) if with_init else None),
             # a real activity source (sticky fills) alongside
             k2.FieldSpec(torch.tensor(np.ascontiguousarray(np.moveaxis(s["is_active"], 0, -1))),
                          torch.empty((B, W, d), dtype=torch.bool))]
    off = torch.ones(B, dtype=torch.int32) if with_init else None
    k2.compact_rows(fill.kind[:, 0], specs, off)
    np.testing.assert_array_equal(specs[0].out.numpy(), np.asarray(ref))
    ref_act = np.asarray(engine.compact_stream_rows(stream, n_keep).is_active)
    got_act = specs[1].out.numpy()[:, int(with_init):]
    np.testing.assert_array_equal(got_act, ref_act)

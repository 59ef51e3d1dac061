"""K1's plain PyTorch version against the Pallas kernel in interpret mode.

Both start from the same state (JAX ``init_state_batch``, carried over with
``pdmpflux_tpu_torch.convert``) and the same chunk seed, so they draw the
same Threefry counters and must follow the same trajectories.  B = 256 with
an RNG lane tile of 128 exercises the ``tile * 7919`` seed offset; the
event cap of 10 inside a 16-transition chunk exercises freezing.

Tolerances:
* float64: integer outputs equal; floats to ``rtol 1e-10, atol 1e-12``
  (the two sides differ only by rounding order: summation order over d,
  ``log`` implementations, fused multiply-adds);
* float32: event kinds equal on at least 99% of (transition, chain) pairs
  (a rounding difference can flip one thinning decision and the chain then
  follows another, equally valid trajectory).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.ops.pallas import driver as pdrv  # noqa: E402
from pdmpflux_tpu.ops.pallas import zigzag_chunk as zc  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402

B, K, TILE, CAP = 256, 16, 128, 10


def _samplers(pot, d, grid, signed):
    kw = dict(grid_size=grid, signed_bound=signed)
    if pot == "gauss":
        return (pf.ZigZag(d, lambda x: x, **kw),
                pt.ZigZag(d, pt.potentials.grad_gauss, **kw))
    if pot == "banana":
        return (pf.ZigZagAD(d, pf.utils.potentials.banana, **kw),
                pt.ZigZagAD(d, pt.potentials.banana, **kw))
    # an untagged potential: the plain version differentiates it itself
    return (pf.ZigZagAD(d, lambda x: jnp.sum(x * x) / 2, **kw),
            pt.ZigZagAD(d, lambda x: torch.sum(x * x) / 2, **kw))


def _run_both(pot, d, grid, signed, jdt, seed):
    js, ts = _samplers(pot, d, grid, signed)
    assert (ts.device_potential is None) == (pot == "gauss_untagged")
    rs = np.random.default_rng(d + grid)
    x0 = rs.normal(size=(B, d))
    v0 = rs.choice([-1.0, 1.0], size=(B, d))
    st = js.init_state_batch(x0, v0, 11, dtype=jdt)
    fields = {f: np.asarray(getattr(st, f)) for f in st._fields if f != "key"}
    fields["key"] = np.asarray(jax.random.key_data(st.key))
    tstate = convert.state_from_numpy(fields, device="cpu")
    counts0 = np.zeros(B, np.int32)
    counts0[::7] = CAP - 2  # some chains reach the cap inside the chunk

    # JAX: the Pallas kernel, interpreted
    n_grid = js.grid_size if js.grid_size >= 2 else pdrv.PALLAS_CONST_GRID
    gc, gcs = pdrv.convert_grad(js, d, TILE, jdt)
    fc, fcs = pdrv.convert_flow(js, d, TILE, jdt)
    fs = jnp.stack([st.t, st.t_comp, st.ts, st.horizon, st.bound_h,
                    st.exp_rv, st.ar, st.tt]).astype(jdt)
    isc = jnp.stack([st.mode, st.rejected, st.errored_bound,
                     st.hitting_horizon, jnp.asarray(counts0)]).astype(jnp.int32)
    outs = zc.run_chunk(
        seed, st.x.T, st.v.T, fs, isc, st.error_value_ar.T.astype(jdt),
        grad_vec=gc, grad_consts=gcs, flow_vec=fc, flow_consts=fcs,
        n_grid=n_grid, K=K, adaptive=True, signed=signed, refresh_rate=0.0,
        cap=CAP, tile=TILE, interpret=True,
    )
    outs = [np.asarray(o) for o in outs]

    # port: the plain version through the wrapper (CPU tensors)
    tst = tdrv.chunk_state(tstate, torch.as_tensor(counts0))
    fill = tzc.empty_fill(K, d, B, tst.x.dtype, "cpu")
    tzc.run_chunk(seed, tst, fill, 0, tdrv.chunk_config(ts, K, CAP, TILE))
    mine = [a.numpy() for a in (*tst, *fill) if a is not None]  # no act: not sticky
    return outs, mine


NAMES = ("x", "v", "fs", "iscal", "ring", "ev_kind", "ev_x", "ev_v", "ev_fs",
         "ev_ring")


@pytest.mark.parametrize("pot,d,grid,signed,seed", [
    ("gauss", 4, 10, True, 12345),
    ("banana", 10, 0, False, -777),
    ("gauss", 10, 0, False, 2**31 - 5),
    ("gauss_untagged", 10, 10, False, 99),
])
def test_plain_k1_matches_pallas_f64(pot, d, grid, signed, seed):
    outs, mine = _run_both(pot, d, grid, signed, jnp.float64, seed)
    _assert_f64_equal(outs, mine)


@pytest.mark.parametrize("pot,grid,signed", [("gauss", 2, True), ("banana", 33, False),
                                             ("gauss", 64, False)])
def test_plain_k1_matches_pallas_f64_at_grid_edges(pot, grid, signed):
    """The envelope's edges that the kernel's lane groups split: a single
    segment (2), and more segments than a group has lanes (33, 64)."""
    outs, mine = _run_both(pot, 10, grid, signed, jnp.float64, 7 * grid)
    _assert_f64_equal(outs, mine)


def _assert_f64_equal(outs, mine):
    for name, a, b in zip(NAMES, outs, mine):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12, err_msg=name)
    kinds = outs[5][:, 0]
    assert (kinds == 2).sum() > B  # many events
    assert (outs[3][4] == CAP).any()  # some chains froze


@pytest.mark.parametrize("pot,d,grid,signed", [
    ("banana", 10, 10, True),
])
def test_plain_k1_matches_pallas_f32(pot, d, grid, signed):
    outs, mine = _run_both(pot, d, grid, signed, jnp.float32, 4242)
    assert mine[0].dtype == np.float32
    agree = np.mean(outs[5][:, 0] == mine[5][:, 0])
    assert agree >= 0.99, agree

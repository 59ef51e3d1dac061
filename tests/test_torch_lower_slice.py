"""The plain chunk kernels fed a lowered gradient's torch pair, against JAX.

A gradient no device tag covers (a Student-t with 5 degrees of freedom on
K1, K6, K3, K5 and K4; Neal's funnel written by the user, whose coordinate 0
reads a sum over ``x[1:]``, on K3 and K4) runs through the plain version of
each chunk kernel with the IR's ``(grad, grad_jvp)``
(``ops/cuda/driver.lowered_config``, the config the card's kernels take), and
through JAX's Pallas kernel in interpret mode on the jnp twin of the same
function, from one JAX state carried over with ``pdmpflux_tpu_torch.convert``,
in ``mode="events"`` and ``"horizon"``, float64: integers and the activity
mask equal, floats to rtol 1e-12 (atol 1e-12).
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
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402

B, K, TILE, CAP, KAPPA, D = 64, 16, 64, 10, 2.0, 6
RTOL = ATOL = 1e-12


def _student(np_):
    return lambda x: 3.0 * np_.sum(np_.log1p(x * x / 5.0))


def _neal(np_):
    return lambda x: (x[0] * x[0] / 18.0 + 0.5 * (x.shape[0] - 1) * x[0]
                      + 0.5 * np_.sum(x[1:] ** 2) * np_.exp(-x[0]))


TARGETS = {"student": _student, "neal": _neal}


def _pair(kernel, target, targets=TARGETS, d=D):
    """The sampler in both packages on the jnp and the torch function."""
    jU, tU = targets[target](jnp), targets[target](torch)
    if kernel == "zigzag":
        return pf.ZigZagAD(d, jU), pt.ZigZagAD(d, tU)
    if kernel == "sticky":
        kappa = np.full(d, KAPPA)
        return pf.StickyZigZagAD(d, jU, kappa), pt.StickyZigZagAD(d, tU, kappa)
    if kernel == "suzz":
        return pf.SpeedUpZigZagAD(d, jU), pt.SpeedUpZigZagAD(d, tU)
    if kernel == "bps":
        return pf.BPSAD(d, jU, refresh_rate=0.5), pt.BPSAD(d, tU, refresh_rate=0.5)
    if kernel == "boomerang":
        return (pf.BoomerangAD(d, jU, refresh_rate=0.5, tmax=1.0),
                pt.BoomerangAD(d, tU, refresh_rate=0.5, tmax=1.0))
    return pf.ForwardECMCAD(d, jU), pt.ForwardECMCAD(d, tU)


def _initial(kernel, seed, d=D):
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(B, d)) * (0.3 if kernel == "sticky" else 1.0)
    if kernel in ("zigzag", "sticky", "suzz"):
        return x0, rs.choice([-1.0, 1.0], size=(B, d))
    v0 = rs.normal(size=(B, d))
    if kernel != "boomerang":
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    return x0, v0


def _to_port(jst):
    fields = {f: np.asarray(getattr(jst, f)) for f in jst._fields if f != "key"}
    fields["key"] = np.asarray(jax.random.key_data(jst.key))
    return convert.state_from_numpy(fields, device="cpu")


def run_both(kernel, target, horizon, seed=5, targets=TARGETS, d=D, pair=None, start=None,
             tmax=None):
    """JAX's interpreted Pallas chunk and the port's plain version on the
    lowered config (through its wrapper, on CPU tensors) from one state at
    dimension ``d``; ``targets`` maps a target's name to its function of a
    numpy-like module (``jnp`` or ``torch``).  ``pair``: the two samplers
    (:func:`_pair`'s), whose cached conversions let a second call reuse
    JAX's compiled kernel; ``start``: ``(x0, v0)``; ``tmax``: the first
    envelope's horizon in place of the sampler's."""
    js, ts = pair or _pair(kernel, target, targets, d)
    assert ts.device_potential is None  # a gradient of the user's own
    kind, sticky = pdrv.kernel_kind(js), kernel == "sticky"
    x0, v0 = start or _initial(kernel, seed, d)
    st = js.init_state_batch(x0, v0, 11, dtype=jnp.float64)
    if tmax is not None:
        st = st._replace(horizon=jnp.full_like(st.horizon, tmax),
                         bound_h=jnp.full_like(st.bound_h, tmax))
    counts0 = np.zeros(B, np.int32)
    counts0[::7] = CAP - 2  # some chains reach the cap inside the chunk
    cfg = tdrv.chunk_config(ts, K, CAP, TILE)
    cfg = tdrv.lowered_config(cfg, ts, d, torch.float64, "cpu")
    assert cfg.device_potential == lower.USER_POTENTIAL and cfg.user.kernel == kernel
    run_chunk = tsc.run_chunk if kind in tsc.KINDS else tzc.run_chunk
    t_target = None
    if horizon:  # a target inside the chunk: the median clock after it
        probe = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0), sticky)
        run_chunk(seed, probe, tzc.empty_fill(K, d, B, probe.x.dtype, "cpu", sticky), 0, cfg)
        t_target = tzc.f32_target(float(torch.median(probe.fs[tzc.F_T])))

    gc, gcs = pdrv.convert_grad(js, d, TILE, jnp.float64, kind)
    fc, fcs = pdrv.convert_flow(js, d, TILE, jnp.float64)
    fs = jnp.stack([st.t, st.t_comp, st.ts, st.horizon, st.bound_h, st.exp_rv, st.ar,
                    st.tt]).astype(jnp.float64)
    isc = jnp.stack([st.mode, st.rejected, st.errored_bound, st.hitting_horizon,
                     jnp.asarray(counts0)]).astype(jnp.int32)
    outs = zc.run_chunk(
        seed, st.x.T, st.v.T, fs, isc, st.error_value_ar.T.astype(jnp.float64),
        grad_vec=gc, grad_consts=gcs, flow_vec=fc, flow_consts=fcs,
        n_grid=js.grid_size, K=K, adaptive=True, signed=bool(js.signed_bound),
        refresh_rate=float(js.refresh_rate), cap=CAP, tile=TILE, interpret=True, kind=kind,
        gaussian_velocity=pdrv._kernel_gaussian_velocity(js, kind),
        ecmc_params=pdrv._ecmc_params(js, kind), sticky=sticky,
        act=st.is_active.T.astype(jnp.float64) if sticky else None,
        kappa=jnp.full((d,), KAPPA, jnp.float64) if sticky else None,
        mode="horizon" if horizon else "events", t_target=t_target)
    ref = [np.asarray(o) for o in outs]

    tst = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0), sticky)
    fill = tzc.empty_fill(K, d, B, tst.x.dtype, "cpu", sticky)
    run_chunk(seed, tst, fill, 0, cfg._replace(t_target=t_target))
    mine = [a.numpy() for a in (*tst, *fill) if a is not None]
    assert len(ref) == len(mine)
    return ref, mine, t_target


CASES = [("zigzag", "student", False), ("zigzag", "student", True),
         ("sticky", "student", False), ("suzz", "student", False),
         ("suzz", "student", True), ("bps", "student", False), ("bps", "student", True),
         ("boomerang", "student", False), ("ecmc", "student", False),
         ("bps", "neal", False), ("suzz", "neal", False)]


def check_outputs(ref, mine, t_target, many_events=True):
    """Integers and the activity mask equal, floats to ``RTOL``/``ATOL``;
    many events (where ``many_events``), and in horizon mode a share of the
    lanes frozen."""
    for i, (a, b) in enumerate(zip(ref, mine)):
        if b.dtype == np.bool_:  # JAX keeps the activity 0/1 in the state dtype
            np.testing.assert_array_equal(a > 0, b, err_msg=str(i))
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL, err_msg=str(i))
    ev_kind = ref[len(ref) // 2][:, 0]
    assert not many_events or (ev_kind > 0).sum() > B // 2  # many events
    if t_target is not None:  # the target freezes a share of the lanes
        froze = ref[2][tzc.F_T] >= np.float32(t_target)
        assert 0.1 < froze.mean() < 0.95, froze.mean()


@pytest.mark.parametrize("kernel,target,horizon", CASES)
def test_plain_kernel_on_lowered_gradient_matches_pallas(kernel, target, horizon):
    check_outputs(*run_both(kernel, target, horizon))

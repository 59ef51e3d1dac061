"""The JAX package's test potentials on the port's chunk kernels, against JAX.

Every test potential of ``pdmpflux_tpu/utils/potentials.py`` carries a
device tag in the port (``gauss_1d`` the ``"gauss"`` tag, ``cauchy``,
``ridged_gauss``, ``funnel`` and ``neal_funnel`` their own), so the CUDA
chunk kernels run them as the Pallas kernel runs any traced gradient.

* (a) closed forms: ``LANE_POTENTIALS``' ``grad`` and ``grad_jvp`` of each
  tag on seeded ``(d, B)`` rows against ``jax.grad`` and
  ``jax.jvp(jax.grad(U))``, jitted as JAX's kernels run them (XLA folds
  ``ridged_gauss``'s factors 0.1 and 10), in float64, rtol 1e-12, atol
  1e-12 (the funnel's rows with ``x[0] > 0``).
* (b) the plain chunk versions (K1, K6, K4, K3, K5) on each new tag, in
  ``mode="events"``, against the Pallas kernel in interpret mode, from one
  JAX ``init_state_batch`` state carried over with
  ``pdmpflux_tpu_torch.convert``: integers and the activity mask equal,
  floats to rtol 1e-10, atol 1e-12 (rounding order only), except
  ``ridged_gauss`` on the scalar-rate kernels (``RIDGED_SCALAR_RTOL``).
  ``tests/test_torch_potentials_modes.py`` holds the horizon mode, float32
  and ``"aniso"`` on K1, K6 and K4 with the same harness, in a file of its
  own so that the two run on two test workers.
* (c) routing: ``api.pick_backend(..., device="cuda")`` returns
  ``"kernel"`` for every kernel kind on every test potential (no card is
  needed to decide) and on an untagged gradient the lowering expresses
  (``ops/cuda/lower.py``), a dense ``A @ x`` included; a ``cumprod`` raises.
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
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402
from pdmpflux_tpu_torch.utils import potentials as tpot  # noqa: E402

B, K, TILE, CAP, KAPPA = 128, 16, 128, 10, 2.0
RTOL = ATOL = 1e-12
NEW_TAGS = ("cauchy", "ridged", "funnel", "neal_funnel")
NAMES = {"cauchy": "cauchy", "ridged": "ridged_gauss", "funnel": "funnel",
         "neal_funnel": "neal_funnel", "gauss": "gauss_1d"}
KERNELS = ("zigzag", "sticky", "suzz", "bps", "boomerang", "ecmc")


def _potentials(tag, d):
    """``(U_jax, U_port)`` of a tag."""
    if tag == "aniso":
        s = np.linspace(0.5, 3.0, d)
        return (pf.utils.potentials.anisotropic_gauss(s),
                pt.potentials.anisotropic_gauss(s))
    return getattr(pf.utils.potentials, NAMES[tag]), getattr(pt.potentials, NAMES[tag])


def _rows(tag, d, n, seed):
    """Seeded ``(n, d)`` points and velocities; the funnel's ``x[0] > 0``."""
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(n, d)) * 1.5
    if tag == "funnel":
        x[:, 0] = np.abs(x[:, 0]) + 0.5
    return x, rs.normal(size=(n, d))


@pytest.mark.parametrize("tag", NEW_TAGS + ("gauss",))
def test_closed_forms_match_jax_grad(tag):
    """``LANE_POTENTIALS[tag]``'s ``grad`` and ``grad_jvp`` against
    ``jax.grad`` and ``jax.jvp(jax.grad(U))`` (``gauss``: ``gauss_1d``)."""
    jU, tU = _potentials(tag, 1)
    assert tU.device_potential == tag
    for d in ((1,) if tag == "gauss" else (2, 6, 40)):
        x, v = _rows(tag, d, 64, d)
        want_g = np.asarray(jax.jit(jax.vmap(jax.grad(jU)))(jnp.asarray(x)))
        want_dg = np.asarray(jax.jit(jax.vmap(
            lambda a, b: jax.jvp(jax.grad(jU), (a,), (b,))[1]))(jnp.asarray(x), jnp.asarray(v)))
        grad, grad_jvp = tpot.LANE_POTENTIALS[tag](None)
        xt, vt = torch.as_tensor(x.T), torch.as_tensor(v.T)
        g = grad(xt)
        g2, dg = grad_jvp(xt, vt)
        assert torch.equal(g, g2)  # one expression, the same bits
        np.testing.assert_allclose(g.numpy().T, want_g, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(dg.numpy().T, want_dg, rtol=RTOL, atol=ATOL)


def _pair(kernel, tag, d, signed):
    """The same sampler in both packages."""
    jU, tU = _potentials(tag, d)
    kw = dict(signed_bound=signed)
    if kernel == "zigzag":
        return pf.ZigZagAD(d, jU, **kw), pt.ZigZagAD(d, tU, **kw)
    if kernel == "sticky":
        kappa = np.full(d, KAPPA)
        return pf.StickyZigZagAD(d, jU, kappa, **kw), pt.StickyZigZagAD(d, tU, kappa, **kw)
    if kernel == "suzz":
        return pf.SpeedUpZigZagAD(d, jU, **kw), pt.SpeedUpZigZagAD(d, tU, **kw)
    if kernel == "bps":
        return (pf.BPSAD(d, jU, refresh_rate=0.5, **kw),
                pt.BPSAD(d, tU, refresh_rate=0.5, **kw))
    if kernel == "boomerang":
        return (pf.BoomerangAD(d, jU, refresh_rate=0.5, tmax=1.0, **kw),
                pt.BoomerangAD(d, tU, refresh_rate=0.5, tmax=1.0, **kw))
    return pf.ForwardECMCAD(d, jU, **kw), pt.ForwardECMCAD(d, tU, **kw)


def _initial(kernel, tag, d, seed):
    """Positions N(0, I) (near the axes for the sticky sampler; the funnel's
    ``x[0]`` in [0.5, 3]); velocities +-1 for the Zig-Zag family, unit for
    BPS and ECMC, N(0, I) for the Boomerang."""
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(B, d)) * (0.3 if kernel == "sticky" else 1.0)
    if tag == "funnel":
        x0[:, 0] = 0.5 + np.abs(rs.normal(size=B))
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


def run_both(kernel, tag, d, signed, jdt, seed, horizon):
    """The interpreted Pallas chunk and the port's plain version (through
    its wrapper, on CPU tensors) from one state; returns both outputs and
    the float32 target (None in events mode)."""
    js, ts = _pair(kernel, tag, d, signed)
    assert ts.device_potential == tag
    kind, sticky = pdrv.kernel_kind(js), kernel == "sticky"
    assert tdrv.kernel_kind(ts) == kind
    x0, v0 = _initial(kernel, tag, d, seed % 1000)
    st = js.init_state_batch(x0, v0, 11, dtype=jdt)
    counts0 = np.zeros(B, np.int32)
    counts0[::7] = CAP - 2  # some chains reach the cap inside the chunk
    cfg = tdrv.chunk_config(ts, K, CAP, TILE)
    run_chunk = tsc.run_chunk if kind in tsc.KINDS else tzc.run_chunk
    t_target = None
    if horizon:  # a target inside the chunk: the median clock after it
        probe = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0), sticky)
        run_chunk(seed, probe, tzc.empty_fill(K, d, B, probe.x.dtype, "cpu", sticky), 0,
                  cfg)
        t_target = tzc.f32_target(float(torch.median(probe.fs[tzc.F_T])))

    # JAX: the Pallas kernel, interpreted
    gc, gcs = pdrv.convert_grad(js, d, TILE, jdt, kind)
    fc, fcs = pdrv.convert_flow(js, d, TILE, jdt)
    fs = jnp.stack([st.t, st.t_comp, st.ts, st.horizon, st.bound_h, st.exp_rv, st.ar,
                    st.tt]).astype(jdt)
    isc = jnp.stack([st.mode, st.rejected, st.errored_bound, st.hitting_horizon,
                     jnp.asarray(counts0)]).astype(jnp.int32)
    n_grid = js.grid_size if js.grid_size >= 2 else pdrv.PALLAS_CONST_GRID
    outs = zc.run_chunk(
        seed, st.x.T, st.v.T, fs, isc, st.error_value_ar.T.astype(jdt),
        grad_vec=gc, grad_consts=gcs, flow_vec=fc, flow_consts=fcs, n_grid=n_grid, K=K,
        adaptive=True, signed=signed, refresh_rate=float(js.refresh_rate), cap=CAP,
        tile=TILE, interpret=True, kind=kind,
        gaussian_velocity=pdrv._kernel_gaussian_velocity(js, kind),
        ecmc_params=pdrv._ecmc_params(js, kind), sticky=sticky,
        act=st.is_active.T.astype(jdt) if sticky else None,
        kappa=jnp.full((d,), KAPPA, jdt) if sticky else None,
        mode="horizon" if horizon else "events", t_target=t_target)
    ref = [np.asarray(o) for o in outs]

    # port: the plain version through the wrapper (CPU tensors)
    tst = tdrv.chunk_state(_to_port(st), torch.as_tensor(counts0), sticky)
    fill = tzc.empty_fill(K, d, B, tst.x.dtype, "cpu", sticky)
    run_chunk(seed, tst, fill, 0, cfg._replace(t_target=t_target))
    mine = [a.numpy() for a in (*tst, *fill) if a is not None]
    assert len(ref) == len(mine)
    return ref, mine, t_target


def _assert_f64_equal(ref, mine, t_target, rtol=1e-10):
    for i, (a, b) in enumerate(zip(ref, mine)):
        if b.dtype == np.bool_:  # JAX keeps the activity 0/1 in the state dtype
            np.testing.assert_array_equal(a > 0, b, err_msg=str(i))
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, i
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=str(i))
        else:
            np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-12, err_msg=str(i))
    ev_kind = ref[len(ref) // 2][:, 0]
    assert (ev_kind > 0).sum() > B  # many events
    assert (ref[3][tzc.I_CNT] == CAP).any()  # some chains froze at the cap
    if t_target is not None:  # the target freezes a share of the lanes
        froze = ref[2][tzc.F_T] >= np.float32(t_target)
        assert 0.2 < froze.mean() < 0.9, froze.mean()


# every new tag on every chunk kernel, in events mode (the horizon, f32 and
# "aniso" cases: tests/test_torch_potentials_modes.py)
CASES = [(kernel, tag, 6, (i + j) % 2 == 0, 1000 * i + 17 * j - 500)
         for i, kernel in enumerate(("zigzag", "sticky", "suzz", "bps", "ecmc"))
         for j, tag in enumerate(NEW_TAGS)]
RIDGED_SCALAR_RTOL = 1e-5
"""Float tolerance of ``ridged_gauss`` on the scalar-rate kernels (K3, K5):
there each transition multiplies a difference between the two sides by
about 4 (measured: ECMC's velocities 1.5e-13 apart after one transition,
4.7e-8 after 16; the Boomerang's 9.7e-7), as the ridges' curvature
(``|1 - 10 sin(10 y_i)|`` up to 11) bends every reflection, so the last-bit
differences of the two sides (XLA's fused ``exp``, which differs from
torch's on 15% of inputs, and the order of its reductions) grow past 1e-10
within the chunk; every decision (the integer outputs) stays equal."""


def check_f64(kernel, tag, d, signed, seed, horizon):
    """One f64 case of :func:`run_both`, held as the module docstring says."""
    ref, mine, t_target = run_both(kernel, tag, d, signed, jnp.float64, seed, horizon)
    scalar = kernel in ("bps", "boomerang", "ecmc")
    _assert_f64_equal(ref, mine, t_target,
                      RIDGED_SCALAR_RTOL if scalar and tag == "ridged" else 1e-10)


@pytest.mark.parametrize("kernel,tag,d,signed,seed", CASES)
def test_plain_kernel_matches_pallas_f64(kernel, tag, d, signed, seed):
    check_f64(kernel, tag, d, signed, seed, False)


def test_every_test_potential_routes_to_the_kernels():
    """With ``device="cuda"`` and ``backend="auto"`` every sampler family on
    every test potential routes to its chunk kernel, and so does an untagged
    gradient that the lowering expresses, a dense ``A @ x`` included; a
    running product (``cumprod``) raises, naming ``backend="xla_stream"``."""
    d = 4
    pots = [pt.potentials.gauss, pt.potentials.gauss_1d, pt.potentials.banana,
            pt.potentials.anisotropic_gauss(np.ones(d)), pt.potentials.cauchy,
            pt.potentials.ridged_gauss, pt.potentials.funnel, pt.potentials.neal_funnel]
    families = (lambda U: pt.ZigZagAD(d, U), lambda U: pt.StickyZigZagAD(d, U, np.ones(d)),
                lambda U: pt.SpeedUpZigZagAD(d, U), lambda U: pt.BPSAD(d, U),
                lambda U: pt.BoomerangAD(d, U), lambda U: pt.ForwardECMCAD(d, U))
    limits = dict(scalar_max_dim=lambda dt, user=None: 1210,
                  sticky_max_dim=lambda dt, user=None: 13136)
    with pytest.MonkeyPatch.context() as mp:  # the shared-memory limits need a build
        mp.setattr(tsc, "scalar_max_dim", limits["scalar_max_dim"])
        mp.setattr(tzc, "sticky_max_dim", limits["sticky_max_dim"])
        for make in families:
            for U in pots:
                s = make(U)
                for backend in ("auto", "pallas"):
                    assert tapi.pick_backend(s, backend, d, torch.float32, "cuda") == \
                        "kernel", (type(s).__name__, U.device_potential)
            untagged = make(lambda x: torch.sum(x * x) / 2)
            assert tapi.pick_backend(untagged, "auto", d, torch.float32, "cuda") == "kernel"
            dense = make(lambda x: 0.5 * x @ (torch.eye(d, dtype=x.dtype) @ x))
            assert tapi.pick_backend(dense, "auto", d, torch.float32, "cuda") == "kernel"
            refused = make(lambda x: 0.5 * torch.sum(torch.cumprod(x, 0) ** 2))
            with pytest.raises(ValueError, match="backend='xla_stream'"):
                tapi.pick_backend(refused, "auto", d, torch.float32, "cuda")
            for s in (untagged, dense, refused):
                assert tapi.pick_backend(s, "xla_stream", d, torch.float32,
                                         "cuda") == "engine"

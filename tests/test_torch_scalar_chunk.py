"""K3 and K5's plain PyTorch version against the Pallas kernel in interpret
mode (``run_chunk`` with ``kind="bps"``, ``"boomerang"`` and ``"ecmc"``).

Both start from the same state (JAX ``init_state_batch``, carried over with
``pdmpflux_tpu_torch.convert``) and the same chunk seed, so they draw the
same Threefry counters and must follow the same trajectories.  B = 256 with
an RNG lane tile of 128 exercises the ``tile * 7919`` seed offset; an event
cap reached inside the 16-transition chunk exercises freezing.  Some chains
start with ``x`` parallel to ``v`` so that on the Gaussian target ECMC's
first jump meets the degenerate orthogonal component (``|v_o| < 1e-10``).

Tolerances:
* float64: integer outputs equal; floats to ``rtol 1e-10, atol 1e-12`` (the
  two sides differ only by rounding order: summation order over d, ``log``,
  ``cos`` and ``pow`` implementations);
* float32: event kinds equal on at least 99% of (transition, chain) pairs (a
  rounding difference can flip one decision and the chain then follows
  another, equally valid trajectory).
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
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402

B, K, TILE, CAP = 256, 16, 128, 10
NAMES = ("x", "v", "fs", "iscal", "ring", "ev_kind", "ev_x", "ev_v", "ev_fs",
         "ev_ring")


def scales(d):
    return np.linspace(0.5, 3.0, d)


def make_samplers(kind, pot, d, **kw):
    """The same sampler in both packages: a manual gradient for ``gauss``, an
    autodiff one of the tagged potential otherwise."""
    jcls = {"bps": (pf.BPS, pf.BPSAD), "boomerang": (pf.Boomerang, pf.BoomerangAD),
            "ecmc": (pf.ForwardECMC, pf.ForwardECMCAD)}[kind]
    tcls = {"bps": (pt.BPS, pt.BPSAD), "boomerang": (pt.Boomerang, pt.BoomerangAD),
            "ecmc": (pt.ForwardECMC, pt.ForwardECMCAD)}[kind]
    if pot == "gauss":
        return jcls[0](d, lambda x: x, **kw), tcls[0](d, pt.potentials.grad_gauss, **kw)
    if pot == "banana":
        return (jcls[1](d, pf.utils.potentials.banana, **kw),
                tcls[1](d, pt.potentials.banana, **kw))
    return (jcls[1](d, pf.utils.potentials.anisotropic_gauss(scales(d)), **kw),
            tcls[1](d, pt.potentials.anisotropic_gauss(scales(d)), **kw))


def initial(kind, d, seed, ecmc_start=False):
    """Random positions; unit velocities (Gaussian ones for the Boomerang);
    every eleventh chain starts with ``x`` parallel to ``v``.  With
    ``ecmc_start``, ``ecmc_gauss_d10``'s start: x = 0, v = 1 / sqrt(d)."""
    if ecmc_start:
        return np.zeros((B, d)), np.full((B, d), 1.0 / np.sqrt(d))
    rs = np.random.default_rng(seed)
    x0 = rs.normal(size=(B, d))
    v0 = rs.normal(size=(B, d))
    if kind != "boomerang":
        v0 /= np.linalg.norm(v0, axis=1, keepdims=True)
    x0[3::11] = 0.7 * v0[3::11]
    return x0, v0


def run_both(kind, pot, d, jdt, seed, ecmc_start=False, **kw):
    js, ts = make_samplers(kind, pot, d, **kw)
    assert ts.device_potential == pot and tdrv.kernel_kind(ts) == kind
    x0, v0 = initial(kind, d, d + len(pot), ecmc_start)
    st = js.init_state_batch(x0, v0, 11, dtype=jdt)
    fields = {f: np.asarray(getattr(st, f)) for f in st._fields if f != "key"}
    fields["key"] = np.asarray(jax.random.key_data(st.key))
    tstate = convert.state_from_numpy(fields, device="cpu")
    counts0 = np.zeros(B, np.int32)
    counts0[::7] = CAP - 2  # some chains reach the cap inside the chunk

    # JAX: the Pallas kernel, interpreted
    n_grid = js.grid_size if js.grid_size >= 2 else pdrv.PALLAS_CONST_GRID
    gc, gcs = pdrv.convert_grad(js, d, TILE, jdt, kind)
    fc, fcs = pdrv.convert_flow(js, d, TILE, jdt)
    fs = jnp.stack([st.t, st.t_comp, st.ts, st.horizon, st.bound_h,
                    st.exp_rv, st.ar, st.tt]).astype(jdt)
    isc = jnp.stack([st.mode, st.rejected, st.errored_bound,
                     st.hitting_horizon, jnp.asarray(counts0)]).astype(jnp.int32)
    outs = zc.run_chunk(
        seed, st.x.T, st.v.T, fs, isc, st.error_value_ar.T.astype(jdt),
        grad_vec=gc, grad_consts=gcs, flow_vec=fc, flow_consts=fcs,
        n_grid=n_grid, K=K, adaptive=True, signed=bool(js.signed_bound),
        refresh_rate=float(js.refresh_rate), cap=CAP, tile=TILE, interpret=True,
        kind=kind, gaussian_velocity=pdrv._kernel_gaussian_velocity(js, kind),
        ecmc_params=pdrv._ecmc_params(js, kind),
    )
    outs = [np.asarray(o) for o in outs]

    # port: the plain version through the wrapper (CPU tensors)
    tst = tdrv.chunk_state(tstate, torch.as_tensor(counts0))
    fill = tzc.empty_fill(K, d, B, tst.x.dtype, "cpu")
    tsc.run_chunk(seed, tst, fill, 0, tdrv.chunk_config(ts, K, CAP, TILE))
    mine = [a.numpy() for a in (*tst, *fill) if a is not None]
    return outs, mine


def assert_f64_equal(outs, mine):
    for name, a, b in zip(NAMES, outs, mine):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if a.dtype.kind == "i":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-10, atol=1e-12, err_msg=name)
    kinds = outs[5][:, 0]
    assert (kinds == pf.EV_JUMP).sum() > B // 2  # events happen
    assert (outs[3][4] == CAP).any()  # some chains froze


@pytest.mark.parametrize("kind,pot,d,signed", [
    ("bps", "gauss", 10, True),
    ("bps", "aniso", 10, False),
    ("bps", "banana", 2, True),
    ("boomerang", "banana", 10, True),
    ("boomerang", "gauss", 2, False),
    ("boomerang", "aniso", 10, True),
    ("ecmc", "banana", 10, False),
    ("ecmc", "aniso", 10, True),
])
def test_plain_k3_k5_match_pallas_f64(kind, pot, d, signed):
    kw = dict(signed_bound=signed)
    if kind != "ecmc":
        kw.update(refresh_rate=0.3, tmax=1.0)
    outs, mine = run_both(kind, pot, d, jnp.float64, 4321 + d, **kw)
    assert_f64_equal(outs, mine)


@pytest.mark.parametrize("grid", [2, 33, 64])
@pytest.mark.parametrize("kind,pot,kw", [
    ("bps", "aniso", dict(signed_bound=False, refresh_rate=0.3)),
    ("boomerang", "banana", dict(refresh_rate=0.3)),
    ("ecmc", "gauss", dict(switch=True, ran_p=True, positive=False)),
])
def test_plain_k3_k5_match_pallas_f64_at_grid_edges(kind, pot, kw, grid):
    """The envelope's edges in the kernel's layout: one grid point per lane
    (2), and lanes owning two grid points with lane 31 handing its pair
    across (33, 64)."""
    outs, mine = run_both(kind, pot, 10, jnp.float64, 2026, grid_size=grid, **kw)
    assert_f64_equal(outs, mine)


def test_plain_k3_gaussian_velocity_matches_pallas_f64():
    outs, mine = run_both("bps", "gauss", 10, jnp.float64, -99,
                          refresh_rate=1.0, gaussian_velocity=True)
    assert_f64_equal(outs, mine)
    speeds = np.linalg.norm(mine[7], axis=1)  # (K, B): N(0, I) refreshes
    assert np.abs(speeds - 1.0).max() > 0.1


@pytest.mark.parametrize("d,switch,ran_p,positive,normal", [
    (10, True, False, True, False),
    (10, True, True, False, False),
    (10, False, False, True, True),
    (2, True, False, True, False),   # d = 2: mix_p forced to 0
])
def test_plain_k5_variants_match_pallas_f64(d, switch, ran_p, positive, normal):
    outs, mine = run_both("ecmc", "gauss", d, jnp.float64, 2**31 - 7 - d,
                          switch=switch, ran_p=ran_p, positive=positive,
                          normal=normal)
    assert_f64_equal(outs, mine)
    if not normal:  # unit speed survives every jump
        np.testing.assert_allclose(np.linalg.norm(mine[7], axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize("kind,pot", [("bps", "banana"), ("ecmc", "gauss"),
                                      ("boomerang", "banana")])
def test_plain_k3_k5_match_pallas_f32(kind, pot):
    kw = {} if kind == "ecmc" else dict(refresh_rate=0.3, tmax=1.0)
    outs, mine = run_both(kind, pot, 10, jnp.float32, 77, **kw)
    assert mine[0].dtype == np.float32
    agree = np.mean(outs[5][:, 0] == mine[5][:, 0])
    assert agree >= 0.99, agree


def test_plain_k5_f32_keeps_the_reference_degenerate_frame():
    """From ``ecmc_gauss_d10``'s start (x = 0, v constant) every chain's first
    jump meets x parallel to v.  In float32 the orthogonal component is then
    rounding noise above the 1e-10 degenerate threshold, so the jump leaves
    |v| off 1 in the JAX package, and alike in the port (which way the noise
    points depends on each side's rounding, so the trajectories part)."""
    outs, mine = run_both("ecmc", "gauss", 10, jnp.float32, 5, ecmc_start=True)
    off_j = np.abs(np.linalg.norm(outs[7], axis=1) - 1.0).max()
    off_t = np.abs(np.linalg.norm(mine[7], axis=1) - 1.0).max()
    assert off_j > 0.01 and off_t > 0.01, (off_j, off_t)


def test_plain_k5_positive_keeps_a_zero_sign(monkeypatch):
    """``positive`` multiplies the switched direction by sign(<v_o, v_prop>)
    with sign(0) read as 1 (``_make_kernel`` ``:566-568``).  Crafted draws at
    d = 3 make e1 = (1, 0, 0) and e2 = (0, 1, 0) with v_o = e1, so v_prop =
    e2 is orthogonal to v_o and must survive unscaled."""
    d = 3
    a = float(np.exp(-0.5))  # Box-Muller radius sqrt(-2 log a) = 1

    def rows(seeds, k, row0, n, tile, dt):
        if row0 == 2:  # rho uniform, -, mix (refresh), theta
            return torch.tensor([[0.25], [0.5], [0.1], [0.5]], dtype=dt)
        u = torch.ones((6 * d, 1), dtype=dt)   # radius 0: every normal 0 ...
        u[3 * d + 0] = u[5 * d + 1] = 0.0      # ... but g1 = (1, 0, 0), g2 = (0, 1, 0)
        u[2 * d + 0] = u[4 * d + 1] = a
        return u

    monkeypatch.setattr(tsc, "_rows", rows)
    sampler = pt.ForwardECMC(d, pt.potentials.grad_gauss)
    cfg = tdrv.chunk_config(sampler, 1, 1, 128)
    g = torch.tensor([[0.0], [0.0], [2.0]], dtype=torch.float64)
    v = torch.tensor([[1.0], [0.0], [0.5]], dtype=torch.float64)
    v_new = tsc._ecmc_jump(cfg, g, v, torch.zeros(1, dtype=torch.int64), 0, d,
                           torch.float64)
    rho = -np.sqrt(1.0 - 0.25 ** (2.0 / (d - 1)))
    np.testing.assert_allclose(v_new[:, 0].numpy(), [0.0, np.sqrt(1 - rho * rho), rho],
                               atol=1e-12)

"""The port's plotting (``pdmpflux_tpu_torch.plotting``) on torch skeletons:
the nine cases of ``tests/test_plotting.py`` (every function builds on the
headless Agg backend, files land where asked), and parity with the JAX
package on skeletons converted from JAX's (``convert``): the animation
frames equal, also through a curved flow (rtol 1e-12), ``plot_traj``'s line
data equal, and ``plot_U_contour``'s grid of U values and contour levels at
rtol 1e-12."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("matplotlib")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu import plotting as jplot  # noqa: E402
from pdmpflux_tpu_torch import convert, plotting  # noqa: E402

SKIP_GIF = os.environ.get("SKIP_GIF_TEST", "0") == "1"
F64 = torch.float64
RTOL = 1e-12


def _skel(sampler, n, x0, v0, seed):
    return pt.sample_skeleton(sampler, n, x0, v0, seed=seed, dtype=F64, device="cpu")


@pytest.fixture(scope="module")
def skel2d():
    sampler = pt.ZigZagAD(2, lambda x: torch.sum(x**2) / 2)
    return sampler, _skel(sampler, 300, np.zeros(2), np.ones(2), 0)


@pytest.fixture(scope="module")
def samples2d(skel2d):
    sampler, skel = skel2d
    return pt.sample_from_skeleton(sampler, 2000, skel)


def test_plot_traj_2d(skel2d, tmp_path):
    _, skel = skel2d
    plotting.plot_traj(skel, 200, save_path=str(tmp_path / "traj.png"))
    assert (tmp_path / "traj.png").exists()


def test_plot_traj_1d():
    sampler = pt.ZigZagAD(1, lambda x: x**2 / 2)
    skel = _skel(sampler, 100, 0.0, 1.0, 1)
    assert plotting.plot_traj(skel, 100) is not None


def test_plot_traj_3d():
    sampler = pt.ZigZagAD(3, lambda x: torch.sum(x**2) / 2)
    skel = _skel(sampler, 100, np.zeros(3), np.ones(3), 2)
    assert plotting.plot_traj(skel, 100).axes[0].name == "3d"


def test_phase_space_plot(skel2d):
    _, skel = skel2d
    assert plotting.plot_traj(skel, 100, xv_plot=True) is not None


def test_jointplot(samples2d, tmp_path):
    plotting.jointplot(samples2d, save_path=str(tmp_path / "joint.png"))
    assert (tmp_path / "joint.png").exists()


def test_marginalplot_with_exact_overlay(samples2d):
    fig = plotting.marginalplot(samples2d, 0, U=lambda x: torch.sum(x * x) / 2)
    assert [ln.get_label() for ln in fig.axes[0].lines] == ["KDE", "exact (from U)"]


def test_plot_U_contour():
    assert plotting.plot_U_contour(lambda x: torch.sum(x * x) / 2) is not None


@pytest.mark.skipif(SKIP_GIF, reason="GIF rendering disabled")
@pytest.mark.extended
def test_anim_traj_gif(skel2d, tmp_path):
    _, skel = skel2d
    out = str(tmp_path / "traj.gif")
    plotting.anim_traj(skel, 30, dt=0.2, save_path=out, fps=10)
    assert os.path.exists(out) and os.path.getsize(out) > 0


@pytest.mark.skipif(SKIP_GIF, reason="GIF rendering disabled")
@pytest.mark.extended
def test_anim_traj_1d_gif(tmp_path):
    s = pt.ZigZagAD(1, lambda x: torch.sum(x * x) / 2)
    skel = _skel(s, 40, np.zeros(1), np.ones(1), 0)
    out = str(tmp_path / "traj1d.gif")
    plotting.anim_traj(skel, 30, dt=0.2, save_path=out, fps=10)
    assert os.path.exists(out) and os.path.getsize(out) > 0
    out2 = str(tmp_path / "traj1d_tail.gif")
    plotting.anim_traj_(skel, 30, dt=0.2, save_path=out2, fps=10)
    assert os.path.exists(out2) and os.path.getsize(out2) > 0


# --- parity with the JAX package ------------------------------------------

def _jax_skel(d, n, seed):
    s = pf.ZigZagAD(d, lambda x: jnp.sum(x**2) / 2)
    js = pf.sample_skeleton(s, n, np.zeros(d), np.ones(d), seed=seed)
    host = jax.device_get(js)
    ts = convert.skeleton_from_numpy({f: np.asarray(getattr(host, f))
                                      for f in js._fields}, device="cpu")
    return js, ts


@pytest.mark.parametrize("d", [1, 3])
def test_anim_points_equal_jax(d):
    js, ts = _jax_skel(d, 60, 4)
    for a, b in zip(plotting._anim_points(ts, 40, 0.1, None, (0, 2 if d > 2 else 1)),
                    jplot._anim_points(js, 40, 0.1, None, (0, 2 if d > 2 else 1))):
        if isinstance(b, tuple):
            assert a == b
        else:
            np.testing.assert_array_equal(a, b)


def test_anim_points_through_a_flow_match_jax():
    """The Boomerang's elliptic flow between events: the port's ``flow``
    (rows and ``(1,)`` times) against JAX's on one chain."""
    js, ts = _jax_skel(2, 40, 6)
    jb = pf.BoomerangAD(2, lambda x: jnp.sum(x**2) / 2)
    tb = pt.BoomerangAD(2, lambda x: torch.sum(x**2) / 2)
    got = plotting._anim_points(ts, 30, 0.1, tb.flow, (0, 1))
    want = jplot._anim_points(js, 30, 0.1, jb.flow, (0, 1))
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("xv_plot", [False, True])
def test_plot_traj_data_equal_jax(xv_plot):
    js, ts = _jax_skel(2, 80, 5)
    on_cpu = plotting.plot_traj(ts, 60, xv_plot=xv_plot).axes[0].lines[0].get_xydata()
    want = jplot.plot_traj(js, 60, xv_plot=xv_plot).axes[0].lines[0].get_xydata()
    np.testing.assert_array_equal(on_cpu, want)


def test_plot_U_contour_values_match_jax():
    jU, tU = pf.utils.potentials.banana, pt.potentials.banana
    xs = np.linspace(-3, 3, 40)
    XX, YY = np.meshgrid(xs, np.linspace(-2, 4, 40))
    pts = np.stack([XX.ravel(), YY.ravel()], axis=1)
    np.testing.assert_allclose(plotting._U_values(tU, pts),
                               np.asarray(jax.vmap(jU)(jnp.asarray(pts))), rtol=RTOL)
    got = plotting.plot_U_contour(tU, ylim=(-2, 4), n=40).axes[0]
    want = jplot.plot_U_contour(jU, ylim=(-2, 4), n=40).axes[0]
    np.testing.assert_allclose(got.collections[0].levels, want.collections[0].levels,
                               rtol=RTOL)

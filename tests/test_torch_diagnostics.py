"""Diagnostics of the port (``pdmpflux_tpu_torch.diagnostics`` and
``api.sample_skeleton_with_diagnostic``) against the JAX package.

* The numpy estimators (``ess``, ``ess_per_dim``, ``ess_nd``,
  ``split_rhat``, ``ess_summary``, ``RHAT_THRESHOLD``) equal JAX's on the
  same seeded samples, exactly.
* ``RV_diagnostic``, single chain and batch, on float64 skeletons the port
  made (converted to JAX's records through ``convert``), matches JAX's to
  rtol 1e-12.
* ``sample_skeleton_with_diagnostic`` on the CPU gives, on its own
  skeleton, the RV that JAX's function computes on the same skeleton (JAX's
  ``sample_skeleton`` replaced by the converted one), to rtol 1e-12.
* The validation messages are JAX's; the figure builds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu import diagnostics as jd  # noqa: E402
from pdmpflux_tpu.core.types import Skeleton as JSkeleton  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch import diagnostics as td  # noqa: E402

D = 3
RTOL = 1e-12


def _series():
    rs = np.random.default_rng(11)
    iid = rs.normal(size=(4, 300, D))
    ar = np.zeros((4, 300, D))
    for i in range(1, 300):  # AR(1), rho = 0.9
        ar[:, i] = 0.9 * ar[:, i - 1] + rs.normal(size=(4, D))
    return {"iid": iid, "ar1": ar, "const": np.ones((2, 40, D)), "short": iid[:, :3]}


@pytest.mark.parametrize("kind", ["iid", "ar1", "const", "short"])
def test_estimators_equal_jax(kind):
    s = _series()[kind]
    assert td.RHAT_THRESHOLD == jd.RHAT_THRESHOLD
    assert td.ess(s[0, :, 0]) == jd.ess(s[0, :, 0])
    np.testing.assert_array_equal(td.ess_per_dim(s[1]), jd.ess_per_dim(s[1]))
    for a in (s, s[0], s[0, :, 0]):
        np.testing.assert_array_equal(td.ess_nd(a), jd.ess_nd(a))
        np.testing.assert_array_equal(td.split_rhat(a if a.ndim > 1 else a[:, None]),
                                      jd.split_rhat(a if a.ndim > 1 else a[:, None]))
    for thr in (jd.RHAT_THRESHOLD, 1.5):
        got, ref = td.ess_summary(s, thr), jd.ess_summary(s, thr)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def _jax_skeleton(skel):
    return JSkeleton(**{f: jnp.asarray(a) for f, a in convert.skeleton_to_numpy(skel).items()})


SAMPLERS = {
    "zigzag": (lambda: pf.ZigZag(D, lambda x: x),
               lambda: pt.ZigZag(D, pt.potentials.grad_gauss)),
    "sticky": (lambda: pf.StickyZigZag(D, lambda x: x, np.full(D, 2.0)),
               lambda: pt.StickyZigZag(D, pt.potentials.grad_gauss, np.full(D, 2.0))),
    "boomerang": (lambda: pf.BoomerangAD(D, pf.utils.potentials.banana, refresh_rate=0.5),
                  lambda: pt.BoomerangAD(D, pt.potentials.banana, refresh_rate=0.5)),
}


def _U_jax(x):
    return jnp.sum(x * x) / 2 + jnp.sum(x[:1] ** 3) / 5


def _U_torch(x):
    return torch.sum(x * x) / 2 + torch.sum(x[:1] ** 3) / 5


def _init(Bc):
    rs = np.random.default_rng(4)
    return rs.normal(size=(Bc, D)) * 0.4, rs.choice([-1.0, 1.0], size=(Bc, D))


@pytest.fixture(scope="module")
def skeletons():
    """Port skeletons (float64, CPU): a horizon batch (padded past each
    chain's n_valid), a trimmed single chain, and an event-count batch."""
    out = {}
    for name, (_, make) in SAMPLERS.items():
        x0, v0 = _init(5)
        kw = dict(seed=3, dtype=torch.float64, device="cpu")
        out[name, "batch"] = pt.sample_skeleton(make(), 12.0, x0, v0, **kw)
        out[name, "single"] = pt.sample_skeleton(make(), 12.0, x0[0], v0[0], **kw)
        out[name, "events"] = pt.sample_skeleton(make(), 50, x0, v0, **kw)
    return out


@pytest.mark.parametrize("B", [0, 7, 64])
@pytest.mark.parametrize("shape", ["batch", "single", "events"])
@pytest.mark.parametrize("name", ["zigzag", "sticky", "boomerang"])
def test_rv_diagnostic_matches_jax(skeletons, name, shape, B):
    skel = skeletons[name, shape]
    got = td.RV_diagnostic(skel, _U_torch, B)
    ref = jd.RV_diagnostic(_jax_skeleton(skel), _U_jax, B)
    if shape == "single":
        assert isinstance(got, float)
        np.testing.assert_allclose(got, ref, rtol=RTOL)
    else:
        assert isinstance(got, torch.Tensor) and got.shape == (skel.t.shape[0],)
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL)
    assert np.all(np.asarray(ref) > 0)


@pytest.mark.parametrize("single", [False, True])
@pytest.mark.parametrize("name", ["zigzag", "sticky", "boomerang"])
def test_sample_skeleton_with_diagnostic_matches_jax_formula(monkeypatch, name, single):
    make_jax, make_port = SAMPLERS[name]
    x0, v0 = _init(6)
    if single:
        x0, v0 = x0[0], v0[0]
    T, n_b = 9.0, 50
    skel, rv = pt.sample_skeleton_with_diagnostic(
        make_port(), T, x0, v0, _U_torch, B=n_b, seed=8, dtype=torch.float64, device="cpu")
    ref_skel = pt.sample_skeleton(make_port(), T, x0, v0, seed=8, dtype=torch.float64,
                                  device="cpu")
    for a, b in zip(skel, ref_skel):
        assert torch.equal(a, b)
    jskel = _jax_skeleton(skel)
    monkeypatch.setattr(pf.api, "sample_skeleton", lambda *a, **k: jskel)
    _, ref = pf.sample_skeleton_with_diagnostic(make_jax(), T, x0, v0, _U_jax, B=n_b)
    if single:
        assert isinstance(rv, float)
        np.testing.assert_allclose(rv, ref, rtol=RTOL)
    else:
        assert rv.shape == (6,)
        np.testing.assert_allclose(rv.numpy(), np.asarray(ref), rtol=RTOL)


def test_sample_skeleton_with_diagnostic_at_zero_horizon():
    s = pt.ZigZag(D, pt.potentials.grad_gauss)
    x0, v0 = _init(3)
    _, rv = pt.sample_skeleton_with_diagnostic(s, 0.0, x0, v0, _U_torch, device="cpu",
                                               dtype=torch.float64)
    assert torch.equal(rv, torch.zeros(3, dtype=torch.float64))
    _, rv1 = pt.sample_skeleton_with_diagnostic(s, 0.0, x0[0], v0[0], _U_torch,
                                                device="cpu", dtype=torch.float64)
    assert rv1 == 0.0


def _broken(skel, single):
    """The skeleton with its (or its first chain's) last time set to NaN."""
    t = skel.t.clone()
    if single:
        t[-1] = float("nan")
    else:
        t[0, int(skel.n_valid[0]) - 1] = float("nan")
    return skel._replace(t=t)


@pytest.mark.parametrize("shape", ["batch", "single"])
@pytest.mark.parametrize("what", ["negative B", "bad t_end"])
def test_rv_validation_messages_match_jax(skeletons, shape, what):
    skel = skeletons["zigzag", shape]
    B = -1 if what == "negative B" else 4
    if what == "bad t_end":
        skel = _broken(skel, shape == "single")
    with pytest.raises(ValueError) as got:
        td.RV_diagnostic(skel, _U_torch, B)
    with pytest.raises(ValueError) as ref:
        jd.RV_diagnostic(_jax_skeleton(skel), _U_jax, B)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("shape", ["batch", "single"])
def test_diagnostic_figure_builds(skeletons, shape, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    skel = skeletons["sticky", shape]
    path = tmp_path / "diag.png"
    fig = pt.diagnostic(skel, save_path=str(path))
    jd.diagnostic(_jax_skeleton(skel))
    lines = capsys.readouterr().out.splitlines()
    assert fig is not None and path.exists()
    assert lines[0] == lines[1] and lines[0].startswith("number of error bound:")
    titles = [ax.get_title() for ax in fig.axes]
    assert len(titles) == 4 and titles[0] == "Time between events histogram"
    import matplotlib.pyplot as plt

    plt.close("all")

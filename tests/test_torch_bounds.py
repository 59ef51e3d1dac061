"""The port's batched thinning envelopes against the JAX package's.

``pdmpflux_tpu_torch.core.bounds`` builds every chain's envelope at once;
the JAX functions build one chain's and are mapped over chains with
``jax.vmap``.  Inputs are made from a seed with numpy and both run in
float64 on the CPU.  Every envelope function is held to the JAX one at
rtol 1e-12 (atol 1e-12 near zero), in both time-derivative modes, on the
Zig-Zag's rates at the Gaussian and the banana (d = 10) and the
one-dimensional Gaussian (d = 1); ``next_event`` is inverted at draws inside
and past each envelope.

One exception: finite-difference tangents are held at rtol 1e-7.  XLA
contracts products and sums into fused multiply-adds and sums a rate over
coordinates in its own order, so its rate and torch's can differ in the last
bit, and a central difference over a step of ``sqrt(eps) * max(1, |t|)``
turns that bit into a relative slope difference of up to ``eps / sqrt(eps)``,
about 1.5e-8 (measured: 1e-9 on the envelopes).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core import bounds as jb  # noqa: E402
from pdmpflux_tpu_torch.core import bounds as tb  # noqa: E402

B = 12
RTOL = ATOL = 1e-12
FD_RTOL = 1e-7
POTENTIALS = {
    "gauss": (10, pf.utils.potentials.gauss, pt.potentials.gauss),
    "banana": (10, pf.utils.potentials.banana, pt.potentials.banana),
    "gauss_1d": (1, pf.utils.potentials.gauss_1d, pt.potentials.gauss_1d),
}


def _inputs(d, seed):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(B, d))
    v = rs.choice([-1.0, 1.0], size=(B, d))
    h = rs.uniform(0.2, 3.0, size=B)
    return x, v, h


def _samplers(pot, tderiv):
    d, jU, tU = POTENTIALS[pot]
    kw = dict(tderiv=tderiv)
    return d, pf.ZigZagAD(d, jU, **kw), pt.ZigZagAD(d, tU, **kw)


def _close(got, want, what, rtol=RTOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=ATOL,
                               err_msg=what)


def _boxes_equal(tbox, jbox, what, rtol=RTOL):
    for f in ("grid", "box_max", "cum_sum", "step_size"):
        _close(getattr(tbox, f), getattr(jbox, f), f"{what}: {f}", rtol)


@pytest.mark.parametrize("tderiv", ["jvp", "finite_diff"])
@pytest.mark.parametrize("pot", list(POTENTIALS))
def test_envelopes_match_jax(pot, tderiv):
    d, js, ts = _samplers(pot, tderiv)
    rtol = FD_RTOL if tderiv == "finite_diff" else RTOL
    x, v, h = _inputs(d, 11)
    tx, tv, th = (torch.as_tensor(a) for a in (x, v, h))
    jx, jv, jh = (jnp.asarray(a) for a in (x, v, h))
    for n_grid in (2, 10, 33):
        tbox = tb.upper_bound_grid(lambda t: ts.rate(tx, tv, t), th, n_grid, 0.3, tderiv)
        jbox = jax.vmap(lambda x_, v_, h_: jb.upper_bound_grid(
            lambda t: js.rate(x_, v_, t), h_, n_grid, 0.3, tderiv))(jx, jv, jh)
        _boxes_equal(tbox, jbox, f"grid n={n_grid}", rtol)
        tvec = tb.upper_bound_grid_vect(lambda t: ts._signed_rate_vect(tx, tv, t), th,
                                        n_grid, tderiv)
        jvec = jax.vmap(lambda x_, v_, h_: jb.upper_bound_grid_vect(
            lambda t: js._signed_rate_vect(x_, v_, t), h_, n_grid, tderiv))(jx, jv, jh)
        _boxes_equal(tvec, jvec, f"grid_vect n={n_grid}", rtol)
    tcon = tb.upper_bound_constant(lambda t: ts.rate(tx, tv, t), th, 0.25)
    jcon = jax.vmap(lambda x_, v_, h_: jb.upper_bound_constant(
        lambda t: js.rate(x_, v_, t), h_, 0.25))(jx, jv, jh)
    _boxes_equal(tcon, jcon, "constant", rtol)
    # the sampler's own strategy resolution gives the same envelope
    _boxes_equal(ts.bound_box(tx, tv, th),
                 jax.vmap(js.bound_box)(jx, jv, jh), "bound_box", rtol)


@pytest.mark.parametrize("pot", list(POTENTIALS))
def test_next_event_matches_jax(pot):
    d, js, ts = _samplers(pot, "jvp")
    x, v, h = _inputs(d, 12)
    tx, tv, th = (torch.as_tensor(a) for a in (x, v, h))
    jx, jv, jh = (jnp.asarray(a) for a in (x, v, h))
    tbox = ts.bound_box(tx, tv, th)
    jbox = jax.vmap(js.bound_box)(jx, jv, jh)
    total = np.asarray(jbox.cum_sum)[:, -1]
    rs = np.random.default_rng(13)
    # inside the envelope, halfway between its grid points' masses, past it
    # and at 0 (an exact tie with a grid point's mass would test the last
    # bit of the two cumulative sums, which XLA adds in its own order)
    cum = np.asarray(jbox.cum_sum)
    for draw in (rs.uniform(0, 1, B) * total, (cum[:, 2] + cum[:, 3]) / 2,
                 total * (1 + rs.uniform(0.01, 1, B)), np.zeros(B)):
        tt, tl = tb.next_event(tbox, torch.as_tensor(draw))
        jt, jl = jax.vmap(jb.next_event)(jbox, jnp.asarray(draw))
        assert np.array_equal(np.isinf(tt.numpy()), np.isinf(np.asarray(jt)))
        fin = np.isfinite(np.asarray(jt))
        np.testing.assert_allclose(tt.numpy()[fin], np.asarray(jt)[fin], rtol=RTOL,
                                   atol=ATOL)
        _close(tl, jl, "lam")


def test_linspace_matches_jax():
    h = np.random.default_rng(14).uniform(0.1, 9.0, size=B)
    for n in (2, 9, 17, 64):
        got = tb.linspace0(torch.as_tensor(h), n).numpy()
        want = np.asarray(jax.vmap(lambda a: jnp.linspace(0.0, a, n))(jnp.asarray(h)))
        np.testing.assert_array_equal(got, want)

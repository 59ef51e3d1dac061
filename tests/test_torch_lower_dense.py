"""Gradients that couple coordinates through a constant matrix, lowered into
the chunk kernels' generated potential, against JAX.

* The plain chunk kernels fed the IR's torch pair (``ops/cuda/lower.py``
  through ``driver.lowered_config``, the config the card's kernels take)
  against JAX's Pallas kernel in interpret mode on the jnp twin, from one
  JAX state (``test_torch_lower_slice.run_both``), float64, D = 6: a
  correlated Gaussian ``0.5 x P x`` (``P = Sigma^-1``, ``Sigma_ij =
  0.9^|i-j|``) and a Bayesian logistic regression ``sum log1p(exp(X b)) -
  y . X b + |b|^2 / 200`` (``X`` 40 x 6 with an intercept column, labels
  from a seeded ``b*``; JAX hoists ``X`` and ``y`` into the kernel's
  operands) on K1 (events, horizon), K6, K4 (events, horizon), K3 BPS
  (events, horizon), the Boomerang and K5; the quartic sum ``|x|^2 / 2 +
  log1p(sum x^4)`` (a sum of degree 4, formed at every point) on K1 and K6.
  Integers and the activity mask equal, floats to rtol and atol 1e-12.
* The whole ``sample_skeleton`` of the logistic ``ZigZagAD`` in both
  packages, the port's through the lowered pair (the plain K1 and K2), JAX's
  through its stream fills with the Pallas kernel interpreted.
* The products' ordered sums: ``core.dims.ordered_matvec`` is
  ``ordered_sum`` of the products bit for bit.
  (Each kernel's header and hoisted data: ``tests/test_torch_lower.py``.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core import engine  # noqa: E402
from pdmpflux_tpu.core.types import EV_INIT  # noqa: E402
from pdmpflux_tpu.ops.pallas import driver as pdrv  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402
from pdmpflux_tpu_torch.core.dims import ordered_matvec, ordered_sum  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import driver as tdrv  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from test_torch_lower_slice import D, check_outputs, run_both  # noqa: E402

N_ROWS = 40
_rs = np.random.default_rng(40)
XN = np.concatenate([np.ones((N_ROWS, 1)), _rs.normal(size=(N_ROWS, D - 1))], 1)
BETA = _rs.normal(size=D) * 0.5
YN = (_rs.random(N_ROWS) < 1.0 / (1.0 + np.exp(-XN @ BETA))).astype(np.float64)
PN = np.linalg.inv(0.9 ** np.abs(np.subtract.outer(np.arange(D), np.arange(D))))


def _const(np_, a):
    return jnp.asarray(a) if np_ is jnp else torch.as_tensor(a)


def corr_gauss(np_):
    """``U = x P x / 2``, P the inverse of the AR(1) covariance 0.9^|i-j|."""
    P = _const(np_, PN)
    return lambda x: 0.5 * x @ (P @ x)


def logistic(np_):
    """The Bayesian logistic regression: ``sum softplus(X b) - y . X b`` with
    softplus written ``log1p(exp(.))`` in both packages, and the N(0, 10^2 I)
    prior."""
    X, y = _const(np_, XN), _const(np_, YN)

    def U(b):
        z = X @ b
        return np_.sum(np_.log1p(np_.exp(z)) - y * z) + b @ b / 200.0

    return U


def quartic(np_):
    """``U = |x|^2 / 2 + log1p(sum x^4)``: a sum of degree 4 in x."""
    return lambda x: x @ x / 2.0 + np_.log1p(np_.sum(x ** 4))


TARGETS = {"corr": corr_gauss, "logistic": logistic, "quartic": quartic}
DENSE_KERNELS = [("zigzag", False), ("zigzag", True), ("sticky", False), ("suzz", False),
                 ("suzz", True), ("bps", False), ("bps", True), ("boomerang", False),
                 ("ecmc", False)]
CASES = ([(k, t, h) for t in ("corr", "logistic") for k, h in DENSE_KERNELS]
         + [("zigzag", "quartic", False), ("sticky", "quartic", False)])


@pytest.mark.parametrize("kernel,target,horizon", CASES)
def test_plain_kernel_on_dense_gradient_matches_pallas(kernel, target, horizon):
    check_outputs(*run_both(kernel, target, horizon, targets=TARGETS))


def test_ordered_matvec_is_ordered_sum():
    rs = np.random.default_rng(3)
    m, u = torch.as_tensor(rs.normal(size=(7, 13))), torch.as_tensor(rs.normal(size=(13, 5)))
    assert torch.equal(ordered_matvec(m, u), ordered_sum(m[:, :, None] * u[None], 1)[:, 0])


B_SK, N_SK, T_CAP, CHUNK, TILE, SEED = 64, 24, 32, 16, 64, 11


def test_logistic_zigzag_sample_skeleton_matches_jax(monkeypatch):
    """The slice as a whole on the logistic regression: the port's
    ``sample_skeleton`` with the chunk config made the lowered one (as the
    stream driver makes it on the card) against JAX's fused path (stream
    fills of ``make_pallas_stream_runner``, the Pallas kernel interpreted,
    each fill's event rows appended per chain), float64, fills of 32 rows so
    that chains straggle into a second fill."""
    skeleton_matches_jax(monkeypatch, logistic)


def skeleton_matches_jax(monkeypatch, target, d=D):
    """A ``ZigZagAD`` on ``target`` (a function of a numpy-like module) at
    dimension ``d``: the port's ``sample_skeleton`` through the lowered pair
    against JAX's stream fills, as above."""
    js, ts = pf.ZigZagAD(d, target(jnp)), pt.ZigZagAD(d, target(torch))
    rs = np.random.default_rng(SEED)
    x0 = rs.normal(size=(B_SK, d)) * 0.3
    v0 = rs.choice([-1.0, 1.0], size=(B_SK, d))

    target = N_SK - 1
    keys = jax.random.split(jax.random.key(SEED), B_SK)
    st = jax.vmap(lambda a, b, k: js.init_state(a, b, k, dtype=jnp.float64))(
        jnp.asarray(x0), jnp.asarray(v0), keys)
    init = jax.vmap(lambda s: engine.event_from_state(s, EV_INIT))(st)
    run = jax.jit(pdrv.make_pallas_stream_runner(js, T_CAP, target, chunk=CHUNK, tile=TILE,
                                                 interpret=True))
    rows = {f: [[np.asarray(getattr(init, f))[b]] for b in range(B_SK)] for f in init._fields}
    counts = jnp.zeros((B_SK,), jnp.int32)
    fills = 0
    while not bool((np.asarray(counts) >= target).all()):
        res = run(st, engine.empty_stream(T_CAP, d, jnp.float64, B_SK), counts)
        st, counts = res.state, res.counts
        fills += 1
        stream = {f: np.asarray(getattr(res.stream, f)) for f in init._fields}
        for b in range(B_SK):
            ev = stream["kind"][b] > 0
            for f in init._fields:
                rows[f][b].extend(stream[f][b][ev])
    assert fills >= 2
    ref = {f: np.stack([np.stack(r[:N_SK]) for r in rows[f]]) for f in init._fields}

    configs = []
    plain_config = tdrv.chunk_config

    def lowered(sampler, K, cap, tile):
        cfg = tdrv.lowered_config(plain_config(sampler, K, cap, tile), sampler, d,
                                  torch.float64, "cpu")
        configs.append(cfg)
        return cfg

    monkeypatch.setattr(tdrv, "chunk_config", lowered)
    skel = pt.sample_skeleton(ts, N_SK, x0, v0, seed=SEED, dtype=torch.float64, device="cpu",
                              t_cap=T_CAP, chunk=CHUNK, tile=TILE)
    assert configs and all(c.device_potential == lower.USER_POTENTIAL for c in configs)
    got = convert.skeleton_to_numpy(skel)
    assert (got["n_valid"] == N_SK).all()
    for f, a in ref.items():
        assert got[f].shape == a.shape and got[f].dtype == a.dtype, f
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[f], a, rtol=1e-12, atol=1e-12, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)

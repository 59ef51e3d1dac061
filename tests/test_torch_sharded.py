"""The port's chain-batch helpers (``parallel/sharded.py``) against the JAX
package's, on a padded batch skeleton with irregular clocks and ``n_valid``.

Equal-time sample times ``k * (t_end / n)`` must be JAX's bit for bit at an
``n`` that is not a power of two (300): both divide ``t_end`` by ``n`` once.
The JAX functions run eagerly, as written; under ``jax.jit`` XLA's CPU
backend turns the division into a multiplication by ``1 / n``.  Pooled
moments reduce in another order, so they agree to ``rtol 1e-12`` in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu as pf  # noqa: E402
import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu.core.types import Skeleton  # noqa: E402
from pdmpflux_tpu_torch import convert  # noqa: E402

N_PER_CHAIN = 300


def batch_fields(dtype, B=7, N=40, d=3, seed=0):
    """A padded chain-batch skeleton as numpy fields: clocks from random
    gaps, zeros past each chain's ``n_valid``, a frozen coordinate here and
    there."""
    rs = np.random.default_rng(seed)
    nv = rs.integers(5, N + 1, size=B).astype(np.int32)
    pad = np.arange(N)[None, :] >= nv[:, None]
    t = np.cumsum(rs.exponential(0.37, size=(B, N)), axis=1)
    t[:, 0] = 0.0
    t[pad] = 0.0
    fields = dict(
        x=rs.normal(size=(B, N, d)), v=rs.choice([-1.0, 1.0], size=(B, N, d)), t=t,
        horizon=np.ones((B, N)), ar=np.zeros((B, N)),
        is_active=rs.uniform(size=(B, N, d)) < 0.9,
        rejected=np.zeros((B, N), np.int32), errored_bound=np.zeros((B, N), np.int32),
        hitting_horizon=np.zeros((B, N), np.int32), error_value_ar=np.zeros((B, N, 5)),
        kind=np.full((B, N), pf.EV_JUMP, np.int32), n_valid=nv)
    return {f: a.astype(dtype) if a.dtype == np.float64 else a for f, a in fields.items()}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_batch_sample_times_match_jax_bit_for_bit(dtype):
    fields = batch_fields(dtype)
    js, ts = pf.ZigZag(3, lambda x: x), pt.ZigZag(3, pt.potentials.grad_gauss)
    got = pt.sample_from_skeleton_batch(ts, N_PER_CHAIN, convert.skeleton_from_numpy(
        fields, device="cpu"), discard_vt=False).numpy()
    want = np.asarray(pf.parallel.sample_from_skeleton_batch(
        js, N_PER_CHAIN, Skeleton(**{f: jnp.asarray(a) for f, a in fields.items()}),
        discard_vt=False))
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got[..., -1], want[..., -1])
    rtol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol)


def test_pooled_moments_match_jax_f64():
    fields = batch_fields(np.float64, seed=1)
    js, ts = pf.ZigZag(3, lambda x: x), pt.ZigZag(3, pt.potentials.grad_gauss)
    got = pt.pooled_moments(convert.skeleton_from_numpy(fields, device="cpu"), ts,
                            N_PER_CHAIN)
    want = pf.parallel.pooled_moments(
        Skeleton(**{f: jnp.asarray(a) for f, a in fields.items()}), js, N_PER_CHAIN)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12)

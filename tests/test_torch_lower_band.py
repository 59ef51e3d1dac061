"""Gradients that read coordinates other than their own (neighbours at fixed
offsets, ``x[k]`` past coordinate 1), lowered into the chunk kernels'
generated potential, against ``torch.func`` and JAX.

The targets, each written as a user writes it (float64, D = 6):

* ``ar1``: the AR(1) prior in its innovation form, ``x_0^2 / 2 + sum((x[1:]
  - rho x[:-1])^2) / (2 (1 - rho^2))``, whose precision is the tridiagonal
  inverse of ``rho^|i-j|`` (rho = 0.9);
* ``band``: ``sum(x[:-1] * x[1:]) + sum(x^2)``, a coupling of neighbours;
* ``x5``: ``x[5]^2 + |x|^2 / 2``, a read of a fixed coordinate past 1;
* ``neal_last``: Neal's funnel with its scale at ``x[-1]`` in place of
  ``x[0]`` (coordinate d - 1 reads a sum over ``x[:-1]``).

* Each target's lowered pair against ``torch.func.jvp`` at rtol 1e-12 on
  all six kernels; K1 and K6 keep their chain moments (no point context);
  so do two gradients written directly, a band assembled with ``cat`` and
  fixed coordinates assembled with ``stack``.
* The plain chunk kernels fed the IR's pair (``driver.lowered_config``, the
  config the card's kernels take) against JAX's Pallas kernel in interpret
  mode on the jnp twin, from one JAX state (``test_torch_lower_slice
  .run_both``): K1, K6, K4 and K3 in events and horizon mode, the Boomerang
  and K5 in events mode; integers and the activity mask equal, floats to
  rtol and atol 1e-12.
* The whole ``sample_skeleton`` of the AR(1) ``ZigZagAD`` against JAX's
  stream fills; the AR(1) pair against the dense ``0.5 x P x`` pair; a read
  outside ``[0, d)`` refused.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pdmpflux_tpu_torch.models.base import resolve_potential  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from test_torch_lower_dense import skeleton_matches_jax  # noqa: E402
from test_torch_lower_slice import D, check_outputs, run_both  # noqa: E402

RHO = 0.9
RTOL = ATOL = 1e-12


def ar1(np_):
    """The AR(1) prior with unit marginal variance, innovation form."""
    return lambda x: x[0] * x[0] / 2 + np_.sum((x[1:] - RHO * x[:-1]) ** 2) / (2 * (1 - RHO ** 2))


def band(np_):
    """``sum(x[:-1] x[1:]) + |x|^2``: precision 2 I plus ones beside the diagonal."""
    return lambda x: np_.sum(x[:-1] * x[1:]) + np_.sum(x ** 2)


def x5(np_):
    return lambda x: x[5] ** 2 + np_.sum(x ** 2) / 2


def neal_last(np_):
    """Neal's funnel with its scale last: ``x[-1]`` plays ``x[0]``'s part."""
    return lambda x: (x[-1] * x[-1] / 18.0 + 0.5 * (x.shape[0] - 1) * x[-1]
                      + 0.5 * np_.sum(x[:-1] ** 2) * np_.exp(-x[-1]))


TARGETS = {"ar1": ar1, "band": band, "x5": x5, "neal_last": neal_last}
KERNEL_MODES = [("zigzag", False), ("zigzag", True), ("sticky", False), ("sticky", True),
                ("suzz", False), ("suzz", True), ("bps", False), ("bps", True),
                ("boomerang", False), ("ecmc", False)]
CASES = [(k, t, h) for t in TARGETS for k, h in KERNEL_MODES]


def _points(seed, n=33):
    rs = np.random.default_rng(seed)
    return (torch.as_tensor(rs.normal(size=(D, n)) * 1.3),
            torch.as_tensor(rs.normal(size=(D, n))))


def _reference(grad, x, v):
    return torch.func.jvp(torch.func.vmap(grad, in_dims=1, out_dims=1), (x,), (v,))


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_band_pair_matches_torch_func(target):
    """The IR's pair against ``torch.func.jvp(vmap(grad))`` at rtol 1e-12 on
    every kernel, the gradient alone its first half bit for bit; every
    target reads other coordinates (``reads_others``) and stays off K1/K6's
    point context."""
    grad = resolve_potential(TARGETS[target](torch), D)[1]
    x, v = _points(len(target))
    want_g, want_dg = _reference(grad, x, v)
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(grad, kernel, D, torch.float64)
        g, dg = low.grad_jvp(x, v)
        torch.testing.assert_close(g, want_g, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(dg, want_dg, rtol=RTOL, atol=ATOL)
        assert torch.equal(low.grad(x), g)
        assert low.point == (kernel not in lower.MOMENT_KERNELS)
        text = low.header()
        assert "reads_others = true" in text and "F yw, T& g, T& dg" in text
        if target == "x5":
            assert "yw(5, yk5, wk5);" in text
        if target == "neal_last":  # the sum over x[:-1], read at x[-1]
            assert len(low.reductions) == 1 and f"yw({D - 1}, yk{D - 1}," in text
        if target in ("ar1", "band"):
            assert "yw(i - 1, ym1, wm1);" in text and "yw(i + 1, yp1, wp1);" in text


def _zero(x):
    return torch.zeros(1, dtype=x.dtype, device=x.device)


DIRECT = {
    # a band assembled with cat: x_i - 0.4 (x_{i+1} + x_{i-1})
    "cat": lambda x: x - 0.4 * (torch.cat([x[1:], _zero(x)]) + torch.cat([_zero(x), x[:-1]])),
    # every coordinate a chain value of fixed coordinates, assembled with stack
    "stack": lambda x: torch.stack([x[0] - x[1], x[1] - x[0], x[2], x[3], x[4], x[5] * x[3]]),
}


@pytest.mark.parametrize("name", sorted(DIRECT))
def test_direct_gradient_reading_other_coordinates(name):
    """A gradient written directly (no ``torch.func``) that assembles its
    coordinates from neighbours with ``cat`` or from fixed coordinates with
    ``stack``: the pair against ``torch.func`` on every kernel."""
    grad = DIRECT[name]
    x, v = _points(11)
    want_g, want_dg = _reference(grad, x, v)
    for kernel in lower.SOURCES:
        g, dg = lower.lower_gradient(grad, kernel, D, torch.float64).grad_jvp(x, v)
        torch.testing.assert_close(g, want_g, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(dg, want_dg, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kernel,target,horizon", CASES)
def test_plain_kernel_on_band_gradient_matches_pallas(kernel, target, horizon):
    check_outputs(*run_both(kernel, target, horizon, targets=TARGETS))


def test_ar1_zigzag_sample_skeleton_matches_jax(monkeypatch):
    """The slice as a whole on the banded AR(1): the port's ``sample_skeleton``
    through the lowered pair against JAX's stream fills, float64."""
    skeleton_matches_jax(monkeypatch, ar1)


@pytest.mark.parametrize("kernel", ["zigzag", "sticky", "bps"])
def test_band_ar1_matches_dense_precision(kernel):
    """The banded AR(1) pair against the dense ``0.5 x P x`` pair, ``P`` the
    tridiagonal inverse of ``rho^|i-j|`` written out, rtol 1e-12."""
    c = 1.0 / (1.0 - RHO ** 2)
    P = np.diag(np.r_[c, np.full(D - 2, (1.0 + RHO ** 2) * c), c])
    P += np.diag(np.full(D - 1, -RHO * c), 1) + np.diag(np.full(D - 1, -RHO * c), -1)
    np.testing.assert_allclose(np.linalg.inv(P), RHO ** np.abs(np.subtract.outer(
        np.arange(D), np.arange(D))), rtol=1e-12, atol=1e-12)
    Pt = torch.as_tensor(P)
    banded = lower.lower_gradient(resolve_potential(ar1(torch), D)[1], kernel, D, torch.float64)
    dense = lower.lower_gradient(resolve_potential(lambda x: 0.5 * x @ (Pt.to(x) @ x), D)[1],
                                 kernel, D, torch.float64)
    assert dense.products and not banded.products
    x, v = _points(9)
    for a, b in zip(banded.grad_jvp(x, v), dense.grad_jvp(x, v)):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_a_read_outside_the_chain_is_refused():
    """A piece whose neighbour or fixed coordinate falls outside ``[0, d)``
    raises ``LoweringError`` (a correct trace never builds one: its slices
    are static)."""
    b = lower.Graph(torch.float64)
    up, down = b.near("y", 1), b.near("w", -2)
    lower.check_reads(lower.Piece(0, D - 1, 0, up), D)
    lower.check_reads(lower.Piece(2, D, 0, down), D)
    lower.check_reads(lower.Piece(0, 1, None, b.coord("y", D - 1)), D)
    for pc in (lower.Piece(0, D, 0, up), lower.Piece(1, D, 0, down),
               lower.Piece(0, D - 1, 1, up), lower.Piece(0, 1, None, b.coord("y", D))):
        with pytest.raises(lower.LoweringError, match="outside \\[0, 6\\)"):
            lower.check_reads(pc, D)

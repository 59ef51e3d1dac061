"""Running sums, flips and periodic shifts (``cumsum``, ``flip``, ``roll``)
lowered into the chunk kernels' generated potential, against ``torch.func``
and JAX.

The targets, each written as a user writes it (float64, at D = 9 and at
D = 36, past K1's 16 lanes and past the plain version's 32 runs of a
per-transition running sum):

* ``local_level``: the local level model of Durbin & Koopman (2012, ch. 2)
  in non-centred form, ``|z|^2 / 2 + sum((y - s cumsum(z))^2) / 2`` with
  ``s^2 = q = 1469.1 / 15099`` (their Nile estimate), ``y`` drawn from the
  model; its gradient traces to ``cumsum, flip, cumsum, flip``: a prefix
  and a suffix running sum, both of inputs affine in the point;
* ``poisson_rw``: Poisson counts on a random-walk log-intensity ``a + s
  cumsum(z)`` (a = log 5, s = 0.05), a suffix running sum of ``exp`` of it;
* ``phi4_2d``: the scalar phi^4 action of Albergo et al. (arXiv:2101.08176)
  on ``x.reshape(L, L)``, ``M2 = -4``, ``lam = 8``, neighbours by ``roll``
  along both axes (L = 3 and 6 here; 8 on the card);
* ``flip_pair``: ``|x - 0.5 flip(x)|^2 / 2``.

* Each target's lowered pair against ``torch.func.jvp`` at rtol 1e-12 on
  all six kernels, and the per-transition pair (``Lowered.along``) against
  it along the flow; the local level's gradient against its dense form
  ``P z - s L^T y``; gradients written directly that flip a hoisted
  parameter's product or a slice and roll a weighted vector.
* The plain chunk kernels fed the IR's pair (``driver.lowered_config``)
  against JAX's Pallas kernel in interpret mode on the jnp twin
  (``test_torch_lower_slice.run_both``): K1, K6, K4 and K3 in events and
  horizon mode, the Boomerang and K5 in events mode; integers and the
  activity mask equal, floats to rtol and atol 1e-12.
* The whole ``sample_skeleton`` of ``ZigZagAD(local_level)`` against JAX's
  stream fills.
* The route: per transition on K1 and K3/K5 where the input is affine, at
  the point otherwise; the plain running sums' order; refusals of a
  ``roll`` and a ``flip`` of a stage's output and of ``cumprod``.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pdmpflux_tpu_torch.models.base import resolve_potential  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from test_torch_lower_dense import skeleton_matches_jax  # noqa: E402
from test_torch_lower_slice import check_outputs, run_both  # noqa: E402

RTOL = ATOL = 1e-12
DS = (9, 36)
Q = 1469.1 / 15099.0
SIGMA_ETA = math.sqrt(Q)
A_LOG, SIGMA_RW = math.log(5.0), 0.05
M2, LAM = -4.0, 8.0


def _model_draws(n=1000, seed=19):
    """``y`` of the local level and of the Poisson walk, drawn from each
    model at length ``n`` (a target at d reads the first d: the walk's
    prefix is the model at d)."""
    rs = np.random.default_rng(seed)
    level = SIGMA_ETA * np.cumsum(rs.normal(size=n)) + rs.normal(size=n)
    counts = rs.poisson(np.exp(A_LOG + SIGMA_RW * np.cumsum(rs.normal(size=n)))).astype(float)
    return level, counts


Y_LEVEL, Y_COUNTS = _model_draws()


def _const(np_, a):
    return jnp.asarray(a) if np_ is jnp else torch.as_tensor(a)


def local_level(np_):
    """The non-centred local level model, sigma_eps = 1."""
    def U(z):
        y = _const(np_, Y_LEVEL[:z.shape[0]])
        return np_.sum(z * z) / 2 + np_.sum((y - SIGMA_ETA * np_.cumsum(z, 0)) ** 2) / 2
    return U


def poisson_rw(np_):
    """Poisson counts on the log-intensity ``a + s cumsum(z)``."""
    def U(z):
        y = _const(np_, Y_COUNTS[:z.shape[0]])
        eta = A_LOG + SIGMA_RW * np_.cumsum(z, 0)
        return np_.sum(z * z) / 2 + np_.sum(np_.exp(eta) - y * eta)
    return U


def phi4_2d(np_):
    """The scalar phi^4 action on an L x L periodic lattice, L^2 = d."""
    def U(x):
        L = math.isqrt(x.shape[0])
        p = x.reshape(L, L)
        action = M2 * p * p + LAM * p ** 4
        for mu in (0, 1):
            action = (action + 2 * p * p - p * np_.roll(p, -1, mu)
                      - p * np_.roll(p, 1, mu))
        return np_.sum(action)
    return U


def flip_pair(np_):
    return lambda x: np_.sum((x - 0.5 * np_.flip(x, (0,))) ** 2) / 2


TARGETS = {"local_level": local_level, "poisson_rw": poisson_rw, "phi4_2d": phi4_2d,
           "flip_pair": flip_pair}
KERNEL_MODES = [("zigzag", False), ("zigzag", True), ("sticky", False), ("sticky", True),
                ("suzz", False), ("suzz", True), ("bps", False), ("bps", True),
                ("boomerang", False), ("ecmc", False)]


def _grad(target, d):
    return resolve_potential(TARGETS[target](torch), d)[1]


def _points(seed, d, n=17):
    rs = np.random.default_rng(seed)
    return (torch.as_tensor(rs.normal(size=(d, n))),
            torch.as_tensor(rs.normal(size=(d, n))))


def _reference(grad, x, v):
    return torch.func.jvp(torch.func.vmap(grad, in_dims=1, out_dims=1), (x,), (v,))


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("target", sorted(TARGETS))
def test_scan_pair_matches_torch_func(target, d):
    """The IR's pair against ``torch.func.jvp(vmap(grad))`` at rtol 1e-12 on
    every kernel, the gradient alone its first half bit for bit; where the
    kernel forms running sums once per transition, the pair along the flow
    (``Lowered.along``, the Boomerang's elliptic one) at the flowed point."""
    grad = _grad(target, d)
    x, v = _points(d + len(target), d)
    want = _reference(grad, x, v)
    tau = torch.as_tensor(np.random.default_rng(d).random(x.shape[1]))
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(grad, kernel, d, torch.float64)
        g, dg = low.grad_jvp(x, v)
        for a, b in zip((g, dg), want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        assert torch.equal(low.grad(x), g)
        if not low.trans:
            continue
        elliptic = kernel == "boomerang"
        c, s = (torch.cos(tau), torch.sin(tau)) if elliptic else (1.0, tau)
        y, w = (x * c + v * s, v * c - x * s) if elliptic else (x + v * tau, v)
        for a, b in zip(low.along(x, v, elliptic)(y, w, tau), _reference(grad, y, w)):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_route_of_each_target(target):
    """Where each target's stages are formed: the local level's two running
    sums (prefix, then suffix) once per transition on K1 and K3/K5, at every
    point on K6 and K4; the Poisson walk's prefix sum per transition, its
    suffix sum after ``exp`` at the point (K1 in point mode); the lattice
    and the flip no stage, their reads of other coordinates through the
    accessor (a flip's at ``c - i``)."""
    d = DS[1]
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(_grad(target, d), kernel, d, torch.float64)
        scans = [pr.scan for _, pr in sorted(low.products.items())]
        text = low.header()
        assert "reads_others = true" in text or target in ("local_level", "poisson_rw")
        affine = kernel in lower.TRANSITION_KERNELS
        if target == "local_level":
            assert scans == ["prefix", "suffix"]
            assert low.lane_bytes() == (0 if affine else 4 * d * 8)
            assert low.trans == (sorted(low.products) if affine else [])
            assert low.point == (kernel != "zigzag")
            if affine:
                assert "__shfl_sync(mask, s, k, parts)" in text and "__syncwarp(mask)" in text
            elif kernel == "sticky":
                assert "block_scan(u" in text and "__shared__ T srows[2][32];" in text
        elif target == "poisson_rw":
            assert scans == ["prefix", "suffix"] and low.point
            assert low.trans == ([min(low.products)] if affine else [])
            assert f"for (int p = {d - 1}; p >= 0; --p)" in text or kernel == "sticky"
        else:
            assert not low.products and low.point == (kernel not in lower.MOMENT_KERNELS)
            if target == "flip_pair":
                assert f"yw({d - 1} - i, ysm1p{d - 1}, wsm1p{d - 1});" in text


def test_local_level_matches_its_dense_precision():
    """The local level's gradient against ``P z - s L^T y`` written out, ``P
    = I + q L^T L``, ``L`` the lower-triangular matrix of ones: the exact
    Gaussian posterior the card's gate reads."""
    d = DS[1]
    L = np.tril(np.ones((d, d)))
    P = np.eye(d) + Q * L.T @ L
    b = SIGMA_ETA * L.T @ Y_LEVEL[:d]
    x, v = _points(3, d)
    for kernel in ("zigzag", "sticky", "bps"):
        g, dg = lower.lower_gradient(_grad("local_level", d), kernel, d,
                                     torch.float64).grad_jvp(x, v)
        torch.testing.assert_close(g, torch.as_tensor(P @ x.numpy() - b[:, None]),
                                   rtol=1e-11, atol=1e-11)
        torch.testing.assert_close(dg, torch.as_tensor(P @ v.numpy()), rtol=1e-11, atol=1e-11)


@pytest.mark.parametrize("kind", ["prefix", "suffix"])
@pytest.mark.parametrize("n", [1, 5, 32, 33, 70])
def test_ordered_scan_order(kind, n):
    """The plain running sum in the kernels' order: one lane's walk adds in
    index order (``cumsum`` of a sequential sum, bit for bit), and the runs
    of a per-transition sum add their totals in run order; both against
    ``torch.cumsum`` to rounding."""
    u = torch.as_tensor(np.random.default_rng(n).normal(size=(n, 3)))
    a = u.flip(0) if kind == "suffix" else u
    walk = [a[0]]
    for r in range(1, n):
        walk.append(walk[-1] + a[r])
    walk = torch.stack(walk)
    assert torch.equal(lower.ordered_scan(u, kind), walk.flip(0) if kind == "suffix" else walk)
    want = torch.cumsum(a, 0)
    want = want.flip(0) if kind == "suffix" else want
    for parts in (2, 16, 32):
        torch.testing.assert_close(lower.ordered_scan(u, kind, parts), want,
                                   rtol=1e-13, atol=1e-13)


PARITY = ([(k, t, h, DS[0]) for t in TARGETS for k, h in KERNEL_MODES]
          + [(k, "local_level", h, DS[1]) for k, h in KERNEL_MODES])


@pytest.mark.parametrize("kernel,target,horizon,d", PARITY)
def test_plain_kernel_on_scan_gradient_matches_pallas(kernel, target, horizon, d):
    check_outputs(*run_both(kernel, target, horizon, targets=TARGETS, d=d))


def test_local_level_zigzag_sample_skeleton_matches_jax(monkeypatch):
    """The slice as a whole on the local level model: the port's
    ``sample_skeleton`` through the lowered pair (two running sums formed
    once per transition) against JAX's stream fills, float64."""
    skeleton_matches_jax(monkeypatch, local_level, d=DS[0])


def test_refusals_of_a_stage_output_and_of_cumprod():
    """A ``roll`` of a flattened ``(n, K)`` matrix's parameters (read at ``i
    / K``), a ``flip`` of a scatter-add's output and a ``cumprod`` raise
    ``LoweringError`` naming the op and ``backend='xla_stream'`` on every
    kernel; rolls and flips of a product's and of a running sum's output
    lower (``test_direct_flips_and_rolls``)."""
    d, n = DS
    W = torch.as_tensor(np.random.default_rng(2).normal(size=(n // 3, 3)))
    P = torch.as_tensor(np.random.default_rng(3).permutation(d))
    cases = {"aten.roll": [(lambda x: x + torch.roll((x.reshape(n // 3, 3) * W.to(x)).reshape(-1),
                                                     1), n)],
             "aten.flip": [(lambda x: x + torch.flip(torch.zeros_like(x).index_add(
                 0, P, x ** 2), (0,)), d)],
             "aten.cumprod": [(lambda x: x + 0.1 * torch.cumprod(torch.tanh(x), 0), d)]}
    for op, grads in cases.items():
        for grad, d in grads:
            for kernel in lower.SOURCES:
                with pytest.raises(lower.LoweringError) as err:
                    lower.lower_gradient(grad, kernel, d, torch.float64)
                assert op in str(err.value) and "backend='xla_stream'" in str(err.value)


_W = np.linspace(0.5, 2.0, DS[0])
_A = np.random.default_rng(2).normal(size=(DS[0], DS[0]))
DIRECT = {
    # a flip of a hoisted parameter's product: the parameters reversed
    "flip_weighted": lambda x: x - 0.5 * torch.flip(torch.as_tensor(_W).to(x) * x, (0,)),
    # a flip of a slice: its reads at c - i for c other than d - 1
    "flip_slice": lambda x: x + 0.3 * torch.cat([torch.flip(x[2:], (0,)), x[:2] ** 2]),
    # a roll of a weighted vector, and a flip of a flip (x itself)
    "roll_weighted": lambda x: (x + 0.3 * torch.roll(torch.as_tensor(_W).to(x) * x, 2)
                                + torch.flip(torch.flip(x, (0,)), (0,)) ** 3),
    # a roll and a flip of a product's and of a running sum's output (refused
    # before ``test_torch_lower_regression.py``): reads of their rows elsewhere
    "roll_product": lambda x: x * torch.roll(torch.as_tensor(_A).to(x) @ x, 1),
    "roll_cumsum": lambda x: x + torch.roll(torch.cumsum(x, 0), 2),
    "flip_product": lambda x: x * torch.flip(torch.as_tensor(_A).to(x) @ x, (0,)),
    "flip_cumsum": lambda x: x + torch.flip(torch.cumsum(x, 0), (0,)),
}


@pytest.mark.parametrize("name", sorted(DIRECT))
def test_direct_flips_and_rolls(name):
    """Gradients written directly that flip or roll hoisted parameters,
    slices, flips, and a product's and a running sum's output: the pair
    against ``torch.func`` on every kernel."""
    d, grad = DS[0], DIRECT[name]
    x, v = _points(13, d)
    want = _reference(grad, x, v)
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(grad, kernel, d, torch.float64)
        for a, b in zip(low.grad_jvp(x, v), want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        if name == "roll_weighted":  # flip(flip(x)) reads x itself
            assert "sm1" not in low.header()

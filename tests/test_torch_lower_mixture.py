"""Log-sum-exp, softmax and small matrix views of the chain, lowered into the
chunk kernels' generated potential, against JAX.

* The plain chunk kernels fed the IR's torch pair (``ops/cuda/lower.py``
  through ``driver.lowered_config``) against JAX's Pallas kernel in interpret
  mode on the jnp twin (``test_torch_lower_slice.run_both``), float64, D = 6,
  on K1 (events, horizon), K6, K4 (events, horizon), K3 BPS (events,
  horizon), the Boomerang and K5:
  - the JAX package's bimodal target (``tests/test_integration.py``):
    ``-logsumexp(stack([a, b]))`` of two chain sums, folded at lowering time;
  - a 4-component Gaussian mixture, mu_k = (+-2, +-2, 0, ...), written with
    the broadcast ``x[None, :] - MU`` (four sums over the coordinates, a
    short axis of 4 vectors) and as ``|x|^2 / 2 - logsumexp(MU @ x - |mu|^2 /
    2)`` (a product into 4 data rows and a max stage over them);
  - a softmax regression ``-(Y * log_softmax(X @ x.reshape(p, K), 1)).sum()
    + |x|^2 / 200`` (K products of the strided columns of ``x.reshape(p,
    K)``, their backward ``X.T @ G`` flattened into the coordinates at ``K r
    + k``), at ``(p, K) = (3, 2)``, and ``(2, 3)`` where the view's rows are
    its short axis (K1 alone); and the ``(K, p)`` layout ``X @ x.reshape(K,
    p).T`` with ``logsumexp`` (the backward's rows one after another): these
    cases in ``tests/test_torch_lower_softmax.py``, so that a run that
    spreads files over workers takes the two files side by side;
  - ``|x|^2 / 2 + logsumexp(x)``, a max stage over the coordinates (K6), a
    batch of two products (``bmm``, K3) and an elementwise gradient on
    ``x.reshape(3, 2)`` flattened back (K3).
  Integers and the activity mask equal, floats to rtol and atol 1e-12.
* The whole ``sample_skeleton`` of the bimodal ``ZigZagAD(1, U)`` in both
  packages (``test_torch_lower_dense.skeleton_matches_jax``).
* The route on the card decided here: each target at its full size takes
  the kernel under ``"auto"`` on ``"cuda"`` for every kernel.
* The max's plain version: the first index that attains it gives its value
  and tangent; refusals of a short axis past ``KMAX`` and of ``cumprod``,
  and ``roll``, refused before, lowered against ``torch.func``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402
from test_torch_lower_dense import skeleton_matches_jax  # noqa: E402
from test_torch_lower_slice import D, check_outputs, run_both  # noqa: E402
from test_torch_lower_transition import _limit  # noqa: E402

N_ROWS = 40


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread for the plain kernels' many small ops: faster
    alone, and a run that puts files side by side keeps its cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _const(np_, a):
    return jnp.asarray(a) if np_ is jnp else torch.as_tensor(a)


def _lse(np_, a, axis):
    if np_ is jnp:
        return jax.scipy.special.logsumexp(a, axis=axis)
    return torch.logsumexp(a, axis)


def _log_softmax(np_, a, axis):
    return jax.nn.log_softmax(a, axis=axis) if np_ is jnp else torch.log_softmax(a, axis)


def bimodal(np_):
    """``tests/test_integration.py:39-43`` as written there, at any d."""
    def U(x):
        a = -np_.sum((x - 2.0) ** 2) / 2
        b = -np_.sum((x + 2.0) ** 2) / 2
        return -_lse(np_, np_.stack([a, b]), 0)

    return U


def mixture_means(d: int, k: int = 4) -> np.ndarray:
    """mu_k = (+-2, +-2, 0, ..., 0): the four sign patterns."""
    mu = np.zeros((k, d))
    signs = np.array([[1, 1], [1, -1], [-1, 1], [-1, -1]], dtype=np.float64)
    mu[:, :2] = 2.0 * signs[:k]
    return mu


MU = mixture_means(D)


def mixture_broadcast(np_, mu=MU):
    """Equal weights, unit covariance: ``-logsumexp(-|x - mu_k|^2 / 2)``."""
    M = _const(np_, mu)
    return lambda x: -_lse(np_, -((x[None, :] - M) ** 2).sum(1) / 2, 0)


def mixture_matrix(np_, mu=MU):
    """The same mixture as ``|x|^2 / 2 - logsumexp(MU x - |mu_k|^2 / 2)``."""
    M, half = _const(np_, mu), _const(np_, (mu * mu).sum(1) / 2)
    return lambda x: x @ x / 2 - _lse(np_, M @ x - half, 0)


def regression_data(n: int, p: int, k: int, seed: int):
    """``X`` (n, p): an intercept column and N(0, 1) columns; one-hot labels
    ``Y`` (n, k) drawn from the softmax of ``X B*`` for a seeded ``B*``."""
    rs = np.random.default_rng(seed)
    X = np.concatenate([np.ones((n, 1)), rs.normal(size=(n, p - 1))], 1)
    logits = X @ rs.normal(size=(p, k))
    prob = np.exp(logits - logits.max(1, keepdims=True))
    prob /= prob.sum(1, keepdims=True)
    labels = (prob.cumsum(1) > rs.random((n, 1))).argmax(1)
    return X, np.eye(k)[labels]


def softmax_pk(X, Y):
    """``-(Y * log_softmax(X @ W, 1)).sum() + |x|^2 / 200``, ``W =
    x.reshape(p, K)``."""
    p, k = X.shape[1], Y.shape[1]

    def target(np_):
        Xc, Yc = _const(np_, X), _const(np_, Y)
        return lambda x: (-(Yc * _log_softmax(np_, Xc @ x.reshape(p, k), 1)).sum()
                          + x @ x / 200.0)

    return target


def softmax_kp(X, Y):
    """The ``(K, p)`` layout: ``Z = X @ x.reshape(K, p).T``, ``U = -(Y *
    Z).sum() + logsumexp(Z, 1).sum() + |x|^2 / 200``."""
    p, k = X.shape[1], Y.shape[1]

    def target(np_):
        Xc, Yc = _const(np_, X), _const(np_, Y)

        def U(x):
            Z = Xc @ x.reshape(k, p).T
            return -(Yc * Z).sum() + _lse(np_, Z, 1).sum() + x @ x / 200.0

        return U

    return target


def lse_coords(np_):
    """``|x|^2 / 2 + logsumexp(x)``: a max over the coordinates."""
    return lambda x: x @ x / 2 + _lse(np_, x, 0)


A_BATCH = np.random.default_rng(45).normal(size=(2, 4, 3))
C_VIEW = np.random.default_rng(46).normal(size=(3, 2)) ** 2 + 0.5


def batched(np_):
    """``|bmm(A, x.reshape(2, 3, 1))|^2 / 2``: a batch of two products, each
    of a 4 x 3 matrix with a row of ``x.reshape(2, 3)``."""
    A = _const(np_, A_BATCH)
    return lambda x: 0.5 * np_.sum(np_.matmul(A, x.reshape(2, 3, 1)) ** 2) + x @ x / 2


def scaled_view(np_):
    """``sum(C * x.reshape(3, 2)^2) / 2 + logsumexp(x)``: an elementwise
    gradient on the strided columns flattened back into the coordinates."""
    C = _const(np_, C_VIEW)
    return lambda x: 0.5 * np_.sum(C * x.reshape(3, 2) ** 2) + _lse(np_, x, 0)


X32, Y32 = regression_data(N_ROWS, 3, 2, seed=41)
X23, Y23 = regression_data(N_ROWS, 2, 3, seed=42)
TARGETS = {"bimodal": bimodal, "mix_broadcast": mixture_broadcast,
           "mix_matrix": mixture_matrix, "softmax_pk": softmax_pk(X32, Y32),
           "softmax_pk_rows": softmax_pk(X23, Y23), "softmax_kp": softmax_kp(X32, Y32),
           "lse_coords": lse_coords, "batched": batched, "scaled_view": scaled_view}
KERNELS = [("zigzag", False), ("zigzag", True), ("sticky", False), ("suzz", False),
           ("suzz", True), ("bps", False), ("bps", True), ("boomerang", False),
           ("ecmc", False)]
CASES = ([(k, t, h) for t in ("bimodal", "mix_broadcast", "mix_matrix") for k, h in KERNELS]
         + [("sticky", "lse_coords", False), ("bps", "batched", False),
            ("bps", "scaled_view", False)])
"""The softmax regression's cases run from ``tests/test_torch_lower_softmax.py``."""


@pytest.mark.parametrize("kernel,target,horizon", CASES)
def test_plain_kernel_on_mixture_matches_pallas(kernel, target, horizon):
    check_outputs(*run_both(kernel, target, horizon, targets=TARGETS))


@pytest.mark.parametrize("target", list(TARGETS))
def test_pair_matches_torch_func(target):
    """Each target's torch pair against ``torch.func`` at random points, on
    the walking kernel (K3) and the moment kernel (K1)."""
    U = TARGETS[target](torch)
    grad = torch.func.grad(U)
    rs = np.random.default_rng(7)
    x, v = (torch.as_tensor(rs.normal(size=(D, 9)) * 2.0) for _ in range(2))
    want = torch.stack([grad(x[:, b]) for b in range(9)], 1)
    dwant = torch.stack([torch.func.jvp(grad, (x[:, b],), (v[:, b],))[1] for b in range(9)], 1)
    for kernel in ("bps", "zigzag"):
        g, dg = lower.lower_gradient(grad, kernel, D, torch.float64).grad_jvp(x, v)
        torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(dg, dwant, rtol=1e-12, atol=1e-12)


def test_bimodal_zigzag_sample_skeleton_matches_jax(monkeypatch):
    """The JAX package's integration target, ``ZigZagAD(1, U)``, through the
    lowered pair (the plain K1 and K2) against JAX's stream fills."""
    skeleton_matches_jax(monkeypatch, bimodal, d=1)


def _full_size():
    """Each target at its full size (the card's phase 44)."""
    mu = mixture_means(100)
    X, Y = regression_data(1000, 20, 5, seed=44)
    return {"bimodal_d1": (1, bimodal), "bimodal_d10": (10, bimodal),
            "mix_broadcast": (100, lambda np_: mixture_broadcast(np_, mu)),
            "mix_matrix": (100, lambda np_: mixture_matrix(np_, mu)),
            "softmax_pk": (100, softmax_pk(X, Y)), "softmax_kp": (100, softmax_kp(X, Y))}


@pytest.mark.parametrize("target", list(_full_size()))
def test_every_target_takes_the_kernel_at_full_size(monkeypatch, target):
    """``pick_backend(..., "auto", d, float32, "cuda")`` is ``"kernel"`` for
    every kernel (K3/K5's limit as its build reports it, K6's the tags' as
    ``test_torch_lower`` stubs it: the card's phase 44 reads K6's with each
    potential's context from its build), with each lane's context within
    ``LANE_BYTES``."""
    monkeypatch.setattr(tsc, "scalar_max_dim", _limit)
    monkeypatch.setattr(tzc, "sticky_max_dim", lambda dt, user=None: 13136)
    d, make = _full_size()[target]
    U = make(torch)
    kappa = np.ones(d)
    samplers = {"zigzag": pt.ZigZagAD(d, U), "sticky": pt.StickyZigZagAD(d, U, kappa),
                "suzz": pt.SpeedUpZigZagAD(d, U), "bps": pt.BPSAD(d, U, refresh_rate=1.0),
                "boomerang": pt.BoomerangAD(d, U, refresh_rate=1.0),
                **({"ecmc": pt.ForwardECMCAD(d, U)} if d > 1 else {})}
    for kernel, s in samplers.items():
        assert tapi.pick_backend(s, "auto", d, torch.float32, "cuda") == "kernel", kernel
        low = lower.lower_sampler(s, "zigzag" if kernel == "sticky" else kernel, d,
                                  torch.float32)
        assert lower.lane_fits(low), (kernel, low.lane_bytes())


def test_mixture_forms():
    """The broadcast mixture keeps K1's and K6's chain moments (four sums of
    degree 2, the log-sum-exp folded at lowering time); ``MU @ x`` makes a
    product into 4 data rows and a max stage over them (K1 forms it once per
    transition); the bimodal stack folds into two sums."""
    grad = torch.func.grad(mixture_broadcast(torch))
    for kernel in ("zigzag", "sticky"):
        low = lower.lower_gradient(grad, kernel, D, torch.float64)
        assert not low.point and low.red_kind == ["sum"] * 4 and not low.products
    low = lower.lower_gradient(torch.func.grad(mixture_matrix(torch)), "zigzag", D,
                               torch.float64)
    assert low.point and low.red_kind == ["max", "sum"] and low.trans == [0]
    assert low.red_space == [4, 4]
    low = lower.lower_gradient(torch.func.grad(bimodal(torch)), "zigzag", 10, torch.float64)
    assert not low.point and low.red_kind == ["sum", "sum"]
    low = lower.lower_gradient(torch.func.grad(bimodal(torch)), "zigzag", 1, torch.float64)
    assert not low.point and not low.stages  # at d = 1 a sum is its one term


def test_headers_take_the_max_and_place_the_rows():
    """K3's lane keeps a running max (a larger value or a NaN over a number
    replaces it); K6 reduces (value, tangent, index) across its block
    (``block_max``, a barrier between the warps' partials and their reads);
    the softmax's backward products fill ``Sums`` slots of p rows each, read
    at ``i % K``, ``i / K``, from one walk of the data rows."""
    low = lower.lower_gradient(torch.func.grad(mixture_matrix(torch)), "bps", D,
                               torch.float64)
    text = low.header()
    assert "> cs.s[0] || (" in text and "!= " in text
    low = lower.lower_gradient(torch.func.grad(mixture_matrix(torch)), "sticky", D,
                               torch.float64)
    text = low.header()
    assert "static void block_max(" in text and "__shared__ int irows[2][32];" in text
    block = text[text.index("static void block_max("):]
    assert block.index("__syncthreads();") < block.index("v = has ? row[l]")
    low = lower.lower_gradient(torch.func.grad(softmax_pk(X32, Y32)(torch)), "suzz", D,
                               torch.float64)
    text = low.header()
    assert low.slot_rows == 3 and "T c[2][3], dc[2][3];" in text
    assert "i % 2 == 0 ? cs.c[0][i / 2] : (cs.c[1][i / 2])" in text
    assert "yw(2 * i + 1, " in text  # column 1 of x.reshape(3, 2)
    assert text.count("u over data rows") == 1 and "// products [2, 3]: (3 x 40) u" in text


def test_ordered_max_takes_the_first_index():
    """Ties take the lowest index, a NaN the first NaN; the value is the
    element itself (-0.0 before 0.0 stays -0.0)."""
    u = torch.tensor([[1.0, -0.0, 3.0, float("nan")],
                      [2.0, 0.0, 3.0, 1.0],
                      [2.0, 0.0, float("nan"), float("nan")]])
    du = torch.arange(12.0).reshape(3, 4)
    val, dval = lower.ordered_max(u, du)
    assert torch.equal(dval, torch.tensor([4.0, 1.0, 10.0, 3.0]))
    assert val[0] == 2.0 and str(val[1].item()) == "-0.0" and val[2:].isnan().all()


def test_refusals_past_kmax_and_of_roll():
    """A short axis past ``KMAX`` (a 17-component mixture at d = 20) and a
    ``cumprod`` raise ``LoweringError`` naming the op and
    ``backend='xla_stream'`` on every kernel; the ``roll`` this test once
    refused lowers, its pair against ``torch.func`` at rtol 1e-12."""
    d = lower.KMAX + 4
    mu = np.random.default_rng(3).normal(size=(lower.KMAX + 1, d))
    rolled = torch.func.grad(lambda x: 0.5 * torch.sum(x * torch.roll(x, 1)))
    x, v = (torch.as_tensor(np.random.default_rng(s).normal(size=(D, 9))) for s in (4, 5))
    want = torch.func.jvp(torch.func.vmap(rolled, in_dims=1, out_dims=1), (x,), (v,))
    for kernel in lower.SOURCES:
        got = lower.lower_gradient(rolled, kernel, D, torch.float64).grad_jvp(x, v)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    cases = {"KMAX": (mixture_broadcast(torch, mu), d),
             "aten.cumprod": (lambda x: 0.5 * torch.sum(torch.cumprod(x, 0) ** 2), D)}
    for what, (U, dim) in cases.items():
        grad = torch.func.grad(U)
        for kernel in lower.SOURCES:
            with pytest.raises(lower.LoweringError) as err:
                lower.lower_gradient(grad, kernel, dim, torch.float32)
            assert what in str(err.value), (kernel, str(err.value))
            assert "backend='xla_stream'" in str(err.value)

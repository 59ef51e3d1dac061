"""The lowering of a user's gradient into the CUDA chunk kernels
(``pdmpflux_tpu_torch/ops/cuda/lower.py``), on the CPU.

* The IR's torch pair ``(grad, grad_jvp)`` on seeded float64 ``(d, B)``
  points against ``torch.func.jvp`` of ``vmap(grad)``, rtol 1e-12: ``lambda
  x: x``, ``sum(x**2) / 2``, a Student-t, ``log cosh``, an anisotropic
  Gaussian with closed-over scales (hoisted into the parameters), a banana
  (``x[0]``, ``x[1]``), Neal's funnel and the funnel (sums over
  ``x[1:]``), a hierarchical mean (a sum over ``x[1:] - x[0]``); and each of the seven device tags' potentials lowered as if
  untagged, against the tag's closed forms (``LANE_POTENTIALS``).
* ``LoweringError`` naming the op for a ``cumprod`` (a coupling other than a
  constant matrix, a running sum or a periodic shift) and a read of one element of a matrix product (reads of
  ``x[5]`` and of neighbouring coordinates lower: ``test_torch_lower_band.py``);
  a sum of a summand of degree past 2 in ``x`` taken by every kernel (K1 and
  K6 form it at every point).
* Products with a constant matrix (``mv``, ``mm``, ``einsum``, ``linear``,
  ``addmv``, data rows and back, nested with sums): the pair against
  ``torch.func``, and each kernel's header hoisting the matrix and the
  labels.
* The generated header's shape per kernel, the cache on the sampler, and
  ``api.pick_backend`` on ``"cuda"`` (no card is needed to decide).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch.models.base import resolve_potential  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402
from pdmpflux_tpu_torch.utils import potentials as tpot  # noqa: E402

D, B = 7, 33
RTOL = 1e-12
ATOL = 1e-12
SCALES = torch.linspace(0.5, 3.0, D, dtype=torch.float64)


def student(x):
    """Student-t with 5 degrees of freedom, ``3 sum log1p(x^2 / 5)``."""
    return 3.0 * torch.sum(torch.log1p(x * x / 5.0))


def neal(x):
    return (x[0] * x[0] / 18.0 + 0.5 * (x.shape[0] - 1) * x[0]
            + 0.5 * torch.sum(x[1:] ** 2) * torch.exp(-x[0]))


USER = {
    "identity": (lambda x: x, False),
    "gauss": (lambda x: torch.sum(x ** 2) / 2, True),
    "student": (student, True),
    "logcosh": (lambda x: torch.sum(torch.log(torch.cosh(x))), True),
    "aniso": (lambda x: torch.sum((x / SCALES.to(x)) ** 2) / 2, True),
    "banana": (lambda x: (x[0] ** 2 + (x[1] - x[0] ** 2 + 1.0) ** 2
                          + torch.sum(x[2:] ** 2)) / 2, True),
    "neal": (neal, True),
    "hier": (lambda x: x[0] ** 2 / 2 + torch.sum((x[1:] - x[0]) ** 2) / 2, True),
    "funnel": (lambda x: (x[0] ** 2 / 2 + (x.shape[0] - 1) * torch.log(x[0])
                          + torch.sum(x[1:] ** 2) / (2 * x[0] ** 2)), True),
}
TAGS = {"gauss": tpot.gauss, "banana": tpot.banana,
        "aniso": tpot.anisotropic_gauss(SCALES.numpy()), "cauchy": tpot.cauchy,
        "ridged": tpot.ridged_gauss, "funnel": tpot.funnel,
        "neal_funnel": tpot.neal_funnel}


def _grad(name):
    f, is_potential = USER[name]
    return resolve_potential(f, D)[1] if is_potential else f


def _points(funnel=False, seed=0):
    rs = np.random.default_rng(seed)
    x = rs.normal(size=(D, B)) * 1.3
    if funnel:
        x[0] = np.abs(x[0]) + 0.5
    return torch.as_tensor(x), torch.as_tensor(rs.normal(size=(D, B)))


def _reference(grad, x, v):
    gv = torch.func.vmap(grad, in_dims=1, out_dims=1)
    return torch.func.jvp(gv, (x,), (v,))


@pytest.mark.parametrize("kernel", ["zigzag", "bps"])
@pytest.mark.parametrize("name", sorted(USER))
def test_torch_pair_matches_torch_func(name, kernel):
    """The IR's pair against ``torch.func.jvp(vmap(grad))`` at rtol 1e-12; the
    gradient alone is the pair's first half, bit for bit."""
    grad = _grad(name)
    low = lower.lower_gradient(grad, kernel, D, torch.float64)
    x, v = _points(name == "funnel", seed=len(name))
    want_g, want_dg = _reference(grad, x, v)
    g, dg = low.grad_jvp(x, v)
    torch.testing.assert_close(g, want_g, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(dg, want_dg, rtol=RTOL, atol=ATOL)
    assert torch.equal(low.grad(x), g)
    if name == "aniso":  # the closed-over scales are the parameters
        torch.testing.assert_close(low.params, SCALES, rtol=0, atol=0)
    if name in ("neal", "funnel", "hier"):
        assert len(low.reductions) == 1  # a sum over x[1:], read by coordinate 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_two_hoisted_vectors_of_another_dtype(dtype):
    """Two closed-over float64 vectors (a mean and scales) in a run of either
    dtype: each is hoisted once, at its own offset, rounded to the run's
    dtype, and the pair matches ``torch.func`` (float32 to its rounding)."""
    mu = torch.as_tensor(np.linspace(-1.0, 2.0, D))
    s = torch.as_tensor(np.linspace(0.5, 3.0, D))
    grad = resolve_potential(lambda x: torch.sum(((x - mu) / s) ** 2) / 2, D)[1]
    low = lower.lower_gradient(grad, "bps", D, dtype)
    want = torch.cat([mu.to(dtype), s.to(dtype)]).to(torch.float64)
    assert torch.equal(low.params, want)
    x, v = (a.to(dtype) for a in _points(seed=5))
    want_g, want_dg = _reference(grad, x, v)
    g, dg = low.grad_jvp(x, v)
    tol = RTOL if dtype == torch.float64 else 1e-6
    torch.testing.assert_close(g, want_g, rtol=tol, atol=tol)
    torch.testing.assert_close(dg, want_dg, rtol=tol, atol=tol)


@pytest.mark.parametrize("tag", sorted(TAGS))
def test_tagged_potentials_lowered_as_untagged(tag):
    """Each tag's potential, differentiated by ``torch.func.grad`` and
    lowered as a gradient of the user's own: its pair against the tag's
    closed forms and against ``torch.func`` at rtol 1e-12."""
    grad = resolve_potential(TAGS[tag], D)[1]
    params = tpot.device_potential_of(TAGS[tag])[1]
    closed_g, closed_jvp = tpot.LANE_POTENTIALS[tag](params)
    for kernel in ("zigzag", "sticky", "suzz", "bps", "boomerang", "ecmc"):
        low = lower.lower_gradient(grad, kernel, D, torch.float64)
        x, v = _points(tag == "funnel", seed=3)
        g, dg = low.grad_jvp(x, v)
        want_g, want_dg = closed_jvp(x, v)
        torch.testing.assert_close(g, want_g, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(dg, want_dg, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(g, closed_g(x), rtol=RTOL, atol=ATOL)
        ref_g, ref_dg = _reference(grad, x, v)
        torch.testing.assert_close(dg, ref_dg, rtol=RTOL, atol=ATOL)


def test_refusals_name_the_op():
    """A running product (a coupling other than through a constant matrix,
    a running sum or a periodic shift) and a read of one element of a matrix product raise ``LoweringError`` naming
    the aten op and node and ``backend='xla_stream'``, for every kernel."""
    A = torch.as_tensor(np.random.default_rng(1).normal(size=(D, D)))
    cases = {"aten.cumprod": lambda x: 0.5 * torch.sum(torch.cumprod(x, 0) ** 2),
             "aten.select": lambda x: (A.to(x) @ x)[3] ** 2 + torch.sum(x ** 2)}
    for op, U in cases.items():
        grad = resolve_potential(U, D)[1]
        for kernel in lower.SOURCES:
            with pytest.raises(lower.LoweringError) as err:
                lower.lower_gradient(grad, kernel, D, torch.float32)
            assert op in str(err.value), (kernel, str(err.value))
            assert "backend='xla_stream'" in str(err.value)
    with pytest.raises(lower.LoweringError, match="one element of a matrix product"):
        lower.lower_gradient(resolve_potential(cases["aten.select"], D)[1], "bps", D,
                             torch.float64)


def test_non_quadratic_sums_only_on_the_walking_kernels():
    """A sum of ``log1p(x^2)``, past degree 2 in ``x``, is taken by every
    kernel: K3/K5 and K4 add it at every point, and K1 and K6, whose chain
    moments are exact only to degree 2, form it at every point too (a point
    potential, no moments); a quadratic sum reading ``x[0]`` stays in K1/K6's
    moments.  Each pair against ``torch.func``."""
    def g(x):
        return x * torch.sum(torch.log1p(x ** 2))

    x, v = _points(seed=4)
    want = _reference(g, x, v)
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(g, kernel, D, torch.float64)
        assert low.point
        text = low.header()
        assert "log1p(" in text and "moment_add(Moments& m, int i, T y" not in text
        assert ("static Sums fill(" if kernel == "sticky" else "static Sums sums(") in text
        for a, b in zip(low.grad_jvp(x, v), want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)

    def quad(x):
        return x * torch.sum((x - x[0]) ** 2)

    for kernel in lower.SOURCES:
        low = lower.lower_gradient(quad, kernel, D, torch.float64)
        assert low.point == (kernel not in lower.MOMENT_KERNELS)
        for a, b in zip(low.grad_jvp(x, v), _reference(quad, x, v)):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)


def test_moments_extrapolate_the_sums_exactly():
    """K1/K6's chain moments of a quadratic summand: the Taylor terms the
    header adds give the sum at every time along the linear flow
    (``m0 + t (m1 + t m2)``) and its derivative, evaluated here through the
    IR's own nodes."""
    low = lower.lower_gradient(_grad("neal"), "zigzag", D, torch.float64)
    (summand,) = low.reductions[0]
    memo = {}
    terms = lower.taylor(low.b, summand.e, memo)
    x, v = _points(seed=5)
    lo, hi = lower._coords(summand)

    def value(n, y, w):  # the summand's nodes on coordinates [lo, hi)
        if n is None:
            return torch.zeros(())
        ops = {"y": y, "w": w}
        if n.op in ops:
            return ops[n.op]
        if n.op == "lit":
            return torch.tensor(n.attr, dtype=torch.float64)
        return lower._TORCH[n.op](*(value(a, y, w) for a in n.args), n.attr)

    m = [value(c, x[lo:hi], v[lo:hi]).sum(0) for c in terms]
    for t in (0.0, 0.3, 1.7):
        y = x + v * t
        want = (y[lo:hi] ** 2).sum(0)
        torch.testing.assert_close(m[0] + t * (m[1] + t * m[2]), want, rtol=1e-12, atol=1e-12)
        torch.testing.assert_close(m[1] + 2 * t * m[2], (2 * y[lo:hi] * v[lo:hi]).sum(0),
                                   rtol=1e-12, atol=1e-12)


def test_header_per_kernel_and_cache():
    """The header defines ``UserPotential`` with the moments (K1, K6) or the
    sums at a point (K3/K5, K4), literals as exact hexadecimal floats, the
    parameters read as ``prm``; a sampler lowers once per (kernel, d,
    dtype)."""
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(_grad("neal"), kernel, D, torch.float32)
        text = low.header()
        assert "struct UserPotential" in text and "static constexpr bool chain = true" in text
        assert ("moment_add" in text) == (kernel in lower.MOMENT_KERNELS)
        assert ("static Sums sums(" in text) == (kernel not in lower.MOMENT_KERNELS)
        assert "reads_others = true" in text and "exp(" in text
        assert "0x1.c71c720000000p-5" in text  # 1/18 rounded to float32
    for kernel in lower.MOMENT_KERNELS:  # only the sum reads coordinate 0
        hier = lower.lower_gradient(_grad("hier"), kernel, D, torch.float64)
        assert "reads_others = true" in hier.header()
    aniso = lower.lower_gradient(_grad("aniso"), "bps", D, torch.float64).header()
    assert "prm[0 + i]" in aniso
    s = pt.ZigZagAD(D, student)
    a = lower.lower_sampler(s, "zigzag", D, torch.float32)
    assert lower.lower_sampler(s, "zigzag", D, torch.float32) is a
    assert lower.lower_sampler(s, "zigzag", D, torch.float64) is not a
    sticky = pt.StickyZigZagAD(D, student, np.ones(D))
    assert lower.lower_sampler(sticky, "zigzag", D, torch.float32).kernel == "sticky"


def test_pick_backend_lowers_on_cuda(monkeypatch):
    """On ``"cuda"`` a lowerable untagged Zig-Zag routes to the kernel, a
    dense ``A @ x`` included, and a running product raises before any build,
    naming ``aten.cumprod`` and ``backend='xla_stream'``; the engine backends
    and the CPU stay as they were."""
    monkeypatch.setattr(tsc, "scalar_max_dim", lambda dt, user=None: 1210)
    monkeypatch.setattr(tzc, "sticky_max_dim", lambda dt, user=None: 13136)
    A = torch.eye(D, dtype=torch.float64) * 2.0
    for make in (lambda U: pt.ZigZagAD(D, U), lambda U: pt.StickyZigZagAD(D, U, np.ones(D)),
                 lambda U: pt.BPSAD(D, U), lambda U: pt.SpeedUpZigZagAD(D, U)):
        ok, dense = make(student), make(lambda x: 0.5 * x @ (A.to(x) @ x))
        refused = make(lambda x: 0.5 * torch.sum(torch.cumprod(x, 0) ** 2))
        for s in (ok, dense):
            assert tapi.pick_backend(s, "auto", D, torch.float32, "cuda") == "kernel"
            assert tapi.pick_backend(s, "pallas", D, torch.float32, "cuda") == "kernel"
        with pytest.raises(lower.LoweringError, match="aten.cumprod"):
            tapi.pick_backend(refused, "auto", D, torch.float32, "cuda")
        for s in (dense, refused):
            assert tapi.pick_backend(s, "xla_stream", D, torch.float32, "cuda") == "engine"
            assert tapi.pick_backend(s, "auto", D, torch.float32, "cpu") == "kernel"


DENSE_A = np.random.default_rng(7).normal(size=(D, D))
DENSE_X = np.random.default_rng(8).normal(size=(11, D))
DENSE_W = np.linspace(-1.0, 1.0, D)


def _dense_user():
    """Gradients through constant matrices, each as a user writes it."""
    A, X, w = (torch.as_tensor(a) for a in (DENSE_A, DENSE_X, DENSE_W))
    y = torch.as_tensor((np.arange(11) % 3 == 0).astype(np.float64))
    return {
        "corr": lambda x: 0.5 * x @ ((A @ A.T).to(x) @ x),
        "einsum": lambda x: 0.5 * torch.einsum("i,ij,j->", x, (A @ A.T).to(x), x),
        "linear": lambda x: (torch.sum(torch.tanh(torch.nn.functional.linear(x, A.to(x), w.to(x))))
                             + x @ x / 2),
        "addmv": lambda x: torch.sum(torch.addmv(w.to(x), A.to(x), x, beta=2.0, alpha=0.5) ** 2),
        "column": lambda x: torch.sum((A.to(x) @ x[:, None]) ** 2) / 2,
        "logistic": lambda b: (torch.sum(torch.nn.functional.softplus(X.to(b) @ b)
                                         - y.to(b) * (X.to(b) @ b)) + b @ b / 200),
        "nested": lambda x: torch.sum((A.to(x) @ (A.T.to(x) @ x)) ** 2) / (1 + x @ x),
        "data_sum": lambda x: torch.log1p(torch.sum(torch.exp(-(X.to(x) @ x) ** 2))) + x @ x,
    }


@pytest.mark.parametrize("name", sorted(_dense_user()))
def test_dense_pairs_match_torch_func(name):
    """Each dense gradient's pair against ``torch.func.jvp(vmap(grad))`` at
    rtol 1e-12 on every kernel, the gradient alone its first half bit for
    bit; a stage formed at each point, but on K1 and K3/K5 a product of an
    affine input, formed once per transition (K1 then forms none at a point
    where every product is one), whose pair along the transition
    (``Lowered.along`` at ``x`` itself, ``tau = 0``) is the point's."""
    grad = resolve_potential(_dense_user()[name], D)[1]
    x, v = _points(seed=len(name))
    want_g, want_dg = _reference(grad, x, v)
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(grad, kernel, D, torch.float64)
        assert low.products
        assert bool(low.trans) == (kernel in lower.TRANSITION_KERNELS)
        assert low.point == (kernel != "zigzag" or set(low.trans) != set(low.products))
        g, dg = low.grad_jvp(x, v)
        torch.testing.assert_close(g, want_g, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(dg, want_dg, rtol=RTOL, atol=ATOL)
        assert torch.equal(low.grad(x), g)
        if low.trans:
            ga, dga = low.along(x, v, kernel == "boomerang")(x, v, torch.zeros(B, dtype=x.dtype))
            torch.testing.assert_close(ga, want_g, rtol=RTOL, atol=ATOL)
            torch.testing.assert_close(dga, want_dg, rtol=RTOL, atol=ATOL)


def test_dense_headers_hoist_the_data():
    """The logistic regression's header on every kernel: ``X`` hoisted once
    (row-major, its transpose read column by column; the gradient's two
    ``X.to(b)`` copies share the block), then the labels and ``X^T y`` (a
    constant of the gradient; the Boomerang then ``X b``'s constant part
    ``M u(0)``), the products read from ``prm``; K6 keeps the products in
    shared memory, K4 in the lane (``lane_bytes``), K1 and K3/K5 form ``X b``
    once per transition (``form``) and keep ``X^T s`` in the lane."""
    grad = resolve_potential(_dense_user()["logistic"], D)[1]
    for kernel in lower.SOURCES:
        low = lower.lower_gradient(grad, kernel, D, torch.float32)
        trans = kernel in lower.TRANSITION_KERNELS
        assert low.params.numel() == 11 * D + 11 + D + (11 if kernel == "boomerang" else 0)
        torch.testing.assert_close(low.params[:11 * D],
                                   torch.as_tensor(DENSE_X, dtype=torch.float32).double()
                                   .reshape(-1), rtol=0, atol=0)
        assert {pr.moff for pr in low.products.values()} == {0}
        assert low.point and [k for k, _ in low.stages] == ["mv", "mv"]
        assert sorted(pr.colmajor for pr in low.products.values()) == [False, True]
        text = low.header()
        assert f"prm[0 + (k) * {D} + (" in text or "prm[0 + (r) * " in text
        assert f"prm[{11 * D + 11} + i]" in text  # X^T y
        assert ("static Sums fill(" in text) == (kernel == "sticky")
        assert ("static Sums sums(" in text) == (kernel != "sticky")
        assert ("static void form(" in text) == trans
        assert low.trans == ([m for k, m in low.stages][:1] if trans else [])
        assert f"static constexpr int NP = {2 * 11 if trans else 0};" in text
        if kernel == "sticky":  # each product's input and output in shared memory
            assert f"shared_bytes = {2 * (2 * D + 2 * 11)}L" in text
            assert "__shared__ T rows" not in text and "__syncthreads();" in text
        else:
            # Sums: X^T s and its tangent (K1 keeps two); the input, beta,
            # only where X b is formed at the point (K4); the walk of X^T s
            # over the rows: a row's s and tangent, D accumulators and theirs
            sums = 2 * D * (2 if kernel == "zigzag" else 1)
            assert lower.lane_fits(low)
            assert low.lane_bytes() == 4 * (sums + (0 if trans else 2 * D) + 2 + 2 * D)
        if trans:  # sigma(X b) reads X b's row k at the point's time
            assert "yw.prod(0, 11, k, " in text
        if kernel != "sticky":  # X^T s: one walk of the rows, s over all of them
            walk = text[text.index("u over data rows"):]
            assert "if (k >= " not in walk[:walk.index("return cs;")]


def test_a_lane_context_past_its_room_takes_the_engine(monkeypatch):
    """A 100 x 100 quadratic form in ``tanh(x)`` on BPS, whose products
    (after a nonlinearity) are formed at each point, keeps 6400 bytes of
    context per lane in float64, past ``lower.LANE_BYTES``: ``"auto"``
    takes the engine, ``"pallas"`` raises; in float32 (3200 bytes) it takes
    the kernel.  The dense quadratic form in ``x`` keeps as much on K4, the
    engine's there too; on BPS and the Zig-Zag its products are formed once
    per transition, no per-point context, and it takes the kernel."""
    monkeypatch.setattr(tsc, "scalar_max_dim", lambda dt, user=None: 1210)
    d = 100
    A = torch.eye(d, dtype=torch.float64)
    U = lambda x: 0.5 * torch.tanh(x) @ (A.to(x) @ torch.tanh(x))  # noqa: E731
    quad = lambda x: 0.5 * x @ (A.to(x) @ x)  # noqa: E731
    s = pt.BPSAD(d, U)
    assert tapi.pick_backend(s, "auto", d, torch.float64, "cuda") == "engine"
    with pytest.raises(ValueError, match="bytes per lane"):
        tapi.pick_backend(s, "pallas", d, torch.float64, "cuda")
    assert tapi.pick_backend(s, "auto", d, torch.float32, "cuda") == "kernel"
    low = lower.lower_sampler(s, "bps", d, torch.float64)
    assert low.lane_bytes() == 8 * 4 * 2 * d and not lower.lane_fits(low) and not low.trans
    # K1 keeps a segment's two Sums alive: 4 d values each, beside the
    # products' 4 d inputs
    zz = lower.lower_sampler(pt.ZigZagAD(d, U), "zigzag", d, torch.float32)
    assert zz.lane_bytes() == 4 * (2 * 4 * d + 4 * d)
    suzz = pt.SpeedUpZigZagAD(d, quad)
    assert tapi.pick_backend(suzz, "auto", d, torch.float64, "cuda") == "engine"
    with pytest.raises(ValueError, match="bytes per lane"):
        tapi.pick_backend(suzz, "pallas", d, torch.float64, "cuda")
    for dense, kernel in ((pt.BPSAD(d, quad), "bps"), (pt.ZigZagAD(d, quad), "zigzag")):
        for backend in ("auto", "pallas"):
            assert tapi.pick_backend(dense, backend, d, torch.float64, "cuda") == "kernel"
        low = lower.lower_sampler(dense, kernel, d, torch.float64)
        assert low.lane_bytes() == 0 and low.n_trans == 4 * d

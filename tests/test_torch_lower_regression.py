"""Hierarchical regressions lowered into the chunk kernels' generated
potential: coefficient blocks of x against data rows (``X @ x[a:b]`` and its
backward ``X.T @ r`` into the slice), a slice of x beside a product's rows
(``mu + Z @ gamma + s * x[:J]``), gathers, shifts, rolls and flips of a
stage's output (``alpha[county]``, ``(A @ x)[idx]``, ``cumsum(x)[idx]``) and
scatter-adds of rows that read a stage (a varying intercept's backward),
against ``torch.func`` and JAX.

The targets (float64, at the small sizes of ``test_torch_lower_gather.py``;
the card's ``chip_smoke.py`` phase 47 runs the radon models at full size):

* ``radon_x``: Gelman & Hill's radon model with individual- and group-level
  predictors (2007, ch. 12.6), non-centred, each predictor widened to a
  covariate matrix (``chip_smoke.radon_x_model`` on ``radon_x_data(J=6,
  n=40)``): ``x = (eta, mu, beta[4], gamma[2], log sigma_alpha, log
  sigma_y)``, d = 15; ``radon_x_fixed`` with both scales fixed (d = 13, a
  Gaussian posterior);
* the Gaussian and the logistic regression whose coefficients are the slice
  ``x[3:7]`` of x (d = 9); a logistic and a Poisson regression with a
  varying intercept (``X @ b + a[county]``, d = 8);
* ``(A @ x)[idx]`` and ``cumsum(x)[idx]``, their squares summed; a product's
  output shifted against x, and rolled and flipped products and running
  sums (d = 9).

* Each case's pair against ``torch.func.jvp`` at rtol 1e-12 on all six
  kernels, the gradient alone bit for bit with the pair's first half.
* ``radon_x_fixed``'s gradient against its precision.
* The generated headers: per-transition products on K1 and K3/K5, inline
  rows and their kept inputs on K4, K6's barrier behind a read at another
  row.
* The route at full size (d = 94 and 92) with the card mocked.
* The whole ``sample_skeleton`` of ``ZigZagAD(radon_x)`` against JAX's
  stream fills.
* The gather and scatter-add terms bit for bit with ``jax.grad``'s.

``test_torch_lower_regression_pallas.py`` holds the radon targets against
JAX's interpreted Pallas kernel on every kernel and mode.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch.models.base import resolve_potential  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import zigzag_chunk as tzc  # noqa: E402
from chip_smoke import radon_x_data, radon_x_model, radon_x_posterior  # noqa: E402
from test_torch_lower_dense import skeleton_matches_jax  # noqa: E402
from test_torch_lower_transition import _limit  # noqa: E402

RTOL = ATOL = 1e-12
J_SMALL = 6
DATA = radon_x_data(J=J_SMALL, n=40)


def radon_x(data, fixed=False):
    """``chip_smoke.radon_x_model`` on ``data`` as a function of a
    numpy-like module (``jnp`` or ``torch``)."""
    def make(np_):
        const = jnp.asarray if np_ is jnp else torch.as_tensor
        return radon_x_model(data, np_, fixed, const)
    return make


_rs = np.random.default_rng(21)
D = 9
_A = _rs.normal(size=(D, D)) / 3
_IDX = np.array([3, 0, 8, 8, 5, 2, 2, 3, 1, 7, 7])
_X = _rs.normal(size=(30, 4))
_Y = _rs.normal(size=30)
_YB = (_rs.random(30) < 0.4).astype(float)
_C = _rs.integers(0, 3, 30)


def _t(a, x):
    return torch.as_tensor(a).to(x.device) if a.dtype.kind == "i" else torch.as_tensor(a).to(x)


def gauss_slice(np_):
    """``0.5 |y - X x[3:7]|^2 + 0.5 |x|^2``: coefficients a slice of x."""
    def U(x):
        r = _t(_Y, x) - _t(_X, x) @ x[3:7]
        return 0.5 * torch.sum(r * r) + 0.5 * torch.sum(x * x)
    return U


def logistic_slice(np_):
    def U(x):
        z = _t(_X, x) @ x[3:7]
        return (torch.sum(torch.nn.functional.softplus(z) - _t(_YB, x) * z)
                + 0.5 * torch.sum(x * x))
    return U


def intercept_logistic(np_):
    """A logistic regression with a varying intercept and its scale:
    ``x = (a[3], b[4], log sd)``."""
    def U(x):
        a, b, ls = x[:3], x[3:7], x[7]
        z = _t(_X, x) @ b + a[_t(_C, x)]
        return (torch.sum(torch.nn.functional.softplus(z) - _t(_YB, x) * z)
                + 0.5 * torch.sum(a * a) * torch.exp(-2 * ls) + 3 * ls + 0.5 * ls * ls
                + torch.sum(b * b) / 200)
    return U


def intercept_poisson(np_):
    def U(x):
        z = _t(_X, x) @ x[3:7] + x[:3][_t(_C, x)]
        return torch.sum(torch.exp(z) - _t(_YB, x) * z) + 0.5 * torch.sum(x * x)
    return U


def _grad_of(make, d):
    return resolve_potential(make(torch), d)[1]


TARGETS = {"radon_x": (J_SMALL + 9, radon_x(DATA)),
           "radon_x_fixed": (J_SMALL + 7, radon_x(DATA, fixed=True)),
           "gauss_slice": (D, gauss_slice), "logistic_slice": (D, logistic_slice),
           "intercept_logistic": (8, intercept_logistic),
           "intercept_poisson": (8, intercept_poisson)}
"""Targets as functions of a numpy-like module (the torch side here)."""
STAGE_READS = {
    # gathers of a product's and of a running sum's output
    "product_gather": lambda x: x + 0.5 * (_t(_A, x) @ x)[_t(_IDX % D, x)][:D],
    "cumsum_gather": lambda x: x + 0.1 * torch.cumsum(x, 0)[_t(_IDX, x)][2:],
    "product_gather_sq": torch.func.grad(lambda x: 0.5 * torch.sum(
        (_t(_A, x) @ x)[_t(_IDX, x)] ** 2) + 0.5 * torch.sum(x * x)),
    "cumsum_gather_sq": torch.func.grad(lambda x: 0.5 * torch.sum(
        torch.cumsum(x, 0)[_t(_IDX, x)] ** 2) + 0.5 * torch.sum(x * x)),
    # a product's output at i + 1 beside x at i
    "product_shift": lambda x: x + torch.cat([(_t(_A, x) @ x)[1:] * x[:-1], x[:1]]),
    "product_shift_sum": torch.func.grad(lambda x: torch.sum(
        (_t(_A, x) @ x)[1:] * x[:-1]) + torch.sum(x * x)),
    # rolled and flipped products and running sums
    "product_roll": lambda x: x * torch.roll(_t(_A, x) @ x, 1),
    "product_flip": lambda x: x * torch.flip(_t(_A, x) @ x, (0,)),
    "cumsum_roll": lambda x: x + torch.roll(torch.cumsum(x, 0), 2),
    "cumsum_flip": lambda x: x + torch.flip(torch.cumsum(x, 0), (0,)),
    "product_roll_quad": torch.func.grad(lambda x: 0.5 * torch.sum(
        x * torch.roll(_t(_A, x) @ x, 1)) + torch.sum(x * x)),
}
"""Gradients written directly that read a stage's output at another index."""


def _points(seed, d, n=17):
    rs = np.random.default_rng(seed)
    return (torch.as_tensor(rs.normal(size=(d, n))),
            torch.as_tensor(rs.normal(size=(d, n))))


def _pairs_match(grad, d, seed):
    """The lowered pair on every kernel against ``torch.func.jvp(vmap(grad))``
    at rtol 1e-12, the gradient alone bit for bit with the pair's first half."""
    x, v = _points(seed, d)
    want = torch.func.jvp(torch.func.vmap(grad, in_dims=1, out_dims=1), (x,), (v,))
    lows = {}
    for kernel in lower.SOURCES:
        low = lows[kernel] = lower.lower_gradient(grad, kernel, d, torch.float64)
        g, dg = low.grad_jvp(x, v)
        for a, b in zip((g, dg), want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        assert torch.equal(low.grad(x), g)
    return lows


@pytest.mark.parametrize("target", sorted(TARGETS))
def test_regression_pair_matches_torch_func(target):
    """Each regression's pair on every kernel (each refused before: a
    product into a slice of x, a slice of x beside a product's rows, a
    scatter-add of rows that read a product)."""
    d, make = TARGETS[target]
    lows = _pairs_match(_grad_of(make, d), d, d + len(target))
    assert all(low.products for low in lows.values())


@pytest.mark.parametrize("name", sorted(STAGE_READS))
def test_stage_output_read_at_another_index(name):
    """A product's or a running sum's output gathered, shifted, rolled or
    flipped: the pair on every kernel, each read through a table of rows
    (``mvg``) or at an affine row (``mvx``)."""
    lows = _pairs_match(STAGE_READS[name], D, 31)
    for low in lows.values():
        assert {x.op for e in low._nodes_read() for x in lower._nodes(e)} & {"mvg", "mvx"}, name


def test_radon_x_fixed_matches_its_precision():
    """``radon_x_fixed`` is Gaussian: its lowered gradient against ``P x -
    b`` from ``chip_smoke.radon_x_posterior`` (mean ``P^-1 b``), and its
    derivative against ``P v``, on a moment kernel, K6 and a walking one."""
    d, make = TARGETS["radon_x_fixed"]
    mean, cov = radon_x_posterior(DATA)
    P = np.linalg.inv(cov)
    x, v = _points(3, d)
    for kernel in ("zigzag", "sticky", "bps"):
        g, dg = lower.lower_gradient(_grad_of(make, d), kernel, d,
                                     torch.float64).grad_jvp(x, v)
        torch.testing.assert_close(g, torch.as_tensor(P @ (x.numpy() - mean[:, None])),
                                   rtol=1e-10, atol=1e-10)
        torch.testing.assert_close(dg, torch.as_tensor(P @ v.numpy()), rtol=1e-10, atol=1e-10)


def test_headers_read_stages_where_they_lie():
    """Where each kernel keeps the radon models' stages: on K1 and K3/K5 the
    fixed model's four products (``Z gamma``, ``X beta``, ``X.T r``, ``Z.T``
    of the scatter-add) are formed once per transition and read at a
    county's row through ``yw.prod``; the free scales make ``X.T r`` and
    the scatter-add's product point stages.  K4 forms ``Z gamma`` and ``X
    beta`` row by row where read (inline), from inputs its Sums keep for the
    gradient's segment walks; K6 holds every product in shared memory, the
    barrier after a product read at another row marked."""
    d = J_SMALL + 7
    fixed = {k: lower.lower_gradient(_grad_of(radon_x(DATA, True), d), k, d, torch.float64)
             for k in ("zigzag", "bps", "suzz", "sticky")}
    for k in ("zigzag", "bps"):
        assert len(fixed[k].trans) == 4 and not fixed[k].slot and not fixed[k].inline
        assert "yw.prod(" in fixed[k].header()
    d = J_SMALL + 9
    free = {k: lower.lower_gradient(_grad_of(radon_x(DATA), d), k, d, torch.float64)
            for k in ("zigzag", "suzz", "sticky")}
    assert len(free["zigzag"].trans) == 2 and len(free["zigzag"].slot) == 2
    for low in (fixed["suzz"], free["suzz"]):
        text = low.header()
        assert len(low.kept) == 2 and all(f"T u{m}[" in text for m in low.kept)
        assert "const int zr" in text and "cs.u" in text
    for low in (fixed["sticky"], free["sticky"]):
        assert len(low.slot) == 4
        assert low.header().count("__syncthreads();  // its rows are read at other indices") >= 2


def _full_size():
    """The radon models at their full size (the card's phase 47)."""
    data = radon_x_data()
    return {"radon_x_d94": (94, radon_x(data)), "radon_x_fixed_d92": (92, radon_x(data, True))}


@pytest.mark.parametrize("target", list(_full_size()))
def test_every_target_takes_the_kernel_at_full_size(monkeypatch, target):
    """``pick_backend(..., "auto", d, float32, "cuda")`` is ``"kernel"`` on
    every kernel at full size (K3/K5's limit as its build reports it, K6's
    stubbed as in ``test_torch_lower_mixture``): no lane's context passes
    ``LANE_BYTES``."""
    monkeypatch.setattr(tsc, "scalar_max_dim", _limit)
    monkeypatch.setattr(tzc, "sticky_max_dim", lambda dt, user=None: 13136)
    d, make = _full_size()[target]
    U = make(torch)
    samplers = {"zigzag": pt.ZigZagAD(d, U), "sticky": pt.StickyZigZagAD(d, U, np.ones(d)),
                "suzz": pt.SpeedUpZigZagAD(d, U), "bps": pt.BPSAD(d, U, refresh_rate=1.0),
                "boomerang": pt.BoomerangAD(d, U, refresh_rate=1.0),
                "ecmc": pt.ForwardECMCAD(d, U)}
    for kernel, s in samplers.items():
        assert tapi.pick_backend(s, "auto", d, torch.float32, "cuda") == "kernel", kernel
        for dtype in (torch.float32, torch.float64):
            low = lower.lower_sampler(s, "zigzag" if kernel == "sticky" else kernel, d, dtype)
            assert lower.lane_fits(low) and low.point and len(low.products) == 4, kernel


def test_radon_x_zigzag_sample_skeleton_matches_jax(monkeypatch):
    """The slice as a whole on ``radon_x``: the port's ``sample_skeleton``
    through the lowered pair (two products per transition, a scatter-add of
    rows that read them walked at each intercept, ``X.T r`` and ``Z.T`` of
    the scatter-add at each point) against JAX's stream fills, float64."""
    skeleton_matches_jax(monkeypatch, radon_x(DATA), d=J_SMALL + 9)


def test_gather_and_scatter_terms_are_bit_for_bit_with_jax():
    """The intercepts' coordinates of a one-column radon model (``alpha = mu
    + Z gamma + 0.33 eta`` gathered at each house's county, ``X beta``
    beside it; one column each, so that both packages' products round
    alike): the lowered gradient's scatter-add of rows that read both
    products equals ``jax.grad``'s (op by op) bit for bit, the segment sums
    adding in XLA's scatter order on the CPU."""
    import jax

    county, X, Z, y = DATA
    J = J_SMALL

    def make(np_):
        const = jnp.asarray if np_ is jnp else torch.as_tensor

        def U(x):
            c, Xc, Zc, yc = (const(a) for a in (county, X[:, :1], Z[:, :1], y))
            if np_ is torch:
                Xc, Zc, yc = Xc.to(x), Zc.to(x), yc.to(x)
            r = yc - (x[J] + Zc @ x[J + 2:J + 3] + 0.33 * x[:J])[c] - Xc @ x[J + 1:J + 2]
            return 0.5 * np_.sum(r * r) / 0.76 ** 2 + 0.5 * np_.sum(x * x)
        return U

    d = J + 3
    want = jax.vmap(jax.grad(make(jnp)))  # op by op: jit fuses the adds in its order
    low = lower.lower_gradient(resolve_potential(make(torch), d)[1], "bps", d, torch.float64)
    x, _ = _points(17, d, 64)
    assert np.array_equal(np.asarray(want(jnp.asarray(x.numpy().T))).T[:J],
                          low.grad(x).numpy()[:J])

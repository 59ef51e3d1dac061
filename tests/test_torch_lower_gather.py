"""Reads at a constant index array (``x[idx]``, ``index_select``, ``gather``,
``take``) and their scatter-add backward lowered into the chunk kernels'
generated potential, against ``torch.func`` and JAX.

The targets, each written as a user writes it (float64, at their small
sizes here; the card's ``chip_smoke.py`` phase 46 runs them at full size):

* ``radon``: the varying-intercept model of Gelman & Hill (2007, ch. 12),
  ``y_r ~ N(alpha[county_r] + beta floor_r, sigma_y^2)``, ``alpha_j ~
  N(mu_alpha, sigma_alpha^2)``, on data of the Minnesota radon survey's
  shape drawn from a numpy seed (85 counties of very unequal sizes, 919
  houses at full size; 6 and 40 here) at about the book's estimates; the
  full model ``x = (alpha, mu_alpha, beta, log sigma_alpha, log sigma_y)``
  and ``radon_fixed`` with both scales fixed (a Gaussian posterior);
* ``icar``: the ICAR prior as the Stan case study on the BYM model (Morris
  et al. 2019) writes it, ``0.5 sum((phi[node1] - phi[node2])^2)`` plus the
  soft sum-to-zero ``0.5 (sum(phi) / (0.001 d))^2``, with unit-noise
  observations at each area, on an L x L grid triangulated by one seeded
  diagonal per cell and relabelled by a seeded permutation (L = 3 and 6
  here, 32 on the card);
* ``perm``: ``|x - 0.5 x[perm]|^2 / 2`` for a seeded permutation, a gather
  whose rows are the coordinates.

* Each target's lowered pair against ``torch.func.jvp`` at rtol 1e-12 on
  all six kernels; gathers and scatter-adds written directly; the Gaussian
  targets' gradients against their precision matrices.
* K4 against JAX's Pallas kernel in interpret mode on the ICAR from its
  posterior, where its default first horizon rejects nearly every
  transition in both packages.
* The whole ``sample_skeleton`` of ``ZigZagAD(icar)`` against JAX's stream
  fills.
* The gather and scatter-add terms bit for bit with ``jax.grad``'s.
* The route at full size (radon d = 87 and 89, the ICAR at d = 1024) with
  the card mocked; ``ordered_segment_sum``'s order; refusals (gathers of a
  stage's output lower since ``test_torch_lower_regression.py``: here two
  direct cases).

``test_torch_lower_gather_pallas.py`` holds these targets against JAX's
interpreted Pallas kernel on every other kernel and mode.
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
from chip_smoke import RADON_TRUTH, icar_graph, radon_data  # noqa: E402
from test_torch_lower_dense import skeleton_matches_jax  # noqa: E402
from test_torch_lower_slice import _pair, check_outputs, run_both  # noqa: E402
from test_torch_lower_transition import _limit  # noqa: E402

RTOL = ATOL = 1e-12
MU_ALPHA, BETA, SIGMA_Y, SIGMA_ALPHA = RADON_TRUTH  # Gelman & Hill's estimates


def _const(np_, a):
    return jnp.asarray(a) if np_ is jnp else torch.as_tensor(a)


def radon(data, fixed=False):
    """The varying-intercept model on ``data``: a function of a numpy-like
    module (``jnp`` or ``torch``) giving ``U``."""
    county, floor, y = data
    J, n = int(county.max()) + 1, len(y)

    def make(np_):
        def U(x):
            c, f, yy = _const(np_, county), _const(np_, floor), _const(np_, y)
            a, mu, b = x[:J], x[J], x[J + 1]
            r = yy - a[c] - b * f
            prior = mu * mu / 200 + b * b / 200
            if fixed:
                return (np_.sum(r * r) / (2 * SIGMA_Y ** 2)
                        + np_.sum((a - mu) ** 2) / (2 * SIGMA_ALPHA ** 2) + prior)
            lsa, lsy = x[J + 2], x[J + 3]
            return (0.5 * np_.sum(r * r) * np_.exp(-2 * lsy) + n * lsy
                    + 0.5 * np_.sum((a - mu) ** 2) * np_.exp(-2 * lsa) + J * lsa
                    + prior + 0.5 * (lsa * lsa + lsy * lsy))
        return U
    return make


def icar(graph, sd=None):
    """The ICAR prior with unit-noise observations on ``graph``; the soft
    sum-to-zero's sd ``0.001 d`` (Morris et al.), or ``sd``."""
    edges, y = graph

    def make(np_):
        def U(x):
            E, yy = _const(np_, edges), _const(np_, y)
            dphi = x[E[:, 0]] - x[E[:, 1]]
            s = 0.001 * x.shape[0] if sd is None else sd
            return (0.5 * np_.sum(dphi ** 2) + 0.5 * (np_.sum(x) / s) ** 2
                    + 0.5 * np_.sum((yy - x) ** 2))
        return U
    return make


def perm(d):
    p = np.random.default_rng(21).permutation(d)
    return lambda np_: lambda x: 0.5 * np_.sum((x - 0.5 * x[_const(np_, p)]) ** 2)


RADON_SMALL = radon_data(J=6, n=40)
FULL_SD = 0.001 * 1024
"""The sum-to-zero's sd of the full-size ICAR target (d = 1024).  At d = 9
Morris et al.'s ``0.001 d`` is a precision of 12 346 along ``(1, ..., 1)``,
which turns the port's and JAX's summation orders of ``sum(phi)`` (each
exact to rounding; the gather and scatter-add terms agree bit for bit,
``test_gather_gradient_is_bit_for_bit_with_jax``) into relative
differences past 1e-12 along a chunk's transitions; the comparisons with
JAX take the full-size target's strength instead."""
TARGETS = {"radon": (10, radon(RADON_SMALL)), "radon_fixed": (8, radon(RADON_SMALL, True)),
           "icar_l3": (9, icar(icar_graph(3))), "icar_l6": (36, icar(icar_graph(6))),
           "icar_l3_full_sd": (9, icar(icar_graph(3), FULL_SD)),
           "perm_d9": (9, perm(9)), "perm_d36": (36, perm(36))}
KERNEL_MODES = [("zigzag", False), ("zigzag", True), ("sticky", False), ("sticky", True),
                ("suzz", False), ("suzz", True), ("bps", False), ("bps", True),
                ("boomerang", False), ("ecmc", False)]


def _grad(target):
    d, make = TARGETS[target]
    return resolve_potential(make(torch), d)[1]


def _points(seed, d, n=17):
    rs = np.random.default_rng(seed)
    return (torch.as_tensor(rs.normal(size=(d, n))),
            torch.as_tensor(rs.normal(size=(d, n))))


def _reference(grad, x, v):
    return torch.func.jvp(torch.func.vmap(grad, in_dims=1, out_dims=1), (x,), (v,))


def _pairs_match(grad, d, seed):
    """The lowered pair on every kernel against ``torch.func.jvp(vmap(grad))``
    at rtol 1e-12, the gradient alone bit for bit with the pair's first half."""
    x, v = _points(seed, d)
    want = _reference(grad, x, v)
    lows = {}
    for kernel in lower.SOURCES:
        low = lows[kernel] = lower.lower_gradient(grad, kernel, d, torch.float64)
        g, dg = low.grad_jvp(x, v)
        for a, b in zip((g, dg), want):
            torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
        assert torch.equal(low.grad(x), g)
    return lows


@pytest.mark.parametrize("target", sorted(set(TARGETS) - {"icar_l3_full_sd"}))
def test_gather_pair_matches_torch_func(target):
    """Each target's pair on every kernel; K6 takes its ``reads_others``
    barriers (a gather reads other threads' coordinates)."""
    d = TARGETS[target][0]
    lows = _pairs_match(_grad(target), d, d + len(target))
    assert "reads_others = true" in lows["sticky"].header()


_W = np.linspace(0.5, 2.0, 9)
_IDX = np.array([3, 0, 8, 8, 5, -1, 2, 3, 3, 7, 1])
DIRECT = {
    # the gathers torch writes, with repeated and negative indices
    "index_select": lambda x: x + torch.sin(torch.index_select(x, 0, torch.as_tensor(
        _IDX % 9))).sum() * 0.1 + torch.zeros_like(x).index_add(
        0, torch.as_tensor(_IDX % 9), torch.cos(x[torch.as_tensor(_IDX)]), alpha=0.5),
    "gather_take": lambda x: x * 0.3 + torch.zeros_like(x).scatter_add(
        0, torch.as_tensor(_IDX % 9), torch.gather(x, 0, torch.as_tensor(_IDX % 9)) ** 2)
    + torch.zeros_like(x).put(torch.as_tensor(_IDX), torch.take(x, torch.as_tensor(_IDX)) ** 3,
                              accumulate=True),
    # a gather of a slice, of hoisted parameters and of a gather; one element
    "slice_params": lambda x: x + torch.zeros(9).to(x).index_put(
        (torch.as_tensor(_IDX),),
        (torch.as_tensor(_W).to(x) * x)[2:][torch.as_tensor(_IDX % 7)][torch.as_tensor(
            [4, 0, 1, 1, 3, 2, 5, 6, 10, 9, 8, 7])[:11]] * x[torch.as_tensor(4)]
        * torch.take(x, torch.as_tensor(_IDX))[6],  # one element of a gather: x[2]
        accumulate=True),
    # a scatter-add into a slice of the coordinates, and onto a non-zero base
    "into_slice": lambda x: torch.cat([x[:4].index_add(0, torch.as_tensor([0, 3, 3, 1]),
                                                       x[5:] ** 2), x[4:] * 2.0]),
    # gathers of a stage's output (refused before ``test_torch_lower_regression.py``)
    "cumsum_gather": lambda x: x + torch.cumsum(x, 0)[torch.as_tensor(_P)],
    "product_gather": lambda x: x * (torch.as_tensor(np.eye(9) + 0.1).to(x)
                                     @ x)[torch.as_tensor(_P)],
}


@pytest.mark.parametrize("name", sorted(DIRECT))
def test_direct_gathers_and_scatters(name):
    """Gradients written directly with ``index_select``, ``gather``, ``take``,
    ``index_add`` (with ``alpha``), ``scatter_add``, ``put`` and
    ``index_put`` (accumulating), repeated and negative indices, a 0-d
    index, gathers of a slice, of hoisted parameters and of a gather, one
    element of a gather, scatter-adds into a slice and onto a base, and
    gathers of a running sum's and of a product's output: the pair on every
    kernel."""
    _pairs_match(DIRECT[name], 9, 13)


def radon_precision(data):
    """``(P, b)`` of ``radon_fixed``: ``U = x P x / 2 - b x + c``."""
    county, floor, y = data
    J, n = int(county.max()) + 1, len(y)
    A = np.zeros((n, J + 2))
    A[np.arange(n), county] = 1.0
    A[:, J + 1] = floor
    C = np.zeros((J, J + 2))
    C[:, :J] = np.eye(J)
    C[:, J] = -1.0
    P = A.T @ A / SIGMA_Y ** 2 + C.T @ C / SIGMA_ALPHA ** 2 + np.diag(
        [0.0] * J + [1 / 100, 1 / 100])
    return P, A.T @ y / SIGMA_Y ** 2


def icar_precision(graph, sd=None):
    """``(P, b)`` of the ICAR target: the graph's Laplacian, the soft
    sum-to-zero's ``1 1^T / sd^2`` (``sd`` 0.001 d by default) and the
    identity; ``b = y``."""
    edges, y = graph
    d = len(y)
    P = np.eye(d) + np.ones((d, d)) / (0.001 * d if sd is None else sd) ** 2
    for a, c in edges:
        P[a, a] += 1.0
        P[c, c] += 1.0
        P[a, c] -= 1.0
        P[c, a] -= 1.0
    return P, y


def test_gaussian_targets_match_their_precision():
    """``radon_fixed`` and the ICAR target are Gaussian: their lowered
    gradients against ``P x - b`` written out, the exact posterior (mean
    ``P^-1 b``, covariance ``P^-1``) the card's gates read."""
    cases = [("radon_fixed", radon_precision(RADON_SMALL)),
             ("icar_l6", icar_precision(icar_graph(6)))]
    for target, (P, bvec) in cases:
        d = len(bvec)
        x, v = _points(3, d)
        for kernel in ("zigzag", "sticky", "bps"):
            g, dg = lower.lower_gradient(_grad(target), kernel, d,
                                         torch.float64).grad_jvp(x, v)
            torch.testing.assert_close(g, torch.as_tensor(P @ x.numpy() - bvec[:, None]),
                                       rtol=1e-11, atol=1e-11)
            torch.testing.assert_close(dg, torch.as_tensor(P @ v.numpy()),
                                       rtol=1e-11, atol=1e-11)


def test_k4_default_first_horizon_stalls_on_the_icar():
    """K4 in events mode on the ICAR as Morris et al. scale its sum-to-zero
    (L = 3), from exact posterior draws: with the first envelope's horizon
    at 0.02 most transitions are events and the two packages agree (the
    full check); at the default ``tmax`` 2.0 the envelope over ``[0, 2]``
    lies far above the rate near 0 (the speed ``sqrt(1 + |x|^2)`` and the
    stiff sum-to-zero's rate grow along the speed-up flow), and until a
    reset moves it each transition is a rejection against the same
    envelope: fewer than 2% are events, in JAX's kernel as in the port."""
    d, make = TARGETS["icar_l3"]
    P, b = icar_precision(icar_graph(3))
    cov = np.linalg.inv(P)
    rs = np.random.default_rng(46)
    start = (cov @ b + rs.normal(size=(64, d)) @ np.linalg.cholesky(cov).T,
             rs.choice([-1.0, 1.0], size=(64, d)))
    pair, shares = _pair("suzz", "icar_l3", {"icar_l3": make}, d), []
    for tmax in (0.02, None):  # the second run reuses JAX's compiled kernel
        ref, mine, _ = run_both("suzz", "icar_l3", False, targets={"icar_l3": make}, d=d,
                                pair=pair, start=start, tmax=tmax)
        check_outputs(ref, mine, None, many_events=tmax is not None)
        shares.append(float((ref[len(ref) // 2][:, 0] > 0).mean()))
    assert shares[0] > 0.3 and shares[1] < 0.02, shares


def test_icar_zigzag_sample_skeleton_matches_jax(monkeypatch):
    """The slice as a whole on the ICAR target: the port's ``sample_skeleton``
    through the lowered pair (two scatter-adds walked at every coordinate,
    the sum-to-zero on K1's chain moments) against JAX's stream fills,
    float64."""
    skeleton_matches_jax(monkeypatch, TARGETS["icar_l3_full_sd"][1], d=9)


def test_gather_gradient_is_bit_for_bit_with_jax():
    """The ICAR's edge and observation terms at L = 3 (two gathers, two
    scatter-adds of one vector and its negation) and the radon model's
    residual term (a gather of a slice, a scatter-add into it: the
    intercepts' coordinates): the lowered gradient equals ``jax.grad``'s
    (op by op) bit for bit, the segment sums adding in XLA's scatter order
    on the CPU."""
    import jax

    edges, y = icar_graph(3)
    county, floor, yr = RADON_SMALL
    J = int(county.max()) + 1

    def edge(np_):
        def U(x):
            E, yy = _const(np_, edges), _const(np_, y)
            return 0.5 * np_.sum((x[E[:, 0]] - x[E[:, 1]]) ** 2) + 0.5 * np_.sum((yy - x) ** 2)
        return U

    def resid(np_):
        def U(x):
            r = _const(np_, yr) - x[:J][_const(np_, county)] - x[J + 1] * _const(np_, floor)
            return 0.5 * np_.sum(r * r) / SIGMA_Y ** 2 + 0.5 * np_.sum(x * x)
        return U

    # every coordinate of the ICAR's; the intercepts' of the radon model (beta's
    # and sigma_y's are sums over the houses, which XLA adds in its own order)
    for make, d, n in ((edge, 9, 9), (resid, 10, J)):
        want = jax.vmap(jax.grad(make(jnp)))  # op by op: jit fuses the adds in its order
        low = lower.lower_gradient(resolve_potential(make(torch), d)[1], "bps", d,
                                   torch.float64)
        x, _ = _points(17, d, 64)
        assert np.array_equal(np.asarray(want(jnp.asarray(x.numpy().T))).T[:n],
                              low.grad(x).numpy()[:n])


def _full_size():
    """Each target at its full size (the card's phase 46)."""
    data = radon_data()
    return {"radon_d89": (89, radon(data)), "radon_fixed_d87": (87, radon(data, True)),
            "icar_d1024": (1024, icar(icar_graph(32)))}


@pytest.mark.parametrize("target", list(_full_size()))
def test_every_target_takes_the_kernel_at_full_size(monkeypatch, target):
    """``pick_backend(..., "auto", d, float32, "cuda")`` is ``"kernel"`` on
    every kernel (K3/K5's limit as its build reports it, K6's stubbed as in
    ``test_torch_lower_mixture``): a segment walk adds nothing to a lane's
    context, so each lane keeps only its sums (``lane_bytes``); the ICAR's
    one sum keeps K1's and K6's chain moments, the radon model's sums over
    the houses make it a point potential there."""
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
        low = lower.lower_sampler(s, "zigzag" if kernel == "sticky" else kernel, d,
                                  torch.float32)
        sums = len(low.reductions)
        assert low.lane_bytes() == (2 if kernel == "zigzag" else 1) * 2 * sums * 4
        assert low.point == (kernel not in lower.MOMENT_KERNELS or "radon" in target)
        assert "reads_others = true" in low.header() and not low.products
        assert sums == (1 if "icar" in target else 2 if "fixed" in target else 4)


def test_headers_walk_each_segment():
    """The generated ``at`` walks coordinate i's segment of each scatter-add
    (``ptr[i]`` to ``ptr[i + 1]`` of the rows sorted by target, the value
    and its tangent in one walk), reading each row's coordinates through
    the accessor at the gather's index table; the radon model's sums over
    the houses read the county table in the lane's walk of the rows."""
    low = lower.lower_gradient(_grad("icar_l3"), "bps", 9, torch.float64)
    text = low.header()
    assert text.count("// scatter-add rows") == 2 and text.count("for (int sq = sq0;") == 2
    assert "const int sr0 = (int)prm[" in text and "yw((int)prm[" in text
    walk = text[text.index("// scatter-add rows"):]
    body = walk[:walk.index("for (int sq = sq0;", walk.index("for (int sq = sq0;") + 1)]
    assert body.count(" = sq == sq0 ? ") == 2  # the value and its tangent, in one walk
    low = lower.lower_gradient(_grad("radon"), "bps", 10, torch.float64)
    text = low.header()
    assert "for (int k = 0; k < 40; ++k) {  // sum 0 over data rows" in text
    assert "yw((int)prm[" in text[text.index("sum 0 over data rows"):]


@pytest.mark.parametrize("n,m", [(0, 3), (1, 1), (40, 6), (300, 17)])
def test_ordered_segment_sum_order(n, m):
    """Each segment added in increasing row order from its first term, an
    empty segment 0: bit for bit with a sequential walk of the rows sorted
    stably by target, and to rounding with ``index_add``."""
    rs = np.random.default_rng(n + m)
    idx = torch.as_tensor(rs.integers(0, max(m - 1, 1), n))  # the last segment empty
    vals = torch.as_tensor(rs.normal(size=(n, 3)))
    order = torch.argsort(idx, stable=True)
    ptr = torch.cat([torch.zeros(1, dtype=torch.long),
                     torch.cumsum(torch.bincount(idx, minlength=m), 0)])
    got = lower.ordered_segment_sum(vals, ptr, order)
    walk = torch.zeros(m, 3, dtype=torch.float64)
    for i in range(m):
        rows = [int(r) for r in order[ptr[i]:ptr[i + 1]]]
        assert rows == sorted(rows)
        for q, r in enumerate(rows):
            walk[i] = vals[r] if q == 0 else walk[i] + vals[r]
    assert torch.equal(got, walk)
    torch.testing.assert_close(got, torch.zeros(m, 3, dtype=torch.float64).index_add(
        0, idx, vals), rtol=1e-13, atol=1e-13)


_E = np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 5], [5, 6], [6, 7], [7, 8]])
_P = np.random.default_rng(4).permutation(9)
REFUSED = {
    # a 2-D index array, an index that depends on x, a gather of a scatter-add's output
    "aten.index": [lambda x: x + torch.sum(x[torch.as_tensor(_E)], 1).sum(),
                   lambda x: x * torch.as_tensor(np.array([1.0, 2.0])).to(x)[(x > 0).long()],
                   lambda x: x + torch.zeros_like(x).index_add(
                       0, torch.as_tensor(_P), x ** 2)[torch.as_tensor(_P)]],
    # writes that do not add, and a scatter into more than the coordinates
    "aten.index_put": [lambda x: x + torch.zeros_like(x).index_put(
        (torch.as_tensor(_P),), x[torch.as_tensor(_P)] ** 2)],
    "aten.scatter": [lambda x: x + torch.zeros_like(x).scatter(0, torch.as_tensor(_P), x ** 2)],
    # a scatter into more than the coordinates, and one of a scatter-add's output
    "aten.index_add": [lambda x: x + torch.zeros(12).to(x).index_add(
        0, torch.as_tensor(_P + 3), x ** 2)[:9],
                       lambda x: x + torch.zeros_like(x).index_add(
        0, torch.as_tensor(_P), torch.zeros_like(x).index_add(0, torch.as_tensor(_P), x ** 2))],
    "aten.cumprod": [lambda x: x + 0.1 * torch.cumprod(torch.tanh(x), 0)],
    "aten.sort": [lambda x: x + torch.sort(x)[0]],
    "aten.convolution": [lambda x: x + torch.nn.functional.conv1d(
        x[None, None], torch.ones(1, 1, 3).to(x), padding=1)[0, 0]],
}


@pytest.mark.parametrize("op", sorted(REFUSED))
def test_refusals_of_gathers_and_scatters(op):
    """A 2-D index array (``x[E]``), an index that depends on x, a gather of
    a scatter-add's output, ``index_put`` without ``accumulate``, ``scatter``
    (not ``scatter_add``), a scatter into a length other than d, a
    scatter-add of a scatter-add's output, ``cumprod``, ``sort`` and
    ``conv1d`` raise
    ``LoweringError`` naming the op and ``backend='xla_stream'`` on a moment
    kernel (K1) and a walking one (K3): the interpreter refuses them before
    any kernel's form is chosen."""
    for grad in REFUSED[op]:
        for kernel in ("zigzag", "bps"):
            with pytest.raises(lower.LoweringError) as err:
                lower.lower_gradient(grad, kernel, 9, torch.float64)
            assert op in str(err.value) and "backend='xla_stream'" in str(err.value), (
                kernel, str(err.value))

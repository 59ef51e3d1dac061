"""Products with a constant matrix formed once per transition
(``ops/cuda/lower.py``: ``Lowered.trans``, ``Lowered.along``; the kernels'
``UserPotential::form``), on the CPU.

* The per-transition form against the dense pair: ``c0 = M u(x)`` and
  ``c1 = M du(x; v)`` formed at the transition's start and read at ``t``
  (``Lowered.along``) against the pair formed at the point ``x + t v`` (the
  Boomerang's ``x cos t + v sin t``), float64, d = 1000, 16 chains, rtol and
  atol 1e-12: ``P x`` (a dense quadratic form), ``A (x - mu)`` (its constant
  part ``-A mu`` on the elliptic flow) and the first stage of a logistic
  regression's ``X^T sigma(X b)`` (``X b``, 200 data rows; the second stage
  formed at the point), on K1, K3 (BPS, the Boomerang) and K5.
* The plain chunk kernels on ``0.5 (x - mu) A (x - mu)`` through the lowered
  config (``driver.lowered_config``, its pair along the transition) against
  JAX's Pallas kernel in interpret mode (``test_torch_lower_slice.run_both``,
  D = 6): K1 and K3 BPS in both modes, the Boomerang and K5; integers equal,
  floats to rtol and atol 1e-12.
* Routing: the dense ``0.5 x P x`` at d = 1000 in float32 takes the kernel
  for ``ZigZagAD``, ``BPSAD``, ``BoomerangAD`` and ``ForwardECMCAD`` on
  ``"cuda"`` (the shared-memory limits stubbed as the builds report them:
  1210 for the tags, ``(227 KB / 4 - NP) / 12`` for a generated potential
  with ``NP`` values per transition), and ``SpeedUpZigZagAD`` (K4, whose
  flow is not affine) the engine.
* Headers: K1's and K3's form the products once per transition
  (``form``) and read them through the point's accessor (``yw.prod``), not
  in ``sums``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import pdmpflux_tpu_torch as pt  # noqa: E402
from pdmpflux_tpu_torch import api as tapi  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import lower  # noqa: E402
from pdmpflux_tpu_torch.ops.cuda import scalar_chunk as tsc  # noqa: E402
from test_torch_lower_slice import D, check_outputs, run_both  # noqa: E402

RTOL = ATOL = 1e-12
WIDE, CHAINS, ROWS = 1000, 16, 200
KERNELS = ("zigzag", "bps", "boomerang", "ecmc")
SMEM_VALUES_F32 = 232448 // 4  # a block's shared memory in float32 values


def _spd(d, seed):
    a = np.random.default_rng(seed).normal(size=(d, d)) / np.sqrt(d)
    return a @ a.T + np.eye(d)


_rs = np.random.default_rng(17)
P_WIDE = _spd(WIDE, 1)
A_WIDE = _rs.normal(size=(WIDE, WIDE)) / np.sqrt(WIDE)
MU_WIDE = _rs.normal(size=WIDE)
X_WIDE = _rs.normal(size=(ROWS, WIDE)) / np.sqrt(WIDE)
A_SMALL = _spd(D, 2)
MU_SMALL = np.linspace(-0.5, 0.5, D)


def _wide_gradients():
    """The gradients of the pair checks (per chain, ``(d,) -> (d,)``)."""
    P, A, mu, X = (torch.as_tensor(a) for a in (P_WIDE, A_WIDE, MU_WIDE, X_WIDE))
    return {
        "Px": torch.func.grad(lambda x: 0.5 * x @ (P.to(x) @ x)),
        "A(x-mu)": torch.func.grad(lambda x: torch.sum(torch.log(torch.cosh(
            A.to(x) @ (x - mu.to(x)))))),
        "logistic": torch.func.grad(lambda b: torch.sum(
            torch.nn.functional.softplus(X.to(b) @ b)) + b @ b / 200.0),
    }


def _flowed(kernel, x, v, t):
    """The point the kernel's flow reaches from ``(x, v)`` at times ``t``."""
    if kernel == "boomerang":
        c, s = torch.cos(t), torch.sin(t)
        return x * c + v * s, -x * s + v * c
    return x + v * t, v


@pytest.mark.parametrize("name", sorted(_wide_gradients()))
def test_transition_form_matches_the_dense_pair(name):
    grad = _wide_gradients()[name]
    rs = np.random.default_rng(len(name))
    x, v = (torch.as_tensor(rs.normal(size=(WIDE, CHAINS))) for _ in range(2))
    t = torch.as_tensor(rs.uniform(0.0, 1.5, size=CHAINS))
    for kernel in KERNELS:
        low = lower.lower_gradient(grad, kernel, WIDE, torch.float64)
        assert low.trans and low.trans[0] == low.stages[0][1]
        elliptic = kernel == "boomerang"
        assert bool(low.mc_off) == elliptic
        y, w = _flowed(kernel, x, v, t)
        g, dg = low.along(x, v, elliptic)(y, w, t)
        want_g, want_dg = low.grad_jvp(y, w)
        torch.testing.assert_close(g, want_g, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(dg, want_dg, rtol=RTOL, atol=ATOL)
        # at the transition's start the read is the point's own product
        # (c0 + 0 c1 = c0), so the pair there is the dense pair bit for bit
        if not elliptic:
            g0, dg0 = low.along(x, v)(x, v, torch.zeros(CHAINS, dtype=x.dtype))
            want0 = low.grad_jvp(x, v)
            assert torch.equal(g0, want0[0]) and torch.equal(dg0, want0[1])


def _shifted_quadratic(np_):
    """``U = (x - mu) A (x - mu) / 2``: two products of the affine ``x -
    mu``, formed once per transition, with the constant part ``-A mu``."""
    A = jnp.asarray(A_SMALL) if np_ is jnp else torch.as_tensor(A_SMALL)
    mu = jnp.asarray(MU_SMALL) if np_ is jnp else torch.as_tensor(MU_SMALL)
    return lambda x: 0.5 * (x - mu) @ (A @ (x - mu))


JAX_CASES = [("zigzag", False), ("zigzag", True), ("bps", False), ("bps", True),
             ("boomerang", False), ("ecmc", False)]


@pytest.mark.parametrize("kernel,horizon", JAX_CASES)
def test_plain_kernel_on_transition_products_matches_pallas(kernel, horizon):
    check_outputs(*run_both(kernel, "shifted", horizon,
                            targets={"shifted": _shifted_quadratic}))


def _limit(dt, user=None):
    """``scalar_max_dim`` as the builds report it in float32."""
    if user is None or not user.n_trans:
        return 1210
    return (SMEM_VALUES_F32 - user.n_trans) // 12


def test_dense_quadratic_form_at_d1000_takes_the_kernel(monkeypatch):
    monkeypatch.setattr(tsc, "scalar_max_dim", _limit)
    P = torch.as_tensor(P_WIDE)
    U = lambda x: 0.5 * x @ (P.to(x) @ x)  # noqa: E731
    for make, kind in ((pt.ZigZagAD, "zigzag"), (pt.BPSAD, "bps"),
                       (pt.BoomerangAD, "boomerang"), (pt.ForwardECMCAD, "ecmc")):
        s = make(WIDE, U)
        for backend in ("auto", "pallas"):
            assert tapi.pick_backend(s, backend, WIDE, torch.float32, "cuda") == "kernel", kind
        low = lower.lower_sampler(s, kind, WIDE, torch.float32)
        assert low.lane_bytes() == 0 and low.n_trans == 4 * WIDE and lower.lane_fits(low)
        assert WIDE <= _limit(torch.float32, low)
    suzz = pt.SpeedUpZigZagAD(WIDE, U)  # K4: formed at each point, past LANE_BYTES
    assert tapi.pick_backend(suzz, "auto", WIDE, torch.float32, "cuda") == "engine"
    with pytest.raises(ValueError, match="bytes per lane"):
        tapi.pick_backend(suzz, "pallas", WIDE, torch.float32, "cuda")


def test_headers_form_the_products_once_per_transition():
    """K1 and K3 form ``P x`` and ``P^T x`` in ``form`` (every ``parts``-th
    row from the caller's ``part``, each over its columns) and read them through
    ``yw.prod``; K1 keeps no point context (no ``sums``), K3's ``sums``
    forms no product."""
    P = torch.as_tensor(_spd(D, 3))
    grad = torch.func.grad(lambda x: 0.5 * x @ (P.to(x) @ x))
    for kernel in ("zigzag", "bps"):
        low = lower.lower_gradient(grad, kernel, D, torch.float32)
        text = low.header()
        form = text[text.index("static void form("):text.index("static void at(")]
        assert f"j += {lower.FORM_ROWS} * parts" in form and "prm[0 + (rs[k]) * " in form
        assert "prm[0 + (q) * " in form  # P^T read column by column, one block
        assert f"static constexpr int NP = {4 * D};" in text
        assert f"yw.prod(0, {D}, i, nullptr" in text and f"yw.prod({2 * D}, {D}, i" in text
        assert ("static Sums sums(" in text) == (kernel == "bps")
        if kernel == "bps":
            sums = text[text.index("static Sums sums("):text.index("static void at(")]
            assert "prm[" not in sums
        else:
            assert not low.point and "moment_add" in text

"""``radon_x`` of ``test_torch_lower_regression.py`` (the non-centred radon
model with covariate matrices, d = 15: two products per transition on K1
and K3/K5, a scatter-add of rows that read them, ``X.T r`` into a slice of x)
through the plain chunk kernels fed the lowered config, against JAX's
Pallas kernel in interpret mode (``test_torch_lower_slice.run_both``) in
events mode: K1, K6, K4, K3 (BPS and Boomerang) and K5.  Float64.  The
chains start near the posterior, as the card's cells start from its draws
(:func:`start`).  Most of the time is JAX tracing and compiling its
interpreted kernel, once for each kernel and mode (about 6 s each), so the
radon targets' cases lie in four files of at most six:
``test_torch_lower_regression_horizon_pallas.py`` holds ``radon_x`` in
horizon mode (K1, K6, K4, K3), ``test_torch_lower_regression_fixed_pallas.py``
and ``test_torch_lower_regression_fixed_horizon_pallas.py``
``radon_x_fixed``; a kernel's two modes share its samplers (``pairs``).
"""

from functools import cache

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from chip_smoke import RADON_TRUTH, radon_x_posterior  # noqa: E402
from test_torch_lower_gather import KERNEL_MODES  # noqa: E402
from test_torch_lower_regression import DATA, TARGETS  # noqa: E402
from test_torch_lower_slice import B, _pair, check_outputs, run_both  # noqa: E402

TARGET = "radon_x"


@cache
def pairs(target, kernel):
    """The two packages' samplers of ``kernel`` on ``target``, shared by its
    modes."""
    d, make = TARGETS[target]
    return _pair(kernel, target, {target: make}, d)


def start(target, kernel, seed=47):
    """``(x0, v0)`` of B chains: the fixed model's exact posterior draws, and
    for ``radon_x`` its log scales at the truth's plus N(0, 0.1^2) noise;
    ``v0`` as ``test_torch_lower_slice._initial`` draws it.  From N(0, I)
    draws of every coordinate a log scale far below the truth's makes the
    residual's term stiff, and the two packages' equally valid rounding of
    ``X beta`` parts the Boomerang's states by 1e-11 relative within a
    chunk."""
    d = TARGETS[target][0]
    mean, cov = radon_x_posterior(DATA)
    rs = np.random.default_rng(seed)
    x0 = mean + rs.normal(size=(B, len(mean))) @ np.linalg.cholesky(cov).T
    if target == "radon_x":
        logs = np.log(RADON_TRUTH[3:1:-1]) + 0.1 * rs.normal(size=(B, 2))
        x0 = np.concatenate([x0, logs], 1)
    if kernel in ("zigzag", "sticky", "suzz"):
        return x0, rs.choice([-1.0, 1.0], size=(B, d))
    v0 = rs.normal(size=(B, d))
    return x0, v0 if kernel == "boomerang" else v0 / np.linalg.norm(v0, axis=1, keepdims=True)


def check(target, kernel, horizon):
    """One kernel and mode against JAX's interpreted kernel; K4's few events
    a transition on the radon models (its first envelope spans the default
    ``tmax``) are checked as they come."""
    d, make = TARGETS[target]
    ref, mine, t_target = run_both(kernel, target, horizon, targets={target: make}, d=d,
                                   pair=pairs(target, kernel), start=start(target, kernel))
    check_outputs(ref, mine, t_target, many_events=kernel != "suzz")
    assert (ref[len(ref) // 2][:, 0] > 0).sum() > 0


EVENTS = [k for k, h in KERNEL_MODES if not h]
HORIZON = [k for k, h in KERNEL_MODES if h]


@pytest.mark.parametrize("kernel", EVENTS)
def test_plain_kernel_on_radon_x_matches_pallas(kernel):
    check(TARGET, kernel, False)

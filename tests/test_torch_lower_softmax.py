"""The softmax regression lowered into the chunk kernels' generated
potential, against JAX: the plain chunk kernels fed the IR's torch pair
against JAX's Pallas kernel in interpret mode on the jnp twin
(``test_torch_lower_slice.run_both``), float64, D = 6, on K1 (events,
horizon), K6, K4 (events, horizon), K3 BPS (events, horizon), the Boomerang
and K5, for ``-(Y * log_softmax(X @ x.reshape(3, 2), 1)).sum() + |x|^2 /
200`` (the strided columns of the view, the backward's products flattened
at ``K r + k``) and the ``(K, p)`` layout ``X @ x.reshape(2, 3).T`` with
``logsumexp`` (the backward's rows one after another), and on K1 for
``x.reshape(2, 3)``, whose rows are the view's short axis.  Integers and the
activity mask equal, floats to rtol and atol 1e-12.  The targets and the
other checks: ``tests/test_torch_lower_mixture.py``.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lower_mixture import KERNELS, TARGETS, one_thread  # noqa: E402, F401
from test_torch_lower_slice import check_outputs, run_both  # noqa: E402


CASES = ([(k, t, h) for t in ("softmax_pk", "softmax_kp") for k, h in KERNELS]
         + [("zigzag", "softmax_pk_rows", False)])


@pytest.mark.parametrize("kernel,target,horizon", CASES)
def test_plain_kernel_on_softmax_matches_pallas(kernel, target, horizon):
    check_outputs(*run_both(kernel, target, horizon, targets=TARGETS))

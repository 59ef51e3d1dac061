"""``radon_x`` of ``test_torch_lower_regression.py`` through the plain
chunk kernels fed the lowered config, against JAX's Pallas kernel in
interpret mode, in horizon mode (K7): K1, K6, K4 and K3 (BPS), as
``test_torch_lower_regression_pallas.py`` holds it in events mode.
Float64.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lower_regression_pallas import HORIZON, check  # noqa: E402


@pytest.mark.parametrize("kernel", HORIZON)
def test_plain_kernel_on_radon_x_in_horizon_mode_matches_pallas(kernel):
    check("radon_x", kernel, True)

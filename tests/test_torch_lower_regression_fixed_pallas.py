"""``radon_x_fixed`` of ``test_torch_lower_regression.py`` (the non-centred
radon model with covariate matrices and both scales fixed, d = 13: its four
products formed once per transition on K1 and K3/K5, the scatter-add's too)
through the plain chunk kernels fed the lowered config, against JAX's
Pallas kernel in interpret mode in events mode, as
``test_torch_lower_regression_pallas.py`` holds ``radon_x``: K1, K6, K4, K3
(BPS and Boomerang) and K5.  Float64.
"""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lower_regression_pallas import EVENTS, check  # noqa: E402


@pytest.mark.parametrize("kernel", EVENTS)
def test_plain_kernel_on_radon_x_fixed_matches_pallas(kernel):
    check("radon_x_fixed", kernel, False)

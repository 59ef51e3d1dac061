"""The ICAR target of ``test_torch_lower_gather.py`` (two gathers at a
constant edge array and their scatter-adds) through the plain chunk
kernels fed the lowered config, against JAX's Pallas kernel in interpret
mode (``test_torch_lower_slice.run_both``): K1, K6, K4 and K3 in events and
horizon mode, the Boomerang and K5 in events mode, each once (K4's events
mode in ``test_torch_lower_gather.py``, beside its default first horizon).
Float64.  Most of this file's time is JAX compiling its interpreted kernel,
once for each kernel and mode (about 4 s each); a kernel's two modes share
its samplers (``pairs``), whose conversions JAX caches.
"""

from functools import cache

import pytest

torch = pytest.importorskip("torch")

from test_torch_lower_gather import KERNEL_MODES, TARGETS  # noqa: E402
from test_torch_lower_slice import _pair, check_outputs, run_both  # noqa: E402


PARITY = [(k, h) for k, h in KERNEL_MODES if (k, h) != ("suzz", False)]
TARGET = "icar_l3_full_sd"


@cache
def pairs(kernel):
    """The two packages' samplers of ``kernel`` on the target, shared by its
    modes."""
    d, make = TARGETS[TARGET]
    return _pair(kernel, TARGET, {TARGET: make}, d)


@pytest.mark.parametrize("kernel,horizon", PARITY)
def test_plain_kernel_on_gather_gradient_matches_pallas(kernel, horizon):
    """The plain chunk kernels fed the lowered config against JAX's Pallas
    kernel in interpret mode on the ICAR (L = 3, its sum-to-zero at
    ``FULL_SD``), each kernel and mode once but K4's events mode, which
    ``test_torch_lower_gather.py`` holds beside its default first
    horizon."""
    d, make = TARGETS[TARGET]
    check_outputs(*run_both(kernel, TARGET, horizon, targets={TARGET: make}, d=d,
                            pair=pairs(kernel)))

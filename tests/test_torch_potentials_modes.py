"""The plain chunk kernels on the new device tags against JAX, in the modes
``tests/test_torch_potentials.py`` leaves to this file (its harness; the two
files run on two test workers).

* horizon mode (K7): a funnel on every kernel, the Boomerang's elliptic flow
  included, and ``cauchy`` and ``ridged_gauss`` once each, against the
  Pallas kernel's ``mode="horizon"`` in interpret mode; the float32 target
  at the median clock an events chunk reaches, so that a share of the lanes
  freezes inside.  float64, held as the events-mode cases.
* ``"aniso"`` on K1, K6 and K4 (``tests/test_torch_scalar_chunk.py`` holds
  K3/K5 on it), in events mode, float64.
* float32, one case per kernel: event kinds equal on at least 99% of
  (transition, chain) pairs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_potentials import KERNELS, check_f64, run_both  # noqa: E402

HORIZON_CASES = [(kernel, ("funnel", "neal_funnel")[i % 2], 6, i % 3 > 0, 313 * i + 5)
                 for i, kernel in enumerate(KERNELS)]
HORIZON_CASES += [("suzz", "cauchy", 6, False, 808), ("zigzag", "ridged", 6, True, 909)]


@pytest.mark.parametrize("kernel,tag,d,signed,seed", HORIZON_CASES)
def test_plain_kernel_matches_pallas_f64_in_horizon_mode(kernel, tag, d, signed, seed):
    check_f64(kernel, tag, d, signed, seed, True)


@pytest.mark.parametrize("kernel", ["zigzag", "sticky", "suzz"])
def test_aniso_on_k1_k6_k4_matches_pallas_f64(kernel):
    check_f64(kernel, "aniso", 5, True, 71, False)


@pytest.mark.parametrize("kernel,tag", [("zigzag", "neal_funnel"), ("sticky", "funnel"),
                                        ("suzz", "cauchy"), ("bps", "ridged"),
                                        ("ecmc", "neal_funnel")])
def test_plain_kernel_matches_pallas_f32(kernel, tag):
    ref, mine, _ = run_both(kernel, tag, 6, True, jnp.float32, 4242, False)
    assert mine[0].dtype == np.float32
    ev = len(ref) // 2
    agree = np.mean(ref[ev][:, 0] == mine[ev][:, 0])
    assert agree >= 0.99, agree

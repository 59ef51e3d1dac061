"""Bouncy Particle Sampler (``pdmpflux_tpu/models/bps.py``).

Linear flow, scalar rate ``max(0, <grad_U(x_t), v_t>) + refresh_rate``, and
the bounce-or-refresh velocity jump, which runs inside the fused chunk
kernel (``ops/cuda/scalar_chunk.py``, K3).  The bound strategy is forced
non-vectorized, as in the reference.
"""

from __future__ import annotations

from ..ops.flows import linear_flow
from .base import PDMP, resolve_potential, tag_from


class BPS(PDMP):
    """Defaults as in ``BouncyParticleSamplers.jl:21-24`` (``tmax=1.0`` and
    ``refresh_rate=0.1`` for the manual-gradient constructor; ``BPSAD``
    below uses the reference's other defaults).  ``gaussian_velocity``
    refreshes to an N(0, I) velocity instead of a unit one."""

    def __init__(self, dim, grad_U, *, grid_size=10, tmax=1.0,
                 refresh_rate=0.1, vectorized_bound=False, signed_bound=True,
                 adaptive=True, gaussian_velocity=False, **kw):
        del vectorized_bound  # forced off for BPS (:37)
        super().__init__(
            dim, grad_U, grid_size=grid_size, tmax=tmax,
            refresh_rate=refresh_rate, vectorized_bound=False,
            signed_bound=signed_bound, adaptive=adaptive, **kw,
        )
        self.gaussian_velocity = bool(gaussian_velocity)

    def flow(self, x, v, t):
        return linear_flow(x, v, t)


def BPSAD(dim, U, *, refresh_rate=0.0, grid_size=10, tmax=2.0,
          signed_bound=True, adaptive=True, **kw):
    """``BPSAD`` (``BouncyParticleSamplers.jl:86-94``): ``grad_U`` by
    ``torch.func.grad``, ``refresh_rate=0.0`` and ``tmax=2.0``."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(BPS(
        dim, grad_U, potential=U_vec, refresh_rate=refresh_rate,
        grid_size=grid_size, tmax=tmax, signed_bound=signed_bound,
        adaptive=adaptive, **kw,
    ), U)

"""Forward Event-Chain Monte Carlo (``pdmpflux_tpu/models/ecmc.py``).

Linear flow, scalar rate ``max(0, <grad_U, v>)`` and the gradient-frame
velocity jump (``ForwardEventChainMonteCarlo.jl:132-176``), which runs
inside the fused chunk kernel (``ops/cuda/scalar_chunk.py``, K5): a radial
draw along the normalized gradient, the orthogonal component kept,
orthogonally switched or fully refreshed.  ``dim >= 2``; ``mix_p = 0`` at
``dim == 2``; the refresh rate is forced to 0.
"""

from __future__ import annotations

from ..ops.flows import linear_flow
from .base import PDMP, resolve_potential, tag_from

MIN_DIMENSION = 2


class ForwardECMC(PDMP):
    """Defaults as in ``ForwardEventChainMonteCarlo.jl:301-303``, except
    ``grid_size=20``, as in the JAX package."""

    def __init__(self, dim, grad_U, *, grid_size=20, tmax=2.0,
                 signed_bound=True, adaptive=True, ran_p=False, mix_p=0.5,
                 switch=True, positive=True, speed_factor=1.0, normal=False,
                 **kw):
        if dim < MIN_DIMENSION:
            raise ValueError(
                f"The dimension must be at least {MIN_DIMENSION} to use the "
                f"ForwardEventChain. Got dimension {dim}"
            )
        if dim == 2:
            mix_p = 0.0  # orthogonal refresh in dim < 3 causes zero division
        super().__init__(
            dim, grad_U, grid_size=grid_size, tmax=tmax,
            refresh_rate=0.0,  # forced (:322-323)
            vectorized_bound=False,  # forced (:321)
            signed_bound=signed_bound, adaptive=adaptive, **kw,
        )
        self.ran_p = bool(ran_p)
        self.mix_p = float(mix_p)
        self.switch = bool(switch)
        self.positive = bool(positive)
        self.speed_factor = float(speed_factor)
        self.normal = bool(normal)

    def flow(self, x, v, t):
        return linear_flow(x, v, t)


def ForwardECMCAD(dim, U, *, grid_size=20, tmax=2.0, signed_bound=True,
                  adaptive=True, ran_p=False, mix_p=0.5, switch=True,
                  positive=True, speed_factor=1.0, **kw):
    """``ForwardECMCAD`` (``ForwardEventChainMonteCarlo.jl:367-378``)."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(ForwardECMC(
        dim, grad_U, potential=U_vec, grid_size=grid_size, tmax=tmax,
        signed_bound=signed_bound, adaptive=adaptive, ran_p=ran_p,
        mix_p=mix_p, switch=switch, positive=positive,
        speed_factor=speed_factor, **kw,
    ), U)

"""Boomerang sampler (``pdmpflux_tpu/models/boomerang.py``).

Elliptic flow with the N(0, I) reference measure.  As in the JAX package,
the event rate and the bounce both use the effective gradient
``grad_U(x) - x``; a refresh draws an un-normalized N(0, I) velocity.  The
jump runs inside the fused chunk kernel (``ops/cuda/scalar_chunk.py``, K3)
and, batched below, in the transition engine (``core/engine.py``).
"""

from __future__ import annotations

import torch

from ..ops.flows import boomerang_flow
from .base import ScalarRatePDMP, resolve_potential, tag_from
from .bps import bounce_or_refresh


class Boomerang(ScalarRatePDMP):
    """Defaults as in ``BoomerangSamplers.jl:21-23``."""

    def __init__(self, dim, grad_U, *, grid_size=10, tmax=1.0,
                 refresh_rate=0.1, vectorized_bound=False, signed_bound=True,
                 adaptive=True, **kw):
        del vectorized_bound  # forced off (:36)
        super().__init__(
            dim, grad_U, grid_size=grid_size, tmax=tmax,
            refresh_rate=refresh_rate, vectorized_bound=False,
            signed_bound=signed_bound, adaptive=adaptive, **kw,
        )

    def _grad_eff(self, x):
        return self.grad_U(x) - x

    def _grad_like(self, x):
        """The effective gradient ``grad_U(x) - x`` of rows ``(..., d)``."""
        return self.grad_rows(x) - x

    def flow(self, x, v, t):
        return boomerang_flow(x, v, t)

    def velocity_jump(self, x, v, keys, is_active):
        """Reflect off the effective gradient's direction, or refresh to an
        un-normalized N(0, I) velocity (``BoomerangSamplers.jl:51-65``)."""
        g = self._grad_like(x)
        nrm = torch.sqrt(self.dims.sum(g * g, keepdim=True))
        e = g / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
        v_reflect = v - 2.0 * self.dims.sum(v * e, keepdim=True) * e
        return bounce_or_refresh(g, v, v_reflect, keys, self.refresh_rate, False, self.dims)


def BoomerangAD(dim, U, *, refresh_rate=0.0, grid_size=10, tmax=2.0,
                signed_bound=True, adaptive=True, **kw):
    """``BoomerangAD`` (``BoomerangSamplers.jl:79-87``): ``refresh_rate=0.0``,
    ``tmax=2.0``."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(Boomerang(
        dim, grad_U, potential=U_vec, refresh_rate=refresh_rate,
        grid_size=grid_size, tmax=tmax, signed_bound=signed_bound,
        adaptive=adaptive, **kw,
    ), U)

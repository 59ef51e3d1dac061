"""Bouncy Particle Sampler (``pdmpflux_tpu/models/bps.py``).

Linear flow, scalar rate ``max(0, <grad_U(x_t), v_t>) + refresh_rate``, and
the bounce-or-refresh velocity jump, which runs inside the fused chunk
kernel (``ops/cuda/scalar_chunk.py``, K3) and, batched below, in the
transition engine (``core/engine.py``).  The bound strategy is forced
non-vectorized, as in the reference.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..ops.flows import linear_flow
from .base import ScalarRatePDMP, max0, resolve_potential, tag_from


def bounce_or_refresh(g, v, v_reflect, keys, refresh_rate, normalize_fresh, dims):
    """The jump of BPS and the Boomerang on the (effective) gradient ``g``
    ``(B, d)``: ``v_reflect`` with probability ``bounce / (bounce + refresh)``,
    ``bounce = max(0, <g, v>)`` (0 when both are 0), else a fresh N(0, I)
    velocity, normalized when ``normalize_fresh``; the uniform and the
    normals from the two halves of each chain's key.  Sums over the
    coordinates of ``dims`` (``core/dims.py``)."""
    bounce_rate = max0(dims.sum(g * v))
    denom = bounce_rate + refresh_rate
    pos = denom > 0
    bounce_prob = torch.where(pos, bounce_rate / torch.where(pos, denom, torch.ones_like(denom)),
                              torch.zeros_like(denom))
    k = rng.split(keys, 2)
    u = rng.key_uniform(k[:, 0], v.dtype)
    fresh = rng.normal_shaped(k[:, 1], (dims.size(v),), v.dtype, dims.cols)
    if normalize_fresh:
        nrm = torch.sqrt(dims.sum(fresh * fresh, keepdim=True))
        fresh = fresh / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    return torch.where((u < bounce_prob)[:, None], v_reflect, fresh)


class BPS(ScalarRatePDMP):
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

    def velocity_jump(self, x, v, keys, is_active):
        """Reflect off ``grad_U(x)`` or refresh (``BouncyParticleSamplers.jl:50-74``)."""
        g = self.grad_rows(x)
        gg = self.dims.sum(g * g, keepdim=True)
        scale = 2.0 * self.dims.sum(v * g, keepdim=True) / torch.where(
            gg > 0, gg, torch.ones_like(gg))
        v_reflect = torch.where(gg > 0, v - scale * g, v)
        return bounce_or_refresh(g, v, v_reflect, keys, self.refresh_rate,
                                 not self.gaussian_velocity, self.dims)


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

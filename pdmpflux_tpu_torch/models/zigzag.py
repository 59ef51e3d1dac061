"""Zig-Zag sampler (``pdmpflux_tpu/models/zigzag.py``).

Linear flow, per-coordinate rates ``max(0, dU_i(x_t) v_i)`` and one
coordinate flip at an event, drawn in proportion to the rates
(``ZigZagSamplers.jl:101-107``).  The rates, the envelope and the flip run
inside the fused chunk kernel (``ops/cuda/zigzag_chunk.py``, K1) with
vectorized bounds; the batched rates and ``velocity_jump`` below are the
transition engine's (``core/engine.py``), which runs scalar bounds,
``grid_size = 0`` and finite-difference tangents.
"""

from __future__ import annotations

import torch

from ..core import rng
from ..ops.flows import linear_flow
from .base import PDMP, max0, resolve_potential, tag_from


class ZigZag(PDMP):
    """Zig-Zag sampler, defaults as in ``ZigZagSamplers.jl:58-60``."""

    def _zigzag_family(self):
        return True

    def __init__(self, dim, grad_U, *, grid_size=10, tmax=2.0,
                 refresh_rate=0.0, vectorized_bound=True, signed_bound=True,
                 adaptive=True, **kw):
        super().__init__(
            dim, grad_U, grid_size=grid_size, tmax=tmax,
            refresh_rate=refresh_rate, vectorized_bound=vectorized_bound,
            signed_bound=signed_bound, adaptive=adaptive, **kw,
        )

    def flow(self, x, v, t):
        return linear_flow(x, v, t)

    def _grad_like(self, x):
        """The gradient the rates and flips read, of rows ``(..., d)``."""
        return self.grad_rows(x)

    def rate(self, x, v, t):
        return self.dims.sum(self._rate_vect(x, v, t))

    def _rate_vect(self, x, v, t):
        return max0(self._signed_rate_vect(x, v, t))

    def _signed_rate_vect(self, x, v, t):
        xt, vt = self.along(x, v, t)
        return self._grad_like(xt) * vt

    rate_vect, signed_rate_vect = _rate_vect, _signed_rate_vect

    def _flip_rates(self, x, v, is_active):
        """Flip intensities at an event, on the velocity masked by
        ``is_active`` (the JAX package's fix: a frozen coordinate cannot
        flip)."""
        va = torch.where(is_active, v, torch.zeros_like(v))
        return max0(self._grad_like(x) * va)

    def velocity_jump(self, x, v, keys, is_active):
        lam = self._flip_rates(x, v, is_active)
        pos = lam > 0
        logits = torch.where(pos, torch.log(torch.where(pos, lam, torch.ones_like(lam))),
                             torch.full_like(lam, float("-inf")))
        return self.dims.put(v, rng.categorical(keys, logits, self.dims), -v)


def ZigZagAD(dim, U, **kw):
    """``ZigZagAD``: build ``grad_U`` from the potential with
    ``torch.func.grad``."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(ZigZag(dim, grad_U, potential=U_vec, **kw), U)

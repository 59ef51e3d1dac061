"""Zig-Zag sampler (``pdmpflux_tpu/models/zigzag.py``).

Linear flow, per-coordinate rates ``max(0, dU_i(x_t) v_i)``.  The velocity
jump (one coordinate flip drawn proportionally to the rates) runs inside the
fused chunk kernel, ``ops/cuda/zigzag_chunk.py``; the stand-alone
``velocity_jump`` of the XLA transition engine is not ported yet.
"""

from __future__ import annotations

from ..ops.flows import linear_flow
from .base import PDMP, resolve_potential, tag_from


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


def ZigZagAD(dim, U, **kw):
    """``ZigZagAD``: build ``grad_U`` from the potential with
    ``torch.func.grad``."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(ZigZag(dim, grad_U, potential=U_vec, **kw), U)

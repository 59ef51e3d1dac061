"""Speed-Up Zig-Zag (``pdmpflux_tpu/models/speedup_zigzag.py``).

Zig-Zag under the speed change ``s(x) = sqrt(1 + |x|^2)``: the closed-form
nonlinear flow (``ops/flows.suzz_flow``) and Zig-Zag-structured rates and
flips on the effective gradient ``grad_U_eff(x) = s(x) grad_U(x) - x / s(x)``.
The rates, the envelope's tangents and the flip run inside the fused chunk
kernel (``ops/cuda/zigzag_chunk.py``, K4), which builds the effective
gradient and its time derivative from the device potential's gradient and
Hessian-vector product; the transition engine (``core/engine.py``) takes
the rates and flips below, on the effective gradient of each row.
"""

from __future__ import annotations

import torch

from ..ops.flows import suzz_flow
from .base import resolve_potential, tag_from
from .zigzag import ZigZag


class SpeedUpZigZag(ZigZag):
    """Defaults as in ``SpeedUpZigZagSamplers.jl:58-69`` (Zig-Zag's flags)."""

    def _grad_eff(self, x):
        """The effective gradient of one chain, ``(d,)``."""
        s = torch.sqrt(1.0 + torch.sum(x * x))
        return s * self.grad_U(x) - x / s

    def _grad_like(self, x):
        """The effective gradient of rows ``(..., d)``."""
        s = torch.sqrt(1.0 + self.dims.sum(x * x, keepdim=True))
        return s * self.grad_rows(x) - x / s

    def flow(self, x, v, t):
        """The speed-change flow on rows with the coordinate axis last and
        ``t`` broadcasting as ``(..., 1)``."""
        return suzz_flow(x, v, t, dim_axis=-1, dims=self.dims)


def SpeedUpZigZagAD(dim, U, **kw):
    """``SpeedUpZigZagAD`` (``SpeedUpZigZagSamplers.jl:121-129``)."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(SpeedUpZigZag(dim, grad_U, potential=U_vec, **kw), U)

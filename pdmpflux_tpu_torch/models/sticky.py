"""Sticky Zig-Zag for sparse (spike-and-slab) posteriors
(``pdmpflux_tpu/models/sticky.py``).

The sticky logic (axis-hit sticking, Exp(sum kappa) thaw clocks, activity
masking) lives in the fused chunk kernel (K6) and in the transition engine's
sticky branches (``core/engine.py``), both activated by ``sticky = True``;
this class only adds the per-coordinate thawing rates ``kappa``, which the
engine reads for the thaw clock and the thawed coordinate's draw.
"""

from __future__ import annotations

import numpy as np
import torch

from .base import resolve_potential, tag_from
from .zigzag import ZigZag


class StickyZigZag(ZigZag):
    """Defaults as in ``StickyZigZagSamplers.jl:61-74``; ``kappa`` is the
    ``(dim,)`` vector of thawing rates (default 0.5 each)."""

    sticky = True

    def __init__(self, dim, grad_U, kappa=None, **kw):
        super().__init__(dim, grad_U, **kw)
        if kappa is None:
            kappa = np.full((dim,), 0.5)
        kappa = np.asarray(kappa, float)
        if kappa.shape != (dim,):
            raise ValueError(
                f"kappa must have shape ({dim},). Current shape: {kappa.shape}"
            )
        if np.any(kappa < 0):
            raise ValueError("kappa entries must be non-negative.")
        self.kappa = torch.as_tensor(kappa, dtype=torch.float64)


def StickyZigZagAD(dim, U, kappa=None, **kw):
    """``StickyZigZagAD`` (``StickyZigZagSamplers.jl:117-125``): ``grad_U``
    by ``torch.func.grad``, the device potential from ``U``'s tag."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(StickyZigZag(dim, grad_U, kappa, potential=U_vec, **kw), U)

"""Deterministic flows (``pdmpflux_tpu/ops/flows.py``).

The linear flow of the Zig-Zag family, BPS and Forward ECMC, and the
Boomerang's elliptic flow, written as the JAX package writes them."""

from __future__ import annotations

import torch


def linear_flow(x, v, t):
    """``(x, v, t) -> (x + v t, v)``; ``t`` broadcasts against ``x``."""
    return x + v * t, v


def boomerang_flow(x, v, t):
    """The rotation of ``(x, v)`` by the angle ``t`` (the Hamiltonian flow of
    the N(0, I) reference measure): ``(x cos t + v sin t, -x sin t + v cos t)``."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    c, s = torch.cos(t), torch.sin(t)
    return x * c + v * s, -x * s + v * c

"""Deterministic flows (``pdmpflux_tpu/ops/flows.py``).

Only the linear flow of the Zig-Zag family is ported so far."""

from __future__ import annotations


def linear_flow(x, v, t):
    """``(x, v, t) -> (x + v t, v)``; ``t`` broadcasts against ``x``."""
    return x + v * t, v

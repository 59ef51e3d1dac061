"""Deterministic flows (``pdmpflux_tpu/ops/flows.py``).

The linear flow of the Zig-Zag family, BPS and Forward ECMC, the
Boomerang's elliptic flow, the Speed-Up Zig-Zag's closed-form speed-change
flow and RHMC's velocity-Verlet flow, written as the JAX package writes
them."""

from __future__ import annotations

import math

import torch

from ..core.dims import LOCAL, ordered_sum


def div_once(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` rounded once, as the kernels divide: torch's CUDA division
    by a Python number multiplies by the number's rounded reciprocal."""
    return a / torch.full_like(a, b)


def linear_flow(x, v, t):
    """``(x, v, t) -> (x + v t, v)``; ``t`` broadcasts against ``x``."""
    return x + v * t, v


def boomerang_flow(x, v, t):
    """The rotation of ``(x, v)`` by the angle ``t`` (the Hamiltonian flow of
    the N(0, I) reference measure): ``(x cos t + v sin t, -x sin t + v cos t)``."""
    t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
    c, s = torch.cos(t), torch.sin(t)
    return x * c + v * s, -x * s + v * c


def _suzz_at(x, v, t, dim_axis, dims=LOCAL):
    """``x_t`` of the speed-change flow and its speed factor ``phi``
    (``dx_t/dt = phi v``), in ``make_suzz_flow``'s operations; the four
    per-chain terms ``v0, c / d, a`` and the base ``y0 + sqrt(y0^2 + a)``
    do not depend on ``t``.  Coordinates along the last axis are those of
    ``dims`` (``core/dims.py``); along another axis (the chunk kernels'
    ``(d, B)`` columns) they are all local."""
    if dim_axis == -1:
        d, osum = dims.size(x), dims.ordered_sum
        x0, v0 = dims.first(x), dims.first(v)
    else:
        d = x.shape[dim_axis]
        x0, v0 = x.narrow(dim_axis, 0, 1), v.narrow(dim_axis, 0, 1)

        def osum(a):
            return ordered_sum(a, dim_axis)
    y = x - v0 * x0 * v
    c = v0 * osum(y * v)
    a = div_once(1.0 + osum(y * y), d) - div_once(c * c, d * d)
    c_d = div_once(c, d)
    y0 = x0 + c_d
    # sqrt(float(dim)) is the double rounded to the state's type, as JAX
    # rounds the Python float
    b = (y0 + torch.sqrt(y0 * y0 + a)) * torch.exp(
        torch.full_like(v0, math.sqrt(d)) * v0 * t)
    x1 = (b * b - a) / (2.0 * b) - c_d
    # d x1 / dt = sqrt(d) v0 (b^2 + a) / (2 b), and x_t = y + v0 x1 v
    phi = v0 * (torch.full_like(v0, math.sqrt(d)) * v0 * ((b * b + a) / (2.0 * b)))
    return y + v0 * x1 * v, phi


def suzz_flow(x, v, t, dim_axis: int = -1, dims=LOCAL):
    """The Speed-Up Zig-Zag's flow under the speed ``s(x) = sqrt(1 + |x|^2)``
    (``make_suzz_flow``, ``SpeedUpZigZagSamplers.jl:71-79``) for ``v`` in
    ``{-1, +1}^d``: coordinates along ``dim_axis``, ``t`` broadcasting
    against ``x`` with that axis of size 1 (``(B,)`` times for ``(d, B)``
    chains, ``(..., 1)`` for rows).  Every per-chain sum is added in
    coordinate order (along the last axis over the coordinate group
    ``dims``, ``core/dims.py``: in order within each process's slice and
    then across the slices).
    ``t = 0`` is the identity only up to rounding, as in JAX."""
    return _suzz_at(x, v, t, dim_axis, dims)[0], v


def suzz_flow_tangent(x, v, t, dim_axis: int = -1):
    """``(x_t, phi)``: :func:`suzz_flow`'s position and its speed factor,
    ``dx_t/dt = phi v`` with ``phi = v0 sqrt(d) v0 (b_t^2 + a) / (2 b_t)``,
    in closed form where JAX takes ``jax.jvp`` through the flow."""
    return _suzz_at(x, v, t, dim_axis)


def rows_map(fn, x: torch.Tensor) -> torch.Tensor:
    """A one-chain map ``(d,) -> (d,)`` (or ``-> ()``) applied to every row of
    ``x`` ``(..., d)`` with ``torch.func.vmap``."""
    lead = x.shape[:-1]
    out = torch.func.vmap(fn)(x.reshape((-1, x.shape[-1])))
    return out.reshape(lead + out.shape[1:])


def make_verlet_flow(grad_rows, step_size: float):
    """The Hamiltonian flow ``x' = v, v' = -grad U(x)`` by velocity Verlet
    (``RandomizedHamiltonianMonteCarlo.jl:97-130``): ``n = floor(t / h)``
    full steps and one remainder step of ``t - n h``, each step's closing
    gradient reused as the next one's opening gradient (one gradient per
    step, as the JAX package chains it).  ``grad_rows`` maps rows ``(..., d)``
    to their gradients (``PDMP.grad_rows``).

    ``flow(x, v, t, t_max=None)`` takes rows ``(..., d)`` and times
    ``(..., 1)``.  The step count depends on the data: the loop runs to the
    largest count of the batch, read from the device, or to ``floor(t_max /
    h) + 1`` steps for a host bound ``t_max >= max(t)`` (no device read); a
    row past its own count keeps its state by selection, so its steps are
    exact identities."""
    def half_step(x, v, g, dt):
        v = v - 0.5 * dt * g
        x = x + dt * v
        g2 = grad_rows(x)
        return x, v - 0.5 * dt * g2, g2

    def flow(x, v, t, t_max=None):
        t = torch.as_tensor(t, dtype=x.dtype, device=x.device)
        h = torch.tensor(step_size, dtype=x.dtype, device=x.device)
        n = torch.floor(t / h)
        r = t - n * h
        g = grad_rows(x)
        steps = (int(n.max()) if n.numel() else 0) if t_max is None else \
            int(math.floor(t_max / step_size)) + 1
        for i in range(steps):
            x2, v2, g2 = half_step(x, v, g, h)
            go = n > i
            x, v, g = (torch.where(go, x2, x), torch.where(go, v2, v),
                       torch.where(go, g2, g))
        x, v, _ = half_step(x, v, g, r)
        return x, v

    return flow

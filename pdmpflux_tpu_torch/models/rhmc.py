"""Randomized Hamiltonian Monte Carlo as a PDMP (``pdmpflux_tpu/models/rhmc.py``).

Velocity-Verlet Hamiltonian flow between events (``ops/flows.make_verlet_flow``),
a constant Poisson refresh clock ``rate = refresh_rate``
(``RandomizedHamiltonianMonteCarlo.jl:133``) under the trivial two-point
constant bound, and Horowitz partial momentum refreshment
``v <- cos(phi) v + sin(phi) xi`` at events (``:143-148``).  No chunk kernel
covers it: it runs on the transition engine (``core/engine.py``), as in the
JAX package.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..core.types import BoundBox
from ..ops.flows import make_verlet_flow
from .base import PDMP, resolve_potential, tag_from


def _auto_horizon(refresh_rate: float, step_size: float,
                  overhead_steps: float = 14.0) -> float:
    """The JAX package's default thinning horizon for RHMC: the ``T`` on a
    grid of ``0.05 / refresh_rate`` steps minimizing ``(T / h + c) / (1 -
    exp(-refresh_rate T))``, the cost per event of a lane-batched Verlet
    flow with ``c`` transition overheads in Verlet-step units (``c = 14``,
    as that package calibrated it).  The horizon only segments the constant
    Poisson clock, so the law is the same at any ``T``."""
    lam, h = float(refresh_rate), float(step_size)
    best_T, best_cost = 1.0 / lam, float("inf")
    for i in range(1, 400):
        T = i * 0.05 / lam
        cost = (T / h + overhead_steps) / (1.0 - math.exp(-lam * T))
        if cost < best_cost:
            best_T, best_cost = T, cost
    return best_T


class RHMC(PDMP):
    """Defaults as in ``RandomizedHamiltonianMonteCarlo.jl:48-57``, except
    ``tmax=None``, which takes :func:`_auto_horizon` (the reference's fixed
    10.0 is honored when passed)."""

    flow_takes_bound = True

    def __init__(self, dim, grad_U, *, mean_duration=None, refresh_rate=1.0,
                 phi=math.pi / 2, step_size=0.05, tmax=None, adaptive=False, **kw):
        if mean_duration is not None:
            md = float(mean_duration)
            if not math.isfinite(md) or md <= 0:
                raise ValueError(
                    f"mean_duration must be finite and positive. Current value: {mean_duration}"
                )
            refresh_rate = 1.0 / md
        refresh_rate = float(refresh_rate)
        if not math.isfinite(refresh_rate) or refresh_rate <= 0:
            raise ValueError(
                f"refresh_rate must be finite and positive. Current value: {refresh_rate}"
            )
        phi = float(phi)
        if not (0.0 < phi <= math.pi / 2):
            raise ValueError(f"phi must satisfy 0 < phi <= pi/2. Current value: {phi}")
        step_size = float(step_size)
        if not math.isfinite(step_size) or step_size <= 0:
            raise ValueError(
                f"step_size must be finite and positive. Current value: {step_size}"
            )
        if tmax is None:
            tmax = _auto_horizon(refresh_rate, step_size)
        tmax = float(tmax)
        if not math.isfinite(tmax) or tmax < 0:
            raise ValueError(f"tmax must be finite and non-negative. Current value: {tmax}")
        super().__init__(
            dim, grad_U, grid_size=0, tmax=tmax, refresh_rate=refresh_rate,
            vectorized_bound=False, signed_bound=False, adaptive=adaptive, **kw,
        )
        self.phi = phi
        self.step_size = step_size
        self._flow = make_verlet_flow(self.grad_rows, step_size)

    def on_dims(self, dims):
        """As ``PDMP.on_dims``, with the Verlet flow on the view's gradient."""
        view = super().on_dims(dims)
        if view is not self:
            view._flow = make_verlet_flow(view.grad_rows, self.step_size)
        return view

    def flow(self, x, v, t, t_max=None):
        """Verlet flow of rows ``(..., d)`` by times ``(..., 1)``; ``t_max``
        bounds the times from the host (see ``make_verlet_flow``)."""
        return self._flow(x, v, t, t_max)

    def rate(self, x, v, t):
        return torch.full(t.shape, self.refresh_rate, dtype=x.dtype, device=x.device)

    def bound_box(self, x, v, horizon):
        """The trivial constant box (the reference's specialized
        ``init_state``, ``:208-218``)."""
        lam = torch.full_like(horizon, self.refresh_rate)
        zero = torch.zeros_like(horizon)
        return BoundBox(grid=torch.stack([zero, horizon], 1), box_max=lam[:, None],
                        cum_sum=torch.stack([zero, lam * horizon], 1), step_size=horizon)

    def velocity_jump(self, x, v, keys, is_active):
        xi = rng.normal_shaped(keys, (self.dims.size(v),), v.dtype, self.dims.cols)
        return math.cos(self.phi) * v + math.sin(self.phi) * xi


def RHMCAD(dim, U, **kw):
    """``RHMCAD`` (``RandomizedHamiltonianMonteCarlo.jl:182-186``): ``grad_U``
    by ``torch.func.grad``."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(RHMC(dim, grad_U, potential=U_vec, **kw), U)

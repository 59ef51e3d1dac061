"""Forward Event-Chain Monte Carlo (``pdmpflux_tpu/models/ecmc.py``).

Linear flow, scalar rate ``max(0, <grad_U, v>)`` and the gradient-frame
velocity jump (``ForwardEventChainMonteCarlo.jl:132-176``), which runs
inside the fused chunk kernel (``ops/cuda/scalar_chunk.py``, K5) and,
batched below, in the transition engine (``core/engine.py``): a radial
draw along the normalized gradient, the orthogonal component kept,
orthogonally switched or fully refreshed.  ``dim >= 2``; ``mix_p = 0`` at
``dim == 2``; the refresh rate is forced to 0.
"""

from __future__ import annotations

import math

import torch

from ..core import rng
from ..ops.flows import linear_flow
from .base import ScalarRatePDMP, resolve_potential, tag_from

TOLERANCE = 1e-10
MIN_DIMENSION = 2


def _dot(a, b, dims):
    return dims.sum(a * b, keepdim=True)


def _normalize(u, dims):
    """``(u / |u|, |u|)`` over the coordinates, ``u`` unchanged where ``|u| = 0``."""
    n = torch.sqrt(_dot(u, u, dims))
    return u / torch.where(n > 0, n, torch.ones_like(n)), n


class ForwardECMC(ScalarRatePDMP):
    """Defaults as in ``ForwardEventChainMonteCarlo.jl:301-303``, except
    ``grid_size=20``, as in the JAX package."""

    def __init__(self, dim, grad_U, *, grid_size=20, tmax=2.0,
                 signed_bound=True, adaptive=True, ran_p=False, mix_p=0.5,
                 switch=True, positive=True, speed_factor=1.0, normal=False,
                 **kw):
        if dim < MIN_DIMENSION:
            raise ValueError(
                f"The dimension must be at least {MIN_DIMENSION} to use the "
                f"ForwardEventChain. Got dimension {dim}"
            )
        if dim == 2:
            mix_p = 0.0  # orthogonal refresh in dim < 3 causes zero division
        super().__init__(
            dim, grad_U, grid_size=grid_size, tmax=tmax,
            refresh_rate=0.0,  # forced (:322-323)
            vectorized_bound=False,  # forced (:321)
            signed_bound=signed_bound, adaptive=adaptive, **kw,
        )
        self.ran_p = bool(ran_p)
        self.mix_p = float(mix_p)
        self.switch = bool(switch)
        self.positive = bool(positive)
        self.speed_factor = float(speed_factor)
        self.normal = bool(normal)

    def flow(self, x, v, t):
        return linear_flow(x, v, t)

    # -- jump helpers ----------------------------------------------------------
    def _orthogonal_switch(self, v_o, n, keys):
        """Orthogonal switch (``:60-88``): rotate ``v_o`` within a random
        2-plane of the orthogonal complement of ``n``."""
        dims = self.dims
        k = rng.split(keys, 2)
        g = rng.normal_shaped(k[:, 0], (2, dims.size(n)), n.dtype, dims.cols)
        g1 = g[:, 0] - _dot(g[:, 0], n, dims) * n
        g2 = g[:, 1] - _dot(g[:, 1], n, dims) * n
        e1, _ = _normalize(g1, dims)
        e2, _ = _normalize(g2 - _dot(g2, e1, dims) * e1, dims)
        c1, c2 = _dot(v_o, e1, dims), _dot(v_o, e2, dims)
        v_r = v_o - c1 * e1 - c2 * e2
        v_new = v_r + e2 * c1 + e1 * c2
        if self.ran_p:
            theta = (rng.key_uniform(k[:, 1], n.dtype) * 2.0 * math.pi)[:, None]
            ct, st = torch.cos(theta), torch.sin(theta)
            v_new = v_r + (ct * e1 + st * e2) * c1 + (st * e1 - ct * e2) * c2
        if self.positive:
            s = torch.sign(_dot(v_o, v_new, dims))
            v_new = v_new * torch.where(s == 0, torch.ones_like(s), s)
        return v_new

    def _full_refresh(self, n, keys):
        """Full orthogonal refresh (``:105-113``)."""
        dims = self.dims
        g, _ = _normalize(rng.normal_shaped(keys, (dims.size(n),), n.dtype, dims.cols), dims)
        return g - _dot(g, n, dims) * n

    def velocity_jump(self, x, v, keys, is_active):
        dt, dims = x.dtype, self.dims
        sf = self.speed_factor
        k = rng.split(keys, 4)
        k_rho, k_mix, k_deg, k_ref = k.unbind(1)
        if self.normal:
            rho = sf * (-torch.abs(rng.normal_shaped(k_rho, (), dt)))
        else:
            u = rng.key_uniform(k_rho, dt)
            rho = sf * (-torch.sqrt(1.0 - u ** (2.0 / (self.dim - 1))))
        rho = rho[:, None]
        n, ng = _normalize(self.grad_rows(x), dims)
        n = torch.where(ng > 0, n, torch.zeros_like(n))
        v_o = v - _dot(v, n, dims) * n
        # a degenerate orthogonal component is drawn afresh (:159-162)
        deg = torch.sqrt(_dot(v_o, v_o, dims)) < TOLERANCE
        fresh_o = rng.normal_shaped(k_deg, (dims.size(v),), dt, dims.cols)
        fresh_o = fresh_o - _dot(fresh_o, n, dims) * n
        v_o = torch.where(deg, fresh_o, v_o)
        if self.switch:
            v_o_prop = self._orthogonal_switch(v_o, n, k_ref)
        else:
            v_o_prop = self._full_refresh(n, k_ref)
        refresh = (rng.key_uniform(k_mix, dt) < self.mix_p)[:, None]
        v_o_sel = torch.where(refresh, v_o_prop, v_o)
        v_o_unit, _ = _normalize(v_o_sel, dims)
        zero = torch.zeros((), dtype=dt, device=x.device)
        if self.normal:
            # the speed depends on the orthogonal magnitude (:251, :257)
            mag2 = _dot(v_o_sel, v_o_sel, dims)
            tangential = torch.sqrt(torch.maximum(zero, sf * sf * mag2 - rho * rho))
        else:
            tangential = torch.sqrt(torch.maximum(zero, sf * sf - rho * rho))
        return v_o_unit * tangential + rho * n


def ForwardECMCAD(dim, U, *, grid_size=20, tmax=2.0, signed_bound=True,
                  adaptive=True, ran_p=False, mix_p=0.5, switch=True,
                  positive=True, speed_factor=1.0, **kw):
    """``ForwardECMCAD`` (``ForwardEventChainMonteCarlo.jl:367-378``)."""
    U_vec, grad_U = resolve_potential(U, dim)
    return tag_from(ForwardECMC(
        dim, grad_U, potential=U_vec, grid_size=grid_size, tmax=tmax,
        signed_bound=signed_bound, adaptive=adaptive, ran_p=ran_p,
        mix_p=mix_p, switch=switch, positive=positive,
        speed_factor=speed_factor, **kw,
    ), U)

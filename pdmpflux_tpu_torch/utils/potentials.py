"""Test potentials (``pdmpflux_tpu/utils/potentials.py``) as torch functions.

Each function below also carries a ``device_potential`` tag naming the
potential that the fused CUDA kernels implement on the card: the gradient
and its derivative along the velocity (the Hessian-vector product), from
which each kernel builds its rates and their time derivatives along its
flow.  A sampler built from a tagged potential or gradient can run them;
any other gradient runs only the plain PyTorch version on the CPU.

The kernels evaluate one coordinate ``i`` at time ``t`` along the linear
flow, ``g_i(x + v t)`` and ``(H(x + v t) v)_i``, from one definition
(``csrc/pdmp_common.cuh``) that K1 (``csrc/zigzag_chunk.cu``) calls on the
chain's column of the ``(d, B)`` state (stride ``B``), K6
(``csrc/sticky_chunk.cu``) on its shared-memory copy (stride 1) with the
masked velocity ``v * act``, K3/K5 (``csrc/scalar_chunk.cu``) on its
warp's shared-memory copy, and K4 (``csrc/suzz_chunk.cu``) at ``t = 0`` on
the point ``x_t`` of the Speed-Up Zig-Zag's nonlinear flow.  A tag may carry
parameters (``device_params``, a float64 vector): :func:`anisotropic_gauss`
carries its scales.  The chain-minor functions at the end of this module are
the same formulas on whole ``(d, B)`` tensors, for the plain versions; the
plain K6 passes them the masked velocity.
"""

from __future__ import annotations

import torch

DEVICE_POTENTIALS = {"gauss": 0, "banana": 1, "aniso": 2}
"""Tag -> potential id of the CUDA kernels (``Potential`` in the source);
each kernel wrapper names the tags its kernel implements."""


def _tag(name, params=None):
    def deco(fn):
        fn.device_potential = name
        fn.device_params = params
        return fn
    return deco


@_tag("gauss")
def gauss(x):
    """Isotropic standard Gaussian: ``U(x) = |x|^2 / 2``."""
    return torch.sum(x * x) / 2.0


@_tag("gauss")
def grad_gauss(x):
    """Gradient of :func:`gauss`, ``x -> x``."""
    return x


@_tag("banana")
def banana(x):
    """Banana target of the reference test suite (needs ``dim >= 2``)."""
    mean_x2 = x[0] ** 2 - 1.0
    return -(-x[0] ** 2 - (x[1] - mean_x2) ** 2 - torch.sum(x[2:] ** 2)) / 2.0


@_tag("banana")
def grad_banana(x):
    """Gradient of :func:`banana`."""
    r1 = x[1] - (x[0] * x[0] - 1.0)
    g0 = x[0] - 2.0 * x[0] * r1
    return torch.cat([torch.stack([g0, r1]), x[2:]])


def anisotropic_gauss(scales):
    """Axis-aligned anisotropic Gaussian with marginal standard deviations
    ``scales``: ``U(x) = sum((x / s)^2) / 2``.  The returned potential
    carries the tag ``"aniso"`` with the scales as its parameters."""
    s = torch.as_tensor(scales, dtype=torch.float64).reshape(-1)

    @_tag("aniso", s)
    def U(x):
        return torch.sum((x / s.to(x)) ** 2) / 2.0

    return U


# Chain-minor ((d, B), chains on the last axis) versions of the device
# potentials, written as the kernel evaluates them: the gradient, and the
# gradient with its derivative along v (the Hessian-vector product).  The
# plain version of the kernel uses these for tagged samplers.

def _gauss_lane(x):
    return x


def _gauss_lane_jvp(x, v):
    return x, v


def _banana_lane(x):
    r1 = x[1] - (x[0] * x[0] - 1.0)
    return torch.cat([(x[0] - 2.0 * x[0] * r1)[None], r1[None], x[2:]])


def _banana_lane_jvp(x, v):
    x0, v0, v1 = x[0], v[0], v[1]
    dg0 = (1.0 - 2.0 * (x[1] - (x0 * x0 - 1.0)) + 4.0 * x0 * x0) * v0 - 2.0 * x0 * v1
    dg1 = v1 - 2.0 * x0 * v0
    return _banana_lane(x), torch.cat([dg0[None], dg1[None], v[2:]])


def _aniso_lanes(scales):
    """``jax.grad`` of ``sum((x / s)^2) / 2`` evaluates ``(x / s) / s`` (the
    factors 2 and 1/2 cancel exactly); its derivative along v is
    ``(v / s) / s``."""
    def col(x):
        return scales.to(device=x.device, dtype=x.dtype)[:, None]

    def grad(x):
        s = col(x)
        return x / s / s

    def grad_jvp(x, v):
        s = col(x)
        return x / s / s, v / s / s

    return grad, grad_jvp


LANE_POTENTIALS = {
    "gauss": lambda _: (_gauss_lane, _gauss_lane_jvp),
    "banana": lambda _: (_banana_lane, _banana_lane_jvp),
    "aniso": _aniso_lanes,
}
"""Tag -> ``params -> (grad, grad_jvp)`` on chain-minor tensors."""

COORDINATEWISE = {"gauss", "aniso"}
"""Tags whose gradient's coordinate ``i`` reads coordinate ``i`` alone (and
parameter ``i``): a coordinate-sharded transition evaluates them on its
slice (``models/base.PDMP.grad_rows``)."""


def device_potential_of(*fns):
    """The first ``device_potential`` tag among ``fns`` and its parameters,
    ``(tag, params)``; ``(None, None)`` when none is tagged."""
    for fn in fns:
        tag = getattr(fn, "device_potential", None)
        if tag is not None:
            return tag, getattr(fn, "device_params", None)
    return None, None


# Test potentials without a device tag (``pdmpflux_tpu/utils/potentials.py``):
# the transition engine runs them on the card (``backend="xla_stream"``) and
# every path runs them on the CPU.

def gauss_1d(x):
    """The one-dimensional standard Gaussian, ``U(x) = x^2 / 2``."""
    return torch.sum(x * x) / 2.0


def funnel(x):
    """Neal-style funnel of the reference's test configuration (needs
    ``x[0] > 0``)."""
    d = x.shape[0]
    v = x[0]
    return v ** 2 / 2.0 + (d - 1) * torch.log(v) + torch.sum(x[1:] ** 2) / (2.0 * v ** 2)


def neal_funnel(x):
    """Neal's funnel, ``x[0] ~ N(0, 9)`` and ``x[1:] | x[0] ~ N(0, exp(x[0]) I)``,
    valid on all of R^d."""
    d = x.shape[0]
    v = x[0]
    return v * v / 18.0 + 0.5 * (d - 1) * v + 0.5 * torch.sum(x[1:] ** 2) * torch.exp(-v)


def ridged_gauss(x):
    """A Gaussian with sinusoidal ridges."""
    return torch.sum(x * x) / 2.0 + 0.1 * torch.sum(torch.sin(10.0 * x))


def cauchy(x):
    """Product of standard Cauchy marginals, ``U(x) = sum log(1 + x_i^2)``."""
    return torch.sum(torch.log1p(x * x))

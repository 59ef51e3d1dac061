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
carries its scales.  The two funnels' coordinate 0 also reads two sums over
the chain's other coordinates, ``S = sum_{j>=1} y_j^2`` and
``P = sum_{j>=1} y_j v_j`` at the point ``y``.  The chain-minor functions
at the end of this module are the same formulas on whole ``(d, B)``
tensors, for the plain versions and the transition engine, written in
``jax.grad``'s order of operations where the formula allows; the plain K6
passes them the masked velocity.  Their sums over coordinates run in
coordinate order, as K3/K5 and K4 add them.
"""

from __future__ import annotations

import torch

from ..core.dims import ordered_sum

DEVICE_POTENTIALS = {"gauss": 0, "banana": 1, "aniso": 2, "cauchy": 3, "ridged": 4,
                     "funnel": 5, "neal_funnel": 6}
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


def _cauchy_lane_jvp(y, v=None):
    """``jax.grad`` of ``sum(log1p(y^2))``: ``2 (y q)`` with
    ``q = 1 / (y^2 + 1)``; along v, ``2 (v q + y p)`` with
    ``p = -(2 (v y)) / (y^2 + 1)^2``."""
    j = y * y + 1.0
    q = torch.ones_like(j) / j
    g = 2.0 * (y * q)
    if v is None:
        return g
    p = -(2.0 * (v * y)) * (torch.ones_like(j) / (j * j))
    return g, 2.0 * (v * q + y * p)


def _ridged_lane_jvp(y, v=None):
    """``jax.grad`` of ``sum(y^2) / 2 + 0.1 sum(sin(10 y))`` as XLA compiles
    it (the factors 0.1 and 10 folded away): ``(cos(10 y) + y / 2) + y / 2``;
    along v, ``(-((10 v) sin(10 y)) + v / 2) + v / 2``."""
    z = 10.0 * y
    g = (torch.cos(z) + 0.5 * y) + 0.5 * y
    if v is None:
        return g
    return g, (-((10.0 * v) * torch.sin(z)) + 0.5 * v) + 0.5 * v


def chain_sums(y, v=None):
    """``(S, P)`` of ``(d, B)`` chains: ``S = sum_{j>=1} y_j^2`` and
    ``P = sum_{j>=1} y_j v_j`` (None without ``v``), added in coordinate
    order; zeros at ``d = 1``."""
    if y.shape[0] < 2:
        zero = torch.zeros_like(y[0])
        return zero, None if v is None else zero
    s = ordered_sum(y[1:] * y[1:], 0)[0]
    return s, None if v is None else ordered_sum(y[1:] * v[1:], 0)[0]


def _funnel_lane_jvp(y, v=None):
    """The funnel ``c^2 / 2 + (d - 1) log c + S / (2 c^2)``, ``c = y_0``:
    ``jax.grad`` evaluates ``g_0 = (-((S / c^4) c) + (d - 1) / c) + c`` and
    ``g_j = y_j / c^2``; along v, ``dg_0 = (-(2 P c / c^4 - 3 (S / c^4) v_0)
    - (d - 1) v_0 / c^2) + v_0`` and ``dg_j = v_j / c^2 - 2 v_0 (c / c^4) y_j``."""
    c = y[0]
    c2 = c * c
    one = torch.ones_like(c)
    r4 = one / (c2 * c2)
    ic2 = one / c2
    S, P = chain_sums(y, v)
    nm1 = float(y.shape[0] - 1)
    g = torch.cat([((-((r4 * S) * c) + torch.full_like(c, nm1) / c) + c)[None],
                   ic2 * y[1:]])
    if v is None:
        return g
    v0 = v[0]
    a1 = (r4 * (2.0 * P)) * c
    a2 = 3.0 * ((r4 * S) * v0)
    dg0 = (-(a1 - a2) - (nm1 * v0) / c2) + v0
    dic2 = (-2.0 * v0) * (c * r4)
    return g, torch.cat([dg0[None], ic2 * v[1:] + dic2 * y[1:]])


def _neal_funnel_lane_jvp(y, v=None):
    """Neal's funnel ``c^2 / 18 + (d - 1) c / 2 + S e^{-c} / 2``, ``c = y_0``:
    ``jax.grad`` evaluates ``g_0 = ((-((S / 2) e) + (d - 1) / 2) + c k) + c k``
    with ``e = exp(-c)``, ``k = 1 / 18``, and ``g_j = e y_j``; along v, with
    ``e' = -v_0 e``, ``dg_0 = (-(P e + (S / 2) e') + v_0 k) + v_0 k`` and
    ``dg_j = e' y_j + e v_j``."""
    c = y[0]
    e = torch.exp(-c)
    k = 1.0 / 18.0
    S, P = chain_sums(y, v)
    half_s = 0.5 * S
    g = torch.cat([((-(half_s * e) + 0.5 * (y.shape[0] - 1)) + c * k + c * k)[None],
                   e * y[1:]])
    if v is None:
        return g
    v0 = v[0]
    ed = -v0 * e
    dg0 = (-(P * e + half_s * ed) + v0 * k) + v0 * k
    return g, torch.cat([dg0[None], ed * y[1:] + e * v[1:]])


def _both(fn):
    """``params -> (grad, grad_jvp)`` for a closed form ``fn(y, v=None)``
    that returns the gradient alone without ``v``."""
    return lambda _: (fn, fn)


LANE_POTENTIALS = {
    "gauss": lambda _: (_gauss_lane, _gauss_lane_jvp),
    "banana": lambda _: (_banana_lane, _banana_lane_jvp),
    "aniso": _aniso_lanes,
    "cauchy": _both(_cauchy_lane_jvp),
    "ridged": _both(_ridged_lane_jvp),
    "funnel": _both(_funnel_lane_jvp),
    "neal_funnel": _both(_neal_funnel_lane_jvp),
}
"""Tag -> ``params -> (grad, grad_jvp)`` on chain-minor tensors."""

COORDINATEWISE = {"gauss", "aniso", "cauchy", "ridged"}
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


@_tag("gauss")
def gauss_1d(x):
    """The one-dimensional standard Gaussian, ``U(x) = x^2 / 2``."""
    return torch.sum(x * x) / 2.0


@_tag("funnel")
def funnel(x):
    """Neal-style funnel of the reference's test configuration (needs
    ``x[0] > 0``)."""
    d = x.shape[0]
    v = x[0]
    return v ** 2 / 2.0 + (d - 1) * torch.log(v) + torch.sum(x[1:] ** 2) / (2.0 * v ** 2)


@_tag("neal_funnel")
def neal_funnel(x):
    """Neal's funnel, ``x[0] ~ N(0, 9)`` and ``x[1:] | x[0] ~ N(0, exp(x[0]) I)``,
    valid on all of R^d."""
    d = x.shape[0]
    v = x[0]
    return v * v / 18.0 + 0.5 * (d - 1) * v + 0.5 * torch.sum(x[1:] ** 2) * torch.exp(-v)


@_tag("ridged")
def ridged_gauss(x):
    """A Gaussian with sinusoidal ridges."""
    return torch.sum(x * x) / 2.0 + 0.1 * torch.sum(torch.sin(10.0 * x))


@_tag("cauchy")
def cauchy(x):
    """Product of standard Cauchy marginals, ``U(x) = sum log(1 + x_i^2)``."""
    return torch.sum(torch.log1p(x * x))

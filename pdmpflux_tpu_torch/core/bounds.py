"""Thinning envelopes over a chain batch (``pdmpflux_tpu/core/bounds.py``).

The JAX package builds one chain's envelope and maps it over chains with
``jax.vmap``; here every function takes the whole batch, tensors leading
with ``B``, so that ``searchsorted``, ``argmax`` and the gathers run batched
without vmap rules.  A rate function ``fn(t)`` takes per-chain times of
shape ``(B, *S)`` and returns the rate ``(B, *S)``, or per-coordinate rates
``(B, *S, d)`` for the vectorized envelope; only the user's functions inside
it go through ``torch.func``.

* :func:`upper_bound_grid` / :func:`upper_bound_grid_vect`: the
  tangent-intersection envelope on a uniform grid, with time derivatives by
  ``torch.func.jvp`` (``tderiv="jvp"``) or by central differences
  (``"finite_diff"``);
* :func:`upper_bound_constant`: the constant bound of ``grid_size == 0``
  (17-point coarse scan, then 16 golden-section steps);
* :func:`next_event`: the envelope inverted at the cumulative Exp(1) draw,
  ``t = inf`` past its end.
"""

from __future__ import annotations

from typing import Callable

import torch

from .dims import LOCAL
from .types import BoundBox

_INVPHI = 0.6180339887498949
_INVPHI2 = 0.38196601125010515


def linspace0(horizon: torch.Tensor, n: int) -> torch.Tensor:
    """``jnp.linspace(0.0, h, n)`` per chain as XLA compiles it: ``(B, n)``,
    ``h * (i * (1 / (n - 1)))`` below the end point (XLA multiplies by the
    constant's reciprocal) and exactly ``h`` at it."""
    i = torch.arange(n - 1, dtype=horizon.dtype, device=horizon.device)
    return torch.cat([horizon[:, None] * (i * (1.0 / (n - 1)))[None, :], horizon[:, None]], 1)


def _trailing(a: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``a`` ``(B, ...)`` with unit axes appended up to ``like``'s rank."""
    return a.reshape(a.shape + (1,) * (like.dim() - a.dim()))


def _time_derivatives(fn: Callable, ts: torch.Tensor, horizon: torch.Tensor, mode: str):
    """Values and d/dt of ``fn`` on the grid ``ts`` ``(B, n)``.

    ``"jvp"``: exact forward-mode tangents; ``"finite_diff"``: central
    differences with ``sqrt(eps) * max(1, |t|)`` steps clipped to
    ``[0, horizon]`` (``UpperBound.jl:50-76``)."""
    if mode == "jvp":
        return torch.func.jvp(fn, (ts,), (torch.ones_like(ts),))
    if mode == "finite_diff":
        eps = torch.tensor(torch.finfo(ts.dtype).eps, dtype=ts.dtype, device=ts.device)
        h = torch.sqrt(eps) * torch.clamp_min(ts.abs(), 1.0)
        lo = torch.clamp_min(ts - h, 0.0)
        hi = torch.minimum(horizon[:, None], ts + h)
        f, f_lo, f_hi = fn(ts), fn(lo), fn(hi)
        span = hi - lo
        span = _trailing(torch.where(span == 0, torch.ones_like(span), span), f)
        return f, (f_hi - f_lo) / span
    raise ValueError(f"unknown time-derivative mode: {mode}")


def _segment_envelope(values, grads, step):
    """Per-segment envelope ``max(f0, f1, f0 + g0 s*, 0)`` from the endpoint
    values and derivatives (grid on axis 1, any trailing axes elementwise),
    ``s*`` the intersection offset of the two tangents clamped to
    ``[0, step]``, NaN intersections taken as 0 (``UpperBound.jl:123-131``)."""
    f0, f1 = values[:, :-1], values[:, 1:]
    g0, g1 = grads[:, :-1], grads[:, 1:]
    step = _trailing(step, f0)
    denom = g1 - g0
    num = f0 - f1 + g1 * step
    zero = torch.zeros((), dtype=f0.dtype, device=f0.device)
    flat = denom == 0
    ip = torch.where(flat, zero, num / torch.where(flat, torch.ones_like(denom), denom))
    ip = torch.where(torch.isnan(ip), zero, ip)
    ip = torch.minimum(torch.maximum(ip, zero), step)
    return torch.maximum(torch.maximum(f0, f1), torch.maximum(f0 + g0 * ip, zero))


def _box(ts, box, step):
    cum = torch.cat([torch.zeros_like(box[:, :1]), torch.cumsum(box, 1) * step[:, None]], 1)
    return BoundBox(grid=ts, box_max=box, cum_sum=cum, step_size=step)


def upper_bound_grid(rate_fn: Callable, horizon: torch.Tensor, n_grid: int,
                     refresh_rate=0.0, tderiv: str = "jvp") -> BoundBox:
    """Scalar-rate grid envelope (``UpperBound.jl:92-137``) over ``n_grid``
    points spanning each chain's ``[0, horizon]``, plus ``refresh_rate``."""
    ts = linspace0(horizon, n_grid)
    step = horizon * (1.0 / (n_grid - 1))
    values, grads = _time_derivatives(rate_fn, ts, horizon, tderiv)
    return _box(ts, _segment_envelope(values, grads, step) + refresh_rate, step)


def upper_bound_grid_vect(rate_vect_fn: Callable, horizon: torch.Tensor, n_grid: int,
                          tderiv: str = "jvp", dims=LOCAL) -> BoundBox:
    """Vectorized envelope (``UpperBound.jl:203-247``): one envelope per
    coordinate, summed over the coordinates of ``dims`` (``core/dims.py``);
    no refresh rate."""
    ts = linspace0(horizon, n_grid)
    step = horizon * (1.0 / (n_grid - 1))
    values, grads = _time_derivatives(rate_vect_fn, ts, horizon, tderiv)  # (B, n, d)
    return _box(ts, dims.sum(_segment_envelope(values, grads, step)), step)


def upper_bound_constant(rate_fn: Callable, horizon: torch.Tensor, refresh_rate=0.0,
                         n_coarse: int = 17, n_refine: int = 16) -> BoundBox:
    """Constant envelope (``UpperBound.jl:18-36``): the best of a coarse
    scan, refined by golden-section steps around it (a local maximum, as
    Brent's method finds; bound violations are repaired by the engine's
    ``ar > 1`` path)."""
    ts = linspace0(horizon, n_coarse)
    vals = rate_fn(ts)
    i = torch.argmax(vals, 1, keepdim=True)
    span = horizon * (1.0 / (n_coarse - 1))
    t_i = torch.gather(ts, 1, i)[:, 0]
    lo = torch.clamp_min(t_i - span, 0.0)
    hi = torch.minimum(horizon, t_i + span)
    best = torch.gather(vals, 1, i)[:, 0]
    for _ in range(n_refine):
        m1 = lo + _INVPHI2 * (hi - lo)
        m2 = lo + _INVPHI * (hi - lo)
        f1, f2 = rate_fn(m1), rate_fn(m2)
        best = torch.maximum(best, torch.maximum(f1, f2))
        take_left = f1 >= f2
        lo = torch.where(take_left, lo, m1)
        hi = torch.where(take_left, m2, hi)
    box = (best + refresh_rate)[:, None]
    grid = torch.stack([torch.zeros_like(horizon), horizon], 1)
    cum = torch.cat([torch.zeros_like(box), box * horizon[:, None]], 1)
    return BoundBox(grid=grid, box_max=box, cum_sum=cum, step_size=horizon)


def next_event(box: BoundBox, exp_rv: torch.Tensor):
    """``(t, lam)`` per chain: the envelope inverted at the cumulative draw
    ``exp_rv`` (``UpperBound.jl:264-273``), a left ``searchsorted`` and a
    linear interpolation in the segment; ``(inf, box_max[-1])`` when the
    draw exceeds the integrated envelope."""
    cum = box.cum_sum
    n = cum.shape[1]
    idx = torch.searchsorted(cum.contiguous(), exp_rv[:, None].contiguous(), side="left")
    overflow = idx[:, 0] >= n
    i1 = torch.clamp(idx, 1, n - 1)
    i0 = i1 - 1
    lo, hi = torch.gather(cum, 1, i0)[:, 0], torch.gather(cum, 1, i1)[:, 0]
    den = torch.where(hi == lo, torch.ones_like(hi), hi - lo)
    frac = (exp_rv - lo) / den
    g0 = torch.gather(box.grid, 1, i0)[:, 0]
    tp = g0 + frac * (torch.gather(box.grid, 1, i1)[:, 0] - g0)
    tp = torch.where(overflow, torch.full_like(tp, float("inf")), tp)
    lam = torch.where(overflow, box.box_max[:, -1], torch.gather(box.box_max, 1, i0)[:, 0])
    return tp, lam

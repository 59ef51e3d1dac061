"""Chain-batch helpers (``pdmpflux_tpu/parallel/sharded.py``).

On one card a chain batch is a plain leading axis; the multi-device drivers
of the JAX package are not ported yet."""

from __future__ import annotations

import torch

from ..core.types import Skeleton
from ..ops.flows import div_once


def _batch_interp(sampler, skeleton: Skeleton, n_per_chain: int):
    """Per chain, ``n_per_chain`` equal-time points on ``(0, t_end]``:
    positions, velocities and times, each ``(B, n, ...)``."""
    t, X, V, A = skeleton.t, skeleton.x, skeleton.v, skeleton.is_active
    nv = skeleton.n_valid.to(torch.int64)
    B, N = t.shape
    last = torch.clamp_min(nv - 1, 0)
    t_end = torch.gather(t, 1, last[:, None])                 # (B, 1)
    # padding columns hold zeros; push them past any query time so the
    # search only sees the valid monotone prefix
    col = torch.arange(N, device=t.device)[None, :]
    tb_eff = torch.where(col < nv[:, None], t, torch.full_like(t, float("inf")))
    # divided, as JAX divides: on CUDA, torch's division by a Python number
    # multiplies by its rounded reciprocal
    tm = torch.arange(1, n_per_chain + 1, dtype=t.dtype,
                      device=t.device)[None, :] * div_once(t_end, n_per_chain)
    idx = torch.searchsorted(tb_eff.contiguous(), tm.contiguous(), right=True) - 1
    idx = torch.minimum(torch.clamp_min(idx, 0), last[:, None])
    i3 = idx[:, :, None].expand(-1, -1, X.shape[2])
    xb = torch.gather(X, 1, i3)
    vb = torch.where(torch.gather(A, 1, i3), torch.gather(V, 1, i3),
                     torch.zeros((), dtype=V.dtype, device=V.device))
    xs, vs = sampler.flow(xb, vb, (tm - torch.gather(t, 1, idx))[:, :, None])
    return xs, vs, tm


def sample_from_skeleton_batch(sampler, n_per_chain: int, skeleton: Skeleton,
                               *, discard_vt: bool = True):
    """``(B, n, d)`` equal-time positions per chain, or ``(B, n, 2d + 1)``
    with velocities and times when ``discard_vt=False``."""
    xs, vs, tm = _batch_interp(sampler, skeleton, n_per_chain)
    if discard_vt:
        return xs
    return torch.cat([xs, vs, tm[:, :, None]], dim=2)


def pooled_moments(skeleton: Skeleton, sampler, n_per_chain: int):
    """Cross-chain pooled mean and variance of ``n_per_chain`` equal-time
    samples per chain."""
    xs, _, _ = _batch_interp(sampler, skeleton, n_per_chain)
    B = xs.shape[0]
    n_tot = B * n_per_chain
    mean = div_once(torch.sum(torch.sum(xs, dim=1), dim=0), n_tot)
    var = div_once(torch.sum(torch.sum(xs * xs, dim=1), dim=0), n_tot) - mean ** 2
    return mean, var

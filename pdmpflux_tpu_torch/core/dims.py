"""The coordinate group of a transition: which of the ``d`` coordinates this
process holds, and the reductions over all of them.

The JAX package shards the coordinate axis of ``sample_skeleton_gspmd``
over a mesh's ``dim`` axis and lets XLA's partitioner insert the
collectives.  PyTorch has no partitioner, so the port's transition
(``core/engine.py``), envelopes (``core/bounds.py``), samplers
(``models/``) and flows (``ops/flows.py``) reduce over coordinates through
a group object:

* :data:`LOCAL`: every coordinate in this process; its operations are the
  plain torch reductions over the last axis, so a run without a mesh is
  the same computation as before the group existed;
* :class:`ShardedDims`: the slice ``[lo, hi)`` of the coordinates held by
  this process of a ``torch.distributed`` group (``parallel/mesh.py``
  builds one per chain row of a mesh).  Every reduction gathers each
  process's partial result and combines the parts in rank order, so every
  process of the group computes the same bits and takes the same branch;
  the sums are linear, so the envelope's forward-mode tangents
  (``torch.func.jvp``) pass through them.

Every operation reduces over the last axis.  A gradient that is not
coordinatewise runs on the gathered rows and keeps this process's slice
(``models/base.PDMP.grad_rows``), as GSPMD runs a function it cannot
partition.  Shaped random draws keep the unsharded bits: with JAX's
partitionable Threefry an element's word depends only on its flat index,
so a process computes the counters of its own slice (``cols``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def ordered_sum(a: torch.Tensor, axis: int) -> torch.Tensor:
    """Sum over ``axis`` (kept with size 1), added in coordinate order as the
    CUDA kernels add it: torch's own reductions order their adds otherwise."""
    s = a.narrow(axis, 0, 1)
    for i in range(1, a.shape[axis]):
        s = s + a.narrow(axis, i, 1)
    return s


def ordered_matvec(m: torch.Tensor, u: torch.Tensor, block: int = 1 << 20) -> torch.Tensor:
    """``m @ u`` for an ``(r, c)`` matrix and ``(c, n)`` columns, each element
    added over ``c`` in order as :func:`ordered_sum` adds
    (``ordered_sum(m[:, :, None] * u[None], 1)[:, 0]`` bit for bit): the
    products formed a block of columns at a time (about ``block`` values),
    then added one column after another."""
    r, c = m.shape
    step = max(1, min(c, block // max(1, r * u.shape[1])))
    s = None
    for c0 in range(0, c, step):
        p = m[:, c0:c0 + step, None] * u[None, c0:c0 + step]
        for i in range(p.shape[1]):
            s = p[:, 0] if s is None else s + p[:, i]
    return s


class Dims:
    """All ``d`` coordinates in this process (:data:`LOCAL`)."""

    sharded = False
    lo = 0
    cols: Optional[Tuple[int, int]] = None
    """``(lo, hi)`` of the last axis for ``core/rng``'s shaped draws; None
    for every coordinate."""

    def size(self, a: torch.Tensor) -> int:
        """The number of coordinates ``d`` of a ``(..., d_local)`` tensor."""
        return a.shape[-1]

    def sum(self, a: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
        return torch.sum(a, -1, keepdim=keepdim)

    def ordered_sum(self, a: torch.Tensor) -> torch.Tensor:
        """The sum in coordinate order, kept with size 1 (:func:`ordered_sum`)."""
        return ordered_sum(a, -1)

    def any(self, a: torch.Tensor) -> torch.Tensor:
        return a.any(-1)

    def all(self, a: torch.Tensor) -> torch.Tensor:
        return a.all(-1)

    def min_argmin(self, a: torch.Tensor):
        """``(min, argmin)``: the first index of the minimum."""
        return a.min(-1).values, torch.argmin(a, -1)

    def argmax(self, a: torch.Tensor) -> torch.Tensor:
        """The first index of the maximum."""
        return torch.argmax(a, -1)

    def first(self, a: torch.Tensor) -> torch.Tensor:
        """Coordinate 0, kept with size 1."""
        return a.narrow(-1, 0, 1)

    def put(self, a: torch.Tensor, idx: torch.Tensor, val, rows=None) -> torch.Tensor:
        """``a`` ``(B, d_local)`` with each chain's coordinate ``idx`` ``(B,)``
        set to ``val``: a scalar, or that coordinate of a tensor shaped as
        ``a``.  ``rows``: ``arange(B)`` on ``a``'s device, where the caller
        has it."""
        if rows is None:
            rows = torch.arange(a.shape[0], device=a.device)
        out = a.clone()
        out[rows, idx] = val[rows, idx] if isinstance(val, torch.Tensor) else val
        return out

    def gather(self, a: torch.Tensor) -> torch.Tensor:
        """``(..., d_local)`` to the whole ``(..., d)``."""
        return a

    def local(self, a: torch.Tensor) -> torch.Tensor:
        """This process's slice of the last axis of a whole ``(..., d)``."""
        return a


LOCAL = Dims()


class _SumParts(torch.autograd.Function):
    """The rank-ordered sum of every process's part; its tangent is the
    same sum of the parts' tangents."""

    @staticmethod
    def forward(part, dims):
        return dims.add_parts(part)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dims = inputs[1]

    @staticmethod
    def jvp(ctx, tangent, _):
        return ctx.dims.add_parts(tangent)


class _CatParts(torch.autograd.Function):
    """Every process's ``(..., n)`` part concatenated along the last axis in
    rank order; its tangent likewise."""

    @staticmethod
    def forward(part, dims):
        return torch.cat(list(dims.parts(part)), -1)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.dims = inputs[1]

    @staticmethod
    def jvp(ctx, tangent, _):
        return torch.cat(list(ctx.dims.parts(tangent)), -1)


class ShardedDims(Dims):
    """The slice ``[lo, hi)`` of ``d`` coordinates held by rank ``rank`` of
    ``group`` (``size`` processes, equal slices in rank order).

    The collectives gather every process's part: NCCL on the card gathers
    on the device; any other backend (gloo, whose CUDA support lacks
    ``all_gather``) gathers on the host, the part copied there and back.
    That staging serves correctness (two processes sharing one card), not
    speed."""

    sharded = True

    def __init__(self, d: int, rank: int, size: int, group=None):
        if d % size:
            raise ValueError(f"dimension {d} must be divisible by the {size}-device "
                             "'dim' mesh axis")
        self.d, self.rank, self.n_parts, self.group = d, rank, size, group
        self.lo, self.hi = rank * d // size, (rank + 1) * d // size
        self.cols = (self.lo, self.hi)
        self.nccl = dist.get_backend(group) == "nccl"

    def __repr__(self) -> str:
        return f"ShardedDims(d={self.d}, [{self.lo}, {self.hi}), {self.n_parts} parts)"

    def size(self, a: torch.Tensor) -> int:
        return self.d

    def parts(self, t: torch.Tensor) -> torch.Tensor:
        """``(size, *t.shape)``: every process's ``t`` in rank order."""
        t = t.detach().contiguous()
        if self.nccl:
            out = t.new_empty((self.n_parts,) + t.shape)
            dist.all_gather_into_tensor(out, t, group=self.group)
            return out
        host = t.cpu()
        parts = [torch.empty_like(host) for _ in range(self.n_parts)]
        dist.all_gather(parts, host, group=self.group)
        return torch.stack(parts).to(t.device)

    def add_parts(self, part: torch.Tensor) -> torch.Tensor:
        parts = self.parts(part)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def sum(self, a, keepdim=False):
        return _SumParts.apply(torch.sum(a, -1, keepdim=keepdim), self)

    def ordered_sum(self, a):
        return _SumParts.apply(ordered_sum(a, -1), self)

    def any(self, a):
        return self.parts(a.any(-1).to(torch.uint8)).amax(0) > 0

    def all(self, a):
        return self.parts(a.all(-1).to(torch.uint8)).amin(0) > 0

    def _pick(self, vals: torch.Tensor, idx: torch.Tensor, largest: bool):
        """The winning part's value and global index; ties go to the
        lowest rank, whose coordinates come first."""
        v, i = self.parts(vals), self.parts(idx + self.lo)
        r = (torch.argmax(v, 0) if largest else torch.argmin(v, 0))[None]
        return torch.gather(v, 0, r)[0], torch.gather(i, 0, r)[0]

    def min_argmin(self, a):
        return self._pick(a.min(-1).values, torch.argmin(a, -1), largest=False)

    def argmax(self, a):
        return self._pick(a.max(-1).values, torch.argmax(a, -1), largest=True)[1]

    def put(self, a, idx, val, rows=None):
        """As :meth:`Dims.put`, where this process holds the coordinate."""
        cols = torch.arange(self.lo, self.hi, device=a.device)
        return torch.where(cols[None, :] == idx[:, None], val, a)

    def first(self, a):
        return _CatParts.apply(a.narrow(-1, 0, 1), self).narrow(-1, 0, 1)

    def gather(self, a):
        return _CatParts.apply(a, self)

    def local(self, a):
        return a[..., self.lo:self.hi]

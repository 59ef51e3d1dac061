"""K2: event-row compaction of a raw stream fill.

One function takes the place of the JAX package's
``engine.compact_stream_rows`` / ``compact_stream_rows_with_init`` (XLA
log-shift at ``d < 128``, Pallas ``compact.compact_field`` at ``d >= 128``)
and ``engine.merge_stream_at_offsets``: for each chain, the rows whose kind is
``> 0`` go, in time order, to output columns ``off[b] + j``; columns past the
chain's events are zeroed, columns below ``off[b]`` are left as they are, and
an optional init record goes to column 0.

* ``off = 0`` (``None``), no init: ``compact_stream_rows``;
* ``off = 1`` with the init record: ``compact_stream_rows_with_init``;
* ``off = 1 + prev_counts`` into the accumulator: ``merge_stream_at_offsets``.

Sources are read in the fill's chain-minor ``(T, F, B)`` layout (any row and
field stride, chains contiguous); outputs are ``(B, W, F)``.
:func:`compact_rows` runs the CUDA kernel (``csrc/compact.cu``) for CUDA
tensors and the plain version, :func:`compact_rows_plain`, for CPU tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence

import torch

from ...core.types import Event, RawFill, Skeleton
from . import build


class FieldSpec(NamedTuple):
    """One field to compact: ``src`` ``(T, F, B)`` or None (rows of ones),
    ``out`` ``(B, W, F)``, ``init`` ``(B, F)`` or None."""

    src: Optional[torch.Tensor]
    out: torch.Tensor
    init: Optional[torch.Tensor] = None


def compact_rows_plain(kind: torch.Tensor, fields: Sequence[FieldSpec],
                       off: Optional[torch.Tensor]) -> None:
    """Plain PyTorch version of K2 (``kind`` is ``(T, B)``)."""
    T, B = kind.shape
    W = fields[0].out.shape[1]
    dev = kind.device
    keep = (kind > 0).T                                    # (B, T)
    pos = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    o = (torch.zeros(B, dtype=torch.int64, device=dev) if off is None
         else off.to(torch.int64))
    dest = o[:, None] + pos
    bi, ti = torch.nonzero(keep & (dest < W), as_tuple=True)
    ci = dest[bi, ti]
    col = torch.arange(W, device=dev)[None, :]
    tail = col >= (o + keep.sum(dim=1))[:, None]           # (B, W)
    for spec in fields:
        out = spec.out
        out[tail] = 0
        if spec.src is None:
            out[bi, ci] = 1
        else:
            out[bi, ci] = spec.src.permute(2, 0, 1)[bi, ti].to(out.dtype)
        if spec.init is not None and W > 0:
            out[:, 0] = spec.init


def _check_cuda(kind, fields, off):
    T, B = kind.shape
    if kind.dtype != torch.int32 or kind.stride(1) != 1:
        raise ValueError("kind must be int32 with chains contiguous")
    if off is not None and (off.dtype != torch.int32 or tuple(off.shape) != (B,)
                            or not off.is_contiguous()):
        raise ValueError(f"off must be a contiguous int32 ({B},) tensor")
    if not 1 <= len(fields) <= 12:
        raise ValueError("compact_rows takes 1 to 12 fields")
    W = fields[0].out.shape[1]
    for spec in fields:
        out = spec.out
        F = out.shape[2]
        if (out.shape[0] != B or out.shape[1] != W or not out.is_contiguous()
                or out.element_size() not in (1, 4, 8)):
            raise ValueError(f"out must be a contiguous ({B}, {W}, F) tensor "
                             "of 1-, 4- or 8-byte elements")
        if spec.src is not None:
            s = spec.src
            if (s.dtype != out.dtype or tuple(s.shape) != (T, F, B)
                    or (s.stride(2) != 1 and s.numel() > 0)):  # T = 0: nothing read
                raise ValueError(f"src must be {out.dtype} ({T}, {F}, {B}) with "
                                 f"chains contiguous, got {s.dtype} {tuple(s.shape)}")
        if spec.init is not None and (spec.init.dtype != out.dtype
                                      or tuple(spec.init.shape) != (B, F)
                                      or not spec.init.is_contiguous()):
            raise ValueError(f"init must be a contiguous {out.dtype} ({B}, {F})")
        for a in (spec.src, spec.init, out):
            if a is not None and a.device != kind.device:
                raise ValueError(f"every tensor must lie on {kind.device}")


def compact_rows(kind: torch.Tensor, fields: Sequence[FieldSpec],
                 off: Optional[torch.Tensor] = None) -> None:
    """Compact every field in place into its ``out`` (see the module
    docstring); one call covers all fields and counts as one launch of K2
    (its four kernels: keep masks, column scan, copy, tail and init)."""
    if not kind.is_cuda:
        return compact_rows_plain(kind, fields, off)
    _check_cuda(kind, fields, off)
    lib = build.library()
    T, B = kind.shape
    n = len(fields)
    ptrs = ctypes.c_void_p * n
    srcs = ptrs(*[s.src.data_ptr() if s.src is not None else None for s in fields])
    inits = ptrs(*[s.init.data_ptr() if s.init is not None else None for s in fields])
    outs = ptrs(*[s.out.data_ptr() for s in fields])
    longs = ctypes.c_long * n
    row_strides = longs(*[s.src.stride(0) if s.src is not None else 0 for s in fields])
    field_strides = longs(*[s.src.stride(1) if s.src is not None else 0 for s in fields])
    ints = ctypes.c_int * n
    widths = ints(*[s.out.shape[2] for s in fields])
    elems = ints(*[s.out.element_size() for s in fields])
    # per (row tile, chain) keep masks and first columns, and each chain's end
    words = lib.compact_rows_scratch(T, B, n, widths, elems)
    if words < 0:
        raise ValueError(f"compact_rows: no scratch size for T={T}, B={B}, {n} fields")
    scratch = torch.empty(words, dtype=torch.int32, device=kind.device)
    err = lib.compact_rows_launch(
        ctypes.c_void_p(kind.data_ptr()), ctypes.c_long(kind.stride(0)),
        ctypes.c_int(T), ctypes.c_int(B),
        ctypes.c_void_p(off.data_ptr() if off is not None else None),
        ctypes.c_int(fields[0].out.shape[1]), ctypes.c_int(n),
        srcs, row_strides, field_strides, widths, elems, inits, outs,
        ctypes.c_void_p(scratch.data_ptr()), ctypes.c_long(words),
        ctypes.c_void_p(torch.cuda.current_stream(kind.device).cuda_stream),
    )
    build.check(err, "compact_rows")
    build.LAUNCHES["compact_rows"] += 1


def _fill_sources(fill: RawFill):
    """Skeleton field -> ``(T, F, B)`` source view of a raw fill: a sticky
    fill's activity stream, or None for the all-true activity rows of a
    non-sticky fill."""
    return {
        "x": fill.x, "v": fill.v,
        "t": fill.fs[:, 0:1], "horizon": fill.fs[:, 1:2], "ar": fill.fs[:, 2:3],
        "is_active": fill.act,
        "rejected": fill.kind[:, 1:2], "errored_bound": fill.kind[:, 2:3],
        "hitting_horizon": fill.kind[:, 3:4],
        "error_value_ar": fill.ring, "kind": fill.kind[:, 0:1],
    }


def _row_layout(B: int, W: int, d: int, dtype) -> dict:
    """Field -> ``(shape, dtype)`` of ``(B, W)`` skeleton rows."""
    def f(*s):
        return (B, W) + s, dtype

    i32 = (B, W), torch.int32
    return dict(x=f(d), v=f(d), t=f(), horizon=f(), ar=f(),
                is_active=((B, W, d), torch.bool), rejected=i32, errored_bound=i32,
                hitting_horizon=i32, error_value_ar=f(5), kind=i32)


def empty_rows(B: int, W: int, d: int, dtype, device) -> Skeleton:
    """Uninitialized ``(B, W, ...)`` skeleton buffers (K2 writes every
    column of a compaction with ``off`` 0, or 1 plus an init record)."""
    return Skeleton(**{f: torch.empty(s, dtype=dt, device=device)
                       for f, (s, dt) in _row_layout(B, W, d, dtype).items()},
                    n_valid=torch.zeros((B,), dtype=torch.int32, device=device))


def packed_rows(B: int, W: int, d: int, dtype, device, flat=None):
    """``(flat, rows)``: ``empty_rows``'s fields as views into one byte
    buffer ``flat``, each at a 16-byte aligned offset, so that one copy moves
    them all; given ``flat`` (such a buffer's copy on another device), the
    same views into it."""
    spans, n = {}, 0
    for f, (s, dt) in _row_layout(B, W, d, dtype).items():
        nbytes = torch.Size(s).numel() * torch.empty((), dtype=dt).element_size()
        spans[f] = (n, nbytes, s, dt)
        n += -(-nbytes // 16) * 16
    if flat is None:
        flat = torch.empty(n, dtype=torch.uint8, device=device)
    rows = {f: flat[o:o + nb].view(dt).view(s) for f, (o, nb, s, dt) in spans.items()}
    return flat, Skeleton(**rows, n_valid=torch.zeros((B,), dtype=torch.int32,
                                                       device=flat.device))


def fill_specs(fill: RawFill, out: Skeleton, init: Optional[Event] = None):
    """``(kind, specs)``: K2's arguments for every ``Skeleton`` field of a
    raw fill compacted into ``out``."""
    B = fill.kind.shape[2]
    specs = []
    for name, src in _fill_sources(fill).items():
        o = getattr(out, name)
        o3 = o if o.dim() == 3 else o.unsqueeze(-1)
        ini = None
        if init is not None:
            ini = getattr(init, name).reshape(B, o3.shape[2]).to(o.dtype).contiguous()
        specs.append(FieldSpec(src, o3, ini))
    return fill.kind[:, 0], specs


def compact_fill(fill: RawFill, out: Skeleton, off: Optional[torch.Tensor] = None,
                 init: Optional[Event] = None) -> Skeleton:
    """K2 over every ``Skeleton`` field of a raw fill, into ``out`` in place
    (``out.n_valid`` is left to the caller)."""
    kind, specs = fill_specs(fill, out, init)
    compact_rows(kind, specs, off)
    return out

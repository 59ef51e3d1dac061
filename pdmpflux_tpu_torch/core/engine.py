"""Skeleton assembly around the stream fills (``pdmpflux_tpu/core/engine.py``).

For now the time-horizon pieces the JAX package runs in XLA outside any
kernel, here plain torch on the device:

* :func:`prepend_init_rows` (``engine.py:884-905``): the initial record in
  front of compacted event rows;
* :func:`finalize_horizon_rows` (``engine.py:908-982``): overshoot rows
  dropped, the exact ``t = T`` terminal point, the tail zeroed;
* :func:`grow_rows` (``engine.py:985-996``): zero columns for the
  accumulator between straggler fills.

The JAX ``finalize_horizon_rows(flow, rows, init_ev, counts, T)`` prepends
the initial record itself; here it takes the skeleton that already holds it
in column 0 (``prepend_init_rows(rows, init_ev, counts, W)``), because the
time-horizon driver has K2 write that record while it compacts the first
fill, which spares a copy of the whole accumulator.
"""

from __future__ import annotations

from typing import Optional

import torch

from .types import EV_TERMINAL, Event, Skeleton


def _fields(skel: Skeleton):
    return [(f, getattr(skel, f)) for f in Skeleton._fields if f != "n_valid"]


def prepend_init_rows(rows: Skeleton, init_ev: Event, counts: torch.Tensor,
                      n_keep: int) -> Skeleton:
    """The batched initial record in column 0, then the ``(B, W)`` event
    rows; ``n_valid`` is the initial record plus ``min(counts, n_keep)``."""
    out = {f: torch.cat([getattr(init_ev, f)[:, None].to(a.dtype), a], dim=1)
           for f, a in _fields(rows)}
    return Skeleton(**out, n_valid=(1 + torch.clamp_max(counts, n_keep)).to(torch.int32))


def finalize_horizon_rows(flow, skel: Skeleton, T: float,
                          out_width: Optional[int] = None) -> Skeleton:
    """The time-horizon skeleton of a batch (``sample.jl:384-420``): keep each
    chain's prefix of rows with ``t <= T``, flow its last kept row (velocity
    zeroed on inactive coordinates) by ``T - t_last`` with ``flow`` on
    ``(B, d)`` rows and ``(B, 1)`` times, and write it as the terminal row
    (``t = T``, ``kind = EV_TERMINAL``, its horizon and activity carried,
    ``ar``, counters and error ring 0) when ``T > 0``; zero every column past
    ``n_valid``.

    ``skel`` holds the initial record in column 0 and ``n_valid`` rows per
    chain.  The result has ``W + 1`` columns, or ``out_width`` when given (the
    caller's bound on ``n_valid``, which trims in the same pass)."""
    t = skel.t
    B, W1 = t.shape
    dev = t.device
    Tv = torch.tensor(T, dtype=t.dtype, device=dev)
    col = torch.arange(W1, device=dev)[None, :]
    keep = (col < skel.n_valid[:, None]) & (t <= Tv)
    kcount = keep.sum(dim=1)                    # a prefix: t is monotone
    last = kcount - 1                           # >= 0: the init record has t = 0
    rows = torch.arange(B, device=dev)

    x_l, act_l = skel.x[rows, last], skel.is_active[rows, last]
    v_l = torch.where(act_l, skel.v[rows, last], torch.zeros((), dtype=x_l.dtype, device=dev))
    xT, vT = flow(x_l, v_l, (Tv - t[rows, last])[:, None].to(x_l.dtype))
    term = {"x": xT, "v": vT, "t": Tv, "horizon": skel.horizon[rows, last],
            "is_active": act_l, "kind": EV_TERMINAL}   # every other field 0

    has_term = float(T) > 0.0
    n_valid = kcount + int(has_term)
    Wo = W1 + 1 if out_width is None else int(out_width)
    col2 = torch.arange(Wo, device=dev)[None, :]
    tail = col2 >= n_valid[:, None]
    out = {}
    for f, a in _fields(skel):
        if Wo <= W1:
            o = a[:, :Wo].clone()
        else:
            o = a.new_zeros((B, Wo) + a.shape[2:])
            o[:, :W1] = a
        if has_term:
            o[rows, kcount] = term[f] if f in term else 0
        out[f] = o.masked_fill_(tail.reshape(tail.shape + (1,) * (o.dim() - 2)), 0)
    return Skeleton(**out, n_valid=n_valid.to(torch.int32))


def grow_rows(rows: Skeleton, extra: int) -> Skeleton:
    """``rows`` widened by ``extra`` zero columns (the accumulator's growth
    between stream fills, ``Composites.jl:172-191``)."""
    out = {f: torch.cat([a, torch.zeros((a.shape[0], extra) + a.shape[2:], dtype=a.dtype,
                                        device=a.device)], dim=1)
           for f, a in _fields(rows)}
    return Skeleton(**out, n_valid=rows.n_valid)

"""The transition engine and the skeleton assembly around the stream fills
(``pdmpflux_tpu/core/engine.py``).

The engine is what the JAX package compiles with XLA outside any Pallas
kernel, here plain torch on the device:

* :func:`make_transition`: one transition of every chain of a batch (one
  envelope build and one thinning decision, or a horizon move, a stick or a
  thaw), all branches evaluated densely and selected per chain, written over
  the batch directly with tensors leading with ``B``; only the sampler's
  user functions go through ``torch.func``;
* :func:`make_stream_runner`: stream fills of those transitions in the
  chunk kernels' ``RawFill`` layout (rows, ..., B), so that K2
  (``ops/cuda/compact.compact_fill``), :func:`finalize_horizon_rows` and the
  streaming fold take them unchanged.  It covers every sampler, RHMC and the
  scalar-bound Zig-Zag family included, which no chunk kernel does.

And the time-horizon pieces:

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

from collections import Counter
from typing import NamedTuple, Optional

import torch

from ..ops.flows import div_once
from . import bounds, rng
from .dims import LOCAL
from .types import (
    ERROR_RING_SIZE,
    EV_JUMP,
    EV_NONE,
    EV_STICK,
    EV_TERMINAL,
    EV_THAW,
    MODE_ERRONEOUS,
    MODE_FRESH,
    MODE_REJECTED,
    Event,
    PDMPState,
    RawFill,
    Skeleton,
    StreamResult,
    empty_fill,
    kahan_add,
)

HORIZON_GROW = 1.01    # move_to_horizon!  (SamplingLoopInplace.jl:98)
HORIZON_SHRINK = 1.04  # if_reject!        (SamplingLoopInplace.jl:194)
CHUNK = 64
"""Transitions per chunk of a stream fill, fixed as the JAX package's stream
engine runs them; the runner reads the device once per chunk."""

COUNTS = Counter()
"""``chunks`` and ``transitions`` (batched transitions) the engine ran
since the last :func:`reset_counts`."""

CHUNK_EVENTS: Optional[list] = None
"""Set to a list to time the engine on the card: each chunk of a CUDA fill
then appends its ``(start, end)`` CUDA events, recorded on the current
stream around the chunk's transitions."""


def reset_counts() -> None:
    COUNTS.clear()


class RunResult(NamedTuple):
    """A fixed-event run (``parallel/sharded.sample_skeleton_gspmd``)."""
    state: PDMPState            # batched final state, frozen at each chain's last event
    skeleton: Skeleton          # batched event buffers, n_events wide
    transitions: torch.Tensor   # () int32 transitions executed, whole chunks


def _col(pred: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A per-chain ``(B,)`` predicate with unit axes up to ``like``'s rank."""
    return pred.reshape(pred.shape + (1,) * (like.dim() - pred.dim()))


def tree_select(pred: torch.Tensor, on_true, on_false):
    """Fieldwise ``where`` of two batched named tuples on a per-chain
    predicate (the engine freezes finished chains with it)."""
    return type(on_true)(*(torch.where(_col(pred, a), a, b)
                           for a, b in zip(on_true, on_false)))


def make_transition(sampler, dims=LOCAL):
    """The batched transition of ``sampler``: ``transition(state, t_max=None)
    -> (state', event)`` for a ``(B, ...)`` state.  ``t_max`` is a host bound
    on the flow times, for a flow whose cost depends on them
    (``sampler.flow_takes_bound``); it is at least ``max(horizon,
    bound_h)`` over the batch.

    ``dims`` (``core/dims.py``) is the coordinate group: every coordinate by
    default, or this process's slice of them, when ``x``, ``v`` and
    ``is_active`` of the state hold that slice and every reduction over
    coordinates (the envelope, the rates, the sticky hit and thaw, the
    jumps, the flows that couple coordinates) combines the slices of the
    group (``parallel/sharded.sample_skeleton_gspmd``).

    Mode bookkeeping as in the JAX package: ``FRESH`` proposals grow the
    horizon by 1.01 at a horizon move, ``REJECTED`` proposals carry the
    cumulative Exp draw, ``ERRONEOUS`` proposals (after ``ar > 1``, on a
    half-horizon envelope) reset without flowing; events commit time with
    Kahan compensation, and the counters and the error ring reset after
    each event."""
    sampler = sampler.on_dims(dims)
    sticky = sampler.sticky
    adaptive = sampler.adaptive
    flow, rate_fn = sampler.flow, sampler.rate
    bound_fn, jump_fn = sampler.bound_box, sampler.velocity_jump

    def transition(state: PDMPState, t_max: Optional[float] = None):
        B = state.x.shape[0]
        dt, dev = state.x.dtype, state.x.device
        zero = torch.zeros((), dtype=dt, device=dev)
        inf = torch.full((), float("inf"), dtype=dt, device=dev)
        rows = torch.arange(B, device=dev)
        keys = rng.split(state.key, 6)
        key, k_jump, k_thaw = keys[:, 0], keys[:, 3], keys[:, 5]
        # the scalar draws of k_exp, k_u and k_tt (split slots 1, 2, 4) in
        # one Threefry pass; each is jax.random.uniform of its own key
        u3 = rng.key_uniform(keys[:, [1, 2, 4]], dt)
        e_draw, u_thin = -torch.log1p(-u3[:, 0]), u3[:, 1]
        fkw = {"t_max": t_max} if sampler.flow_takes_bound else {}

        va = torch.where(state.is_active, state.v, zero)

        # proposal: rebuild the envelope, invert it at the cumulative draw
        box = bound_fn(state.x, va, state.bound_h)
        tp, lam_bar = bounds.next_event(box, state.exp_rv)
        fresh = state.mode == MODE_FRESH
        erroneous = state.mode == MODE_ERRONEOUS

        # thinning at tp; the raw ratio keeps the reference's inf / nan
        # semantics (ar > 1 is erroneous; u < nan rejects)
        tp_safe = torch.where(torch.isfinite(tp), tp, zero)
        ar_new = rate_fn(state.x, va, tp_safe) / lam_bar
        min_pt = torch.minimum(tp, state.tt)

        if sticky:  # the axis-crossing check of a fresh proposal
            event_time = torch.minimum(min_pt, state.horizon)
            x_probe, _ = flow(state.x, va, event_time[:, None])
            any_crossing = dims.any(state.x * x_probe < 0)
            v_safe = torch.where(va == 0, torch.ones_like(va), va)
            tj = torch.where(state.is_active & (state.x * state.v < 0) & (va != 0),
                             -state.x / v_safe, inf)
            t_togo, i_stick = dims.min_argmin(tj)
            crossed = fresh & any_crossing & torch.isfinite(t_togo)
        else:
            crossed = torch.zeros((B,), dtype=torch.bool, device=dev)
            t_togo = torch.zeros((B,), dtype=dt, device=dev)

        # branch predicates (mutually exclusive, exhaustive)
        beyond = min_pt > state.horizon
        p_stick = crossed
        p_moveh = ~crossed & beyond & ~erroneous
        p_erreset = ~crossed & beyond & erroneous
        thin = ~crossed & ~beyond
        if sticky:
            p_thaw = thin & (state.tt <= tp)
            p_ac = thin & (tp < state.tt)
        else:
            p_thaw = torch.zeros_like(thin)
            p_ac = thin
        p_err = p_ac & (ar_new > 1.0)
        p_proxy = p_ac & ~p_err
        acc_draw = u_thin < ar_new
        p_acc = p_proxy & acc_draw
        p_rej = p_proxy & ~acc_draw

        # one flow at the branch's time
        flow_time = torch.where(p_stick, t_togo, torch.where(
            p_moveh, state.horizon, torch.where(
                p_thaw, state.tt, torch.where(p_acc, tp_safe, zero))))
        x_f, v_f = flow(state.x, va, flow_time[:, None], **fkw)
        does_flow = (p_stick | p_moveh | p_thaw | p_acc)[:, None]
        x_new = torch.where(does_flow, x_f, state.x)
        # with frozen coordinates the flowed (masked) velocity must not
        # overwrite the latent full one (SamplingLoopInplace.jl:89-94)
        v_flowed = torch.where(dims.all(state.is_active)[:, None], v_f, state.v)
        v_after = torch.where(does_flow, v_flowed, state.v)
        v_new = torch.where(p_acc[:, None],
                            jump_fn(x_new, v_after, k_jump, state.is_active), v_after)

        if sticky:
            kappa = sampler.kappa.to(dtype=dt, device=dev)
            act_stick = dims.put(state.is_active, i_stick, False, rows)
            logits = torch.where(state.is_active, -inf, torch.log(kappa))
            act_thaw = dims.put(state.is_active, rng.categorical(k_thaw, logits, dims), True,
                                rows)
            is_active_new = torch.where(p_stick[:, None], act_stick, torch.where(
                p_thaw[:, None], act_thaw, state.is_active))
        else:
            is_active_new = state.is_active

        # time commitment (Kahan-compensated)
        inc = torch.where(p_stick, t_togo, torch.where(p_thaw, state.tt, tp_safe)) + state.ts
        t_k, tc_k = kahan_add(state.t, state.t_comp, inc)
        is_event = p_acc | p_stick | p_thaw
        t_new = torch.where(is_event, t_k, state.t)
        tc_new = torch.where(is_event, tc_k, state.t_comp)
        ts_new = torch.where(is_event, zero, torch.where(
            p_moveh, state.ts + state.horizon, state.ts))

        h = state.horizon
        if adaptive:
            h = torch.where(p_moveh & fresh, h * HORIZON_GROW, h)
            h = torch.where(p_err, h * 0.5, h)
            h = torch.where(p_rej, div_once(h, HORIZON_SHRINK), h)

        one = torch.ones((), dtype=torch.int32, device=dev)
        izero = torch.zeros((), dtype=torch.int32, device=dev)
        hitting = state.hitting_horizon + torch.where(p_moveh, one, izero)
        rejected = state.rejected + torch.where(p_rej, one, izero)
        errored = state.errored_bound + torch.where(p_err, one, izero)
        ring_err = state.error_value_ar.clone()
        ring_err[rows, (errored % ERROR_RING_SIZE).long()] = ar_new
        ring = torch.where(p_err[:, None], ring_err, state.error_value_ar)

        # proposal bookkeeping
        reset = p_stick | p_moveh | p_erreset | p_thaw | p_acc
        exp_new = torch.where(reset | p_err, e_draw, torch.where(
            p_rej, state.exp_rv + e_draw, state.exp_rv))
        mode_new = torch.where(reset, MODE_FRESH, torch.where(
            p_err, MODE_ERRONEOUS, torch.where(p_rej, MODE_REJECTED, state.mode))).to(torch.int32)
        bound_h_new = torch.where(reset, h, torch.where(
            p_err, state.horizon * 0.5, state.bound_h))
        if sticky:  # the thaw clock Exp(1) / sum(kappa[frozen])
            rate_thaw = dims.sum(torch.where(is_active_new, zero, kappa))
            pos = rate_thaw > 0
            tt_fresh = torch.where(pos, -torch.log1p(-u3[:, 2]) / torch.where(
                pos, rate_thaw, torch.ones_like(rate_thaw)), inf)
            tt_new = torch.where(reset, tt_fresh, state.tt)
        else:
            tt_new = torch.where(reset, inf, state.tt)
        ar_state = torch.where(p_ac, ar_new, state.ar)

        kind = torch.where(p_acc, EV_JUMP, torch.where(
            p_stick, EV_STICK, torch.where(p_thaw, EV_THAW, EV_NONE))).to(torch.int32)
        # rows carry the trajectory time t + ts: the event time at events,
        # the advanced position's time after horizon moves
        event = Event(kind=kind, x=x_new, v=v_new, t=t_new + ts_new, horizon=h,
                      ar=ar_state, is_active=is_active_new, rejected=rejected,
                      errored_bound=errored, hitting_horizon=hitting,
                      error_value_ar=ring)
        # the counters and the ring restart after each event (:28-31)
        new_state = PDMPState(
            x=x_new, v=v_new, t=t_new, t_comp=tc_new, ts=ts_new, horizon=h,
            bound_h=bound_h_new, exp_rv=exp_new, tt=tt_new, mode=mode_new,
            ar=ar_state, is_active=is_active_new,
            rejected=torch.where(is_event, izero, rejected),
            errored_bound=torch.where(is_event, izero, errored),
            hitting_horizon=torch.where(is_event, izero, hitting),
            error_value_ar=torch.where(is_event[:, None], zero, ring),
            key=key,
        )
        return new_state, event

    return transition


def _write_row(fill: RawFill, r: int, ev: Event) -> None:
    """Event records ``(B, ...)`` into row ``r`` of a raw fill, chains minor."""
    fill.kind[r] = torch.stack([ev.kind, ev.rejected, ev.errored_bound, ev.hitting_horizon])
    fill.x[r] = ev.x.T
    fill.v[r] = ev.v.T
    fill.fs[r] = torch.stack([ev.t, ev.horizon, ev.ar])
    fill.ring[r] = ev.error_value_ar.T
    if fill.act is not None:
        fill.act[r] = ev.is_active.T


def make_stream_runner(sampler, t_cap: int, n_events_target: int, mode: str = "events",
                       dims=LOCAL):
    """``run(state, counts, t_target=None) -> StreamResult``: one stream fill
    of at most ``t_cap`` transition rows from the engine, with the contract of
    ``ops/cuda/driver.make_stream_runner``.

    A chain is live while its count is below ``n_events_target``
    (``mode="events"``) or while its committed clock is below ``t_target``
    compared in the state's dtype (``mode="horizon"``, as the JAX engine
    compares it); a finished chain keeps its state and writes rows of kind 0
    (the rows of its would-be transition, as the JAX engine writes them).
    Chunks of :data:`CHUNK` transitions run until no chain is live or the
    fill is full; the runner reads the device once per chunk (the live test,
    and the flow bound of a ``flow_takes_bound`` sampler) and never inside
    one.  ``dims``: the coordinate group of :func:`make_transition`."""
    if t_cap <= 0 or t_cap % CHUNK:
        raise ValueError(
            f"t_cap={t_cap}: the transition engine fills in chunks of {CHUNK} "
            f"transitions, so its t_cap must be a positive multiple of {CHUNK}"
        )
    if mode not in ("events", "horizon"):
        raise ValueError(f"mode must be 'events' or 'horizon', not {mode!r}")
    transition = make_transition(sampler, dims)
    n_chunks = t_cap // CHUNK
    bounded = sampler.flow_takes_bound
    growth = HORIZON_GROW ** CHUNK if sampler.adaptive else 1.0

    def run(state: PDMPState, counts: torch.Tensor, t_target=None) -> StreamResult:
        B, d = state.x.shape
        dt, dev = state.x.dtype, state.x.device
        fill = empty_fill(t_cap, d, B, dt, dev, sampler.sticky)
        if mode == "horizon":
            target = torch.tensor(float(t_target), dtype=dt, device=dev)

        def live_of(state, counts):
            return state.t < target if mode == "horizon" else counts < n_events_target

        it = 0
        while it < n_chunks:
            probe = live_of(state, counts).any().to(dt)[None]
            if bounded:
                probe = torch.cat([probe, torch.maximum(state.horizon, state.bound_h).max()[None]])
            probe = probe.cpu()
            if not bool(probe[0]):
                break
            t_max = float(probe[1]) * growth if bounded else None
            timed = CHUNK_EVENTS is not None and dev.type == "cuda"
            if timed:
                span = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                span[0].record()
            for k in range(CHUNK):
                live = live_of(state, counts)
                ns, ev = transition(state, t_max)
                state = tree_select(live, ns, state)
                kind = torch.where(live, ev.kind, torch.zeros_like(ev.kind))
                counts = counts + (kind > 0).to(counts.dtype)
                _write_row(fill, it * CHUNK + k, ev._replace(kind=kind))
            if timed:
                span[1].record()
                CHUNK_EVENTS.append(span)
            COUNTS["chunks"] += 1
            COUNTS["transitions"] += CHUNK
            it += 1
        rows = it * CHUNK
        return StreamResult(state, fill.head(rows), counts, rows)

    return run


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

"""Core data structures of the PyTorch port.

Counterpart of ``pdmpflux_tpu/core/types.py``: the same transition-machine
modes, event kinds, thinning envelope and record layouts, as ``NamedTuple``s
of tensors.  A chain batch adds a leading axis to every field.

``PDMPState.key`` holds JAX's raw Threefry key data (``uint32[2]`` per chain,
``jax.random.key_data``) in an ``int64`` tensor, because PyTorch has no
``uint32`` arithmetic on the CPU; values stay in ``[0, 2**32)``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

MODE_FRESH = 0      # current (bound_h, exp_rv) form a fresh outer proposal
MODE_REJECTED = 1   # exp_rv is cumulative after >=1 thinning rejection
MODE_ERRONEOUS = 2  # proposal comes from a half-horizon rebuild after ar > 1

EV_NONE = 0      # transition produced no event
EV_INIT = 1      # initial state
EV_JUMP = 2      # accepted thinning event (velocity jump applied)
EV_STICK = 3     # sticky sampler froze a coordinate at an axis
EV_THAW = 4      # sticky sampler released a frozen coordinate
EV_TERMINAL = 5  # synthesized exact-t=T point (time-horizon sampling)

ERROR_RING_SIZE = 5  # ring buffer of recent erroneous acceptance ratios


class BoundBox(NamedTuple):
    """Piecewise-constant upper bound of the event rate on ``[0, horizon]``
    for a chain batch: ``grid`` ``(B, n)`` time points from 0, ``box_max``
    ``(B, n - 1)`` per-segment envelope values, ``cum_sum`` ``(B, n)`` the
    integrated envelope from 0, ``step_size`` ``(B,)`` the grid spacing."""

    grid: torch.Tensor
    box_max: torch.Tensor
    cum_sum: torch.Tensor
    step_size: torch.Tensor


class PDMPState(NamedTuple):
    """Per-chain evolving state (see the JAX package for field meanings)."""

    x: torch.Tensor            # (d,) position
    v: torch.Tensor            # (d,) velocity
    t: torch.Tensor            # () committed event-clock time
    t_comp: torch.Tensor       # () Kahan compensation term for t
    ts: torch.Tensor           # () time flowed since the last committed event
    horizon: torch.Tensor      # () adaptive thinning horizon
    bound_h: torch.Tensor      # () horizon the current proposal's envelope covers
    exp_rv: torch.Tensor       # () cumulative Exp(1) draw of the current proposal
    tt: torch.Tensor           # () time-to-thaw clock (+inf if not sticky)
    mode: torch.Tensor         # () int32 MODE_*
    ar: torch.Tensor           # () last acceptance ratio
    is_active: torch.Tensor    # (d,) bool activity mask
    rejected: torch.Tensor     # () int32 rejections since last event
    errored_bound: torch.Tensor    # () int32 bound violations since last event
    hitting_horizon: torch.Tensor  # () int32 horizon hits since last event
    error_value_ar: torch.Tensor   # (ERROR_RING_SIZE,) ring of erroneous ars
    key: torch.Tensor          # (2,) int64 Threefry key words


class Event(NamedTuple):
    """Snapshot emitted by one transition; ``kind == EV_NONE`` means none."""

    kind: torch.Tensor
    x: torch.Tensor
    v: torch.Tensor
    t: torch.Tensor
    horizon: torch.Tensor
    ar: torch.Tensor
    is_active: torch.Tensor
    rejected: torch.Tensor
    errored_bound: torch.Tensor
    hitting_horizon: torch.Tensor
    error_value_ar: torch.Tensor


class Skeleton(NamedTuple):
    """Struct-of-arrays event history, ``(B, N, ...)`` for a chain batch;
    ``n_valid`` counts the filled columns of each chain."""

    x: torch.Tensor                # (N, d)
    v: torch.Tensor                # (N, d)
    t: torch.Tensor                # (N,)
    horizon: torch.Tensor          # (N,)
    ar: torch.Tensor               # (N,)
    is_active: torch.Tensor        # (N, d) bool
    rejected: torch.Tensor         # (N,) int32
    errored_bound: torch.Tensor    # (N,) int32
    hitting_horizon: torch.Tensor  # (N,) int32
    error_value_ar: torch.Tensor   # (N, ERROR_RING_SIZE)
    kind: torch.Tensor             # (N,) int32 EV_*
    n_valid: torch.Tensor          # () int32, or (B,) for a batch


def kahan_add(total, comp, increment):
    """One step of Kahan compensated summation: returns new (total, comp)."""
    y = increment - comp
    s = total + y
    comp = (s - total) - y
    return s, comp


def event_from_state(state: PDMPState, kind) -> Event:
    """An event record snapshotting ``state`` (batched or not)."""
    kind_t = torch.full(state.t.shape, int(kind), dtype=torch.int32,
                        device=state.t.device)
    return Event(
        kind=kind_t, x=state.x, v=state.v, t=state.t,
        horizon=state.horizon, ar=state.ar, is_active=state.is_active,
        rejected=state.rejected, errored_bound=state.errored_bound,
        hitting_horizon=state.hitting_horizon,
        error_value_ar=state.error_value_ar,
    )


def empty_skeleton(n_events: int, dim: int, dtype, batch_shape=(),
                   device="cpu") -> Skeleton:
    """Zero-filled event buffers of ``n_events`` columns."""
    def f(*s):
        return torch.zeros(tuple(batch_shape) + s, dtype=dtype, device=device)

    def i(*s):
        return torch.zeros(tuple(batch_shape) + s, dtype=torch.int32,
                           device=device)

    return Skeleton(
        x=f(n_events, dim), v=f(n_events, dim), t=f(n_events),
        horizon=f(n_events), ar=f(n_events),
        is_active=torch.zeros(tuple(batch_shape) + (n_events, dim),
                              dtype=torch.bool, device=device),
        rejected=i(n_events), errored_bound=i(n_events),
        hitting_horizon=i(n_events), error_value_ar=f(n_events, ERROR_RING_SIZE),
        kind=i(n_events), n_valid=i(),
    )


class RawFill(NamedTuple):
    """``T`` raw transition rows of a stream fill, chains minor: ``kind``
    ``(T, 4, B)`` int32 ``[kind, rejected, errored, hitting]``, ``x``/``v``
    ``(T, d, B)``, ``fs`` ``(T, 3, B)`` ``[t + ts, horizon, ar]``, ``ring``
    ``(T, 5, B)`` and ``act`` ``(T, d, B)`` bool, None for a non-sticky fill
    (every row all active).  The chunk kernels and the transition engine
    both write it; K2 and the streaming fold read it."""

    kind: torch.Tensor
    x: torch.Tensor
    v: torch.Tensor
    fs: torch.Tensor
    ring: torch.Tensor
    act: Optional[torch.Tensor] = None

    @property
    def rows(self) -> int:
        return self.kind.shape[0]

    def head(self, rows: int) -> "RawFill":
        return RawFill(*(None if a is None else a[:rows] for a in self))


def empty_fill(T: int, d: int, B: int, dtype, device, sticky: bool = False) -> RawFill:
    """Uninitialized fill buffers: every row a chunk covers is written."""
    def f(*s):
        return torch.empty(s, dtype=dtype, device=device)

    return RawFill(
        kind=torch.empty((T, 4, B), dtype=torch.int32, device=device),
        x=f(T, d, B), v=f(T, d, B), fs=f(T, 3, B),
        ring=f(T, ERROR_RING_SIZE, B),
        act=(torch.empty((T, d, B), dtype=torch.bool, device=device)
             if sticky else None),
    )


class StreamResult(NamedTuple):
    """One stream fill, from a chunk kernel's driver or the engine."""

    state: PDMPState       # batched final state
    fill: RawFill          # the rows written, (rows, ..., B) chains minor
    counts: torch.Tensor   # (B,) int32 events recorded per chain
    transitions: int       # transitions executed (rows written)

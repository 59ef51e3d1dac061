"""Driver API (``pdmpflux_tpu/api.py``).

* ``sample_skeleton(sampler, n_sk, ...)``: fixed-event-count skeleton of a
  chain batch, through stream fills of the sampler's chunk kernel (K1 for a
  Zig-Zag, K6 for a Sticky Zig-Zag, whose fills also carry the activity
  stream, K4 for a Speed-Up Zig-Zag, K3 for BPS and the Boomerang, K5 for
  Forward ECMC) or of the transition engine (``core/engine.py``: RHMC, the
  scalar-bound Zig-Zag family, and whatever ``backend`` sends there), and
  compaction by K2; ``sample_skeleton(sampler, T, ...)`` with a float ``T``: the
  time-horizon skeleton, the same fills in horizon mode (K7 on the kernels)
  and an exact terminal point at ``t = T`` (``core/engine.finalize_horizon_rows``);
* ``sample_from_skeleton``: skeleton -> equal-time samples (N, dt, N + dt);
* ``sample``: the two chained;
* ``sample_skeleton_with_diagnostic``: the time-horizon skeleton and the
  realized volatility of ``U`` along it.

``sample_skeleton(..., checkpoint_path=...)`` saves the run every
``checkpoint_every`` fills and resumes from the file (``api.py:236-266``
of the JAX package, the same file layout and manifest).

Every function takes ``device`` (default ``"cuda"``).  On CUDA the fill and
the compaction run the hand-written kernels; on the CPU the same driver runs
their plain PyTorch versions, which is the port's reference path.  Asking for
CUDA without a card raises.  ``backend`` picks the fill (:func:`pick_backend`,
the JAX package's four values): ``"auto"`` takes the chunk kernel wherever one
covers the sampler and the shape, else the engine; ``"xla"`` and
``"xla_stream"`` always take the engine; ``"pallas"`` takes the kernel or
raises.
"""

from __future__ import annotations

import gc
import math
import os
import time
import warnings
from collections import Counter
from typing import NamedTuple, Optional

import numpy as np
import torch

from .core import engine
from .core.device import resolve_device
from .core.engine import finalize_horizon_rows, grow_rows, prepend_init_rows
from .core.types import EV_INIT, Event, PDMPState, Skeleton, empty_skeleton, event_from_state
from .diagnostics import boundary_u, linspace0
from .ops.cuda import compact as k2
from .ops.cuda import driver as k1_driver
from .ops.cuda import lower
from .ops.cuda import scalar_chunk as k3
from .ops.cuda import zigzag_chunk as k1
from .ops.flows import div_once
from .parallel import checkpoint as _ckpt

DEFAULT_MAX_TRANSITIONS_PER_EVENT = 256
_DEVICE_BYTES_FALLBACK = 8 << 30


def _row_bytes(d: int, dtype) -> int:
    """Bytes of one chain's skeleton row: the floats, the int32 fields and
    the activity bytes."""
    return (2 * d + 20) * torch.empty((), dtype=dtype).element_size() + d


def _device_bytes_budget(dev: torch.device) -> int:
    """Usable bytes for a fill plus the accumulator: 60% of the card's free
    memory (``PDMPFLUX_DEVICE_BYTES`` overrides; 8 GiB on the CPU)."""
    env = os.environ.get("PDMPFLUX_DEVICE_BYTES", "")
    if env:
        return int(env)
    if dev.type == "cuda":
        free, _ = torch.cuda.mem_get_info(dev)
        return int(free * 0.6)
    return int(_DEVICE_BYTES_FALLBACK * 0.6)


def _update_fill_ratio(sampler, target, transitions):
    """Remember the events-per-transition ratio for fill sizing (5%
    hysteresis, as in the JAX package)."""
    new = min(1.0, target / max(int(transitions), 1))
    old = getattr(sampler, "_fill_ratio", None)
    if old is None or abs(new - old) > 0.05 * old:
        sampler._fill_ratio = new


def _prep_init(sampler, xinit, vinit):
    """Normalize initial conditions to a (B, d) batch; validate like
    ``sample.jl:287-311`` (finite values, matching dims)."""
    x = np.asarray(xinit, float)
    v = np.asarray(vinit, float)
    if x.ndim == 0:
        x = x[None]
    if v.ndim == 0:
        v = v[None]
    squeeze = x.ndim == 1
    if x.ndim == 1:
        x, v = x[None, :], v[None, :]
    if x.shape != v.shape or x.shape[-1] != sampler.dim:
        raise ValueError(
            f"xinit and vinit must have the same dimension as pdmp.dim "
            f"({sampler.dim}). Current shapes: xinit {x.shape}, vinit {v.shape}"
        )
    if not (np.all(np.isfinite(x)) and np.all(np.isfinite(v))):
        raise ValueError("initial values contain NaN, Inf, or -Inf.")
    return x, v, squeeze


def _squeeze_skeleton(skel: Skeleton) -> Skeleton:
    return Skeleton(*(a[0] for a in skel))


def _save_stream_checkpoint(path, mode, target, state, acc, counts_np, fills):
    """Atomic checkpoint of a stream-loop run: the state, the event
    accumulator (the counts ride in the skeleton's ``n_valid`` slot) and a
    manifest naming the run (JAX ``api.py:371-382``)."""
    acc_save = acc._replace(n_valid=torch.as_tensor(np.asarray(counts_np), dtype=torch.int32))
    _ckpt.save_checkpoint(path, state, acc_save,
                          meta={"mode": mode, "target": target, "fills": int(fills)})


def _load_stream_checkpoint(path, mode, target, device, acc_device=None):
    """Load and validate a stream-loop checkpoint; ``(state, acc, counts,
    fills)``, the state on ``device`` and the accumulator on ``acc_device``
    (default ``device``; the host path keeps it on the CPU), or None when
    there is no file.  A file for another run (mode or target) raises
    instead of sampling the wrong thing."""
    if not os.path.exists(path):
        return None
    state, acc, meta = _ckpt.load_checkpoint(path, device, acc_device)
    if meta.get("mode") != mode or meta.get("target") != target:
        raise ValueError(
            f"checkpoint at {path} is for mode={meta.get('mode')!r} "
            f"target={meta.get('target')!r}, not this run's mode={mode!r} "
            f"target={target!r}; delete it to start fresh."
        )
    counts = acc.n_valid.cpu().numpy().astype(np.int64)
    return state, acc, counts, int(meta.get("fills", 0))


def _fail_after_fills(fill_no: int):
    """Fault injection for checkpoint/resume rehearsals: raise after N fills
    when ``PDMPFLUX_FAIL_AFTER_FILLS=N`` is set."""
    n = os.environ.get("PDMPFLUX_FAIL_AFTER_FILLS", "")
    if n and fill_no >= int(n):
        raise RuntimeError(
            f"fault injection: PDMPFLUX_FAIL_AFTER_FILLS={n} reached"
        )


BACKENDS = ("auto", "xla", "xla_stream", "pallas")


def pick_backend(sampler, backend: str, d: int, dtype, device) -> str:
    """``"kernel"`` or ``"engine"``: which fill runs ``sampler`` at dimension
    ``d`` in ``dtype`` on ``device``, decided before any launch from the
    sampler's type and flags, the shape, dtype and device (the JAX package's
    ``_use_pallas`` and ``pick_launch``).

    * ``"xla"`` and ``"xla_stream"``: the engine;
    * ``"auto"``: the chunk kernel where ``kernel_kind`` covers the sampler
      and, on CUDA, the kernel takes the shape (``grid_size`` up to
      ``MAX_GRID``; ``d`` up to ``scalar_max_dim`` for K3/K5 and
      ``sticky_max_dim`` for K6, shared memory's limits, a generated
      potential's read from its own build; the plain versions
      on the CPU have none), else the engine;
    * ``"pallas"``: the kernel, or ``ValueError`` where none covers the
      sampler or the shape.

    On CUDA a covered sampler whose gradient carries no device potential
    (a gradient of the user's own) is lowered into a generated potential
    (``ops/cuda/lower.py``) and takes the kernel where the kernel holds its
    context: a product with a constant matrix whose input is affine in the
    point (a dense quadratic form's ``P x``, ``A (x - mu)``, a regression's
    ``X b``) is formed once per transition on K1 and K3/K5 and kept beside
    the chain's state, so it takes the kernel at any ``d`` their shared
    memory (K3/K5: ``scalar_max_dim`` read from the potential's own build)
    or scratch (K1: none) holds; a context formed at each point (K4's
    products, a product after a nonlinearity such as ``A tanh(x)``, a sum
    past degree 2) must fit what the kernel keeps there (K6's shared memory,
    read from its build; ``lower.LANE_BYTES`` a lane of the others), else
    the engine under ``"auto"``, ``ValueError`` under ``"pallas"``.  Reads of
    neighbours at fixed offsets (``x[1:] - x[:-1]``, a band) and of any fixed
    coordinate (``x[k]``) take the kernel like any other read, and so do
    running sums, flips and periodic shifts, and reads at a constant index
    array (``x[idx]``, a hierarchical model's ``alpha[county]``, an areal
    prior's ``phi[node1] - phi[node2]``) with their scatter-add backward,
    which each coordinate walks where it is read and which keeps no
    context.  A gradient the lowering cannot express (``cumprod``, one
    element of a matrix product, a gather of a stage's output, a 2-D index
    array, a slice of a data vector's rows, a value whose short axis is
    past ``lower.KMAX``) raises
    its ``LoweringError`` under ``"auto"`` and ``"pallas"``, naming
    ``backend="xla_stream"``.  A failed build or launch
    never picks the route: they raise where they happen."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not {backend!r}")
    if backend in ("xla", "xla_stream"):
        return "engine"
    kind = k1_driver.kernel_kind(sampler)
    if kind is None:
        if backend == "pallas":
            raise ValueError(
                "backend='pallas' covers ZigZag/StickyZigZag/SpeedUpZigZag "
                "(vectorized bounds), BPS, Boomerang and ForwardECMC; "
                f"{type(sampler).__name__} runs on backend='xla'"
            )
        return "engine"
    if torch.device(device).type != "cuda":
        return "kernel"
    scalar = kind in k3.KINDS
    n_grid = sampler.grid_size if sampler.grid_size >= 2 else k1_driver.PALLAS_CONST_GRID

    def too_large(limit) -> bool:  # past the kernel's grid or d: the engine
        if n_grid <= k1.MAX_GRID and (limit is None or d <= limit):
            return False
        if backend == "pallas":
            raise ValueError(
                f"backend='pallas': the {kind} chunk kernel takes grid_size up to "
                f"{k1.MAX_GRID} and d up to {limit or 'any'} in {dtype}; got grid_size="
                f"{sampler.grid_size}, d={d}; {type(sampler).__name__} runs on "
                "backend='xla_stream' here"
            )
        return True

    user = sampler.device_potential not in k1.KERNEL_POTENTIALS
    if too_large(None if user else k3.scalar_max_dim(dtype) if scalar else
                 k1.sticky_max_dim(dtype) if sampler.sticky else None):
        return "engine"
    if user:
        low = lower.lower_sampler(sampler, kind, d, dtype, device)  # raises LoweringError
        # K3/K5's and K6's shared memory hold the generated potential's own
        # context (its build reports the limit); a lane of the other kernels
        # keeps its per-point context in local memory
        if (scalar or sampler.sticky) and too_large(
                k3.scalar_max_dim(dtype, low) if scalar else k1.sticky_max_dim(dtype, low)):
            return "engine"
        if not lower.lane_fits(low):
            if backend == "pallas":
                raise ValueError(f"backend='pallas': {lower.lane_message(low)}")
            return "engine"
    return "kernel"


def fill_runner(sampler, route: str, t_cap: int, target: int, chunk: int, tile: int,
                mode: str = "events"):
    """The stream-fill runner of ``route`` (:func:`pick_backend`): the chunk
    kernels' driver in launches of ``chunk`` transitions, or the transition
    engine in its fixed chunks of ``engine.CHUNK`` transitions."""
    if route == "kernel":
        return k1_driver.make_stream_runner(sampler, t_cap, target, chunk=chunk,
                                            tile=tile, mode=mode)
    return engine.make_stream_runner(sampler, t_cap, target, mode=mode)


def fill_rows(sampler, target: int, B: int, d: int, dtype,
              dev: torch.device) -> int:
    """Rows of one stream fill: about 1.8 transitions per event on a cold
    sampler (1.08x the measured need once a run has finished), aligned,
    and capped so a fill plus the accumulator fit the memory budget."""
    budget_rows = int((_device_bytes_budget(dev) / max(B * _row_bytes(d, dtype), 1)
                       - (target + 1)) / 1.5)
    max_rows = max(64, budget_rows // 64 * 64)
    # the JAX package uses the ratio on the TPU only, where each new fill
    # size costs a compile; PyTorch runs eagerly, so every device uses it
    ratio = getattr(sampler, "_fill_ratio", None)
    margin = 1.8 if not ratio else min(1.8, max(1.08, 1.08 / ratio))
    align = 256 if target >= 256 else 64
    t_cap = min(int(-(-int(target * margin + 64) // align) * align), max_rows)
    return max(t_cap, 64)


def _force_host() -> bool:
    """``PDMPFLUX_STREAM_HOST_ACC=1`` forces host accumulation, as in JAX."""
    return os.environ.get("PDMPFLUX_STREAM_HOST_ACC", "") == "1"


HOST_ACC = Counter()
"""Host accumulation since the caller last cleared it: ``fills`` copied to
the host, their ``bytes``, and host seconds of the copies (``copy_s``) and
of the indexed writes that place the rows (``place_s``)."""


def _fetch_rows(fill, k: int) -> Skeleton:
    """A fill's event rows compacted by K2 on the fill's device into ``(B,
    k)`` rows at offset 0 (zero past each chain's events), in one buffer
    copied to the host in one transfer; the rows as views of the host copy.
    Compaction is a stable permutation, so this gives the rows JAX's host
    path compacts in numpy from the whole fill, and only event rows cross."""
    B, d = fill.kind.shape[2], fill.x.shape[1]
    dtype, dev = fill.x.dtype, fill.x.device
    flat, rows = k2.packed_rows(B, k, d, dtype, dev)
    k2.compact_fill(fill, rows)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)  # so that copy_s times the copy alone
    t0 = time.perf_counter()
    host = flat.cpu()
    HOST_ACC["copy_s"] += time.perf_counter() - t0
    HOST_ACC["bytes"] += flat.numel()
    HOST_ACC["fills"] += 1
    return k2.packed_rows(B, k, d, dtype, None, flat=host)[1]


class _HostRows:
    """A chain batch's skeleton in host memory (JAX's
    ``_stream_events_host_acc`` buffers and ``_BatchAccumulator``): per chain
    the initial record in column 0, then each fill's events behind the
    chain's earlier ones, placed with one indexed write per field.  The
    buffers start ``width`` columns wide and double when a fill needs more;
    ``cap`` bounds the columns a chain fills (the event-count target)."""

    def __init__(self, init_ev: Event, width: int, cap: Optional[int] = None):
        B, d = init_ev.x.shape
        skel = empty_skeleton(width, d, init_ev.x.dtype, (B,), "cpu")
        self.bufs = {f: getattr(skel, f) for f in Skeleton._fields[:-1]}
        for f, a in self.bufs.items():
            a[:, 0] = getattr(init_ev, f).cpu()
        self.filled = torch.ones(B, dtype=torch.int64)
        self.cap = cap

    def resume(self, acc: Skeleton, counts) -> None:
        """Continue from a checkpoint's accumulator (on the CPU)."""
        self.bufs = {f: getattr(acc, f) for f in Skeleton._fields[:-1]}
        self.filled = 1 + torch.as_tensor(counts, dtype=torch.int64)

    def _ensure(self, n_cols: int) -> None:
        have = self.bufs["t"].shape[1]
        if n_cols <= have:
            return
        new = max(n_cols, 2 * have)
        for f, a in self.bufs.items():
            self.bufs[f] = torch.cat([a, a.new_zeros((a.shape[0], new - have) + a.shape[2:])],
                                     dim=1)

    def add(self, fill, n) -> None:
        """Append a fill whose chains recorded ``n`` (host, ``(B,)``) events."""
        n = torch.as_tensor(n, dtype=torch.int64)
        if self.cap is not None:
            n = torch.minimum(n, self.cap - self.filled)
        rows = _fetch_rows(fill, max(1, int(n.max())))
        t0 = time.perf_counter()
        self._ensure(int((self.filled + n).max()))
        B, k = rows.t.shape
        W = self.bufs["t"].shape[1]
        bi, ji = torch.nonzero(torch.arange(k)[None, :] < n[:, None], as_tuple=True)
        src, dst = bi * k + ji, bi * W + self.filled[bi] + ji
        for f, buf in self.bufs.items():
            buf.view(B * W, -1).index_copy_(
                0, dst, getattr(rows, f).reshape(B * k, -1).index_select(0, src))
        self.filled += n
        HOST_ACC["place_s"] += time.perf_counter() - t0

    def skeleton(self) -> Skeleton:
        return Skeleton(**self.bufs, n_valid=self.filled.to(torch.int32))


def _with_host_retry(run, host: bool, message: str):
    """``run(host)``.  A CUDA out-of-memory error on the device path drops
    the failed attempt (its frames and tensors, then the allocator's cache),
    warns with JAX's text and runs again with host accumulation; no other
    error is caught."""
    if host:
        return run(True)
    try:
        return run(False)
    except torch.cuda.OutOfMemoryError:
        pass
    gc.collect()
    torch.cuda.empty_cache()
    warnings.warn(message)
    return run(True)


def sample_skeleton(sampler, n_or_T, xinit, vinit, *, seed=None,
                    verbose: bool = False, dtype=None, device="cuda",
                    max_transitions_per_event: int = DEFAULT_MAX_TRANSITIONS_PER_EVENT,
                    t_cap: Optional[int] = None, chunk: int = 32,
                    tile: int = 128, init_capacity: int = 1024,
                    checkpoint_path: Optional[str] = None,
                    checkpoint_every: int = 4, backend: str = "auto") -> Skeleton:
    """Generate a PDMP skeleton, as the JAX package's stream paths do.

    ``n_or_T``: an ``int`` asks for that many skeleton points per chain (the
    initial state included); a ``float`` asks for a time horizon ``T``, with
    an exact terminal point at ``t = T``.  A chain batch's time-horizon
    skeleton is as wide as its longest chain rounded up to a multiple of 256
    (zero past each chain's ``n_valid``), or exactly as wide as its longest
    chain from host accumulation; a single chain's is trimmed exactly.

    ``dtype`` defaults to torch's default float.  ``t_cap`` sets the rows of
    one stream fill: by default sized from the target and device memory for
    a point count, and ``max(64, ceil64(init_capacity))`` for a time horizon
    (the JAX package's fill width off the TPU, kept fixed so that equal
    seeds give equal skeletons call after call).  ``chunk`` is the
    transitions per kernel launch and ``tile`` the RNG lane tile — with equal
    ``seed``, fill rows, ``chunk`` and ``tile`` the skeleton reproduces the
    JAX fused-kernel path.  The transition engine takes neither: it runs
    fixed chunks of 64 transitions, as JAX's stream engine does, so a
    ``t_cap`` that routes to it must be a multiple of 64.

    Host accumulation, where JAX takes it: when ``PDMPFLUX_STREAM_HOST_ACC=1``
    or the skeleton would not fit the device budget (60% of the card's free
    memory, ``PDMPFLUX_DEVICE_BYTES`` overrides) — a point count's peak
    ``B * row_bytes * (n_sk + 1.5 t_cap)``, a time horizon's ``2.5 B *
    row_bytes * t_cap`` — and after a CUDA out-of-memory error on the device
    path, which then reruns from the inits with a warning.  The fills still
    run on the device; K2 compacts each on the device, one copy per fill
    brings its event rows to the host, and the skeleton comes back as CPU
    tensors, bit for bit the device path's (up to ``n_valid``).

    ``checkpoint_path``: atomically save the state and the event
    accumulator every ``checkpoint_every`` stream fills; if the file exists
    and matches this run's mode and target, the run resumes from it and
    continues bit for bit (the counter-based keys live in the saved
    state; keep ``t_cap``, ``chunk`` and ``tile`` as they were).  Delete
    the file to start fresh.  A point count's file resumes on either
    accumulation; a time horizon checkpoints on the device path only, as in
    JAX.  ``PDMPFLUX_FAIL_AFTER_FILLS=N`` injects a crash after N fills, for
    rehearsals.
    """
    ck = ((checkpoint_path, max(1, int(checkpoint_every)))
          if checkpoint_path else None)
    if not (isinstance(n_or_T, (int, np.integer)) and not isinstance(n_or_T, bool)):
        return _sample_skeleton_horizon(
            sampler, float(n_or_T), xinit, vinit, seed=seed, verbose=verbose,
            dtype=dtype, device=device, t_cap=t_cap, chunk=chunk, tile=tile,
            init_capacity=init_capacity, ck=ck, backend=backend)
    n_sk = int(n_or_T)
    if n_sk <= 0:
        raise ValueError(f"n_sk must be positive. Current value: {n_sk}")
    x, v, squeeze = _prep_init(sampler, xinit, vinit)
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    B, d = x.shape
    target = n_sk - 1  # events beyond the initial record
    if t_cap is None:
        t_cap = fill_rows(sampler, target, B, d, dtype, dev)
    runner = fill_runner(sampler, pick_backend(sampler, backend, d, dtype, dev),
                         t_cap, target, chunk, tile)
    # the fill, the accumulator and about half a fill of K2's temporaries
    peak = B * _row_bytes(d, dtype) * (target + 1 + int(1.5 * t_cap))

    def run(host):
        state = sampler.init_state_batch(x, v, seed, dtype, dev)
        return _stream_events(sampler, runner, state, target, t_cap,
                              max_transitions_per_event, host, ck, verbose)

    skel = _with_host_retry(
        run, _force_host() or peak > _device_bytes_budget(dev),
        "device OOM during on-device skeleton accumulation; retrying with host "
        "accumulation (slower: one device->host stream transfer per fill).")
    return _squeeze_skeleton(skel) if squeeze else skel


def _events_fill(runner, state, counts, acc, init_ev, width):
    """One event-count fill merged by K2 into the ``(B, width)`` device
    accumulator: the first fill behind the initial record, a later one after
    each chain's earlier events.  ``(state, counts, acc, transitions)``."""
    res = runner(state, counts)
    if acc is None:
        B, d = state.x.shape
        acc = k2.compact_fill(res.fill, k2.empty_rows(B, width, d, state.x.dtype,
                                                       state.x.device),
                              off=1 + counts, init=init_ev)
    else:
        acc = k2.compact_fill(res.fill, acc, off=1 + counts)
    return res.state, res.counts, acc, res.transitions


def _stream_events(sampler, runner, state, target, t_cap, max_per_event, host, ck,
                   verbose) -> Skeleton:
    """The event-count fill loop (JAX ``_stream_events_device_acc`` and,
    with ``host``, ``_stream_events_host_acc``): fills until every chain has
    ``target`` events, accumulated on the device or in host memory."""
    B = state.x.shape[0]
    dev = state.x.device
    init_ev = event_from_state(state, EV_INIT)
    rows = _HostRows(init_ev, target + 1, cap=target + 1) if host else None
    acc = None
    counts = torch.zeros((B,), dtype=torch.int32, device=dev)
    counts_host = np.zeros(B, np.int64)
    trans_total = 0
    fills_done = 0
    if ck is not None:
        loaded = _load_stream_checkpoint(ck[0], "events", target, dev,
                                         "cpu" if host else None)
        if loaded is not None:
            state, acc, counts_host, fills_done = loaded
            counts = torch.as_tensor(counts_host, dtype=torch.int32, device=dev)
            if host:
                rows.resume(acc, counts_host)
    max_fills = max(1, (target * int(max_per_event)) // t_cap + 1)
    exhausted = True
    for fill in range(fills_done, max_fills):
        prev_host = counts_host
        if host:
            res = runner(state, counts)
            state, counts, n_tr = res.state, res.counts, res.transitions
            counts_host = counts.cpu().numpy().astype(np.int64)
            rows.add(res.fill, counts_host - prev_host)
            del res  # the fill's memory goes back before the next fill
        else:
            state, counts, acc, n_tr = _events_fill(runner, state, counts, acc, init_ev,
                                                    target + 1)
            counts_host = counts.cpu().numpy().astype(np.int64)
        trans_total += n_tr
        done = counts_host >= target
        if ck is not None and (fill + 1) % ck[1] == 0 and not done.all():
            _save_stream_checkpoint(ck[0], "events", target, state,
                                    rows.skeleton() if host else acc, counts_host, fill + 1)
        _fail_after_fills(fill + 1)
        if verbose:
            print(f"[sample_skeleton] events {int(counts_host.min())}/{target} "
                  f"(chains done: {int(done.sum())}/{B})")
        if done.all():
            exhausted = False
            _update_fill_ratio(sampler, target, trans_total)
            break
        if n_tr == 0:
            exhausted = False
            break
    if exhausted:
        warnings.warn(
            f"transition budget exhausted after {max_fills} stream fills; "
            "results contain fewer events than requested."
        )
    sampler.state = state
    if host:
        return rows.skeleton()
    return acc._replace(n_valid=(1 + torch.clamp_max(counts, target)).to(torch.int32))


def _trim_single(skel: Skeleton) -> Skeleton:
    """A one-chain batch as a single-chain skeleton of exactly its
    ``n_valid`` rows."""
    n0 = int(skel.n_valid[0])
    return Skeleton(*(a[0, :n0] for a in skel[:-1]), n_valid=skel.n_valid[0])


def _bucket256(n: int) -> int:
    return -(-n // 256) * 256


class _HorizonFills(NamedTuple):
    """The time-horizon fills of one chain batch, accumulated on its device."""

    state: PDMPState
    acc: Skeleton        # the initial record, then each chain's events
    total: torch.Tensor  # (B,) int32 events per chain, on the device
    needs: list          # after each fill, the most events of any chain
    transitions: int


def _horizon_fills(runner, state, init_ev, T: float, t_cap: int, ck=None,
                   verbose: bool = False, tag: str = "sample_skeleton") -> _HorizonFills:
    """Stream fills in horizon mode until every chain's clock reaches ``T``
    (JAX ``api.py:1085-1242``): the first compacted by K2 behind the
    initial record, each later (straggler) fill merged by K2 after its
    chain's earlier events, the accumulator grown first when a chain would
    overflow it.  A checkpoint holds the accumulator without its initial
    record, as the JAX package's does; a resumed run puts the record back in
    front."""
    B, d = state.x.shape
    dev, dtype = state.x.device, state.x.dtype
    zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
    acc = None
    total = zeros            # events per chain so far, on the card
    total_host = np.zeros(B, np.int64)
    needs, n_total, fill_no = [], 0, 0
    if ck is not None:
        loaded = _load_stream_checkpoint(ck[0], "horizon", T, dev)
        if loaded is not None:
            state, rows, total_host, fill_no = loaded
            total = torch.as_tensor(total_host, dtype=torch.int32, device=dev)
            acc = prepend_init_rows(rows, init_ev, total, rows.t.shape[1])
    while True:
        res = runner(state, zeros, T)  # counts start at 0 in every fill
        state, n_tr = res.state, res.transitions
        counts_host = res.counts.cpu().numpy().astype(np.int64)
        if acc is None:
            acc = k2.compact_fill(res.fill, k2.empty_rows(B, 1 + t_cap, d, dtype, dev),
                                  off=torch.ones((B,), dtype=torch.int32, device=dev),
                                  init=init_ev)
        else:
            width = acc.t.shape[1] - 1
            need = int((total_host + counts_host).max())
            if need > width:
                acc = grow_rows(acc, max(t_cap, need - width))
            acc = k2.compact_fill(res.fill, acc, off=1 + total)
        total = total + res.counts
        total_host += counts_host
        needs.append(int(total_host.max()))
        n_total += n_tr
        del res  # the fill's memory goes back before the next fill or finalize
        t_now = state.t.cpu().numpy()
        done = t_now >= T
        fill_no += 1
        if ck is not None and fill_no % ck[1] == 0 and not done.all():
            events_only = Skeleton(*(a[:, 1:] for a in acc[:-1]), n_valid=acc.n_valid)
            _save_stream_checkpoint(ck[0], "horizon", T, state, events_only,
                                    total_host, fill_no)
        _fail_after_fills(fill_no)
        if verbose:
            print(f"[{tag}] t={t_now.min():.4g}/{T} "
                  f"(chains done: {int(done.sum())}/{B})")
        if done.all():
            return _HorizonFills(state, acc, total, needs, n_total)
        if n_tr == 0:
            raise RuntimeError("time-horizon sampling made no progress")


def _horizon_host(sampler, runner, state, init_ev, T: float, verbose: bool) -> Skeleton:
    """Time-horizon fills with host accumulation (JAX's ``host_loop``,
    ``api.py:1244-1277``): K2 compacts each fill on the device to as many
    rows as its busiest chain recorded, one copy brings them to the host
    accumulator, and :func:`_assemble_horizon` finishes on the host."""
    B = state.x.shape[0]
    zeros = torch.zeros((B,), dtype=torch.int32, device=state.x.device)
    rows = _HostRows(init_ev, 16)
    while True:
        res = runner(state, zeros, T)
        state, n_tr = res.state, res.transitions
        rows.add(res.fill, res.counts.cpu().to(torch.int64))
        del res
        t_now = state.t.cpu().numpy()
        done = t_now >= T
        if verbose:
            print(f"[sample_skeleton] t={t_now.min():.4g}/{T} "
                  f"(chains done: {int(done.sum())}/{B})")
        if done.all():
            break
        if n_tr == 0:
            raise RuntimeError("time-horizon sampling made no progress")
    sampler.state = state
    return _assemble_horizon(sampler.flow, rows, T, state.x.device)


def _assemble_horizon(flow, rows: _HostRows, T: float, dev) -> Skeleton:
    """The host accumulator's time-horizon skeleton (JAX
    ``_assemble_horizon``, ``api.py:912-965``): ``finalize_horizon_rows`` on
    the host buffers, as wide as the longest chain (``n_valid.max()``), its
    one batched flow of each chain's last kept row run on ``dev``, the
    fills' device, so that the terminal rows are the device path's."""
    skel = rows.skeleton()
    t = skel.t
    col = torch.arange(t.shape[1])[None, :]
    kept = ((col < skel.n_valid[:, None]) & (t <= torch.tensor(T, dtype=t.dtype))).sum(dim=1)

    def flow_on_dev(x, v, tau):
        return tuple(a.cpu() for a in flow(x.to(dev), v.to(dev), tau.to(dev)))

    return finalize_horizon_rows(flow_on_dev, skel, T, int(kept.max()) + 1)


def _sample_skeleton_horizon(sampler, T: float, xinit, vinit, *, seed, verbose,
                             dtype, device, t_cap, chunk, tile,
                             init_capacity, ck=None, backend="auto") -> Skeleton:
    """Time-horizon skeleton (``sample.jl:323-439``), as the JAX package's
    stream path builds it: :func:`_horizon_fills` then the terminal rows on
    the device (``finalize_horizon_rows``), or host accumulation where JAX's
    ``device_ok`` is false (``api.py:1049-1055``)."""
    if not math.isfinite(T) or T < 0:
        raise ValueError(f"T must be finite and non-negative. Current value: {T}")
    x, v, squeeze = _prep_init(sampler, xinit, vinit)
    dev = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    B, d = x.shape
    if t_cap is None:
        t_cap = max(64, -(-max(2, int(init_capacity)) // 64) * 64)
    if T == 0.0:  # the initial record alone
        state = sampler.init_state_batch(x, v, seed, dtype, dev)
        sampler.state = state
        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        skel = prepend_init_rows(k2.empty_rows(B, 0, d, dtype, dev),
                                 event_from_state(state, EV_INIT), zeros, 0)
        return _trim_single(skel) if squeeze else skel
    runner = fill_runner(sampler, pick_backend(sampler, backend, d, dtype, dev),
                         t_cap, t_cap, chunk, tile, mode="horizon")
    # the fill (updated in place), the compacted rows and a second fill
    peak = B * _row_bytes(d, dtype) * 2.5 * t_cap

    def run(host):
        state = sampler.init_state_batch(x, v, seed, dtype, dev)
        init_ev = event_from_state(state, EV_INIT)
        if host:
            return _horizon_host(sampler, runner, state, init_ev, T, verbose)
        hz = _horizon_fills(runner, state, init_ev, T, t_cap, ck, verbose)
        sampler.state = hz.state
        # n_valid <= 2 + events (init and terminal rows), bucketed to 256
        out_w = None if squeeze else min(hz.acc.t.shape[1] + 1,
                                         _bucket256(2 + max(1, hz.needs[-1])))
        return finalize_horizon_rows(
            sampler.flow, hz.acc._replace(n_valid=(1 + hz.total).to(torch.int32)), T, out_w)

    skel = _with_host_retry(
        run, _force_host() or peak >= _device_bytes_budget(dev),
        "device OOM during on-device horizon accumulation; retrying with host "
        "accumulation (slower: one device->host transfer per fill).")
    return _trim_single(skel) if squeeze else skel


# ---------------------------------------------------------------------------
# Skeleton -> samples
# ---------------------------------------------------------------------------

def _interp_times(sampler, skel: Skeleton, tm, discard_vt: bool):
    """Positions (and optionally velocities and times) along a single-chain
    skeleton at output times ``tm`` (``sample.jl:475-513``)."""
    t = skel.t
    idx = torch.clamp(torch.searchsorted(t, tm, right=True) - 1, 0, t.shape[0] - 1)
    act = skel.is_active[idx]
    v_used = torch.where(act, skel.v[idx], torch.zeros_like(skel.v[idx]))
    xs, vs = sampler.flow(skel.x[idx], v_used, (tm - t[idx])[:, None])
    if discard_vt:
        return xs
    return torch.cat([xs, vs, tm[:, None]], dim=1)


def sample_from_skeleton(sampler, n_or_dt, skeleton: Skeleton, *, dt=None,
                         discard_vt: bool = True):
    """Equal-time samples from a single-chain skeleton.

    * ``n_or_dt = N`` (int): ``N`` samples at ``dt = t_end / N``;
    * ``n_or_dt = dt`` (float): samples every ``dt`` up to ``t_end``;
    * ``n_or_dt = N`` with ``dt=``: the first ``N`` skeleton points, step ``dt``.

    Returns ``(N, d)`` positions, or ``(N, 2d + 1)`` with velocities and
    times when ``discard_vt=False``.
    """
    if skeleton.t.dim() > 1:
        raise ValueError(
            "sample_from_skeleton expects a single-chain skeleton; "
            "use parallel.sample_from_skeleton_batch for chain batches"
        )
    t = skeleton.t
    if isinstance(n_or_dt, (int, np.integer)) and dt is not None:
        N = int(n_or_dt)
        sub = Skeleton(*(a[:N] if a.dim() >= 1 else a for a in skeleton))
        t_end = float(sub.t[-1])
        n_out = int(math.floor(t_end / float(dt)))
        tm = torch.arange(1, n_out + 1, dtype=t.dtype, device=t.device) * float(dt)
        return _interp_times(sampler, sub, tm, discard_vt)
    if isinstance(n_or_dt, (int, np.integer)):
        N = int(n_or_dt)
        if N <= 0:
            raise ValueError(f"N must be positive. Current value: {N}")
        step = float(t[-1]) / N
        tm = torch.arange(1, N + 1, dtype=t.dtype, device=t.device) * step
        return _interp_times(sampler, skeleton, tm, discard_vt)
    step = float(n_or_dt)
    if step <= 0:
        raise ValueError(f"dt must be positive. Current value: {step}")
    n_out = int(math.floor(float(t[-1]) / step))
    tm = torch.arange(1, n_out + 1, dtype=t.dtype, device=t.device) * step
    return _interp_times(sampler, skeleton, tm, discard_vt)


def sample(sampler, N_sk: int, N_samples: int, xinit, vinit, *, seed=None,
           verbose: bool = False, discard_vt: bool = True, dtype=None,
           device="cuda", backend: str = "auto"):
    """``sample_skeleton`` then ``sample_from_skeleton`` (``sample.jl:27-41``);
    ``(B, d)`` initial conditions return ``(B, N_samples, d)``."""
    skel = sample_skeleton(sampler, int(N_sk), xinit, vinit, seed=seed,
                           verbose=verbose, dtype=dtype, device=device, backend=backend)
    if skel.t.dim() == 2:
        from .parallel.sharded import sample_from_skeleton_batch

        return sample_from_skeleton_batch(sampler, int(N_samples), skel,
                                          discard_vt=discard_vt)
    return sample_from_skeleton(sampler, int(N_samples), skel,
                                discard_vt=discard_vt)


def sample_skeleton_with_diagnostic(sampler, T: float, xinit, vinit, U, *, B: int = 1000,
                                    seed=None, verbose: bool = False, dtype=None,
                                    init_capacity: int = 1024, device="cuda",
                                    backend: str = "auto"):
    """Time-horizon skeleton and the online realized volatility of ``U``
    (``sample.jl:75-236``; JAX ``api.py:1543-1611``).

    The reference accumulates the increments of ``U`` event by event
    between batch boundaries; they telescope to ``U(x(t_b)) - U(x(t_{b-1}))``,
    so ``U`` (a torch function of one ``(d,)`` position) is evaluated at the
    ``B + 1`` boundary positions that the sampler's exact flow reconstructs,
    and the squared differences summed.  A single chain gives a float; a
    chain batch a ``(Bc,)`` tensor of per-chain values on the skeleton's
    device, each chain's padded tail masked to +inf out of the boundary
    search.
    """
    T = float(T)
    skel = sample_skeleton(sampler, T, xinit, vinit, seed=seed, verbose=verbose,
                           dtype=dtype, init_capacity=init_capacity, device=device,
                           backend=backend)
    t = skel.t
    if T == 0.0:
        return skel, (0.0 if t.dim() == 1 else torch.zeros(t.shape[0], dtype=t.dtype,
                                                           device=t.device))
    bounds = linspace0(T, B + 1, t.dtype, t.device)
    if t.dim() == 1:
        u = torch.func.vmap(U)(_interp_times(sampler, skel, bounds, True))
        return skel, float(div_once(torch.sum(torch.diff(u) ** 2), T))
    u = boundary_u(skel, bounds[None, :].expand(t.shape[0], -1), U, sampler.flow)
    return skel, div_once(torch.sum(torch.diff(u, dim=1) ** 2, dim=1), T)

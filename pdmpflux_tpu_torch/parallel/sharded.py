"""Chain-batch helpers and the sharded drivers
(``pdmpflux_tpu/parallel/sharded.py``).

* :func:`sample_skeleton_sharded`: skeletons of a chain batch sharded over a
  mesh's ``chains`` axis (``parallel/mesh.py``).  Each shard runs the
  single-device fill loop on its own device with its own count and clock
  read-backs, and no communication inside a fill, as JAX's ``shard_map``
  runs each device's loop; results cross processes once, at the end.  On a
  mesh with a ``dim`` axis every process of a row runs the row's shards
  whole, as ``shard_map`` over ``chains`` replicates over ``dim``.
* :func:`sample_skeleton_gspmd`: a fixed number of events per chain with
  the chains sharded over ``chains`` and the coordinates over ``dim``:
  the transition engine reduces over the coordinate slices of each row of
  processes (``core/dims.py``) where JAX's GSPMD partitioner inserts the
  collectives.
* :func:`sample_from_skeleton_batch` and :func:`pooled_moments` of a batch,
  the latter over every process of a mesh's group; both take the
  coordinate block of a ``sample_skeleton_gspmd`` skeleton.

Chain ``b`` takes key ``b`` of ``split(key(seed), B)`` whatever its shard.
On the transition engine (every shard off the card) each chain's stream is
then the one an unsharded run gives it, bit for bit.  A chunk kernel seeds
each fill from its batch's keys and advances the keys by its chunk count
(``ops/cuda/driver.py``), as the JAX kernel does under ``shard_map``: on the
card, a run of one shard equals ``sample_skeleton`` bit for bit, and a run
of several shards draws other streams of the same law.
"""

from __future__ import annotations

import math
import warnings
from typing import List, NamedTuple

import numpy as np
import torch

from .. import api
from ..core import engine, rng
from ..core.dims import LOCAL
from ..core.engine import finalize_horizon_rows, prepend_init_rows
from ..core.engine import RunResult
from ..core.types import EV_INIT, PDMPState, Skeleton, empty_skeleton, event_from_state
from ..models.base import as_key
from ..ops.flows import div_once
from . import distributed
from . import mesh as mesh_lib


class ShardedRun(NamedTuple):
    state: PDMPState           # (B_p, ...) this process's chains, in global order
    skeleton: Skeleton         # (B_p, N, ...) the same chains' skeletons
    transitions: torch.Tensor  # (n_shards,) int64 transitions of every global shard
    stats: dict                # the skeleton statistics over every process's chains


class _Shard:
    """One shard's chains on its device, and its fill loop's progress."""

    def __init__(self, sampler, x, v, keys, dtype, dev):
        self.dev = dev
        self.state = sampler.init_state_batch(x, v, None, dtype, dev, keys=keys.to(dev))
        self.init_ev = event_from_state(self.state, EV_INIT)
        self.n = x.shape[0]
        self.counts = torch.zeros((self.n,), dtype=torch.int32, device=dev)
        self.counts_host = np.zeros(self.n, np.int64)
        self.acc = None
        self.transitions = 0
        self.done = False


def _shards(sampler, xinit, vinit, mesh, seed, dtype):
    """This process's shards of the global ``(B, d)`` inits (every process
    passes them whole): ``(shards, B, d, dtype)``."""
    x, v, _ = api._prep_init(sampler, xinit, vinit)
    B, d = x.shape
    ranges = mesh_lib.chain_sharding(mesh, B)
    if dtype is None:
        dtype = torch.get_default_dtype()
    keys = rng.split(as_key(seed, "cpu"), B)
    shards = []
    for dev, g in zip(mesh.devices, mesh.local_shards()):
        lo, hi = ranges[g]
        shards.append(_Shard(sampler, x[lo:hi], v[lo:hi], keys[lo:hi], dtype, dev))
    return shards, B, d, dtype


def _route(sampler, d, dtype, dev):
    """JAX's ``_pick_stream_launch``: the chunk kernel on the card where
    ``api.pick_backend`` gives it, the transition engine elsewhere; with the
    kernel's launch chunk or the engine's."""
    route = api.pick_backend(sampler, "auto", d, dtype, dev) if dev.type == "cuda" else "engine"
    return route, (32 if route == "kernel" else engine.CHUNK)


def cat_chains(records: list, dev):
    """Records of tensors (the shards' states, skeletons or accumulators)
    concatenated along the chains on ``dev``; one record as it is."""
    if len(records) == 1:
        return records[0]
    return type(records[0])(*(torch.cat([a.to(dev) for a in parts])
                              for parts in zip(*records)))


def process_path(path, mesh):
    """A checkpoint path per process of a group: ``path.rank<r>`` when the
    group has several."""
    return path if not path or mesh.world_size == 1 else f"{path}.rank{mesh.rank}"


def _gather_transitions(mesh, local: List[int]) -> torch.Tensor:
    t = torch.tensor(local, dtype=torch.int64)
    return distributed.all_gather_rows(t, mesh.chain_group) if mesh.distributed else t


def _chain_stats(skel: Skeleton) -> torch.Tensor:
    """Per chain, float64: ``n_valid`` and the valid rows' sums of ``ar``,
    ``rejected``, ``errored_bound`` and ``hitting_horizon``."""
    valid = (torch.arange(skel.t.shape[1], device=skel.t.device)[None, :]
             < skel.n_valid[:, None])
    cols = [skel.n_valid.to(torch.float64)]
    for f in ("ar", "rejected", "errored_bound", "hitting_horizon"):
        cols.append(torch.where(valid, getattr(skel, f), 0).to(torch.float64).sum(dim=1))
    return torch.stack(cols, dim=1)


def _skeleton_stats(skel: Skeleton, mesh=None) -> dict:
    """JAX's ``_skeleton_stats`` over every chain of the mesh's processes:
    ``events`` (the sum of ``n_valid``), ``ar_sum``, ``rejected``,
    ``errored_bound`` and ``hitting_horizon`` summed, ``mean_ar = ar_sum /
    max(events, 1)``.  The per-chain sums are gathered and added in global
    chain order, so any split of the batch gives the same numbers."""
    per = _chain_stats(skel)
    if mesh is not None and mesh.distributed:
        per = distributed.all_gather_rows(per, mesh.chain_group)
    ev, ar, rej, err, hit = per.sum(dim=0).tolist()
    stats = {"events": int(ev), "ar_sum": ar, "rejected": int(rej),
             "errored_bound": int(err), "hitting_horizon": int(hit)}
    stats["mean_ar"] = ar / max(int(ev), 1)
    return stats


def sample_skeleton_sharded(sampler, n_or_T, xinit, vinit, *, mesh=None, seed=None,
                            dtype=None, max_transitions_per_event: int = 256,
                            init_capacity: int = 1024, verbose: bool = False,
                            checkpoint_path=None, checkpoint_every: int = 4) -> ShardedRun:
    """Skeletons of a chain batch sharded over ``mesh`` (default: this
    process's devices, :func:`mesh.make_mesh`), each shard's fills on its
    device.

    ``n_or_T``: an ``int`` asks for that many skeleton points per chain, a
    ``float`` for a time horizon with exact ``t = T`` terminal rows.  Every
    process passes the global ``(B, d)`` inits, ``B`` divisible by
    ``mesh.shape["chains"]``, and gets back its own chains (in global order),
    the transition count of every shard and the statistics of all chains;
    on a mesh with a ``dim`` axis, every process of a row the row's chains
    whole.

    The fill rows are JAX's sharded sizing: for a point count the cold
    1.8 transitions per event (the measured ratio once a run has finished,
    as ``api.fill_rows`` keeps it), aligned to the launch chunk, capped at
    half the device budget per shard's batch; for a time horizon
    ``ceil(init_capacity)`` to the chunk.  Local shards run one after
    another; one process per card runs the cards at once.

    ``checkpoint_path`` (point counts only, as in JAX): save every
    ``checkpoint_every`` fills and resume bit for bit, one file per process
    (``path.rank<r>`` in a group of several).
    """
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    ck = ((checkpoint_path, max(1, int(checkpoint_every)))
          if checkpoint_path else None)
    if isinstance(n_or_T, (int, np.integer)) and not isinstance(n_or_T, bool):
        return _sharded_events(sampler, int(n_or_T), xinit, vinit, mesh, seed, dtype,
                               max_transitions_per_event, verbose, ck)
    if ck is not None:
        warnings.warn(
            "checkpoint_path on sample_skeleton_sharded is only supported "
            "in event-count mode; ignoring it for the time-horizon run."
        )
    return _sharded_horizon(sampler, float(n_or_T), xinit, vinit, mesh, seed, dtype,
                            init_capacity, verbose)


def _events_t_cap(sampler, target, B_local, d, dtype, dev, chunk):
    """JAX's sharded fill rows (``sharded.py:219-242``)."""
    budget_rows = int((api._device_bytes_budget(dev) / max(B_local * api._row_bytes(d, dtype), 1)
                       - (target + 1)) / 2)
    ratio = getattr(sampler, "_fill_ratio", None)
    margin = 1.8 if not ratio else min(1.8, max(1.08, 1.08 / ratio))
    align = max(256 if target >= 256 else chunk, chunk)
    t_cap = max(chunk, -(-int(max(target, 1) * margin + 64) // align) * align)
    return min(t_cap, max(chunk, budget_rows // chunk * chunk))


def _sharded_events(sampler, n_events, xinit, vinit, mesh, seed, dtype, max_per_event,
                    verbose, ck) -> ShardedRun:
    if n_events <= 0:
        raise ValueError(f"n_sk must be positive. Current value: {n_events}")
    shards, B, d, dtype = _shards(sampler, xinit, vinit, mesh, seed, dtype)
    target = n_events - 1
    route, chunk = _route(sampler, d, dtype, mesh.devices[0])
    t_cap = _events_t_cap(sampler, target, B // mesh.shape[mesh_lib.CHAIN_AXIS], d, dtype,
                          mesh.devices[0], chunk)
    runner = api.fill_runner(sampler, route, t_cap, target, chunk, 128)
    fills_done = 0
    if ck is not None:
        path = process_path(ck[0], mesh)
        loaded = api._load_stream_checkpoint(path, "sharded_events", target, "cpu")
        if loaded is not None:
            state, acc, counts_np, fills_done = loaded
            lo = 0
            for s in shards:
                part = slice(lo, lo + s.n)
                lo += s.n
                s.state = PDMPState(*(a[part].to(s.dev) for a in state))
                s.acc = Skeleton(*(a[part].to(s.dev) for a in acc))
                s.counts_host = counts_np[part]
                s.counts = torch.as_tensor(s.counts_host, dtype=torch.int32, device=s.dev)
                s.done = bool((s.counts_host >= target).all())
    max_fills = max(1, (target * int(max_per_event)) // t_cap + 1)
    exhausted = True
    for fill in range(fills_done, max_fills):
        for s in shards:
            if s.done:
                continue
            with mesh_lib.on_device(s.dev):
                s.state, s.counts, s.acc, n_tr = api._events_fill(
                    runner, s.state, s.counts, s.acc, s.init_ev, target + 1)
            s.transitions += n_tr
            s.counts_host = s.counts.cpu().numpy().astype(np.int64)
            s.done = bool((s.counts_host >= target).all()) or n_tr == 0
        counts_host = np.concatenate([s.counts_host for s in shards])
        done = counts_host >= target
        if ck is not None and (fill + 1) % ck[1] == 0 and not done.all():
            api._save_stream_checkpoint(
                path, "sharded_events", target,
                cat_chains([s.state for s in shards], "cpu"), cat_chains([s.acc for s in shards], "cpu"),
                counts_host, fill + 1)
        api._fail_after_fills(fill + 1)
        if verbose:
            print(f"[sample_skeleton_sharded] events {int(counts_host.min())}/{target} "
                  f"(chains done: {int(done.sum())}/{len(done)})")
        if all(s.done for s in shards):
            exhausted = False
            break
    if exhausted:
        warnings.warn(
            f"transition budget exhausted after {max_fills} stream fills; "
            "results contain fewer events than requested."
        )
    transitions = _gather_transitions(mesh, [s.transitions for s in shards])
    if not exhausted and (counts_host >= target).all():
        api._update_fill_ratio(sampler, target, int(transitions.max()))
    dev = mesh.devices[0]
    skel = cat_chains([s.acc._replace(n_valid=(1 + torch.clamp_max(s.counts, target)).to(torch.int32))
                 for s in shards], dev)
    return ShardedRun(cat_chains([s.state for s in shards], dev), skel, transitions,
                      _skeleton_stats(skel, mesh))


def _global_needs(mesh, local: List[list]) -> list:
    """After each fill of the longest loop, the most events of any chain of
    any shard (a shard that stopped keeps its last count)."""
    n = max(len(x) for x in local)
    if mesh.distributed:
        n = int(distributed.all_reduce(torch.tensor([n]), torch.distributed.ReduceOp.MAX,
                                       mesh.chain_group))
    need = torch.tensor([x + x[-1:] * (n - len(x)) for x in local], dtype=torch.int64)
    need = need.max(dim=0).values
    if mesh.distributed:
        need = distributed.all_reduce(need, torch.distributed.ReduceOp.MAX, mesh.chain_group)
    return need.tolist()


def _sharded_horizon(sampler, T, xinit, vinit, mesh, seed, dtype, init_capacity,
                     verbose) -> ShardedRun:
    if not math.isfinite(T) or T < 0:
        raise ValueError(f"T must be finite and non-negative. Current value: {T}")
    shards, B, d, dtype = _shards(sampler, xinit, vinit, mesh, seed, dtype)
    dev = mesh.devices[0]
    if T == 0.0:  # the initial record, then one zero row, as JAX's
        skels = [prepend_init_rows(empty_skeleton(1, d, dtype, (s.n,), s.dev), s.init_ev,
                                   torch.zeros_like(s.counts), 1) for s in shards]
        skel = cat_chains(skels, dev)
        return ShardedRun(cat_chains([s.state for s in shards], dev), skel,
                          _gather_transitions(mesh, [0] * len(shards)),
                          _skeleton_stats(skel, mesh))
    route, chunk = _route(sampler, d, dtype, dev)
    t_cap = max(chunk, -(-int(init_capacity) // chunk) * chunk)
    runner = api.fill_runner(sampler, route, t_cap, t_cap, chunk, 128, mode="horizon")
    fills = []
    for s in shards:
        with mesh_lib.on_device(s.dev):
            fills.append(api._horizon_fills(runner, s.state, s.init_ev, T, t_cap,
                                            verbose=verbose, tag="sample_skeleton_sharded"))
    # the finalize width of JAX's one accumulator over every chain
    # (sharded.py:465-467): its growth replayed from the fills' largest counts
    needs = _global_needs(mesh, [f.needs for f in fills])
    W = t_cap
    for n in needs[1:]:
        if n > W:
            W += max(t_cap, n - W)
    out_w = min(W + 2, api._bucket256(2 + max(1, needs[-1])))
    skel = cat_chains([finalize_horizon_rows(
        sampler.flow, f.acc._replace(n_valid=(1 + f.total).to(torch.int32)), T, out_w)
        for f in fills], dev)
    return ShardedRun(cat_chains([f.state for f in fills], dev), skel,
                      _gather_transitions(mesh, [f.transitions for f in fills]),
                      _skeleton_stats(skel, mesh))


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


def _block_dims(sampler, skeleton: Skeleton, mesh):
    """The coordinate group of ``skeleton``: the mesh's slice when the
    skeleton holds a block of the coordinates (``sample_skeleton_gspmd``),
    else every coordinate."""
    d_local = skeleton.x.shape[-1]
    if mesh is None or d_local == sampler.dim:
        return LOCAL
    dims = mesh.dims(sampler.dim)
    if dims.hi - dims.lo != d_local:
        raise ValueError(f"a skeleton of {d_local} coordinates is neither the sampler's "
                         f"{sampler.dim} nor this process's slice {dims.lo}:{dims.hi}")
    return dims


def sample_from_skeleton_batch(sampler, n_per_chain: int, skeleton: Skeleton,
                               *, discard_vt: bool = True, mesh=None):
    """``(B, n, d)`` equal-time positions per chain, or ``(B, n, 2d + 1)``
    with velocities and times when ``discard_vt=False``.  With ``mesh``, a
    ``sample_skeleton_gspmd`` skeleton's block of coordinates gives this
    process's block of samples (a flow that couples coordinates reduces
    over the mesh's dim group)."""
    view = sampler.on_dims(_block_dims(sampler, skeleton, mesh))
    xs, vs, tm = _batch_interp(view, skeleton, n_per_chain)
    if discard_vt:
        return xs
    return torch.cat([xs, vs, tm[:, :, None]], dim=2)


def pooled_moments(skeleton: Skeleton, sampler, n_per_chain: int, mesh=None):
    """Cross-chain pooled mean and variance of ``n_per_chain`` equal-time
    samples per chain.  With a ``mesh`` whose processes form a group, each
    process passes its own chains' skeleton and gets the moments of the
    whole batch: the per-chain sums (O(B d)) are gathered and added in
    global chain order, so the result is the single-process one bit for
    bit.  A ``sample_skeleton_gspmd`` skeleton's block of coordinates gives
    the moments of every coordinate, gathered over the mesh's dim group."""
    dims = _block_dims(sampler, skeleton, mesh)
    xs, _, _ = _batch_interp(sampler.on_dims(dims), skeleton, n_per_chain)
    s1, s2 = torch.sum(xs, dim=1), torch.sum(xs * xs, dim=1)
    if mesh is not None and mesh.distributed:
        s1 = distributed.all_gather_rows(s1, mesh.chain_group)
        s2 = distributed.all_gather_rows(s2, mesh.chain_group)
    n_tot = s1.shape[0] * n_per_chain
    mean = div_once(torch.sum(s1, dim=0), n_tot)
    var = div_once(torch.sum(s2, dim=0), n_tot) - mean ** 2
    return dims.gather(mean), dims.gather(var)


def _localize(rec, dims):
    """A state or an event record with ``x``, ``v`` and ``is_active`` cut to
    the coordinates of ``dims``."""
    return rec._replace(x=dims.local(rec.x), v=dims.local(rec.v),
                        is_active=dims.local(rec.is_active))


def sample_skeleton_gspmd(sampler, n_events: int, xinit, vinit, *, mesh=None, seed=None,
                          dtype=None, max_transitions_per_event: int = 256) -> RunResult:
    """``n_events`` skeleton points per chain (the initial record included)
    with the chains sharded over the mesh's ``chains`` axis and the
    coordinates over its ``dim`` axis (default: :func:`mesh.make_mesh`), for
    a ``dim`` too large for one device.

    Every process passes the global ``(B, d)`` inits (``B`` divisible by the
    ``chains`` axis, ``d`` by the ``dim`` axis) and gets back a
    ``RunResult(state, skeleton, transitions)`` of its own chains, in
    global order, where ``x``, ``v`` and ``is_active`` of the state and the
    skeleton hold only its own coordinates (JAX's ``state_shardings`` and
    ``skeleton_shardings`` with ``shard_dim``); every other field is whole.
    ``transitions`` counts the whole chunks of 64 transitions that the
    batch ran, at most ``n_events * max_transitions_per_event`` rounded up
    to a chunk; where that budget runs out, ``n_valid`` falls short of
    ``n_events``.  The state is frozen at each chain's last event.

    Each chain shard runs the transition engine (``core/engine.py``) in
    fills of whole chunks, its transition reducing over the coordinate
    slices of its row of processes (``core/dims.py``), and K2 compacts each
    fill's events into the skeleton; a chain's events, its final state and
    the chunk count are those of JAX's fixed-event scatter runner
    (``make_fixed_event_runner``), which JAX's GSPMD path runs.  Chain
    ``b`` takes key ``b`` of ``split(key(seed), B)``."""
    if mesh is None:
        mesh = mesh_lib.make_mesh()
    n_events = int(n_events)
    if n_events <= 0:
        raise ValueError(f"n_sk must be positive. Current value: {n_events}")
    x, v, _ = api._prep_init(sampler, xinit, vinit)
    B, d = x.shape
    dims = mesh.dims(d)
    ranges = mesh_lib.chain_sharding(mesh, B)
    if dtype is None:
        dtype = torch.get_default_dtype()
    keys = rng.split(as_key(seed, "cpu"), B)
    target = n_events - 1
    n_chunks = max(1, -(-n_events * int(max_transitions_per_event) // engine.CHUNK))
    runners = {}
    states, skels, transitions = [], [], 0
    for dev, g in zip(mesh.devices, mesh.local_shards()):
        lo, hi = ranges[g]
        with mesh_lib.on_device(dev):
            state = sampler.init_state_batch(x[lo:hi], v[lo:hi], None, dtype, dev,
                                             keys=keys[lo:hi].to(dev))
            init_ev = _localize(event_from_state(state, EV_INIT), dims)
            state = _localize(state, dims)
            fill_chunks = api.fill_rows(sampler, target, hi - lo, state.x.shape[1], dtype,
                                        dev) // engine.CHUNK
            counts = torch.zeros((hi - lo,), dtype=torch.int32, device=dev)
            acc, chunks = None, 0
            while True:
                t_cap = min(fill_chunks, n_chunks - chunks) * engine.CHUNK
                if t_cap not in runners:
                    runners[t_cap] = engine.make_stream_runner(sampler, t_cap, target,
                                                               dims=dims)
                state, counts, acc, n_tr = api._events_fill(runners[t_cap], state, counts,
                                                            acc, init_ev, n_events)
                chunks += n_tr // engine.CHUNK
                if chunks >= n_chunks or n_tr < t_cap or bool((counts >= target).all()):
                    break
        transitions = max(transitions, chunks * engine.CHUNK)
        states.append(state)
        skels.append(acc._replace(n_valid=(1 + torch.clamp_max(counts, target)).to(torch.int32)))
    if mesh.distributed:
        transitions = int(distributed.all_reduce(torch.tensor([transitions]),
                                                 torch.distributed.ReduceOp.MAX))
    dev = mesh.devices[0]
    return RunResult(cat_chains(states, dev), cat_chains(skels, dev),
                     torch.tensor(transitions, dtype=torch.int32))

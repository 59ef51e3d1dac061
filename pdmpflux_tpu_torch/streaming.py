"""Streaming (bounded-memory) statistics over unbounded PDMP runs
(``pdmpflux_tpu/streaming.py``).

``sample_skeleton`` holds the whole skeleton on the card, so the longest
run is one card's memory of events.  Here each stream fill is *folded* into
O(B * d) running accumulators and then discarded, so a run is bounded by
wall time, not memory, while ESS, split-R-hat and posterior moments stay
computable at the end:

* a fixed equal-time grid ``t_j = (j + 1) T / n_samples`` is chosen up
  front (time-horizon mode);
* each fill is one horizon-mode stream fill to a capped clock target, from
  the sampler's chunk kernel (K1 or K6, K3/K5 or K4 in horizon mode, K7), or
  from the transition engine where no kernel covers the sampler (RHMC, the
  scalar-bound Zig-Zag family) or ``backend`` asks for it, as JAX falls back
  to its XLA engine (``api.pick_backend``); the grid points the fill newly covers are
  interpolated from its raw rows, which carry trajectory time and form a
  valid skeleton, and flowed from the covering row as
  ``sample_from_skeleton`` would;
* those samples update per-chain **split-half moments** (count, sum, sum of
  squares, for split-R-hat and the posterior moments) and **batch-mean**
  window sums (for the batch-means ESS), and are dropped.

The fold reads the port's raw fill where it lies, chains minor
(``core.types.RawFill``): row times ``fs[:, 0, :]``, ``x``/``v``
``(rows, d, B)``, ``act`` ``(rows, d, B)`` or None (all active).  It gathers
each chain's rows at its grid indices rather than transposing the fill.  It
is plain torch on the device, as XLA computed it outside any Pallas kernel:
``searchsorted``, gathers, the sampler's flow, and batched products with
one-hot half and window masks (deterministic, so that a resumed run equals
an unbroken one bit for bit on the card too; ``index_add_`` adds by
atomics in no fixed order).

Estimators, finalized in float64 on the host by :func:`streaming_summary`:
split-R-hat over the 2B half-chains from the half sufficient statistics
(the definition of ``diagnostics.split_rhat``), and batch-means ESS per
chain and coordinate, aggregated as ``diagnostics.ess_summary`` aggregates.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from .api import (
    _device_bytes_budget,
    _fail_after_fills,
    _prep_init,
    _row_bytes,
    fill_runner,
    pick_backend,
)
from .core import rng
from .core.device import resolve_device
from .core.types import PDMPState
from .models.base import as_key
from .parallel import distributed
from .parallel import mesh as mesh_lib
from .parallel.sharded import cat_chains, process_path
from .diagnostics import RHAT_THRESHOLD
from .ops.flows import div_once
from .parallel.checkpoint import _flatten, _meta_bytes, _write_atomic, load_state, read_meta


class StreamingStats(NamedTuple):
    """O(B * d) accumulators on the device."""

    n_half: torch.Tensor      # (B, 2)    int32 samples folded per chain half
    sum_half: torch.Tensor    # (B, 2, d) sum of (x - x_ref) per half
    sumsq_half: torch.Tensor  # (B, 2, d) sum of (x - x_ref)^2 per half
    bsum: torch.Tensor        # (B, M, d) sum of (x - x_ref) per ESS window
    bcount: torch.Tensor      # (B, M)    int32 samples folded per ESS window


def empty_stats(B: int, d: int, n_batches: int, dtype=torch.float32,
                device="cuda") -> StreamingStats:
    dev = resolve_device(device)

    def z(*s, dt=dtype):
        return torch.zeros(s, dtype=dt, device=dev)

    return StreamingStats(
        n_half=z(B, 2, dt=torch.int32), sum_half=z(B, 2, d), sumsq_half=z(B, 2, d),
        bsum=z(B, n_batches, d), bcount=z(B, n_batches, dt=torch.int32),
    )


class StreamingRun(NamedTuple):
    stats: StreamingStats  # final accumulators (device)
    state: PDMPState       # final engine state (continuation, sample.jl:281)
    events: int            # total events committed across all chains
    fills: int             # stream fills executed
    n_samples: int         # grid size the stats were folded over
    n_burnin: int          # leading grid points excluded from the stats
    x_ref: np.ndarray = np.float32(0.0)  # (d,) centering offset the fold
    #                                      subtracted (mean initial position)


def make_fold_chunk(sampler, G: int, n_samples: int, n_batches: int,
                    n_burnin: int, dt_grid: float, x_ref):
    """The fold of one fill's grid window into the accumulators.

    ``fold(stats, fill, anchor, rows_written, j_start, j_hi) -> stats``:
    ``fill`` is the RAW fill (a ``RawFill``, chains minor) of which the
    first ``rows_written`` rows were written, ``anchor = (t, x, v,
    is_active)`` the trajectory point covering grid times before the fill's
    first row, and ``j_start``/``j_hi`` ``(B,)`` each chain's half-open grid
    window this fill newly covers.  Only indices in ``[max(j_start,
    n_burnin), j_hi)`` contribute; the caller guarantees ``j_hi <= j_start +
    G``.  The operations are those of the JAX package's ``make_fold_chunk``
    (``streaming.py:88-176``) with its ``(B, W, ...)`` stream read at the
    port's ``(rows, ..., B)``.
    """
    flow = sampler.flow
    n_post = max(n_samples - n_burnin, 1)
    x_ref = np.asarray(x_ref)

    def fold(stats: StreamingStats, fill, anchor, rows_written, j_start, j_hi):
        at, ax, av, aa = anchor
        dtype, dev = ax.dtype, ax.device
        B, d = ax.shape
        rows = int(rows_written)
        j = j_start[:, None] + torch.arange(G, dtype=torch.int32, device=dev)[None, :]
        tg = (j + 1).to(dtype) * torch.tensor(dt_grid, dtype=dtype, device=dev)  # (B, G)
        live = (j < j_hi[:, None]) & (j >= n_burnin)                              # (B, G)

        if rows > 0:
            tm = fill.fs[:rows, 0, :].T.contiguous()                              # (B, rows)
            idx = torch.searchsorted(tm, tg.contiguous(), right=True) - 1
            # idx == -1: the grid time precedes every row of the fill and the
            # carried anchor covers it
            use_anchor = idx < 0
            idxc = torch.clamp(idx, 0, rows - 1)
            chain = torch.arange(B, device=dev)[:, None]
            m3 = use_anchor[:, :, None]

            def take(a, a_anchor):
                # a[idxc[b, g], :, b] for every (b, g): (B, G, d)
                return torch.where(m3, a_anchor[:, None, :], a[idxc, :, chain])

            x_i, v_i = take(fill.x, ax), take(fill.v, av)
            a_i = aa[:, None, :] if fill.act is None else take(fill.act, aa)
            t_i = torch.where(use_anchor, at[:, None], torch.gather(tm, 1, idxc))
        else:  # an empty fill: the anchor covers every grid time
            x_i, v_i, a_i = ax[:, None, :], av[:, None, :], aa[:, None, :]
            t_i = at[:, None]
        # clamp: float32 grid and row-time rounding can leave tg an ulp past
        # the covering row's time; masked-out lanes flow by 0
        zero = torch.zeros((), dtype=dtype, device=dev)
        tau = torch.where(live, torch.clamp_min(tg - t_i, 0.0), zero)
        v_used = torch.where(a_i, v_i, zero)
        xs, _ = flow(x_i.expand(B, G, d), v_used.expand(B, G, d), tau[:, :, None])
        xs = xs - torch.as_tensor(x_ref, device=dev).to(dtype)

        w = live.to(dtype)                                                        # (B, G)
        xm = xs * w[:, :, None]
        x2m = (xs * xs) * w[:, :, None]

        # post-burn-in ordinal of each grid index (clipped; masked-out
        # indices carry zero weight regardless)
        jp = torch.clamp(j - n_burnin, 0, n_post - 1)
        half = torch.clamp(jp * 2 // n_post, 0, 1)
        win = torch.clamp(jp * n_batches // n_post, 0, n_batches - 1)
        oh_h = half[:, :, None] == torch.arange(2, device=dev)                   # (B, G, 2)
        oh_w = win[:, :, None] == torch.arange(n_batches, device=dev)            # (B, G, M)
        oh_hT = oh_h.transpose(1, 2).to(dtype)
        oh_wT = oh_w.transpose(1, 2).to(dtype)
        lv = live[:, :, None]

        return StreamingStats(
            n_half=stats.n_half + (oh_h & lv).sum(dim=1, dtype=torch.int32),
            sum_half=stats.sum_half + torch.bmm(oh_hT, xm),
            sumsq_half=stats.sumsq_half + torch.bmm(oh_hT, x2m),
            bsum=stats.bsum + torch.bmm(oh_wT, xm),
            bcount=stats.bcount + (oh_w & lv).sum(dim=1, dtype=torch.int32),
        )

    return fold


def _anchor_from_state(state: PDMPState):
    """Interpolation anchor: the state's trajectory point, position ``x`` at
    trajectory time ``t + ts`` (``ts`` counts flow past the last committed
    event), velocity and activity as stored.  The last row of a fill is the
    same point, so a fill boundary is a consistent cut."""
    return (state.t + state.ts, state.x, state.v, state.is_active)


def _save_streaming_checkpoint(path, state, stats, meta):
    """Atomic checkpoint of a streaming run: the state, the accumulators and
    a manifest that carries the per-chain grid cursor.  The anchor needs no
    saving: it is the state's own trajectory point."""
    arrays = _flatten("state", state)
    arrays.update(_flatten("stats", stats))
    arrays["__meta__"] = _meta_bytes(meta)
    _write_atomic(path, arrays)


def _load_streaming_checkpoint(path, expect: dict, device):
    """Load and validate a streaming checkpoint: ``(state, stats, meta)`` on
    ``device``, or None when there is no file.  A file from another run
    configuration (the manifest's ``T``, grid, burn-in, centering offset
    ``x_ref``, batch ``shape`` and ``seed``) raises instead of silently
    mixing two runs."""
    if not os.path.exists(path):
        return None
    dev = resolve_device(device)
    with np.load(path) as z:
        meta = read_meta(z)
        for k, v in expect.items():
            if meta.get(k) != v:
                raise ValueError(
                    f"checkpoint at {path} was written for {k}="
                    f"{meta.get(k)!r}, not this run's {k}={v!r}; delete it "
                    "to start fresh."
                )
        state = load_state(z, "state", dev)
        stats = StreamingStats(*[torch.tensor(z[f"stats.{f}"], device=dev)
                                 for f in StreamingStats._fields])
    return state, stats, meta


def _seed_meta(seed):
    """The seed as the manifest records it: an int, None, or key words."""
    if seed is None or isinstance(seed, (int, np.integer)):
        return None if seed is None else int(seed)
    return np.asarray(torch.as_tensor(seed).cpu()).astype(np.int64).tolist()


def sample_streaming_stats(
    sampler,
    T: float,
    xinit,
    vinit,
    *,
    n_samples: int = 4096,
    n_batches: int = 64,
    burnin_frac: float = 0.25,
    seed=None,
    dtype=None,
    t_cap: int | None = None,
    grid_chunk: int = 512,
    verbose: bool = False,
    checkpoint_path=None,
    checkpoint_every: int = 64,
    mesh=None,
    stop_when_converged: bool = False,
    check_every: int = 32,
    min_ess: float = 0.0,
    device="cuda",
    chunk: int = 32,
    tile: int = 128,
    backend: str = "auto",
) -> StreamingRun:
    """Run time-horizon sampling to ``t = T`` while folding equal-time
    samples into O(B * d) accumulators; the skeleton is never materialized.

    ``n_samples`` equal-time grid points span ``(0, T]``; the leading
    ``burnin_frac`` of them stay out of the statistics.  Finalize with
    :func:`streaming_summary`.

    Each fill is one horizon-mode stream fill of ``t_cap`` rows at most
    (by default from the device memory budget, 256 to 8192), run to a clock
    target capped so that no chain's grid advances past its fold window of
    ``grid_chunk`` points.  Fills go in groups of 8 on CUDA (2 on the CPU),
    as the JAX package groups them per dispatch; ``fills``,
    ``checkpoint_every`` and ``check_every`` count as there.  ``chunk`` and
    ``tile`` are the kernel driver's (transitions per kernel launch, RNG lane
    tile); ``backend`` picks the fill as ``sample_skeleton``'s does.

    ``checkpoint_path``: atomically save the state, the accumulators and the
    grid cursor about every ``checkpoint_every`` fills, and RESUME bit for
    bit from an existing file written for the same configuration.

    ``stop_when_converged``: treat ``T`` as a budget; every ``check_every``
    groups, finalize the partial accumulators and stop once split-R-hat
    gates (and the worst coordinate's pooled ESS reaches ``min_ess``, when
    given).

    ``mesh``: run the fills and folds per shard of the mesh's ``chains``
    axis (``parallel.make_mesh``; ``device`` is then the mesh's), each on
    its device.  Every process passes the global inits; the fills' clock cap
    and the stopping tests read the whole batch, so each chain's fills,
    samples and sums are those of the run without a mesh, and the gathered
    accumulators (O(B * d)) give the summary of every chain.  On the
    transition engine the run equals the one without a mesh bit for bit; a
    chunk kernel seeds each fill from its shard's keys (see
    ``parallel/sharded.py``), so only a mesh of one shard equals it there.
    A checkpoint then holds this process's chains, one file per process of
    a group (``path.rank<r>``).  On a mesh with a ``dim`` axis above 1, every
    process of a row runs the row's chain shards whole (JAX's ``shard_map``
    over ``chains`` replicates over ``dim``), and the reductions run over
    the mesh's chain group.

    The fused chunk kernels cover the Zig-Zag family with vectorized bounds,
    BPS, Boomerang and Forward ECMC; every other sampler runs on the
    transition engine.
    """
    if not (isinstance(T, (int, float)) and math.isfinite(T) and T > 0):
        raise ValueError(f"T must be finite and positive. Current value: {T}")
    T = float(T)
    if n_samples < n_batches * 2:
        raise ValueError(
            f"n_samples={n_samples} must be at least 2 * n_batches="
            f"{2 * n_batches} for the batch-means ESS estimator"
        )
    x, v, _squeeze = _prep_init(sampler, xinit, vinit)
    if dtype is None:
        dtype = torch.get_default_dtype()
    B, d = x.shape
    if mesh is None:
        parts = [(resolve_device(device), 0, B)]
        dist_on, path, group = False, checkpoint_path, None
    else:
        ranges = mesh_lib.chain_sharding(mesh, B)
        parts = [(dv, *ranges[g]) for dv, g in zip(mesh.devices, mesh.local_shards())]
        dist_on, group = mesh.distributed, mesh.chain_group
        path = process_path(checkpoint_path, mesh)
    dev = parts[0][0]
    B_local = parts[0][2] - parts[0][1]
    n_burnin = int(burnin_frac * n_samples)
    dt_grid = T / n_samples
    x_ref = np.asarray(x.mean(axis=0), np.float32)

    if t_cap is None:
        # a fill plus the fold's gather temporaries: ~3 fill-sized buffers
        budget_rows = int(_device_bytes_budget(dev) / max(B_local * _row_bytes(d, dtype), 1) / 3)
        t_cap = max(256, min(8192, budget_rows // 256 * 256))
    G = int(grid_chunk)
    T32 = np.float32(T)
    dt32 = np.float32(dt_grid)
    runner = fill_runner(sampler, pick_backend(sampler, backend, d, dtype, dev),
                         t_cap, t_cap, chunk, tile, mode="horizon")
    fold = make_fold_chunk(sampler, G, n_samples, n_batches, n_burnin, dt_grid, x_ref)

    if mesh is None:
        states = [sampler.init_state_batch(x, v, seed, dtype, dev)]
    else:
        keys = rng.split(as_key(seed, "cpu"), B)
        states = [sampler.init_state_batch(x[lo:hi], v[lo:hi], None, dtype, dv,
                                           keys=keys[lo:hi].to(dv)) for dv, lo, hi in parts]
    stats = [empty_stats(hi - lo, d, n_batches, st.x.dtype, dv)
             for st, (dv, lo, hi) in zip(states, parts)]
    j_done = [torch.zeros((hi - lo,), dtype=torch.int32, device=dv) for dv, lo, hi in parts]
    zeros = [torch.zeros_like(j) for j in j_done]
    events = 0
    fills = 0
    ck_meta = {"T": T, "n_samples": int(n_samples), "n_batches": int(n_batches),
               "n_burnin": int(n_burnin), "shape": [B, d], "x_ref": x_ref.tolist(),
               "seed": _seed_meta(seed)}
    if path:
        loaded = _load_streaming_checkpoint(path, ck_meta, "cpu")
        if loaded is not None:
            state, stat, meta = loaded
            events, fills = int(meta["events"]), int(meta["fills"])
            cursor = torch.tensor(meta["cursor"], dtype=torch.int32)
            off = 0
            for i, (dv, lo, hi) in enumerate(parts):
                part = slice(off, off + hi - lo)
                off += hi - lo
                states[i] = PDMPState(*(a[part].to(dv) for a in state))
                stats[i] = StreamingStats(*(a[part].to(dv) for a in stat))
                j_done[i] = cursor[part].to(dv)

    def reduce_max(vals):
        """Flags and negated minima over every process of the mesh."""
        t = torch.tensor(vals, dtype=torch.float64)
        return (distributed.all_reduce(t, torch.distributed.ReduceOp.MAX, group)
                if dist_on else t).tolist()

    def gathered():
        """Every chain's accumulators, in global order, on ``dev``."""
        out = cat_chains(stats, dev)
        return (StreamingStats(*(distributed.all_gather_rows(a, group) for a in out))
                if dist_on else out)

    def one_fill(i, j_min):
        """One shard's fill and its fold (the JAX package's ``program``,
        ``streaming.py:371-413``): the clock target capped so that every
        chain's grid advance stays inside its fold window ``[j_done, j_done
        + G)`` (the slack of G // 4 points absorbs the sub-transition
        overshoot of the halt test), then the cursor bookkeeping.  ``j_min``
        is the least cursor of the whole batch.  ``(events, transitions,
        advanced, all done, overflow)``."""
        dv, state = parts[i][0], states[i]
        anchor = _anchor_from_state(state)
        cap_pts = np.float32(j_min + G - max(1, G // 4))
        tt_eff = min(T32, cap_pts * dt32)             # float32, as JAX computes it
        res = runner(state, zeros[i], float(tt_eff))
        ns = res.state
        traj = ns.t + ns.ts
        done = ns.t >= torch.tensor(float(T32), dtype=ns.t.dtype, device=dv)
        j_hi = torch.clamp_max(torch.floor(div_once(traj, dt_grid)).to(torch.int32),
                               n_samples)
        j_hi = torch.where(done, n_samples, j_hi)
        j_hi = torch.maximum(j_hi, j_done[i])
        stats[i] = fold(stats[i], res.fill, anchor, res.transitions, j_done[i], j_hi)
        covered = j_done[i] + G
        j_new = torch.minimum(j_hi, covered)
        flags = (res.transitions > 0, bool((j_new > j_done[i]).any()), bool(done.all()),
                 bool((j_hi > covered).any()))
        states[i], j_done[i] = ns, j_new
        return int(res.counts.sum()), flags

    K = 8 if dev.type == "cuda" else 2
    if checkpoint_path:
        K = min(K, max(1, int(checkpoint_every)))
    groups = 0
    save_every_groups = max(1, -(-int(checkpoint_every) // K))
    j_min = -reduce_max([-min(int(j.min()) for j in j_done)])[0]
    while True:
        overflow = stalled = False
        ev_group = 0
        for _ in range(K):
            flags = []
            for i in range(len(parts)):
                with mesh_lib.on_device(parts[i][0]):
                    ev, f = one_fill(i, int(j_min))
                ev_group += ev
                flags.append(f)
            moved, advanced, _, overflowed = (any(f) for f in zip(*flags))
            fill_done = all(f[2] for f in flags)
            neg_j, moved, advanced, not_done, overflowed = reduce_max(
                [-min(int(j.min()) for j in j_done), moved, advanced, not fill_done,
                 overflowed])
            j_min = -neg_j
            overflow = overflow or bool(overflowed)
            stalled = stalled or not (moved or advanced or not not_done)
        t_h = np.concatenate([st.t.cpu().numpy() for st in states])
        j_h = np.concatenate([j.cpu().numpy() for j in j_done])
        tally = [ev_group, int((t_h < T).sum())]
        if dist_on:
            tally = distributed.all_reduce(torch.tensor(tally), group=group).tolist()
        events += tally[0]
        all_done = tally[1] == 0
        fills += K
        _fail_after_fills(fills)
        groups += 1
        if overflow:
            raise RuntimeError(
                "streaming grid coverage overflow: a fill advanced a "
                f"chain's sample grid by more than grid_chunk={G} points "
                "past the fill's clock cap (an engine invariant — please "
                "report); rerun with a larger grid_chunk as a workaround"
            )
        grid_done = j_min >= n_samples
        if verbose:
            print(f"[streaming] fill {fills}: t={t_h.min():.4g}/{T} grid "
                  f"{int(j_h.min())}/{n_samples} (chains done: {int((t_h >= T).sum())}/"
                  f"{len(t_h)})")
        if (path and groups % save_every_groups == 0
                and not (all_done and grid_done)):
            _save_streaming_checkpoint(
                path, cat_chains(states, "cpu"), cat_chains(stats, "cpu"),
                dict(ck_meta, events=events, fills=fills, cursor=j_h.tolist()))
        if all_done and grid_done:
            break
        if (stop_when_converged and groups % max(1, int(check_every)) == 0
                and j_min > n_burnin):
            every = gathered()
            if float(min_ess) > 0:
                summ = streaming_summary(StreamingRun(every, states[0], events, fills,
                                                      n_samples, n_burnin, x_ref))
                gated = (summ["converged"]
                         and summ["ess_total_worst_coord"] >= float(min_ess))
                rhat_max = summ["rhat_max"]
            else:
                # R-hat alone needs only the half sufficient statistics
                rhat_max = float(_rhat_from_half_stats(
                    *(a.cpu().numpy() for a in every[:3])).max())
                gated = rhat_max < RHAT_THRESHOLD
            if gated:
                if verbose:
                    print(f"[streaming] early stop at fill {fills}: "
                          f"rhat_max={rhat_max:.4f}")
                break
        if stalled:
            raise RuntimeError("streaming sampling made no progress")
    state = cat_chains(states, dev)
    sampler.state = state
    return StreamingRun(gathered(), state, events, fills, n_samples, n_burnin, x_ref)


def _rhat_from_half_stats(n_h, sum_h, sq_h):
    """Split-R-hat over the 2B half-chains from (count, sum, sum of squares)
    sufficient statistics (float64; the ``diagnostics.split_rhat`` formula
    with equal half lengths by grid design)."""
    n_h = np.asarray(n_h, np.float64)
    sum_h = np.asarray(sum_h, np.float64)
    sq_h = np.asarray(sq_h, np.float64)
    B = n_h.shape[0]
    d = sum_h.shape[-1]
    n_safe = np.maximum(n_h, 1.0)[:, :, None]
    mu_h = sum_h / n_safe
    var_h = np.maximum(
        (sq_h - sum_h * mu_h) / np.maximum(n_h[:, :, None] - 1.0, 1.0), 0.0
    )
    n_half = float(np.maximum(n_h.mean(), 2.0))
    seq_mu = mu_h.reshape(2 * B, d)
    W = var_h.reshape(2 * B, d).mean(axis=0)
    B_var = n_half * seq_mu.var(axis=0, ddof=1)
    var_plus = (n_half - 1.0) / n_half * W + B_var / n_half
    return np.sqrt(np.where(W > 0, var_plus / np.where(W > 0, W, 1.0), 1.0))


def streaming_summary(run: StreamingRun, x_ref=None,
                      rhat_threshold: float | None = None) -> dict:
    """Finalize a :class:`StreamingRun` into moments, split-R-hat and the
    batch-means ESS aggregate (float64, host), with the fields of
    ``diagnostics.ess_summary`` plus per-chain moments.

    ``x_ref`` defaults to the centering offset recorded on the run, so means
    come back in the original coordinates."""
    if rhat_threshold is None:
        rhat_threshold = RHAT_THRESHOLD
    if x_ref is None:
        x_ref = run.x_ref
    s = StreamingStats(*(a.detach().cpu().numpy() for a in run.stats))
    n_h = np.asarray(s.n_half, np.float64)          # (B, 2)
    sum_h = np.asarray(s.sum_half, np.float64)      # (B, 2, d)
    sq_h = np.asarray(s.sumsq_half, np.float64)
    bsum = np.asarray(s.bsum, np.float64)           # (B, M, d)
    bcount = np.asarray(s.bcount, np.float64)
    B, M, d = bsum.shape

    n_tot = n_h.sum(axis=1)                         # (B,)
    mean_c = sum_h.sum(axis=1) / np.maximum(n_tot, 1.0)[:, None]  # centered
    var_c = np.maximum(
        (sq_h.sum(axis=1) - n_tot[:, None] * mean_c ** 2)
        / np.maximum(n_tot - 1.0, 1.0)[:, None],
        0.0,
    )

    rhat = _rhat_from_half_stats(s.n_half, s.sum_half, s.sumsq_half)

    # batch-means ESS per chain and coordinate; only (near) fully populated
    # windows enter the between-window variance, so an early-stopped run's
    # empty or partial trailing windows do not corrupt it
    full = bcount >= np.maximum(
        0.75 * bcount.max(axis=1, keepdims=True), 1.0)  # (B, M)
    m_eff = np.maximum(full.sum(axis=1), 2.0)           # (B,)
    bc = np.maximum(bcount, 1.0)[:, :, None]
    bmu = np.where(full[:, :, None], bsum / bc, 0.0)    # (B, M, d)
    bmean = bmu.sum(axis=1) / m_eff[:, None]            # (B, d)
    var_bm = (np.where(full[:, :, None],
                       (bmu - bmean[:, None, :]) ** 2, 0.0).sum(axis=1)
              / np.maximum(m_eff - 1.0, 1.0)[:, None])  # (B, d)
    L = (np.where(full, bcount, 0.0).sum(axis=1)
         / m_eff)[:, None]                              # mean window length
    L = np.maximum(L, 1.0)
    n_used = (m_eff * L[:, 0])[:, None]                 # samples in the estimate
    ess = np.where(
        var_bm > 0,
        np.maximum(n_used, 1.0) * var_c / (L * np.where(
            var_bm > 0, var_bm, 1.0)),
        np.maximum(n_used, 1.0),
    )                                                   # (B, d)
    per_coord = ess.sum(axis=0)

    mean = mean_c + np.asarray(x_ref)
    return {
        "mean": mean,                               # (B, d)
        "var": var_c,                               # (B, d)
        "pooled_mean": mean.mean(axis=0),
        "pooled_var": (var_c + (mean - mean.mean(axis=0)) ** 2).mean(axis=0),
        "ess": ess,                                 # (B, d)
        "ess_per_coord": per_coord,
        "ess_total_worst_coord": float(per_coord.min()),
        "rhat": rhat,
        "rhat_max": float(rhat.max()),
        "converged": bool(rhat.max() < rhat_threshold),
        "n_samples_used": float(n_tot.sum()),
    }

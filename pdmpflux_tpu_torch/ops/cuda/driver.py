"""Stream-fill driver around the chunk kernels (``pdmpflux_tpu/ops/pallas/driver.py``).

:func:`make_stream_runner` is the port of ``make_pallas_stream_runner`` for
the Zig-Zag (K1), the Sticky Zig-Zag (K6), the Speed-Up Zig-Zag (K4) and
the scalar-rate samplers BPS and Boomerang (K3) and Forward ECMC (K5), on a
device tag or on a gradient of the user's own lowered into a generated
potential (``lowered_config``, on the card): a host loop over chunks, one
kernel launch per chunk, each writing its ``K`` transition rows straight
into the raw fill at the chunk's row offset, until every chain has its
target count (event-count mode) or has its committed clock at the target
time (horizon mode, K7), or the fill is full.  The loop reads the per-chain
counts (or clocks) back once per chunk, exactly where the JAX
``while_loop`` tests ``any(count < target)`` (``any(t < t_target)``), so the
number of chunks (and with it the ``fold_in`` key advance) equals the JAX
driver's.
"""

from __future__ import annotations

import torch

from ...core import rng
from ...core.types import PDMPState, StreamResult, empty_fill
from . import lower
from . import scalar_chunk as sc
from . import zigzag_chunk as zc

PALLAS_CONST_GRID = 9
"""Grid points the kernel substitutes for a ``grid_size == 0`` request (the
JAX package's constant, ``driver.py:24``)."""


def kernel_kind(sampler):
    """Which chunk kernel covers the sampler, by exact type (JAX
    ``driver.py:74-88``): ``"zigzag"`` for a Zig-Zag or a Sticky Zig-Zag
    with vectorized bounds (K1, K6), ``"suzz"`` for a Speed-Up Zig-Zag with
    vectorized bounds (K4), ``"bps"`` and ``"boomerang"`` (K3), ``"ecmc"``
    (K5); None otherwise (RHMC, and a Zig-Zag-family sampler with scalar
    bounds, which JAX runs on its XLA engine)."""
    from ...models.boomerang import Boomerang
    from ...models.bps import BPS
    from ...models.ecmc import ForwardECMC
    from ...models.speedup_zigzag import SpeedUpZigZag
    from ...models.sticky import StickyZigZag
    from ...models.zigzag import ZigZag

    if getattr(sampler, "sticky", False):
        if type(sampler) is StickyZigZag and sampler.vectorized_bound:
            return "zigzag"
        return None
    if type(sampler) in (ZigZag, SpeedUpZigZag):
        if not sampler.vectorized_bound:
            return None
        return "suzz" if type(sampler) is SpeedUpZigZag else "zigzag"
    return {BPS: "bps", Boomerang: "boomerang", ForwardECMC: "ecmc"}.get(type(sampler))


def _effective(grad, grad_jvp):
    """The Boomerang's gradient-like map ``grad U(x) - x`` from the device
    potential's ``grad U`` (JAX ``driver.py:450-456``); its derivative
    along ``v`` is ``H v - v``."""
    def grad_eff(x):
        return grad(x) - x

    def grad_eff_jvp(x, v):
        g, dg = grad_jvp(x, v)
        return g - x, dg - v

    return grad_eff, grad_eff_jvp


def chunk_config(sampler, K: int, cap: int, tile: int) -> zc.ChunkConfig:
    kind = kernel_kind(sampler)
    if kind is None:
        raise ValueError(
            f"the fused chunk kernels cover ZigZag, StickyZigZag and "
            f"SpeedUpZigZag with vectorized_bound=True, BPS, Boomerang and "
            f"ForwardECMC; got "
            f"{type(sampler).__name__} with "
            f"vectorized_bound={getattr(sampler, 'vectorized_bound', None)}"
        )
    n_grid = sampler.grid_size if sampler.grid_size >= 2 else PALLAS_CONST_GRID
    potential, params = sampler.device_potential, sampler.device_params
    # K4 and its plain version build the Speed-Up Zig-Zag's effective
    # gradient and its tangent from grad U themselves (a per-chain sum)
    grad_like = sampler._grad_eff if kind == "boomerang" else sampler.grad_U
    grad, grad_jvp = zc.lane_gradients(grad_like, potential, params)
    if kind == "boomerang" and potential is not None:
        grad, grad_jvp = _effective(grad, grad_jvp)
    ecmc = ()
    if kind == "ecmc":
        ecmc = (sampler.ran_p, sampler.mix_p, sampler.switch, sampler.positive,
                sampler.speed_factor, sampler.normal)
    return zc.ChunkConfig(
        n_grid=n_grid, K=K, adaptive=bool(sampler.adaptive),
        signed=bool(sampler.signed_bound),
        refresh_rate=float(sampler.refresh_rate), cap=int(cap), tile=int(tile),
        grad=grad, grad_jvp=grad_jvp, device_potential=potential,
        kappa=sampler.kappa if getattr(sampler, "sticky", False) else None,
        kind=kind,
        # the Boomerang refreshes to N(0, I) (JAX driver.py:100-105)
        gaussian_velocity=kind == "boomerang" or bool(
            getattr(sampler, "gaussian_velocity", False)),
        ecmc_params=ecmc, pot_params=params,
    )


def _per_transition(low: lower.Lowered, kind: str):
    """The plain version's pair along one transition (``lower.Lowered.along``):
    ``(x, v) -> pair(y, w, tau)``, the Boomerang's along its elliptic flow and
    made effective; None where the lowering forms no product once per
    transition."""
    if not low.trans:
        return None
    if kind == "zigzag":  # K1 forms a running sum in its group's lanes
        return lambda x, v: low.along(x, v, parts=zc.lanes_for(x.shape[1]))
    if kind != "boomerang":
        return low.along

    def along(x, v):
        pair = low.along(x, v, elliptic=True)

        def effective(y, w, tau):
            g, dg = pair(y, w, tau)
            return g - y, None if dg is None else dg - w

        return effective

    return along


def lowered_config(cfg: zc.ChunkConfig, sampler, d: int, dtype, device) -> zc.ChunkConfig:
    """``cfg`` of an untagged sampler made the generated potential's: its
    gradient lowered for the kernel (``lower.lower_sampler``, cached on the
    sampler; raises ``LoweringError``), the IR's torch pair as the plain
    version's gradients (the Boomerang's made effective, as a tag's are) and
    its pair along a transition where it forms products once per transition,
    potential id 7 and the hoisted parameters on ``device`` in ``dtype``."""
    low = lower.lower_sampler(sampler, cfg.kind, d, dtype, device)
    grad, grad_jvp = low.grad, low.grad_jvp
    if cfg.kind == "boomerang":
        grad, grad_jvp = _effective(grad, grad_jvp)
    return cfg._replace(
        grad=grad, grad_jvp=grad_jvp, device_potential=lower.USER_POTENTIAL, user=low,
        pot_params=low.params_on(device, dtype) if low.params.numel() else None,
        per_transition=_per_transition(low, cfg.kind))


def chunk_state(state: PDMPState, counts: torch.Tensor,
                sticky: bool = False) -> zc.ChunkState:
    """A batched ``PDMPState`` in the kernels' layout, in fresh tensors that
    the kernels update in place; a sticky chain also carries its activity
    mask.  The copies are explicit: for one chain ``x.T`` is already
    contiguous, and ``contiguous()`` would hand the kernel the state's own
    memory (the caller's initial arrays and the initial record)."""
    dt = state.x.dtype

    def fresh(a):
        return a.T.clone(memory_format=torch.contiguous_format)

    return zc.ChunkState(
        x=fresh(state.x), v=fresh(state.v),
        fs=torch.stack([state.t, state.t_comp, state.ts, state.horizon,
                        state.bound_h, state.exp_rv, state.ar,
                        state.tt]).to(dt),
        iscal=torch.stack([state.mode, state.rejected, state.errored_bound,
                           state.hitting_horizon, counts]).to(torch.int32),
        ring=fresh(state.error_value_ar.to(dt)),
        act=fresh(state.is_active) if sticky else None,
    )


def key_seed(keys: torch.Tensor) -> int:
    """The fill's base seed: the uint32 sum of every chain's key words,
    read as an int32 (``driver.py:535-538``)."""
    return rng.wrap_int32(int(torch.sum(keys).item()))


def make_stream_runner(sampler, t_cap: int, n_events_target: int,
                       chunk: int = 32, tile: int = 128, mode: str = "events"):
    """``run(state, counts, t_target=None) -> StreamResult``: one stream fill
    of at most ``t_cap`` rows.  ``tile`` is the RNG lane tile (the Pallas
    launch's lane tile), which fixes the random stream, not how the kernel is
    launched; ``B`` need not be a multiple of it.

    ``mode="horizon"`` (K7) runs chunks until every chain's committed clock
    reaches the runtime ``t_target``, read as float32 as the JAX driver reads
    it (``driver.py:539-549``); ``n_events_target`` then only caps a fill's
    events per chain."""
    if t_cap % chunk:
        raise ValueError(f"t_cap={t_cap} must be a multiple of chunk={chunk}")
    if mode not in ("events", "horizon"):
        raise ValueError(f"mode must be 'events' or 'horizon', not {mode!r}")
    cfg = chunk_config(sampler, chunk, n_events_target, tile)
    run_chunk = sc.run_chunk if cfg.kind in sc.KINDS else zc.run_chunk
    n_chunks = t_cap // chunk

    def run(state: PDMPState, counts: torch.Tensor,
            t_target=None) -> StreamResult:
        B, d = state.x.shape
        dev, dt = state.x.device, state.x.dtype
        st = chunk_state(state, counts, cfg.sticky)
        fill = empty_fill(t_cap, d, B, dt, dev, cfg.sticky)
        # kappa and the potential's parameters in the state's dtype, on its
        # device, once per fill; the horizon target rounded to float32
        run_cfg = cfg._replace(
            kappa=None if cfg.kappa is None else cfg.kappa.to(dev, dt),
            pot_params=None if cfg.pot_params is None else cfg.pot_params.to(dev, dt),
            t_target=zc.f32_target(t_target) if mode == "horizon" else None)
        if cfg.device_potential is None and dev.type == "cuda":
            # a gradient of the user's own: its generated potential on the card
            run_cfg = lowered_config(run_cfg, sampler, d, dt, dev)

        def live_any():
            # the committed clock fs[F_T], not the row time t + ts
            if run_cfg.horizon:
                return bool((st.fs[zc.F_T] < run_cfg.t_target).any())
            return bool((st.iscal[zc.I_CNT] < n_events_target).any())

        seed0 = key_seed(state.key)
        it = 0
        while it < n_chunks and live_any():
            run_chunk(rng.wrap_int32(seed0 + it * 1000003), st, fill,
                      it * chunk, run_cfg)
            it += 1
        fs = st.fs
        new_state = state._replace(
            x=st.x.T, v=st.v.T, t=fs[zc.F_T], t_comp=fs[zc.F_TC],
            ts=fs[zc.F_TS], horizon=fs[zc.F_H], bound_h=fs[zc.F_BH],
            exp_rv=fs[zc.F_EXP], ar=fs[zc.F_AR], tt=fs[zc.F_TT],
            mode=st.iscal[zc.I_MODE], rejected=st.iscal[zc.I_REJ],
            errored_bound=st.iscal[zc.I_ERR],
            hitting_horizon=st.iscal[zc.I_HIT],
            error_value_ar=st.ring.T,
            is_active=st.act.T if cfg.sticky else state.is_active,
            key=rng.fold_in(state.key, it),
        )
        rows = it * chunk
        return StreamResult(new_state, fill.head(rows), st.iscal[zc.I_CNT],
                            rows)

    return run

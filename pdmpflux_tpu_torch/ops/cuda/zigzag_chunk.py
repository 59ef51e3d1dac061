"""K1, K6 and K4: a chunk of ``K`` fused Zig-Zag-family transitions per chain.

Replaces ``pdmpflux_tpu/ops/pallas/zigzag_chunk.py:run_chunk`` with
``kind="zigzag"``: K1 for ``sticky=False``, K6 for ``sticky=True``; and with
``kind="suzz"``, the Speed-Up Zig-Zag: K4.  Each runs in ``mode="events"``
and, with ``ChunkConfig.t_target`` set, ``mode="horizon"`` (K7: a lane also
freezes once its committed clock reaches the float32 target).  Each of the
``K`` transitions builds the grid envelope with time tangents, inverts the
Poisson clock, runs the thinning test, flows, flips one coordinate, commits
the Kahan clock, adapts the horizon and emits one event row.  The sticky
variant also carries the activity mask and the thaw clock: rates and flows
use the masked velocity, a fresh proposal whose flow would cross an axis
sticks the first coordinate to reach it, a thaw clock below the proposal
releases a frozen coordinate drawn in proportion to ``kappa``, and every row
records the activity mask.  The Speed-Up Zig-Zag flows along the closed-form
speed-change flow (``ops/flows.suzz_flow``, every live lane, at ``t = 0``
too) and takes its rates and flips on the effective gradient
``s grad U(x) - x / s``, whose time derivative along the flow is written out
in closed form (``_suzz_rates``) where JAX takes ``jax.jvp``; its sums over
coordinates are added in coordinate order, as K4 adds them.

Two versions of the same function live here:

* :func:`run_chunk_plain`, plain PyTorch on ``(d, B)`` chain-minor tensors,
  operation for operation the Pallas body (``_make_kernel``), sticky and
  Speed-Up branches included.  It draws the same Threefry counters, so on
  the same state it reproduces the Pallas kernel trajectory by trajectory.
* the CUDA kernels: ``csrc/zigzag_chunk.cu`` (K1, a group of lanes per
  chain), ``csrc/sticky_chunk.cu`` (K6, one CTA per chain) and
  ``csrc/suzz_chunk.cu`` (K4, one warp per chain, the envelope's grid points
  across its lanes).

:func:`run_chunk` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.

Layouts (kernel layout, chains on the minor axis): state ``x``/``v``
``(d, B)``, ``fs`` ``(8, B)`` float rows ``[t, t_comp, ts, horizon,
bound_h, exp_rv, ar, tt]``, ``iscal`` ``(5, B)`` int32 rows ``[mode,
rejected, errored, hitting, count]``, ``ring`` ``(5, B)``, and for sticky
chains ``act`` ``(d, B)`` bool.  A chunk writes rows ``row0 .. row0 + K - 1``
of a ``core.types.RawFill`` (re-exported here with ``empty_fill``); state
tensors update in place.
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple, Optional

import torch

from ...core import rng
from ...core.types import (
    ERROR_RING_SIZE,
    EV_JUMP,
    EV_STICK,
    EV_THAW,
    MODE_ERRONEOUS,
    MODE_FRESH,
    MODE_REJECTED,
    RawFill,
    empty_fill,  # noqa: F401 (re-exported)
)
from ...utils.potentials import DEVICE_POTENTIALS, LANE_POTENTIALS
from ..flows import div_once, ordered_sum, suzz_flow, suzz_flow_tangent
from . import build, lower

F_T, F_TC, F_TS, F_H, F_BH, F_EXP, F_AR, F_TT = range(8)
NF = 8
I_MODE, I_REJ, I_ERR, I_HIT, I_CNT = range(5)
NI = 5

HORIZON_GROW = 1.01
HORIZON_SHRINK = 1.04
MAX_GRID = 64
"""Most envelope grid points the CUDA kernels keep per chain."""
KERNEL_POTENTIALS = tuple(sorted(DEVICE_POTENTIALS))
"""Device potentials every chunk kernel (K1, K6, K4, K3/K5) implements."""


class ChunkState(NamedTuple):
    """Per-chain state in kernel layout (see the module docstring); ``act``
    is None for a non-sticky chain."""

    x: torch.Tensor
    v: torch.Tensor
    fs: torch.Tensor
    iscal: torch.Tensor
    ring: torch.Tensor
    act: Optional[torch.Tensor] = None


class ChunkConfig(NamedTuple):
    """Static parameters of a chunk kernel (the Pallas kernel's static
    arguments): K1/K6 for ``kind="zigzag"``, K4 for ``"suzz"``, K3/K5
    (``scalar_chunk``) for ``"bps"``, ``"boomerang"`` and ``"ecmc"``.  K4
    takes the raw ``grad U`` and its ``H v`` and builds the effective
    gradient itself."""

    n_grid: int
    K: int
    adaptive: bool
    signed: bool
    refresh_rate: float
    cap: int
    tile: int
    grad: Callable                      # (d, B) -> (d, B) gradient
    grad_jvp: Callable                  # (x, v) -> (grad(x), H(x) v)
    device_potential: Optional[str]     # potential tag the CUDA kernels take
    kappa: Optional[torch.Tensor] = None  # (d,) thaw rates; None: not sticky
    kind: str = "zigzag"
    gaussian_velocity: bool = False     # K3: N(0, I) refresh, not unit
    ecmc_params: tuple = ()             # K5: (ran_p, mix_p, switch, positive, speed_factor, normal)
    pot_params: Optional[torch.Tensor] = None  # the device potential's parameters
    t_target: Optional[float] = None    # K7: float32 clock target; None: events mode
    user: Optional[object] = None       # lower.Lowered: a generated potential ("user")
    # the plain version's pair along one transition: (x, v) at its start ->
    # pair(y, w, tau) -> (grad, H v) at the point (y, w) reached at times tau,
    # the products formed once per transition (lower.Lowered.along); None:
    # grad_jvp at each point
    per_transition: Optional[Callable] = None

    @property
    def sticky(self) -> bool:
        return self.kappa is not None

    @property
    def horizon(self) -> bool:
        """``mode="horizon"`` (K7): a lane also freezes once its committed
        clock reaches ``t_target``."""
        return self.t_target is not None

    def launch_args(self) -> tuple:
        """The horizon flag and float32 target every CUDA chunk launcher
        takes after the seed."""
        return (ctypes.c_int(int(self.horizon)),
                ctypes.c_float(self.t_target if self.horizon else 0.0))


def f32_target(T: float) -> float:
    """``T`` rounded to float32: the Pallas kernel and the JAX driver's chunk
    loop read the horizon target as a float32 scalar whatever the state's
    dtype (``zigzag_chunk.py:986``, ``driver.py:539-544``)."""
    return float(torch.tensor(float(T), dtype=torch.float32))


def lanes_for(B: int) -> int:
    """K1's lanes per chain at ``B`` chains (``lanes_for`` in
    ``csrc/zigzag_chunk.cu``): the fewest of 2-16 that give the card 12
    warps per SM."""
    L = 2
    while L < 16 and B * L < 132 * 12 * 32:
        L *= 2
    return L


def live_lanes(cnt: torch.Tensor, t: torch.Tensor, cfg: ChunkConfig) -> torch.Tensor:
    """Lanes that run their next transition (``zigzag_chunk.py:341-343``):
    below the event cap and, in horizon mode, with the committed clock below
    the target (a NaN clock freezes, as there)."""
    live = cnt < cfg.cap
    return live & (t < cfg.t_target) if cfg.horizon else live


def lane_gradients(grad_U: Callable, device_potential: Optional[str],
                   params: Optional[torch.Tensor] = None):
    """Chain-minor ``(grad, grad_jvp)`` for the plain version: the device
    potential's own formulas when tagged, else ``torch.func`` on the
    per-chain ``grad_U``."""
    if device_potential in LANE_POTENTIALS:
        return LANE_POTENTIALS[device_potential](params)
    grad = torch.func.vmap(grad_U, in_dims=1, out_dims=1)
    return grad, lambda x, v: torch.func.jvp(grad, (x,), (v,))


def _suzz_grad_eff(grad, x):
    """The Speed-Up Zig-Zag's effective gradient ``s grad U(x) - x / s``,
    ``s = sqrt(1 + |x|^2)``, of ``(d, N)`` chains."""
    s = torch.sqrt(1.0 + ordered_sum(x * x, 0))
    return s * grad(x) - x / s


def _suzz_rates(grad_jvp, xt, v, phi):
    """The Speed-Up Zig-Zag's signed rates ``grad_eff(x_t) v`` of ``(d, N)``
    chains at ``x_t`` and their time derivatives along the flow, where
    ``dx_t/dt = phi v``: in closed form,
    ``d grad_eff / dt = phi (s H v + g (x.v) / s - v / s + x (x.v) / s^3)``
    at ``x_t``, from the gradient ``g`` and ``H v`` there."""
    g, hv = grad_jvp(xt, v)
    s = torch.sqrt(1.0 + ordered_sum(xt * xt, 0))
    xvs = ordered_sum(xt * v, 0) / s
    xvs3 = xvs / (s * s)
    dge = phi * (s * hv + g * xvs - v / s + xt * xvs3)
    return (s * g - xt / s) * v, dge * v


def _grid_rates(cfg, x, v, step, n_grid, pair=None):
    """Per-coordinate rates along the flow at the grid times
    ``t_j = step * j`` and their time derivatives, ``(n_grid, d, B)`` each,
    from one gradient call over all grid points: ``grad(x + v t_j) * v`` on
    the linear flow (``pair``: the transition's pair, its per-transition
    products read at ``t_j``), the effective gradient's along the
    speed-change flow (``kind="suzz"``).  Unsigned rates take the derivative
    of ``max(r, 0)`` as JAX's JVP does (half the tangent at ``r == 0``)."""
    d, B = x.shape
    js = torch.arange(n_grid, dtype=x.dtype, device=x.device)[:, None, None]
    t = step[None, None, :] * js                                  # (n_grid, 1, B)
    lanes = lambda a: a.permute(1, 0, 2).reshape(a.shape[1], n_grid * B)  # noqa: E731
    vl = lanes(v[None].expand(n_grid, d, B))
    if cfg.kind == "suzz":
        xt, phi = suzz_flow_tangent(x[None], v[None], t, dim_axis=1)
        r, dr = _suzz_rates(cfg.grad_jvp, lanes(xt), vl, lanes(phi))
    else:
        xt = lanes(x[None] + v[None] * t)
        g, dg = (cfg.grad_jvp(xt, vl) if pair is None else
                 pair(xt, vl, t.expand(n_grid, 1, B).reshape(-1)))
        r, dr = g * vl, dg * vl
    r = r.reshape(d, n_grid, B).permute(1, 0, 2)
    dr = dr.reshape(d, n_grid, B).permute(1, 0, 2)
    if cfg.signed:
        return r, dr
    one, half, zero = (torch.ones_like(r), torch.full_like(r, 0.5),
                       torch.zeros_like(r))
    coef = torch.where(r > 0, one, torch.where(r == 0, half, zero))
    return torch.maximum(r, zero), dr * coef


def flow_and_rates(cfg):
    """A zigzag-family kind's ``flow(x, va, t) -> x_t``, its signed flip
    rates ``rates(x_t, va) -> (d, B)`` and its sum over coordinates: the
    linear flow on ``grad U`` (K1, K6), or the speed-change flow on the
    effective gradient with sums in coordinate order (K4)."""
    if cfg.kind == "suzz":
        return (lambda x, va, t: suzz_flow(x, va, t, 0)[0],
                lambda xt, va: _suzz_grad_eff(cfg.grad, xt) * va,
                lambda a: ordered_sum(a, 0)[0])
    return (lambda x, va, t: x + va * t, lambda xt, va: cfg.grad(xt) * va,
            lambda a: torch.sum(a, dim=0))


def _categorical_rows(w, u):
    """Per-chain inverse-CDF draw over rows, ``P(i) = w[i] / sum(w)``
    (``zigzag_chunk._categorical_rows``): count ``c <= u * c[d-1]`` over the
    inclusive prefix sums, clamped to ``d - 1``."""
    d = w.shape[0]
    c = torch.cumsum(w, dim=0)
    m = torch.sum((c <= (u * c[d - 1])[None, :]).to(torch.int32), dim=0)
    return torch.clamp_max(m, d - 1)


def run_chunk_plain(seed: int, st: ChunkState, fill: RawFill, row0: int,
                    cfg: ChunkConfig) -> None:
    """Plain PyTorch version of K1, K6 and K4; runs on any device."""
    x, v, fs, iscal, ring, act = st
    sticky = cfg.sticky
    d, B = x.shape
    dt = x.dtype
    n_grid, G = cfg.n_grid, cfg.n_grid - 1
    flow, rates, coord_sum = flow_and_rates(cfg)
    seeds = rng.lane_seeds(seed, B, cfg.tile, x.device)
    iota_d = torch.arange(d, device=x.device)[:, None]
    zero = torch.zeros((B,), dtype=dt, device=x.device)
    izero = torch.zeros((B,), dtype=torch.int32, device=x.device)
    inf = torch.full((B,), float("inf"), dtype=dt, device=x.device)
    no = torch.zeros((B,), dtype=torch.bool, device=x.device)
    if sticky:
        kappa = cfg.kappa.to(device=x.device, dtype=dt)[:, None]   # (d, 1)

    for k in range(cfg.K):
        t_s, tc_s, ts_s, h_s, bh_s, exp_s, ar_s, tt_s = (fs[i].clone()
                                                          for i in range(NF))
        mode_s, rej, err, hit, cnt = (iscal[i].clone() for i in range(NI))
        ring0 = ring.clone()
        act0 = act.clone() if sticky else None
        live = live_lanes(cnt, t_s, cfg)
        va = v * act0.to(dt) if sticky else v
        # the products formed once per transition (a generated potential on
        # K1), read at each point's time tau
        pair = None if cfg.per_transition is None else cfg.per_transition(x, va)

        def rates_at(xt, tau):
            return rates(xt, va) if pair is None else pair(xt, None, tau)[0] * va

        # ---- envelope on [0, bh]: tangent-intersection segment maxima ----
        step = div_once(bh_s, G)
        f_all, g_all = _grid_rates(cfg, x, va, step, n_grid, pair)
        box = []
        f_prev = g_prev = None
        for j in range(n_grid):
            f_j, g_j = f_all[j], g_all[j]
            if j > 0:
                den = g_j - g_prev
                num = f_prev - f_j + g_j * step
                ip = torch.where(den == 0, torch.zeros_like(num),
                                 num / torch.where(den == 0,
                                                   torch.ones_like(den), den))
                ip = torch.where(torch.isnan(ip), torch.zeros_like(ip), ip)
                ip = torch.minimum(torch.maximum(ip, torch.zeros_like(ip)),
                                   step.expand_as(ip))
                inter = f_prev + g_prev * ip
                seg = torch.maximum(torch.maximum(f_prev, f_j),
                                    torch.maximum(inter, torch.zeros_like(inter)))
                box.append(coord_sum(seg) + cfg.refresh_rate)
            f_prev, g_prev = f_j, g_j
        cum = [zero]
        for j in range(G):
            cum.append(cum[-1] + box[j] * step)

        # ---- invert the envelope at the Exp clock ----
        idx = sum((c < exp_s).to(torch.int32) for c in cum)
        overflow = idx >= n_grid
        tp = inf
        lam_bar = box[G - 1]
        for j in range(1, n_grid):
            sel = idx == j
            lo, hi = cum[j - 1], cum[j]
            denom = torch.where(hi == lo, torch.ones_like(hi), hi - lo)
            tpj = step * (j - 1) + (exp_s - lo) / denom * step
            tp = torch.where(sel, tpj, tp)
            lam_bar = torch.where(sel, box[j - 1], lam_bar)

        fresh = mode_s == MODE_FRESH
        erroneous = mode_s == MODE_ERRONEOUS
        tp_safe = torch.where(overflow, zero, tp)

        # ---- thinning at tp on the unsigned rate ----
        lam_t = coord_sum(torch.clamp_min(rates_at(flow(x, va, tp_safe), tp_safe), 0.0))
        ar_new = lam_t / lam_bar

        # ---- sticky: thaw clock and the axis crossing at fresh proposals ----
        if sticky:
            min_pt = torch.minimum(tp, tt_s)
            event_time = torch.minimum(min_pt, h_s)
            x_probe = x + va * event_time
            any_crossing = torch.sum((x * x_probe < 0).to(dt), dim=0) > 0
            v_safe = torch.where(va == 0, torch.ones_like(va), va)
            tj = torch.where(act0 & (x * v < 0) & (va != 0), -x / v_safe,
                             torch.full_like(x, float("inf")))
            t_togo = torch.amin(tj, dim=0)
            i_stick = torch.argmin(tj, dim=0)      # first index on ties
            p_stick = fresh & any_crossing & torch.isfinite(t_togo)
        else:
            min_pt = tp
            p_stick = no

        beyond = min_pt > h_s
        p_moveh = ~p_stick & beyond & ~erroneous
        p_erreset = ~p_stick & beyond & erroneous
        thin = ~p_stick & ~beyond
        if sticky:
            p_thaw = thin & (tt_s <= tp)
            p_ac = thin & (tp < tt_s)
        else:
            p_thaw = no
            p_ac = thin
        p_err = p_ac & (ar_new > 1.0)
        p_proxy = p_ac & ~p_err
        u_acc = rng.uniform(seeds, k, 1, cfg.tile, dt)
        u_flip = rng.uniform(seeds, k, 2, cfg.tile, dt)
        acc = u_acc < ar_new
        p_acc = p_proxy & acc
        p_rej = p_proxy & ~acc

        # ---- flow on the masked velocity, then the coordinate flip ----
        flow_t = torch.where(p_moveh, h_s, torch.where(p_acc, tp_safe, zero))
        if sticky:
            flow_t = torch.where(p_stick, t_togo, torch.where(p_thaw, tt_s, flow_t))
        # every live lane flows, at t = 0 too: the speed-change flow is the
        # identity there only up to rounding, as in JAX
        x_new = flow(x, va, flow_t)
        # the latent v survives the flow; flip rates use the old mask
        rates_flip = torch.clamp_min(rates_at(x_new, flow_t), 0.0)
        m = _categorical_rows(rates_flip, u_flip)
        v_new = torch.where((iota_d == m[None, :]) & p_acc[None, :], -v, v)

        # ---- sticky activity updates and the fresh thaw clock ----
        if sticky:
            w_thaw = torch.where(act0, torch.zeros_like(x), kappa.expand(d, B))
            i_thaw = _categorical_rows(w_thaw, rng.uniform(seeds, k, 3, cfg.tile, dt))
            act_new = torch.where(
                (iota_d == i_stick[None, :]) & p_stick[None, :], False,
                torch.where((iota_d == i_thaw[None, :]) & p_thaw[None, :], True, act0))
            rate_thaw = torch.sum(kappa * (1.0 - act_new.to(dt)), dim=0)
            e_tt = rng.exponential(seeds, 0xC0000000 + k, cfg.tile, dt)
            tt_fresh = torch.where(
                rate_thaw > 0,
                e_tt / torch.where(rate_thaw > 0, rate_thaw, torch.ones_like(rate_thaw)),
                inf)

        # ---- Kahan time commit, horizon adaptation ----
        inc_t = tp_safe
        if sticky:
            inc_t = torch.where(p_stick, t_togo, torch.where(p_thaw, tt_s, tp_safe))
        inc = inc_t + ts_s
        y = inc - tc_s
        s_sum = t_s + y
        tc_k = (s_sum - t_s) - y
        is_event = p_acc | p_stick | p_thaw
        t_new = torch.where(is_event, s_sum, t_s)
        tc_new = torch.where(is_event, tc_k, tc_s)
        ts_new = torch.where(is_event, zero,
                             torch.where(p_moveh, ts_s + h_s, ts_s))
        h_new = h_s
        if cfg.adaptive:
            h_new = torch.where(p_moveh & fresh, h_new * HORIZON_GROW, h_new)
            h_new = torch.where(p_err, h_new * 0.5, h_new)
            h_new = torch.where(p_rej, div_once(h_new, HORIZON_SHRINK), h_new)

        # ---- counters, error ring, proposal bookkeeping ----
        hit_new = hit + p_moveh.to(torch.int32)
        rej_new = rej + p_rej.to(torch.int32)
        err_new = err + p_err.to(torch.int32)
        ring_idx = torch.remainder(err_new, ERROR_RING_SIZE)
        slot = torch.arange(ERROR_RING_SIZE, device=x.device)[:, None]
        ring_new = torch.where(p_err[None, :] & (ring_idx[None, :] == slot),
                               ar_new[None, :], ring0)
        reset = p_stick | p_moveh | p_erreset | p_thaw | p_acc
        e_draw = rng.exponential(seeds, 0x80000000 + k, cfg.tile, dt)
        exp_new = torch.where(reset | p_err, e_draw,
                              torch.where(p_rej, exp_s + e_draw, exp_s))
        mode_new = torch.where(
            reset, MODE_FRESH,
            torch.where(p_err, MODE_ERRONEOUS,
                        torch.where(p_rej, MODE_REJECTED, mode_s))).to(torch.int32)
        bh_new = torch.where(reset, h_new, torch.where(p_err, h_s * 0.5, bh_s))
        ar_state = torch.where(p_ac, ar_new, ar_s)
        tt_new = torch.where(reset, tt_fresh, tt_s) if sticky else tt_s

        # ---- freeze finished chains ----
        def keep(new, old):
            return torch.where(live, new, old)

        lv = live[None, :]
        x_new = torch.where(lv, x_new, x)
        v_new = torch.where(lv, v_new, v)
        ring_new = torch.where(lv, ring_new, ring0)
        if sticky:
            act_new = torch.where(lv, act_new, act0)
        t_new, tc_new, ts_new = keep(t_new, t_s), keep(tc_new, tc_s), keep(ts_new, ts_s)
        h_new, bh_new = keep(h_new, h_s), keep(bh_new, bh_s)
        exp_new, ar_state = keep(exp_new, exp_s), keep(ar_state, ar_s)
        tt_new = keep(tt_new, tt_s)
        mode_new = keep(mode_new, mode_s)
        rej_new, err_new, hit_new = keep(rej_new, rej), keep(err_new, err), keep(hit_new, hit)
        is_event = is_event & live
        kval = torch.where(p_acc, EV_JUMP,
                           torch.where(p_stick, EV_STICK,
                                       torch.where(p_thaw, EV_THAW, 0)))
        kval = torch.where(is_event, kval, 0).to(torch.int32)
        cnt_new = cnt + (kval > 0).to(torch.int32)

        # ---- emit the event row ----
        r = row0 + k
        fill.kind[r] = torch.stack([kval, rej_new, err_new, hit_new])
        fill.x[r] = x_new
        fill.v[r] = v_new
        if sticky:
            fill.act[r] = act_new
        fill.fs[r] = torch.stack([t_new + ts_new, h_new, ar_state])
        fill.ring[r] = ring_new

        # counters reset after a recorded event
        rej_new = torch.where(is_event, izero, rej_new)
        err_new = torch.where(is_event, izero, err_new)
        hit_new = torch.where(is_event, izero, hit_new)
        ring_new = torch.where(is_event[None, :], torch.zeros_like(ring_new),
                               ring_new)

        x.copy_(x_new)
        v.copy_(v_new)
        if sticky:
            act.copy_(act_new)
        fs.copy_(torch.stack([t_new, tc_new, ts_new, h_new, bh_new, exp_new,
                              ar_state, tt_new]))
        iscal.copy_(torch.stack([mode_new, rej_new, err_new, hit_new, cnt_new]))
        ring.copy_(ring_new)


def sticky_max_dim(dtype, user=None) -> int:
    """Largest ``d`` K6 takes: its per-chain copy of x, v, kappa, a scan
    buffer and the activity bytes must fit one block's shared memory beside
    its static rows, which a generated potential (``user``, a
    ``lower.Lowered``; its library is built) sizes itself."""
    lib = build.library() if user is None else user.library()
    return int(lib.sticky_chunk_max_dim(int(dtype == torch.float64)))


def potential_message(what: str, potentials, tag) -> str:
    """The error text for a sampler whose device potential (``tag``) the
    CUDA ``what`` kernel does not implement."""
    return (f"the CUDA {what} kernel covers the device potentials "
            f"{list(potentials)} (utils.potentials: gauss, grad_gauss, gauss_1d, "
            "banana, grad_banana, anisotropic_gauss, cauchy, ridged_gauss, funnel, "
            f"neal_funnel) and a generated one ({lower.USER_POTENTIAL!r}, with its "
            f"lowering); this config's is {tag!r} — a gradient of your own takes its "
            "generated potential from driver.lowered_config, which the stream "
            "driver calls on the card")


def check_cuda(st: ChunkState, fill: RawFill, row0: int, cfg: ChunkConfig,
               what: str, potentials) -> None:
    """Raise unless a chunk kernel can run: a device potential in
    ``potentials``, ``n_grid`` in ``[2, MAX_GRID]``, and every state and
    fill tensor contiguous, of the right type and shape, on one card."""
    user = cfg.device_potential == lower.USER_POTENTIAL
    if user and cfg.user is None:
        raise ValueError("a generated potential needs its lowering (ChunkConfig.user)")
    if user and not lower.lane_fits(cfg.user):
        raise ValueError(lower.lane_message(cfg.user))
    if cfg.device_potential not in potentials and not user:
        raise ValueError(potential_message(what, potentials, cfg.device_potential))
    if cfg.device_potential == "aniso" and cfg.pot_params is None:
        raise ValueError("the 'aniso' device potential needs its scales (pot_params)")
    if not 2 <= cfg.n_grid <= MAX_GRID:
        raise ValueError(f"n_grid={cfg.n_grid} outside the kernel's [2, {MAX_GRID}]")
    dtype = st.x.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the CUDA {what} kernel takes float32/float64, not {dtype}")
    d, B = st.x.shape
    want = {
        "x": (st.x, (d, B), dtype), "v": (st.v, (d, B), dtype),
        "fs": (st.fs, (NF, B), dtype), "iscal": (st.iscal, (NI, B), torch.int32),
        "ring": (st.ring, (ERROR_RING_SIZE, B), dtype),
        "ev_kind": (fill.kind, (fill.rows, 4, B), torch.int32),
        "ev_x": (fill.x, (fill.rows, d, B), dtype),
        "ev_v": (fill.v, (fill.rows, d, B), dtype),
        "ev_fs": (fill.fs, (fill.rows, 3, B), dtype),
        "ev_ring": (fill.ring, (fill.rows, ERROR_RING_SIZE, B), dtype),
    }
    if cfg.sticky:
        want.update({
            "act": (st.act, (d, B), torch.bool),
            "kappa": (cfg.kappa, (d,), dtype),
            "ev_act": (fill.act, (fill.rows, d, B), torch.bool),
        })
    if cfg.pot_params is not None:
        want["pot_params"] = (cfg.pot_params,
                              (cfg.user.params.numel(),) if user else (d,), dtype)
    for name, (a, shape, dt) in want.items():
        if a is None or not a.is_cuda or a.device != st.x.device:
            raise ValueError(f"{name} must lie on {st.x.device}")
        if tuple(a.shape) != shape or a.dtype != dt or not a.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {dt} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if row0 < 0 or row0 + cfg.K > fill.rows:
        raise ValueError(f"rows {row0}..{row0 + cfg.K} outside the fill's {fill.rows}")


def kernel_library(cfg: ChunkConfig):
    """The library whose launcher runs ``cfg``: the kernels' own, or for a
    generated potential the one its lowering builds (``lower.Lowered.library``)."""
    return build.library() if cfg.user is None else cfg.user.library()


def potential_id(cfg: ChunkConfig) -> int:
    """The launcher's potential id: the tag's, or 7 for a generated potential."""
    return lower.USER_ID if cfg.user is not None else DEVICE_POTENTIALS[cfg.device_potential]


def launch_name(cfg: ChunkConfig) -> str:
    """The :data:`build.LAUNCHES` key of a K1, K6 or K4 launch (with
    ``_horizon`` in horizon mode)."""
    base = ("suzz_chunk" if cfg.kind == "suzz" else
            "sticky_chunk" if cfg.sticky else "zigzag_chunk")
    return base + ("_horizon" if cfg.horizon else "")


def run_chunk(seed: int, st: ChunkState, fill: RawFill, row0: int,
              cfg: ChunkConfig) -> None:
    """Run ``cfg.K`` transitions: the CUDA kernel (K4 for ``kind="suzz"``,
    K6 when ``cfg.sticky``, else K1) for CUDA tensors, the plain version for
    CPU tensors."""
    if not st.x.is_cuda:
        return run_chunk_plain(seed, st, fill, row0, cfg)
    suzz = cfg.kind == "suzz"
    what = "Speed-Up Zig-Zag" if suzz else "Sticky Zig-Zag" if cfg.sticky else "Zig-Zag"
    check_cuda(st, fill, row0, cfg, what, KERNEL_POTENTIALS)
    d, B = st.x.shape
    if cfg.sticky and d > (max_d := sticky_max_dim(st.x.dtype, cfg.user)):
        raise ValueError(
            f"d={d} exceeds the sticky kernel's {max_d} for {st.x.dtype}: one "
            "chain's x, v, kappa, scan buffer and activity bytes must fit the "
            "227 KB of shared memory a block can have")
    lib = kernel_library(cfg)
    p = ctypes.c_void_p
    r = row0
    head = (
        ctypes.c_int(1 if st.x.dtype == torch.float64 else 0),
        ctypes.c_int(potential_id(cfg)),
        ctypes.c_int(d), ctypes.c_int(B), ctypes.c_int(cfg.K),
        ctypes.c_int(cfg.n_grid), ctypes.c_int(int(cfg.adaptive)),
        ctypes.c_int(int(cfg.signed)), ctypes.c_double(cfg.refresh_rate),
        ctypes.c_int(cfg.cap), ctypes.c_int(cfg.tile),
        ctypes.c_int(rng.wrap_int32(seed)), *cfg.launch_args(),
        p(0 if cfg.pot_params is None else cfg.pot_params.data_ptr()),
        p(st.x.data_ptr()), p(st.v.data_ptr()), p(st.fs.data_ptr()),
        p(st.iscal.data_ptr()), p(st.ring.data_ptr()),
    )
    rows = (p(fill.kind[r].data_ptr()), p(fill.x[r].data_ptr()),
            p(fill.v[r].data_ptr()), p(fill.fs[r].data_ptr()),
            p(fill.ring[r].data_ptr()))
    stream = p(torch.cuda.current_stream(st.x.device).cuda_stream)
    name = launch_name(cfg)
    if cfg.sticky:
        err = lib.sticky_chunk_launch(
            *head, p(st.act.data_ptr()), p(cfg.kappa.data_ptr()), *rows,
            p(fill.act[r].data_ptr()), stream)
    elif suzz:
        err = lib.suzz_chunk_launch(*head, *rows, stream)
    else:
        # the (NP, B) values a generated potential forms once per transition,
        # where K1 reads x and v in place rather than in shared memory
        n_trans = 0 if cfg.user is None else cfg.user.n_trans
        scratch = (torch.empty((n_trans, B), dtype=st.x.dtype, device=st.x.device)
                   if n_trans else None)
        err = lib.zigzag_chunk_launch(*head, *rows,
                                      p(0 if scratch is None else scratch.data_ptr()), stream)
    build.check(err, name, lib)
    build.LAUNCHES[name] += 1

"""K3 and K5: a chunk of ``K`` fused scalar-rate transitions per chain.

Replaces ``pdmpflux_tpu/ops/pallas/zigzag_chunk.py:run_chunk`` with
``kind="bps"`` or ``"boomerang"`` (K3) or ``kind="ecmc"`` (K5): the
``vect=False`` branches of ``_make_kernel``, in ``mode="events"`` and, with
``ChunkConfig.t_target`` set, ``mode="horizon"`` (K7, as in
``zigzag_chunk``).  Each of the ``K`` transitions builds the envelope of the
scalar rate
``<g(x_t), v_t>`` on the grid (tangent-intersection segment maxima, the
refresh rate added once after the max with 0 when signed; unsigned, the rate
is already ``max(<g, v>, 0) + refresh``), inverts the Poisson clock, thins on
``max(0, <g, v>) + refresh``, flows, jumps, commits the Kahan clock, adapts
the horizon and emits one event row.  ``g`` is the gradient for BPS and
Forward ECMC and the effective gradient ``grad U(x) - x`` for the Boomerang,
whose flow is the rotation of ``(x, v)``.  The velocity jumps:

* K3, bounce or refresh: a reflection on ``g`` with probability
  ``max(0, <g, v>) / (max(0, <g, v>) + refresh)`` (uniform row 2), else a
  Box-Muller velocity from rows ``3 .. 3 + 2d``, normalized unless
  ``gaussian_velocity`` (the Boomerang always draws N(0, I));
* K5, the Forward-ECMC gradient-frame jump on ``ecmc_params = (ran_p, mix_p,
  switch, positive, speed_factor, normal)``: rows 2-3 the radial draw, 4 the
  mix, 5 the angle, then Box-Muller blocks from row 6 (the degenerate
  orthogonal component, and one or two Gaussian directions).

Two versions of the same function live here:

* :func:`run_chunk_plain`, plain PyTorch on ``(d, B)`` chain-minor tensors,
  operation for operation the Pallas body on the same Threefry counters, so
  on the same state it reproduces the Pallas kernel trajectory by trajectory;
* the CUDA kernel ``csrc/scalar_chunk.cu`` (one warp per chain, the
  envelope's grid points across its lanes).

:func:`run_chunk` takes the plain version for CPU tensors only; for CUDA
tensors it launches the kernel or raises.  The layouts are those of
``zigzag_chunk`` (``ChunkState``, ``RawFill``, ``empty_fill``).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ...core import rng
from ...core.types import (
    ERROR_RING_SIZE,
    EV_JUMP,
    MODE_ERRONEOUS,
    MODE_FRESH,
    MODE_REJECTED,
)
from ..flows import boomerang_flow, linear_flow, ordered_sum
from . import build
from .zigzag_chunk import (
    F_AR,
    F_BH,
    F_EXP,
    F_H,
    F_T,
    F_TC,
    F_TS,
    F_TT,
    HORIZON_GROW,
    HORIZON_SHRINK,
    I_CNT,
    I_ERR,
    I_HIT,
    I_MODE,
    I_REJ,
    KERNEL_POTENTIALS,
    ChunkConfig,
    ChunkState,
    RawFill,
    check_cuda,
    div_once,
    kernel_library,
    live_lanes,
    potential_id,
)

KINDS = {"bps": 0, "boomerang": 1, "ecmc": 2}
"""Chunk kind -> kind id of the CUDA kernel."""
TWO_PI = 2.0 * math.pi


def launch_name(kind: str) -> str:
    """The :data:`build.LAUNCHES` key of a kind: K3 or K5."""
    return "ecmc_chunk" if kind == "ecmc" else "bps_chunk"


def flow(kind: str, x, v, t):
    """The kind's flow of ``(d, B)`` states by ``(B,)`` times."""
    return (boomerang_flow if kind == "boomerang" else linear_flow)(x, v, t)


def _rate_jvp(kind: str, grad_jvp, x, v, t, pair=None):
    """The signed rate ``<g(x_t), v_t>`` at ``(B,)`` times and its time
    derivative, as ``jax.jvp`` takes them: ``<dg, v_t> + <g, dv_t/dt>`` with
    ``dx_t/dt = v_t``, and ``dv_t/dt = -x_t`` on the elliptic flow;
    ``pair``: the transition's pair, its per-transition products read at
    ``t``."""
    xt, vt = flow(kind, x, v, t)
    g, dg = grad_jvp(xt, vt) if pair is None else pair(xt, vt, t)
    if kind == "boomerang":
        return _dot(g, vt), _sum(dg * vt + g * -xt)
    return _dot(g, vt), _dot(dg, vt)


def _rows(seeds, k: int, row0: int, n: int, tile: int, dt):
    """Uniform rows ``row0 .. row0 + n - 1`` of transition ``k``, ``(n, B)``."""
    rows = torch.arange(row0, row0 + n, device=seeds.device, dtype=torch.int64)
    return rng.uniform(seeds, k, rows[:, None], tile, dt)


def _box_muller(u1, u2):
    return torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(TWO_PI * u2)


def _sum(a):
    """Sum over the coordinate axis, added in coordinate order as the kernel
    adds it, so that both round alike."""
    return ordered_sum(a, 0)[0]


def _dot(a, b):
    return _sum(a * b)


def _normalize(u):
    """Unit columns (zero columns unchanged) and the column norms."""
    n = torch.sqrt(_dot(u, u))
    return u / torch.where(n > 0, n, torch.ones_like(n)), n


def _bounce_or_refresh(cfg: ChunkConfig, g, v, seeds, k, d, dt):
    """K3's jump (``_make_kernel`` ``:587-616``)."""
    br = torch.clamp_min(_dot(g, v), 0.0)
    denom = br + cfg.refresh_rate
    one = torch.ones_like(denom)
    prob = torch.where(denom > 0, br / torch.where(denom > 0, denom, one),
                       torch.zeros_like(denom))
    gg = _dot(g, g)
    scale = 2.0 * _dot(v, g) / torch.where(gg > 0, gg, one)
    v_reflect = torch.where(gg > 0, v - scale * g, v)
    u = _rows(seeds, k, 3, 2 * d, cfg.tile, dt)
    z = _box_muller(u[:d], u[d:])
    if not cfg.gaussian_velocity:
        nrm = torch.sqrt(_dot(z, z))
        z = z / torch.where(nrm > 0, nrm, torch.ones_like(nrm))
    bounce = rng.uniform(seeds, k, 2, cfg.tile, dt) < prob
    return torch.where(bounce, v_reflect, z)


def _ecmc_jump(cfg: ChunkConfig, g, v, seeds, k, d, dt):
    """K5's gradient-frame jump (``_make_kernel`` ``:520-586``)."""
    ran_p, mix_p, switch, positive, sf, normal = cfg.ecmc_params
    u_s = _rows(seeds, k, 2, 4, cfg.tile, dt)           # rows 2..5
    u_bm = _rows(seeds, k, 6, 6 * d, cfg.tile, dt)      # rows 6..6+6d
    n_dir, gn = _normalize(g)
    n_dir = torch.where(gn > 0, n_dir, torch.zeros_like(n_dir))
    vp = _dot(v, n_dir)
    v_o = v - vp * n_dir
    von = torch.sqrt(_dot(v_o, v_o))
    fresh_o = _box_muller(u_bm[:d], u_bm[d:2 * d])
    fresh_o = fresh_o - _dot(fresh_o, n_dir) * n_dir
    v_o = torch.where(von < 1e-10, fresh_o, v_o)
    g1 = _box_muller(u_bm[2 * d:3 * d], u_bm[3 * d:4 * d])
    if switch:
        g2 = _box_muller(u_bm[4 * d:5 * d], u_bm[5 * d:])
        g1p = g1 - _dot(g1, n_dir) * n_dir
        g2p = g2 - _dot(g2, n_dir) * n_dir
        e1, _ = _normalize(g1p)
        e2, _ = _normalize(g2p - _dot(g2p, e1) * e1)
        c1, c2 = _dot(v_o, e1), _dot(v_o, e2)
        v_r = v_o - c1 * e1 - c2 * e2
        if ran_p:
            theta = u_s[3] * TWO_PI
            ct, st = torch.cos(theta), torch.sin(theta)
            v_prop = v_r + (ct * e1 + st * e2) * c1 + (st * e1 - ct * e2) * c2
        else:
            v_prop = v_r + e2 * c1 + e1 * c2
        if positive:
            s = torch.sign(_dot(v_o, v_prop))
            v_prop = v_prop * torch.where(s == 0, torch.ones_like(s), s)
    else:
        gg, _ = _normalize(g1)
        v_prop = gg - _dot(gg, n_dir) * n_dir
    v_o_sel = torch.where(u_s[2] < mix_p, v_prop, v_o)
    v_o_unit, _ = _normalize(v_o_sel)
    if normal:
        rho = sf * -torch.abs(_box_muller(u_s[0], u_s[1]))
        tang = torch.sqrt(torch.clamp_min(sf * sf * _dot(v_o_sel, v_o_sel) - rho * rho, 0.0))
    else:
        rho = sf * -torch.sqrt(1.0 - u_s[0] ** (2.0 / (d - 1)))
        tang = torch.sqrt(torch.clamp_min(sf * sf - rho * rho, 0.0))
    return v_o_unit * tang + rho * n_dir


def run_chunk_plain(seed: int, st: ChunkState, fill: RawFill, row0: int,
                    cfg: ChunkConfig) -> None:
    """Plain PyTorch version of K3 and K5; runs on any device."""
    x, v, fs, iscal, ring, _ = st
    d, B = x.shape
    dt = x.dtype
    n_grid, G = cfg.n_grid, cfg.n_grid - 1
    kind = cfg.kind
    seeds = rng.lane_seeds(seed, B, cfg.tile, x.device)
    zero = torch.zeros((B,), dtype=dt, device=x.device)
    izero = torch.zeros((B,), dtype=torch.int32, device=x.device)
    inf = torch.full((B,), float("inf"), dtype=dt, device=x.device)

    for k in range(cfg.K):
        t_s, tc_s, ts_s, h_s, bh_s, exp_s, ar_s, tt_s = (fs[i].clone() for i in range(8))
        mode_s, rej, err, hit, cnt = (iscal[i].clone() for i in range(5))
        ring0 = ring.clone()
        live = live_lanes(cnt, t_s, cfg)
        # the products formed once per transition (a generated potential),
        # read at each point's time of the transition
        pair = None if cfg.per_transition is None else cfg.per_transition(x, v)

        def grad_at(xt, tau):
            return cfg.grad(xt) if pair is None else pair(xt, None, tau)[0]

        # ---- envelope of the scalar rate on [0, bh] ----
        step = div_once(bh_s, G)
        box = []
        f_prev = g_prev = None
        for j in range(n_grid):
            f_j, g_j = _rate_jvp(kind, cfg.grad_jvp, x, v, step * j, pair)
            if not cfg.signed:  # max(s, 0) + refresh; JAX's max JVP halves at 0
                coef = torch.where(f_j > 0, 1.0, torch.where(f_j == 0, 0.5, 0.0)).to(dt)
                f_j, g_j = torch.clamp_min(f_j, 0.0) + cfg.refresh_rate, g_j * coef
            if j > 0:
                den = g_j - g_prev
                num = f_prev - f_j + g_j * step
                ip = torch.where(den == 0, zero,
                                 num / torch.where(den == 0, torch.ones_like(den), den))
                ip = torch.where(torch.isnan(ip), zero, ip)
                ip = torch.minimum(torch.maximum(ip, zero), step)
                inter = f_prev + g_prev * ip
                seg = torch.maximum(torch.maximum(f_prev, f_j), torch.maximum(inter, zero))
                box.append(seg + cfg.refresh_rate if cfg.signed else seg)
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
            tp = torch.where(sel, step * (j - 1) + (exp_s - lo) / denom * step, tp)
            lam_bar = torch.where(sel, box[j - 1], lam_bar)
        fresh = mode_s == MODE_FRESH
        erroneous = mode_s == MODE_ERRONEOUS
        tp_safe = torch.where(overflow, zero, tp)

        # ---- thinning at tp on max(0, <g, v>) + refresh ----
        xt_p, vt_p = flow(kind, x, v, tp_safe)
        lam_t = torch.clamp_min(_dot(grad_at(xt_p, tp_safe), vt_p), 0.0) + cfg.refresh_rate
        ar_new = lam_t / lam_bar

        beyond = tp > h_s
        p_moveh = beyond & ~erroneous
        p_erreset = beyond & erroneous
        p_ac = ~beyond
        p_err = p_ac & (ar_new > 1.0)
        p_proxy = p_ac & ~p_err
        acc = rng.uniform(seeds, k, 1, cfg.tile, dt) < ar_new
        p_acc = p_proxy & acc
        p_rej = p_proxy & ~acc

        # ---- flow (v too on the elliptic flow), then the velocity jump ----
        flow_t = torch.where(p_moveh, h_s, torch.where(p_acc, tp_safe, zero))
        x_new, v_flow = flow(kind, x, v, flow_t)
        g = grad_at(x_new, flow_t)
        jump = _ecmc_jump if kind == "ecmc" else _bounce_or_refresh
        v_new = torch.where(p_acc, jump(cfg, g, v_flow, seeds, k, d, dt), v_flow)

        # ---- Kahan time commit, horizon adaptation ----
        y = tp_safe + ts_s - tc_s
        s_sum = t_s + y
        tc_k = (s_sum - t_s) - y
        t_new = torch.where(p_acc, s_sum, t_s)
        tc_new = torch.where(p_acc, tc_k, tc_s)
        ts_new = torch.where(p_acc, zero, torch.where(p_moveh, ts_s + h_s, ts_s))
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
        ring_new = torch.where(p_err & (ring_idx == slot), ar_new, ring0)
        reset = p_moveh | p_erreset | p_acc
        e_draw = rng.exponential(seeds, 0x80000000 + k, cfg.tile, dt)
        exp_new = torch.where(reset | p_err, e_draw,
                              torch.where(p_rej, exp_s + e_draw, exp_s))
        mode_new = torch.where(
            reset, MODE_FRESH,
            torch.where(p_err, MODE_ERRONEOUS,
                        torch.where(p_rej, MODE_REJECTED, mode_s))).to(torch.int32)
        bh_new = torch.where(reset, h_new, torch.where(p_err, h_s * 0.5, bh_s))
        ar_state = torch.where(p_ac, ar_new, ar_s)

        # ---- freeze finished chains, emit the event row ----
        def keep(new, old):
            return torch.where(live, new, old)

        x_new, v_new, ring_new = keep(x_new, x), keep(v_new, v), keep(ring_new, ring0)
        t_new, tc_new, ts_new = keep(t_new, t_s), keep(tc_new, tc_s), keep(ts_new, ts_s)
        h_new, bh_new = keep(h_new, h_s), keep(bh_new, bh_s)
        exp_new, ar_state = keep(exp_new, exp_s), keep(ar_state, ar_s)
        mode_new = keep(mode_new, mode_s)
        rej_new, err_new, hit_new = keep(rej_new, rej), keep(err_new, err), keep(hit_new, hit)
        is_event = p_acc & live
        kval = torch.where(is_event, EV_JUMP, 0).to(torch.int32)
        cnt_new = cnt + is_event.to(torch.int32)

        r = row0 + k
        fill.kind[r] = torch.stack([kval, rej_new, err_new, hit_new])
        fill.x[r] = x_new
        fill.v[r] = v_new
        fill.fs[r] = torch.stack([t_new + ts_new, h_new, ar_state])
        fill.ring[r] = ring_new

        # counters reset after a recorded event
        rej_new = torch.where(is_event, izero, rej_new)
        err_new = torch.where(is_event, izero, err_new)
        hit_new = torch.where(is_event, izero, hit_new)
        ring_new = torch.where(is_event, torch.zeros_like(ring_new), ring_new)

        x.copy_(x_new)
        v.copy_(v_new)
        fs.copy_(torch.stack([t_new, tc_new, ts_new, h_new, bh_new, exp_new,
                              ar_state, tt_s]))
        iscal.copy_(torch.stack([mode_new, rej_new, err_new, hit_new, cnt_new]))
        ring.copy_(ring_new)


def scalar_max_dim(dtype, user=None) -> int:
    """Largest ``d`` K3/K5 take: the shared-memory vectors of a block's
    four chains must fit the 227 KB a block can have; a generated potential
    (``user``, a ``lower.Lowered``; its library is built) that forms values
    once per transition keeps them beside one chain's vectors, and its build
    reports its own limit."""
    lib = build.library() if user is None else user.library()
    return int(lib.scalar_chunk_max_dim(int(dtype == torch.float64)))


def run_chunk(seed: int, st: ChunkState, fill: RawFill, row0: int,
              cfg: ChunkConfig) -> None:
    """Run ``cfg.K`` transitions: the CUDA kernel (K3 for ``"bps"`` and
    ``"boomerang"``, K5 for ``"ecmc"``) for CUDA tensors, the plain version
    for CPU tensors."""
    if not st.x.is_cuda:
        return run_chunk_plain(seed, st, fill, row0, cfg)
    if cfg.kind not in KINDS:
        raise ValueError(f"the scalar-rate kernel runs {sorted(KINDS)}, not {cfg.kind!r}")
    check_cuda(st, fill, row0, cfg, "scalar-rate", KERNEL_POTENTIALS)
    d, B = st.x.shape
    if d > (max_d := scalar_max_dim(st.x.dtype, cfg.user)):
        raise ValueError(
            f"d={d} exceeds the scalar-rate kernel's {max_d} for {st.x.dtype}: "
            "the shared-memory vectors of a block's chains must fit the "
            "227 KB of shared memory a block can have")
    ran_p, mix_p, switch, positive, sf, normal = cfg.ecmc_params or (
        False, 0.0, False, False, 1.0, False)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    r = row0
    name = launch_name(cfg.kind) + ("_horizon" if cfg.horizon else "")
    lib = kernel_library(cfg)
    err = lib.scalar_chunk_launch(
        i(1 if st.x.dtype == torch.float64 else 0), i(KINDS[cfg.kind]),
        i(potential_id(cfg)), i(d), i(B), i(cfg.K),
        i(cfg.n_grid), i(int(cfg.adaptive)), i(int(cfg.signed)), f(cfg.refresh_rate),
        i(cfg.cap), i(cfg.tile), i(rng.wrap_int32(seed)), *cfg.launch_args(),
        i(int(cfg.gaussian_velocity)),
        i(int(ran_p)), f(mix_p), i(int(switch)), i(int(positive)), f(sf), i(int(normal)),
        p(0 if cfg.pot_params is None else cfg.pot_params.data_ptr()),
        p(st.x.data_ptr()), p(st.v.data_ptr()), p(st.fs.data_ptr()),
        p(st.iscal.data_ptr()), p(st.ring.data_ptr()),
        p(fill.kind[r].data_ptr()), p(fill.x[r].data_ptr()), p(fill.v[r].data_ptr()),
        p(fill.fs[r].data_ptr()), p(fill.ring[r].data_ptr()),
        p(torch.cuda.current_stream(st.x.device).cuda_stream))
    build.check(err, name, lib)
    build.LAUNCHES[name] += 1

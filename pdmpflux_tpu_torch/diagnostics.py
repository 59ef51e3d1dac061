"""Diagnostics (``pdmpflux_tpu/diagnostics.py``).

* ``diagnostic(skeleton)``: the 2x2 summary figure (inter-event times,
  acceptance-rate histogram with its mean, hitting-horizon and rejection
  histograms on log axes) and the printed errored-bound total
  (``diagnostic.jl:4-21``); matplotlib is imported inside the function.
* ``RV_diagnostic(skeleton, U, B)``: offline realized volatility of ``U``
  along the path, reconstructed with the *linear* masked flow as the
  reference does (``diagnostic.jl:23-75``; approximate for curved-flow
  samplers, as noted there).  Torch on the skeleton's device; ``U`` is a
  torch function of one ``(d,)`` position, evaluated under
  ``torch.func.vmap``.
* ``ess`` / ``ess_per_dim`` / ``ess_nd`` / ``split_rhat`` / ``ess_summary``
  and :data:`RHAT_THRESHOLD`: the JAX package's numpy estimators, copied
  here so that this package imports nothing of it.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import Skeleton
from .ops.flows import div_once, linear_flow


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def diagnostic(skeleton: Skeleton, color="#78C2AD", show=False, save_path=None):
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    t = _host(skeleton.t)
    ar = _host(skeleton.ar)
    hit = _host(skeleton.hitting_horizon)
    rej = _host(skeleton.rejected)
    err = _host(skeleton.errored_bound)
    if t.ndim == 2:
        # chain batch: pool only the valid (written) rows of each chain —
        # padding slots are zeros and would corrupt every histogram
        n_valid = _host(skeleton.n_valid)
        valid = np.arange(t.shape[1])[None, :] < n_valid[:, None]
        dt = np.concatenate(
            [np.diff(t[b, : n_valid[b]]) for b in range(t.shape[0])]
        )
        ar, hit, rej, err = (a[valid] for a in (ar, hit, rej, err))
    else:
        dt = np.diff(t)
    err_total = int(err.sum())

    fig, axes = plt.subplots(2, 2, figsize=(12, 9))
    axes[0, 0].hist(dt, bins="auto", color=color)
    axes[0, 0].set(title="Time between events histogram", xlabel="Time",
                   ylabel="Count")
    axes[0, 1].hist(ar, bins="auto", color=color, density=True)
    axes[0, 1].axvline(ar.mean(), ls="--", color="#E95420")
    axes[0, 1].set(
        title=f"Acceptance rate histogram (Mean: {ar.mean():.3f})",
        xlabel="Rate", ylabel="Relative Frequency",
    )
    axes[1, 0].hist(hit, bins=15, color=color, log=True)
    axes[1, 0].set(
        title=f"Hitting horizon histogram (Total: {int(hit.sum())})",
        xlabel="Horizon", ylabel="Log Frequency",
    )
    axes[1, 1].hist(rej, bins=20, color=color, log=True)
    axes[1, 1].set(
        title=f"Rejection histogram (Total: {int(rej.sum())})",
        xlabel="Rejections", ylabel="Log Frequency",
    )
    fig.tight_layout()
    print("number of error bound:", err_total)
    if save_path:
        fig.savefig(save_path)
    if show:
        plt.show()
    return fig


def _u_rows(U, x: torch.Tensor) -> torch.Tensor:
    """``U`` at every row of ``x`` (``(..., d)`` -> ``(...)``)."""
    flat = x.reshape(-1, x.shape[-1])
    return torch.func.vmap(U)(flat).reshape(x.shape[:-1])


def RV_diagnostic(skeleton: Skeleton, U, B: int = 0):
    """Offline realized volatility with the linear masked-velocity flow
    (``diagnostic.jl:37-75``).

    A single-chain ``(N,)`` skeleton returns a float, like the reference; a
    chain-batch ``(Bc, N)`` skeleton returns a ``(Bc,)`` tensor of per-chain
    RVs on the skeleton's device.
    """
    t = skeleton.t
    if t.dim() == 2:
        return _rv_diagnostic_batch(skeleton, U, B)
    N = t.shape[0]
    if N == 0:
        return 0.0
    T = float(t[-1])
    if not np.isfinite(T) or T < 0:
        raise ValueError(
            f"history.t[end] must be finite and non-negative. Current value: {T}"
        )
    if B == 0:
        B = max(1, int(np.floor(np.sqrt(N))))
    elif B < 0:
        raise ValueError(f"B must be non-negative. Current value: {B}")
    if T == 0.0:
        return 0.0

    # float64 throughout, as the reference's numpy reconstruction; the
    # boundaries as np.linspace computes them
    f64 = torch.float64
    X, V = skeleton.x.to(f64), skeleton.v.to(f64)
    tt = t.to(f64)
    boundaries = torch.arange(B + 1, dtype=f64, device=t.device) * (T / B)
    boundaries[-1] = T
    idx = torch.clamp(torch.searchsorted(tt, boundaries, right=True) - 1, 0, N - 1)
    tau = boundaries - tt[idx]
    x_b = X[idx] + torch.where(skeleton.is_active[idx], V[idx],
                               torch.zeros((), dtype=f64, device=t.device)) * tau[:, None]
    u = _u_rows(U, x_b)
    # boundaries[0] == 0 gives x(0) = X[0]; the increments telescope as the
    # reference's per-event accumulation does
    return float(torch.sum(torch.diff(u) ** 2)) / T


def linspace0(stop: float, n: int, dtype, device) -> torch.Tensor:
    """``jnp.linspace(0.0, stop, n)`` (float64, cast to ``dtype``): ``stop *
    (i / (n - 1))`` below the end point, exactly ``stop`` at it."""
    if n == 1:
        return torch.zeros(1, dtype=dtype, device=device)
    i = torch.arange(n - 1, dtype=torch.float64, device=device)
    end = torch.full((1,), stop, dtype=torch.float64, device=device)
    return torch.cat([div_once(i, n - 1) * stop, end]).to(dtype)


def boundary_u(skeleton: Skeleton, bounds: torch.Tensor, U, flow) -> torch.Tensor:
    """``U`` at each chain's positions at times ``bounds`` ``(Bc, n)``: the
    covering row of the chain-batch skeleton (its padded tail masked to +inf
    out of the search) flowed by ``flow`` with its masked velocity."""
    t = skeleton.t
    N = t.shape[1]
    col = torch.arange(N, device=t.device)[None, :]
    t_m = torch.where(col < skeleton.n_valid[:, None], t, torch.full_like(t, float("inf")))
    idx = torch.clamp(torch.searchsorted(t_m.contiguous(), bounds.contiguous(), right=True) - 1,
                      0, N - 1)
    i3 = idx[:, :, None].expand(-1, -1, skeleton.x.shape[-1])
    v_used = torch.where(torch.gather(skeleton.is_active, 1, i3),
                         torch.gather(skeleton.v, 1, i3),
                         torch.zeros((), dtype=t.dtype, device=t.device))
    # idx stays in the finite valid prefix
    xb, _ = flow(torch.gather(skeleton.x, 1, i3), v_used,
                 (bounds - torch.gather(t_m, 1, idx))[:, :, None])
    return _u_rows(U, xb)


def _rv_diagnostic_batch(skeleton: Skeleton, U, B: int) -> torch.Tensor:
    """Vectorized chain-batch RV: per-chain boundaries on the chain's own
    ``[0, t_end]``, the linear masked flow from the covering rows."""
    t = skeleton.t
    n_valid = skeleton.n_valid.to(torch.int64)
    t_end = torch.gather(t, 1, torch.clamp_min(n_valid - 1, 0)[:, None])[:, 0]
    if not (bool(torch.isfinite(t_end).all()) and bool((t_end >= 0).all())):
        raise ValueError(
            "history.t[end] must be finite and non-negative for every chain."
        )
    if B == 0:
        B = max(1, int(np.floor(np.sqrt(max(int(n_valid.min()), 1)))))
    elif B < 0:
        raise ValueError(f"B must be non-negative. Current value: {B}")
    bounds = linspace0(1.0, B + 1, t.dtype, t.device)[None, :] * t_end[:, None]
    u = boundary_u(skeleton, bounds, U, linear_flow)
    pos = t_end > 0
    te = torch.where(pos, t_end, torch.ones_like(t_end))
    return torch.where(pos, torch.sum(torch.diff(u, dim=1) ** 2, dim=1) / te,
                       torch.zeros_like(t_end))


def _autocorr_fft(x: np.ndarray) -> np.ndarray:
    n = len(x)
    x = x - x.mean()
    m = 1 << (2 * n - 1).bit_length()
    f = np.fft.rfft(x, m)
    acov = np.fft.irfft(f * np.conj(f))[:n].real
    if acov[0] <= 0:
        return np.zeros(n)
    return acov / acov[0]


def ess(series: np.ndarray) -> float:
    """Effective sample size of a 1-d series via Geyer's initial positive
    sequence estimator: ``tau = -1 + 2 * sum_k Gamma_k`` over the pair sums
    ``Gamma_k = rho_{2k} + rho_{2k+1}`` truncated at the first non-positive
    pair; ``ESS = n / tau``."""
    series = np.asarray(series, float)
    n = len(series)
    if n < 4 or np.var(series) == 0:
        return float(n)
    rho = _autocorr_fft(series)
    n_pairs = (len(rho) - 1) // 2
    gamma = rho[: 2 * n_pairs : 2] + rho[1 : 2 * n_pairs + 1 : 2]
    nonpos = np.nonzero(gamma <= 0)[0]
    cut = int(nonpos[0]) if len(nonpos) else len(gamma)
    tau = -1.0 + 2.0 * float(np.sum(gamma[:cut]))
    return float(n / max(tau, 1e-12))


def ess_per_dim(samples: np.ndarray) -> np.ndarray:
    """ESS of each coordinate of an ``(N, d)`` sample array."""
    s = np.asarray(samples, float)
    return np.asarray([ess(s[:, j]) for j in range(s.shape[1])])


def ess_nd(samples: np.ndarray) -> np.ndarray:
    """Vectorized Geyer ESS: ``(B, N, d)`` chains-by-samples-by-coordinates
    (or ``(N, d)`` / ``(N,)``) -> per-series ESS with the chain/coordinate
    axes preserved.  The estimator of :func:`ess`, batched through one FFT."""
    s = np.asarray(samples, float)
    shape = s.shape
    if s.ndim == 1:
        s = s[None, :, None]
    elif s.ndim == 2:
        s = s[None]
    B, N, d = s.shape
    if N < 4:
        full = np.full((B, d), float(N))
        return full[0, 0] if len(shape) == 1 else (
            full[0] if len(shape) == 2 else full
        )
    x = s - s.mean(axis=1, keepdims=True)
    m = 1 << (2 * N - 1).bit_length()
    f = np.fft.rfft(x, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), axis=1)[:, :N].real
    var0 = acov[:, 0:1]
    ok = var0 > 0
    rho = np.where(ok, acov / np.where(ok, var0, 1.0), 0.0)
    n_pairs = (N - 1) // 2
    gamma = rho[:, : 2 * n_pairs : 2] + rho[:, 1 : 2 * n_pairs + 1 : 2]
    nonpos = gamma <= 0
    first = np.where(nonpos.any(axis=1), nonpos.argmax(axis=1), n_pairs)
    k_idx = np.arange(n_pairs)[None, :, None]
    tau = -1.0 + 2.0 * np.sum(
        np.where(k_idx < first[:, None, :], gamma, 0.0), axis=1
    )
    out = np.where(ok[:, 0], N / np.maximum(tau, 1e-12), float(N))  # (B, d)
    if len(shape) == 1:
        return out[0, 0]
    if len(shape) == 2:
        return out[0]
    return out


def split_rhat(samples: np.ndarray) -> np.ndarray:
    """Split-R-hat per coordinate of a ``(B, N, d)`` chain batch (each chain
    halved, ``2B`` sequences; Gelman-Rubin potential scale reduction on the
    halves)."""
    s = np.asarray(samples, float)
    if s.ndim == 2:
        s = s[None]
    B, N, d = s.shape
    n = N // 2
    if n < 2:
        return np.ones(d)
    seq = np.concatenate([s[:, :n], s[:, n : 2 * n]], axis=0)  # (2B, n, d)
    mu = seq.mean(axis=1)
    W = seq.var(axis=1, ddof=1).mean(axis=0)
    B_var = n * mu.var(axis=0, ddof=1)
    var_plus = (n - 1) / n * W + B_var / n
    return np.sqrt(np.where(W > 0, var_plus / np.where(W > 0, W, 1.0), 1.0))


RHAT_THRESHOLD = 1.02
"""Default split-R-hat convergence gate, shared by :func:`ess_summary` and
``streaming.streaming_summary``."""


def ess_summary(samples: np.ndarray,
                rhat_threshold: float = RHAT_THRESHOLD) -> dict:
    """Cross-chain ESS with convergence gating: per-chain Geyer ESS on every
    coordinate, summed over chains per coordinate, the **worst coordinate**
    reported; ``converged`` gates on ``max_d split_rhat < rhat_threshold``."""
    s = np.asarray(samples, float)
    if s.ndim == 2:
        s = s[None]
    ess_bd = ess_nd(s)                    # (B, d)
    per_coord = ess_bd.sum(axis=0)        # (d,)
    rhat = split_rhat(s)
    return {
        "ess_per_coord": per_coord,
        "ess_total_worst_coord": float(per_coord.min()),
        "rhat": rhat,
        "rhat_max": float(rhat.max()),
        "converged": bool(rhat.max() < rhat_threshold),
    }

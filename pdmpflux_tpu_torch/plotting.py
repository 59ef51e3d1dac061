"""Visualization (``pdmpflux_tpu/plotting.py``): matplotlib counterparts of
the reference's ``plot.jl``.

* ``plot_traj``      1-D (t vs x), 2-D, 3-D skeleton polylines, with the
  phase-space ``xv_plot`` option (plot.jl:71-130)
* ``jointplot``      2-coordinate joint + marginal histograms (plot.jl:5-12)
* ``marginalplot``   1-D histogram + KDE + optional exact marginal from U
  (plot.jl:14-69)
* ``plot_U_contour`` 2-D potential contours (plot.jl:151-190)
* ``anim_traj``      trajectory animation (GIF via matplotlib.animation),
  interpolating between events at step dt with optional nonlinear flow
  (plot.jl:194-333)

Skeletons and samples are torch tensors on any device (or numpy arrays);
they are copied to the host before plotting.  ``U`` is a torch potential of
one ``(d,)`` position and ``flow`` a sampler's flow (``sampler.flow``: rows
``(..., d)``, times ``(..., 1)``), as everywhere in the port.  matplotlib
is imported inside the functions, so the package imports without it.  All
functions return the matplotlib Figure (or the animation object) and accept
``save_path`` for file output; they never require a display.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.types import Skeleton
from .ops.flows import rows_map


def _mpl():
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    return plt


def _np(a) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _U_values(U, pts: np.ndarray) -> np.ndarray:
    """``U`` of every row of ``pts`` ``(n, d)`` in float64."""
    return _np(rows_map(U, torch.as_tensor(pts, dtype=torch.float64)))


def plot_traj(skeleton: Skeleton, n_max: int = 1000, *, coords=(0, 1, 2),
              xv_plot: bool = False, save_path=None, ax=None, **plot_kw):
    """Polyline of the first ``n_max`` skeleton points (plot.jl:71-130).

    Passing ``ax=`` overlays onto an existing axes — the counterpart of the
    reference's mutating ``plot_traj!`` (plot.jl:101-130).  For the 3-D case
    the axes must have been created with ``projection="3d"``.  Extra keyword
    arguments are forwarded to ``Axes.plot`` (color, label, ...).
    """
    plt = _mpl()
    X = _np(skeleton.x)[:n_max]
    V = _np(skeleton.v)[:n_max]
    t = _np(skeleton.t)[:n_max]
    d = X.shape[1]
    plot_kw.setdefault("lw", 0.7)
    overlay = ax is not None

    three_d = not xv_plot and d >= 3 and len(coords) >= 3
    if overlay:
        fig, ax2 = ax.figure, ax
        if three_d and ax.name != "3d":
            raise ValueError(
                "overlaying a 3-D trajectory requires an axes created with "
                "projection='3d'"
            )
    elif three_d:
        fig = plt.figure()
        ax2 = fig.add_subplot(projection="3d")
    else:
        fig, ax2 = plt.subplots()

    if xv_plot:
        ax2.plot(X[:, coords[0]], V[:, coords[0]], **plot_kw)
        if not overlay:
            ax2.set(xlabel=f"x{coords[0]}", ylabel=f"v{coords[0]}",
                    title="Phase space trajectory")
    elif d == 1:
        ax2.plot(t, X[:, 0], **plot_kw)
        if not overlay:
            ax2.set(xlabel="t", ylabel="x", title="PDMP trajectory")
    elif not three_d:
        ax2.plot(X[:, coords[0]], X[:, coords[1]], **plot_kw)
        if not overlay:
            ax2.set(xlabel=f"x{coords[0]}", ylabel=f"x{coords[1]}",
                    title="PDMP trajectory")
    else:
        ax2.plot(X[:, coords[0]], X[:, coords[1]], X[:, coords[2]], **plot_kw)
        if not overlay:
            ax2.set(title="PDMP trajectory")
    if save_path:
        fig.savefig(save_path)
    return fig


def jointplot(samples, coords=(0, 1), bins=60, save_path=None):
    """Joint scatter/2-D-histogram with marginal histograms (plot.jl:5-12)."""
    plt = _mpl()
    s = _np(samples)
    x, y = s[:, coords[0]], s[:, coords[1]]
    fig = plt.figure(figsize=(7, 7))
    gs = fig.add_gridspec(
        2, 2, width_ratios=(4, 1), height_ratios=(1, 4),
        wspace=0.05, hspace=0.05,
    )
    ax = fig.add_subplot(gs[1, 0])
    ax_hx = fig.add_subplot(gs[0, 0], sharex=ax)
    ax_hy = fig.add_subplot(gs[1, 1], sharey=ax)
    ax.hist2d(x, y, bins=bins, cmap="viridis")
    ax_hx.hist(x, bins=bins, color="#78C2AD")
    ax_hy.hist(y, bins=bins, orientation="horizontal", color="#78C2AD")
    ax_hx.tick_params(labelbottom=False)
    ax_hy.tick_params(labelleft=False)
    ax.set(xlabel=f"x{coords[0]}", ylabel=f"x{coords[1]}")
    if save_path:
        fig.savefig(save_path)
    return fig


def marginalplot(samples, coord: int = 0, U=None, bins=80, save_path=None):
    """1-D marginal histogram + Gaussian-KDE + optional exact marginal
    overlay computed from ``U`` by numerical quadrature (plot.jl:14-69)."""
    plt = _mpl()
    s = _np(samples)[:, coord]
    fig, ax = plt.subplots()
    ax.hist(s, bins=bins, density=True, alpha=0.6, color="#78C2AD",
            label="samples")
    # Gaussian KDE (Scott's rule), dependency-free.
    n = len(s)
    h = 1.06 * s.std() * n ** (-1 / 5)
    grid = np.linspace(s.min() - 3 * h, s.max() + 3 * h, 400)
    if h > 0:
        kde = np.exp(
            -0.5 * ((grid[:, None] - s[None, ::max(1, n // 5000)]) / h) ** 2
        ).sum(axis=1)
        kde /= kde.sum() * (grid[1] - grid[0])
        ax.plot(grid, kde, color="#E95420", label="KDE")
    if U is not None:
        # exact 1-d marginal for product-form / 1-d potentials
        logp = -_U_values(U, grid[:, None])
        p = np.exp(logp - logp.max())
        p /= p.sum() * (grid[1] - grid[0])
        ax.plot(grid, p, "k--", label="exact (from U)")
    ax.legend()
    ax.set(xlabel=f"x{coord}", ylabel="density", title="Marginal")
    if save_path:
        fig.savefig(save_path)
    return fig


def plot_U_contour(U, xlim=(-3, 3), ylim=(-3, 3), n=120, save_path=None):
    """Contours of a 2-D potential (plot.jl:151-190)."""
    plt = _mpl()
    xs = np.linspace(*xlim, n)
    ys = np.linspace(*ylim, n)
    XX, YY = np.meshgrid(xs, ys)
    pts = np.stack([XX.ravel(), YY.ravel()], axis=1)
    ZZ = _U_values(U, pts).reshape(n, n)
    fig, ax = plt.subplots()
    cs = ax.contourf(XX, YY, np.exp(-(ZZ - ZZ.min())), levels=30,
                     cmap="viridis")
    fig.colorbar(cs, ax=ax)
    ax.set(xlabel="x0", ylabel="x1", title="exp(-U) contours")
    if save_path:
        fig.savefig(save_path)
    return fig


def _anim_points(skeleton: Skeleton, n_max: int, dt: float, flow, coords):
    """Interpolated animation frames.  2-D+ histories animate the two
    ``coords`` coordinates (plot.jl:216-333); 1-D histories animate
    ``(t, x)`` with time on the horizontal axis (plot.jl:207-214 — the
    reference's dim-1 branch).  ``flow`` is called on one row ``(d,)`` of
    float64 tensors and a ``(1,)`` time.  Returns (points, event_xy,
    labels)."""
    X = _np(skeleton.x)[:n_max]
    V = _np(skeleton.v)[:n_max]
    A = _np(skeleton.is_active)[:n_max]
    t = _np(skeleton.t)[:n_max]
    one_d = X.shape[1] == 1

    pts = []
    for i in range(len(t) - 1):
        seg = max(1, int(np.ceil((t[i + 1] - t[i]) / dt)))
        taus = np.linspace(0.0, t[i + 1] - t[i], seg, endpoint=False)
        v_used = np.where(A[i], V[i], 0.0)
        for tau in taus:
            p = (X[i] + v_used * tau) if flow is None else _np(flow(
                torch.as_tensor(X[i], dtype=torch.float64),
                torch.as_tensor(v_used, dtype=torch.float64),
                torch.tensor([tau], dtype=torch.float64))[0])
            pts.append((t[i] + tau, p[0]) if one_d else p[list(coords)])
    pts.append((t[-1], X[-1, 0]) if one_d else X[-1][list(coords)])
    if one_d:
        ev_xy = np.stack([t, X[:, 0]], axis=1)
        labels = ("t", "x")
    else:
        ev_xy = X[:, list(coords)]
        labels = (f"x{coords[0]}", f"x{coords[1]}")
    return np.asarray(pts), ev_xy, labels


def anim_traj(skeleton: Skeleton, n_max: int = 200, *, dt: float = 0.1,
              flow=None, coords=(0, 1), save_path=None, fps: int = 30):
    """Animate the trajectory, interpolating between events at step ``dt``
    (plot.jl:194-333).  ``flow`` overrides the linear interpolant for
    curved-flow samplers (the reference's ``nonlinear_flow`` option).
    Dim-1 histories animate ``(t, x)`` like the reference (plot.jl:207)."""
    plt = _mpl()
    from matplotlib import animation

    frames_xy, ev_xy, labels = _anim_points(skeleton, n_max, dt, flow, coords)

    fig, ax = plt.subplots()
    pad = 0.5
    ax.set_xlim(frames_xy[:, 0].min() - pad, frames_xy[:, 0].max() + pad)
    ax.set_ylim(frames_xy[:, 1].min() - pad, frames_xy[:, 1].max() + pad)
    ax.set(xlabel=labels[0], ylabel=labels[1])
    (line,) = ax.plot([], [], lw=0.8)
    (dot,) = ax.plot([], [], "o", color="#E95420", ms=4)
    ev = ax.scatter(ev_xy[:, 0], ev_xy[:, 1], s=4, alpha=0.3)

    def update(i):
        line.set_data(frames_xy[: i + 1, 0], frames_xy[: i + 1, 1])
        dot.set_data(frames_xy[i : i + 1, 0], frames_xy[i : i + 1, 1])
        return line, dot, ev

    ani = animation.FuncAnimation(
        fig, update, frames=len(frames_xy), interval=1000 / fps, blit=True
    )
    if save_path:
        ani.save(save_path, writer=animation.PillowWriter(fps=fps))
    return ani


def anim_traj_(skeleton: Skeleton, n_max: int = 200, *, dt: float = 0.1,
               flow=None, coords=(0, 1), save_path=None, fps: int = 30,
               tail: int = 60):
    """Fading-tail animation variant (plot.jl:339-631 ``anim_traj_``):
    only the most recent ``tail`` interpolation points are drawn, with
    opacity fading toward the tail end and the current point highlighted.
    Dim-1 histories animate ``(t, x)`` like the reference (plot.jl:207)."""
    plt = _mpl()
    from matplotlib import animation
    from matplotlib.collections import LineCollection

    pts, _, labels = _anim_points(skeleton, n_max, dt, flow, coords)

    fig, ax = plt.subplots()
    pad = 0.5
    ax.set_xlim(pts[:, 0].min() - pad, pts[:, 0].max() + pad)
    ax.set_ylim(pts[:, 1].min() - pad, pts[:, 1].max() + pad)
    ax.set(xlabel=labels[0], ylabel=labels[1])
    lc = LineCollection([], linewidths=1.2)
    ax.add_collection(lc)
    (dot,) = ax.plot([], [], "o", color="#E95420", ms=5)

    def update(i):
        lo = max(0, i - tail)
        window = pts[lo : i + 1]
        segs = np.stack([window[:-1], window[1:]], axis=1) if len(window) > 1 else []
        lc.set_segments(segs)
        n = max(len(window) - 1, 1)
        alphas = np.linspace(0.05, 1.0, n)
        lc.set_color([(0.25, 0.5, 0.6, a) for a in alphas])
        dot.set_data(pts[i : i + 1, 0], pts[i : i + 1, 1])
        return lc, dot

    ani = animation.FuncAnimation(
        fig, update, frames=len(pts), interval=1000 / fps, blit=True
    )
    if save_path:
        ani.save(save_path, writer=animation.PillowWriter(fps=fps))
    return ani

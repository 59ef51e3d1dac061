"""Sampler base class (``pdmpflux_tpu/models/base.py``).

A sampler holds static configuration and pure functions on tensors.  The
bound-strategy flags resolve exactly as in the JAX package (reference
``AbstractPDMP.jl:104-136``); the error texts are the same.

The maps the transition engine (``core/engine.py``) calls take a chain
batch, tensors leading with ``B``:

* ``flow(x, v, t)``: rows ``(..., d)``, times ``(..., 1)``;
* ``rate(x, v, t)``, ``rate_vect``, ``signed_rate``, ``signed_rate_vect``:
  ``x``, ``v`` ``(B, d)`` and per-chain times ``(B, *S)``; the unsigned
  total rate ``(B, *S)``, or per-coordinate rates ``(B, *S, d)``;
* ``bound_box(x, v, horizon)``: the envelope of the chosen strategy;
* ``velocity_jump(x, v, keys, is_active)``: ``(B, d)`` velocities after an
  event, one Threefry key ``(B, 2)`` per chain.

Every reduction over coordinates goes through ``self.dims``, the
coordinate group (``core/dims.py``): all of them (``LOCAL``) by default, or
this process's slice in a view made by :meth:`PDMP.on_dims` for the
coordinate-sharded engine (``parallel/sharded.sample_skeleton_gspmd``),
where ``d`` above is this process's share.

Only the user's one-chain functions (``grad_U``) go through
``torch.func.vmap`` (``ops/flows.rows_map``).
"""

from __future__ import annotations

import copy
import warnings
from typing import Callable, Optional

import torch

from ..core import bounds, rng
from ..core.device import resolve_device
from ..core.dims import LOCAL
from ..core.types import ERROR_RING_SIZE, MODE_FRESH, PDMPState
from ..ops.flows import rows_map
from ..utils.potentials import COORDINATEWISE, LANE_POTENTIALS, device_potential_of


def as_key(seed_or_key, device="cpu") -> torch.Tensor:
    """Key data for a seed (``None`` means 0) or pass key data through."""
    if seed_or_key is None:
        return rng.key(0, device)
    if isinstance(seed_or_key, int):
        return rng.key(seed_or_key, device)
    return torch.as_tensor(seed_or_key, dtype=torch.int64, device=device)


def resolve_potential(U: Callable, dim: int):
    """``(U_vec, grad_U)`` from a user potential.

    * ``U`` mapping ``(dim,) -> (dim,)`` (``dim > 1``) is already a gradient;
    * a scalar or ``(1,)`` output is a potential, differentiated with
      ``torch.func.grad``;
    * at ``dim == 1`` the scalar-argument convention ``U(x: float)`` is
      detected and wrapped.
    """
    probe = torch.zeros(dim, dtype=torch.float64)
    try:
        out = torch.as_tensor(U(probe))
        vector_input_ok = True
    except Exception:
        out = None
        vector_input_ok = False

    if vector_input_ok and tuple(out.shape) == (dim,) and dim > 1:
        return None, U
    if vector_input_ok and tuple(out.shape) in ((), (1,)):
        U_vec = (lambda x: U(x)[0]) if tuple(out.shape) == (1,) else U
        return U_vec, torch.func.grad(U_vec)
    if dim == 1:
        scalar_out = torch.as_tensor(U(probe[0]))
        if tuple(scalar_out.shape) == ():
            U_vec = lambda x: U(x[0])  # noqa: E731
            return U_vec, torch.func.grad(U_vec)
        if tuple(scalar_out.shape) == (1,):
            return None, lambda x: torch.reshape(U(x[0]), (1,))
    raise ValueError(
        f"Could not interpret potential: U(zeros({dim})) has shape "
        f"{None if out is None else tuple(out.shape)}; expected a scalar "
        f"(potential) or (dim,) vector (gradient)."
    )


def max0(y: torch.Tensor) -> torch.Tensor:
    """``max(y, 0)`` with JAX's derivative at the tie: ``torch.maximum`` (not
    ``clamp_min``) splits the tangent in half where ``y == 0``, as
    ``jnp.maximum(0.0, y)`` does, which the envelope's jvp tangents see
    wherever a rate term starts at exactly 0."""
    return torch.maximum(y, torch.zeros((), dtype=y.dtype, device=y.device))


def tag_from(sampler, U):
    """An ``*AD`` constructor's sampler: when its autodiff gradient carries
    no device potential, take the tag (and parameters) of ``U``."""
    if sampler.device_potential is None:
        sampler.device_potential, sampler.device_params = device_potential_of(U)
    return sampler


class PDMP:
    """Base class of the port's PDMP samplers.

    ``device_potential`` names the potential the CUDA kernels evaluate for
    this sampler (from the tag on ``grad_U`` or ``potential``) and
    ``device_params`` its parameters; the tag is None when only the plain
    PyTorch version can run the sampler."""

    sticky: bool = False
    dims = LOCAL
    """The coordinate group this sampler's maps reduce over (``core/dims.py``)."""

    def __init__(
        self,
        dim: int,
        grad_U: Callable,
        *,
        grid_size: int = 10,
        tmax: float = 2.0,
        refresh_rate: float = 0.0,
        vectorized_bound: bool = True,
        signed_bound: bool = True,
        adaptive: bool = True,
        tderiv: str = "jvp",
        potential: Optional[Callable] = None,
        ad_backend: str = "torch",
        AD_backend: Optional[str] = None,
    ):
        if AD_backend is not None:
            ad_backend = AD_backend
            if AD_backend in ("FiniteDiff", "Undefined", ""):
                tderiv = "finite_diff"
        if dim <= 0:
            raise ValueError(f"dimension dim must be positive. Current value: {dim}")
        if grid_size < 0:
            raise ValueError(f"grid_size must be non-negative. Current value: {grid_size}")
        tmax = float(tmax)
        if tmax == 0.0:  # adaptive-horizon trigger, ZigZagSamplers.jl:73
            tmax, adaptive = 1.0, True

        self.dim = dim
        self.grad_U = grad_U
        self.potential = potential
        self.grid_size = int(grid_size)
        self.tmax = tmax
        self.refresh_rate = float(refresh_rate)
        self.vectorized_bound = bool(vectorized_bound)
        self.signed_bound = bool(signed_bound)
        self.adaptive = bool(adaptive)
        self.tderiv = tderiv
        self.ad_backend = ad_backend
        self.kappa = None
        self.state: Optional[PDMPState] = None
        self.device_potential, self.device_params = device_potential_of(
            grad_U, potential)

        if self.signed_bound and not self.vectorized_bound and self._zigzag_family():
            warnings.warn(
                "Signed bound is not compatible with non-vectorized bound for "
                "ZigZag, switching to unsigned bound"
            )
            self.signed_bound = False

    def _zigzag_family(self) -> bool:
        return False

    # -- dynamics interface (subclasses implement) ---------------------------
    def flow(self, x, v, t):
        raise NotImplementedError

    def rate(self, x, v, t):
        raise NotImplementedError

    rate_vect: Optional[Callable] = None
    signed_rate: Optional[Callable] = None
    signed_rate_vect: Optional[Callable] = None
    flow_takes_bound = False
    """True when ``flow`` takes ``t_max``, a host bound on its times (RHMC's
    Verlet flow, whose step count depends on them)."""

    def velocity_jump(self, x, v, keys, is_active):
        raise NotImplementedError

    def on_dims(self, dims):
        """This sampler over the coordinates of ``dims``: itself for
        :data:`~pdmpflux_tpu_torch.core.dims.LOCAL`, else a shallow copy
        whose maps take this process's slice of each row, with the
        per-coordinate parameters (``kappa``) sliced alike."""
        if not dims.sharded:
            return self
        view = copy.copy(self)
        view.dims = dims
        if self.kappa is not None:
            view.kappa = dims.local(self.kappa)
        return view

    def grad_rows(self, x):
        """``grad_U`` of every row of ``x`` ``(..., d)``: the device
        potential's closed form when the sampler carries a tag (the formula
        the kernels evaluate, ``utils.potentials.LANE_POTENTIALS``), else the
        user's ``grad_U`` through ``torch.func.vmap``.  On a slice of the
        coordinates a coordinatewise potential runs on the slice, with its
        parameters sliced; any other gradient runs on the gathered rows,
        and the slice of the result is kept."""
        dims, tag = self.dims, self.device_potential
        if dims.sharded and tag in COORDINATEWISE:
            params = self.device_params
            return self._grad_full(x, None if params is None else dims.local(params))
        return dims.local(self._grad_full(dims.gather(x), self.device_params))

    def _grad_full(self, x, params):
        if self.device_potential in LANE_POTENTIALS:
            grad, _ = LANE_POTENTIALS[self.device_potential](params)
            flat = x.reshape((-1, x.shape[-1]))
            return grad(flat.T).T.reshape(x.shape)
        return rows_map(self.grad_U, x)

    def along(self, x, v, t):
        """``flow`` from each chain's ``(x, v)`` ``(B, d)`` to its times
        ``(B, *S)``: positions and velocities ``(B, *S, d)`` (the velocity
        may stay ``(B, 1, ..., d)`` where the flow keeps it)."""
        shape = (x.shape[0],) + (1,) * (t.dim() - 1) + (x.shape[1],)
        return self.flow(x.reshape(shape), v.reshape(shape), t[..., None])

    # -- bound strategy resolution (AbstractPDMP.jl:104-136) -----------------
    def bound_box(self, x, v, horizon):
        """The envelope of the rate from ``(x, v)`` over ``[0, horizon]``:
        constant on the unsigned rate when ``grid_size == 0``, else a grid
        envelope of the signed or unsigned, scalar or per-coordinate rate,
        the refresh rate added on the signed scalar path only."""
        if self.grid_size == 0:
            return bounds.upper_bound_constant(lambda t: self.rate(x, v, t), horizon)
        if self.signed_bound:
            sel_rate, sel_vect = self.signed_rate, self.signed_rate_vect
            refresh = self.refresh_rate
        else:
            sel_rate, sel_vect = self.rate, self.rate_vect
            refresh = 0.0
        if not self.vectorized_bound:
            return bounds.upper_bound_grid(lambda t: sel_rate(x, v, t), horizon,
                                           self.grid_size, refresh, tderiv=self.tderiv)
        return bounds.upper_bound_grid_vect(lambda t: sel_vect(x, v, t), horizon,
                                            self.grid_size, tderiv=self.tderiv,
                                            dims=self.dims)

    def init_state(self, xinit, vinit, seed=None, dtype=None,
                   device="cuda") -> PDMPState:
        """One chain's initial state; the Exp clock is
        ``jax.random.exponential`` of the second of three split keys.
        ``device="cuda"`` without a card raises."""
        device = resolve_device(device)
        xinit = torch.as_tensor(xinit, dtype=dtype, device=device)
        vinit = torch.as_tensor(vinit, dtype=dtype, device=device)
        if tuple(xinit.shape) != (self.dim,) or tuple(vinit.shape) != (self.dim,):
            raise ValueError(
                f"xinit and vinit must have the same dimension as pdmp.dim "
                f"({self.dim}). Current dimensions: xinit ({tuple(xinit.shape)}), "
                f"vinit ({tuple(vinit.shape)})"
            )
        batch = self.init_state_batch(xinit[None], vinit[None], None,
                                      dtype, device, keys=as_key(seed, device)[None])
        return PDMPState(*(f[0] for f in batch))

    def init_state_batch(self, xinit, vinit, seed=None, dtype=None,
                         device="cuda", keys=None) -> PDMPState:
        """Initialize ``(B, d)`` chains; chain ``b`` gets key ``b`` of
        ``split(key(seed), B)``, as in the JAX package.  ``device="cuda"``
        without a card raises."""
        device = resolve_device(device)
        x = torch.as_tensor(xinit, dtype=dtype, device=device)
        v = torch.as_tensor(vinit, dtype=dtype, device=device)
        dt = x.dtype
        B = x.shape[0]
        if keys is None:
            keys = rng.split(as_key(seed, device), B)
        sub = rng.split(keys, 3)  # (B, 3, 2): key, k_exp, k_tt

        def full(val):
            return torch.full((B,), val, dtype=dt, device=device)

        def izero():
            return torch.zeros((B,), dtype=torch.int32, device=device)

        return PDMPState(
            x=x, v=v, t=full(0.0), t_comp=full(0.0), ts=full(0.0),
            horizon=full(self.tmax), bound_h=full(self.tmax),
            exp_rv=rng.key_exponential(sub[:, 1], dt),
            tt=full(float("inf")),
            mode=torch.full((B,), MODE_FRESH, dtype=torch.int32, device=device),
            ar=full(0.0),
            is_active=torch.ones((B, self.dim), dtype=torch.bool, device=device),
            rejected=izero(), errored_bound=izero(), hitting_horizon=izero(),
            error_value_ar=torch.zeros((B, ERROR_RING_SIZE), dtype=dt,
                                       device=device),
            key=sub[:, 0],
        )


class ScalarRatePDMP(PDMP):
    """A sampler with one scalar event rate, ``max(0, <g(x_t), v_t>) +
    refresh_rate`` for a gradient-like ``g`` (BPS and Forward ECMC: ``grad
    U``; the Boomerang: ``grad U(x) - x``), whose signed rate omits the
    refresh rate: the signed grid envelope adds it once after its max with
    0, as the JAX package's tight envelope does."""

    def _grad_like(self, x):
        return self.grad_rows(x)

    def signed_rate(self, x, v, t):
        xt, vt = self.along(x, v, t)
        return self.dims.sum(self._grad_like(xt) * vt)

    def rate(self, x, v, t):
        return max0(self.signed_rate(x, v, t)) + self.refresh_rate

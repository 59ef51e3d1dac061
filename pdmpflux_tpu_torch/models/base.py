"""Sampler base class (``pdmpflux_tpu/models/base.py``).

A sampler holds static configuration and pure functions on tensors.  The
bound-strategy flags resolve exactly as in the JAX package (reference
``AbstractPDMP.jl:104-136``); the error texts are the same.
"""

from __future__ import annotations

import warnings
from typing import Callable, Optional

import torch

from ..core import rng
from ..core.device import resolve_device
from ..core.types import ERROR_RING_SIZE, MODE_FRESH, PDMPState
from ..utils.potentials import device_potential_of


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

    def flow(self, x, v, t):
        raise NotImplementedError

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

"""Converters between the port's records and plain numpy dicts.

The dicts are keyed by the JAX package's field names
(``pdmpflux_tpu.core.types``), so a caller holding both packages can wrap
them into JAX pytrees, or hand JAX results to the port, without this
package importing JAX.  ``PDMPState.key`` travels as JAX's raw key data:
``uint32`` words of shape ``(..., 2)`` (``jax.random.key_data`` /
``jax.random.wrap_key_data``).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .core.types import PDMPState, Skeleton


def _to_numpy(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy()


def state_to_numpy(state: PDMPState) -> dict:
    out = {f: _to_numpy(getattr(state, f)) for f in PDMPState._fields}
    out["key"] = out["key"].astype(np.uint32)
    return out


def state_from_numpy(fields: dict, device="cuda") -> PDMPState:
    """A state on ``device`` (the card by default, like every entry point;
    asking for CUDA without a card raises)."""
    dev = resolve_device(device)

    def conv(name, a):
        a = np.asarray(a)
        if name == "key":
            a = a.astype(np.int64)
        return torch.tensor(a, device=dev)

    return PDMPState(**{f: conv(f, fields[f]) for f in PDMPState._fields})


def skeleton_to_numpy(skel: Skeleton) -> dict:
    return {f: _to_numpy(getattr(skel, f)) for f in Skeleton._fields}


def skeleton_from_numpy(fields: dict, device="cuda") -> Skeleton:
    """A skeleton on ``device`` (the card by default, as above)."""
    dev = resolve_device(device)
    return Skeleton(**{f: torch.tensor(np.asarray(fields[f]), device=dev)
                       for f in Skeleton._fields})

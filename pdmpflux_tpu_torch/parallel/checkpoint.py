"""Checkpoint / resume (``pdmpflux_tpu/parallel/checkpoint.py``).

A checkpoint is a flat ``.npz`` in the JAX package's layout: one array per
record field under ``state.<field>`` (and ``skel.<field>`` for a partial
skeleton), and ``__meta__``, a JSON manifest as ``uint8`` bytes.  The key
is stored as JAX stores it, its ``uint32`` words (``jax.random.key_data``),
so either package loads the other's files.  Determinism comes from the
counter-based keys in the saved state: a resumed run continues the one that
was interrupted bit for bit.

Tensors go to the host for the save; :func:`load_checkpoint` puts the state
on the caller's device and the skeleton there or where the caller says.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.types import PDMPState, Skeleton


def _flatten(prefix: str, tree) -> dict:
    """``{prefix.field: numpy array}`` of a record of tensors; the key as
    ``uint32`` words."""
    out = {}
    for name in tree._fields:
        val = np.asarray(getattr(tree, name).detach().cpu().numpy())
        if name == "key":
            val = val.astype(np.uint32)
        out[f"{prefix}.{name}"] = val
    return out


def _meta_bytes(meta: Optional[dict]) -> np.ndarray:
    return np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)


def _write_atomic(path: str, arrays: dict) -> None:
    """Write ``arrays`` to ``path`` through a temporary file and
    ``os.replace``, so a crash leaves the previous checkpoint whole."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def save_checkpoint(path: str, state: PDMPState,
                    skeleton: Optional[Skeleton] = None,
                    meta: Optional[dict] = None) -> None:
    """Atomically write state (and an optional partial skeleton) to
    ``path``."""
    arrays = _flatten("state", state)
    if skeleton is not None:
        arrays.update(_flatten("skel", skeleton))
    arrays["__meta__"] = _meta_bytes(meta)
    _write_atomic(path, arrays)


def _tensor(a: np.ndarray, dev: torch.device, key: bool = False) -> torch.Tensor:
    a = np.asarray(a)
    return torch.tensor(a.astype(np.int64) if key else a, device=dev)


def load_state(z, prefix: str, dev: torch.device) -> PDMPState:
    """A ``PDMPState`` from an open ``.npz``; the key's ``uint32`` words
    become the port's ``int64`` words."""
    return PDMPState(**{f: _tensor(z[f"{prefix}.{f}"], dev, f == "key")
                        for f in PDMPState._fields})


def read_meta(z) -> dict:
    return json.loads(bytes(z["__meta__"]).decode()) if "__meta__" in z else {}


def load_checkpoint(path: str, device="cuda", skeleton_device=None):
    """Returns ``(state, skeleton_or_None, meta)``, the state on ``device``
    (the card by default; CUDA without a card raises) and the skeleton on
    ``skeleton_device`` (default ``device``; host accumulation keeps it on
    the CPU)."""
    dev = resolve_device(device)
    skel_dev = dev if skeleton_device is None else resolve_device(skeleton_device)
    with np.load(path) as z:
        meta = read_meta(z)
        state = load_state(z, "state", dev)
        skel = None
        if any(k.startswith("skel.") for k in z.files):
            skel = Skeleton(*[_tensor(z[f"skel.{f}"], skel_dev) for f in Skeleton._fields])
    return state, skel, meta

"""Threefry-2x32 random numbers, bit-compatible with the JAX package.

Two callers share one generator:

* the fused Zig-Zag kernel's counter RNG (``_threefry2x32``, ``_bits2``,
  ``_mant24``, ``_uniform`` and ``_exponential`` of
  ``pdmpflux_tpu/ops/pallas/zigzag_chunk.py``), used by the plain version of
  K1 and mirrored in ``csrc/zigzag_chunk.cu``;
* the ``jax.random`` pieces the event-count path touches: ``key(seed)``,
  ``split``, ``fold_in`` and ``exponential``, as JAX 0.9 computes them with
  ``jax_threefry_partitionable=True`` and 64-bit integer seeds.

PyTorch has no ``uint32`` addition on the CPU, so every word is an
``int64`` tensor holding a value in ``[0, 2**32)`` and each sum is masked.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_C240 = 0x1BD11BDA
LN2_24 = 16.635532333438686  # 24 * ln 2


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int64 word tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _C240)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for block in range(5):
        for r in (_ROT[:4] if block % 2 == 0 else _ROT[4:]):
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + (block + 1)) & M32
    return x0, x1


def wrap_int32(n: int) -> int:
    """Python int -> the int32 it wraps to."""
    return ((int(n) + 2**31) % 2**32) - 2**31


# ---------------------------------------------------------------------------
# The kernel's counter RNG
# ---------------------------------------------------------------------------

def lane_seeds(seed: int, B: int, tile: int, device) -> torch.Tensor:
    """Per-chain Threefry key word: the chunk seed plus ``tile_index * 7919``
    (int32 arithmetic), as a uint32 value.  ``tile`` is the logical lane
    tile of the RNG layout, not a launch parameter."""
    tiles = torch.arange(B, device=device, dtype=torch.int64) // tile
    s = (int(seed) + tiles * 7919 + 2**31) % 2**32 - 2**31
    return s & M32


def bits2(seeds, salt: int, row: int, tile: int):
    """Both Threefry words at counter ``row * tile + lane`` for every chain.

    ``seeds``: per-chain key words from :func:`lane_seeds`; ``salt``: the
    second key word (the transition index, or ``0x80000000 + k`` for the
    Exp clock)."""
    B = seeds.shape[0]
    lane = torch.arange(B, device=seeds.device, dtype=torch.int64) % tile
    counter = (row * tile + lane) & M32
    return threefry2x32(seeds, int(salt) & M32, counter,
                        torch.zeros_like(counter))


def mant24(bits, dtype):
    """Top 24 bits of a word as a float in [0, 1)."""
    return (bits >> 8).to(dtype) * (1.0 / (1 << 24))


def uniform(seeds, salt: int, row: int, tile: int, dtype):
    """(0, 1) uniforms: ``mant24 + 2**-25``."""
    b0, _ = bits2(seeds, salt, row, tile)
    return mant24(b0, dtype) + (0.5 / (1 << 24))


def exponential(seeds, salt: int, tile: int, dtype):
    """Exp(1) draws with a 48-bit-deep tail from both words (row 0)."""
    b0, b1 = bits2(seeds, salt, 0, tile)
    u_hi = mant24(b0, dtype)
    u_lo = mant24(b1, dtype) + (0.5 / (1 << 24))
    deep = u_hi == 0.0
    u = torch.where(deep, u_lo, u_hi + u_lo * (1.0 / (1 << 24)))
    u = torch.clamp_max(u, 1.0 - 1.0 / (1 << 24))
    base = torch.where(deep, torch.full_like(u, LN2_24), torch.zeros_like(u))
    return base - torch.log(u)


# ---------------------------------------------------------------------------
# jax.random counterparts (per-chain keys)
# ---------------------------------------------------------------------------

def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` for an integer seed."""
    s = int(seed)
    return torch.tensor([(s >> 32) & M32, s & M32], dtype=torch.int64,
                        device=device)


def split(k: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.split(key, n)`` on key data ``(..., 2)``: ``(..., n, 2)``."""
    i = torch.arange(n, dtype=torch.int64, device=k.device)
    b0, b1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(i), i)
    return torch.stack([b0, b1], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` on key data of shape ``(..., 2)``."""
    data = torch.as_tensor(data, dtype=torch.int64, device=keys.device) & M32
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1],
                          torch.zeros_like(data), data)
    return torch.stack([b0, b1], dim=-1)


def key_uniform(keys: torch.Tensor, dtype) -> torch.Tensor:
    """``jax.random.uniform(key, dtype=dtype)`` (one scalar draw per key)."""
    zero = torch.zeros_like(keys[..., 0])
    b0, b1 = threefry2x32(keys[..., 0], keys[..., 1], zero, zero)
    if dtype == torch.float64:
        mant = (b0 << 20) | (b1 >> 12)  # top 52 bits of (b0 << 32 | b1)
        return mant.to(torch.float64) * 2.0**-52
    if dtype == torch.float32:
        return ((b0 ^ b1) >> 9).to(torch.float32) * 2.0**-23
    raise TypeError(f"uniform draws cover float32 and float64, not {dtype}")


def key_exponential(keys: torch.Tensor, dtype) -> torch.Tensor:
    """``jax.random.exponential(key, dtype=dtype)`` per key."""
    return -torch.log1p(-key_uniform(keys, dtype))

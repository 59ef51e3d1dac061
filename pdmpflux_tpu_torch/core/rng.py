"""Threefry-2x32 random numbers, bit-compatible with the JAX package.

Two callers share one generator:

* the fused Zig-Zag kernel's counter RNG (``_threefry2x32``, ``_bits2``,
  ``_mant24``, ``_uniform`` and ``_exponential`` of
  ``pdmpflux_tpu/ops/pallas/zigzag_chunk.py``), used by the plain version of
  K1 and mirrored in ``csrc/zigzag_chunk.cu``;
* the ``jax.random`` pieces the drivers and the transition engine touch:
  ``key(seed)``, ``split``, ``fold_in``, scalar ``uniform`` and
  ``exponential`` draws, and shaped ``uniform``, ``normal`` and
  ``categorical`` draws, as JAX 0.9 computes them with
  ``jax_threefry_partitionable=True`` and 64-bit integer seeds.  Normals go
  through XLA's ErfInv polynomial written in torch ops (:func:`erf_inv`).

PyTorch has no ``uint32`` addition on the CPU, so every word is an
``int64`` tensor holding a value in ``[0, 2**32)`` and each sum is masked.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .dims import LOCAL

M32 = 0xFFFFFFFF
_NP = {torch.float32: np.float32, torch.float64: np.float64}
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_C240 = 0x1BD11BDA
LN2_24 = 16.635532333438686  # 24 * ln 2


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on broadcastable int64 word tensors.

    The rounds update two fresh tensors in place.  ``x1`` is reduced mod
    2**32 after every round, since its rotation needs the exact word; ``x0``
    only enters sums and the low bits of an xor, so it carries its excess
    (below 2**40) and is reduced once at the end."""
    ks = (k0, k1, k0 ^ k1 ^ _C240)
    x0, x1 = torch.broadcast_tensors(x0 + ks[0], x1 + ks[1])
    x0, x1 = x0.clone(), x1.bitwise_and(M32)
    t = torch.empty_like(x1)
    for block in range(5):
        for r in (_ROT[:4] if block % 2 == 0 else _ROT[4:]):
            x0.add_(x1)
            torch.bitwise_right_shift(x1, 32 - r, out=t)
            x1.bitwise_left_shift_(r).bitwise_or_(t).bitwise_xor_(x0).bitwise_and_(M32)
        x0.add_(ks[(block + 1) % 3])
        x1.add_(ks[(block + 2) % 3] + (block + 1)).bitwise_and_(M32)
    return x0.bitwise_and_(M32), x1


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
    return _mantissa_floats(keys, (), dtype)


def key_exponential(keys: torch.Tensor, dtype) -> torch.Tensor:
    """``jax.random.exponential(key, dtype=dtype)`` per key."""
    return -torch.log1p(-key_uniform(keys, dtype))


# ---------------------------------------------------------------------------
# Shaped draws (the transition engine's jax.random calls)
# ---------------------------------------------------------------------------
#
# With ``jax_threefry_partitionable`` a draw of shape ``S`` from one key runs
# Threefry at the counters ``(0, i)`` for the flat index ``i`` of each element
# (``prng.iota_2x32_shape``); a 32-bit draw takes ``w0 ^ w1``, a 64-bit one
# ``w0 << 32 | w1``.  Every key of a ``(..., 2)`` batch draws its own ``S``.

def _flat_index(shape, cols, device) -> torch.Tensor:
    """The flat indices of a draw of ``shape``, or of its columns ``[lo, hi)``
    of the last axis when ``cols`` is given (a coordinate-sharded draw:
    ``core/dims.py``)."""
    n = math.prod(shape)
    if cols is None:
        return torch.arange(n, dtype=torch.int64, device=device)
    lo, hi = cols
    rows = torch.arange(n // shape[-1], dtype=torch.int64, device=device)
    return (rows[:, None] * shape[-1]
            + torch.arange(lo, hi, dtype=torch.int64, device=device)[None, :]).reshape(-1)


def _mantissa_floats(keys: torch.Tensor, shape, dtype, cols=None) -> torch.Tensor:
    """``(..., *shape)`` floats in [0, 1): the top mantissa bits of each
    element's random word (the ``bitcast(bits >> k | 1.0) - 1`` of
    ``jax.random.uniform``, which is exact).  With ``cols = (lo, hi)`` only
    the columns ``[lo, hi)`` of the last axis, with their bits in the whole
    draw."""
    shape = tuple(int(s) for s in shape)
    i = _flat_index(shape, cols, keys.device)
    if cols is not None:
        shape = shape[:-1] + (cols[1] - cols[0],)
    w0, w1 = threefry2x32(keys[..., 0, None], keys[..., 1, None],
                          torch.zeros_like(i), i)
    if dtype == torch.float64:
        f = ((w0 << 20) | (w1 >> 12)).to(torch.float64) * 2.0**-52
    elif dtype == torch.float32:
        f = ((w0 ^ w1) >> 9).to(torch.float32) * 2.0**-23
    else:
        raise TypeError(f"uniform draws cover float32 and float64, not {dtype}")
    return f.reshape(keys.shape[:-1] + shape)


def uniform_shaped(keys: torch.Tensor, shape, dtype, minval=0.0,
                   maxval=1.0, cols=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` per key:
    ``max(minval, floats * (maxval - minval) + minval)`` in ``dtype``; with
    ``cols``, the columns ``[lo, hi)`` of its last axis."""
    f = _mantissa_floats(keys, shape, dtype, cols)
    lo = torch.tensor(minval, dtype=dtype, device=keys.device)
    hi = torch.tensor(maxval, dtype=dtype, device=keys.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's ErfInv (the polynomials of Giles, "Approximating the erfinv function")
# in the order XLA evaluates them.  float32: one polynomial in w - 2.5 for
# w = -log1p(-x^2) < 5, another in sqrt(w) - 3; float64: three ranges.
_ERFINV32_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
                 1.50140941)
_ERFINV32_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
                 2.83297682)
_ERFINV64_LT6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's ``ErfInv`` (``lax.erf_inv``) written in torch ops; ``±1`` map to
    ``±inf``.  It differs from XLA's only where the two ``log1p`` differ and
    where XLA contracts a product and a sum into one rounding: float32 within
    2 ulp, float64 within a few ulp."""
    def c(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    w = -torch.log1p(-(x * x))
    if x.dtype == torch.float32:
        lt = w < 5.0
        w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt, c(_ERFINV32_LT5[0]), c(_ERFINV32_GE5[0]))
        for a, b in zip(_ERFINV32_LT5[1:], _ERFINV32_GE5[1:]):
            p = torch.where(lt, c(a), c(b)) + p * w
    else:
        lt6, lt16 = w < 6.25, w < 16.0
        w = torch.where(lt6, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, c(3.25), c(5.0)))

        def coef(i):
            k = c(_ERFINV64_LT6_25[i])
            if i < 19:
                k = torch.where(lt6, k, c(_ERFINV64_LT16[i]))
            if i < 17:
                k = torch.where(lt16, k, c(_ERFINV64_GE16[i]))
            return k

        p = coef(0)
        for i in range(1, 17):
            p = coef(i) + p * w
        for i in range(17, 19):
            p = torch.where(lt16, coef(i) + p * w, p)
        for i in range(19, 23):
            p = torch.where(lt6, coef(i) + p * w, p)
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal_shaped(keys: torch.Tensor, shape, dtype, cols=None) -> torch.Tensor:
    """``jax.random.normal(key, shape, dtype)`` per key: ``sqrt(2)
    erf_inv(u)`` for ``u`` uniform on ``[nextafter(-1, 0), 1)``; with
    ``cols``, the columns ``[lo, hi)`` of its last axis."""
    lo = float(np.nextafter(np.array(-1.0, _NP[dtype]), np.array(0.0, _NP[dtype])))
    u = uniform_shaped(keys, shape, dtype, lo, 1.0, cols)
    return torch.tensor(float(_NP[dtype](np.sqrt(2))), dtype=dtype,
                        device=keys.device) * erf_inv(u)


def categorical(keys: torch.Tensor, logits: torch.Tensor, dims=LOCAL) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` per key over the last axis of
    ``logits`` ``(..., n)``: the first argmax of ``logits`` plus Gumbel noise
    ``-log(-log(u))``, ``u`` uniform on ``[tiny, 1)`` (JAX's "low" mode).
    Over a coordinate group ``dims`` (``core/dims.py``), ``logits`` holds
    this process's slice and the index is the global one."""
    dtype = logits.dtype
    u = uniform_shaped(keys, (dims.size(logits),), dtype, torch.finfo(dtype).tiny, 1.0,
                       cols=dims.cols)
    return dims.argmax(-torch.log(-torch.log(u)) + logits)

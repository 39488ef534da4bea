"""threefry2x32 keys and draws, bit for bit as ``jax.random`` makes them
(jax 0.9.0 with ``jax_threefry_partitionable`` on, its default; port of
``jax/_src/prng.py`` and ``jax/_src/random.py``).

A key is two uint32 words, a numpy ``(2,)`` uint32 array (the raw key
data of ``jax.random.PRNGKey``), or a stack of them ``(..., 2)``.
Deriving keys (:func:`PRNGKey`, :func:`split`, :func:`fold_in`) and the
small draws (:func:`uniform`, :func:`randint` on the host) are numpy,
whose uint32 arithmetic wraps as the hash needs: they never touch a
device.  The one wide draw, a uniform per row, runs on a tensor's
device (:func:`uniform_rows`) in int64 arithmetic cut to 32 bits after
each add and shift, and reads nothing back.

The partitionable mode is the only mode: a draw of shape S hashes the
64-bit row-major index of each element, high word and low word, and
takes ``bits1 ^ bits2`` (``prng.py:1184``); ``split`` hashes the index
of each new key (``prng.py:1156``).
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np

MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA                   # threefry's key-schedule constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Shape = Union[int, Sequence[int]]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(
        int(s) for s in shape)


# ------------------------------------------------------------------ core
def _threefry_np(k1, k2, x0, x1):
    """threefry2x32's 20 rounds on numpy uint32 words (``prng.py:863,
    883``): keys and counts broadcast against each other."""
    u = np.uint32
    k1, k2 = np.asarray(k1, u), np.asarray(k2, u)
    ks = (k1, k2, k1 ^ k2 ^ u(_PARITY))
    with np.errstate(over="ignore"):
        x0 = np.asarray(x0, u) + ks[0]
        x1 = np.asarray(x1, u) + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = (x1 << u(r)) | (x1 >> u(32 - r))
                x1 = x0 ^ x1
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + u(i + 1)
    return x0, x1


def _iota_2x32(shape: Tuple[int, ...]):
    """The 64-bit row-major index of each element of ``shape`` as (high,
    low) uint32 words (``prng.py:989``)."""
    n = math.prod(shape)
    idx = np.arange(n, dtype=np.uint64).reshape(shape)
    return ((idx >> np.uint64(32)).astype(np.uint32),
            (idx & np.uint64(MASK)).astype(np.uint32))


def _words(key):
    key = np.asarray(key, np.uint32)
    if key.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 uint32 words, got shape {key.shape}")
    return key[..., 0], key[..., 1]


# ------------------------------------------------------------------ keys
def PRNGKey(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` (``prng.py:802``): the seed's high
    and low 32 bits.  A seed in int32's range, as JAX holds it without
    x64, has a high word of 0."""
    seed = int(seed)
    hi = 0 if -2 ** 31 <= seed < 2 ** 31 else (seed >> 32) & MASK
    return np.array([hi, seed & MASK], np.uint32)


def fold_in(key, data) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` (``prng.py:1168``): the hash of
    the counter pair (0, data) under ``key``.  ``key`` may be a stack
    ``(..., 2)`` and ``data`` an integer array: they broadcast, one key
    per pair."""
    k1, k2 = _words(key)
    data = (np.asarray(data, np.int64) & MASK).astype(np.uint32)
    x0, x1 = _threefry_np(k1, k2, np.zeros_like(data), data)
    return np.stack([x0, x1], axis=-1)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` (``prng.py:1156``): ``(num, 2)``
    new keys, key i the hash of the counter pair (0, i); a stack of keys
    ``(..., 2)`` gives ``(..., num, 2)``."""
    k1, k2 = _words(key)
    hi, lo = _iota_2x32((int(num),))
    x0, x1 = _threefry_np(k1[..., None], k2[..., None], hi, lo)
    return np.stack([x0, x1], axis=-1)


# ------------------------------------------------------------- host draws
def random_bits(key, shape: Shape) -> np.ndarray:
    """32-bit ``jax.random.bits``: ``bits1 ^ bits2`` of the hashed
    element indices (``prng.py:1184``); a stack of keys ``(..., 2)``
    gives ``(..., *shape)``, each key's own draw."""
    shape = _shape(shape)
    k1, k2 = _words(key)
    lead = (slice(None),) * k1.ndim + (None,) * len(shape)
    hi, lo = _iota_2x32(shape)
    b1, b2 = _threefry_np(k1[lead], k2[lead], hi, lo)
    return b1 ^ b2


def _bits_to_unit(bits: np.ndarray) -> np.ndarray:
    """The top 23 bits as a float in [0, 1): ORed into 1.0's exponent,
    then 1.0 taken off (``random.py:435``)."""
    f = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
    return f - np.float32(1.0)


def uniform(key, shape: Shape = (), minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32, on the host.  XLA fuses the
    scaling ``floats * (maxval - minval) + minval`` into one multiply-add
    with one rounding; the float64 product of two float32s is exact, so
    it is formed there and rounded to float32 once."""
    lo, hi = np.float32(minval), np.float32(maxval)
    floats = _bits_to_unit(random_bits(key, shape))
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def randint(key, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint`` in int32 (``random.py:581``): two bit
    streams from a 2-way split, each reduced modulo the span and
    combined with ``2**32 mod span``, all in wrapping uint32."""
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    minv = min(max(int(minval), lo32), hi32)
    maxv = min(max(int(maxval), lo32), hi32)
    out_of_range = int(maxval) > hi32
    keys = split(key)
    higher = random_bits(keys[..., 0, :], shape)
    lower = random_bits(keys[..., 1, :], shape)
    u = np.uint32
    span = u((maxv - minv) & MASK)
    if maxv <= minv:
        span = u(1)
    if out_of_range and maxv > minv:
        span = u((int(span) + 1) & MASK)
    with np.errstate(over="ignore", divide="ignore"):
        if span == 0:       # a span of 2**32: the remainders do nothing
            offset = higher * u(0) + lower
        else:
            mult = u(2 ** 16) % span
            mult = (mult * mult) % span
            offset = ((higher % span) * mult + lower % span) % span
    return (np.int64(minv) + offset.astype(np.int64)).astype(np.int32)


# ----------------------------------------------------------- device draws
def _threefry_torch(k1, k2, x0, x1):
    """threefry2x32 on int64 tensors holding uint32 words: every add and
    shift is cut back to 32 bits.  ``k1`` / ``k2`` are Python ints or
    int64 tensors that broadcast against the counts; ``x0`` may be one
    of them too (a high word that is the same for every count).  Each
    key injection adds one constant, ``key + round`` folded first."""
    def add(a, b):
        return (a + b) & MASK
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = add(x0, ks[0])
    x1 = add(x1, ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = add(x0, x1)
            x1 = ((x1 << r) & MASK) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = add(x0, ks[(i + 1) % 3])
        x1 = add(x1, add(ks[(i + 2) % 3], i + 1))
    return x0, x1


def _bits_rows(keys, n: int, device) -> "torch.Tensor":
    """32-bit ``jax.random.bits(key, (n,))`` for each key of ``keys``
    (``(2,)`` -> ``(n,)``, ``(T, 2)`` -> ``(T, n)``) as int64 tensors
    holding uint32 words on ``device``."""
    import torch
    keys = np.asarray(keys, np.uint32)
    if keys.ndim == 1:
        k1, k2 = int(keys[0]), int(keys[1])
    else:
        kt = torch.from_numpy(keys.astype(np.int64)).to(device,
                                                        non_blocking=True)
        k1, k2 = kt[:, 0:1], kt[:, 1:2]
    idx = torch.arange(n, dtype=torch.int64, device=device)
    # the counters' high words: 0 below 2**32 rows, a constant then
    hi = 0 if n <= 2 ** 32 else idx >> 32
    b1, b2 = _threefry_torch(k1, k2, hi, idx & MASK)
    return b1 ^ b2


def uniform_rows(keys, n: int, device) -> "torch.Tensor":
    """``jax.random.uniform(key, (n,))`` for each key of ``keys`` (one
    key ``(2,)`` -> ``(n,)``; a stack ``(T, 2)`` -> ``(T, n)``), float32
    on ``device``.  The keys are kernel arguments (one key) or one small
    upload (a stack); nothing is read back."""
    import torch
    bits = _bits_rows(keys, n, device) >> 9 | 0x3F800000
    # int64 -> int32 keeps the low 32 bits: the float's bit pattern
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)


def _mul32(a, b):
    """``a * b`` modulo 2**32 for int64 tensors (or ints) holding uint32
    words, in 16-bit halves so no product leaves int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK


def randint_rows(key, shape: Shape, minval: int, maxval: int,
                 device) -> "torch.Tensor":
    """``jax.random.randint(key, shape, minval, maxval)`` as an int32
    tensor on ``device``: :func:`randint`'s arithmetic on the device's
    bit streams, element i of the row-major ``shape`` hashing index i."""
    import torch
    shape = _shape(shape)
    lo32, hi32 = -2 ** 31, 2 ** 31 - 1
    minv = min(max(int(minval), lo32), hi32)
    maxv = min(max(int(maxval), lo32), hi32)
    span = (maxv - minv) & MASK if maxv > minv else 1
    if int(maxval) > hi32 and maxv > minv:
        span = (span + 1) & MASK
    keys = split(key)
    n = math.prod(shape)
    higher = _bits_rows(keys[0], n, device)
    lower = _bits_rows(keys[1], n, device)
    if span == 0:           # a span of 2**32: the remainders do nothing
        offset = lower
    else:
        mult = ((2 ** 16 % span) ** 2 & MASK) % span   # uint32 wraps
        offset = (_mul32(higher % span, mult) + lower % span) & MASK
        offset = offset % span
    return (minv + offset).to(torch.int32).reshape(shape)

"""Counter-based threefry2x32 draws on the host, bit for bit those of the
JAX package (its ``jax.random`` under the default ``threefry2x32``
implementation with ``jax_threefry_partitionable=True`` and 32-bit ints).

The JAX package draws the diagnostics' randomness with ``jax.random``: the
fitting diagnostic's partition tags (``randint(PRNGKey(seed), (N,), 0,
10)``) and the bootstrap's resample counts (``split`` then a per-replicate
``randint`` and a scatter-add). Reproducing those bits here, in numpy, means
one ``seed`` gives the same resample in both packages. The draws are made on
the host and handed to the device as tensors.

  * A key is a ``(2,)`` uint32 array ``(k1, k2)``; ``prng_key(seed)`` is
    ``(0, seed & 0xffffffff)`` for a 32-bit seed, as ``threefry_seed``.
  * Partitionable layout: element ``i`` of a draw of shape ``S`` hashes the
    counter pair ``(hi32(i), lo32(i))`` of its flat index under the key, and
    32-bit draws are the xor of the two output words.
  * ``split(key, n)`` is the same hash of ``0 .. n-1``, both words kept.
  * ``randint`` draws two 32-bit words per element under the two halves of
    ``split(key)`` and reduces ``hi * (2^32 mod span) + lo`` mod ``span``
    with uint32 wraparound, exactly as ``jax.random.randint``.

Reference: Salmon et al., "Parallel random numbers: as easy as 1, 2, 3"
(SC 2011); the round constants and rotations are Threefry-2x32's.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)

Shape = Union[int, Sequence[int]]


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 (20 rounds) of the counter words ``(x0, x1)`` under
    ``key``; returns the two output words."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, _U32) + ks[0], np.asarray(x1, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for block in range(5):
            for r in _ROTATIONS[block % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(block + 1) % 3]
            x[1] = x[1] + ks[(block + 2) % 3] + _U32(block + 1)
    return x[0], x[1]


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s) for s in shape)


def _counters(shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
    """The flat index of every element as (hi, lo) uint32 words."""
    flat = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64).reshape(shape)
    return (flat >> np.uint64(32)).astype(_U32), (flat & np.uint64(0xFFFFFFFF)).astype(_U32)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s raw key data. A seed that fits 32 bits
    is a 32-bit int there, whose logical shift by 32 is 0."""
    seed = int(seed)
    if -(1 << 31) <= seed < (1 << 31):
        return np.array([0, seed & 0xFFFFFFFF], _U32)
    seed &= 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], _U32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    hi, lo = _counters((int(num),))
    b0, b1 = threefry2x32(key, hi, lo)
    return np.stack([b0, b1], axis=-1)


def random_bits(key: np.ndarray, shape: Shape) -> np.ndarray:
    """32 uniform bits per element (``jax.random.bits`` at uint32)."""
    b0, b1 = threefry2x32(key, *_counters(_shape(shape)))
    return b0 ^ b1


def randint(key: np.ndarray, shape: Shape, minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` at int32."""
    k_hi, k_lo = split(key)
    higher, lower = random_bits(k_hi, shape), random_bits(k_lo, shape)
    info = np.iinfo(np.int32)
    lo_v = int(np.clip(minval, info.min, info.max))
    hi_v = int(np.clip(maxval, info.min, info.max))
    span = _U32(1) if hi_v <= lo_v else _U32((hi_v - lo_v) & 0xFFFFFFFF)
    if maxval > info.max and hi_v > lo_v:
        span = _U32((int(span) + 1) & 0xFFFFFFFF)
    with np.errstate(over="ignore", divide="ignore"):
        if span == 0:  # the full 2^32 range: the remainders are no-ops
            offset = higher * _U32(0) + lower
        else:
            multiplier = _U32((1 << 16) % int(span))
            multiplier = multiplier * multiplier % span
            offset = (higher % span * multiplier + lower % span) % span
    return (np.int64(lo_v) + offset.astype(np.int64)).astype(np.int32)


def uniform(key: np.ndarray, shape: Shape, minval: float = 0.0, maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled. XLA
    compiles the scale and shift into one fused multiply-add (one rounding);
    the f32 product is exact in float64, so the sum there rounds once more
    only on an exact tie of the float32 rounding."""
    bits = random_bits(key, shape)
    one = np.array(1.0, np.float32).view(_U32)
    floats = ((bits >> _U32(9)) | one).view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo) + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, scaled)


def bootstrap_counts(seed: int, num_samples: int, n: int) -> np.ndarray:
    """The JAX bootstrap's ``(num_samples, n)`` resample counts: replicate
    ``r`` draws ``n`` row indices by ``randint(split(PRNGKey(seed),
    num_samples)[r], (n,), 0, n)`` and counts them (float32)."""
    keys = split(prng_key(seed), num_samples)
    counts = np.zeros((num_samples, n), np.float32)
    for r in range(num_samples):
        counts[r] = np.bincount(randint(keys[r], (n,), 0, n), minlength=n)
    return counts

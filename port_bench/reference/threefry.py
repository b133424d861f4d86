"""``jax.random``'s threefry2x32 draws in NumPy, as far as the loss
normaliser needs them: ``split`` and ``randint`` of a raw key in jax's
partitionable layout (jax 0.9.0's default).

The program's normaliser (``mean_pairwise_distance`` above 2048 rows)
samples its pairs with these draws from the fixed key ``PRNGKey(0)``; the
reference draws the same pairs here, from the published algorithm
(Salmon et al. 2011, 20 rounds; jax's counter layouts), without the
program's code.  Keys are (2,) uint32 arrays.
"""
from __future__ import annotations

import numpy as np

_MASK = np.uint64(0xFFFFFFFF)
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _MASK


def hash2x32(key, x0, x1):
    """The 20-round Threefry-2x32 of counters (x0, x1) under ``key``; uint32
    words in uint64 arrays."""
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    k2 = k0 ^ k1 ^ np.uint64(0x1BD11BDA)
    ks = (k0, k1, k2)
    x0 = (np.asarray(x0, np.uint64) + k0) & _MASK
    x1 = (np.asarray(x1, np.uint64) + k1) & _MASK
    for g in range(5):
        for r in _ROT[g % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & _MASK
        x1 = (x1 + ks[(g + 2) % 3] + np.uint64(g + 1)) & _MASK
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) keys: counter k hashes to the words of key k."""
    k = np.arange(num, dtype=np.uint64)
    x0, x1 = hash2x32(key, k >> np.uint64(32), k & _MASK)
    return np.stack([x0, x1], -1).astype(np.uint32)


def random_bits(key, m: int) -> np.ndarray:
    """(m,) uint32 words: word k is the XOR of the hash of counter k."""
    k = np.arange(m, dtype=np.uint64)
    x0, x1 = hash2x32(key, k >> np.uint64(32), k & _MASK)
    return (x0 ^ x1).astype(np.uint32)


def randint(key, m: int, lo: int, hi: int) -> np.ndarray:
    """(m,) int64 draws of ``jax.random.randint(key, (m,), lo, hi)`` for a
    span that fits int32: two words a value, reduced modulo the span with
    uint32 wrap-around."""
    k1, k2 = split(key)
    higher = random_bits(k1, m).astype(np.uint64)
    lower = random_bits(k2, m).astype(np.uint64)
    span = np.uint64(hi - lo)
    mult = np.uint64((2 ** 16) % int(span))
    mult = ((mult * mult) & _MASK) % span
    offset = (((higher % span) * mult) & _MASK) + lower % span
    offset = (offset & _MASK) % span
    return offset.astype(np.int64) + lo

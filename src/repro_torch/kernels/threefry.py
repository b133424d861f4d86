"""Threefry-2x32 counter-mode bits, the hash behind ``jax.random``, for a
batch of keys: the kernel of ``csrc/threefry.cu`` beside its plain twin.

``threefry_bits(keys, m, mode)`` takes keys (R, 2) int64 holding uint32
words and returns (R, m) int32 *sort words* ``word - 2**31`` (the word
with its top bit flipped), whose signed order is the words' unsigned
order, so a stable sort takes them as they are; ``words`` gives the
uint32 values back as int64.  The layouts of ``jax._src.prng``
(``mode``):

* ``ORIGINAL`` — ``threefry_2x32(key, iota(m))`` as jax < 0.5 draws
  ``random_bits`` and ``split`` (``jax_threefry_partitionable`` off): the
  counts cut in two halves, pair i hashing (i, h + i), h = ceil(m / 2);
* ``XOR`` — ``_threefry_random_bits_partitionable`` (jax 0.9.0's
  default): word k the XOR of the hash of the 64-bit counter k;
* ``PAIRS`` — ``_threefry_split_foldlike``: counter k gives words 2k and
  2k + 1 (m even).

CPU tensors run the twin (``threefry_bits_plain``, int64 torch ops masked
to 32 bits); CUDA tensors launch the kernel, counted in
``threefry_bits.launches``, and raise if the launch fails.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import clib

ORIGINAL, XOR, PAIRS = 0, 1, 2
MASK = 0xFFFFFFFF
TOP = 2 ** 31
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32_plain(k0, k1, x0, x1):
    """The 20-round hash of ``jax._src.prng._threefry2x32_lowering`` on
    int64 tensors holding uint32 words; the keys broadcast against the
    counts.  Returns the two output words."""
    k2 = k0 ^ k1 ^ 0x1BD11BDA
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for g in range(5):
        for r in _ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def _counts(m: int, mode: int, device):
    """(x0, x1) counter words (1, items) of each layout."""
    if mode == ORIGINAL:
        h = (m + 1) // 2
        i = torch.arange(h, dtype=torch.int64, device=device)
        hi = h + i
        return i[None], torch.where(hi < m, hi, torch.zeros_like(hi))[None]
    items = m if mode == XOR else m // 2
    k = torch.arange(items, dtype=torch.int64, device=device)
    return (k >> 32)[None], (k & MASK)[None]


def words(sort_words):
    """The uint32 words, as int64, of ``threefry_bits``' int32 sort
    words."""
    return sort_words.to(torch.int64) + TOP


def threefry_bits_plain(keys, m: int, mode: int):
    """Twin of the kernel: (R, m) int32 sort words of keys (R, 2)."""
    r = keys.shape[0]
    k0, k1 = keys[:, 0:1] & MASK, keys[:, 1:2] & MASK
    x0, x1 = threefry2x32_plain(k0, k1, *_counts(m, mode, keys.device))
    if mode == ORIGINAL:
        out = torch.cat([x0, x1], dim=1)[:, :m].reshape(r, m)
    elif mode == XOR:
        out = x0 ^ x1
    else:
        out = torch.stack([x0, x1], dim=-1).reshape(r, m)
    return (out - TOP).to(torch.int32)


def _check(keys, m: int, mode: int) -> None:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be (R, 2) int64, got {keys.dtype} "
                         f"{tuple(keys.shape)}")
    if mode not in (ORIGINAL, XOR, PAIRS):
        raise ValueError(f"unknown threefry layout {mode}")
    if m < 0 or (mode == PAIRS and m % 2) or (mode == ORIGINAL
                                               and m >= 2 ** 32):
        raise ValueError(f"{m} words do not fit layout {mode}")


def threefry_bits(keys, m: int, mode: int):
    """(R, m) int32 sort words of keys (R, 2) int64 in layout
    ``mode``."""
    m = int(m)
    _check(keys, m, mode)
    if clib.route(keys) == "cpu":
        return threefry_bits_plain(keys, m, mode)
    keys = keys.contiguous()
    out = torch.empty((keys.shape[0], m), dtype=torch.int32,
                      device=keys.device)
    if keys.shape[0] and m:
        clib.launch(threefry_bits, "threefry", "tf_bits",
                    (clib.P, clib.P, clib.I, clib.L, clib.I), keys, out,
                    keys.shape[0], m, mode)
    return out


KERNELS = (threefry_bits,)
threefry_bits.launches = 0

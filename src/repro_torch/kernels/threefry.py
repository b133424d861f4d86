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
  2k + 1 (m even);
* ``FOLD`` — ``PAIRS`` from the counter ``ctr`` on: ``fold_in(key,
  data)`` is the hash of the one counter ``data mod 2**32`` (m = 2), and
  ``threefry_2x32`` of one counter pair (x0, x1) that of ``x0 << 32 |
  x1``.

``threefry_given(keys, counts)`` is ``threefry_2x32(key, count)`` of a
count of m words held on the keys' device (int64 uint32 words, read
there, never on the host): the ``ORIGINAL`` pairing with those words in
place of ``iota(m)``, pair i hashing ``(counts[i], counts[h + i])``, 0
past m (the one word an odd count pads).  Its twin is
``threefry_given_plain``.

``threefry_round(keys, n, rounds, partitionable, split_keys)`` fuses one
shuffle round (``ThreefryShuffleSource.next_round`` and ``permutation``)
into one launch: the kept keys of ``split(keys)`` (when ``split_keys``)
and the (rounds, R, n) sort words of every ``permutation`` round, the key
chain recomputed in the kernel.  Its twin ``threefry_round_plain`` is the
composition of ``threefry_bits_plain`` calls the unfused draw makes.
``threefry_round_op`` is it without the split, as the custom op
``repro_torch::threefry_round`` (``permutation`` calls it): one op on
``meta`` tensors too.

CPU tensors run the twins (int64 torch ops masked to 32 bits); CUDA
tensors launch the kernels, counted in ``threefry_bits.launches``,
``threefry_round.launches`` and ``threefry_given.launches``, and raise if
the launch fails.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import clib

ORIGINAL, XOR, PAIRS, FOLD = 0, 1, 2, 3
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


def _counts(m: int, mode: int, device, ctr: int = 0):
    """(x0, x1) counter words (1, items) of each layout."""
    if mode == ORIGINAL:
        h = (m + 1) // 2
        i = torch.arange(h, dtype=torch.int64, device=device)
        hi = h + i
        return i[None], torch.where(hi < m, hi, torch.zeros_like(hi))[None]
    items = m if mode == XOR else m // 2
    k = torch.arange(items, dtype=torch.int64, device=device)
    if mode == FOLD:        # ctr + k as two words, without int64 overflow
        k = k + (ctr & MASK)
        return (((k >> 32) + (ctr >> 32)) & MASK)[None], (k & MASK)[None]
    return (k >> 32)[None], (k & MASK)[None]


def words(sort_words):
    """The uint32 words, as int64, of ``threefry_bits``' int32 sort
    words."""
    return sort_words.to(torch.int64) + TOP


def threefry_bits_plain(keys, m: int, mode: int, ctr: int = 0):
    """Twin of the kernel: (R, m) int32 sort words of keys (R, 2)."""
    r = keys.shape[0]
    k0, k1 = keys[:, 0:1] & MASK, keys[:, 1:2] & MASK
    x0, x1 = threefry2x32_plain(k0, k1, *_counts(m, mode, keys.device,
                                                  ctr))
    if mode == ORIGINAL:
        out = torch.cat([x0, x1], dim=1)[:, :m].reshape(r, m)
    elif mode == XOR:
        out = x0 ^ x1
    else:
        out = torch.stack([x0, x1], dim=-1).reshape(r, m)
    return (out - TOP).to(torch.int32)


def _check_keys(keys) -> None:
    if keys.dim() != 2 or keys.shape[1] != 2 or keys.dtype != torch.int64:
        raise ValueError(f"keys must be (R, 2) int64, got {keys.dtype} "
                         f"{tuple(keys.shape)}")


def _check(keys, m: int, mode: int, ctr: int) -> None:
    _check_keys(keys)
    if mode not in (ORIGINAL, XOR, PAIRS, FOLD):
        raise ValueError(f"unknown threefry layout {mode}")
    if m < 0 or (mode in (PAIRS, FOLD) and m % 2) or (
            mode == ORIGINAL and m >= 2 ** 32):
        raise ValueError(f"{m} words do not fit layout {mode}")
    if not 0 <= ctr or ctr + m // 2 > 2 ** 64:
        raise ValueError(f"counter {ctr} leaves 64 bits")


def threefry_bits(keys, m: int, mode: int, ctr: int = 0):
    """(R, m) int32 sort words of keys (R, 2) int64 in layout
    ``mode``; ``ctr`` is ``FOLD``'s first counter."""
    m, ctr = int(m), int(ctr)
    _check(keys, m, mode, ctr)
    if clib.route(keys) == "cpu":
        return threefry_bits_plain(keys, m, mode, ctr)
    keys = keys.contiguous()
    out = torch.empty((keys.shape[0], m), dtype=torch.int32,
                      device=keys.device)
    if keys.shape[0] and m:
        # the counter passes as the signed 64-bit word of its bits
        clib.launch(threefry_bits, "threefry", "tf_bits",
                    (clib.P, clib.P, clib.I, clib.L, clib.I, clib.L), keys,
                    out, keys.shape[0], m, mode,
                    ctr - 2 ** 64 if ctr >= 2 ** 63 else ctr)
    return out


def threefry_given_plain(keys, counts):
    """Twin of ``threefry_given``: the halves of the padded count through
    the bare hash."""
    m = counts.numel()
    h = (m + 1) // 2
    padded = torch.cat([counts & MASK, counts.new_zeros(2 * h - m)])
    x0, x1 = threefry2x32_plain(keys[:, 0:1] & MASK, keys[:, 1:2] & MASK,
                                padded[None, :h], padded[None, h:])
    return (torch.cat([x0, x1], dim=1)[:, :m] - TOP).to(torch.int32)


def threefry_given(keys, counts):
    """(R, m) int32 sort words of ``threefry_2x32(key r, counts)`` for
    keys (R, 2) int64 and counts (m,) int64 words on the keys' device."""
    _check_keys(keys)
    if counts.dtype != torch.int64 or counts.dim() != 1:
        raise ValueError(f"counts must be (m,) int64, got {counts.dtype} "
                         f"{tuple(counts.shape)}")
    if clib.route(keys, counts) == "cpu":
        return threefry_given_plain(keys, counts)
    keys = keys.contiguous()
    m = counts.numel()
    out = torch.empty((keys.shape[0], m), dtype=torch.int32,
                      device=keys.device)
    if keys.shape[0] and m:
        clib.launch(threefry_given, "threefry", "tf_given",
                    (clib.P, clib.P, clib.P, clib.I, clib.L), keys,
                    counts.contiguous(), out, keys.shape[0], m)
    return out


def permutation_rounds(n: int) -> int:
    """``jax.random.permutation``'s shuffle rounds for n items:
    ``ceil(3 ln n / ln(2**32 - 1))``, enough for 32-bit sort keys to leave
    few ties (2 at n = 4096, 1 at n <= 1625)."""
    return int(np.ceil(3 * np.log(max(1, int(n)))
                       / np.log(np.iinfo(np.uint32).max)))


def threefry_round_plain(keys, n: int, rounds: int, partitionable: bool,
                         split_keys: bool):
    """Twin of ``threefry_round``: the unfused draw's ``split`` and sort
    word calls.  (kept (R, 2) int64 words or None, (rounds, R, n) int32
    sort words)."""
    split_mode = PAIRS if partitionable else ORIGINAL
    bits_mode = XOR if partitionable else ORIGINAL

    def split(k):
        pair = words(threefry_bits_plain(k, 4, split_mode)).reshape(-1, 2, 2)
        return pair[:, 0], pair[:, 1]

    kept, k = split(keys) if split_keys else (None, keys)
    out = []
    for _ in range(int(rounds)):
        k, sub = split(k)
        out.append(threefry_bits_plain(sub, int(n), bits_mode))
    return kept, (torch.stack(out) if out else torch.empty(
        (0, keys.shape[0], int(n)), dtype=torch.int32, device=keys.device))


def threefry_round(keys, n: int, rounds: int, partitionable: bool,
                   split_keys: bool):
    """One shuffle round in one launch: with ``split_keys``, ``kept, sub =
    split(keys)``, else ``sub = keys``; then ``rounds`` permutation rounds
    of ``sub, t = split(sub)`` drawing n sort words from each ``t``.
    keys (R, 2) int64; returns (kept (R, 2) int64 words or None,
    (rounds, R, n) int32 sort words)."""
    n, rounds = int(n), int(rounds)
    _check_keys(keys)
    if n < 0 or rounds < 0 or (not partitionable and n >= 2 ** 32):
        raise ValueError(f"{rounds} rounds of {n} words do not fit")
    if clib.route(keys) == "cpu":
        return threefry_round_plain(keys, n, rounds, partitionable,
                                    split_keys)
    keys = keys.contiguous()
    r = keys.shape[0]
    kept = torch.empty((r, 2), dtype=torch.int64,
                       device=keys.device) if split_keys else None
    out = torch.empty((rounds, r, n), dtype=torch.int32, device=keys.device)
    if r and (split_keys or (rounds and n)):
        clib.launch(threefry_round, "threefry", "tf_round",
                    (clib.P, clib.P, clib.P, clib.I, clib.L, clib.I, clib.I),
                    keys, kept if split_keys else None, out, r, n, rounds,
                    int(bool(partitionable)))
    return kept, out


@torch.library.custom_op("repro_torch::threefry_round", mutates_args=())
def threefry_round_op(keys: torch.Tensor, n: int, rounds: int,
                      partitionable: bool) -> torch.Tensor:
    """``threefry_round`` of ``permutation``'s own chain (no split first)
    as one custom op: (rounds, R, n) int32 sort words.  On CUDA one
    launch of the kernel, on the CPU the twin; on ``meta`` tensors only
    the shape, so that the dry-run's cost mode sees one op, priced by its
    bytes, where the card runs one launch."""
    return threefry_round(keys, n, rounds, partitionable, False)[1]


@threefry_round_op.register_fake
def _(keys, n, rounds, partitionable):
    return keys.new_empty((rounds, keys.shape[0], n), dtype=torch.int32)


KERNELS = (threefry_bits, threefry_round, threefry_given)
for _k in KERNELS:
    _k.launches = 0

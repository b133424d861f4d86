"""Self-organizing checkpoint compression: the paper's SOG idea applied to
weight tensors.

Counterpart of ``repro.runtime.sog_compress``.  Each 2-D weight (D, F) is
taken as F column vectors; ShuffleSoftSort (``repro_torch.core``, on the
card by default) lays them out on a grid so that neighbours correlate,
storing only the F permutation indices.  The permuted tensor is then
int8-quantized, delta-coded along the sorted order and deflated, all
host-side numpy and zlib exactly as the reference does it: given the same
order, the payload is byte for byte the reference's.  Correlated columns
(duplicated or co-adapted features, the common case in trained nets)
compress better once sorted; the permutation costs 4F bytes.  The round
trip is exact at the int8 quantization level.
"""
from __future__ import annotations

import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.core.prng import instance_seeds
from repro_torch.core.shufflesoftsort import (
    ShuffleSoftSortConfig,
    shuffle_soft_sort,
)


def _grid_hw(n: int) -> tuple[int, int]:
    """Near-square sorting grid for n columns; h * w >= n.

    An exact factorization when a near-square one exists (aspect ratio
    <= 2, no padding).  Otherwise (n prime, or its largest divisor <=
    sqrt(n) tiny) walking h down tends to a 1 x n grid, whose
    "neighbourhood" is a line; for those n a padded ceil(sqrt) x ceil grid
    (h * w - n < h extra cells), whose pad indices
    ``sog_compress_tensor`` drops from the permutation.
    """
    h = int(np.sqrt(n))
    while n % h:
        h -= 1
    if n // h <= 2 * h:
        return h, n // h
    h = int(np.ceil(np.sqrt(n)))
    return h, int(np.ceil(n / h))


def _quantize(w: np.ndarray) -> tuple[np.ndarray, float]:
    scale = float(np.max(np.abs(w))) / 127.0 + 1e-12
    return np.clip(np.round(w / scale), -127, 127).astype(np.int8), scale


def _encode(q: np.ndarray) -> bytes:
    # Delta along the sorted (column) axis, the first row kept verbatim
    # through a zero prepend, wrapped mod 256 (lossless for int8), then
    # deflate.
    delta = np.diff(q.astype(np.int16), axis=0,
                    prepend=np.zeros((1, q.shape[1]), np.int16))
    return zlib.compress(delta.astype(np.int8).tobytes(), level=6)


def _as_numpy(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        w = w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def sog_compress_tensor(
    w,
    *,
    sort_rounds: int = 120,
    feature_rows: int = 32,
    seed: int = 0,
    source=None,
    device=None,
) -> dict:
    """Compress one 2-D tensor (D, F) (a tensor on any device, or an
    array) into a blob dict: the payload, the permutation and the sizes,
    with the unsorted baseline's size beside them.

    The sort is ``shuffle_soft_sort`` with the reference's config
    (``rounds=sort_rounds, inner_steps=4``, ``chunk`` the largest divisor
    of the grid size up to 256) on ``device`` (CUDA unless told
    otherwise); ``seed`` seeds its shuffles, or ``source`` (a shuffle
    source of ``repro_torch.core.prng``) replaces them.
    """
    w = _as_numpy(w)
    assert w.ndim == 2, w.shape
    d, f = w.shape

    # Features for sorting: a subsample of rows, a cheap proxy for the
    # column.
    rows = np.linspace(0, d - 1, min(feature_rows, d)).astype(int)
    feats = w[rows].T                                    # (F, <=32)

    hw = _grid_hw(f)
    m = hw[0] * hw[1]
    if m > f:
        # Padded grid: trailing columns replicated as pad features
        # (they cluster beside their twins without distorting the
        # layout), then the pad indices dropped, leaving a permutation of
        # the real f columns in grid-scan order.
        feats = np.concatenate([feats, feats[f - (m - f):]], axis=0)
    # chunk divides the (possibly padded) grid size; the largest such
    # divisor <= 256 bounds the streamed apply's O(chunk * m) footprint.
    chunk = m if m <= 256 else max(c for c in range(1, 257) if m % c == 0)
    cfg = ShuffleSoftSortConfig(rounds=sort_rounds, inner_steps=4,
                                chunk=chunk)
    order, _, _ = shuffle_soft_sort(np.ascontiguousarray(feats), hw, cfg,
                                    seed=seed, source=source, device=device)
    if m > f:
        order = order[order < f]

    q_sorted, scale = _quantize(w.T[order])              # (F, D) sorted
    q_plain, _ = _quantize(w.T)
    payload = _encode(q_sorted)
    baseline = _encode(q_plain)

    return {
        "payload": payload,
        "perm": order.astype(np.int32),
        "scale": scale,
        "shape": (d, f),
        "bytes": len(payload) + 4 * f,                  # + stored permutation
        "baseline_bytes": len(baseline),
        "raw_bytes": w.nbytes,
    }


def sog_decompress_tensor(blob: dict) -> np.ndarray:
    d, f = blob["shape"]
    raw = zlib.decompress(blob["payload"])
    delta = np.frombuffer(raw, np.int8).reshape(f, d).astype(np.int32)
    q = np.cumsum(delta, axis=0).astype(np.int8)   # mod-256 wrap == exact
    wt = q.astype(np.float32) * blob["scale"]            # (F, D) sorted
    out = np.empty_like(wt)
    out[blob["perm"]] = wt                               # invert permutation
    return out.T                                         # (D, F)


def _flatten(tree, path=()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in the order ``jax.tree.flatten`` gives the
    leaves: dict keys sorted, lists and tuples in order, None no leaf."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree) for pl in _flatten(tree[k],
                                                            path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _flatten(v, path + (i,))]
    if tree is None:
        return []
    return [(path, tree)]


def compress_checkpoint(params: Any, *, min_cols: int = 64,
                        sort_rounds: int = 80, seed: int = 7,
                        device=None) -> dict:
    """Compress every >= 2-D weight of a nested dict (or list) of tensors
    or arrays whose last axis has at least ``min_cols`` columns (leading
    axes merged into D).  Returns ``blobs`` (None for a leaf left as it
    is) and ``paths`` (each leaf's keys), both in leaf order, and
    ``stats``: the summed sog, baseline and raw bytes, ``gain_vs_baseline``
    and ``ratio_vs_raw``.  Leaf i's sort is seeded with the i-th of
    ``instance_seeds(seed, leaves)``."""
    flat = _flatten(params)
    seeds = instance_seeds(seed, max(len(flat), 1))
    blobs, stats = [], {"sog_bytes": 0, "baseline_bytes": 0, "raw_bytes": 0}
    for (_, leaf), leaf_seed in zip(flat, seeds):
        arr = _as_numpy(leaf)
        if arr.ndim >= 2 and arr.shape[-1] >= min_cols:
            blob = sog_compress_tensor(arr.reshape(-1, arr.shape[-1]),
                                       sort_rounds=sort_rounds,
                                       seed=leaf_seed, device=device)
            blobs.append(blob)
            stats["sog_bytes"] += blob["bytes"]
            stats["baseline_bytes"] += blob["baseline_bytes"]
            stats["raw_bytes"] += blob["raw_bytes"]
        else:
            blobs.append(None)
    stats["gain_vs_baseline"] = (
        stats["baseline_bytes"] / max(stats["sog_bytes"], 1))
    stats["ratio_vs_raw"] = stats["raw_bytes"] / max(stats["sog_bytes"], 1)
    return {"blobs": blobs, "paths": [p for p, _ in flat], "stats": stats}

"""Self-Organizing Gaussians (paper section IV-B): sort the attributes of
3-D Gaussian splats into a 2-D grid to raise spatial correlation, then
compress the attribute planes with a standard codec (zlib as the
stand-in).

Counterpart of ``examples/self_organizing_gaussians.py``.  The original
SOG uses a heuristic non-differentiable sort because N is in the
millions; ShuffleSoftSort makes the sort learnable with only N stored
parameters (the permutation), the paper's headline application.

    PYTHONPATH=src python -m repro_torch.examples.self_organizing_gaussians \\
        [--n 1024] [--rounds 800] [--device cpu]

It runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import zlib

import numpy as np

from repro_torch.core import ShuffleSoftSortConfig, shuffle_soft_sort
from repro_torch.core.metrics import mean_neighbor_distance


def synthetic_scene(n, seed=0, noise=0.01):
    """Synthetic splat set with realistic attribute structure: all
    attributes are smooth functions of the surface parameterization (real
    3DGS scenes are spatially coherent: nearby splats share scale,
    orientation and color), plus a small jitter.  (n, 14) float32."""
    rng = np.random.RandomState(seed)
    t = rng.rand(n, 2) * 2 * np.pi
    pos = np.stack([np.cos(t[:, 0]), np.sin(t[:, 0]) * np.cos(t[:, 1]),
                    np.sin(t[:, 1])], -1)
    scale = 0.2 + 0.1 * np.abs(np.sin(3 * t))                # (n, 2) -> 3
    scale = np.concatenate([scale, scale[:, :1]], -1)
    rot = np.stack([np.cos(t[:, 0] / 2), np.sin(t[:, 0] / 2),
                    np.cos(t[:, 1] / 2), np.sin(t[:, 1] / 2)], -1)
    opacity = (0.5 + 0.5 * np.cos(t[:, :1]))
    color = 0.5 + 0.5 * np.stack(
        [np.cos(t[:, 0]), np.sin(t[:, 1]), np.cos(t.sum(1))], -1)
    attrs = np.concatenate([pos, scale, rot, opacity, color], -1)
    attrs += noise * rng.randn(*attrs.shape)
    return attrs.astype(np.float32)                          # (n, 14)


def plane_bytes(attrs, order, hw):
    """Compress each attribute as an (h, w) int8 plane (per-plane scale),
    zlib-deflated: the codec proxy for the paper's image codecs."""
    h, w = hw
    total = 0
    for j in range(attrs.shape[1]):
        plane = attrs[order, j].reshape(h, w)
        scale = np.max(np.abs(plane)) / 127.0 + 1e-12
        q = np.clip(np.round(plane / scale), -127, 127).astype(np.int8)
        # 2-D delta (horizontal) mimics intra-frame prediction
        delta = np.diff(q.astype(np.int16), axis=1,
                        prepend=np.zeros((h, 1), np.int16)).astype(np.int8)
        total += len(zlib.compress(delta.tobytes(), 6))
    return total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=800)
    ap.add_argument("--device", default=None,
                    help="torch device of the sort (default: CUDA)")
    args = ap.parse_args(argv)
    n = args.n
    hw = (int(np.sqrt(n)), int(np.sqrt(n)))
    if hw[0] * hw[1] != n:
        ap.error(f"--n {n} is not a square")

    attrs = synthetic_scene(n)
    raw = attrs.nbytes

    rng = np.random.RandomState(1)
    rand_order = rng.permutation(n)
    unsorted_bytes = plane_bytes(attrs, rand_order, hw)

    cfg = ShuffleSoftSortConfig(rounds=args.rounds, inner_steps=8,
                                chunk=min(512, n))
    order, _, _ = shuffle_soft_sort(attrs, hw, cfg, seed=5,
                                    device=args.device)
    # Splat order is free in 3DGS (the paper's key observation), so the
    # permutation is not stored: the sorted layout is the file.
    sorted_bytes = plane_bytes(attrs, order, hw)

    print(f"splats: {n}  attrs/splat: {attrs.shape[1]}  raw: {raw:,} B")
    print(f"codec (random order) : {unsorted_bytes:,} B "
          f"({raw / unsorted_bytes:.1f}x vs raw)")
    print(f"codec (SOG sorted)   : {sorted_bytes:,} B "
          f"({raw / sorted_bytes:.1f}x vs raw, "
          f"{unsorted_bytes / sorted_bytes:.2f}x vs unsorted)")
    print(f"neighbour distance   : "
          f"{mean_neighbor_distance(attrs[rand_order], hw):.3f} -> "
          f"{mean_neighbor_distance(attrs[order], hw):.3f}")
    if sorted_bytes >= unsorted_bytes:
        raise SystemExit("sorting did not help the codec")
    return {"n": n, "raw_bytes": raw, "random_bytes": unsorted_bytes,
            "sorted_bytes": sorted_bytes}


if __name__ == "__main__":
    main()

"""Multi-image grid sorting in one batch (the batched engine).

A gallery service sorts many image sets at once (one per user upload).
ShuffleSoftSort needs only N parameters per instance, so the batched
engine holds B catalogs x S random restarts on the device together,
trains them as one batch (each inner step launches every kernel once for
all of them), and keeps each catalog's best-loss restart.

Counterpart of ``examples/batched_image_grids.py``; shuffles come from the
port's seeded streams (``seed=0``), not from the reference's
``PRNGKey(0)``.

    PYTHONPATH=src python -m repro_torch.examples.batched_image_grids \\
        [--images 6] [--n 256] [--rounds 120] [--device cpu]

It runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import (
    ShuffleSoftSortConfig,
    shuffle_soft_sort,
    shuffle_soft_sort_batched,
)
from repro_torch.core.metrics import dpq
from repro_torch.examples.image_grid_sorting import square_grid


def synthetic_catalog(n, d=50, clusters=12, seed=0):
    """Clustered features mimicking one user's product-image catalog."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(clusters, d) * 2.0
    labels = rng.randint(0, clusters, n)
    x = centers[labels] + 0.4 * rng.randn(n, d)
    return x.astype(np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=6)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=120)
    ap.add_argument("--device", default=None,
                    help="torch device of the sort (default: CUDA)")
    args = ap.parse_args(argv)
    n_images, n, restarts = args.images, args.n, 2
    hw = square_grid(ap, n)
    xs = np.stack([synthetic_catalog(n, seed=i) for i in range(n_images)])
    cfg = ShuffleSoftSortConfig(rounds=args.rounds, inner_steps=8,
                                chunk=min(256, n))

    t0 = time.perf_counter()
    res = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=restarts,
                                    seed=0, device=args.device)
    wall = time.perf_counter() - t0
    print(f"sorted {n_images} catalogs x {restarts} restarts "
          f"({n_images * restarts} instances of N={n}) in {wall:.1f}s "
          f"-> {n_images / wall:.2f} catalogs/s")
    for b in range(n_images):
        print(f"  catalog {b}: dpq {dpq(xs[b], hw):.3f} -> "
              f"{dpq(res.sorted[b], hw):.3f}  "
              f"(best restart {res.best_restart[b]}, "
              f"final losses {np.round(res.all_losses[b, :, -1], 4)})")

    # Reference point: one catalog through the sequential API.
    t0 = time.perf_counter()
    shuffle_soft_sort(xs[0], hw, cfg, seed=0, device=args.device)
    print(f"(sequential API: {time.perf_counter() - t0:.1f}s per "
          f"catalog-restart)")
    return {"xs": xs, "result": res}


if __name__ == "__main__":
    main()

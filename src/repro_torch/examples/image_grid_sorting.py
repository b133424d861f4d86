"""Grid-based image sorting (paper section IV-A): arrange synthetic
'product image' feature vectors (50-dim, clustered; the paper uses 50-dim
low-level visual features) on a grid so that similar items are
neighbours.

Counterpart of ``examples/image_grid_sorting.py``; the sort draws its
shuffles from the port's seeded streams (``seed=3``), not from the
reference's ``PRNGKey(3)``.

    PYTHONPATH=src python -m repro_torch.examples.image_grid_sorting \\
        [--n 1024] [--rounds 500] [--device cpu]

It runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import ShuffleSoftSortConfig, shuffle_soft_sort
from repro_torch.core.metrics import dpq, mean_neighbor_distance


def synthetic_catalog(n=1024, d=50, clusters=24, seed=0):
    """Clustered features mimicking product categories: (n, d) float32
    features and their (n,) category labels."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(clusters, d) * 2.0
    labels = rng.randint(0, clusters, n)
    x = centers[labels] + 0.4 * rng.randn(n, d)
    return x.astype(np.float32), labels


def neighbor_label_agreement(labels, order, hw):
    """Fraction of horizontal/vertical neighbour pairs with equal category:
    a user-facing proxy for 'similar products are adjacent'."""
    h, w = hw
    g = labels[order].reshape(h, w)
    agree = (g[:, 1:] == g[:, :-1]).sum() + (g[1:, :] == g[:-1, :]).sum()
    total = h * (w - 1) + (h - 1) * w
    return agree / total


def square_grid(ap, n):
    """(h, w) of a square grid of n cells; an argparse error otherwise."""
    side = int(round(np.sqrt(n)))
    if side * side != n:
        ap.error(f"--n {n} is not a square")
    return side, side


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=500)
    ap.add_argument("--device", default=None,
                    help="torch device of the sort (default: CUDA)")
    args = ap.parse_args(argv)
    n = args.n
    hw = square_grid(ap, n)
    x, labels = synthetic_catalog(n)

    base_order = np.arange(n)
    before = {"dpq": dpq(x, hw), "nbr": mean_neighbor_distance(x, hw),
              "label_agree": neighbor_label_agreement(labels, base_order,
                                                      hw)}
    print(f"random layout : dpq={before['dpq']:.3f} "
          f"nbr={before['nbr']:.3f} "
          f"label-agree={before['label_agree']:.3f}")

    cfg = ShuffleSoftSortConfig(rounds=args.rounds, inner_steps=8,
                                chunk=min(256, n))
    order, xs, _ = shuffle_soft_sort(x, hw, cfg, seed=3, device=args.device)
    after = {"dpq": dpq(xs, hw), "nbr": mean_neighbor_distance(xs, hw),
             "label_agree": neighbor_label_agreement(labels, order, hw)}
    print(f"sorted layout : dpq={after['dpq']:.3f} "
          f"nbr={after['nbr']:.3f} "
          f"label-agree={after['label_agree']:.3f}")
    return {"order": order, "before": before, "after": after}


if __name__ == "__main__":
    main()

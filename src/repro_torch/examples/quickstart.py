"""Quickstart: the paper's flagship demo, 1024 random RGB colours sorted
onto a 32 x 32 grid with ShuffleSoftSort (N parameters only).

Counterpart of ``examples/quickstart.py``, on the reference's data and
noise: the colours are ``uniform(prng_key(42), (N, 3))`` and the sort runs
with ``key=prng_key(1)`` (``repro_torch.core.threefry``, bitwise
``jax.random``), as the reference's ``PRNGKey(42)`` and ``PRNGKey(1)``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--rounds 600] [--n 1024] [--use-kernel] [--device cpu]

Writes before/after PPM images into the working directory and prints
DPQ_16 and the mean neighbour distance (paper Fig. 1 / Table III).  It
runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import ShuffleSoftSortConfig, shuffle_soft_sort
from repro_torch.core.threefry import prng_key, uniform
from repro_torch.core.metrics import dpq, mean_neighbor_distance
from repro_torch.examples.image_grid_sorting import square_grid


def save_ppm(path, grid_colors, hw, cell=8):
    h, w = hw
    img = (np.asarray(grid_colors).reshape(h, w, 3) * 255).astype(np.uint8)
    img = np.repeat(np.repeat(img, cell, 0), cell, 1)
    with open(path, "wb") as f:
        f.write(f"P6 {img.shape[1]} {img.shape[0]} 255\n".encode())
        f.write(img.tobytes())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--rounds", type=int, default=600)
    ap.add_argument("--use-kernel", action="store_true",
                    help="route the apply through the kernel tier (the "
                         "CUDA kernels on the card, their plain twins on "
                         "the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device of the sort (default: CUDA)")
    args = ap.parse_args(argv)
    hw = square_grid(ap, args.n)
    x = uniform(prng_key(42), (args.n, 3), device=args.device).cpu().numpy()

    before = {"dpq": dpq(x, hw), "nbr": mean_neighbor_distance(x, hw)}
    print(f"random   : dpq={before['dpq']:.3f} nbr={before['nbr']:.3f}")
    save_ppm("colors_before.ppm", x, hw)

    cfg = ShuffleSoftSortConfig(rounds=args.rounds, inner_steps=8,
                                chunk=min(256, args.n),
                                use_kernel=args.use_kernel)
    order, xs, losses = shuffle_soft_sort(x, hw, cfg, key=prng_key(1),
                                          device=args.device)
    after = {"dpq": dpq(xs, hw), "nbr": mean_neighbor_distance(xs, hw)}
    print(f"sorted   : dpq={after['dpq']:.3f} nbr={after['nbr']:.3f} "
          f"(loss {losses[0]:.3f} -> {losses[-1]:.3f})")
    save_ppm("colors_after.ppm", xs, hw)
    print("wrote colors_before.ppm / colors_after.ppm")
    if sorted(order.tolist()) != list(range(args.n)):
        raise SystemExit("invalid permutation")
    return {"colors": x, "order": order, "before": before, "after": after,
            "losses": losses}


if __name__ == "__main__":
    main()

"""Clustered "product image" feature vectors, the paper's section IV-A
input: ``synthetic_catalog`` of the repository's image-grid example
(cluster centres N(0, 2^2), one centre a row, N(0, 0.4^2) jitter),
drawn in PyTorch from one generator on the run's device."""
from __future__ import annotations

import torch


def make(count: int, n: int, d: int, gen: torch.Generator, *,
         clusters: int) -> torch.Tensor:
    """(count, N, d) float32 catalogs, each with its own centres."""
    dev = gen.device
    centres = torch.randn((count, clusters, d), generator=gen,
                          device=dev) * 2.0
    labels = torch.randint(0, clusters, (count, n), generator=gen,
                           device=dev)
    x = torch.gather(centres, 1, labels[..., None].expand(-1, -1, d))
    return x + 0.4 * torch.randn((count, n, d), generator=gen, device=dev)

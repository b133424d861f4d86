"""Loss terms for grid-based permutation learning (paper eq. 2-4), in
PyTorch.

    L(P) = L_nbr(P) + lambda_s * L_s(P) + lambda_sigma * L_sigma(P)

Counterpart of ``repro.core.losses``.  Every term reduces over its
trailing axes only, so the same function serves one instance and a
(BS, ...) batch of instances (the batched engine's layout).
"""
from __future__ import annotations

import torch

from repro_torch.core import threefry


def neighbor_loss_grid(grid: torch.Tensor, norm=1.0) -> torch.Tensor:
    """Mean L2 distance between 4-neighbourhood grid cells of an
    (..., H, W, d) grid, over ``2 * norm``."""
    dh = torch.sqrt(torch.sum(torch.square(grid[..., :, 1:, :]
                                           - grid[..., :, :-1, :]), dim=-1)
                    + 1e-12)
    dv = torch.sqrt(torch.sum(torch.square(grid[..., 1:, :, :]
                                           - grid[..., :-1, :, :]), dim=-1)
                    + 1e-12)
    return (dh.mean(dim=(-2, -1)) + dv.mean(dim=(-2, -1))) / (2.0 * norm)


def stochastic_constraint_loss(colsum: torch.Tensor) -> torch.Tensor:
    """Eq. 3 — colsum is the (..., N) vector of column sums of P_soft."""
    return torch.mean(torch.square(colsum - 1.0), dim=-1)


def std_loss(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Eq. 4 — relative per-dimension std mismatch of (..., N, d) rows.
    Population std (``correction=0``), as ``jnp.std`` computes it."""
    sx = torch.std(x, dim=-2, correction=0)
    sy = torch.std(y, dim=-2, correction=0)
    return torch.mean(torch.abs(sx - sy) / (sx + 1e-12), dim=-1)


def grid_sorting_loss(
    y: torch.Tensor,
    colsum: torch.Tensor,
    x: torch.Tensor,
    hw: tuple[int, int],
    norm=1.0,
    lambda_s: float = 1.0,
    lambda_sigma: float = 2.0,
) -> torch.Tensor:
    """Paper eq. 2 with the published lambda_s=1, lambda_sigma=2.
    ``y``/``x`` are (..., N, d), ``colsum`` (..., N), ``norm`` broadcasts
    against the leading axes."""
    h, w = hw
    grid = y.reshape(*y.shape[:-2], h, w, y.shape[-1])
    return (neighbor_loss_grid(grid, norm)
            + lambda_s * stochastic_constraint_loss(colsum)
            + lambda_sigma * std_loss(x, y))


def mean_pairwise_distance(x: torch.Tensor, sample: int = 2048,
                           key=None, chunk: int = 256) -> torch.Tensor:
    """Normalization constant for L_nbr: mean distance of the pairs of the
    (N, d) rows of ``x``.  Exact (streamed in row chunks, the tail chunk
    padded and masked) up to ``N * N <= 4_194_304``; above that the mean
    over ``sample`` pairs drawn as the reference draws them: ``k1, k2 =
    split(key)``, ``i = randint(k1, (sample,), 0, N)``, ``j = randint(k2,
    ...)`` (``repro_torch.core.threefry``, bitwise ``jax.random``; ``key``
    is raw key data, None meaning ``prng_key(0)``).  The indices are drawn
    on the host, with the twin, and moved to ``x``'s device."""
    n = x.shape[0]
    if n * n <= 4_194_304:
        nb = -(-n // chunk)
        pad = nb * chunk - n
        xp = torch.nn.functional.pad(x, (0, 0, 0, pad))
        valid = (torch.arange(nb * chunk, device=x.device) < n).to(x.dtype)
        rows = []
        for b0 in range(0, nb * chunk, chunk):
            xi = xp[b0:b0 + chunk]
            d = torch.sqrt(torch.sum(torch.square(xi[:, None] - x[None, :]),
                                     dim=-1) + 1e-12)
            rows.append(torch.sum(d, dim=-1) * valid[b0:b0 + chunk])
        return torch.cat(rows).sum() / (n * (n - 1))
    k1, k2 = threefry.split(threefry.prng_key(0) if key is None else key,
                            device="cpu")
    i = threefry.randint(k1, (sample,), 0, n).to(x.device, torch.int64)
    j = threefry.randint(k2, (sample,), 0, n).to(x.device, torch.int64)
    return torch.mean(torch.sqrt(torch.sum(torch.square(x[i] - x[j]),
                                           dim=-1) + 1e-12))

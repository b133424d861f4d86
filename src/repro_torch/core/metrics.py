"""Layout-quality metrics (numpy only).

A copy of ``repro.core.metrics`` kept inside the port so that the port
stands alone.  ``dpq`` is Distance Preservation Quality (Barthel et al.,
CGF 2023): for each neighbourhood size k <= p, the mean feature distance
of every item to its k grid-nearest neighbours, set between the chance
level (random pairs) and the optimum (its k feature-nearest neighbours),
averaged over k = 1..p.  ``mean_neighbor_distance`` is reported beside it.
"""
from __future__ import annotations

import numpy as np


def _grid_positions(h: int, w: int) -> np.ndarray:
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([yy.ravel(), xx.ravel()], axis=-1).astype(np.float64)


def dpq(grid_vectors: np.ndarray, hw: tuple[int, int], p: int = 16) -> float:
    """Distance Preservation Quality of an (N, d) array laid out row-major
    on an (h, w) grid.  Higher is better; ~1.0 means grid neighbourhoods
    preserve feature neighbourhoods as well as theoretically possible."""
    x = np.asarray(grid_vectors, dtype=np.float64)
    h, w = hw
    n = x.shape[0]
    assert n == h * w, (n, hw)

    pos = _grid_positions(h, w)
    dg = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    df = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    np.fill_diagonal(dg, np.inf)
    np.fill_diagonal(df, np.inf)

    grid_order = np.argsort(dg, axis=1)   # (N, N-1) grid-nearest first
    feat_order = np.argsort(df, axis=1)

    d_rand = df[np.isfinite(df)].mean()

    # Cumulative mean feature distance of the k grid/feat-nearest items.
    take = np.arange(n)[:, None]
    df_by_grid = df[take, grid_order[:, :p]]     # (N, p)
    df_by_feat = df[take, feat_order[:, :p]]     # (N, p)
    cum_grid = np.cumsum(df_by_grid, axis=1) / np.arange(1, p + 1)
    cum_feat = np.cumsum(df_by_feat, axis=1) / np.arange(1, p + 1)

    mean_grid_k = cum_grid.mean(axis=0)          # (p,)
    mean_feat_k = cum_feat.mean(axis=0)          # (p,)

    ratio = (d_rand - mean_grid_k) / np.maximum(d_rand - mean_feat_k, 1e-12)
    return float(np.clip(ratio, 0.0, 1.0).mean())


def mean_neighbor_distance(grid_vectors: np.ndarray, hw: tuple[int, int]) -> float:
    """Mean feature distance of 4-neighbourhood grid cells, normalized by
    the mean random-pair distance (lower is better)."""
    x = np.asarray(grid_vectors, dtype=np.float64)
    h, w = hw
    g = x.reshape(h, w, -1)
    dh = np.linalg.norm(g[:, 1:] - g[:, :-1], axis=-1)
    dv = np.linalg.norm(g[1:, :] - g[:-1, :], axis=-1)
    d_nbr = (dh.sum() + dv.sum()) / (dh.size + dv.size)
    df = np.linalg.norm(x[:, None] - x[None, :], axis=-1)
    d_rand = df[~np.eye(h * w, dtype=bool)].mean()
    return float(d_nbr / d_rand)

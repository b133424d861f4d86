"""'Kissing to Find a Match' low-rank permutation baseline (Droge et al.,
NeurIPS 2023), in PyTorch: P ~ row_softmax(scale * V W^T) with
row-normalized factors V, W of shape (N, M), 2NM parameters.

Counterpart of ``repro.core.baselines.kissing``.  The factors start at
``normal(k1 / k2, (N, M)) * 0.1`` from ``k1, k2 = split(key)``, drawn as
the reference draws them (``repro_torch.core.threefry``; ``normal`` is
within a few ulp of ``jax.random.normal``, so the trajectories are held
to the reference by tolerance), trained with the reference's sharpness
anneal and Adam, and binarized by a row argmax.  The paper's Table III
reports this method failing to produce a valid permutation on the
colour-sorting task: ``valid`` is reported as computed, never mended.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.baselines._common import (adam_bias, adam_step,
                                                anneal, as_input)
from repro_torch.core.losses import (
    mean_pairwise_distance,
    neighbor_loss_grid,
    std_loss,
)
from repro_torch.core.softsort import is_valid_permutation

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class KissingConfig:
    rank: int = 13              # M: 2NM = 26624 for N = 1024, as in Table III
    steps: int = 600
    scale_start: float = 4.0    # softmax sharpness (annealed up)
    scale_end: float = 60.0
    lr: float = 0.02
    lambda_sigma: float = 2.0
    lambda_s: float = 1.0


def _normalize_rows(m):
    return m / (torch.linalg.norm(m, dim=-1, keepdim=True) + 1e-9)


def soft_permutation(v, w, scale) -> torch.Tensor:
    """row_softmax(scale * nr(V) nr(W)^T)."""
    return torch.softmax(scale * _normalize_rows(v) @ _normalize_rows(w).T,
                         dim=-1)


def loss_fn(v, w, x, norm, scale, hw, cfg: KissingConfig) -> torch.Tensor:
    p = soft_permutation(v, w, scale)
    y = p @ x
    colsum = p.sum(dim=0)
    return (neighbor_loss_grid(y.reshape(hw[0], hw[1], -1), norm)
            + cfg.lambda_s * torch.mean(torch.square(colsum - 1.0))
            + cfg.lambda_sigma * std_loss(x, y))


def argmax_order(v, w, scale) -> np.ndarray:
    """The row argmax of the soft permutation (the first maximum on a
    tie): duplicates are possible, and make the order invalid."""
    return torch.argmax(soft_permutation(v, w, scale), dim=-1).cpu().numpy()


def init_factors(key, n: int, rank: int, device):
    """``v0, w0 = normal(k1, (n, M)) * 0.1, normal(k2, (n, M)) * 0.1``."""
    k1, k2 = threefry.split(threefry.as_keys(key, device))
    return (threefry.normal(k1, (n, rank)) * 0.1,
            threefry.normal(k2, (n, rank)) * 0.1)


def _train(x, norm, key, *, hw, cfg: KissingConfig):
    dev = x.device
    v, w = init_factors(key, x.shape[0], cfg.rank, dev)
    scales = anneal(cfg.scale_start, cfg.scale_end, cfg.steps, dev)
    bias1, bias2 = adam_bias(cfg.steps, dev)
    mv, nv = torch.zeros_like(v), torch.zeros_like(v)
    mw, nw = torch.zeros_like(w), torch.zeros_like(w)
    loss = torch.zeros((), dtype=_F32, device=dev)
    for i in range(cfg.steps):
        vv = v.detach().requires_grad_(True)
        wv = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(vv, wv, x, norm, scales[i], hw, cfg)
            gv, gw = torch.autograd.grad(loss, (vv, wv))
        v, mv, nv = adam_step(v, gv, mv, nv, cfg.lr, bias1[i], bias2[i])
        w, mw, nw = adam_step(w, gw, mw, nw, cfg.lr, bias1[i], bias2[i])
    return argmax_order(v, w, cfg.scale_end), loss.detach()


def kissing_sort(x, hw: tuple[int, int], cfg: KissingConfig = KissingConfig(),
                 key=None, *, device=None
                 ) -> tuple[np.ndarray, np.ndarray, float, bool]:
    """Returns (order, x[order], loss, valid).  ``valid`` is False when the
    argmax binarization holds duplicates (the paper's reported failure,
    Table III footnote).  ``key`` is raw ``jax.random`` key data (None:
    ``prng_key(0)``).  Runs on CUDA unless ``device`` says otherwise."""
    x = as_input(x, device)
    norm = mean_pairwise_distance(x)
    order, loss = _train(x, norm, threefry.prng_key(0) if key is None
                         else key, hw=hw, cfg=cfg)
    return order, x.cpu().numpy()[order], float(loss), \
        is_valid_permutation(order)

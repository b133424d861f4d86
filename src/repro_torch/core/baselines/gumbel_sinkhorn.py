"""Gumbel-Sinkhorn permutation learning (Mena et al., ICLR 2018), in
PyTorch: the N^2-parameter baseline of the paper's Table III.

Counterpart of ``repro.core.baselines.gumbel_sinkhorn``.  A logit matrix
is pushed toward a doubly-stochastic matrix by Sinkhorn normalization in
log space, with Gumbel noise for exploration drawn as the reference draws
it (``key, sub = split(key)`` every step, ``uniform(sub, (N, N), 1e-9,
1)``: ``repro_torch.core.threefry``, bitwise ``jax.random``), trained on
the grid loss with the reference's tau and noise anneal and its Adam, and
binarized with the Hungarian algorithm (scipy, on the host), which always
gives a valid permutation.  ``p @ x`` is a plain product, as the reference
leaves it to XLA.  The noise's ``-log(-log(u))`` differs from XLA's in
ulps, so the parity with the reference is a tolerance, never bits.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from repro_torch.core import threefry
from repro_torch.core.baselines._common import (adam_bias, adam_step,
                                                anneal, as_input)
from repro_torch.core.losses import (
    mean_pairwise_distance,
    neighbor_loss_grid,
    std_loss,
)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class GumbelSinkhornConfig:
    steps: int = 600
    sinkhorn_iters: int = 20
    tau_start: float = 2.0
    tau_end: float = 0.05
    noise: float = 0.2          # gumbel noise scale (annealed with tau)
    lr: float = 0.05
    lambda_sigma: float = 2.0


def sinkhorn(log_alpha: torch.Tensor, iters: int) -> torch.Tensor:
    """Sinkhorn normalization in log space; returns a ~doubly-stochastic
    P (rows, then columns, ``iters`` times)."""
    la = log_alpha
    for _ in range(int(iters)):
        la = la - torch.logsumexp(la, dim=1, keepdim=True)
        la = la - torch.logsumexp(la, dim=0, keepdim=True)
    return torch.exp(la)


def gumbel_noise(u: torch.Tensor) -> torch.Tensor:
    """The reference's Gumbel draw from uniforms ``u``."""
    return -torch.log(-torch.log(u + 1e-9))


def loss_fn(logits, x, norm, tau, noise_scale, g, hw,
            cfg: GumbelSinkhornConfig) -> torch.Tensor:
    """One step's loss: Sinkhorn of the noisy logits over tau, applied to
    ``x``, on the grid loss with the std term."""
    p = sinkhorn((logits + noise_scale * g) / tau, cfg.sinkhorn_iters)
    y = p @ x
    return (neighbor_loss_grid(y.reshape(hw[0], hw[1], -1), norm)
            + cfg.lambda_sigma * std_loss(x, y))


def hungarian_order(logits) -> np.ndarray:
    """order[i] = the input row at grid cell i, from the assignment that
    maximizes the summed logits (scipy's Jonker-Volgenant)."""
    rows, cols = linear_sum_assignment(-np.asarray(logits))
    return cols[np.argsort(rows)]


def _train(x, norm, key, *, hw, cfg: GumbelSinkhornConfig):
    n = x.shape[0]
    dev = x.device
    taus = anneal(cfg.tau_start, cfg.tau_end, cfg.steps, dev)
    noise = cfg.noise * (1.0 - torch.arange(
        cfg.steps, dtype=_F32, device=dev) / cfg.steps)
    bias1, bias2 = adam_bias(cfg.steps, dev)
    logits = torch.zeros((n, n), dtype=_F32, device=dev)
    mu, nu = torch.zeros_like(logits), torch.zeros_like(logits)
    loss = torch.zeros((), dtype=_F32, device=dev)
    key = threefry.as_keys(key, dev)
    for i in range(cfg.steps):
        key, sub = threefry.split(key)
        g = gumbel_noise(threefry.uniform(sub, (n, n), 1e-9, 1.0))
        lv = logits.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(lv, x, norm, taus[i], noise[i], g, hw, cfg)
            (grad,) = torch.autograd.grad(loss, lv)
        logits, mu, nu = adam_step(logits, grad, mu, nu, cfg.lr, bias1[i],
                                   bias2[i])
    return logits, loss.detach()


def gumbel_sinkhorn_sort(x, hw: tuple[int, int],
                         cfg: GumbelSinkhornConfig = GumbelSinkhornConfig(),
                         key=None, *, device=None
                         ) -> tuple[np.ndarray, np.ndarray, float]:
    """Returns (order, x[order], final_loss); order[i] = input row at grid
    cell i.  ``key`` is raw ``jax.random`` key data (None:
    ``prng_key(0)``, the reference's default).  Runs on CUDA unless
    ``device`` says otherwise."""
    x = as_input(x, device)
    norm = mean_pairwise_distance(x)
    logits, loss = _train(x, norm, threefry.prng_key(0) if key is None
                          else key, hw=hw, cfg=cfg)
    order = hungarian_order(logits.cpu().numpy())
    return order, x.cpu().numpy()[order], float(loss)

"""What the port's Table III baselines (Gumbel-Sinkhorn, Kissing, plain
SoftSort) share: their input on the run's device, the reference's
continuous per-step anneal, and its hand-written Adam (beta 0.9 / 0.999,
eps 1e-8, bias corrections at step ``t = i + 1``)."""
from __future__ import annotations

import numpy as np
import torch


def as_input(x, device) -> torch.Tensor:
    """(N, d) float32 on ``device`` (None: a tensor's own device, else
    CUDA, and an error without one)."""
    from repro_torch.core.shufflesoftsort import resolve_device
    if isinstance(x, torch.Tensor):
        dev = x.device if device is None else torch.device(device)
        return x.to(device=dev, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                           device=resolve_device(device))


def adam_bias(steps: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(steps,) float32 bias corrections ``1 - 0.9 ** t`` and ``1 - 0.999
    ** t``, on the device once for the run."""
    t = torch.arange(1, steps + 1, dtype=torch.float32, device=device)
    return 1 - 0.9 ** t, 1 - 0.999 ** t


def adam_step(p, g, mu, nu, lr: float, bias1, bias2):
    """One step: returns the new (p, mu, nu)."""
    mu = 0.9 * mu + 0.1 * g
    nu = 0.999 * nu + 0.001 * torch.square(g)
    return p - lr * (mu / bias1) / (torch.sqrt(nu / bias2) + 1e-8), mu, nu


def anneal(start: float, end: float, steps: int, device) -> torch.Tensor:
    """(steps,) float32 ``start * (end / start) ** (i / steps)``, the
    reference's continuous per-step anneal, on the device once."""
    frac = (torch.arange(steps, dtype=torch.float32, device=device)
            / steps)
    return start * (end / start) ** frac

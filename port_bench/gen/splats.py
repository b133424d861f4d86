"""Synthetic 3-D Gaussian splats with 3DGS's 59 attributes, the paper's
section IV-B input (Kerbl et al. 2023: position 3, scale 3, rotation 4,
opacity 1, spherical-harmonic colour 48 = 3 DC + 45 of degrees 1-3).

The first 14 are the repository's SOG example (``synthetic_scene``): every
attribute a smooth function of a 2-D surface parameter t, as in real
scenes where nearby splats share scale, orientation and colour.  The 45
higher SH coefficients extend it the same way: coefficient c of degree l
is a_l cos(f_c . t + phi_c), amplitudes falling with the degree (0.3 / l),
integer frequencies f_c in [-l, l]^2 and phases phi_c drawn per scene.
Every attribute gets N(0, noise^2) jitter."""
from __future__ import annotations

import math

import torch

SH_REST = ((1, 9), (2, 15), (3, 21))     # (degree, coefficients) x 3 colours


def make(count: int, n: int, d: int, gen: torch.Generator, *,
         noise: float) -> torch.Tensor:
    """(count, N, 59) float32 scenes."""
    if d != 59:
        raise ValueError(f"a 3DGS splat has 59 attributes, not {d}")
    dev = gen.device
    t = torch.rand((count, n, 2), generator=gen, device=dev) * 2 * math.pi
    t0, t1 = t[..., 0], t[..., 1]
    pos = torch.stack([torch.cos(t0), torch.sin(t0) * torch.cos(t1),
                       torch.sin(t1)], -1)
    scale = 0.2 + 0.1 * torch.abs(torch.sin(3 * t))
    scale = torch.cat([scale, scale[..., :1]], -1)
    rot = torch.stack([torch.cos(t0 / 2), torch.sin(t0 / 2),
                       torch.cos(t1 / 2), torch.sin(t1 / 2)], -1)
    opacity = 0.5 + 0.5 * torch.cos(t[..., :1])
    dc = 0.5 + 0.5 * torch.stack([torch.cos(t0), torch.sin(t1),
                                  torch.cos(t0 + t1)], -1)
    rest = []
    for deg, m in SH_REST:
        f = torch.randint(-deg, deg + 1, (count, 1, m, 2), generator=gen,
                          device=dev).float()
        phi = torch.rand((count, 1, m), generator=gen,
                         device=dev) * 2 * math.pi
        arg = (f * t[:, :, None, :]).sum(-1) + phi
        rest.append((0.3 / deg) * torch.cos(arg))
    attrs = torch.cat([pos, scale, rot, opacity, dc, *rest], -1)
    return attrs + noise * torch.randn(attrs.shape, generator=gen,
                                       device=dev)

"""Building blocks of the LM zoo: linear, RMSNorm, embedding, RoPE, SwiGLU.

Counterpart of ``repro.models.layers``.  Parameters live in
``nn.Module``s whose attribute names are the reference's pytree keys
(``w``, ``b``, ``scale``, ``table``, ``wi`` / ``wg`` / ``wo``), with the
reference's layouts: a linear weight is (d_in, d_out).  The functions take
such a module and tensors, as the reference's take a parameter dict and
arrays.  Parameters require gradients, for training
(``repro_torch.launch.steps``); the serving paths run under
``torch.inference_mode()``, which records no graph.

Mixed dtypes follow JAX's promotion, which PyTorch's matmul does not do by
itself: ``linear`` of a float32 input and a bfloat16 weight computes in
float32 (the weight cast once per call).

The reference's ``AxisRules``, ``constrain_*`` and
``activation_sharding_ctx`` are SPMD sharding annotations with no meaning
on one card; they come with the meshes (ROADMAP.md A16d).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

_F32 = torch.float32
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal(shape, scale, dtype, generator, device):
    """float32 normal * scale, cast to ``dtype``; uninitialised on the
    ``meta`` device (shapes only)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, dtype=_F32, device=device, generator=generator)
    return (w * scale).to(dtype)


def param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t)


def promoted(*ts):
    """The tensors cast to their common dtype, as JAX promotes operands."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


# ------------------------------------------------------------------ linear

class Linear(nn.Module):
    def __init__(self, d_in, d_out, dtype, generator, device, *,
                 bias=False):
        super().__init__()
        self.w = param(normal((d_in, d_out), d_in ** -0.5, dtype, generator,
                              device))
        if bias:
            self.b = param(torch.zeros(d_out, dtype=dtype, device=device))
        else:
            self.b = None


def linear(p, x):
    x, w = promoted(x, p.w)
    y = x @ w
    return y if p.b is None else y + p.b


# ----------------------------------------------------------------- rmsnorm

class RMSNorm(nn.Module):
    def __init__(self, d, dtype, device):
        super().__init__()
        self.scale = param(torch.ones(d, dtype=dtype, device=device))


def rmsnorm(p, x, eps: float = 1e-5):
    xf = x.to(_F32)
    y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (y * p.scale.to(_F32)).to(x.dtype)


# --------------------------------------------------------------- embedding

class Embedding(nn.Module):
    def __init__(self, vocab, d, dtype, generator, device):
        super().__init__()
        self.table = param(normal((vocab, d), 0.02, dtype, generator, device))


def embed(p, tokens):
    """tokens (B, T) -> (B, T, D): rows of the table."""
    return p.table[tokens]


def unembed(p, x):
    """(B, T, D) @ table^T -> logits (B, T, V), in float32."""
    return x.to(_F32) @ p.table.to(_F32).t()


# -------------------------------------------------------------------- rope

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=_F32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta: float):
    """x (B, T, H, Dh); positions (B, T) integers."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(_F32) * freqs                # (B, T, Dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.to(_F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ swiglu

class MLP(nn.Module):
    def __init__(self, d_model, d_ff, dtype, generator, device):
        super().__init__()
        self.wi = Linear(d_model, d_ff, dtype, generator, device)
        self.wg = Linear(d_model, d_ff, dtype, generator, device)
        self.wo = Linear(d_ff, d_model, dtype, generator, device)


def mlp(p, x):
    h = F.silu(linear(p.wg, x)) * linear(p.wi, x)
    return linear(p.wo, h)

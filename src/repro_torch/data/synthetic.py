"""Deterministic synthetic data, the port's counterpart of
``repro.data.synthetic``.

A batch is a pure function of ``(seed, step)``: the key
``fold_in(PRNGKey(seed), step)`` splits into one key for the sequences'
starts and one for the modality context, drawn with the port's bitwise
``jax.random`` (``repro_torch.core.threefry``, jax 0.9.0's counter
layout), so a restart resumes bit for bit and the tokens are the
reference's.  Each sequence is an arithmetic token progression from a
random start (next = prev + 1 mod V): a successor rule the model can
learn, so that a falling loss means something.

The context of a vlm or audio model is ``jax.random.normal`` at
bfloat16 (``normal_bf16``): 8-bit draws, a bfloat16 uniform, XLA's
float32 ``erf_inv`` rounded to bfloat16, times bfloat16 sqrt(2).  No
element of the draws in ``tests/test_torch_train_data.py`` differs from
the reference's; one could, by a bfloat16 ulp, where the float32
``erf_inv`` (within 4 ulp of XLA's: their ``log1p`` differ) lands next to
a bfloat16 rounding boundary.

``token_spec``, ``context_spec`` and ``batch_specs`` describe batches
without allocating: ``meta``-device tensors, where the reference returns
``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.models.config import ModelConfig, ShapeCell

_BF16 = torch.bfloat16
_LO = -1.0 + 2.0 ** -8          # nextafter(-1, 0) in bfloat16


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
                    seed: int = 0, device=None) -> dict:
    """One global batch: ``tokens`` and ``labels`` (batch, seq) int32 and,
    for a vlm or audio model, ``context``; on CUDA unless ``device`` says
    otherwise."""
    key = threefry.fold_in(threefry.prng_key(seed), step, device=device)
    k1, k2 = threefry.split(key)
    starts = threefry.randint(k1, (batch, 1), 0, cfg.vocab_size)
    tokens = (starts + torch.arange(seq + 1, dtype=torch.int32,
                                    device=starts.device)) % cfg.vocab_size
    out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    shape = _context_shape(cfg, batch)
    if shape is not None:
        out["context"] = normal_bf16(k2, shape)
    return out


def _context_shape(cfg: ModelConfig, batch: int):
    if cfg.family == "vlm":
        return (batch, cfg.vision_tokens, cfg.vision_d)
    if cfg.is_encdec:
        return (batch, cfg.audio_frames, cfg.d_model)
    return None


def normal_bf16(key, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape, jnp.bfloat16)``."""
    # jax's bfloat16 uniform on [lo, 1), lo = nextafter(-1, 0) = -1 + 2^-8:
    # 8 random bits (the low byte of each word), the top 7 as the mantissa
    # of a bfloat16 in [1, 2), minus 1; then f * (1 - lo) + lo, where
    # 1 - lo rounds to 2 in bfloat16, so f * 2 is exact and the sum is
    # rounded once
    bits = threefry.random_bits(key, shape) & 0xFF
    f = ((bits >> 1) | 0x3F80).to(torch.int16).view(_BF16).float() - 1.0
    u = torch.clamp(f * 2.0 + _LO, min=_LO).to(_BF16)
    # XLA's float32 erf_inv of it, rounded, times bfloat16 sqrt(2)
    e = threefry.erf_inv(u.float()).to(_BF16)
    return torch.tensor(np.sqrt(2), dtype=_BF16, device=e.device) * e


# ------------------------------------------------------ dry-run specs

def token_spec(batch: int, seq: int) -> torch.Tensor:
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


def context_spec(cfg: ModelConfig, batch: int):
    shape = _context_shape(cfg, batch)
    return None if shape is None else torch.empty(shape, dtype=_BF16,
                                                  device="meta")


def batch_specs(cfg: ModelConfig, cell: ShapeCell) -> dict:
    """Training-batch specs (``meta`` tensors) for one shape cell."""
    specs = {
        "tokens": token_spec(cell.global_batch, cell.seq_len),
        "labels": token_spec(cell.global_batch, cell.seq_len),
    }
    ctx = context_spec(cfg, cell.global_batch)
    if ctx is not None:
        specs["context"] = ctx
    return specs

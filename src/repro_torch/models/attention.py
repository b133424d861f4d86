"""GQA attention: full sequence (train / prefill), one-token decode over a
KV cache, and cross-attention.

Counterpart of ``repro.models.attention``.  Where the reference computes
attention as einsums (``_sdpa``), every call here goes through the port's
flash attention (``repro_torch.kernels.flash_ops.flash_attention``): on
CUDA tensors it launches the ``flash_forward`` kernel, which merges up to
8 key splits in its cluster epilogue, and ``flash_combine`` for more; on
the CPU it runs their plain twins.

- full / prefill: causal, ``q_offset = 0``; the encoder's: not causal;
- decode over the whole padded cache: causal with ``q_offset = pos``,
  which scores key ``j`` iff ``j <= pos``, the reference's length mask;
- cross-attention: not causal.

In float32 this is the reference's function.  In bfloat16 the reference
forms bf16 scores and probabilities, while the flash kernel computes in
float32 and rounds its output once.

The decode step writes the new K/V into the cache tensors in place (the
reference returns updated copies): a padded cache is read once per step
and never copied.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from repro_torch.kernels.flash_ops import flash_attention
from repro_torch.models.layers import (Linear, apply_rope, constrain_dims,
                                       linear, linear_specs, prefixed)
from repro_torch.models.sharded import heads_view, merge_heads, write_cache


class KVCache(NamedTuple):
    k: torch.Tensor   # (B, S, Hkv, Dh)
    v: torch.Tensor   # (B, S, Hkv, Dh)


class Attention(nn.Module):
    def __init__(self, cfg, dtype, generator, device):
        super().__init__()
        d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
        dh = cfg.resolved_head_dim
        bias = cfg.qkv_bias
        self.wq = Linear(d, h * dh, dtype, generator, device, bias=bias)
        self.wk = Linear(d, hkv * dh, dtype, generator, device, bias=bias)
        self.wv = Linear(d, hkv * dh, dtype, generator, device, bias=bias)
        self.wo = Linear(h * dh, d, dtype, generator, device)
        self.bias = bias

    def specs(self, rules):
        fsdp, tp = rules.fsdp, rules.tp
        return {**prefixed("wq", linear_specs(self.bias, fsdp, tp)),
                **prefixed("wk", linear_specs(self.bias, fsdp, tp)),
                **prefixed("wv", linear_specs(self.bias, fsdp, tp)),
                **prefixed("wo", linear_specs(False, tp, fsdp))}


def _split_heads(x, n_heads, dh):
    return heads_view(x, n_heads, dh)


def qkv(p, cfg, x, positions):
    """The rotated q (B, T, H, Dh) and k, and v (B, T, Hkv, Dh), of x."""
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    q = _split_heads(linear(p.wq, x), h, dh)
    k = _split_heads(linear(p.wk, x), hkv, dh)
    v = _split_heads(linear(p.wv, x), hkv, dh)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _out(p, o):
    return linear(p.wo, merge_heads(o))


def _positions(t, device, start=0):
    """Positions (1, T), broadcast over the batch by RoPE."""
    return torch.arange(start, start + t, device=device)[None]


def _seq_shard(cfg, q, k, v):
    """Sequence-sharded attention (``attn_seq_shard``): q rows over tp,
    heads whole; k and v over the batch only."""
    if cfg.attn_seq_shard:
        q = constrain_dims(q, {0: "dp", 1: "tp"})
        k = constrain_dims(k, {0: "dp"})
        v = constrain_dims(v, {0: "dp"})
    return q, k, v


def attention_full(p, cfg, x, *, causal: bool = True, positions=None):
    """Train / prefill path over the whole sequence."""
    if positions is None:
        positions = _positions(x.shape[1], x.device)
    q, k, v = _seq_shard(cfg, *qkv(p, cfg, x, positions))
    return _out(p, flash_attention(q, k, v, causal, 0))


def attention_prefill(p, cfg, x):
    """Full causal pass that also returns the populated KV cache."""
    q, k, v = _seq_shard(cfg, *qkv(p, cfg, x, _positions(x.shape[1],
                                                        x.device)))
    return _out(p, flash_attention(q, k, v, True, 0)), KVCache(k, v)


def attention_decode(p, cfg, x, cache: KVCache, pos: int):
    """One-token step.  x (B, 1, D); cache K/V (B, S, Hkv, Dh); ``pos`` the
    index written (the same for the batch).  Writes K/V at ``pos`` into
    the cache in place and returns it."""
    q, k_new, v_new = qkv(p, cfg, x, _positions(1, x.device, pos))
    write_cache(cache.k, k_new, pos)
    write_cache(cache.v, v_new, pos)
    return _out(p, flash_attention(q, cache.k, cache.v, True, pos)), cache


def cross_attention(p, cfg, x, ctx_kv: KVCache):
    """Attend from x (B, T, D) to a precomputed context cache: no mask, no
    rope on the context."""
    h, dh = cfg.num_heads, cfg.resolved_head_dim
    q = _split_heads(linear(p.wq, x), h, dh)
    return _out(p, flash_attention(q, ctx_kv.k, ctx_kv.v, False, 0))


def context_kv(p, cfg, ctx):
    """K/V of the encoder / vision context (B, Tc, D)."""
    hkv, dh = cfg.num_kv_heads, cfg.resolved_head_dim
    return KVCache(_split_heads(linear(p.wk, ctx), hkv, dh),
                   _split_heads(linear(p.wv, ctx), hkv, dh))


def empty_cache(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                device=None) -> KVCache:
    shape = (batch, seq, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))

"""Layer kinds and the stack of layers.

Counterpart of ``repro.models.blocks``.  A ``Layer`` holds the parameters
of one layer kind (``attn_dense``, ``attn_moe``, ``mamba``,
``mamba_dense``, ``mamba_moe``, ``cross_attn``); ``apply_layer_full``,
``apply_layer_prefill`` and ``apply_layer_decode`` run it.  Where the
reference stacks each unit position's parameters along a repeats axis and
scans over it, the port keeps a plain list of ``num_layers`` layers (layer
``r * len(unit) + i`` is unit position ``i`` of repeat ``r``), and the
caches are a list with one entry per layer.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import KVCache
from repro_torch.models.layers import (MLP, P, RMSNorm, constrain_act, mlp,
                                       param, rmsnorm)
from repro_torch.models.moe import MoE, moe_ffn, moe_ffn_gather
from repro_torch.models.sharded import heads_view
from repro_torch.models.ssm import SSMCache

_F32 = torch.float32


class Layer(nn.Module):
    """The parameters of one layer of kind ``kind``, named as the
    reference's pytree keys."""

    def __init__(self, kind: str, cfg, dtype, generator, device):
        super().__init__()
        self.kind = kind
        d = cfg.d_model
        if kind.startswith("attn") or kind == "cross_attn":
            self.norm1 = RMSNorm(d, dtype, device)
            self.attn = attn.Attention(cfg, dtype, generator, device)
        if kind.startswith("mamba"):
            self.norm1 = RMSNorm(d, dtype, device)
            self.mamba = ssm_mod.Mamba(cfg, dtype, generator, device)
        if kind == "cross_attn":
            self.norm_c = RMSNorm(d, dtype, device)
            self.xattn = attn.Attention(cfg, dtype, generator, device)
            # the tanh gate of llama-3.2-vision, float32, 0 at init
            self.xgate = param(torch.zeros((), dtype=_F32, device=device))
        if kind.endswith("_moe"):
            self.norm2 = RMSNorm(d, dtype, device)
            self.moe = MoE(cfg, dtype, generator, device)
        elif kind in ("attn_dense", "cross_attn", "mamba_dense"):
            self.norm2 = RMSNorm(d, dtype, device)
            self.mlp = MLP(d, cfg.d_ff, dtype, generator, device)

    def specs(self, rules):
        return {"xgate": P()} if self.kind == "cross_attn" else {}


def _res(x, y):
    """The residual stream x + y, pinned to the launcher's activation
    layout: a sub-block whose last product contracts over the
    tensor-parallel axis gives a partial sum, reduced here, as the
    reference's SPMD program reduces it before its next layer."""
    return constrain_act(x + y)


def _gated(p, cfg, x, ctx_kv):
    """x plus the tanh-gated cross-attention to the context.  The gate is
    float32: the product is formed in float32, then cast, as JAX promotes
    it (torch would compute a 0-d float32 tensor times bf16 in bf16)."""
    y = attn.cross_attention(p.xattn, cfg, rmsnorm(p.norm_c, x, cfg.norm_eps),
                             ctx_kv)
    return _res(x, (torch.tanh(p.xgate) * y.to(_F32)).to(x.dtype))


def _ffn(p, cfg, x, capacity_factor=None):
    """The FFN sub-block: (x, aux loss or None)."""
    if hasattr(p, "moe"):
        moe = moe_ffn_gather if cfg.moe_impl == "gather" else moe_ffn
        y, aux = moe(p.moe, cfg, rmsnorm(p.norm2, x, cfg.norm_eps),
                     capacity_factor=capacity_factor)
        return _res(x, y), aux["moe_balance"] + aux["router_z"]
    if hasattr(p, "mlp"):
        return _res(x, mlp(p.mlp, rmsnorm(p.norm2, x, cfg.norm_eps))), None
    return x, None


def apply_layer_full(p, cfg, x, *, causal: bool, ctx=None):
    """Train path: full sequence, no cache.  Returns (x, aux)."""
    kind = p.kind
    if kind.startswith("attn") or kind == "cross_attn":
        x = _res(x, attn.attention_full(p.attn, cfg,
                                        rmsnorm(p.norm1, x, cfg.norm_eps),
                                        causal=causal))
    elif kind.startswith("mamba"):
        x = _res(x, ssm_mod.mamba_forward(p.mamba, cfg,
                                          rmsnorm(p.norm1, x,
                                                  cfg.norm_eps)))
    if kind == "cross_attn":
        x = _gated(p, cfg, x, attn.context_kv(p.xattn, cfg, ctx))
    x, aux = _ffn(p, cfg, x)
    return x, (torch.zeros((), dtype=_F32, device=x.device)
               if aux is None else aux)


def _unit_full(layers, cfg, x, causal, ctx):
    aux = torch.zeros((), dtype=_F32, device=x.device)
    x = constrain_act(x)
    for layer in layers:
        x, a = apply_layer_full(layer, cfg, x, causal=causal, ctx=ctx)
        x = constrain_act(x)
        aux = aux + a
    return x, aux


def _save_dots(ctx, op, *args, **kwargs):
    """``remat_policy="dots"``: keep the outputs of matrix products without
    batch dimensions (``jax.checkpoint_policies.
    dots_with_no_batch_dims_saveable``: a 3-D ``x @ w`` runs as one
    ``mm``), recompute everything else."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def stack_full(layers, unit_len: int, cfg, x, *, causal=True, ctx=None):
    """Train path over ``layers``, unit by unit (``unit_len`` consecutive
    layers, the reference's scan body).  Returns (x, aux summed per unit,
    then over the units, as the reference's scan carries it).  With
    ``cfg.remat`` and autograd recording, each unit runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, all of them (``remat_policy="full"``) or all but the matrix
    products' (``"dots"``).  Remat changes no value."""
    remat = cfg.remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=_F32, device=x.device)
    for start in range(0, len(layers), unit_len):
        unit = layers[start:start + unit_len]
        if not remat:
            x, a = _unit_full(unit, cfg, x, causal, ctx)
        elif cfg.remat_policy == "dots":
            x, a = checkpoint(
                _unit_full, unit, cfg, x, causal, ctx, use_reentrant=False,
                context_fn=lambda: create_selective_checkpoint_contexts(
                    _save_dots))
        else:
            x, a = checkpoint(_unit_full, unit, cfg, x, causal, ctx,
                              use_reentrant=False)
        aux = aux + a
    return x, aux


def apply_layer_prefill(p, cfg, x, *, ctx=None):
    """Prefill: full sequence, and this layer's cache."""
    kind = p.kind
    cache = None
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if kind.startswith("attn") or kind == "cross_attn":
        y, cache = attn.attention_prefill(p.attn, cfg, h)
        x = _res(x, y)
    elif kind.startswith("mamba"):
        # an SSM's prefill: the full forward, and the state after it
        x = _res(x, ssm_mod.mamba_forward(p.mamba, cfg, h))
        cache = _ssm_state_after(p.mamba, cfg, h)
    if kind == "cross_attn":
        x = _gated(p, cfg, x, attn.context_kv(p.xattn, cfg, ctx))
    return _ffn(p, cfg, x)[0], cache


def _ssm_state_after(mp, cfg, h):
    """The conv buffers (the last K-1 projected inputs) and the recurrent
    state after a prefill pass over h."""
    kw = cfg.ssm_conv
    return SSMCache((h @ mp.wx)[:, -(kw - 1):, :],
                    (h @ mp.wb)[:, -(kw - 1):, :],
                    (h @ mp.wc)[:, -(kw - 1):, :],
                    _final_state_scan(mp, cfg, h))


def _final_state_scan(mp, cfg, h):
    """The SSD state after the whole of h (B, T, D),
    S_T = sum_j exp(sum_{i>j} la_i) dt_j B_j x_j^T, chunk by chunk with
    the chunk min(Q_max, T)."""
    b, t_true, _ = h.shape
    hh, nst, p_ = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    q = min(cfg.ssm_chunk, t_true)
    t = (t_true + q - 1) // q * q
    h = ssm_mod._pad(h, t)
    nc = t // q
    x, bm, dt = ssm_mod._inputs(mp, h, t_true, t)
    la = dt * -torch.exp(mp.a_log)
    xh = heads_view(x, hh, p_).to(_F32)

    cum = torch.cumsum(la.reshape(b, nc, q, hh), dim=2)
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dt.reshape(b, nc, q, hh)
    s_local = torch.einsum("bcqh,bcqn,bcqhp->bchnp", w_end,
                           bm.reshape(b, nc, q, nst),
                           xh.reshape(b, nc, q, hh, p_))
    s = torch.zeros(b, hh, nst, p_, dtype=_F32, device=h.device)
    for c in range(nc):
        s = torch.exp(cum[:, c, -1, :])[:, :, None, None] * s + s_local[:, c]
    return s


def apply_layer_decode(p, cfg, x, cache, pos: int, ctx_kv: KVCache | None):
    """One-token step.  x (B, 1, D).  MoE layers run at capacity factor
    E (no token drops)."""
    kind = p.kind
    h = rmsnorm(p.norm1, x, cfg.norm_eps)
    if kind.startswith("attn") or kind == "cross_attn":
        y, cache = attn.attention_decode(p.attn, cfg, h, cache, pos)
    else:
        y, cache = ssm_mod.mamba_decode(p.mamba, cfg, h, cache)
    x = _res(x, y)
    if kind == "cross_attn":
        x = _gated(p, cfg, x, ctx_kv)
    return _ffn(p, cfg, x, float(cfg.num_experts))[0], cache


def make_caches(cfg, kinds, batch: int, seq: int, dtype=torch.bfloat16,
                device=None):
    """Empty caches, one per layer of ``kinds``."""
    return [attn.empty_cache(cfg, batch, seq, dtype, device)
            if kind.startswith("attn") or kind == "cross_attn"
            else ssm_mod.empty_ssm_cache(cfg, batch, dtype, device)
            for kind in kinds]

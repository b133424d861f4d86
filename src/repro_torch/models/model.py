"""End-to-end language model: embed -> (encoder ->) layers -> head.

Counterpart of ``repro.models.model``, for every family of the zoo:

  dense / moe / ssm / hybrid    decoder-only LM
  vlm                           decoder LM with gated cross-attention to
                                stub patch embeddings (the frontend is a
                                stub: callers pass precomputed embeddings)
  audio                         Whisper-style encoder-decoder; the conv
                                frontend stubbed the same way (frames at
                                d_model)

``init_model(cfg, device=None, seed=0)`` builds an ``LM`` on CUDA unless
told otherwise, its weights drawn from one explicit ``torch.Generator``
(on the ``meta`` device it allocates nothing: shapes and counts only).
``params_from_jax(cfg, tree)`` builds it from the reference's parameter
pytree, as numpy arrays, so that both packages compute the same function.
``forward``, ``loss_fn``, ``prefill``, ``precompute_ctx_kvs`` and
``decode_step`` take the model where the reference takes ``params, cfg``;
the train step (``repro_torch.launch.steps``) runs ``loss_fn`` with a
train state's tensors in place of the parameters.

Attention runs on the flash kernels (``repro_torch.models.attention``);
the projections, MLPs, experts, SSM products and the head are PyTorch
matrix products.  The head of an untied model computes in float32, as
JAX promotes the reference's float32 activations against a bfloat16
``lm_head``: its weight is cast to float32 at each call.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.shufflesoftsort import resolve_device
from repro_torch.models import blocks
from repro_torch.models.attention import context_kv
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharded import (is_dtensor, lse_and_pick,
                                        vocab_sharded)
from repro_torch.models.layers import (
    AxisRules,
    Embedding,
    Linear,
    P,
    RMSNorm,
    constrain_act,
    embed,
    linear,
    linear_specs,
    prefixed,
    rmsnorm,
    torch_dtype,
    unembed,
)

_F32 = torch.float32
ENCODER_KIND = "attn_dense"


class LMOutputs(NamedTuple):
    logits: torch.Tensor
    aux_loss: torch.Tensor


class LM(nn.Module):
    """The parameters of one model of the zoo, named as the reference's
    pytree (``embed.table``, ``blocks.<layer>.attn.wq.w``, ...), and its
    config."""

    def __init__(self, cfg: ModelConfig, generator, device):
        super().__init__()
        self.cfg = cfg
        dtype = torch_dtype(cfg.param_dtype)
        unit, repeats = cfg.block_program()
        self.embed = Embedding(cfg.padded_vocab, cfg.d_model, dtype,
                               generator, device)
        self.blocks = nn.ModuleList(
            blocks.Layer(kind, cfg, dtype, generator, device)
            for _ in range(repeats) for kind in unit)
        self.final_norm = RMSNorm(cfg.d_model, dtype, device)
        self.lm_head = None if cfg.tie_embeddings else Linear(
            cfg.d_model, cfg.padded_vocab, dtype, generator, device)
        self.vision_proj = Linear(
            cfg.vision_d, cfg.d_model, dtype, generator,
            device) if cfg.family == "vlm" else None
        if cfg.is_encdec:
            self.encoder = nn.ModuleList(
                blocks.Layer(ENCODER_KIND, cfg, dtype, generator, device)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = RMSNorm(cfg.d_model, dtype, device)

    def forward(self, tokens, context=None) -> LMOutputs:
        return forward(self, tokens, context)

    def specs(self, rules):
        cfg = self.cfg
        out = {}
        if cfg.embed_shard == "hidden":
            # local lookup (vocab replicated), hidden dim over tp: no
            # per-forward (B, S, D) sum of a vocab-sharded table
            out["embed.table"] = P(None, rules.tp)
        if self.lm_head is not None:
            out.update(prefixed("lm_head", linear_specs(
                False, rules.fsdp, rules.tp)))
        if self.vision_proj is not None:
            out.update(prefixed("vision_proj", linear_specs(
                False, None, rules.fsdp)))
        return out


def param_specs(model: nn.Module, rules: AxisRules | None = None) -> dict:
    """{parameter name: P}, the spec the reference's ``init_model``
    returns beside each array (without the stacked layers' leading
    repeats axis): each module's ``specs(rules)`` for its own parameters,
    a parent's overriding its children's.  Raises if a parameter has
    none."""
    rules = rules or AxisRules()
    out = {}
    for prefix, mod in reversed(list(model.named_modules())):
        if hasattr(mod, "specs"):
            pre = f"{prefix}." if prefix else ""
            out.update({pre + k: v for k, v in mod.specs(rules).items()})
    names = [k for k, _ in model.named_parameters()]
    missing = [k for k in names if k not in out]
    if missing:
        raise ValueError(f"no spec for parameters {missing}")
    return {k: out[k] for k in names}


def init_model(cfg: ModelConfig, device=None, seed: int = 0) -> LM:
    """A model with random weights from ``torch.Generator(device)`` seeded
    with ``seed``; CUDA unless ``device`` says otherwise."""
    device = resolve_device(device)
    gen = None if device.type == "meta" else torch.Generator(
        device=device).manual_seed(seed)
    return LM(cfg, gen, device)


# ------------------------------------------------------- reference weights

def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes, as jax hands it
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _flat(tree, prefix=""):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def load_tree(module: nn.Module, tree, device=None):
    """Load a reference pytree (nested dicts of numpy arrays, or dotted
    names) into ``module``, whose parameter names follow its keys; every
    parameter must be given."""
    state = {k: _tensor(v, device) for k, v in _flat(tree)}
    module.load_state_dict(state, strict=True, assign=True)
    return module


def _stacked(tree, key, layers_per_repeat):
    """The reference's stacked tuple (one dict per unit position, leaves
    with a leading repeats axis) as dotted names per layer of the list."""
    out = {}
    for i, unit_tree in enumerate(tree[key]):
        for name, arr in _flat(unit_tree):
            for r in range(arr.shape[0]):
                out[f"{key}.{r * layers_per_repeat + i}.{name}"] = arr[r]
    return out


def params_from_jax(cfg: ModelConfig, tree, device=None) -> LM:
    """The port's model with the weights of the reference's parameter
    pytree ``tree`` (``init_model(key, cfg)[0]`` with every leaf converted
    by ``np.asarray``)."""
    device = resolve_device(device)
    model = LM(cfg, None, torch.device("meta"))
    flat = {k: v for k, v in tree.items() if k not in ("blocks", "encoder")}
    state = dict(_flat(flat))
    state.update(_stacked(tree, "blocks", len(cfg.block_program()[0])))
    if cfg.is_encdec:
        state.update(_stacked(tree, "encoder", 1))
    return load_tree(model, state, device)


# ------------------------------------------------------------ context enc

def _encode_context(model, context):
    """Project / encode the modality context into (B, Tc, D)."""
    cfg = model.cfg
    if context is None:
        return None
    if cfg.family == "vlm":
        return linear(model.vision_proj, context)
    if cfg.is_encdec:
        x, _ = blocks.stack_full(model.encoder, 1, cfg, context,
                                 causal=False)
        return rmsnorm(model.enc_norm, x, cfg.norm_eps)
    return context


def _head(model, x):
    cfg = model.cfg
    if cfg.tie_embeddings:
        logits = unembed(model.embed, x)
    else:
        logits = linear(model.lm_head, x.to(_F32))
    if cfg.padded_vocab != cfg.vocab_size:
        # vocab-padding columns never reach a softmax or an argmax
        if is_dtensor(logits):      # per vocab shard, no gather
            cols = torch.arange(cfg.padded_vocab, device=x.device)
            logits = logits.masked_fill(cols >= cfg.vocab_size, -1e30)
        else:
            logits[..., cfg.vocab_size:] = -1e30
    return constrain_act(logits, vocab_dim=True)


# ---------------------------------------------------------------- forward

def forward(model: LM, tokens, context=None) -> LMOutputs:
    """The full forward.  tokens (B, T) integers; context: the stub
    embeddings of a vlm or audio model."""
    cfg = model.cfg
    ctx = _encode_context(model, context)
    x, aux = blocks.stack_full(model.blocks, len(cfg.block_program()[0]),
                               cfg, constrain_act(embed(model.embed, tokens)),
                               causal=True, ctx=ctx)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return LMOutputs(_head(model, x), aux)


def loss_fn(model: LM, batch) -> tuple[torch.Tensor, dict]:
    """Next-token cross entropy (float32 logsumexp) plus the MoE aux
    losses."""
    out = forward(model, batch["tokens"], batch.get("context"))
    logits = out.logits
    if vocab_sharded(logits):
        lse, ll = lse_and_pick(logits, batch["labels"])
    else:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          batch["labels"][..., None].long())[..., 0]
    nll = (lse - ll).mean()
    return nll + out.aux_loss, {"nll": nll, "aux": out.aux_loss,
                                "ppl": torch.exp(torch.clamp(nll, max=20.0))}


def prefill(model: LM, tokens, context=None):
    """(last-position logits (B, 1, V), caches) for the decode steps."""
    cfg = model.cfg
    ctx = _encode_context(model, context)
    x = constrain_act(embed(model.embed, tokens))
    unit_len = len(cfg.block_program()[0])
    caches = []
    for i, layer in enumerate(model.blocks):
        if i % unit_len == 0:
            x = constrain_act(x)
        x, c = blocks.apply_layer_prefill(layer, cfg, x, ctx=ctx)
        x = constrain_act(x)
        caches.append(c)
    x = rmsnorm(model.final_norm, x[:, -1:, :], cfg.norm_eps)
    return _head(model, x), caches


def precompute_ctx_kvs(model: LM, context):
    """Per-layer context K/V of the cross-attention layers (None for the
    others), or None without a context or a cross-attention layer."""
    ctx = _encode_context(model, context)
    if ctx is None or not any(
            layer.kind == "cross_attn" for layer in model.blocks):
        return None
    return [context_kv(layer.xattn, model.cfg, ctx)
            if layer.kind == "cross_attn" else None
            for layer in model.blocks]


def decode_step(model: LM, token, caches, pos: int, context=None,
                ctx_kvs=None):
    """One decode step.  token (B, 1) integers; ``pos`` the position
    written.  Returns (logits (B, 1, V), caches); the KV caches are
    updated in place.  Without ``ctx_kvs`` (``precompute_ctx_kvs``) the
    context is encoded again, as the reference does."""
    cfg = model.cfg
    if ctx_kvs is None:
        ctx_kvs = precompute_ctx_kvs(model, context)
    x = constrain_act(embed(model.embed, token))
    unit_len = len(cfg.block_program()[0])
    new = []
    for i, (layer, cache) in enumerate(zip(model.blocks, caches)):
        if i % unit_len == 0:
            x = constrain_act(x)
        ck = ctx_kvs[i] if ctx_kvs is not None else None
        x, c = blocks.apply_layer_decode(layer, cfg, x, cache, pos, ck)
        new.append(c)
    x = rmsnorm(model.final_norm, x, cfg.norm_eps)
    return _head(model, x), new


def make_caches(cfg: ModelConfig, batch: int, seq: int,
                dtype=torch.bfloat16, device=None):
    unit, repeats = cfg.block_program()
    return blocks.make_caches(cfg, unit * repeats, batch, seq, dtype,
                              resolve_device(device))


def param_count(model) -> int:
    """Parameters of a model, or of a train state's ``params`` dict."""
    ps = model.parameters() if isinstance(model, nn.Module) else \
        model.values()
    return sum(p.numel() for p in ps)


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Smoke-test twin: the same family and block pattern, tiny dims."""
    unit, _ = cfg.block_program()
    small = dict(
        num_layers=2 * len(unit) if len(unit) <= 8 else len(unit),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
        d_ff=128,
        vocab_size=256,
        head_dim=16,
        moe_d_ff=32 if cfg.moe_d_ff else 0,
        num_experts=min(cfg.num_experts, 4),
        num_experts_per_tok=min(cfg.num_experts_per_tok, 2),
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        vision_tokens=16 if cfg.vision_tokens else 0,
        vision_d=32 if cfg.vision_d else 0,
        encoder_layers=2 if cfg.encoder_layers else 0,
        audio_frames=16 if cfg.audio_frames else 0,
        param_dtype="float32",
        moment_dtype="float32",
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)

"""Token-choice Mixture-of-Experts with capacity-based dispatch.

Counterpart of ``repro.models.moe``: the one-hot einsum dispatch
(``moe_ffn``) and the slot-table gather dispatch (``moe_ffn_gather``),
the same function computed two ways, with the Switch load-balance and
router z aux losses.  Tokens are split into groups of
``cfg.moe_group_size`` (one group when that does not divide the token
count); inside a group a (token, expert) pair takes its expert's next
capacity slot in token order, and pairs past the capacity drop to the
residual.  Top-k is k rounds of argmax, whose first-maximum tie rule is
JAX's.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (P, constrain_moe, normal, param,
                                       promoted)
from repro_torch.models.sharded import (combine_experts, is_dtensor,
                                        per_expert, per_group)

_F32 = torch.float32


class MoE(nn.Module):
    def __init__(self, cfg, dtype, generator, device):
        super().__init__()
        d, e = cfg.d_model, cfg.num_experts
        f = cfg.moe_d_ff or cfg.d_ff
        self.router = param(normal((d, e), d ** -0.5, dtype, generator,
                                   device))
        self.wi = param(normal((e, d, f), d ** -0.5, dtype, generator, device))
        self.wg = param(normal((e, d, f), d ** -0.5, dtype, generator, device))
        self.wo = param(normal((e, f, d), f ** -0.5, dtype, generator, device))

    def specs(self, rules):
        # the router (D x E) is tiny and replicated: a D-sharded router
        # would move the (G, S, D) tokens to a D-sharded layout per layer
        fsdp, tp = rules.fsdp, rules.tp
        return {"router": P(None, None), "wi": P(tp, fsdp, None),
                "wg": P(tp, fsdp, None), "wo": P(tp, None, fsdp)}


def _einsum(eq, *ops):
    return torch.einsum(eq, *promoted(*ops))


def _topk_onehot(probs, k: int):
    """probs (T, E) -> (gates (T, E), selected (T, E) bool) from k argmax
    rounds."""
    e = probs.shape[-1]
    remaining = probs
    gates = torch.zeros_like(probs)
    sel = torch.zeros(probs.shape, dtype=torch.bool, device=probs.device)
    for _ in range(k):
        hot = F.one_hot(remaining.argmax(-1), e).to(probs.dtype)
        gates = gates + probs * hot
        sel = sel | hot.bool()
        remaining = remaining * (1.0 - hot) - hot
    return gates, sel


def _topk_idx_gates(probs, k: int):
    """k argmax rounds: (expert index (N, k) int64, gate (N, k))."""
    remaining = probs
    idxs, gs = [], []
    for _ in range(k):
        idx = remaining.argmax(-1)
        hot = F.one_hot(idx, probs.shape[-1]).to(probs.dtype)
        gs.append((probs * hot).sum(-1))
        idxs.append(idx)
        remaining = remaining * (1.0 - hot) - hot
    return torch.stack(idxs, -1), torch.stack(gs, -1)


def _groups(cfg, x, capacity_factor):
    """(tokens (G, S, D), n, s, g, cap) of the dispatch."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    cf = capacity_factor or cfg.capacity_factor
    n = b * t
    s = min(cfg.moe_group_size, n)
    if n % s:
        s = n                  # one group (decode / odd shapes)
    g = n // s
    return x.reshape(g, s, d), n, s, g, max(int(s * k * cf / e), 1)


def _router(router, tokens):
    """Router logits in the token dtype, upcast after the product, and
    their softmax.  ``router`` is the (D, E) weight."""
    logits = (tokens @ router.to(tokens.dtype)).to(_F32)       # (G, S, E)
    return logits, torch.softmax(logits, dim=-1)


def _aux(cfg, logits, probs_flat, sel_flat):
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    me = probs_flat.mean(0)
    ce = sel_flat.to(_F32).mean(0) * e / k
    return {"moe_balance": (me * ce).sum() * cfg.aux_loss_weight * e,
            "router_z": torch.logsumexp(logits, -1).square().mean()
                        * cfg.router_z_weight}


def _swiglu(xe, wi, wg, wo):
    h = F.silu(_einsum("gecd,edf->gecf", xe, wg)) \
        * _einsum("gecd,edf->gecf", xe, wi)
    return _einsum("gecf,efd->gecd", h, wo)


def _experts(p, xe):
    """SwiGLU of each expert on its slots: (G, E, C, D) -> (G, E, C, D),
    the slots pinned to (groups -> dp, experts -> tp) under a launcher
    context, where each rank runs its experts on its groups
    (``per_expert``)."""
    xe = constrain_moe(xe, {0: "dp", 1: "tp"})
    if is_dtensor(xe):
        return per_expert(_swiglu, xe, (p.wi, p.wg, p.wo))
    return _swiglu(xe, p.wi, p.wg, p.wo)


def _einsum_dispatch(tokens, router, cfg, cap):
    """The one-hot dispatch of each group: (xe (G, E, C, D), combine (G, S,
    E, C), router logits and probs (G, S, E), selected (G, S, E))."""
    g, s, d = tokens.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    n = g * s
    logits, probs = _router(router, tokens)
    gates, sel = _topk_onehot(probs.reshape(n, e), k)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    gates = gates.reshape(g, s, e)
    sel = sel.reshape(g, s, e)

    pos_in_expert = torch.cumsum(sel.to(torch.int32), dim=1) - 1  # (G, S, E)
    keep = sel & (pos_in_expert < cap)
    slot = torch.where(keep, pos_in_expert, torch.full_like(pos_in_expert,
                                                            cap))
    dispatch = F.one_hot(slot.long(), cap + 1).to(tokens.dtype)[..., :cap]
    combine = dispatch * gates[..., None].to(tokens.dtype)         # (G,S,E,C)
    return (_einsum("gsec,gsd->gecd", dispatch, tokens), combine, logits,
            probs, sel)


def _einsum_combine(ye, combine):
    return _einsum("gsec,gecd->gsd", combine, ye.to(combine.dtype))


def moe_ffn(p, cfg, x, *, capacity_factor: float | None = None):
    """x (B, T, D) -> (B, T, D) and the aux losses: the one-hot dispatch
    and combine tensors (G, S, E, C).  On DTensors the dispatch runs per
    group shard and the combine per (group, expert) shard, its partial
    sums over the expert shards reduced after."""
    b, t, d = x.shape
    e = cfg.num_experts
    tokens, n, s, g, cap = _groups(cfg, x, capacity_factor)
    dispatch = functools.partial(_einsum_dispatch, cfg=cfg, cap=cap)
    if is_dtensor(tokens):
        xe, combine, logits, probs, sel = per_group(
            dispatch, (tokens,), (p.router,), n_out=5)
    else:
        xe, combine, logits, probs, sel = dispatch(tokens, p.router)
    ye = _experts(p, xe)
    if is_dtensor(ye):
        y = combine_experts(_einsum_combine, ye, combine)
    else:
        y = _einsum_combine(ye, combine)
    aux = _aux(cfg, logits, probs.reshape(n, e), sel.reshape(n, e))
    return y.to(x.dtype).reshape(b, t, d), aux


def _gather_dispatch(tokens, router, cfg, cap):
    """The slot table of each group and its rows: (xe (G, E, C, D),
    flat_idx (G, S, k), gates (G, S, k), router logits and probs (G, S,
    E), choices per expert (G, S, E)).  Each group routes alone."""
    g, s, d = tokens.shape
    e, k = cfg.num_experts, cfg.num_experts_per_tok
    n = g * s
    logits, probs = _router(router, tokens)
    eidx, gates = _topk_idx_gates(probs.reshape(n, e), k)        # (N, k) x2
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-9)
    eidx = eidx.reshape(g, s, k)
    gates = gates.reshape(g, s, k).to(tokens.dtype)

    # slot of each (token, choice) inside its expert's queue, per group
    sel = F.one_hot(eidx, e).to(torch.int32)                     # (G,S,k,E)
    pos = torch.cumsum(sel.reshape(g, s * k, e), dim=1).reshape(
        g, s, k, e) - 1
    slot = torch.gather(pos, -1, eidx[..., None])[..., 0]        # (G,S,k)
    keep = slot < cap
    slot_c = torch.where(keep, slot, torch.full_like(slot, cap))

    # idx[g, e, c] = source token (or s, a row of zeros); the drop bin at
    # slot cap is written and cut off
    gg = torch.arange(g, device=tokens.device)[:, None, None].expand(g, s, k)
    ss = torch.arange(s, device=tokens.device)[None, :, None].expand(g, s, k)
    idx = torch.full((g, e, cap + 1), s, dtype=torch.long,
                     device=tokens.device)
    idx[gg, eidx, slot_c.long()] = ss
    idx = idx[:, :, :cap]

    tok_pad = torch.cat([tokens, tokens.new_zeros(g, 1, d)], dim=1)
    xe = torch.gather(tok_pad, 1, idx.reshape(g, e * cap, 1).expand(
        g, e * cap, d)).reshape(g, e, cap, d)
    flat_idx = torch.where(keep, eidx * cap + slot_c,
                           torch.full_like(slot_c, e * cap))
    return xe, flat_idx, gates, logits, probs, sel.sum(2)


def _gather_combine(ye, flat_idx, gates):
    """Token (g, s) reads its k slots back: (G, S, D)."""
    g, e, cap, d = ye.shape
    s, k = flat_idx.shape[1:]
    ye_flat = torch.cat([ye.reshape(g, e * cap, d),
                         ye.new_zeros(g, 1, d)], dim=1)          # drop bin
    yk = torch.gather(ye_flat, 1, flat_idx.reshape(g, s * k, 1).expand(
        g, s * k, d)).reshape(g, s, k, d)
    return _einsum("gskd,gsk->gsd", yk, gates)


def moe_ffn_gather(p, cfg, x, *, capacity_factor: float | None = None):
    """The same function through an explicit slot table idx (G, E, C) ->
    source token, moving rows with gathers: memory O(E * C * D) and no
    dispatch products.  On DTensors the table and the combine run per
    group shard (``per_group``); the experts' slots move between them,
    pinned to the tensor-parallel axis."""
    b, t, d = x.shape
    e = cfg.num_experts
    tokens, n, s, g, cap = _groups(cfg, x, capacity_factor)
    dispatch = functools.partial(_gather_dispatch, cfg=cfg, cap=cap)
    if is_dtensor(tokens):
        xe, flat_idx, gates, logits, probs, chosen = per_group(
            dispatch, (tokens,), (p.router,), n_out=6)
    else:
        xe, flat_idx, gates, logits, probs, chosen = dispatch(tokens,
                                                              p.router)
    ye = _experts(p, xe)
    if is_dtensor(ye):
        y = per_group(_gather_combine, (ye, flat_idx, gates))
    else:
        y = _gather_combine(ye, flat_idx, gates)
    aux = _aux(cfg, logits, probs.reshape(n, e), chosen.reshape(n, e))
    return y.to(x.dtype).reshape(b, t, d), aux

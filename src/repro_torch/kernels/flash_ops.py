"""Flash attention on model-layout tensors, and its plain GQA oracle.

Counterpart of ``repro.kernels.flash_ops``.  ``flash_attention(q, k, v)``
takes q (B, T, H, Dh) and k, v (B, S, Hkv, Dh) and runs the one-pass
forward of ``repro_torch.kernels.flash_attention`` on their heads-major
views, read in place (a non-float32 input is cast first); the output
comes back in ``q.dtype``.  The backward is the reference's: for each
``bwd_chunk`` of query rows, the gradient of the oracle on that chunk (its
query rows at ``q_offset + start``), with dk and dv summed over the
chunks, so its memory is O(chunk · S).  CPU tensors run the kernels'
plain twins; CUDA tensors launch the kernels.

The forward runs as the custom op ``repro_torch::flash_fwd``: on ``meta``
tensors its fake implementation gives the shapes, and its FLOP formula is
SDPA's (the two products over every (query, key) pair, masked or not,
kv heads broadcast), so that ``repro_torch.launch.dryrun`` can trace and
cost attention.  On DTensors (the sharded builders of
``repro_torch.launch.steps``) the op runs per shard
(``repro_torch.models.sharded.flash_sharded``); over a key sequence
sharded on the mesh, the ranges' partials merge in the split-K merge
kernel, as the custom op ``repro_torch::flash_merge``.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels.flash_attention import flash_combine, flash_forward

_F32 = torch.float32


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, q_offset: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_forward`` of heads-major float32 operands: (o, m, l)."""
    return flash_forward(q, k, v, causal, q_offset)


@flash_fwd.register_fake
def _(q, k, v, causal, q_offset):
    return (q.new_empty(q.shape, dtype=_F32),
            q.new_empty(q.shape[:-1], dtype=_F32),
            q.new_empty(q.shape[:-1], dtype=_F32))


@torch.library.custom_op("repro_torch::flash_merge", mutates_args=())
def flash_merge(o_part: torch.Tensor, m_part: torch.Tensor,
                l_part: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``flash_combine`` of split partials (S, R, Dh), (S, R), (S, R):
    (o, m, l); on ``meta`` tensors only the shapes."""
    return flash_combine(o_part, m_part, l_part)


@flash_merge.register_fake
def _(o_part, m_part, l_part):
    return (o_part.new_empty(o_part.shape[1:]),
            m_part.new_empty(m_part.shape[1:]),
            m_part.new_empty(m_part.shape[1:]))


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _flash_fwd_flops(q_shape, k_shape, v_shape, *args, out_shape=None,
                     **kwargs) -> int:
    """SDPA's count with kv heads broadcast (GQA): q k^T and p v, two
    FLOPs per multiply-add, over every (query, key) pair."""
    b, h, tq, dh = q_shape
    tk, dv = k_shape[2], v_shape[3]
    return 2 * b * h * tq * tk * dh + 2 * b * h * tq * tk * dv


def flash_attention_ref(q, k, v, *, causal=True, q_offset=0):
    """Plain GQA oracle.  q (B, T, H, Dh), k and v (B, S, Hkv, Dh);
    query head h attends to kv head h // (H / Hkv)."""
    b, tq, h, dh = q.shape
    hkv = k.shape[2]
    rep = h // hkv
    qg = q.reshape(b, tq, hkv, rep, dh)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg.to(_F32),
                     k.to(_F32)) * (dh ** -0.5)
    if causal:
        rows = torch.arange(tq, device=q.device)[:, None] + q_offset
        cols = torch.arange(k.shape[1], device=q.device)[None, :]
        s = torch.where(cols <= rows, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", p, v.to(_F32))
    return out.reshape(b, tq, h, dh)


def fold_heads(t):
    """(B, T, heads, Dh) -> contiguous float32 (B·heads, T, Dh)."""
    b, n, heads, dh = t.shape
    return t.to(_F32).transpose(1, 2).reshape(b * heads, n, dh).contiguous()


def heads_major(t):
    """(B, T, heads, Dh) -> float32 (B, heads, T, Dh), a view of t itself
    when t is float32 with a unit stride along Dh."""
    t = t.to(_F32)
    return (t if t.stride(-1) == 1 else t.contiguous()).transpose(1, 2)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, causal, q_offset, bwd_chunk):
        o, _, _ = flash_fwd(*(heads_major(t.detach()) for t in (q, k, v)),
                            causal, q_offset)
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, q_offset, bwd_chunk)
        return o.transpose(1, 2).to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        causal, q_offset, chunk = ctx.args
        dq = torch.empty(q.shape, dtype=_F32, device=q.device)
        dk = torch.zeros(k.shape, dtype=_F32, device=k.device)
        dv = torch.zeros(v.shape, dtype=_F32, device=v.device)
        with torch.enable_grad():
            kv = (k.detach().requires_grad_(), v.detach().requires_grad_())
            for start in range(0, q.shape[1], chunk):
                rows = slice(start, start + chunk)
                qb = q[:, rows].detach().requires_grad_()
                o = flash_attention_ref(qb, *kv, causal=causal,
                                        q_offset=q_offset + start)
                gq, gk, gv = torch.autograd.grad(o, (qb, *kv),
                                                 dout[:, rows].to(o.dtype))
                dq[:, rows] = gq
                dk += gk
                dv += gv
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def flash_attention(q, k, v, causal: bool = True, q_offset: int = 0,
                    bwd_chunk: int = 128):
    """Attention of q (B, T, H, Dh) over k, v (B, S, Hkv, Dh), H a
    multiple of Hkv (GQA), scaled by Dh^-1/2, computed in float32 and
    returned in q's dtype.  ``causal`` masks key j for query row i unless
    ``j <= i + q_offset`` (``q_offset``: the position of query row 0, e.g.
    the cache length when decoding).  ``bwd_chunk``: query rows per
    backward chunk."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"expected q (B, T, H, Dh) and k, v (B, S, Hkv, "
                         f"Dh), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, dh = q.shape
    if k.shape[0] != b or k.shape[3] != dh or h % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share batch and head_dim with H a multiple of Hkv")
    if int(bwd_chunk) < 1:
        raise ValueError(f"bwd_chunk must be >= 1, got {bwd_chunk}")
    if type(q) is not torch.Tensor:
        from repro_torch.models.sharded import flash_sharded, is_dtensor
    if type(q) is not torch.Tensor and is_dtensor(q):
        return flash_sharded(
            lambda ql, kl, vl, c, off: _FlashAttention.apply(
                ql, kl, vl, c, off, int(bwd_chunk)),
            _parts, q, k, v, bool(causal), int(q_offset))
    return _FlashAttention.apply(q, k, v, bool(causal), int(q_offset),
                                 int(bwd_chunk))


def _parts(q, k, v, causal, q_offset):
    """(o, m, l) of the forward in model layout: o (B, T, H, Dh), m and l
    (B, T, H), float32."""
    o, m, l = flash_fwd(*(heads_major(t) for t in (q, k, v)), causal,
                        q_offset)
    return o.transpose(1, 2), m.transpose(1, 2), l.transpose(1, 2)

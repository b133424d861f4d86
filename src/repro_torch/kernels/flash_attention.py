"""The flash-attention forward kernels for Hopper, each beside its plain
PyTorch twin: the counterparts of the Pallas ``_stats_kernel`` and
``_apply_kernel`` of ``repro.kernels.flash_attention``.

Operands are folded and unpadded, float32: ``q`` (B·H, Tq, Dh) and ``k``,
``v`` (B·Hkv, Tk, Dh), planes ordered (batch, head).  Query plane ``p``
attends to key/value plane ``p // rep`` with ``rep = H / Hkv`` (GQA):
for ``p = b H + h`` that is ``b Hkv + h // rep``.  With
``s_ij = (q_i . k_j) / sqrt(Dh)``, scored where ``j < Tk`` and, causal,
``j <= i + q_offset``:

* ``flash_stats`` — one sweep per row for the row max ``m`` and the
                    denominator ``l = sum_j exp(s_ij - m_i)``, (B·H, Tq).
* ``flash_apply`` — ``o_i = sum_j exp(s_ij - m_i) / l_i v_j`` with m and
                    l read back, (B·H, Tq, Dh).

A row with no scored key (causal with ``i + q_offset < 0``) is the
uniform average of the Tk value rows, as the oracle
``flash_ops.flash_attention_ref`` gives it.

Each wrapper routes on the device of its operands: CPU tensors go to the
plain twin (``*_plain``), which computes the same blocked algorithm in
plain PyTorch; CUDA tensors launch the kernel from
``csrc/flash_attention.cu`` and raise if the launch fails.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import clib

NEG_INF = -1e30
PLAIN_BLOCK = 128      # key block of the plain twins
_F32 = torch.float32


def _check(q, k, v=None):
    """Validate the folded operands; return (rep, Tq, Tk, Dh)."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be (planes, T, Dh), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    bh, tq, dh = q.shape
    bhkv, tk, dhk = k.shape
    if dhk != dh or bhkv == 0 or bh % bhkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "fold to B·H and B·Hkv planes of one head_dim")
    if tk == 0:
        raise ValueError("attention over zero keys")
    if v is not None and v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    for t in (q, k, v):
        if t is not None and (t.dtype != _F32 or not t.is_contiguous()):
            raise ValueError("flash operands must be contiguous float32")
    if bh > 65535:
        raise ValueError(f"{bh} query planes exceed the grid limit 65535")
    return bh // bhkv, tq, tk, dh


def _scores(qg, kj, rows, cols, causal, q_offset, scale):
    """Scores of the grouped query rows against one key block, and their
    mask.  qg (Bkv, rep·Tq, Dh); rows the query position of each row."""
    s = (qg @ kj.transpose(1, 2)) * scale
    ok = torch.ones(s.shape[1:], dtype=torch.bool, device=s.device)
    if causal:
        empty = rows + q_offset < 0
        ok = ok & ((cols[None, :] <= rows[:, None] + q_offset)
                   | empty[:, None])
        s = torch.where(empty[:, None], torch.zeros_like(s), s)
    return torch.where(ok, s, torch.full_like(s, NEG_INF)), ok


def _grouped(q, k):
    """The query planes grouped by their kv plane, and what ``_scores``
    needs besides a key block."""
    rep, tq, tk, dh = _check(q, k)
    qg = q.reshape(k.shape[0], rep * tq, dh)
    rows = torch.arange(tq, device=q.device).repeat(rep)
    return qg, rows, tk, dh ** -0.5


def flash_stats_plain(q, k, causal=True, q_offset=0):
    """Twin of kernel 10a: online max and denominator over key blocks.
    m and l (B·H, Tq) float32."""
    qg, rows, tk, scale = _grouped(q, k)
    m = torch.full(qg.shape[:2], NEG_INF, dtype=_F32, device=q.device)
    l = torch.zeros_like(m)
    for j0 in range(0, tk, PLAIN_BLOCK):
        cols = torch.arange(j0, min(j0 + PLAIN_BLOCK, tk), device=q.device)
        s, ok = _scores(qg, k[:, j0:j0 + PLAIN_BLOCK], rows, cols, causal,
                        q_offset, scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * torch.exp(m - m_new) + p.sum(dim=-1)
        m = m_new
    return m.reshape(q.shape[:2]), l.reshape(q.shape[:2])


def flash_apply_plain(q, k, v, m, l, causal=True, q_offset=0):
    """Twin of kernel 10b: ``o = P v`` over key blocks, P from the given m
    and l.  (B·H, Tq, Dh) float32."""
    qg, rows, tk, scale = _grouped(q, k)
    mc = m.reshape(qg.shape[:2])[..., None]
    lc = torch.clamp_min(l.reshape(qg.shape[:2]), 1e-30)[..., None]
    o = torch.zeros(qg.shape, dtype=_F32, device=q.device)
    for j0 in range(0, tk, PLAIN_BLOCK):
        cols = torch.arange(j0, min(j0 + PLAIN_BLOCK, tk), device=q.device)
        s, ok = _scores(qg, k[:, j0:j0 + PLAIN_BLOCK], rows, cols, causal,
                        q_offset, scale)
        p = torch.where(ok, torch.exp(s - mc) / lc, 0.0)
        o = o + p @ v[:, j0:j0 + PLAIN_BLOCK]
    return o.reshape(q.shape)


_P, _I, _F = clib.P, clib.I, clib.F
_GEOM = [_I] * 5 + [_F, _I, _I]      # bh, rep, tq, tk, dh, scale, causal, off


def flash_stats(q, k, causal=True, q_offset=0):
    """Kernel 10a.  (m, l), (B·H, Tq) float32."""
    if clib.route(q, k) == "cpu":
        return flash_stats_plain(q, k, causal, q_offset)
    rep, tq, tk, dh = _check(q, k)
    m = torch.empty(q.shape[:2], dtype=_F32, device=q.device)
    l = torch.empty_like(m)
    if m.numel():
        clib.launch(flash_stats, "flash_attention", "fa_stats_f32",
                    [_P] * 4 + _GEOM, q, k, m, l, q.shape[0], rep, tq, tk,
                    dh, dh ** -0.5, int(causal), int(q_offset))
    return m, l


def flash_apply(q, k, v, m, l, causal=True, q_offset=0):
    """Kernel 10b.  o (B·H, Tq, Dh) float32."""
    if clib.route(q, k, v, m, l) == "cpu":
        return flash_apply_plain(q, k, v, m, l, causal, q_offset)
    rep, tq, tk, dh = _check(q, k, v)
    for t in (m, l):
        if (t.shape != q.shape[:2] or t.dtype != _F32
                or not t.is_contiguous()):
            raise ValueError("m and l must be contiguous (B·H, Tq) float32")
    o = torch.empty_like(q)
    if o.numel():
        clib.launch(flash_apply, "flash_attention", "fa_apply_f32",
                    [_P] * 6 + _GEOM, q, k, v, m, l, o, q.shape[0], rep, tq,
                    tk, dh, dh ** -0.5, int(causal), int(q_offset))
    return o


KERNELS = (flash_stats, flash_apply)
for _k in KERNELS:
    _k.launches = 0

"""The flash-attention forward kernels for Hopper, each beside its plain
PyTorch twin: the counterpart of the Pallas ``_stats_kernel`` and
``_apply_kernel`` of ``repro.kernels.flash_attention``.

Operands are float32 and unpadded, either folded, ``q`` (B·H, Tq, Dh) and
``k``, ``v`` (B·Hkv, Tk, Dh) with planes ordered (batch, head), or
heads-major views ``q`` (B, H, Tq, Dh) and ``k``, ``v`` (B, Hkv, Tk, Dh)
with any strides (the model layout transposed, read in place).  Query
head ``h`` attends to kv head ``h // rep``, ``rep = H / Hkv`` (GQA).
With ``s_ij = (q_i . k_j) / sqrt(Dh)``, scored where ``j < Tk`` and,
causal, ``j <= i + q_offset``:

* ``flash_forward`` — one pass over the keys with an online softmax: o,
                      and the row max ``m`` and denominator
                      ``l = sum_j exp(s_ij - m_i)``.  With ``splits > 1``
                      each block covers one range of 64-key tiles; with
                      up to ``MAX_CLUSTER`` ranges the blocks of a row
                      tile are one thread block cluster and merge their
                      partials in the kernel's epilogue, through
                      distributed shared memory (one launch, counted on
                      ``flash_forward.cluster_launches`` too);
* ``flash_combine`` — merges the partials of more ranges, in a second
                      launch (and the ranks' partials of a sharded
                      decode, ``flash_ops.flash_merge``).

The two merges are bitwise one another: the epilogue repeats the
combine's arithmetic in its order.  ``flash_forward_split`` is the forward
kernel alone (its partials), for timing it apart from the merge and for
holding the epilogue to the two-launch path.

``decode_splits`` picks the split count: 1 when the row tiles alone fill
the card, else enough key ranges for about two blocks per SM, and where
those are merged in clusters, no more than one wave of resident
clusters holds.  A row with
no scored key (causal with ``i + q_offset < 0``) is the uniform average of
the Tk value rows, as the oracle ``flash_ops.flash_attention_ref`` gives
it.

``flash_stats_plain`` and ``flash_apply_plain`` are the twins of the two
TPU passes (m and l; o from given m and l), against which the card checks
hold the kernel's m, l and o.

Each wrapper routes on the device of its operands: CPU tensors go to the
plain twin (``*_plain``), which computes the same blocked algorithm in
plain PyTorch; CUDA tensors launch the kernel from
``csrc/flash_attention.cu`` and raise if the launch fails.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import clib

NEG_INF = -1e30
PLAIN_BLOCK = 128      # key block of the plain twins
KT = 64                # keys per tile of the kernel (csrc KT)
MAX_DH = 128           # the widest head the kernel's tiles hold
BLOCKS_WANTED = 264    # about two blocks on each of an H100's 132 SMs
MAX_CLUSTER = 8        # the portable cluster size: the most key ranges
                       # merged in the forward's epilogue (csrc MAX_CLUSTER)
_F32 = torch.float32


def _check(q, k, v=None):
    """Validate the operands; return (batch, H, Hkv, Tq, Tk, Dh), with
    batch 1 and the planes as heads for folded (3-D) operands."""
    if q.dim() not in (3, 4) or k.dim() != q.dim():
        raise ValueError(f"q and k must be (planes, T, Dh) or (B, heads, T, "
                         f"Dh), got {tuple(q.shape)} and {tuple(k.shape)}")
    if v is not None and v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    batch = q.shape[0] if q.dim() == 4 else 1
    hq, tq, dh = q.shape[-3:]
    hkv, tk, dhk = k.shape[-3:]
    if (dhk != dh or hkv == 0 or hq % hkv
            or (q.dim() == 4 and k.shape[0] != batch)):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "share batch and head_dim with H a multiple of Hkv")
    if tk == 0:
        raise ValueError("attention over zero keys")
    for t in (q, k, v):
        if t is not None and t.dtype != _F32:
            raise ValueError("flash operands must be float32")
    return batch, hq, hkv, tq, tk, dh


def _planes(t):
    """(…, T, Dh) -> (planes, T, Dh); a copy only for a view that has no
    such shape in place."""
    return t.reshape(-1, *t.shape[-2:])


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
    """The query planes grouped by their kv plane, the kv planes, and what
    ``_scores`` needs besides a key block."""
    batch, hq, hkv, tq, tk, dh = _check(q, k)
    kg = _planes(k)
    qg = q.reshape(kg.shape[0], hq // hkv * tq, dh)
    rows = torch.arange(tq, device=q.device).repeat(hq // hkv)
    return qg, kg, rows, tk, dh ** -0.5


def flash_stats_plain(q, k, causal=True, q_offset=0):
    """Twin of the TPU stats pass: online max and denominator over key
    blocks.  m and l, q.shape[:-1], float32."""
    qg, kg, rows, tk, scale = _grouped(q, k)
    m = torch.full(qg.shape[:2], NEG_INF, dtype=_F32, device=q.device)
    l = torch.zeros_like(m)
    for j0 in range(0, tk, PLAIN_BLOCK):
        j1 = min(j0 + PLAIN_BLOCK, tk)
        cols = torch.arange(j0, j1, device=q.device)
        s, ok = _scores(qg, kg[:, j0:j1], rows, cols, causal, q_offset,
                        scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        l = l * torch.exp(m - m_new) + p.sum(dim=-1)
        m = m_new
    return m.reshape(q.shape[:-1]), l.reshape(q.shape[:-1])


def flash_apply_plain(q, k, v, m, l, causal=True, q_offset=0):
    """Twin of the TPU apply pass: ``o = P v`` over key blocks, P from the
    given m and l.  Shaped like q, float32."""
    qg, kg, rows, tk, scale = _grouped(q, k)
    vg = _planes(v)
    mc = m.reshape(qg.shape[:2])[..., None]
    lc = torch.clamp_min(l.reshape(qg.shape[:2]), 1e-30)[..., None]
    o = torch.zeros(qg.shape, dtype=_F32, device=q.device)
    for j0 in range(0, tk, PLAIN_BLOCK):
        j1 = min(j0 + PLAIN_BLOCK, tk)
        cols = torch.arange(j0, j1, device=q.device)
        s, ok = _scores(qg, kg[:, j0:j1], rows, cols, causal, q_offset,
                        scale)
        p = torch.where(ok, torch.exp(s - mc) / lc, 0.0)
        o = o + p @ vg[:, j0:j1]
    return o.reshape(q.shape)


def row_tile(rows: int) -> int:
    """Query rows per block of the kernel for ``rows`` packed rows
    (rep·Tq) per kv plane: 16 for a short block (decode), else 64."""
    return 16 if rows <= 16 else 64


def split_plan(tk: int, splits: int) -> tuple[int, int]:
    """(splits, key tiles per split) for about ``splits`` key ranges over
    ``tk`` keys: every range holds at least one 64-key tile, none is
    empty, and no more than 65535 (the grid's y limit)."""
    nkt = -(-tk // KT)
    want = max(1, min(int(splits), nkt, 65535))
    tps = -(-nkt // want)
    return -(-nkt // tps), tps


def merges_in_cluster(splits: int) -> bool:
    """Whether ``flash_forward`` merges ``splits`` key ranges (a
    ``split_plan`` count) in its cluster epilogue: 2 to ``MAX_CLUSTER``.
    One range needs no merge; more go to ``flash_combine``."""
    return 1 < splits <= MAX_CLUSTER


@functools.lru_cache(maxsize=None)
def _resident(index: int, rows_tile: int, dh_tile: int, stages: int,
              splits: int) -> int:
    fn = clib._symbol("flash_attention", "fa_max_active_clusters",
                      (clib.I,) * 4 + (clib.P,), ctypes.c_int)
    count = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = fn(rows_tile, dh_tile, stages, splits, ctypes.addressof(count))
    if rc != 0:
        msg = clib._symbol("flash_attention", "fa_error_string",
                           (ctypes.c_int,), ctypes.c_char_p)(rc).decode()
        raise RuntimeError(f"fa_max_active_clusters failed ({rc}: {msg})")
    return count.value


def resident_clusters(device, rows_tile: int, dh: int, stages: int,
                      splits: int) -> int:
    """How many clusters of ``splits`` blocks of the merging forward the
    CUDA ``device`` holds at once (``cudaOccupancyMaxActiveClusters``) at
    a ``rows_tile`` row tile, heads of width ``dh`` and ``stages`` K/V
    stages; asked of the card once per device and shape."""
    device = torch.device(device)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    return _resident(index, rows_tile, 64 if dh <= 64 else MAX_DH, stages,
                     splits)


def decode_splits(bhkv: int, rows: int, tk: int, dh: int,
                  device=None) -> int:
    """The key split count of ``flash_forward`` for ``bhkv`` kv planes of
    ``rows`` packed query rows over ``tk`` keys of width ``dh``: 1 when
    the row tiles fill the card (``BLOCKS_WANTED`` blocks), else as many
    key ranges as give that many blocks with at least one 64-key tile
    each.  On a CUDA ``device``, where that is 2 to ``MAX_CLUSTER``
    ranges, merged in clusters, the most ranges up to it whose clusters
    are all resident at once (``resident_clusters``), or 1: a second wave
    of clusters costs more than the ranges save (PERF.md).  Elsewhere
    (the plain twins on the CPU) the count of two blocks per SM."""
    tile = row_tile(rows)
    blocks = bhkv * -(-rows // tile)
    if blocks == 0 or blocks >= BLOCKS_WANTED:
        return 1
    nkt = -(-tk // KT)
    tps = max(1, nkt // -(-BLOCKS_WANTED // blocks))
    splits = -(-nkt // tps)
    if (splits > MAX_CLUSTER or device is None
            or torch.device(device).type != "cuda"):
        return splits
    for want in range(splits, 1, -1):
        n, tps = split_plan(tk, want)
        if n > 1 and blocks <= resident_clusters(device, tile, dh,
                                                 1 if tps == 1 else 2, n):
            return n
    return 1


def flash_combine_plain(o_part, m_part, l_part):
    """Twin of ``flash_combine``: (o, m, l) from the partials, weighting
    split s by ``exp(m_s - m)``.  o_part (S, R, Dh), m_part and l_part
    (S, R); returns (R, Dh), (R,), (R,)."""
    m = m_part.amax(dim=0)
    w = torch.exp(m_part - m)
    l = (l_part * w).sum(dim=0)
    o = (o_part * w[..., None]).sum(dim=0) / torch.clamp_min(l, 1e-30)[
        ..., None]
    return o, m, l


def flash_forward_split_plain(q, k, v, causal=True, q_offset=0, splits=1):
    """Twin of ``flash_forward_split``: the online softmax over each key
    range of ``split_plan``.  (o, m, l) of shapes (S, R, Dh), (S, R),
    (S, R), R = B·H·Tq; o normalised when S = 1, else unnormalised."""
    qg, kg, rows, tk, scale = _grouped(q, k)
    vg = _planes(v)
    n, tps = split_plan(tk, splits)
    parts = []
    for s_ in range(n):
        m = torch.full(qg.shape[:2], NEG_INF, dtype=_F32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qg.shape, dtype=_F32, device=q.device)
        hi = min((s_ + 1) * tps * KT, tk)
        for j0 in range(s_ * tps * KT, hi, PLAIN_BLOCK):
            j1 = min(j0 + PLAIN_BLOCK, hi)
            cols = torch.arange(j0, j1, device=q.device)
            s, ok = _scores(qg, kg[:, j0:j1], rows, cols, causal, q_offset,
                            scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vg[:, j0:j1]
            m = m_new
        if n == 1:
            acc = acc / torch.clamp_min(l, 1e-30)[..., None]
        parts.append((acc.reshape(-1, qg.shape[2]), m.reshape(-1),
                      l.reshape(-1)))
    return tuple(torch.stack(t) for t in zip(*parts))


def flash_forward_plain(q, k, v, causal=True, q_offset=0, splits=1):
    """Twin of ``flash_forward``: the split-K online softmax, then the
    merge.  (o, m, l): o shaped like q, m and l q.shape[:-1], float32."""
    o, m, l = flash_forward_split_plain(q, k, v, causal, q_offset, splits)
    o, m, l = flash_combine_plain(o, m, l) if o.shape[0] > 1 else (
        o[0], m[0], l[0])
    return o.reshape(q.shape), m.reshape(q.shape[:-1]), l.reshape(
        q.shape[:-1])


_P, _I, _F, _L = clib.P, clib.I, clib.F, clib.L
_FWD_ARGS = ([_P] * 6 + [_I] * 6 + [_L] * 9 + [_F] + [_I] * 7)


def _strides(t):
    """(batch, head, row) strides in elements of a 3-D or 4-D operand."""
    return (t.stride(0), t.stride(1), t.stride(2)) if t.dim() == 4 else (
        0, t.stride(0), t.stride(1))


def flash_combine(o_part, m_part, l_part):
    """The split-K merge kernel.  o_part (S, R, Dh), m_part and l_part
    (S, R), contiguous float32 -> o (R, Dh), m and l (R,)."""
    splits, nrows, dh = o_part.shape
    for t in (o_part, m_part, l_part):
        if t.dtype != _F32:
            raise ValueError("flash_combine operands must be float32")
    if m_part.shape != (splits, nrows) or l_part.shape != m_part.shape:
        raise ValueError(f"m_part {tuple(m_part.shape)} and l_part "
                         f"{tuple(l_part.shape)} must be {(splits, nrows)}")
    if clib.route(o_part, m_part, l_part) == "cpu":
        return flash_combine_plain(o_part, m_part, l_part)
    if not all(t.is_contiguous() for t in (o_part, m_part, l_part)):
        raise ValueError("flash_combine operands must be contiguous")
    o = torch.empty(nrows, dh, dtype=_F32, device=o_part.device)
    m = torch.empty(nrows, dtype=_F32, device=o_part.device)
    l = torch.empty_like(m)
    if nrows:
        clib.launch(flash_combine, "flash_attention", "fa_combine_f32",
                    [_P] * 6 + [_L, _I, _I], o_part, m_part, l_part, o, m, l,
                    nrows, dh, splits)
    return o, m, l


def _forward(q, k, v, causal, q_offset, splits, merge):
    """Launch the forward kernel on CUDA operands: (o, m, l) of shapes
    (S, R, Dh), (S, R), (S, R), S = 1 when ``merge``."""
    batch, hq, hkv, tq, tk, dh = _check(q, k, v)
    if dh > MAX_DH:
        raise ValueError(f"head_dim {dh} > {MAX_DH}, the kernel's widest")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash operands need a unit stride along Dh")
    strides = [s for t in (q, k, v) for s in _strides(t)]
    vec16 = (dh % 4 == 0 and all(s % 4 == 0 for s in strides)
             and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    n, tps = split_plan(tk, splits)
    nrows = batch * hq * tq
    out = 1 if merge else n
    o = torch.empty(out, nrows, dh, dtype=_F32, device=q.device)
    m = torch.empty(out, nrows, dtype=_F32, device=q.device)
    l = torch.empty_like(m)
    if nrows:
        clib.launch(flash_forward, "flash_attention", "fa_fwd_f32",
                    _FWD_ARGS, q, k, v, o, m, l, batch, hq, hkv, tq, tk, dh,
                    *strides, dh ** -0.5, int(causal), int(q_offset), n, tps,
                    row_tile(hq // hkv * tq), int(vec16), int(merge))
        if merge:
            flash_forward.cluster_launches += 1
    return o, m, l


def flash_forward_split(q, k, v, causal=True, q_offset=0, splits=1):
    """The forward kernel alone, on CUDA operands, at the key ranges of
    ``split_plan(Tk, splits)``: (o, m, l) of shapes (S, R, Dh), (S, R),
    (S, R) with R = B·H·Tq rows.  With S = 1 they are the result; with
    more, each split's partial (o unnormalised) for ``flash_combine``.
    Counts its launch on ``flash_forward``."""
    _check(q, k, v)
    if clib.route(q, k, v) == "cpu":
        return flash_forward_split_plain(q, k, v, causal, q_offset, splits)
    return _forward(q, k, v, causal, q_offset, splits, False)


def flash_forward(q, k, v, causal=True, q_offset=0, splits=None):
    """The one-pass forward kernel, merging its key splits in its cluster
    epilogue (up to ``MAX_CLUSTER``) or, with more, in the combine.
    ``splits`` None takes ``decode_splits``.  Returns (o, m, l): o shaped
    like q, m and l q.shape[:-1], contiguous float32."""
    batch, hq, hkv, tq, tk, dh = _check(q, k, v)
    if splits is None:
        splits = decode_splits(batch * hkv, hq // hkv * tq, tk, dh,
                               q.device)
    if clib.route(q, k, v) == "cpu":
        return flash_forward_plain(q, k, v, causal, q_offset, splits)
    merge = merges_in_cluster(split_plan(tk, splits)[0])
    o, m, l = _forward(q, k, v, causal, q_offset, splits, merge)
    o, m, l = flash_combine(o, m, l) if o.shape[0] > 1 else (
        o[0], m[0], l[0])
    return o.reshape(q.shape), m.reshape(q.shape[:-1]), l.reshape(
        q.shape[:-1])


KERNELS = (flash_forward, flash_combine)
for _k in KERNELS:
    _k.launches = 0
flash_forward.cluster_launches = 0   # the launches that merged in-kernel

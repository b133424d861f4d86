"""The model's ops on DTensors where PyTorch's sharding rules do not give
the reference's layout.

Under the launcher (``repro_torch.launch.steps``) the parameters, the batch
and the caches are DTensors on a ``DeviceMesh``, and most ops propagate
their sharding by DTensor's own rules.  These do not, and run here per
shard, with the collectives the reference's SPMD program has:

* ``embed_sharded`` — the lookup in a (vocab -> tp, d -> fsdp) table: the
  table's FSDP shards are gathered, each tensor-parallel rank looks up the
  tokens of its vocab range (the others give zero rows), and the rows are
  summed over tp (a ``Partial`` output that the next ``constrain_act``
  all-reduces).  DTensor's rule for ``index`` would gather the whole table.
* ``flash_sharded`` — attention per batch shard and head shard, on the
  flash kernel (a custom ``autograd.Function`` has no sharding rule); with
  a sequence-sharded KV cache (the decode cells), each rank attends over
  its key range and the partial (o, m, l) are gathered and merged in the
  split-K merge kernel (``flash_combine``).
* ``per_group``, ``per_expert``, ``combine_experts`` — the MoE layer:
  each group routes alone (its dispatch, and the gather dispatch's
  combine, per group shard: scatters and gathers of token rows, which
  DTensor cannot shard), each rank runs its experts on its groups, and
  the one-hot combine sums over the expert shards.
* ``lse_and_pick`` — the loss's logsumexp and label logit over
  vocab-sharded logits: local maxima and sums reduced over tp, and the
  label logit taken where its vocab range lies (DTensor would gather the
  (B, T, V) logits, or fails on ``gather``).
* ``write_cache`` — the decode step's in-place write of the new K/V at
  ``pos`` into a cache that may be sharded along its sequence.
* ``heads_view``, ``merge_heads`` — (.., H * Dh) <-> (.., H, Dh) where the
  heads do not split evenly over the ranks of the hidden dim.

``ensure_rules`` adds a sharding rule that an older torch's DTensor lacks.
A mesh dim of size 1 shards nothing and is treated as replicated, so on a
(1, 1) mesh each of these is the one-device op on the whole tensor.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ensure_rules():
    """Register a sharding rule for ``aten.flip`` (cumsum's backward) on a
    torch whose DTensor has none (2.11): flipped dims replicated, any
    other dim may stay split.  A torch that has one keeps it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    op = torch.ops.aten.flip.default
    prop = DTensor._op_dispatcher.sharding_propagator
    if op in prop.op_strategy_funcs or op in getattr(
            prop, "op_single_dim_strategy_funcs", {}):
        return

    @register_sharding(op)
    def flip(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
            if d not in flipped]


def is_dtensor(t) -> bool:
    if not isinstance(t, torch.Tensor) or type(t) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _shard_dims(t, dim):
    """Mesh dims (of size > 1) on which DTensor ``t`` is Shard(dim)."""
    mesh = t.device_mesh
    return [i for i, pl in enumerate(t.placements)
            if pl.is_shard(dim) and mesh.size(i) > 1]


def _linear_coord(mesh, dims):
    """This rank's index along the product of mesh ``dims`` (first
    major)."""
    coord = mesh.get_coordinate()
    idx = 0
    for i in dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx


# ------------------------------------------------------------- embedding

def embed_sharded(table, tokens):
    """Rows of a DTensor ``table`` (V, D) for ``tokens`` (B, T)."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          Shard)
    from torch.distributed.tensor.experimental import local_map
    mesh = table.device_mesh
    if not is_dtensor(tokens):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    batch = set(_shard_dims(tokens, 0))
    vocab = _shard_dims(table, 0)
    # the table's d shards stay only where the tokens are not split (the
    # "hidden" layout); where they are (FSDP), they are gathered
    hidden = [i for i in _shard_dims(table, 1) if i not in batch]
    if set(vocab) & batch:
        raise ValueError(f"tokens {tokens.placements} and table "
                         f"{table.placements} split one mesh dim both ways")
    t_pl = tuple(Shard(0) if i in vocab else Shard(1) if i in hidden
                 else Replicate() for i in range(mesh.ndim))
    x_pl = tuple(Shard(0) if i in batch else Replicate()
                 for i in range(mesh.ndim))
    out_pl = tuple(Shard(0) if i in batch else Partial() if i in vocab
                   else Shard(2) if i in hidden else Replicate()
                   for i in range(mesh.ndim))
    grad_pl = tuple(Shard(0) if i in vocab else Shard(1) if i in hidden
                    else Partial() if i in batch else Replicate()
                    for i in range(mesh.ndim))
    rows = table.shape[0] // max(1, _prod(mesh, vocab))
    start = _linear_coord(mesh, vocab) * rows

    def lookup(tab, tok):
        if not vocab:
            return tab[tok]
        local = tok - start
        hit = (local >= 0) & (local < rows)
        got = tab[torch.where(hit, local, torch.zeros_like(local))]
        return torch.where(hit[..., None], got, torch.zeros_like(got))

    return local_map(lookup, out_placements=list(out_pl),
                     in_placements=(t_pl, x_pl),
                     in_grad_placements=(grad_pl, x_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def heads_view(x, n_heads: int, dh: int):
    """x (..., n_heads * dh) viewed as (..., n_heads, dh).  A DTensor
    whose last dim is split over more ranks than divide ``n_heads`` is
    gathered on those mesh dims first (its heads cannot split evenly)."""
    if is_dtensor(x):
        dims = _shard_dims(x, x.ndim - 1)
        if dims and n_heads % _prod(x.device_mesh, dims):
            from torch.distributed.tensor import Replicate
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in dims else pl
                for i, pl in enumerate(x.placements)])
    return x.reshape(*x.shape[:-1], n_heads, dh)


def merge_heads(o):
    """o (..., H, Dh) viewed as (..., H * Dh).  A DTensor is viewed per
    shard, so that its gradient comes back in o's layout whatever the
    layout of the gradient of the view (heads that do not split evenly
    cannot take a split of H * Dh)."""
    if not is_dtensor(o):
        return o.reshape(*o.shape[:-2], -1)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    if any(p.is_partial() for p in o.placements):     # sums first
        o = o.redistribute(o.device_mesh, [
            Replicate() if p.is_partial() else p for p in o.placements])
    pl = list(o.placements)
    if any(p.is_shard(o.ndim - 1) for p in pl):
        raise ValueError(f"heads to merge laid out as {pl}")
    return local_map(lambda t: t.reshape(*t.shape[:-2], -1),
                     out_placements=pl, in_placements=(pl,),
                     in_grad_placements=(pl,), device_mesh=o.device_mesh)(o)


def vocab_sharded(logits) -> bool:
    return is_dtensor(logits) and bool(_shard_dims(logits, logits.ndim - 1))


def lse_and_pick(logits, labels):
    """(logsumexp over the last dim, ``logits[..., labels]``) of DTensor
    logits sharded along their last (vocab) dim."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh, last = logits.device_mesh, logits.ndim - 1
    vocab = _shard_dims(logits, last)
    m = logits.detach().amax(dim=-1, keepdim=True)
    m = m.redistribute(mesh, [Replicate() if pl.is_partial() else pl
                              for pl in m.placements])
    total = torch.exp(logits - m).sum(dim=-1)
    total = total.redistribute(mesh, [Replicate() if pl.is_partial()
                                      else pl for pl in total.placements])
    lse = torch.log(total) + m[..., 0]
    if not is_dtensor(labels):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    batch = [i for i in _shard_dims(labels, 0)]
    lg_pl = tuple(Shard(last) if i in vocab else Shard(0) if i in batch
                  else Replicate() for i in range(mesh.ndim))
    lb_pl = tuple(Shard(0) if i in batch else Replicate()
                  for i in range(mesh.ndim))
    out_pl = tuple(Partial() if i in vocab else Shard(0) if i in batch
                   else Replicate() for i in range(mesh.ndim))
    cols = logits.shape[last] // _prod(mesh, vocab)
    start = _linear_coord(mesh, vocab) * cols

    def pick(lg, lb):
        local = lb.long() - start
        hit = (local >= 0) & (local < cols)
        got = torch.gather(lg, -1, torch.where(
            hit, local, torch.zeros_like(local))[..., None])[..., 0]
        return torch.where(hit, got, torch.zeros_like(got))

    ll = local_map(pick, out_placements=list(out_pl),
                   in_placements=(lg_pl, lb_pl),
                   in_grad_placements=(lg_pl, lb_pl), device_mesh=mesh,
                   redistribute_inputs=True)(logits, labels)
    return lse, ll.redistribute(mesh, [Replicate() if pl.is_partial()
                                       else pl for pl in ll.placements])


def per_group(fn, grouped: tuple, replicated: tuple = (), n_out: int = 1):
    """``fn(*grouped, *replicated)`` per shard of the leading (group) dim
    of ``grouped[0]``: every ``grouped`` tensor and every output split
    alike along dim 0, the ``replicated`` ones whole on every rank (their
    gradients summed over the group shards).  The MoE dispatch and
    combine: each group routes alone."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = grouped[0].device_mesh
    dims = _shard_dims(grouped[0], 0)
    g_pl = tuple(Shard(0) if i in dims else Replicate()
                 for i in range(mesh.ndim))
    r_pl = (Replicate(),) * mesh.ndim
    r_grad = tuple(Partial() if i in dims else Replicate()
                   for i in range(mesh.ndim))
    out = tuple([g_pl] * n_out) if n_out > 1 else list(g_pl)
    return local_map(
        fn, out_placements=out,
        in_placements=(g_pl,) * len(grouped) + (r_pl,) * len(replicated),
        in_grad_placements=(g_pl,) * len(grouped)
        + (r_grad,) * len(replicated),
        device_mesh=mesh, redistribute_inputs=True)(*grouped, *replicated)


def _slot_dims(mesh, used, slots: int):
    """Mesh dims (of size > 1, not in ``used``) over which ``slots``
    capacity slots split evenly, taken in order."""
    out, n = [], 1
    for i in range(mesh.ndim):
        if i not in used and mesh.size(i) > 1 and slots % (
                n * mesh.size(i)) == 0:
            out.append(i)
            n *= mesh.size(i)
    return out


def per_expert(fn, xe, weights):
    """``fn(xe, *weights)`` per (group, expert, slot) shard: xe (G, E, C,
    D) split along G and E as it is laid out and along its slots C over
    the other mesh dims where C divides, so that no rank repeats another's
    work; each weight (E, ...) gathered whole except along E, which it
    splits as xe does.  A weight's gradient is a partial sum over the
    group and slot shards (reduce-scattered back to its layout by the
    train step)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = xe.device_mesh
    g_dims, e_dims = _shard_dims(xe, 0), _shard_dims(xe, 1)
    c_dims = _slot_dims(mesh, g_dims + e_dims, xe.shape[2])
    x_pl = tuple(Shard(0) if i in g_dims else Shard(1) if i in e_dims
                 else Shard(2) if i in c_dims else Replicate()
                 for i in range(mesh.ndim))
    w_pl = tuple(Shard(0) if i in e_dims else Replicate()
                 for i in range(mesh.ndim))
    w_grad = tuple(Shard(0) if i in e_dims else Partial()
                   if i in g_dims or i in c_dims else Replicate()
                   for i in range(mesh.ndim))
    n = len(weights)
    return local_map(fn, out_placements=list(x_pl),
                     in_placements=(x_pl,) + (w_pl,) * n,
                     in_grad_placements=(x_pl,) + (w_grad,) * n,
                     device_mesh=mesh, redistribute_inputs=True)(
        xe, *weights)


def combine_experts(fn, ye, combine):
    """``fn(ye, combine)`` -> (G, S, D) per (group, expert, slot) shard:
    ye (G, E, C, D) as it is laid out, combine (G, S, E, C) split alike;
    the output is a partial sum over the expert and slot shards."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = ye.device_mesh
    g_dims, e_dims = _shard_dims(ye, 0), _shard_dims(ye, 1)
    c_dims = _shard_dims(ye, 2)
    y_pl = tuple(Shard(0) if i in g_dims else Shard(1) if i in e_dims
                 else Shard(2) if i in c_dims else Replicate()
                 for i in range(mesh.ndim))
    c_pl = tuple(Shard(0) if i in g_dims else Shard(2) if i in e_dims
                 else Shard(3) if i in c_dims else Replicate()
                 for i in range(mesh.ndim))
    out = tuple(Shard(0) if i in g_dims else Partial()
                if i in e_dims or i in c_dims else Replicate()
                for i in range(mesh.ndim))
    return local_map(fn, out_placements=list(out),
                     in_placements=(y_pl, c_pl), device_mesh=mesh,
                     redistribute_inputs=True)(ye, combine)


def _prod(mesh, dims):
    n = 1
    for i in dims:
        n *= mesh.size(i)
    return n


# ------------------------------------------------------------- attention

def flash_sharded(attend, parts, q, k, v, causal, q_offset):
    """``attend(q, k, v, causal, q_offset)`` (local tensors, model
    layout; ``parts`` the same returning (o, m, l) in float32) per shard
    of DTensors q (B, T, H, Dh) and k, v (B, S, Hkv, Dh).

    Batch shards stay; query heads stay sharded where the kv heads split
    alike, and where they do not each rank takes the kv heads its query
    heads read; query rows sharded over a mesh dim (sequence-parallel
    prefill) shift ``q_offset`` per rank; a key sequence sharded over a
    mesh dim (a decode cache) is attended per key range and merged
    (``_merge_ranges``, no gradient).  Anything else is gathered."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = q.device_mesh
    for t in (k, v):
        if not is_dtensor(t):
            raise ValueError("q is a DTensor and k or v is not")
    h, hkv = q.shape[2], k.shape[2]
    # the batch split of either side (the cache's, at decode): the other
    # side takes it by a local slice where it is replicated
    batch = sorted(set(_shard_dims(q, 0)) | set(_shard_dims(k, 0)))
    seq_kv = _shard_dims(k, 1)
    rows = [i for i in _shard_dims(q, 1) if i not in seq_kv]
    heads = [i for i in _shard_dims(q, 2) if i not in batch + rows]
    n_heads = _prod(mesh, heads)
    kv_split = bool(heads) and hkv % n_heads == 0
    per_rank, rep = h // max(n_heads, 1), h // hkv
    if heads and not kv_split and not (per_rank % rep == 0
                                       or rep % per_rank == 0):
        heads = []                      # no contiguous kv slice: gather
    if seq_kv:
        return _merge_ranges(parts, q, k, v, causal, q_offset, batch,
                             seq_kv)
    q_pl = tuple(Shard(0) if i in batch else Shard(1) if i in rows
                 else Shard(2) if i in heads else Replicate()
                 for i in range(mesh.ndim))
    kv_pl = tuple(Shard(0) if i in batch else Shard(2) if i in heads
                  and kv_split else Replicate() for i in range(mesh.ndim))
    kv_grad = tuple(Partial() if pl == Replicate() and (i in rows
                                                        or i in heads)
                    else pl for i, pl in enumerate(kv_pl))
    t_local = q.shape[1] // max(1, _prod(mesh, rows))
    offset = q_offset + _linear_coord(mesh, rows) * t_local
    h_idx = _linear_coord(mesh, heads)

    def local(ql, kl, vl):
        if heads and not kv_split:      # the kv heads of this rank's rows
            first = h_idx * per_rank // rep
            n = max(1, per_rank // rep)
            kl, vl = kl[:, :, first:first + n], vl[:, :, first:first + n]
        return attend(ql, kl, vl, causal, offset)

    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _merge_ranges(attend_parts, q, k, v, causal, q_offset, batch, seq_kv):
    """Attention over a key sequence sharded on mesh dims ``seq_kv``: each
    rank's (o, m, l) over its key range, gathered over those dims and
    merged by the split-K merge kernel (``flash_merge``).  A rank whose
    keys all lie past the last scored position gives no weight."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels.flash_ops import flash_merge
    mesh = q.device_mesh
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        raise NotImplementedError("attention over a sequence-sharded cache "
                                  "is decode-only (no gradient)")
    q_pl = tuple(Shard(0) if i in batch else Replicate()
                 for i in range(mesh.ndim))
    kv_pl = tuple(Shard(0) if i in batch else Shard(1) if i in seq_kv
                  else Replicate() for i in range(mesh.ndim))
    ql = q.redistribute(mesh, q_pl).to_local()
    kl = k.redistribute(mesh, kv_pl).to_local()
    vl = v.redistribute(mesh, kv_pl).to_local()
    start = _linear_coord(mesh, seq_kv) * kl.shape[1]
    off = q_offset - start
    if causal and off + ql.shape[1] - 1 < 0:    # no key of this range
        o = torch.zeros(ql.shape, dtype=torch.float32, device=ql.device)
        m = torch.full(ql.shape[:-1], NEG_INF, dtype=torch.float32,
                       device=ql.device)
        l = torch.zeros_like(m)
    else:
        o, m, l = attend_parts(ql, kl, vl, causal, off)
    # partials stacked on a new leading dim, one entry per key range
    part_pl = tuple(Shard(0) if i in seq_kv else Shard(1) if i in batch
                    else Replicate() for i in range(mesh.ndim))
    gathered = []
    for t in (o * l[..., None], m, l):
        d = DTensor.from_local(t[None], mesh, part_pl, run_check=False)
        gathered.append(d.redistribute(mesh, tuple(
            Replicate() if i in seq_kv else pl
            for i, pl in enumerate(part_pl))).to_local())
    o_all, m_all, l_all = gathered
    out, _, _ = flash_merge(o_all.reshape(o_all.shape[0], -1,
                                          o_all.shape[-1]).contiguous(),
                            m_all.reshape(m_all.shape[0], -1).contiguous(),
                            l_all.reshape(l_all.shape[0], -1).contiguous())
    out = out.reshape(o_all.shape[1:])
    return DTensor.from_local(out.to(q.dtype), mesh, q_pl, run_check=False)


# ------------------------------------------------------------------ cache

def write_cache(cache, new, pos: int):
    """``cache[:, pos] = new[:, 0]`` in place, for a cache (B, S, ...)
    that may be a DTensor sharded along S: the rank whose key range holds
    ``pos`` writes it."""
    if not is_dtensor(cache):
        cache[:, pos:pos + 1] = new
        return
    from torch.distributed.tensor import Replicate
    mesh = cache.device_mesh
    seq = _shard_dims(cache, 1)
    want = tuple(Replicate() if pl.is_shard(1) else pl
                 for pl in cache.placements)
    local_new = new.redistribute(mesh, want).to_local() if is_dtensor(
        new) else new
    local = cache.to_local()
    start = _linear_coord(mesh, seq) * local.shape[1]
    if start <= pos < start + local.shape[1]:
        local[:, pos - start:pos - start + 1] = local_new.to(local.dtype)

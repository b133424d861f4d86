"""The paper's own workload on a mesh, per shard: one ShuffleSoftSort
round (the dry-run's paper cell, ``repro_torch.launch.dryrun.
run_paper_cell``) and one SoftSort grad step (hillclimb's ``paper_sort``
variants, ``repro_torch.bench.hillclimb.run_paper_variants``).

Each function runs on this rank's rows of x and issues its collectives
itself, through torch's functional collectives
(``torch.distributed._functional_collectives``) on the group it is given,
so that the dry-run's ``CostMode`` records each one as it runs.  No
DTensor is used: the compute is replicated by design, as the reference's
compiled programs replicate it.

``paper_round`` — one outer round (``_outer_round`` of
``repro_torch.core.shufflesoftsort``, the plain chunked apply), with x
(N/R, d) and the int32 order (N/R,) row-sharded and the key (2,), tau_r
and norm replicated.  Step for step it is what the reference's
partitioner emits for ``jax.jit(_outer_round)`` with x and the order
sharded on the mesh's first axis (its HLO at N = 4096 on a (4, 2) mesh):

====  ==========================================  =====================
step  here                                        reference's HLO
====  ==========================================  =====================
1     all-gather the order                        ``all-gather s32[N]``
2     this rank's rows of ``x[order]``, zeros     ``all-reduce
      elsewhere, summed over the group            f32[N, d]``
3     the shuffle (``threefry.permutation``, one  replicated
      ``repro_torch::threefry_round`` op), the
      inner Adam steps and ``argsort(w)``:
      ``_outer_round`` on the full rows
4     ``order[g]``: this rank's entries of the    ``all-reduce s32[N]``
      gathered ``order[g]``, zeros elsewhere,
      summed; then this rank's slice
====  ==========================================  =====================

The all-reduces add exact zeros, so the round is bitwise the unsharded
``_outer_round`` on any number of ranks (for x without -0.0 entries,
which a sum with +0.0 turns into +0.0).  On the wire, per device, by the
reference's model (``collective_stats``; g the group): ``4 N (g-1)/g``,
``2 * 4 N d (g-1)/g`` and ``2 * 4 N (g-1)/g`` bytes.  At N = 2^20, d = 59
on the (16, 16) mesh (g = 16 on "data"):

    all-gather of the order      3 932 160
    all-reduce of x            463 994 880
    all-reduce of the commit     7 864 320
    total                      475 791 360

and on the (2, 16, 16) mesh, whose first axis is "pod" (g = 2):
2 097 152 + 247 463 936 + 4 194 304 = 253 755 392.

``sort_grad_step`` — the loss and its w gradient of one SoftSort step
(``softsort_apply_chunked`` + ``grid_sorting_loss``), w (N,) replicated
and x row-sharded, as a loop over row chunks on this rank's rows:

* per chunk, ``p[:, own rows] @ x_own`` (the payload cast to float32
  first: torch has no mixed-dtype product, and ``jnp`` promotes
  ``f32 @ bf16`` to float32), the partial y chunk all-reduced over the
  group (its backward passes the cotangent through: every rank holds the
  whole loss);
* x all-gathered once, in the payload's dtype, for the loss's std term
  (so the bf16 variants' std term reads the bf16 payload, where the
  reference's reads float32 x: within the bf16 envelope);
* the column sums, replicated, carry their gradient on the group's rank
  0 only, so that the w gradient's partial sums (each rank's products,
  rank 0's column-sum term) add up to the whole; they are all-reduced
  once.

Its collectives, each as many times as it runs (nb = N / chunk):

=============================  ==========================  ===============
collective                     here                        reference (XLA)
=============================  ==========================  ===============
x all-gather                   1 x ``N x d`` (payload      3 x ``f32[N,
                               dtype)                      59]`` (axis 0);
                                                           2 (all axes)
partial y chunk all-reduce     nb x ``f32[chunk, d]``      once in the map
                                                           body, all axes
                                                           (XLA counts a
                                                           body once)
w gradient all-reduce          1 x ``f32[N]``              none
x column statistics            none (std from the          ``f32[59]``
                               gathered x)
=============================  ==========================  ===============

They differ because the reference's are its partitioner's heuristics for
a program written unsharded; this is a design: the product, the step's
FLOPs, is split over the group (``4 N^2 d / g`` per device), where the
axis-0 variant's compiled program gathers x and multiplies all of it on
every device.
"""
from __future__ import annotations

import functools

import torch

_F32 = torch.float32


def _funcol():
    import torch.distributed._functional_collectives as funcol
    return funcol


def _first_row(group, rows: int) -> int:
    """The first row of this rank's block of ``rows`` rows."""
    import torch.distributed as dist
    return dist.get_rank(group) * rows


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The group's row blocks of ``t``, concatenated in rank order."""
    funcol = _funcol()
    # all_gather_single is all_gather_tensor's newer name (torch >= 2.13)
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    return funcol.wait_tensor(gather(t, 0, group))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    funcol = _funcol()
    return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))


def _own_rows(src: torch.Tensor, idx: torch.Tensor, lo: int):
    """``src[idx - lo]`` where ``idx`` falls in this rank's rows [lo, lo +
    len(src)), 0 elsewhere: (len(idx), *src.shape[1:])."""
    own = (idx >= lo) & (idx < lo + src.shape[0])
    got = src[torch.where(own, idx - lo, torch.zeros_like(idx))]
    mask = own.reshape(-1, *([1] * (src.dim() - 1)))
    return torch.where(mask, got, torch.zeros_like(got))


def paper_round(x, order, key, tau_r, norm, *, hw, cfg, group):
    """One ShuffleSoftSort round on this rank's shard (see the module
    docstring): x (N/R, d) float32 and order (N/R,) int32 rows of this
    rank, key (2,) int64 words, tau_r and norm float32 scalars (tensors),
    replicated.  The apply is the plain chunked one at ``cfg.chunk``; the
    shuffle is ``permutation(key, N)`` in jax 0.9.0's default
    (partitionable) counter layout.  Returns (this rank's shard of the
    new order, int32; the loss, a scalar)."""
    from repro_torch.core import threefry
    from repro_torch.core.shufflesoftsort import (_adam_bias, _inner_ramp,
                                                  _outer_round)
    from repro_torch.core.softsort import softsort_apply_chunked
    lo = _first_row(group, order.shape[0])
    # 1. all-gather s32[N]
    full = all_gather_rows(order, group).to(torch.int64)
    n = full.shape[0]
    # 2. all-reduce f32[N, d]: x[order], each rank's rows and zeros
    x_cur = all_reduce_sum(_own_rows(x, full, lo), group)
    # 3. the round itself, replicated: on x[order] in the identity order,
    #    _outer_round's commit gather(order, g) is g itself
    shuf = threefry.permutation(key, n)
    ramp = torch.as_tensor(_inner_ramp(cfg), device=x.device)
    tau_inner = (tau_r.to(_F32) * ramp)[None]
    bias1, bias2 = _adam_bias(cfg, x.device)
    ident = torch.arange(n, dtype=torch.int64, device=x.device)
    g, loss, _ = _outer_round(x_cur[None], ident[None], shuf[None],
                              tau_inner, norm.reshape(1).to(_F32), bias1,
                              bias2, hw=tuple(hw), cfg=cfg,
                              apply_fn=functools.partial(
                                  softsort_apply_chunked, chunk=cfg.chunk))
    # 4. all-reduce s32[N]: order[g], each rank's entries and zeros
    new = all_reduce_sum(_own_rows(order, g[0], lo), group)
    return new[lo:lo + order.shape[0]], loss[0]


class _SumOverGroup(torch.autograd.Function):
    """The all-reduced sum of each rank's partial; its backward hands the
    cotangent to this rank's partial as it is (each rank holds the whole
    loss, so the partials' gradients are the cotangent itself)."""

    @staticmethod
    def forward(ctx, part, group):
        return all_reduce_sum(part, group)

    @staticmethod
    def backward(ctx, dy):
        return dy, None


def sort_grad_step(w, x, tau, norm, *, hw, chunk: int, group,
                   payload_dtype=_F32):
    """The loss and w gradient of one SoftSort step on this rank's rows x
    (N/R, d) float32, w (N,) replicated (see the module docstring).
    ``payload_dtype`` is the dtype x is stored and gathered in (bfloat16
    for the reference's ``_bf16x`` variants).  Returns (loss, gradient
    (N,)), both replicated."""
    import torch.distributed as dist

    from repro_torch.core.losses import grid_sorting_loss
    from repro_torch.core.softsort import _sort_diff
    rows = x.shape[0]
    lo = _first_row(group, rows)
    root = 1.0 if dist.get_rank(group) == 0 else 0.0
    payload = x.to(payload_dtype)
    x_all = all_gather_rows(payload, group).to(_F32)
    xp = payload.to(_F32)
    n = w.shape[0]
    w = w.detach().to(_F32).requires_grad_(True)
    with torch.enable_grad():
        ws = _sort_diff(w)
        nb = -(-n // chunk)
        pad = nb * chunk - n
        if pad:
            ws = torch.cat([ws, ws[-1:].detach().expand(pad)])
        valid = (torch.arange(nb * chunk, device=w.device) < n).to(_F32)
        ys, colsum = [], torch.zeros_like(w)
        for b0 in range(0, nb * chunk, chunk):
            s = -torch.abs(ws[b0:b0 + chunk, None] - w[None, :]) / tau
            p = torch.softmax(s, dim=-1) * valid[b0:b0 + chunk, None]
            ys.append(_SumOverGroup.apply(p[:, lo:lo + rows] @ xp, group))
            colsum = colsum + p.sum(dim=-2)
        y = torch.cat(ys)[:n]
        # the column sums' gradient on rank 0 only; the value unchanged
        colsum = colsum.detach() + (colsum - colsum.detach()) * root
        loss = grid_sorting_loss(y, colsum, x_all, tuple(hw), norm)
        (grad,) = torch.autograd.grad(loss, w)
    return loss.detach(), all_reduce_sum(grad, group)


def paper_sort_collectives(n: int, d: int, chunk: int, g: int,
                           payload_bytes: int = 4) -> dict:
    """``sort_grad_step``'s wire bytes per device by hand, the reference's
    model: {"all-gather": .., "all-reduce": .., "total_bytes": ..}."""
    f = (g - 1) / g
    nb = -(-n // chunk)
    gather = n * d * payload_bytes * f
    reduce = nb * 2.0 * chunk * d * 4 * f + 2.0 * n * 4 * f
    return {"all-gather": gather, "all-reduce": reduce,
            "total_bytes": gather + reduce}


def paper_cell_collectives(n: int, d: int, g: int) -> dict:
    """``paper_round``'s wire bytes per device by hand (see the module
    docstring)."""
    f = (g - 1) / g
    out = {"all-gather": 4 * n * f,
           "all-reduce": 2.0 * 4 * n * d * f + 2.0 * 4 * n * f}
    out["total_bytes"] = out["all-gather"] + out["all-reduce"]
    return out


def round_flops(n: int, d: int, inner_steps: int, chunk: int) -> float:
    """The products of ``paper_round``'s inner steps, every chunk counted:
    per step the forward ``p @ x`` of each (chunk, N) block and its
    backward ``dy @ x^T``, ``2 * rows * N * d`` each over the padded
    rows; x carries no gradient.  Independent of the chunk when it
    divides N."""
    rows = -(-n // chunk) * chunk
    return float(inner_steps * 2 * (2 * rows * n * d))

"""SoftSort — continuous relaxation of argsort, in PyTorch.

    SoftSort_tau(w) = softmax_rows( -|sort(w)_i - w_j| / tau )          (eq. 1)

Counterpart of ``repro.core.softsort`` (dense part):

* ``softsort_matrix``         — the full (N, N) matrix; reference path.
* ``softsort_apply_chunked``  — row-block streaming ``(P @ x, colsum(P))``
                                for any N (the tail block is padded and
                                masked), batched ``(B, N)`` keys and
                                ``descending``.  The everywhere-runnable
                                twin of the kernel tier in
                                ``repro_torch.kernels.ops``.
* ``hard_permutation`` / ``is_valid_permutation`` / ``fix_permutation``.

Every order-deciding sort is ``torch.argsort(..., stable=True)``, which is
what ``jnp.argsort`` does.
"""
from __future__ import annotations

import numpy as np
import torch


def _sort_diff(w: torch.Tensor) -> torch.Tensor:
    """sort(w) along the last axis as a gather by a stable argsort, so the
    gradient flows to the keys through the gather."""
    perm = torch.argsort(w.detach(), dim=-1, stable=True)
    return torch.gather(w, -1, perm)


def softsort_matrix(w: torch.Tensor, tau, descending: bool = False
                    ) -> torch.Tensor:
    """Full (N, N) SoftSort matrix ((..., N, N) for leading batch axes).
    Row i ~ one-hot of the rank-i element."""
    ws = _sort_diff(w)
    if descending:
        ws = torch.flip(ws, dims=(-1,))
    d = torch.abs(ws.unsqueeze(-1) - w.unsqueeze(-2))
    return torch.softmax(-d / tau, dim=-1)


def softsort_apply_chunked(
    w: torch.Tensor,
    x: torch.Tensor,
    tau,
    chunk: int = 256,
    descending: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Streaming ``(P_soft @ x, column_sums(P_soft))`` without an (N, N)
    array.

    Args:
      w: (N,) sort keys, or (B, N) for B instances sharing one ``tau``.
      x: (N, d) payload ((B, N, d) batched).
      tau: temperature (float or 0-d tensor).
      chunk: rows of P per block; the tail block is padded with the last
        sorted key and masked out of the colsum.
      descending: row i targets rank N-1-i — a flip of y; colsum is
        row-order invariant.

    Returns:
      y (N, d) and colsum (N,) (batched shapes for (B, N) keys).
    """
    if descending:
        y, colsum = softsort_apply_chunked(w, x, tau, chunk)
        return torch.flip(y, dims=(-2,)), colsum
    if w.dim() == 1:
        y, colsum = softsort_apply_chunked(w[None], x[None], tau, chunk)
        return y[0], colsum[0]
    assert x.dim() == 3 and x.shape[:2] == w.shape, (w.shape, x.shape)
    n = w.shape[-1]
    if n <= chunk:
        p = softsort_matrix(w, tau)
        return p @ x, p.sum(dim=-2)

    ws = _sort_diff(w)
    nb = -(-n // chunk)
    pad = nb * chunk - n
    if pad:
        ws = torch.cat([ws, ws[:, -1:].detach().expand(-1, pad)], dim=-1)
    valid = (torch.arange(nb * chunk, device=w.device) < n).to(w.dtype)
    ys, colsum = [], torch.zeros_like(w)
    for b0 in range(0, nb * chunk, chunk):
        ws_blk = ws[:, b0:b0 + chunk]                       # (B, chunk)
        s = -torch.abs(ws_blk.unsqueeze(-1) - w.unsqueeze(-2)) / tau
        p = torch.softmax(s, dim=-1) * valid[b0:b0 + chunk, None]
        ys.append(p @ x)
        colsum = colsum + p.sum(dim=-2)
    return torch.cat(ys, dim=-2)[:, :n], colsum


def hard_permutation(w: torch.Tensor) -> torch.Tensor:
    """argmax over the rows of P_soft == stable argsort(w)."""
    return torch.argsort(w, dim=-1, stable=True)


def is_valid_permutation(idx) -> bool:
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor) else idx)
    return bool(np.all(np.sort(idx) == np.arange(idx.shape[0])))


def fix_permutation(idx) -> np.ndarray:
    """Greedy repair of an index vector with duplicates: each duplicate
    row takes the nearest missing value (both sorted — monotone matching
    is optimal for L1 on a line)."""
    idx = np.asarray(idx.cpu() if isinstance(idx, torch.Tensor)
                     else idx).copy()
    n = idx.shape[0]
    seen = np.zeros(n, dtype=bool)
    dup_rows = []
    for i in range(n):
        j = idx[i]
        if seen[j]:
            dup_rows.append(i)
        else:
            seen[j] = True
    missing = np.flatnonzero(~seen)
    dup_rows_sorted = sorted(dup_rows, key=lambda r: idx[r])
    for r, m in zip(dup_rows_sorted, missing):
        idx[r] = m
    return idx

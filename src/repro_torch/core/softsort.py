"""SoftSort — continuous relaxation of argsort, in PyTorch.

    SoftSort_tau(w) = softmax_rows( -|sort(w)_i - w_j| / tau )          (eq. 1)

Counterpart of ``repro.core.softsort``:

* ``softsort_matrix``         — the full (N, N) matrix; reference path.
* ``softsort_apply_chunked``  — row-block streaming ``(P @ x, colsum(P))``
                                for any N (the tail block is padded and
                                masked), batched ``(B, N)`` keys and
                                ``descending``.  The everywhere-runnable
                                twin of the kernel tier in
                                ``repro_torch.kernels.ops``.
* ``softsort_apply_banded``   — the O(N * K) windowed apply in rank space,
                                the oracle of the banded kernel tier.
* ``band_tail_bound``         — the mass the band drops, bounded.
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


def softsort_apply_banded(
    w: torch.Tensor,
    x: torch.Tensor,
    tau,
    band: int,
    descending: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Windowed ``(P_soft @ x, column_sums(P_soft))`` in O(N * K * d).

    Keys and payload are gathered into sorted-key order (the gather keeps
    the gradient, as in ``_sort_diff``); row i then softmaxes only over the
    keys whose rank is within ``band`` of i, a width-(2K+1) diagonal band
    of the soft permutation matrix in rank space.  Out-of-band entries are
    exactly zero; ``band_tail_bound`` bounds the mass they would carry.
    The everywhere-runnable oracle of the banded kernel tier
    (``repro_torch.kernels.ops.softsort_apply_banded``).

    Args:
      w: (N,) sort keys, or (B, N) for B instances sharing one ``tau``.
      x: (N, d) payload ((B, N, d) batched).
      tau: temperature (float or one-element tensor).
      band: K, the band half-width in rank space; ``band >= N - 1`` gives
        the dense result.
      descending: a flip of y; colsum is row-order invariant.

    Returns:
      y (N, d) and colsum (N,), in the dense paths' row and column order
      (batched shapes for (B, N) keys).
    """
    if descending:
        y, colsum = softsort_apply_banded(w, x, tau, band)
        return torch.flip(y, dims=(-2,)), colsum
    if w.dim() == 1:
        y, colsum = softsort_apply_banded(w[None], x[None], tau, band)
        return y[0], colsum[0]
    assert x.dim() == 3 and x.shape[:2] == w.shape, (w.shape, x.shape)
    bsz, n = w.shape
    d = x.shape[-1]
    k = int(band)
    assert k >= 1, band
    perm = torch.argsort(w.detach(), dim=-1, stable=True)
    ws = torch.gather(w, -1, perm)                     # grad-carrying
    xs = torch.gather(x, 1, perm[..., None].expand(-1, -1, d))
    # (N, 2K+1) rank window around each row; clipped indices keep the
    # gathers in bounds and the mask zeroes the clipped slots.
    idx = (torch.arange(n, device=w.device)[:, None]
           + torch.arange(-k, k + 1, device=w.device)[None, :])
    valid = (idx >= 0) & (idx < n)
    idxc = idx.clamp(0, n - 1)
    s = -torch.abs(ws[:, :, None] - ws[:, idxc]) / tau
    # Finite mask value: exp(-1e30 - m) is exactly 0 in float32.
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)                       # (B, N, 2K+1)
    y = torch.einsum("bnk,bnkd->bnd", p, xs[:, idxc])
    # Column sums in rank order, then back to the columns' own order.
    colsum_sorted = torch.zeros_like(ws).scatter_add(
        -1, idxc.reshape(1, -1).expand(bsz, -1), p.reshape(bsz, -1))
    colsum = torch.zeros_like(ws).scatter(-1, perm, colsum_sorted)
    return y, colsum


def band_tail_bound(w: torch.Tensor, tau, band: int) -> torch.Tensor:
    """Upper bound on the per-row probability mass a banded apply drops:
    ``(N - K) * exp(-g_K / tau)``, with ``g_K`` the smallest spread of the
    sorted keys across K ranks.

    Row i's own key scores 0, so its softmax denominator is >= 1, and each
    of the <= N - K keys more than K ranks away lies at least ``g_K``
    from it.  ``tau`` is a scalar, or (B,) for (B, N) keys (one
    temperature per instance).  Returns a scalar ((B,) batched), exactly 0
    when the band covers every pair (``band >= N - 1``).
    """
    n = w.shape[-1]
    k = int(band)
    assert k >= 1, band
    if k >= n - 1:
        return torch.zeros(w.shape[:-1], dtype=torch.float32, device=w.device)
    if not isinstance(tau, (int, float)):
        tau = torch.as_tensor(tau, dtype=torch.float32, device=w.device)
    ws = torch.sort(w, dim=-1).values
    g = torch.amin(ws[..., k:] - ws[..., :n - k], dim=-1)
    return (n - k) * torch.exp(-g / tau)


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

"""Dense O(N^2) oracle for the SoftSort apply — reference semantics only.

Counterpart of ``repro.kernels.ref``: materializes the full soft
permutation matrix, so every kernel test can hold the tiled kernels and
their plain twins against it.
"""
from __future__ import annotations

import torch


def softsort_apply_ref(w: torch.Tensor, x: torch.Tensor, tau
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(P_soft @ x, column_sums(P_soft)), P = softmax(-|sort(w)_i - w_j|/tau).

    w: (N,) or (B, N) keys; x: (N, d) or (B, N, d) payload.
    Returns y (N, d) and colsum (N,) (batched shapes for batched input).
    """
    perm = torch.argsort(w.detach(), dim=-1, stable=True)
    ws = torch.gather(w, -1, perm)
    s = -torch.abs(ws.unsqueeze(-1) - w.unsqueeze(-2)) / tau
    p = torch.softmax(s, dim=-1)
    return p @ x, p.sum(dim=-2)

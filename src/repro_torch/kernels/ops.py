"""Public wrappers of the SoftSort-apply kernel tiers, dense and banded.

``softsort_apply(w, x, tau)`` returns ``(P_soft @ x, column_sums(P_soft))``
with P never materialized.  A ``torch.autograd.Function`` runs both
directions through the four dense kernels of
``repro_torch.kernels.softsort_apply`` (counterpart of the ``custom_vjp``
in ``repro.kernels.ops``):

* forward — sort the keys (``torch.argsort``, stable), launch ``fwd_fused``
  and ``colsum``, save ``(perm, m, l, y)``;
* backward — re-gather the sorted keys through the saved ``perm`` (no
  re-sort), launch ``bwd_dws_delta`` and ``bwd_dx``, scatter ``dws``
  through ``perm`` (a permutation: no collisions, deterministic), and
  return ``dw``, ``dx`` and ``dtau = sum(dtau_cols)``.

``softsort_apply_banded(w, x, tau, band)`` is the O(N K) tier, a second
Function over the four banded kernels: keys and payload are gathered into
rank order, only pairs within ``band`` ranks are scored, the colsum comes
back in rank order and is scattered through ``perm``; the backward sums
the row and column parts of the key gradient in rank order and scatters
them, and the payload gradient, through the saved ``perm``.

``descending`` is a flip of y outside the Function.  ``compute_dtype``
("float32" or "bfloat16") is the payload and score precision of the
kernels; keys, stats, accumulators and every returned gradient stay
float32.  CPU tensors run the kernels' plain twins; CUDA tensors launch
the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.softsort_apply import (
    bwd_band_dcol,
    bwd_band_dws_delta,
    bwd_dws_delta,
    bwd_dx,
    colsum,
    colsum_band,
    fwd_band,
    fwd_fused,
)

_F32 = torch.float32


def _cd(compute_dtype) -> torch.dtype:
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        str(compute_dtype).replace("torch.", ""))
    if cd is None:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return cd


def _tau_tensor(tau, device) -> torch.Tensor:
    """tau as a one-element float32 tensor on ``device`` (a device tensor
    stays on the device: the kernels read it through its pointer)."""
    if isinstance(tau, torch.Tensor):
        return tau.to(device=device, dtype=_F32).reshape(1)
    return torch.full((1,), float(tau), dtype=_F32, device=device)


class _SoftSortApply(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, x, tau, cd):
        w32 = w.detach().to(_F32).contiguous()
        perm = torch.argsort(w32, dim=-1, stable=True)
        ws = torch.gather(w32, -1, perm)
        xc = x.detach().to(cd).contiguous()
        y, m, l = fwd_fused(ws, w32, xc, tau)
        c = colsum(ws, w32, tau, m, l, cd)
        ctx.save_for_backward(w32, xc, tau, perm, m, l, y)
        ctx.dtypes = (w.dtype, x.dtype)
        return y.to(_F32), c

    @staticmethod
    def backward(ctx, dy, dc):
        w32, xc, tau, perm, m, l, y = ctx.saved_tensors
        cd = xc.dtype
        ws = torch.gather(w32, -1, perm)
        dy_c = dy.to(_F32).to(cd).contiguous()
        dc_c = dc.to(_F32).to(cd).contiguous()
        D, dws = bwd_dws_delta(ws, w32, xc, tau, m, l, dy_c, y, dc_c)
        dx, dw_cols, dtau_cols = bwd_dx(ws, w32, xc, tau, m, l, dy_c, dc_c, D)
        dw = dw_cols + torch.zeros_like(dws).scatter_(-1, perm, dws)
        dtau = dtau_cols.sum().reshape(1) if ctx.needs_input_grad[2] else None
        return dw.to(ctx.dtypes[0]), dx.to(ctx.dtypes[1]), dtau, None


def softsort_apply(w, x, tau, descending: bool = False,
                   compute_dtype: str = "float32"):
    """Kernel-tier ``(P_soft @ x, colsum(P_soft))``.

    w: (N,) or (B, N) keys; x: (N, d) or (B, N, d) payload; tau a float or
    a tensor with one element, shared by the batch.
    Returns y (float32, x's batch shape) and colsum (w's shape).
    """
    batched = w.dim() == 2
    wb = w if batched else w[None]
    xb = x if batched else x[None]
    if xb.dim() != 3 or xb.shape[:2] != wb.shape:
        raise ValueError(f"shapes w {tuple(w.shape)} and x {tuple(x.shape)} "
                         "do not match")
    y, c = _SoftSortApply.apply(wb, xb, _tau_tensor(tau, w.device),
                                _cd(compute_dtype))
    if not batched:
        y, c = y[0], c[0]
    if descending:
        y = torch.flip(y, dims=(-2,))
    return y, c


class _SoftSortApplyBanded(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, x, tau, band, cd):
        w32 = w.detach().to(_F32).contiguous()
        xc = x.detach().to(cd).contiguous()
        perm = torch.argsort(w32, dim=-1, stable=True)
        ws, xs = _rank_order(w32, xc, perm)
        y, m, l = fwd_band(ws, xs, tau, band)
        c_sorted = colsum_band(ws, tau, m, l, band, cd)
        c = torch.empty_like(c_sorted).scatter_(-1, perm, c_sorted)
        ctx.save_for_backward(w32, xc, tau, perm, m, l, y)
        ctx.band = band
        ctx.dtypes = (w.dtype, x.dtype)
        return y.to(_F32), c

    @staticmethod
    def backward(ctx, dy, dc):
        w32, xc, tau, perm, m, l, y = ctx.saved_tensors
        cd, band = xc.dtype, ctx.band
        ws, xs = _rank_order(w32, xc, perm)       # the saved perm: no sort
        dy_c = dy.to(_F32).to(cd).contiguous()
        dc_s = torch.gather(dc.to(_F32), -1, perm).to(cd).contiguous()
        D, dws_row = bwd_band_dws_delta(ws, xs, tau, m, l, dy_c, y, dc_s,
                                        band)
        dxs, dws_col, dtau_cols = bwd_band_dcol(ws, xs, tau, m, l, dy_c,
                                                dc_s, D, band)
        # Both axes are sorted keys: the key gradient has a row and a
        # column part, summed in rank order and scattered through perm.
        dw = torch.empty_like(dws_row).scatter_(-1, perm, dws_row + dws_col)
        idx = perm[..., None].expand(-1, -1, dxs.shape[-1])
        dx = torch.empty(dxs.shape, dtype=_F32, device=dxs.device).scatter_(
            1, idx, dxs.to(_F32))
        dtau = dtau_cols.sum().reshape(1) if ctx.needs_input_grad[2] else None
        return dw.to(ctx.dtypes[0]), dx.to(ctx.dtypes[1]), dtau, None, None


def _rank_order(w32, xc, perm):
    """Keys and payload gathered into sorted-key (rank) order."""
    ws = torch.gather(w32, -1, perm)
    xs = torch.gather(xc, 1, perm[..., None].expand(-1, -1, xc.shape[-1]))
    return ws, xs.contiguous()


def softsort_apply_banded(w, x, tau, band: int, descending: bool = False,
                          compute_dtype: str = "float32"):
    """Banded kernel-tier ``(P_soft @ x, colsum(P_soft))`` in O(N K).

    Same arguments and returns as ``softsort_apply``, plus ``band`` = K,
    the half-width in rank space: only pairs within K ranks are scored
    (``repro_torch.core.softsort_apply_banded`` is its oracle, and
    ``band_tail_bound`` bounds the mass left out).  ``band >= N - 1``
    covers every pair and runs the dense ``softsort_apply``.
    """
    n = w.shape[-1]
    band = int(band)
    if band < 1:
        raise ValueError(f"band must be >= 1, got {band}")
    if band >= n - 1:
        return softsort_apply(w, x, tau, descending=descending,
                              compute_dtype=compute_dtype)
    batched = w.dim() == 2
    wb = w if batched else w[None]
    xb = x if batched else x[None]
    if xb.dim() != 3 or xb.shape[:2] != wb.shape:
        raise ValueError(f"shapes w {tuple(w.shape)} and x {tuple(x.shape)} "
                         "do not match")
    y, c = _SoftSortApplyBanded.apply(wb, xb, _tau_tensor(tau, w.device),
                                      band, _cd(compute_dtype))
    if not batched:
        y, c = y[0], c[0]
    if descending:
        y = torch.flip(y, dims=(-2,))
    return y, c

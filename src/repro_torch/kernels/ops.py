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
  return ``dw``, ``dx`` and ``dtau``, summed from ``dtau_cols``.

``softsort_apply_banded(w, x, tau, band)`` is the O(N K) tier, a second
Function over the four banded kernels: keys and payload are gathered into
rank order, only pairs within ``band`` ranks are scored, the colsum comes
back in rank order and is scattered through ``perm``; the backward sums
the row and column parts of the key gradient in rank order and scatters
them, and the payload gradient, through the saved ``perm``.

``softsort_apply_v1(w, x, tau)`` keeps the v1 design, the baseline of
the kernel bench (``repro_torch.bench.kernel_bench``): a three-pass
float32 forward (``v1_stats``, ``v1_apply``, ``colsum``) that saves only
``(w, x, tau)``, and a plain-torch backward that re-sorts and re-forms
the dense softmax chunk by chunk, with ``(B, chunk, N)`` temporaries.

``tau`` is one temperature for the batch (a float or a one-element
tensor) or, for (B, N) keys, a (B,) tensor of one per instance; dtau
comes back in the shape tau was given: the total over the batch for one
temperature (summed as a whole), per instance for B of them.
``descending`` is a flip of y outside the Function.  ``compute_dtype``
("float32" or "bfloat16") is the payload and score precision of the
kernels; keys, stats, accumulators and every returned gradient stay
float32.  CPU tensors run the kernels' plain twins; CUDA tensors launch
the kernels.
"""
from __future__ import annotations

import torch

from repro_torch import spans
from repro_torch.kernels.softsort_apply import (
    _tau_rows,
    bwd_band_dcol,
    bwd_band_dws_delta,
    bwd_dws_delta,
    bwd_dx,
    colsum,
    colsum_band,
    fwd_band,
    fwd_fused,
    v1_apply,
    v1_stats,
)

_F32 = torch.float32


def _cd(compute_dtype) -> torch.dtype:
    cd = {"float32": torch.float32, "bfloat16": torch.bfloat16}.get(
        str(compute_dtype).replace("torch.", ""))
    if cd is None:
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{compute_dtype}")
    return cd


def _tau_tensor(tau, device, bsz: int) -> torch.Tensor:
    """tau as a float32 tensor on ``device``: (1,) for one temperature,
    (B,) for one per instance (a device tensor stays on the device: the
    kernels read it through its pointer)."""
    if not isinstance(tau, torch.Tensor):
        return torch.full((1,), float(tau), dtype=_F32, device=device)
    t = tau.to(device=device, dtype=_F32)
    if t.numel() not in (1, bsz):
        raise ValueError(f"tau must have 1 or B = {bsz} elements, got "
                         f"{tuple(tau.shape)}")
    return t.reshape(t.numel()).contiguous()


def _dtau(dtau_cols, shared: bool):
    """dtau in the shape tau was given: (1,), the total over the batch, for
    one shared temperature; (B,), per instance, for one per instance."""
    if shared:
        return dtau_cols.sum().reshape(1)
    return dtau_cols.sum(dim=1)


class _SoftSortApply(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, x, tau, cd, dt):
        w32 = w.detach().to(_F32).contiguous()
        perm = torch.argsort(w32, dim=-1, stable=True)
        ws = torch.gather(w32, -1, perm)
        xc = x.detach().to(cd).contiguous()
        taus = _tau_rows(tau.detach(), w32.shape[0])
        y, m, l = fwd_fused(ws, w32, xc, taus, dt)
        c = colsum(ws, w32, taus, m, l, cd)
        ctx.save_for_backward(w32, xc, taus, perm, m, l, y)
        ctx.shared_tau = tau.numel() == 1
        ctx.dt = dt
        ctx.dtypes = (w.dtype, x.dtype)
        return y.to(_F32), c

    @staticmethod
    def backward(ctx, dy, dc):
        # Autograd runs this on its own thread on the card: the span's
        # nesting comes from its device interval (``repro_torch.spans``).
        with spans.span("apply.bwd", dy.device):
            w32, xc, tau, perm, m, l, y = ctx.saved_tensors
            cd = xc.dtype
            ws = torch.gather(w32, -1, perm)
            dy_c = dy.to(_F32).to(cd).contiguous()
            dc_c = dc.to(_F32).to(cd).contiguous()
            D, dws = bwd_dws_delta(ws, w32, xc, tau, m, l, dy_c, y, dc_c,
                                   ctx.dt)
            dx, dw_cols, dtau_cols = bwd_dx(ws, w32, xc, tau, m, l, dy_c,
                                            dc_c, D, ctx.dt)
            dw = dw_cols + torch.zeros_like(dws).scatter_(-1, perm, dws)
            dtau = (_dtau(dtau_cols, ctx.shared_tau)
                    if ctx.needs_input_grad[2] else None)
            return (dw.to(ctx.dtypes[0]), dx.to(ctx.dtypes[1]), dtau, None,
                    None)


def softsort_apply(w, x, tau, descending: bool = False,
                   compute_dtype: str = "float32", payload_tile=None):
    """Kernel-tier ``(P_soft @ x, colsum(P_soft))``.

    w: (N,) or (B, N) keys; x: (N, d) or (B, N, d) payload; tau a float or
    a tensor with one element, shared by the batch, or a (B,) tensor, one
    per instance.  ``payload_tile`` (16, 32 or 64) fixes the kernels'
    payload tile on the card; None takes the autotune table's
    (``repro_torch.kernels.autotune.lookup_blocks``).
    Returns y (float32, x's batch shape) and colsum (w's shape).
    """
    batched = w.dim() == 2
    wb = w if batched else w[None]
    xb = x if batched else x[None]
    if xb.dim() != 3 or xb.shape[:2] != wb.shape:
        raise ValueError(f"shapes w {tuple(w.shape)} and x {tuple(x.shape)} "
                         "do not match")
    y, c = _SoftSortApply.apply(wb, xb, _tau_tensor(tau, w.device,
                                                    wb.shape[0]),
                                _cd(compute_dtype), payload_tile)
    if not batched:
        y, c = y[0], c[0]
    if descending:
        y = torch.flip(y, dims=(-2,))
    return y, c


class _SoftSortApplyBanded(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, x, tau, band, cd, dt):
        w32 = w.detach().to(_F32).contiguous()
        xc = x.detach().to(cd).contiguous()
        perm = torch.argsort(w32, dim=-1, stable=True)
        ws, xs = _rank_order(w32, xc, perm)
        taus = _tau_rows(tau.detach(), w32.shape[0])
        y, m, l = fwd_band(ws, xs, taus, band, dt)
        c_sorted = colsum_band(ws, taus, m, l, band, cd)
        c = torch.empty_like(c_sorted).scatter_(-1, perm, c_sorted)
        ctx.save_for_backward(w32, xc, taus, perm, m, l, y)
        ctx.shared_tau = tau.numel() == 1
        ctx.band = band
        ctx.dt = dt
        ctx.dtypes = (w.dtype, x.dtype)
        return y.to(_F32), c

    @staticmethod
    def backward(ctx, dy, dc):
        with spans.span("apply.bwd", dy.device):
            w32, xc, tau, perm, m, l, y = ctx.saved_tensors
            cd, band = xc.dtype, ctx.band
            ws, xs = _rank_order(w32, xc, perm)   # the saved perm: no sort
            dy_c = dy.to(_F32).to(cd).contiguous()
            dc_s = torch.gather(dc.to(_F32), -1, perm).to(cd).contiguous()
            D, dws_row = bwd_band_dws_delta(ws, xs, tau, m, l, dy_c, y, dc_s,
                                            band, ctx.dt)
            dxs, dws_col, dtau_cols = bwd_band_dcol(ws, xs, tau, m, l, dy_c,
                                                    dc_s, D, band, ctx.dt)
            # Both axes are sorted keys: the key gradient has a row and a
            # column part, summed in rank order and scattered through perm.
            dw = torch.empty_like(dws_row).scatter_(-1, perm,
                                                    dws_row + dws_col)
            idx = perm[..., None].expand(-1, -1, dxs.shape[-1])
            dx = torch.empty(dxs.shape, dtype=_F32,
                             device=dxs.device).scatter_(1, idx,
                                                         dxs.to(_F32))
            dtau = (_dtau(dtau_cols, ctx.shared_tau)
                    if ctx.needs_input_grad[2] else None)
            return (dw.to(ctx.dtypes[0]), dx.to(ctx.dtypes[1]), dtau, None,
                    None, None)


def _rank_order(w32, xc, perm):
    """Keys and payload gathered into sorted-key (rank) order."""
    ws = torch.gather(w32, -1, perm)
    xs = torch.gather(xc, 1, perm[..., None].expand(-1, -1, xc.shape[-1]))
    return ws, xs.contiguous()


def softsort_apply_banded(w, x, tau, band: int, descending: bool = False,
                          compute_dtype: str = "float32", payload_tile=None):
    """Banded kernel-tier ``(P_soft @ x, colsum(P_soft))`` in O(N K).

    Same arguments (``payload_tile`` too) and returns as
    ``softsort_apply``, plus ``band`` = K,
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
                              compute_dtype=compute_dtype,
                              payload_tile=payload_tile)
    batched = w.dim() == 2
    wb = w if batched else w[None]
    xb = x if batched else x[None]
    if xb.dim() != 3 or xb.shape[:2] != wb.shape:
        raise ValueError(f"shapes w {tuple(w.shape)} and x {tuple(x.shape)} "
                         "do not match")
    y, c = _SoftSortApplyBanded.apply(
        wb, xb, _tau_tensor(tau, w.device, wb.shape[0]), band,
        _cd(compute_dtype), payload_tile)
    if not batched:
        y, c = y[0], c[0]
    if descending:
        y = torch.flip(y, dims=(-2,))
    return y, c


class _SoftSortApplyV1(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w, x, tau, bwd_chunk):
        w32 = w.detach().to(_F32).contiguous()
        xf = x.detach().to(_F32).contiguous()
        perm = torch.argsort(w32, dim=-1, stable=True)
        ws = torch.gather(w32, -1, perm)
        taus = _tau_rows(tau.detach(), w32.shape[0])
        m, l = v1_stats(ws, w32, taus)
        y = v1_apply(ws, w32, xf, taus, m, l)
        c = colsum(ws, w32, taus, m, l)
        ctx.save_for_backward(w32, xf, tau)    # v1 keeps no residuals
        ctx.bwd_chunk = bwd_chunk
        ctx.dtypes = (w.dtype, x.dtype)
        return y, c

    @staticmethod
    def backward(ctx, dy, dc):
        """The reference's ``_bwd_rule_v1`` in plain torch: re-sort, then
        for each chunk of sorted rows the dense softmax and its
        ``(B, chunk, N)`` temporaries p, dP and ds."""
        w, x, tau = ctx.saved_tensors
        t = tau.reshape(())
        dy = dy.to(_F32)
        dcf = dc.to(_F32)
        perm = torch.argsort(w, dim=-1, stable=True)
        ws = torch.gather(w, -1, perm)
        dw_cols = torch.zeros_like(w)
        dws = torch.empty_like(w)
        dx = torch.zeros_like(x)
        dtau = torch.zeros((), dtype=_F32, device=w.device)
        for r in range(0, w.shape[-1], ctx.bwd_chunk):
            rows = slice(r, r + ctx.bwd_chunk)
            delta = ws[:, rows, None] - w[:, None, :]        # (B, chunk, N)
            s = -torch.abs(delta) / t
            p = torch.softmax(s, dim=-1)
            dp = dy[:, rows] @ x.transpose(1, 2) + dcf[:, None, :]
            ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
            sgn = torch.sign(delta)
            dws[:, rows] = (ds * (-sgn)).sum(dim=-1) / t
            dw_cols += (ds * sgn).sum(dim=1) / t
            dx += p.transpose(1, 2) @ dy[:, rows]
            dtau += (ds * (-s)).sum() / t
        dw = dw_cols.scatter_add(-1, perm, dws)
        dtau = dtau.reshape(1) if ctx.needs_input_grad[2] else None
        return dw.to(ctx.dtypes[0]), dx.to(ctx.dtypes[1]), dtau, None


def softsort_apply_v1(w, x, tau, bwd_chunk: int = 256):
    """The v1 kernel tier's ``(P_soft @ x, colsum(P_soft))``, float32: the
    benchmark baseline, not the engine's path.

    Same arguments and returns as ``softsort_apply`` (no ``descending``
    or ``compute_dtype``), with one tau for the batch; ``bwd_chunk`` is
    the rows of P the backward forms at a time.
    """
    if int(bwd_chunk) < 1:
        raise ValueError(f"bwd_chunk must be >= 1, got {bwd_chunk}")
    batched = w.dim() == 2
    wb = w if batched else w[None]
    xb = x if batched else x[None]
    if xb.dim() != 3 or xb.shape[:2] != wb.shape:
        raise ValueError(f"shapes w {tuple(w.shape)} and x {tuple(x.shape)} "
                         "do not match")
    y, c = _SoftSortApplyV1.apply(wb, xb, _tau_tensor(tau, w.device, 1),
                                  int(bwd_chunk))
    return (y, c) if batched else (y[0], c[0])

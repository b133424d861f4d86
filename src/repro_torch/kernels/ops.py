"""Public wrapper of the dense SoftSort-apply kernel tier.

``softsort_apply(w, x, tau)`` returns ``(P_soft @ x, column_sums(P_soft))``
with P never materialized.  A ``torch.autograd.Function`` runs both
directions through the four kernels of ``repro_torch.kernels.softsort_apply``
(counterpart of the ``custom_vjp`` in ``repro.kernels.ops``):

* forward — sort the keys (``torch.argsort``, stable), launch ``fwd_fused``
  and ``colsum``, save ``(perm, m, l, y)``;
* backward — re-gather the sorted keys through the saved ``perm`` (no
  re-sort), launch ``bwd_dws_delta`` and ``bwd_dx``, scatter ``dws``
  through ``perm`` (a permutation: no collisions, deterministic), and
  return ``dw``, ``dx`` and ``dtau = sum(dtau_cols)``.

``descending`` is a flip of y outside the Function.  ``compute_dtype``
("float32" or "bfloat16") is the payload and score precision of the
kernels; keys, stats, accumulators and every returned gradient stay
float32.  CPU tensors run the kernels' plain twins; CUDA tensors launch
the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.softsort_apply import (
    bwd_dws_delta,
    bwd_dx,
    colsum,
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
    a tensor with one element, shared by the batch (a device tensor stays
    on the device: the kernels read it through its pointer).
    Returns y (float32, x's batch shape) and colsum (w's shape).
    """
    batched = w.dim() == 2
    wb = w if batched else w[None]
    xb = x if batched else x[None]
    if xb.dim() != 3 or xb.shape[:2] != wb.shape:
        raise ValueError(f"shapes w {tuple(w.shape)} and x {tuple(x.shape)} "
                         "do not match")
    if isinstance(tau, torch.Tensor):
        tau_t = tau.to(device=w.device, dtype=_F32).reshape(1)
    else:
        tau_t = torch.full((1,), float(tau), dtype=_F32, device=w.device)
    y, c = _SoftSortApply.apply(wb, xb, tau_t, _cd(compute_dtype))
    if not batched:
        y, c = y[0], c[0]
    if descending:
        y = torch.flip(y, dims=(-2,))
    return y, c

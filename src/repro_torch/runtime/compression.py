"""Gradient compression for data-parallel sync: int8 quantization with
error feedback (EF-SGD / 1-bit-Adam style residual correction).  The
port's counterpart of ``repro.runtime.compression``.

Each leaf is quantized symmetrically to int8 after its residual (the
previous quantization error) is added back; the dequantized gradient
replaces the raw one in the optimizer step, and the new residual is kept
for the next step, which restores convergence to the uncompressed
trajectory.  The dequantized gradients are bitwise the reference's.  The
residual is ``gf - q * scale`` rounded once, as the fused multiply-add
XLA emits for it on the CPU for most leaves (formed in float64, where the
product is exact); the stats are float32 sums, whose order XLA picks.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.tree import flatten, tree_map, unflatten

PyTree = Any
_F32 = torch.float32


class CompressionState(NamedTuple):
    residual: PyTree           # error-feedback residuals, shaped as grads


def init_compression(params: PyTree) -> CompressionState:
    return CompressionState(residual=tree_map(
        lambda p: torch.zeros(p.shape, dtype=_F32, device=p.device), params))


def _quant_leaf(g, r):
    """int8 symmetric quantization with an error-feedback residual:
    (dequantized g in g's dtype, new residual, q, scale)."""
    gf = g.to(_F32) + r
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(_F32) * scale
    new_r = (gf.double() - q.double() * scale.double()).to(_F32)
    return deq.to(g.dtype), new_r, q, scale


def compress_gradients(grads: PyTree, state: CompressionState
                       ) -> tuple[PyTree, CompressionState, dict]:
    """(dequantized grads, new state, stats): the stats report the
    quantization error and the wire compression ratio."""
    flat_g, structure = flatten(grads)
    flat_r = flatten(state.residual)[0]
    deqs, news, errs, raws = [], [], [], []
    for g, r in zip(flat_g, flat_r):
        deq, new_r, _, _ = _quant_leaf(g, r)
        deqs.append(deq)
        news.append(new_r)
        errs.append(torch.sum(torch.square(new_r)))
        raws.append(torch.sum(torch.square(g.to(_F32))))
    stats = {
        "quant_mse": sum(errs) / max(len(errs), 1),
        "grad_sq": sum(raws),
        "wire_bytes_ratio": 0.25,     # int8 vs f32
    }
    return (unflatten(structure, deqs),
            CompressionState(residual=unflatten(structure, news)), stats)

"""Kernel-tier microbenchmark of the port: the SoftSort apply, fwd and
fwd+grad, one row per tier, swept over (N, d, B, K, dtype).  The
counterpart of the reference's ``benchmarks/kernel_bench.py``, with the
same cells, tiers and parity gate:

  * ``dense``     — the O(N^2)-memory oracle (``kernels/ref.py``)
  * ``chunked``   — streamed row blocks in plain torch
                    (``core.softsort_apply_chunked``, chunk 256)
  * ``kernel_v1`` — the v1 kernels: 3-pass forward (``v1_stats``,
                    ``v1_apply``, ``colsum``) + chunked plain-torch
                    backward (``ops.softsort_apply_v1``)
  * ``fused``     — the fused forward (2 kernels) + 2-kernel backward
                    over the (perm, m, l, y) residuals
  * ``banded``    — the O(N K) banded kernels
                    (``ops.softsort_apply_banded``)

bfloat16 cells run only the kernel tiers ``fused`` and ``banded``, held
to the same float32 oracles with the looser ``--tol-bf16``.  Keys are a
shuffled arange (the trainer's per-round init), tau = 0.5, operands made
from a seed with a ``torch.Generator``.

Columns:

  * ``fwd_s`` / ``fwdgrad_s`` — mean seconds over ``--reps`` calls after
    one warm-up call (which also builds the kernels at first use).  On
    CUDA the timed calls end in ``torch.cuda.synchronize()`` and
    ``wall_clock`` is "measured".  On the CPU the kernel tiers run their
    plain twins and ``wall_clock`` is "cpu_twins": those times say
    nothing about the card.
  * ``parity`` / ``band`` — max abs error against the dense oracle (and,
    banded, against the windowed oracle), relative to the oracle's max
    abs; ``--check`` gates them as the reference's bench does.
  * ``bound_ms`` — per kernel tier, the sum of the bounds
    (``kernels/bounds.py``) of the kernels one fwd+grad launches: the
    least time an H100 could take for them.
  * ``tiles`` — the fixed tiles of the v1 kernels: 9a's rows and threads
    per block, and 9b's column step (kernel 1's).  Kernels 1-8 and 9b size
    their payload tile, where they have one, from d.

Usage:

    python -m repro_torch.bench.kernel_bench --check     # full sweep, CUDA
    python -m repro_torch.bench.kernel_bench --device cpu --smoke --check

It writes a file only where ``--out`` says.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from repro_torch.core import (
    band_tail_bound,
    resolve_device,
    softsort_apply_banded as banded_oracle,
    softsort_apply_chunked,
)
from repro_torch.kernels.bounds import tier_bound_ms
from repro_torch.kernels.ops import (
    softsort_apply,
    softsort_apply_banded,
    softsort_apply_v1,
)
from repro_torch.kernels.ref import softsort_apply_ref
from repro_torch.kernels.softsort_apply import TILES

FULL_CELLS = [  # (N, d, B, K)
    (1024, 8, 1, 128),
    (1024, 8, 8, 128),
    (1024, 50, 1, 128),
    (2048, 8, 1, 128),
    (4096, 8, 1, 256),
]
SMOKE_CELLS = [(384, 8, 2, 64)]    # multi-block grids, tiny runtime
DTYPES = ("float32", "bfloat16")
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}
TAU = 0.5


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device, reps: int):
    """(mean seconds over reps after one warm-up call, last output)."""
    out = fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps, out


def _impls(tau, band, dtype):
    """name -> apply(w (B, N), x (B, N, d)) returning (y, c).  bf16 cells
    carry only the kernel tiers: the others are the float32 oracles."""
    kernel = {
        "fused": lambda w, x: softsort_apply(w, x, tau, compute_dtype=dtype),
        "banded": lambda w, x: softsort_apply_banded(w, x, tau, band,
                                                     compute_dtype=dtype),
    }
    if dtype != "float32":
        return kernel
    return {
        "dense": lambda w, x: softsort_apply_ref(w, x, tau),
        "chunked": lambda w, x: softsort_apply_chunked(w, x, tau, 256),
        "kernel_v1": lambda w, x: softsort_apply_v1(w, x, tau),
        **kernel,
    }


def _cell_operands(n: int, d: int, bsz: int, device):
    """Keys a shuffled arange per instance (unit rank gaps, no ties, a
    K-rank spread of exactly K), payload and loss weights normal."""
    g = torch.Generator().manual_seed(n + d + bsz)
    w = torch.stack([torch.randperm(n, generator=g).float()
                     for _ in range(bsz)])
    x = torch.randn(bsz, n, d, generator=g)
    a = torch.randn(bsz, n, d, generator=g)
    b = torch.randn(bsz, n, generator=g)
    return tuple(t.to(device) for t in (w, x, a, b))


def _loss_grad(apply_fn, w, x, a, b):
    """(loss, d loss / dw) of sum(y a) + sum(colsum b)."""
    wv = w.detach().requires_grad_(True)
    y, c = apply_fn(wv, x)
    loss = (y * a).sum() + (c * b).sum()
    (dw,) = torch.autograd.grad(loss, wv)
    return loss.detach(), dw


def _cell_refs(w, x, a, b, tau: float, band: int) -> dict:
    """The float32 oracle references (dense and windowed banded, forward
    and dw), shared by the dtype cells of one shape."""
    with torch.no_grad():
        y_ref, c_ref = softsort_apply_ref(w, x, tau)
        y_ob, c_ob = banded_oracle(w, x, tau, band)
    _, dw_ref = _loss_grad(lambda w_, x_: softsort_apply_ref(w_, x_, tau),
                           w, x, a, b)
    _, dw_ob = _loss_grad(lambda w_, x_: banded_oracle(w_, x_, tau, band),
                          w, x, a, b)
    return {"y": y_ref, "c": c_ref, "dw": dw_ref,
            "y_band": y_ob, "c_band": c_ob, "dw_band": dw_ob}


def _relerr(got, want) -> float:
    """Max abs error relative to the oracle's max magnitude: one
    tolerance gates every N / d / B cell."""
    scale = float(want.abs().max()) + 1e-9
    return float((got.float() - want).abs().max()) / scale


def run_cell(n: int, d: int, bsz: int, band: int, dtype: str,
             tau: float = TAU, reps: int = 3, operands=None, refs=None,
             device=None) -> dict:
    """One cell: every tier of ``dtype`` timed fwd and fwd+grad, with its
    parity.  ``operands`` = (w, x, a, b) tensors, made from the cell's
    seed on ``device`` when not given (``device=None`` means CUDA)."""
    if operands is None:
        operands = _cell_operands(n, d, bsz, resolve_device(device))
    w, x, a, b = operands
    dev = w.device
    if refs is None:
        refs = _cell_refs(w, x, a, b, tau, band)

    impls = _impls(tau, band, dtype)
    fwd_s, fwdgrad_s, grads, outs = {}, {}, {}, {}
    for name, fn in impls.items():
        with torch.no_grad():
            fwd_s[name], outs[name] = _time(lambda: fn(w, x), dev, reps)
        fwdgrad_s[name], (_, grads[name]) = _time(
            lambda: _loss_grad(fn, w, x, a, b), dev, reps)

    parity = {}
    for name in impls:
        if name in ("dense", "banded"):
            continue
        parity[f"{name}_y_relerr"] = _relerr(outs[name][0], refs["y"])
        parity[f"{name}_c_relerr"] = _relerr(outs[name][1], refs["c"])
        parity[f"{name}_dw_relerr"] = _relerr(grads[name], refs["dw"])

    # Banded: against its windowed float32 oracle (same truncation, so
    # this isolates the kernel and precision error), and within the tail
    # bound (plus tolerance) against the dense oracle.
    yb, cb = outs["banded"]
    band_cols = {
        "K": band,
        "tail_bound": float(band_tail_bound(w, tau, band).max()),
        "vs_oracle_y_relerr": _relerr(yb, refs["y_band"]),
        "vs_oracle_c_relerr": _relerr(cb, refs["c_band"]),
        "vs_oracle_dw_relerr": _relerr(grads["banded"], refs["dw_band"]),
        "vs_dense_y_relerr": _relerr(yb, refs["y"]),
        "vs_dense_c_relerr": _relerr(cb, refs["c"]),
        "vs_dense_dw_relerr": _relerr(grads["banded"], refs["dw"]),
    }
    bounds = {name: tier_bound_ms(name, bsz, n, d, band, DTYPE_BYTES[dtype])
              for name in impls}
    cuda = dev.type == "cuda"
    return {
        "N": n, "d": d, "B": bsz, "K": band, "tau": tau, "dtype": dtype,
        "device": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "wall_clock": "measured" if cuda else "cpu_twins",
        "fwd_s": fwd_s,
        "fwdgrad_s": fwdgrad_s,
        "parity": parity,
        "band": band_cols,
        "bound_ms": {k: v for k, v in bounds.items() if v is not None},
        "tiles": dict(TILES),
    }


def gate(rows, tol: float, tol_bf16: float) -> list:
    """Every parity column within its dtype's tolerance, the banded
    vs-dense columns within it plus the tail bound.  Returns the
    failures."""
    bad = []
    for cell in rows:
        lim = tol if cell["dtype"] == "float32" else tol_bf16
        cols = [(key, val, lim) for key, val in cell["parity"].items()]
        bound = cell["band"]["tail_bound"]
        cols += [(f"band.{key}", val,
                  lim + (bound if key.startswith("vs_dense") else 0))
                 for key, val in cell["band"].items()
                 if key not in ("K", "tail_bound")]
        bad += [(cell["N"], cell["d"], cell["B"], cell["dtype"], key, val)
                for key, val, limit in cols
                if not math.isfinite(val) or val > limit]
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one small multi-block cell, both dtypes")
    ap.add_argument("--check", action="store_true",
                    help="fail unless every parity column is within its "
                         "dtype's tolerance (banded-vs-dense within it "
                         "plus the tail bound)")
    ap.add_argument("--tol", type=float, default=2e-3,
                    help="float32 gate: max abs error vs the oracle, "
                         "relative to the oracle's max abs")
    ap.add_argument("--tol-bf16", type=float, default=2e-2,
                    help="bfloat16 gate: the reference's documented bf16 "
                         "envelope")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a CUDA "
                         "device) or cpu, where the plain twins run")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows = []
    for n, d, bsz, band in SMOKE_CELLS if args.smoke else FULL_CELLS:
        operands = _cell_operands(n, d, bsz, device)
        refs = _cell_refs(*operands, TAU, band)   # shared across dtypes
        for dtype in DTYPES:
            cell = run_cell(n, d, bsz, band, dtype, reps=args.reps,
                            operands=operands, refs=refs)
            rows.append(cell)
            worst = max(cell["parity"].values())
            print(f"N={n} d={d} B={bsz} K={band} {dtype} "
                  f"({cell['wall_clock']}): fwd+grad ms "
                  + " ".join(f"{k} {v * 1e3:.3f}"
                             for k, v in cell["fwdgrad_s"].items())
                  + f"; worst parity {worst:.2e}, banded vs oracle dw "
                  f"{cell['band']['vs_oracle_dw_relerr']:.2e}", flush=True)

    doc = {"bench": "kernel_bench", "device": rows[0]["device"],
           "wall_clock": rows[0]["wall_clock"], "tol": args.tol,
           "tol_bf16": args.tol_bf16, "cells": rows}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
        print(f"wrote {args.out}")
    if args.check:
        bad = gate(rows, args.tol, args.tol_bf16)
        if bad:
            raise SystemExit(f"parity gate failed: {bad}")
        ncols = sum(len(c["parity"]) + len(c["band"]) - 2 for c in rows)
        print(f"parity gate OK (tol={args.tol}, tol_bf16={args.tol_bf16}, "
              f"{ncols} columns)")
    return doc


if __name__ == "__main__":
    main()

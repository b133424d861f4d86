#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit (``nvcc``).  It imports nothing of JAX or of the JAX
package, and stops at the first failed check with a non-zero exit code.

Phases, one JSON line each (``"phase"`` key, ``"t"`` seconds since the
start):

1. ``env`` / ``build`` — versions, the card, and the ``nvcc`` build of
   ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a, with its time.
2. ``kernel_check`` — each of the four dense SoftSort-apply kernels
   (1-4) against its plain PyTorch twin on the same card tensors, at
   (B, N, d) = (8, 4096, 50) (the main run's shape), (3, 1000, 3) and
   (1, 17, 1), in float32 and bfloat16, and the last instance run alone
   against its row of the batch, bitwise; ``kernel_times``: median times
   of each kernel, its twin, and the dense ``torch.softmax(...) @ x``
   yardstick at the main shape.
3. ``band_kernel_check`` — the same for the four banded kernels (5-8) at
   (B, N, d, K) = (8, 4096, 50, 256) (the main run's shape with
   ``band="auto"``), (2, 65536, 14, 4096) (the SOG run's shape),
   (3, 1000, 3, 40) and (1, 17, 1, 3); ``band_kernel_times`` at the first
   two shapes in float32, with the dense yardstick at N = 4096 and the
   ``band_tail_bound`` it is within.
4. ``function_check`` / ``band_function_check`` — the dense
   autograd.Function against the O(N^2) oracle, and the banded one
   against the windowed oracle ``core.softsort_apply_banded``: values
   and the gradients of w, x and tau.
5. ``main_run`` — ``shuffle_soft_sort_batched`` through the dense
   kernels: 4 problems x 2 restarts of 4096 clustered 50-d product
   vectors on a 64 x 64 grid, 32 rounds x 8 inner steps, float32.
   Asserts valid permutations, falling losses, a better neighbour
   distance than the unsorted layout, 256 launches of every dense kernel
   and none of a banded one.
6. ``band_main_run`` — the main run with ``band="auto"`` (K = 256, banded
   from round 0): 256 launches of each banded kernel, none of a dense one.
7. ``band_switch_run`` — 2 problems x 1 restart of the same data with
   ``band=24``, 16 rounds: dense rounds 0-5, banded 6-15; exactly 48
   launches of each dense and 80 of each banded kernel.
8. ``sog_run`` — the slice at full width: Self-Organizing Gaussians (paper
   section IV-B), 1 scene x 2 restarts of 65536 splats with 14 attributes
   on a 256 x 256 grid, ``band="auto"`` (K = 4096), 32 rounds x 8 inner
   steps; neighbour distance and the zlib codec proxy against a random
   order, and 256 launches of each banded kernel.

Then the ``{"kernels": [...]}`` summary line, the card's name and power
limit as ``nvidia-smi`` reports them, and ``{"ok": true, "device": ...}``
as the last line.
"""
import json
import os
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
SOURCE = "src/repro_torch/kernels/csrc/softsort_apply.cu"
REPLACES = {
    "fwd_fused": "src/repro/kernels/softsort_apply.py:150",
    "colsum": "src/repro/kernels/softsort_apply.py:182",
    "bwd_dws_delta": "src/repro/kernels/softsort_apply.py:280",
    "bwd_dx": "src/repro/kernels/softsort_apply.py:324",
    "fwd_band": "src/repro/kernels/softsort_apply.py:517",
    "colsum_band": "src/repro/kernels/softsort_apply.py:567",
    "bwd_band_dws_delta": "src/repro/kernels/softsort_apply.py:657",
    "bwd_band_dcol": "src/repro/kernels/softsort_apply.py:706",
}
DENSE = ("fwd_fused", "colsum", "bwd_dws_delta", "bwd_dx")
BAND = ("fwd_band", "colsum_band", "bwd_band_dws_delta", "bwd_band_dcol")
# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FWD_ATOL, GRAD_RTOL, BF16_RTOL = 2e-5, 1e-4, 2e-2
SHAPES = [(8, 4096, 50), (3, 1000, 3), (1, 17, 1)]
MAIN_SHAPE = SHAPES[0]
BAND_SHAPES = [(8, 4096, 50, 256), (2, 65536, 14, 4096), (3, 1000, 3, 40),
               (1, 17, 1, 3)]
BAND_TIMED = BAND_SHAPES[:2]
SOG_SHAPE = BAND_SHAPES[1]       # the shape of the slice's main path
TAU = 0.5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T0,
                      **fields}), flush=True)


def synthetic_catalog(n=1024, d=50, clusters=24, seed=0):
    """Clustered features mimicking product categories (the generator of
    examples/image_grid_sorting.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(clusters, d) * 2.0
    labels = rng.randint(0, clusters, n)
    x = centers[labels] + 0.4 * rng.randn(n, d)
    return x.astype(np.float32), labels


def synthetic_scene(n, seed=0, noise=0.01):
    """Synthetic splat set with realistic attribute structure: all
    attributes are smooth functions of the surface parameterization (real
    3DGS scenes are spatially coherent — nearby splats share scale,
    orientation and color), plus a small jitter.  A copy of the generator
    of examples/self_organizing_gaussians.py."""
    rng = np.random.RandomState(seed)
    t = rng.rand(n, 2) * 2 * np.pi
    pos = np.stack([np.cos(t[:, 0]), np.sin(t[:, 0]) * np.cos(t[:, 1]),
                    np.sin(t[:, 1])], -1)
    scale = 0.2 + 0.1 * np.abs(np.sin(3 * t))                # (n, 2) -> 3
    scale = np.concatenate([scale, scale[:, :1]], -1)
    rot = np.stack([np.cos(t[:, 0] / 2), np.sin(t[:, 0] / 2),
                    np.cos(t[:, 1] / 2), np.sin(t[:, 1] / 2)], -1)
    opacity = (0.5 + 0.5 * np.cos(t[:, :1]))
    color = 0.5 + 0.5 * np.stack(
        [np.cos(t[:, 0]), np.sin(t[:, 1]), np.cos(t.sum(1))], -1)
    attrs = np.concatenate([pos, scale, rot, opacity, color], -1)
    attrs += noise * rng.randn(*attrs.shape)
    return attrs.astype(np.float32)                          # (n, 14)


def plane_bytes(attrs, order, hw):
    """Compress each attribute as an (h, w) int8 plane (per-plane scale),
    zlib-deflated — the codec proxy of
    examples/self_organizing_gaussians.py."""
    h, w = hw
    total = 0
    for j in range(attrs.shape[1]):
        plane = attrs[order, j].reshape(h, w)
        scale = np.max(np.abs(plane)) / 127.0 + 1e-12
        q = np.clip(np.round(plane / scale), -127, 127).astype(np.int8)
        # 2-D delta (horizontal) mimics intra-frame prediction
        delta = np.diff(q.astype(np.int16), axis=1,
                        prepend=np.zeros((h, 1), np.int16)).astype(np.int8)
        total += len(zlib.compress(delta.tobytes(), 6))
    return total


def neighbor_distance(grid_vectors, hw):
    """Mean feature distance of 4-neighbour grid cells: the numerator of
    ``mean_neighbor_distance``.  Its denominator, the mean over all pairs,
    is the same for every order of the same items, so two orders compare
    alike by either; at N = 65536 the all-pairs mean is out of reach of
    the numpy metric."""
    x = np.asarray(grid_vectors, dtype=np.float64)
    h, w = hw
    g = x.reshape(h, w, -1)
    dh = np.linalg.norm(g[:, 1:] - g[:, :-1], axis=-1)
    dv = np.linalg.norm(g[1:, :] - g[:-1, :], axis=-1)
    return float((dh.sum() + dv.sum()) / (dh.size + dv.size))


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps=15, warmup=3):
    """Median milliseconds of ``fn()`` on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(got, want):
    return float((got.detach().float() - want.detach().float()).abs().max())


def require(cond, message):
    """A check that holds under ``python -O`` too."""
    if not cond:
        raise AssertionError(message)


def check(name, got, want, rtol=None, atol=None):
    """Raise unless |got - want| <= atol or rtol * max|want|."""
    err = max_err(got, want)
    limit = atol if atol is not None else rtol * (
        float(want.detach().float().abs().max()) + 1e-9)
    require(err <= limit, f"{name}: max abs err {err:.3g} > {limit:.3g}")
    return err


def bound_ms(kernel, bsz, n, d, k=None, payload_bytes=4):
    """Least time for the work on the card: each input read once, each
    output written once, over HBM bandwidth; float32 operations counted
    per (row, column) pair from the algorithm, over the CUDA-core peak.
    Dense kernels score N^2 pairs per instance, banded ones the
    N (2K + 1) - K (K + 1) pairs within K ranks."""
    pairs = bsz * (n * n if k is None else n * (2 * k + 1) - k * (k + 1))
    bn, bnd = bsz * n * 4, bsz * n * d * payload_bytes
    work = {   # (flops per pair, bytes moved)
        "fwd_fused": (2 * d + 6, 2 * bn + bnd + 4 + bnd + 2 * bn),
        "colsum": (6, 4 * bn + 4 + bn),
        "bwd_dws_delta": (2 * d + 14, 4 * bn + 3 * bnd + bn + 4 + 2 * bn),
        "bwd_dx": (4 * d + 13, 5 * bn + 2 * bnd + bn + 4 + bnd + 2 * bn),
        "fwd_band": (2 * d + 6, bn + bnd + 4 + bnd + 2 * bn),
        "colsum_band": (6, 3 * bn + 4 + bn),
        "bwd_band_dws_delta": (2 * d + 14, 4 * bn + 3 * bnd + 4 + 2 * bn),
        "bwd_band_dcol": (4 * d + 13, 5 * bn + 2 * bnd + 4 + bnd + 2 * bn),
    }
    flops_per_pair, nbytes = work[kernel]
    t_ops = pairs * flops_per_pair / PEAK_F32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def kernel_operands(torch, bsz, n, d, cd, seed):
    """Untied keys: a random permutation of 0..N-1 jittered by < 0.4, as
    the anneal's keys start from arange(N)."""
    g = torch.Generator().manual_seed(seed)
    w = torch.stack([torch.randperm(n, generator=g).float()
                     for _ in range(bsz)])
    w = w + 0.8 * (torch.rand(bsz, n, generator=g) - 0.5)
    ws = torch.sort(w, dim=-1, stable=True).values
    x = torch.randn(bsz, n, d, generator=g)
    dy = torch.randn(bsz, n, d, generator=g)
    dc = torch.randn(bsz, n, generator=g)
    dev = torch.device("cuda")
    return (ws.to(dev), w.to(dev), x.to(dev, cd),
            torch.tensor([TAU], device=dev), dy.to(dev, cd), dc.to(dev, cd))


def kernel_pipeline(K, ws, w, x, tau, dy, dc):
    """All four dense kernels in order; returns their outputs."""
    y, m, l = K.fwd_fused(ws, w, x, tau)
    c = K.colsum(ws, w, tau, m, l, x.dtype)
    D, dws = K.bwd_dws_delta(ws, w, x, tau, m, l, dy, y, dc)
    dx, dwc, dtc = K.bwd_dx(ws, w, x, tau, m, l, dy, dc, D)
    return y, m, l, c, D, dws, dx, dwc, dtc


def band_pipeline(K, ws, xs, tau, dy, dc, k):
    """All four banded kernels in order; returns their outputs.  Both axes
    are the sorted keys ``ws``; ``xs`` and ``dc`` are in rank order."""
    y, m, l = K.fwd_band(ws, xs, tau, k)
    c = K.colsum_band(ws, tau, m, l, k, xs.dtype)
    D, dws = K.bwd_band_dws_delta(ws, xs, tau, m, l, dy, y, dc, k)
    dxs, dwc, dtc = K.bwd_band_dcol(ws, xs, tau, m, l, dy, dc, D, k)
    return y, m, l, c, D, dws, dxs, dwc, dtc


def require_batch_invariant(torch, pipeline, operands, outs):
    """The last instance run alone gives bitwise the batch's last row:
    blocks of one instance never touch another's, and no atomics."""
    i = operands[0].shape[0] - 1
    alone = pipeline(*[t[i:i + 1].contiguous()
                       if isinstance(t, torch.Tensor) and t.dim() > 1
                       else t for t in operands])
    for got, want in zip(alone, outs):
        require(torch.equal(got[0], want[i]), "batched != alone")


def kernel_errors(outs, twins, f32):
    """Max errors of each kernel's outputs against its twin's, checked
    against the stated tolerances; keyed by position in the pipeline."""
    rt = GRAD_RTOL if f32 else BF16_RTOL
    y, m, l, c, D, dws, dx, dwc, dtc = outs
    y0, m0, l0, c0, D0, dws0, dx0, dwc0, dtc0 = twins
    return [
        [check("y", y, y0, atol=FWD_ATOL) if f32 else check("y", y, y0,
                                                            rtol=rt),
         check("m", m, m0, atol=FWD_ATOL), check("l", l, l0, rtol=FWD_ATOL)],
        [check("colsum", c, c0, atol=FWD_ATOL) if f32
         else check("colsum", c, c0, rtol=rt)],
        [check("D", D, D0, rtol=rt), check("dws", dws, dws0, rtol=rt)],
        [check("dx", dx, dx0, rtol=rt), check("dw_cols", dwc, dwc0, rtol=rt),
         check("dtau_cols", dtc, dtc0, rtol=rt)],
    ]


def time_kernels(torch, stats, names, calls, shape):
    """ms (kernel), plain_ms (twin) and bound_ms of each kernel at
    ``shape`` into ``stats``; library_ms is None unless the caller sets
    it."""
    for name, (kern, plain) in zip(names, calls):
        stats[name]["ms"] = time_ms(torch, kern)
        stats[name]["plain_ms"] = time_ms(torch, plain, reps=5)
        stats[name]["library_ms"] = None
        stats[name]["bound_ms"], stats[name]["bound_by"] = bound_ms(
            name, *shape)
        stats[name]["shape"] = list(shape)


def kernel_phase(torch, K):
    """Phase 2: every dense kernel against its twin; times at the main
    shape."""
    stats = {k: {"max_abs_err": 0.0} for k in DENSE}
    for bsz, n, d in SHAPES:
        for cd in (torch.float32, torch.bfloat16):
            f32 = cd == torch.float32
            ws, w, x, tau, dy, dc = kernel_operands(torch, bsz, n, d, cd,
                                                    seed=n + d)
            outs = kernel_pipeline(K, ws, w, x, tau, dy, dc)
            y, m, l, c, D, dws, dx, dwc, dtc = outs
            twins = (*K.fwd_fused_plain(ws, w, x, tau),
                     K.colsum_plain(ws, w, tau, m, l, cd),
                     *K.bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y, dc),
                     *K.bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D))
            torch.cuda.synchronize()
            require_batch_invariant(
                torch, lambda *a: kernel_pipeline(K, *a),
                (ws, w, x, tau, dy, dc), outs)
            errs = dict(zip(DENSE, kernel_errors(outs, twins, f32)))
            emit("kernel_check", shape=[bsz, n, d], dtype=str(cd),
                 max_abs_err={k: max(v) for k, v in errs.items()},
                 batch_invariant=True)
            if not (f32 and (bsz, n, d) == MAIN_SHAPE):
                continue
            for k, v in errs.items():
                stats[k]["max_abs_err"] = max(v)
            calls = [
                (lambda: K.fwd_fused(ws, w, x, tau),
                 lambda: K.fwd_fused_plain(ws, w, x, tau)),
                (lambda: K.colsum(ws, w, tau, m, l),
                 lambda: K.colsum_plain(ws, w, tau, m, l)),
                (lambda: K.bwd_dws_delta(ws, w, x, tau, m, l, dy, y, dc),
                 lambda: K.bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y,
                                               dc)),
                (lambda: K.bwd_dx(ws, w, x, tau, m, l, dy, dc, D),
                 lambda: K.bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D)),
            ]
            time_kernels(torch, stats, DENSE, calls, (bsz, n, d))
            inv_tau = 1.0 / tau

            def library_fwd():   # yardstick only: the port never calls it
                s = -(ws[:, :, None] - w[:, None, :]).abs() * inv_tau
                return torch.softmax(s, dim=-1) @ x

            stats["fwd_fused"]["library_ms"] = time_ms(torch, library_fwd,
                                                       reps=5)
            emit("kernel_times", shape=[bsz, n, d], dtype=str(cd),
                 times=stats)
    return stats


def band_kernel_phase(torch, K, core):
    """Phase 3: every banded kernel against its twin at the four shapes;
    times at the first two.  Returns the stats of each timed shape."""
    timed = {}
    for bsz, n, d, k in BAND_SHAPES:
        for cd in (torch.float32, torch.bfloat16):
            f32 = cd == torch.float32
            ws, _, xs, tau, dy, dc = kernel_operands(torch, bsz, n, d, cd,
                                                     seed=n + d + k)
            outs = band_pipeline(K, ws, xs, tau, dy, dc, k)
            y, m, l, c, D, dws, dxs, dwc, dtc = outs
            twins = (*K.fwd_band_plain(ws, xs, tau, k),
                     K.colsum_band_plain(ws, tau, m, l, k, cd),
                     *K.bwd_band_dws_delta_plain(ws, xs, tau, m, l, dy, y,
                                                 dc, k),
                     *K.bwd_band_dcol_plain(ws, xs, tau, m, l, dy, dc, D, k))
            torch.cuda.synchronize()
            require_batch_invariant(
                torch, lambda *a: band_pipeline(K, *a),
                (ws, xs, tau, dy, dc, k), outs)
            errs = dict(zip(BAND, kernel_errors(outs, twins, f32)))
            emit("band_kernel_check", shape=[bsz, n, d, k], dtype=str(cd),
                 max_abs_err={kk: max(v) for kk, v in errs.items()},
                 batch_invariant=True)
            del twins
            if not (f32 and (bsz, n, d, k) in BAND_TIMED):
                continue
            stats = {kk: {"max_abs_err": max(v)} for kk, v in errs.items()}
            calls = [
                (lambda: K.fwd_band(ws, xs, tau, k),
                 lambda: K.fwd_band_plain(ws, xs, tau, k)),
                (lambda: K.colsum_band(ws, tau, m, l, k),
                 lambda: K.colsum_band_plain(ws, tau, m, l, k)),
                (lambda: K.bwd_band_dws_delta(ws, xs, tau, m, l, dy, y, dc,
                                              k),
                 lambda: K.bwd_band_dws_delta_plain(ws, xs, tau, m, l, dy, y,
                                                    dc, k)),
                (lambda: K.bwd_band_dcol(ws, xs, tau, m, l, dy, dc, D, k),
                 lambda: K.bwd_band_dcol_plain(ws, xs, tau, m, l, dy, dc, D,
                                               k)),
            ]
            time_kernels(torch, stats, BAND, calls, (bsz, n, d, k))
            extra = {}
            if n <= 4096:
                inv_tau = 1.0 / tau

                def library_fwd():   # yardstick only: the port never calls it
                    s = -(ws[:, :, None] - ws[:, None, :]).abs() * inv_tau
                    return torch.softmax(s, dim=-1) @ xs

                stats["fwd_band"]["library_ms"] = time_ms(
                    torch, library_fwd, reps=5)
                # The dense yardstick computes the untruncated apply: it
                # equals fwd_band to within the band's tail bound.
                tail = core.band_tail_bound(ws, float(TAU), k)
                extra["library_tail_bound"] = float(tail.max())
                extra["library_vs_band_max_abs"] = max_err(library_fwd(), y)
            emit("band_kernel_times", shape=[bsz, n, d, k], dtype=str(cd),
                 times=stats, **extra)
            timed[(bsz, n, d, k)] = stats
    return timed


def function_phase(torch, ops, ref, core):
    """Phase 4: both autograd.Functions on the card against their
    oracles: the dense one against the O(N^2) oracle, the banded one
    against the windowed oracle."""
    cases = [("function_check", (bsz, n, d), ops.softsort_apply,
              ref.softsort_apply_ref) for bsz, n, d in SHAPES]
    for bsz, n, d, k in [(3, 1000, 3, 40), (8, 4096, 50, 256)]:
        cases.append((
            "band_function_check", (bsz, n, d, k),
            lambda w, x, t, k=k: ops.softsort_apply_banded(w, x, t, k),
            lambda w, x, t, k=k: core.softsort_apply_banded(w, x, t, k)))
    for phase, shape, fn, oracle in cases:
        bsz, n, d = shape[:3]
        ws, w, x, tau, dy, dc = kernel_operands(torch, bsz, n, d,
                                                torch.float32, seed=7 * n)
        results = []
        for f in (fn, oracle):
            wv = w.clone().requires_grad_(True)
            xv = x.clone().requires_grad_(True)
            tv = tau.clone().requires_grad_(True)
            y, c = f(wv, xv, tv)
            loss = (y * dy).sum() + (c.square() * dc).sum()
            results.append((y, c, *torch.autograd.grad(loss, (wv, xv, tv))))
        torch.cuda.synchronize()
        (y, c, gw, gx, gt), (yr, cr, gwr, gxr, gtr) = results
        emit(phase, shape=list(shape), max_abs_err={
            "y": check("y", y, yr, atol=FWD_ATOL),
            "colsum": check("colsum", c, cr, atol=FWD_ATOL),
            "dw": check("dw", gw, gwr, rtol=GRAD_RTOL),
            "dx": check("dx", gx, gxr, rtol=GRAD_RTOL),
            "dtau": check("dtau", gt, gtr, rtol=GRAD_RTOL)})
        del results


def anneal(torch, core, K, xs, hw, cfg, restarts):
    """One ``shuffle_soft_sort_batched`` run on the card, launch counts
    set to 0 just before it and read just after.  Checks valid
    permutations and finite, falling losses; returns the result, the
    counts and the host-clock ms of each round."""
    n = hw[0] * hw[1]
    stamps = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = core.shuffle_soft_sort_batched(
        xs, hw, cfg, n_restarts=restarts, seed=0, device="cuda",
        callback=lambda r, o, l: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = K.launch_counts()
    per_round = np.diff([t0] + stamps) * 1e3
    for row in res.all_orders.reshape(-1, n):
        require(core.is_valid_permutation(row), "invalid permutation")
    first, last = res.all_losses[:, :, 0], res.all_losses[:, :, -1]
    require(np.isfinite(res.all_losses).all(), "non-finite loss")
    require((last < first).all(), f"loss did not fall: {first} -> {last}")
    timing = dict(seconds=total, ms_per_round=float(per_round.mean()),
                  ms_first_round=float(per_round[0]),
                  ms_per_round_after_first=float(per_round[1:].mean()),
                  loss_first=first.tolist(), loss_last=last.tolist(),
                  best_restart=res.best_restart.tolist(), launches=counts)
    return res, counts, timing


def require_counts(counts, want):
    """Exact launch counts: ``want`` maps kernel name -> launches."""
    require(all(counts[k] == v for k, v in want.items()),
            f"launch counts {counts}, expected {want}")


def catalog_runs(torch, core, K):
    """Phases 5-7 on the clustered 4096-item catalog (d = 50): the dense
    main run, the all-banded main run, the run across the band switch.
    Returns the launch counts of the dense main run."""
    from repro_torch.core.shufflesoftsort import _band_switch_round

    b, s, hw, d = 4, 2, (64, 64), 50
    n = hw[0] * hw[1]
    rounds, inner = 32, 8
    xs = np.stack([synthetic_catalog(n, d, clusters=24, seed=i)[0]
                   for i in range(b)])
    nbr_before = [core.mean_neighbor_distance(xs[i], hw) for i in range(b)]
    per_step = rounds * inner
    dense_counts = None
    for phase, band in (("main_run", None), ("band_main_run", "auto")):
        cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner,
                                         use_kernel=True, band=band)
        emit(phase + "_config", problems=b, restarts=s, n=n, d=d, grid=hw,
             rounds=rounds, inner_steps=inner,
             compute_dtype=cfg.compute_dtype, band=band,
             band_k=core.resolve_band(cfg, n),
             switch_round=_band_switch_round(cfg, n),
             cut="rounds 1000 -> 32 for time; every other config field at "
                 "its default; N = 4096 is 4x the paper's section IV-A task")
        res, counts, timing = anneal(torch, core, K, xs, hw, cfg, s)
        nbr_after = [core.mean_neighbor_distance(res.sorted[i], hw)
                     for i in range(b)]
        require(all(a < bf for a, bf in zip(nbr_after, nbr_before)),
                f"neighbour distance did not fall: {nbr_before} -> "
                f"{nbr_after}")
        on, off = (DENSE, BAND) if band is None else (BAND, DENSE)
        require_counts(counts, {**{k: per_step for k in on},
                                **{k: 0 for k in off}})
        emit(phase, **timing, mean_neighbor_distance_unsorted=nbr_before,
             mean_neighbor_distance_sorted=nbr_after)
        if band is None:
            dense_counts = counts

    # Across the switch: 2 problems x 1 restart, band 24, 16 rounds.
    cfg = core.ShuffleSoftSortConfig(rounds=16, inner_steps=inner,
                                     use_kernel=True, band=24)
    switch = _band_switch_round(cfg, n)
    require(switch == 6, f"switch round {switch}, expected 6")
    res, counts, timing = anneal(torch, core, K, xs[:2], hw, cfg, 1)
    require_counts(counts, {**{k: switch * inner for k in DENSE},
                            **{k: (16 - switch) * inner for k in BAND}})
    emit("band_switch_run", problems=2, restarts=1, n=n, d=d, band=24,
         rounds=16, inner_steps=inner, switch_round=switch, **timing)
    return dense_counts


def sog_run(torch, core, K):
    """Phase 8: the slice at full width, the paper's section IV-B
    workload.  Returns the launch counts."""
    from repro_torch.core.shufflesoftsort import _band_switch_round

    hw, restarts, rounds, inner = (256, 256), 2, 32, 8
    n = hw[0] * hw[1]
    attrs = synthetic_scene(n)
    cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner,
                                     use_kernel=True, band="auto")
    k = core.resolve_band(cfg, n)
    switch = _band_switch_round(cfg, n)
    require((n, attrs.shape[1], k) == SOG_SHAPE[1:] and switch == 0,
            f"SOG run resolved N, d, K, switch = {n}, {attrs.shape[1]}, "
            f"{k}, {switch}")
    emit("sog_run_config", scenes=1, restarts=restarts, n=n,
         d=attrs.shape[1], grid=hw, rounds=rounds, inner_steps=inner,
         band="auto", band_k=k, switch_round=switch,
         compute_dtype=cfg.compute_dtype,
         reduced=["N 1e6 -> 65536 splats, for time",
                  "rounds 800 -> 32, for time"])
    res, counts, timing = anneal(torch, core, K, attrs[None], hw, cfg,
                                 restarts)
    require_counts(counts, {**{kk: rounds * inner for kk in BAND},
                            **{kk: 0 for kk in DENSE}})
    order = res.order[0]
    rand_order = np.random.RandomState(1).permutation(n)
    nbr_random = neighbor_distance(attrs[rand_order], hw)
    nbr_sorted = neighbor_distance(attrs[order], hw)
    require(nbr_sorted < nbr_random,
            f"neighbour distance did not fall: {nbr_random} -> {nbr_sorted}")
    bytes_random = plane_bytes(attrs, rand_order, hw)
    bytes_sorted = plane_bytes(attrs, order, hw)
    emit("sog_run", **timing, neighbor_distance_random=nbr_random,
         neighbor_distance_sorted=nbr_sorted, raw_bytes=int(attrs.nbytes),
         codec_bytes_random=bytes_random, codec_bytes_sorted=bytes_sorted,
         codec_gain=bytes_random / bytes_sorted)
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib

    from repro_torch import core
    from repro_torch.kernels import build, ops, ref
    K = importlib.import_module("repro_torch.kernels.softsort_apply")

    # Full float32 products in the plain twins and the yardstick.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(), nvidia_smi=smi)

    t0 = time.perf_counter()
    logs = build.build_all(verbose=True)
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(logs),
         flags=build.NVCC_FLAGS, ptxas=ptxas)

    stats = kernel_phase(torch, K)
    band_stats = band_kernel_phase(torch, K, core)
    stats.update(band_stats[SOG_SHAPE])
    function_phase(torch, ops, ref, core)
    launches = catalog_runs(torch, core, K)
    launches.update({k: v for k, v in sog_run(torch, core, K).items()
                     if k in BAND})

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": launches[k],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
         "bound_by": v["bound_by"], "library_ms": v["library_ms"],
         "shape": v["shape"]}
        for k, v in stats.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

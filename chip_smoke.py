#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit (``nvcc``).  It imports nothing of JAX or of the JAX
package, and stops at the first failed check with a non-zero exit code.

Phases, one JSON line each (``"phase"`` key):

1. ``env`` / ``build`` — versions, the card, and the ``nvcc`` build of
   ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a, with its time.
2. ``kernel_check`` — each of the four SoftSort-apply kernels against its
   plain PyTorch twin on the same card tensors, at (B, N, d) = (8, 4096,
   50) (the main run's shape), (3, 1000, 3) and (1, 17, 1), in float32
   and bfloat16, and the last instance run alone against its row of the
   batch, bitwise; then ``function_check``: the autograd.Function's values
   and gradients against the dense O(N^2) oracle.  Median times of each
   kernel, its twin, and the dense ``torch.softmax(...) @ x`` yardstick.
3. ``main_run`` — ``shuffle_soft_sort_batched`` through the kernels: 4
   problems x 2 restarts of 4096 clustered 50-d product vectors on a
   64 x 64 grid, 32 rounds x 8 inner steps, float32.  Asserts valid
   permutations, falling losses, a better neighbour distance than the
   unsorted layout, and 256 launches of every kernel.

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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "src/repro_torch/kernels/csrc/softsort_apply.cu"
REPLACES = {
    "fwd_fused": "src/repro/kernels/softsort_apply.py:150",
    "colsum": "src/repro/kernels/softsort_apply.py:182",
    "bwd_dws_delta": "src/repro/kernels/softsort_apply.py:280",
    "bwd_dx": "src/repro/kernels/softsort_apply.py:324",
}
# H100 SXM peaks (NVIDIA data sheet): float32 on the CUDA cores, HBM3.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
FWD_ATOL, GRAD_RTOL, BF16_RTOL = 2e-5, 1e-4, 2e-2
SHAPES = [(8, 4096, 50), (3, 1000, 3), (1, 17, 1)]
MAIN_SHAPE = SHAPES[0]
TAU = 0.5


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def synthetic_catalog(n=1024, d=50, clusters=24, seed=0):
    """Clustered features mimicking product categories (the generator of
    examples/image_grid_sorting.py)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(clusters, d) * 2.0
    labels = rng.randint(0, clusters, n)
    x = centers[labels] + 0.4 * rng.randn(n, d)
    return x.astype(np.float32), labels


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


def bound_ms(kernel, bsz, n, d, payload_bytes=4):
    """Least time for the work on the card: each input read once, each
    output written once, over HBM bandwidth; float32 operations counted
    per (row, column) pair from the algorithm, over the CUDA-core peak."""
    pairs = bsz * n * n
    bn, bnd = bsz * n * 4, bsz * n * d * payload_bytes
    work = {   # (flops per pair, bytes moved)
        "fwd_fused": (2 * d + 6, 2 * bn + bnd + 4 + bnd + 2 * bn),
        "colsum": (6, 4 * bn + 4 + bn),
        "bwd_dws_delta": (2 * d + 14, 4 * bn + 3 * bnd + bn + 4 + 2 * bn),
        "bwd_dx": (4 * d + 13, 5 * bn + 2 * bnd + bn + 4 + bnd + 2 * bn),
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
    """All four kernels in order; returns their outputs."""
    y, m, l = K.fwd_fused(ws, w, x, tau)
    c = K.colsum(ws, w, tau, m, l, x.dtype)
    D, dws = K.bwd_dws_delta(ws, w, x, tau, m, l, dy, y, dc)
    dx, dwc, dtc = K.bwd_dx(ws, w, x, tau, m, l, dy, dc, D)
    return y, m, l, c, D, dws, dx, dwc, dtc


def require_batch_invariant(torch, K, operands, outs):
    """The last instance run alone gives bitwise the batch's last row:
    blocks of one instance never touch another's, and no atomics."""
    i = operands[0].shape[0] - 1
    alone = kernel_pipeline(K, *[t[i:i + 1].contiguous() if t.dim() > 1
                                 else t for t in operands])
    for got, want in zip(alone, outs):
        require(torch.equal(got[0], want[i]), "batched != alone")


def kernel_phase(torch, K):
    """Phase 2: every kernel against its twin; times at the main shape."""
    stats = {k.__name__: {"max_abs_err": 0.0} for k in K.KERNELS}
    for bsz, n, d in SHAPES:
        for cd in (torch.float32, torch.bfloat16):
            f32 = cd == torch.float32
            rt = GRAD_RTOL if f32 else BF16_RTOL
            ws, w, x, tau, dy, dc = kernel_operands(torch, bsz, n, d, cd,
                                                    seed=n + d)
            outs = kernel_pipeline(K, ws, w, x, tau, dy, dc)
            y, m, l, c, D, dws, dx, dwc, dtc = outs
            y0, m0, l0 = K.fwd_fused_plain(ws, w, x, tau)
            c0 = K.colsum_plain(ws, w, tau, m, l, cd)
            D0, dws0 = K.bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y, dc)
            dx0, dwc0, dtc0 = K.bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D)
            torch.cuda.synchronize()
            require_batch_invariant(torch, K, (ws, w, x, tau, dy, dc), outs)
            errs = {
                "fwd_fused": [
                    check("y", y, y0, atol=FWD_ATOL) if f32
                    else check("y", y, y0, rtol=rt),
                    check("m", m, m0, atol=FWD_ATOL),
                    check("l", l, l0, rtol=FWD_ATOL)],
                "colsum": [check("colsum", c, c0, atol=FWD_ATOL) if f32
                           else check("colsum", c, c0, rtol=rt)],
                "bwd_dws_delta": [check("D", D, D0, rtol=rt),
                                  check("dws", dws, dws0, rtol=rt)],
                "bwd_dx": [check("dx", dx, dx0, rtol=rt),
                           check("dw_cols", dwc, dwc0, rtol=rt),
                           check("dtau_cols", dtc, dtc0, rtol=rt)],
            }
            emit("kernel_check", shape=[bsz, n, d], dtype=str(cd),
                 max_abs_err={k: max(v) for k, v in errs.items()},
                 batch_invariant=True)
            if f32 and (bsz, n, d) == MAIN_SHAPE:
                for k, v in errs.items():
                    stats[k]["max_abs_err"] = max(v)
                ops = {
                    "fwd_fused": (lambda: K.fwd_fused(ws, w, x, tau),
                                  lambda: K.fwd_fused_plain(ws, w, x, tau)),
                    "colsum": (lambda: K.colsum(ws, w, tau, m, l),
                               lambda: K.colsum_plain(ws, w, tau, m, l)),
                    "bwd_dws_delta": (
                        lambda: K.bwd_dws_delta(ws, w, x, tau, m, l, dy, y,
                                                dc),
                        lambda: K.bwd_dws_delta_plain(ws, w, x, tau, m, l,
                                                      dy, y, dc)),
                    "bwd_dx": (
                        lambda: K.bwd_dx(ws, w, x, tau, m, l, dy, dc, D),
                        lambda: K.bwd_dx_plain(ws, w, x, tau, m, l, dy, dc,
                                               D)),
                }
                inv_tau = 1.0 / tau

                def library_fwd():   # yardstick only: the port never calls it
                    s = -(ws[:, :, None] - w[:, None, :]).abs() * inv_tau
                    return torch.softmax(s, dim=-1) @ x

                for k, (kern, plain) in ops.items():
                    stats[k]["ms"] = time_ms(torch, kern)
                    stats[k]["plain_ms"] = time_ms(torch, plain, reps=5)
                    stats[k]["library_ms"] = None
                    stats[k]["bound_ms"], stats[k]["bound_by"] = bound_ms(
                        k, bsz, n, d)
                stats["fwd_fused"]["library_ms"] = time_ms(torch, library_fwd,
                                                           reps=5)
                emit("kernel_times", shape=[bsz, n, d], dtype=str(cd),
                     times={k: {f: v[f] for f in ("ms", "plain_ms",
                                                  "library_ms", "bound_ms",
                                                  "bound_by")}
                            for k, v in stats.items()})
    return stats


def function_phase(torch, ops, ref):
    """The autograd.Function on the card against the dense oracle."""
    for bsz, n, d in SHAPES:
        ws, w, x, tau, dy, dc = kernel_operands(torch, bsz, n, d,
                                                torch.float32, seed=7 * n)
        results = []
        for fn in (ops.softsort_apply, ref.softsort_apply_ref):
            wv = w.clone().requires_grad_(True)
            xv = x.clone().requires_grad_(True)
            tv = tau.clone().requires_grad_(True)
            y, c = fn(wv, xv, tv)
            loss = (y * dy).sum() + (c.square() * dc).sum()
            results.append((y, c, *torch.autograd.grad(loss, (wv, xv, tv))))
        torch.cuda.synchronize()
        (y, c, gw, gx, gt), (yr, cr, gwr, gxr, gtr) = results
        emit("function_check", shape=[bsz, n, d], max_abs_err={
            "y": check("y", y, yr, atol=FWD_ATOL),
            "colsum": check("colsum", c, cr, atol=FWD_ATOL),
            "dw": check("dw", gw, gwr, rtol=GRAD_RTOL),
            "dx": check("dx", gx, gxr, rtol=GRAD_RTOL),
            "dtau": check("dtau", gt, gtr, rtol=GRAD_RTOL)})
        del results


def main_run(torch, core, K):
    """Phase 3: the port's batched anneal on the card."""
    b, s, hw, d = 4, 2, (64, 64), 50
    n = hw[0] * hw[1]
    rounds, inner = 32, 8
    xs = np.stack([synthetic_catalog(n, d, clusters=24, seed=i)[0]
                   for i in range(b)])
    cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner,
                                     use_kernel=True)
    emit("main_run_config", problems=b, restarts=s, n=n, d=d, grid=hw,
         rounds=rounds, inner_steps=inner, compute_dtype=cfg.compute_dtype,
         cut="rounds 1000 -> 32 for time; every other config field at its "
             "default; N = 4096 is 4x the paper's section IV-A task")
    stamps = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = core.shuffle_soft_sort_batched(
        xs, hw, cfg, n_restarts=s, seed=0, device="cuda",
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
    nbr_before = [core.mean_neighbor_distance(xs[i], hw) for i in range(b)]
    nbr_after = [core.mean_neighbor_distance(res.sorted[i], hw)
                 for i in range(b)]
    require(all(a < bf for a, bf in zip(nbr_after, nbr_before)),
            f"neighbour distance did not fall: {nbr_before} -> {nbr_after}")
    want = rounds * inner
    require(all(v == want for v in counts.values()),
            f"launch counts {counts}, expected {want} each")
    emit("main_run", seconds=total, ms_per_round=float(per_round.mean()),
         ms_first_round=float(per_round[0]),
         ms_per_round_after_first=float(per_round[1:].mean()),
         loss_first=first.tolist(), loss_last=last.tolist(),
         mean_neighbor_distance_unsorted=nbr_before,
         mean_neighbor_distance_sorted=nbr_after,
         best_restart=res.best_restart.tolist(), launches=counts)
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
    function_phase(torch, ops, ref)
    counts = main_run(torch, core, K)

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[k], "launches": counts[k],
         "max_abs_err": v["max_abs_err"], "ms": v["ms"],
         "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
         "bound_by": v["bound_by"], "library_ms": v["library_ms"]}
        for k, v in stats.items()]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   (B, N, d) = (8, 4096, 50) (the main run's shape), (3, 1000, 3),
   (1, 17, 1), (2, 3000, 30) and (2, 1000, 130), so that kernels 1 and 4
   run at each of their payload tiles (64, 16, 16, 32, and three tiles of
   64), and at (2, 2000, 50) with row keys drawn apart from the column
   keys (``ws`` not ``sort(w)``, so kernel 1's row maximum is not -0);
   in float32 and bfloat16, m bitwise the twin's, and the last instance
   run alone against its row of the batch, bitwise; then the
   per-instance temperature case: B = 4 instances at tau = (0.05, 0.2,
   0.6, 1.0), (4, 1000, 50), each kernel against its twin at that (B,)
   tau, every row bitwise the B = 1 launch at its own tau, and one
   shared tau bitwise its expansion to B; ``kernel_times``: median times
   of each kernel, its twin, and the dense ``torch.softmax(...) @ x``
   yardstick at the main shape, with the (B,) tau the autograd Function
   hands the kernels; each kernel also as ``graph_ms``, a CUDA-graph
   replay of its wrapper call (device time, without the wrapper's host
   time that ``ms`` includes), and as ``graph_ms_shared_tau``, the call
   with one tau, its expansion to B included.
3. ``band_kernel_check`` — the same for the four banded kernels (5-8) at
   (B, N, d, K) = (8, 4096, 50, 256) (the main run's shape with
   ``band="auto"``), (2, 65536, 14, 4096) (the SOG run's shape),
   (3, 1000, 3, 40), (1, 17, 1, 3), (2, 3000, 30, 500) and
   (2, 1000, 130, 150), so that kernels 5, 7 and 8 run at each of their
   payload tiles (64, 16, 16, 16, 32, and three tiles of 64; kernel 6 has
   no payload), and the per-instance temperature case at K = 150;
   ``band_kernel_times`` at the first two shapes in float32, also as
   ``graph_ms``, with the dense yardstick at N = 4096 and the
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
   ``adaptive_run`` — ``band_main_run``'s configuration with
   ``schedule="adaptive"``, ``adapt_every=4`` and the controller's
   defaults, and ``adaptive_claim_run`` — the settings of the reference's
   adaptive rows in BENCH_scaling.json (80 rounds), beside its fixed twin
   ``adaptive_claim_run_fixed``: every instance starts dense and goes
   banded on its measured tail bound; ms per rung and per executed
   instance-round, rounds executed and saved, the controller's fired,
   stopped and switched counts per rung, the dense and banded launches
   equal to each group's rounds x inner steps, and the last-executed
   losses beside the fixed schedule's; falling losses and a better
   neighbour distance than a random layout.  ``adaptive_claim_run_pairs``
   times the claim's two schedules in alternating pairs, with no
   per-round callback, for the seconds saved.
   ``loss_block_check`` — the engine's loss in blocks of 8 instances
   bitwise the same rows of 32 at every batch size, beside the sizes at
   which one batch is not.  ``tournament_run`` — ``restart_tournament``
   on the same catalog, 4
   problems x 8 restarts, 3 rungs of 11 / 10 / 11 rounds, cull 0.5 (8 / 4
   / 2 live restarts per problem: 600 of 1024 instance-rounds), dense and
   with ``band="auto"``, beside its no-cull twin: 256 launches of each
   kernel of the tier, each winner's order and loss trace bitwise its
   twin row, the loss gaps, and the seconds of 2 alternating pairs beside
   the rounds fraction.  ``tournament_adaptive_run`` — the same at 4 x 4
   on ``adaptive_claim_run``'s schedule.  ``segment_run`` —
   ``run_round_segment`` on 8 instances: 4 chained segments bitwise one
   32-round run, and a batch at rounds 8 and 16 bitwise the chain and,
   row by row, each instance alone; dense and banded.
8. ``sog_run`` — the slice at full width: Self-Organizing Gaussians (paper
   section IV-B), 1 scene x 2 restarts of 65536 splats with 14 attributes
   on a 256 x 256 grid, ``band="auto"`` (K = 4096), 32 rounds x 8 inner
   steps; neighbour distance and the zlib codec proxy against a random
   order, and 256 launches of each banded kernel.  The scene and the
   proxy are ``synthetic_scene`` and ``plane_bytes`` of
   ``repro_torch.examples.self_organizing_gaussians``.
   ``sog_codec`` — ``repro_torch.runtime.sog_compress.compress_checkpoint``
   on two blocks of a (1024, 4096) and a (4096, 1024) weight with
   correlated columns: seconds, sog, baseline and raw bytes, and an exact
   round trip.

9. ``v1_kernel_check`` / ``v1_kernel_times`` — the v1 split forward
   (``v1_stats``, ``v1_apply``, float32) against its twins at the shapes
   of phase 2 (the row keys drawn apart from the column keys at the last),
   m bitwise the twin's, the last instance alone bitwise, and the
   per-instance temperature case; times at (8, 4096, 50), events and
   ``graph_ms``; ``v1_vs_fused``: the v1 forward
   (9a, 9b, ``colsum``) and the fused forward (``fwd_fused``, ``colsum``),
   each one CUDA graph, in graph ms at that shape.
10. ``kernel_bench`` — the port's kernel bench
    (``repro_torch.bench.kernel_bench``), its full sweep in both dtypes
    with ``--check``, in this process: one line per cell, the gate must
    pass and the ``v1_stats``, ``v1_apply`` and ``colsum`` counts must
    move.
11. ``flash_check`` / ``flash_times`` — the one-pass flash-attention
    kernel ``flash_forward`` (and its split-K merge ``flash_combine``) on
    the model layout read in place, at ``decode_splits``' split count and
    at 3 splits, at the shapes of ``tests/test_flash_attention.py``, a
    negative offset, ragged Dh (100, 30), and one attention layer of
    Mistral-NeMo-12B (32 query heads, 8 kv heads, head_dim 128, float32)
    at prefill (B = 1, T = S = 4096, causal) and decode (T = 1, S = 4096,
    ``q_offset = 4095``): m and l against the stats twin, o against the
    apply twin fed the kernel's m and l and against the one-pass twin at
    the same splits; ``flash_combine`` against its twin on the decode
    step's own partials; ``flash_function_check``: ``flash_attention``
    against ``flash_attention_ref``, values and dq, dk, dv, at a small GQA
    shape; times at the NeMo shapes with the yardstick
    ``scaled_dot_product_attention`` (float32, TF32 off), decode both
    warm and with the L2 cache flushed before each launch.
12. ``flash_main_run`` — that NeMo layer's attention through
    ``flash_attention``, prefill then one decode step, against the oracle,
    the decode row against the prefill's last row; 2 launches of
    ``flash_forward`` and 1 of ``flash_combine`` (the decode step's).

Phases 9 and 11 run right after phase 3, so that a faulty kernel stops
the script before the long runs; 10 and 12 run after phase 8.

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
T0 = time.perf_counter()
SOFTSORT_CU = "src/repro_torch/kernels/csrc/softsort_apply.cu"
FLASH_CU = "src/repro_torch/kernels/csrc/flash_attention.cu"
REPLACES = {
    "fwd_fused": "src/repro/kernels/softsort_apply.py:150",
    "colsum": "src/repro/kernels/softsort_apply.py:182",
    "bwd_dws_delta": "src/repro/kernels/softsort_apply.py:280",
    "bwd_dx": "src/repro/kernels/softsort_apply.py:324",
    "fwd_band": "src/repro/kernels/softsort_apply.py:517",
    "colsum_band": "src/repro/kernels/softsort_apply.py:567",
    "bwd_band_dws_delta": "src/repro/kernels/softsort_apply.py:657",
    "bwd_band_dcol": "src/repro/kernels/softsort_apply.py:706",
    "v1_stats": "src/repro/kernels/softsort_apply.py:843",
    "v1_apply": "src/repro/kernels/softsort_apply.py:862",
    "flash_forward": "src/repro/kernels/flash_attention.py:42, "
                     "src/repro/kernels/flash_attention.py:62",
    "flash_combine": "src/repro/kernels/flash_attention.py:42, "
                     "src/repro/kernels/flash_attention.py:62",
}
DENSE = ("fwd_fused", "colsum", "bwd_dws_delta", "bwd_dx")
BAND = ("fwd_band", "colsum_band", "bwd_band_dws_delta", "bwd_band_dcol")
V1 = ("v1_stats", "v1_apply")
FLASH = ("flash_forward", "flash_combine")
FWD_ATOL, GRAD_RTOL, BF16_RTOL = 2e-5, 1e-4, 2e-2
SHAPES = [(8, 4096, 50), (3, 1000, 3), (1, 17, 1)]
MAIN_SHAPE = SHAPES[0]
# kernel_check: SHAPES, DT = 32 and three payload tiles of 64, then the
# shape run with row keys drawn apart from the column keys.
DENSE_SHAPES = SHAPES + [(2, 3000, 30), (2, 1000, 130)]
INDEPENDENT_SHAPE = (2, 2000, 50)
BAND_SHAPES = [(8, 4096, 50, 256), (2, 65536, 14, 4096), (3, 1000, 3, 40),
               (1, 17, 1, 3), (2, 3000, 30, 500), (2, 1000, 130, 150)]
BAND_TIMED = BAND_SHAPES[:2]
SOG_SHAPE = BAND_SHAPES[1]       # the shape of the slice's main path
TAU = 0.5
# The per-instance temperature case: B = 4 instances, each at its own tau.
TAUS4 = (0.05, 0.2, 0.6, 1.0)
TAU_SHAPE = (4, 1000, 50)
TAU_BAND = 150
# (B, Tq, S, H, Hkv, Dh, causal, q_offset): the cases of
# tests/test_flash_attention.py, a negative offset and ragged Dh, then one
# Mistral-NeMo-12B attention layer (src/repro/configs/mistral_nemo_12b.py)
# at prefill and at decode.
FLASH_SHAPES = [(2, 64, 64, 4, 2, 32, True, 0),
                (1, 100, 100, 5, 5, 16, True, 0),
                (2, 1, 128, 8, 2, 64, True, 127),
                (2, 48, 80, 6, 3, 32, False, 0),
                (1, 256, 256, 2, 1, 128, True, 0),
                (1, 70, 90, 4, 1, 100, True, -5),
                (1, 50, 300, 6, 2, 30, True, 3)]
NEMO_PREFILL = (1, 4096, 4096, 32, 8, 128, True, 0)
NEMO_DECODE = (1, 1, 4096, 32, 8, 128, True, 4095)
NEMO_CUTS = ["context 128k -> 4096 keys, for time",
             "one layer's attention of 40, not the model"]


def emit(phase, **fields):
    print(json.dumps({"phase": phase, "t": time.perf_counter() - T0,
                      **fields}), flush=True)


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


def time_ms(torch, fn, reps=15, warmup=3, flush=None):
    """Median milliseconds of ``fn()`` on the card, by CUDA events.
    ``flush``, when given, runs before each launch, outside the timed
    span."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def timed(torch, fn):
    """(host seconds, result) of ``fn()`` on the card, ended by a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def graph_ms(torch, fn, reps=15, flush=None):
    """Median milliseconds of one replay of a CUDA graph of ``fn()``: the
    device time of its launches, without the host's Python and dispatch
    time between them (which an eager call of a ~10 us kernel is mostly
    made of).  ``flush`` as in ``time_ms``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, reps, flush=flush)


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


def kernel_operands(torch, bsz, n, d, cd, seed, independent=False):
    """Untied keys: a random permutation of 0..N-1 jittered by < 0.4, as
    the anneal's keys start from arange(N).  The row keys are sort(w), or
    with ``independent`` another such draw, sorted."""
    g = torch.Generator().manual_seed(seed)

    def keys():
        w = torch.stack([torch.randperm(n, generator=g).float()
                         for _ in range(bsz)])
        return w + 0.8 * (torch.rand(bsz, n, generator=g) - 0.5)

    w = keys()
    ws = torch.sort(keys() if independent else w, dim=-1, stable=True).values
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


def dense_twins(K, outs, ws, w, x, tau, dy, dc):
    """The four dense twins, fed the kernels' own y, m, l and D."""
    y, m, l, _, D = outs[:5]
    return (*K.fwd_fused_plain(ws, w, x, tau),
            K.colsum_plain(ws, w, tau, m, l, x.dtype),
            *K.bwd_dws_delta_plain(ws, w, x, tau, m, l, dy, y, dc),
            *K.bwd_dx_plain(ws, w, x, tau, m, l, dy, dc, D))


def band_twins(K, outs, ws, xs, tau, dy, dc, k):
    """The four banded twins, fed the kernels' own y, m, l and D."""
    y, m, l, _, D = outs[:5]
    return (*K.fwd_band_plain(ws, xs, tau, k),
            K.colsum_band_plain(ws, tau, m, l, k, xs.dtype),
            *K.bwd_band_dws_delta_plain(ws, xs, tau, m, l, dy, y, dc, k),
            *K.bwd_band_dcol_plain(ws, xs, tau, m, l, dy, dc, D, k))


def per_instance_tau_case(torch, K, kind):
    """The per-instance temperature case of ``kernel_check`` (``kind``
    "dense"), ``band_kernel_check`` ("banded", K = TAU_BAND) and
    ``v1_kernel_check`` ("v1", float32): B = 4 instances at TAUS4, every
    kernel reading its instance's tau[b].  Each kernel against its twin
    at the same (B,) tau; row b bitwise the B = 1 launch at tau_b; one
    shared tau bitwise its expansion to B."""
    bsz, n, d = TAU_SHAPE
    phase = {"dense": "kernel_check", "banded": "band_kernel_check",
             "v1": "v1_kernel_check"}[kind]
    dtypes = ((torch.float32,) if kind == "v1"
              else (torch.float32, torch.bfloat16))
    for cd in dtypes:
        ws, w, x, _, dy, dc = kernel_operands(torch, bsz, n, d, cd, seed=91)
        taus = torch.tensor(TAUS4, device="cuda")
        if kind == "dense":
            ops = (ws, w, x, dy, dc)

            def run(o, t):
                return kernel_pipeline(K, o[0], o[1], o[2], t, o[3], o[4])

            def twins(outs):
                return dense_twins(K, outs, ws, w, x, taus, dy, dc)
        elif kind == "banded":
            ops = (ws, x, dy, dc)

            def run(o, t):
                return band_pipeline(K, o[0], o[1], t, o[2], o[3], TAU_BAND)

            def twins(outs):
                return band_twins(K, outs, ws, x, taus, dy, dc, TAU_BAND)
        else:
            ops = (ws, w, x)

            def run(o, t):
                return v1_pipeline(K, o[0], o[1], o[2], t)

            def twins(outs):
                return (*K.v1_stats_plain(ws, w, taus),
                        K.v1_apply_plain(ws, w, x, taus, outs[0], outs[1]))
        outs = run(ops, taus)
        want = twins(outs)
        torch.cuda.synchronize()
        if kind == "v1":
            errs = {"v1_stats": max(check("m", outs[0], want[0],
                                          atol=FWD_ATOL),
                                    check("l", outs[1], want[1],
                                          rtol=FWD_ATOL)),
                    "v1_apply": check("y", outs[2], want[2], atol=FWD_ATOL)}
        else:
            names = DENSE if kind == "dense" else BAND
            errs = {k: max(v) for k, v in zip(names, kernel_errors(
                outs, want, cd == torch.float32))}
        for b in range(bsz):
            alone = run([t[b:b + 1].contiguous() for t in ops],
                        taus[b:b + 1])
            for got, row in zip(alone, outs):
                require(torch.equal(got[0], row[b]),
                        f"{kind}: instance {b} alone at its tau != its row")
        shared = run(ops, taus[2:3])
        expanded = run(ops, taus[2:3].expand(bsz).contiguous())
        for a, e in zip(shared, expanded):
            require(torch.equal(a, e), f"{kind}: one tau != its expansion")
        emit(phase, shape=[bsz, n, d] + ([TAU_BAND] if kind == "banded"
                                         else []),
             dtype=str(cd), tau=list(TAUS4), max_abs_err=errs,
             batch_invariant=True, shared_tau_equals_expanded=True)


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
    from repro_torch.kernels.bounds import bound_ms

    for name, (kern, plain) in zip(names, calls):
        stats[name]["ms"] = time_ms(torch, kern)
        stats[name]["plain_ms"] = time_ms(torch, plain, reps=5)
        stats[name]["library_ms"] = None
        stats[name]["bound_ms"], stats[name]["bound_by"] = bound_ms(
            name, *shape)
        stats[name]["shape"] = list(shape)


def kernel_phase(torch, K):
    """Phase 2: every dense kernel against its twin; times at the main
    shape; then the per-instance temperature case."""
    stats = {k: {"max_abs_err": 0.0} for k in DENSE}
    cases = [(s, False) for s in DENSE_SHAPES] + [(INDEPENDENT_SHAPE, True)]
    for (bsz, n, d), independent in cases:
        for cd in (torch.float32, torch.bfloat16):
            f32 = cd == torch.float32
            ws, w, x, tau, dy, dc = kernel_operands(
                torch, bsz, n, d, cd, seed=n + d, independent=independent)
            outs = kernel_pipeline(K, ws, w, x, tau, dy, dc)
            y, m, l, c, D, dws, dx, dwc, dtc = outs
            twins = dense_twins(K, outs, ws, w, x, tau, dy, dc)
            torch.cuda.synchronize()
            # Kernel 1's first sweep takes the maximum of the same rounded
            # scores as the twin's running maximum: equal bitwise.
            require(torch.equal(m, twins[1]), "m differs from the twin's")
            require(independent == bool((m < 0).any()),
                    "row maxima: -0 exactly when ws is sort(w)")
            require_batch_invariant(
                torch, lambda *a: kernel_pipeline(K, *a),
                (ws, w, x, tau, dy, dc), outs)
            errs = dict(zip(DENSE, kernel_errors(outs, twins, f32)))
            emit("kernel_check", shape=[bsz, n, d], dtype=str(cd),
                 independent_keys=independent,
                 max_abs_err={k: max(v) for k, v in errs.items()},
                 batch_invariant=True)
            if not (f32 and (bsz, n, d) == MAIN_SHAPE and not independent):
                continue
            for k, v in errs.items():
                stats[k]["max_abs_err"] = max(v)

            def calls_at(t):
                return [
                    (lambda: K.fwd_fused(ws, w, x, t),
                     lambda: K.fwd_fused_plain(ws, w, x, t)),
                    (lambda: K.colsum(ws, w, t, m, l),
                     lambda: K.colsum_plain(ws, w, t, m, l)),
                    (lambda: K.bwd_dws_delta(ws, w, x, t, m, l, dy, y, dc),
                     lambda: K.bwd_dws_delta_plain(ws, w, x, t, m, l, dy, y,
                                                   dc)),
                    (lambda: K.bwd_dx(ws, w, x, t, m, l, dy, dc, D),
                     lambda: K.bwd_dx_plain(ws, w, x, t, m, l, dy, dc, D)),
                ]

            # Timed with the (B,) tau the autograd Function hands the
            # kernels; graph_ms_shared_tau captures the (1,) tau call,
            # its expansion to B included.
            calls = calls_at(tau.expand(bsz).contiguous())
            time_kernels(torch, stats, DENSE, calls, (bsz, n, d))
            for k, (kern, _) in zip(DENSE, calls):
                stats[k]["graph_ms"] = graph_ms(torch, kern)
            for k, (kern, _) in zip(DENSE, calls_at(tau)):
                stats[k]["graph_ms_shared_tau"] = graph_ms(torch, kern)
            inv_tau = 1.0 / tau

            def library_fwd():   # yardstick only: the port never calls it
                s = -(ws[:, :, None] - w[:, None, :]).abs() * inv_tau
                return torch.softmax(s, dim=-1) @ x

            stats["fwd_fused"]["library_ms"] = time_ms(torch, library_fwd,
                                                       reps=5)
            emit("kernel_times", shape=[bsz, n, d], dtype=str(cd),
                 times=stats)
    per_instance_tau_case(torch, K, "dense")
    return stats


def band_kernel_phase(torch, K, core):
    """Phase 3: every banded kernel against its twin at the six shapes;
    times at the first two; then the per-instance temperature case.
    Returns the stats of each timed shape."""
    timed = {}
    for bsz, n, d, k in BAND_SHAPES:
        for cd in (torch.float32, torch.bfloat16):
            f32 = cd == torch.float32
            ws, _, xs, tau, dy, dc = kernel_operands(torch, bsz, n, d, cd,
                                                     seed=n + d + k)
            outs = band_pipeline(K, ws, xs, tau, dy, dc, k)
            y, m, l, c, D, dws, dxs, dwc, dtc = outs
            twins = band_twins(K, outs, ws, xs, tau, dy, dc, k)
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

            def calls_at(t):
                return [
                    (lambda: K.fwd_band(ws, xs, t, k),
                     lambda: K.fwd_band_plain(ws, xs, t, k)),
                    (lambda: K.colsum_band(ws, t, m, l, k),
                     lambda: K.colsum_band_plain(ws, t, m, l, k)),
                    (lambda: K.bwd_band_dws_delta(ws, xs, t, m, l, dy, y, dc,
                                                  k),
                     lambda: K.bwd_band_dws_delta_plain(ws, xs, t, m, l, dy,
                                                        y, dc, k)),
                    (lambda: K.bwd_band_dcol(ws, xs, t, m, l, dy, dc, D, k),
                     lambda: K.bwd_band_dcol_plain(ws, xs, t, m, l, dy, dc,
                                                   D, k)),
                ]

            # The (B,) tau of the autograd Function, as in kernel_phase.
            calls = calls_at(tau.expand(bsz).contiguous())
            time_kernels(torch, stats, BAND, calls, (bsz, n, d, k))
            for kk, (kern, _) in zip(BAND, calls):
                stats[kk]["graph_ms"] = graph_ms(torch, kern)
            for kk, (kern, _) in zip(BAND, calls_at(tau)):
                stats[kk]["graph_ms_shared_tau"] = graph_ms(torch, kern)
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
    per_instance_tau_case(torch, K, "banded")
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
    Returns the catalog, the launch counts of the dense main run, and the
    all-banded run's result and timing (the fixed schedule that
    ``adaptive_run`` is held against)."""
    from repro_torch.core.shufflesoftsort import _band_switch_round
    from repro_torch.examples.image_grid_sorting import synthetic_catalog

    b, s, hw, d = 4, 2, (64, 64), 50
    n = hw[0] * hw[1]
    rounds, inner = 32, 8
    xs = np.stack([synthetic_catalog(n, d, clusters=24, seed=i)[0]
                   for i in range(b)])
    nbr_before = [core.mean_neighbor_distance(xs[i], hw) for i in range(b)]
    per_step = rounds * inner
    dense_counts = fixed = None
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
        else:
            fixed = res, timing

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
    return xs, dense_counts, fixed


# The adaptive runs on the catalog of phases 5-7 (4 problems x 2 restarts,
# N = 4096, d = 50, 64 x 64, band="auto", 8 inner steps, float32):
# "adaptive_run" is band_main_run's configuration (32 rounds) with
# adapt_every=4 and the controller's defaults; "adaptive_claim_run" has
# the settings of the reference's adaptive rows in BENCH_scaling.json
# (80 rounds, tau_end 0.02, adapt_every 5, patience 1, plateau_rtol 0.02,
# decay_rungs 2), whose claim (about 30% of the rounds saved at under 1%
# final-loss gap, on the CPU at N = 64 and 256) it checks at N = 4096.
ADAPTIVE_RUNS = {
    "adaptive_run": dict(rounds=32, adapt_every=4),
    "adaptive_claim_run": dict(rounds=80, tau_end=0.02, adapt_every=5,
                               patience=1, plateau_rtol=0.02,
                               decay_rungs=2),
}


def adaptive_run(torch, core, K, xs, fixed, phase, hw=(64, 64)):
    """Phase 6b: one of ADAPTIVE_RUNS through
    ``shuffle_soft_sort_batched``, against ``fixed``, the result and
    timing of the same configuration on the fixed schedule.  The
    controller's rung decisions and the ragged dispatches (which group,
    how many instances and rounds) are read through two spies on the
    engine; the kernels count their own launches.  Checks: every dense
    and banded launch accounted for by the groups' rounds x inner steps,
    valid permutations, every instance's last-executed loss below its
    round-0 loss, and each winner's neighbour distance below a random
    layout's.  Reports ms per rung and per executed instance-round,
    rounds executed and saved, and the last-executed losses beside the
    fixed schedule's."""
    import importlib

    eng = importlib.import_module("repro_torch.core.shufflesoftsort")
    b, s = xs.shape[0], 2
    n = hw[0] * hw[1]
    cfg = adaptive_config(core, phase)
    rounds, inner = cfg.rounds, cfg.inner_steps
    made, groups, stamps = [], [], []
    make, ragged = eng.make_adaptive_controller, eng._run_rounds_ragged

    def make_spy(*args, **kw):
        ctrl = make(*args, **kw)
        observe = ctrl.observe

        def stamped(*a, **k):
            stamps.append(time.perf_counter())   # after the rung's sync
            return observe(*a, **k)

        ctrl.observe = stamped
        made.append(ctrl)
        return ctrl

    def ragged_spy(xs_, orders, source, rows, tau_rows, norms, **kw):
        groups.append({"rung": len(made[0].decisions) + 1,
                       "banded": kw["apply_fn"].func.__name__
                       == "softsort_apply_banded",
                       "instances": len(rows), "rounds": len(tau_rows)})
        return ragged(xs_, orders, source, rows, tau_rows, norms, **kw)

    emit(phase + "_config", problems=b, restarts=s, n=n, d=xs.shape[2],
         grid=hw, rounds=rounds, inner_steps=inner, band="auto",
         band_k=core.resolve_band(cfg, n), tau_end=cfg.tau_end,
         adapt_every=cfg.adapt_every, patience=cfg.patience,
         plateau_rtol=cfg.plateau_rtol, decay_rungs=cfg.decay_rungs,
         ewma_alpha=cfg.ewma_alpha, compute_dtype=cfg.compute_dtype)
    eng.make_adaptive_controller, eng._run_rounds_ragged = make_spy, \
        ragged_spy
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        res = core.shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s,
                                             seed=0, device="cuda")
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        counts = K.launch_counts()
    finally:
        eng.make_adaptive_controller, eng._run_rounds_ragged = make, ragged
    (ctrl,) = made
    want = {k: 0 for k in DENSE + BAND}
    for g in groups:
        for k in (BAND if g["banded"] else DENSE):
            want[k] += g["rounds"] * inner
    require_counts(counts, want)
    for row in res.all_orders.reshape(-1, n):
        require(core.is_valid_permutation(row), "invalid permutation")
    executed = res.rounds_executed.reshape(-1)
    losses = res.all_losses.reshape(b * s, rounds)
    first = losses[:, 0]
    last = losses[np.arange(b * s), executed - 1]
    require(np.isfinite(last).all() and (last < first).all(),
            f"loss did not fall: {first} -> {last}")
    require(int((~np.isnan(losses)).sum()) == int(executed.sum()),
            "losses past an early stop are not NaN")
    rng = np.random.RandomState(1)
    nbr_random = [neighbor_distance(xs[i][rng.permutation(n)], hw)
                  for i in range(b)]
    nbr_sorted = [neighbor_distance(res.sorted[i], hw) for i in range(b)]
    require(all(a < r for a, r in zip(nbr_sorted, nbr_random)),
            f"neighbour distance: {nbr_random} -> {nbr_sorted}")
    fixed_res, fixed_timing = fixed
    fixed_last = fixed_res.all_losses.reshape(b * s, rounds)[:, -1]
    rung_ms = np.diff([t0] + stamps) * 1e3
    emit(phase, seconds=total,
         ms_per_rung=rung_ms.tolist(),
         ms_per_instance_round=total * 1e3 / int(executed.sum()),
         rounds_executed=executed.tolist(),
         rounds_saved=ctrl.rounds_saved(),
         rounds_saved_fraction=ctrl.rounds_saved() / (b * s * rounds),
         rungs=[dict(step=d.step, boundary=d.boundary, live=d.n_live,
                     fired=d.fired, stopped=d.stopped, switched=d.switched)
                for d in ctrl.decisions],
         groups=groups, launches=counts,
         loss_last_executed=last.tolist(), loss_fixed=fixed_last.tolist(),
         loss_gap_vs_fixed=((last - fixed_last) / fixed_last).tolist(),
         fixed_seconds=fixed_timing["seconds"],
         fixed_ms_per_round=fixed_timing["ms_per_round"],
         best_restart=res.best_restart.tolist(),
         neighbor_distance_random=nbr_random,
         neighbor_distance_sorted=nbr_sorted)


def sog_run(torch, core, K):
    """Phase 8: the slice at full width, the paper's section IV-B
    workload.  Returns the launch counts."""
    from repro_torch.core.shufflesoftsort import _band_switch_round
    from repro_torch.examples.self_organizing_gaussians import (
        plane_bytes,
        synthetic_scene,
    )

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


# Alternating fixed / adaptive pairs timed for adaptive_claim_run's
# seconds saved.
CLAIM_PAIRS = 4


def run_seconds(torch, core, xs, hw, cfg):
    """Host seconds of one ``shuffle_soft_sort_batched`` run (2 restarts,
    no per-round callback) on the card."""
    return timed(torch, lambda: core.shuffle_soft_sort_batched(
        xs, hw, cfg, n_restarts=2, seed=0, device="cuda"))[0]


def adaptive_config(core, phase):
    """The config of one of ADAPTIVE_RUNS (``schedule="adaptive"``)."""
    return core.ShuffleSoftSortConfig(inner_steps=8, use_kernel=True,
                                      band="auto", schedule="adaptive",
                                      **ADAPTIVE_RUNS[phase])


def adaptive_phases(torch, core, K, xs, band_fixed, hw=(64, 64)):
    """Phase 6b: both ADAPTIVE_RUNS.  ``adaptive_run`` is held against
    ``band_main_run`` (its configuration on the fixed schedule);
    ``adaptive_claim_run`` against a fixed run of its own configuration,
    made here, and then timed against it in CLAIM_PAIRS alternating
    pairs."""
    import dataclasses

    adaptive_run(torch, core, K, xs, band_fixed, "adaptive_run", hw)
    phase = "adaptive_claim_run"
    cfg = dataclasses.replace(adaptive_config(core, phase),
                              schedule="fixed")
    res, counts, timing = anneal(torch, core, K, xs, hw, cfg, 2)
    emit(phase + "_fixed", **timing)
    adaptive_run(torch, core, K, xs, (res, timing), phase, hw)
    # Seconds saved from alternating pairs, neither run with a per-round
    # callback: one run of each differs from the next by about as much
    # as the saving (host-bound rounds).
    adapt = adaptive_config(core, phase)
    fixed_s, adapt_s = [], []
    for _ in range(CLAIM_PAIRS):
        fixed_s.append(run_seconds(torch, core, xs, hw, cfg))
        adapt_s.append(run_seconds(torch, core, xs, hw, adapt))
    saved = [1 - a / f for f, a in zip(fixed_s, adapt_s)]
    emit(phase + "_pairs", fixed_seconds=fixed_s, adaptive_seconds=adapt_s,
         seconds_saved_fraction=saved,
         median_seconds_saved_fraction=float(np.median(saved)))


# The tournament phases on the catalog of phases 5-7 (4 problems, N =
# 4096, d = 50, 64 x 64, float32, the kernel tier).  tournament_run: the
# reference's tournament sweep settings (EXPERIMENTS.md section Scaling:
# 8 restarts, 3 rungs, cull 0.5) at main_run's 32 rounds x 8 inner steps:
# rungs of 11 / 10 / 11 rounds with 8 / 4 / 2 live restarts per problem,
# 600 of the no-cull twin's 1024 instance-rounds.  tournament_adaptive_run:
# adaptive_claim_run's settings at 4 restarts, 3 rungs of controller
# steps, cull 0.5.
TOURNAMENT = dict(restarts=8, n_rungs=3, cull_fraction=0.5)
ADAPTIVE_TOURNAMENT = dict(restarts=4, n_rungs=3, cull_fraction=0.5)
# Alternating tournament / twin pairs timed for the seconds fraction.
TOURNAMENT_PAIRS = 2


def last_executed(row):
    """The last non-NaN loss of a loss trace."""
    return float(row[~np.isnan(row)][-1])


def require_winners(core, res, twin):
    """Each winner is a valid permutation, ends below its round-0 loss,
    is in the last survivor set, and its order and loss trace are bitwise
    its row of the no-cull twin.  Returns each problem's loss gap against
    the twin's best restart."""
    gaps = []
    for p in range(res.order.shape[0]):
        w = int(res.best_restart[p])
        trace = res.all_losses[p, w]
        require(core.is_valid_permutation(res.order[p]),
                f"problem {p}: invalid permutation")
        require(res.final_loss[p] < trace[0],
                f"problem {p}: loss did not fall: {trace[0]} -> "
                f"{res.final_loss[p]}")
        require(w in res.survivors[-1][p],
                f"problem {p}: winner {w} not in {res.survivors[-1][p]}")
        require(np.array_equal(res.order[p], twin.all_orders[p, w]),
                f"problem {p}: the winner's order is not its twin row's")
        require(np.array_equal(trace, twin.all_losses[p, w], equal_nan=True),
                f"problem {p}: the winner's loss trace is not its twin "
                f"row's")
        best = last_executed(twin.losses[p])
        gaps.append((float(res.final_loss[p]) - best) / best)
    return gaps


def timed_pairs(torch, tournament, twin):
    """TOURNAMENT_PAIRS alternating (tournament, twin) timings, neither
    with a per-round callback; returns both lists of seconds."""
    tour_s, twin_s = [], []
    for i in range(TOURNAMENT_PAIRS):
        runs = [(tournament, tour_s), (twin, twin_s)]
        for fn, out in (runs if i % 2 == 0 else runs[::-1]):
            out.append(timed(torch, fn)[0])
    return tour_s, twin_s


def loss_block_check(torch, hw=(64, 64), d=50, full=32):
    """Phase 7a: why the engine evaluates the loss in blocks of 8
    instances.  ``full`` random instances at the catalog's shape; for each
    batch of the first B of them, the loss values and their gradients
    against y and colsum, computed as one batch (``grid_sorting_loss``)
    and as the engine's padded blocks (``_loss_fn`` with ``pad_rows``),
    each row against its row of the full batch computed the same way.
    Reports the batch sizes at which one batch differs (PyTorch's CUDA
    reductions choose their split from the number of rows); requires the
    blocks bitwise at every size."""
    import importlib

    from repro_torch.core.losses import grid_sorting_loss

    eng = importlib.import_module("repro_torch.core.shufflesoftsort")
    n = hw[0] * hw[1]
    g = torch.Generator().manual_seed(17)
    y = torch.randn(full, n, d, generator=g).to("cuda")
    x = torch.randn(full, n, d, generator=g).to("cuda")
    c = (1 + 0.1 * torch.randn(full, n, generator=g)).to("cuda")
    norm = (1 + torch.rand(full, generator=g)).to("cuda")
    cfg = eng.ShuffleSoftSortConfig()
    ident = torch.arange(n, device="cuda").expand(full, n)

    def run(b, blocked):
        yv = y[:b].clone().requires_grad_(True)
        cv = c[:b].clone().requires_grad_(True)
        if blocked:
            loss = eng._loss_fn(None, x[:b], ident[:b], None, hw, norm[:b],
                                cfg, lambda w, xs_, t: (yv, cv),
                                pad_rows=True)
        else:
            loss = grid_sorting_loss(yv, cv, x[:b], hw, norm[:b])
        return (loss.detach(), *torch.autograd.grad(loss.sum(), (yv, cv)))

    sizes = (1, 2, 4, 8, 12, 16, 24)
    differs = {}
    for blocked in (False, True):
        ref = run(full, blocked)
        out = {k: [] for k in ("value", "grad_y", "grad_colsum")}
        for b in sizes:
            for k, got, want in zip(out, run(b, blocked), ref):
                if not torch.equal(got, want[:b]):
                    out[k].append(b)
        differs["blocks" if blocked else "one_batch"] = out
    require(not any(differs["blocks"].values()),
            f"the loss blocks are not batch-invariant: {differs['blocks']}")
    emit("loss_block_check", shape=[full, n, d], sizes=list(sizes),
         differs_from_full_batch_at=differs)


def tournament_run(torch, core, K, xs, hw=(64, 64)):
    """Phase 7b: ``restart_tournament`` on the fixed schedule, dense
    (kernels 1-4) and with ``band="auto"`` (K = 256, kernels 5-8), each
    beside its no-cull twin, ``shuffle_soft_sort_batched`` on the same 32
    instances with the same seeds.  Counts set to 0 just before the
    tournament and read just after: every kernel of the tier launches
    once per inner step of every round (the batch shrinks, the launches
    do not).  Checks the rounds fraction, the survivor counts and the
    winners (``require_winners``); reports the loss gaps, the host ms per
    round of each rung, and the seconds of TOURNAMENT_PAIRS alternating
    pairs beside the rounds fraction."""
    t = TOURNAMENT
    b, s, n = xs.shape[0], t["restarts"], hw[0] * hw[1]
    rounds, inner = 32, 8
    rung_rounds, live = (11, 10, 11), (8, 4, 2)
    want_run = sum(r * b * k for r, k in zip(rung_rounds, live))   # 600
    for band in (None, "auto"):
        cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner,
                                         use_kernel=True, band=band)
        emit("tournament_run_config", problems=b, n=n,
             d=xs.shape[2], grid=hw, rounds=rounds, inner_steps=inner,
             band=band, band_k=core.resolve_band(cfg, n),
             compute_dtype=cfg.compute_dtype, rung_rounds=rung_rounds,
             live_restarts=live, **t,
             source="EXPERIMENTS.md section Scaling, the reference's "
                    "tournament sweep (S = 8, 3 rungs, cull 0.5), at "
                    "N = 4096")

        def tournament(hook=None):
            return core.restart_tournament(
                xs, hw, cfg, n_restarts=s, seed=0, device="cuda",
                cull_fraction=t["cull_fraction"], n_rungs=t["n_rungs"],
                rung_hook=hook)

        def twin():
            return core.shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s,
                                                  seed=0, device="cuda")

        stamps = []
        torch.cuda.synchronize()
        K.reset_launch_counts()
        seconds, res = timed(torch, lambda: tournament(
            lambda start: stamps.append(time.perf_counter())))
        end = time.perf_counter()
        counts = K.launch_counts()
        on, off = (DENSE, BAND) if band is None else (BAND, DENSE)
        require_counts(counts, {**{k: rounds * inner for k in on},
                                **{k: 0 for k in off}})
        require(res.rounds_run == want_run
                and res.rounds_full == b * s * rounds,
                f"rounds_run {res.rounds_run} / {res.rounds_full}")
        require([sv.shape for sv in res.survivors]
                == [(b, k) for k in live[1:] + live[-1:]],
                "survivor counts after each rung")
        twin_seconds, twin_res = timed(torch, twin)
        gaps = require_winners(core, res, twin_res)
        rung_ms = np.diff(stamps + [end]) * 1e3
        tour_s, twin_s = timed_pairs(torch, tournament, twin)
        fractions = [a / w for a, w in zip(tour_s, twin_s)]
        emit("tournament_run", band=band, rounds_run=res.rounds_run,
             rounds_full=res.rounds_full,
             rounds_fraction=res.rounds_run / res.rounds_full,
             seconds_first=seconds, twin_seconds_first=twin_seconds,
             ms_per_round_by_rung=(rung_ms / rung_rounds).tolist(),
             tournament_seconds=tour_s, twin_seconds=twin_s,
             seconds_fraction=fractions,
             median_seconds_fraction=float(np.median(fractions)),
             survivors=[sv.tolist() for sv in res.survivors],
             best_restart=res.best_restart.tolist(),
             final_loss=res.final_loss.tolist(),
             twin_best_loss=[last_executed(r) for r in twin_res.losses],
             loss_gap_vs_twin_best=gaps, winners_bitwise_twin=True,
             launches=counts)


def tournament_adaptive_run(torch, core, K, xs, hw=(64, 64)):
    """Phase 7c: ``restart_tournament`` with adaptive_claim_run's
    configuration at 4 problems x 4 restarts, 3 rungs of controller steps,
    cull 0.5, beside its no-cull adaptive twin.  The ragged dispatches are
    read through a spy on the engine, and every dense and banded launch
    must be accounted for by the groups' rounds x inner steps; the winners
    as in ``require_winners``.  Reports the instance-rounds run against
    the twin's and against ``rounds_full``, the culls per edge, and the
    seconds of TOURNAMENT_PAIRS alternating pairs."""
    import importlib

    eng = importlib.import_module("repro_torch.core.shufflesoftsort")
    t = ADAPTIVE_TOURNAMENT
    b, s, n = xs.shape[0], t["restarts"], hw[0] * hw[1]
    cfg = adaptive_config(core, "adaptive_claim_run")
    emit("tournament_adaptive_run_config", problems=b, n=n,
         d=xs.shape[2], grid=hw, rounds=cfg.rounds,
         inner_steps=cfg.inner_steps, band="auto",
         band_k=core.resolve_band(cfg, n), tau_end=cfg.tau_end,
         adapt_every=cfg.adapt_every, patience=cfg.patience,
         plateau_rtol=cfg.plateau_rtol, decay_rungs=cfg.decay_rungs,
         compute_dtype=cfg.compute_dtype, **t)

    def tournament():
        return core.restart_tournament(
            xs, hw, cfg, n_restarts=s, seed=0, device="cuda",
            cull_fraction=t["cull_fraction"], n_rungs=t["n_rungs"])

    def twin():
        return core.shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s,
                                              seed=0, device="cuda")

    groups, ragged = [], eng._run_rounds_ragged

    def ragged_spy(xs_, orders, source, rows, tau_rows, norms, **kw):
        groups.append((kw["apply_fn"].func.__name__
                       == "softsort_apply_banded", len(rows), len(tau_rows)))
        return ragged(xs_, orders, source, rows, tau_rows, norms, **kw)

    eng._run_rounds_ragged = ragged_spy
    try:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        seconds, res = timed(torch, tournament)
        counts = K.launch_counts()
    finally:
        eng._run_rounds_ragged = ragged
    want = {k: 0 for k in DENSE + BAND}
    for banded, _, rounds in groups:
        for k in (BAND if banded else DENSE):
            want[k] += rounds * cfg.inner_steps
    require_counts(counts, want)
    require(res.rounds_run == sum(k * r for _, k, r in groups)
            == int((~np.isnan(res.all_losses)).sum()),
            f"rounds_run {res.rounds_run} is not the rounds executed")
    twin_seconds, twin_res = timed(torch, twin)
    gaps = require_winners(core, res, twin_res)
    twin_rounds = int(twin_res.rounds_executed.sum())
    widths = [s] + [sv.shape[1] for sv in res.survivors]
    tour_s, twin_s = timed_pairs(torch, tournament, twin)
    fractions = [a / w for a, w in zip(tour_s, twin_s)]
    emit("tournament_adaptive_run", rounds_run=res.rounds_run,
         twin_rounds_executed=twin_rounds, rounds_full=res.rounds_full,
         rounds_vs_twin=res.rounds_run / twin_rounds,
         rounds_fraction=res.rounds_run / res.rounds_full,
         culls_per_edge=[b * (w0 - w1) for w0, w1 in
                         zip(widths[:-1], widths[1:])],
         seconds_first=seconds, twin_seconds_first=twin_seconds,
         tournament_seconds=tour_s, twin_seconds=twin_s,
         seconds_fraction=fractions,
         median_seconds_fraction=float(np.median(fractions)),
         dispatches=len(groups),
         survivors=[sv.tolist() for sv in res.survivors],
         best_restart=res.best_restart.tolist(),
         final_loss=res.final_loss.tolist(),
         twin_best_loss=[last_executed(r) for r in twin_res.losses],
         loss_gap_vs_twin_best=gaps, winners_bitwise_twin=True,
         launches=counts)


def segment_run(torch, core, K, xs, hw=(64, 64)):
    """Phase 7d: ``run_round_segment`` on 8 catalog instances (each
    problem twice), dense and with ``band="auto"``, segments of 8 of 32
    rounds.  Checks, bitwise: 4 chained segments against one 32-round
    ``_run_rounds`` of the same instances and streams; a batch whose
    progress is spread over two rung multiples (rounds 8 and 16) against
    the chain's segments at those rounds, and row by row against each
    instance run alone.  Counts set to 0 just before the chain and read
    just after: every kernel of the tier once per inner step."""
    from repro_torch.core.prng import (ReplayShuffleSource,
                                       TorchShuffleSource, instance_seeds)
    from repro_torch.core.shufflesoftsort import _run_rounds

    seg, rounds, inner, bs = 8, 32, 8, 8
    n = hw[0] * hw[1]
    x8 = torch.as_tensor(np.repeat(xs, 2, axis=0), device="cuda")
    norms = torch.stack([core.mean_pairwise_distance(x) for x in x8])
    seeds = instance_seeds(0, bs)
    start = torch.arange(n, device="cuda").repeat(bs, 1)
    progress = np.array([8] * 4 + [16] * 4)
    for band in (None, "auto"):
        cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner,
                                         use_kernel=True, band=band)

        def segment(x, orders, nrm, prog, source):
            return core.run_round_segment(x, orders, nrm, prog, seg,
                                          source=source, hw=hw, cfg=cfg,
                                          device="cuda")

        one_orders, one_losses = _run_rounds(
            x8, start, TorchShuffleSource(seeds, n, "cuda"), norms, 0,
            hw=hw, cfg=cfg)
        source = TorchShuffleSource(seeds, n, "cuda")
        states, parts = [start], []
        torch.cuda.synchronize()
        K.reset_launch_counts()

        def chain():
            for p0 in range(0, rounds, seg):
                o, ls = segment(x8, states[-1], norms, [p0] * bs, source)
                states.append(o)
                parts.append(ls)

        seconds, _ = timed(torch, chain)
        counts = K.launch_counts()
        on, off = (DENSE, BAND) if band is None else (BAND, DENSE)
        require_counts(counts, {**{k: rounds * inner for k in on},
                                **{k: 0 for k in off}})
        require(torch.equal(states[-1], one_orders)
                and torch.equal(torch.cat(parts), one_losses),
                "chained segments differ from one uninterrupted run")

        gen = TorchShuffleSource(seeds, n, "cuda")
        shuffles = torch.stack([gen.next_round() for _ in range(rounds)]
                               ).cpu().numpy()           # (R, BS, N)

        def replay(cols):
            src = ReplayShuffleSource(shuffles[:, cols], "cuda")
            src.pos[:] = progress[cols]
            return src

        mixed = torch.cat([states[1][:4], states[2][4:]])
        o_m, l_m = segment(x8, mixed, norms, progress,
                           replay(np.arange(bs)))
        require(torch.equal(o_m[:4], states[2][:4])
                and torch.equal(o_m[4:], states[3][4:])
                and torch.equal(l_m[:, :4], parts[1][:, :4])
                and torch.equal(l_m[:, 4:], parts[2][:, 4:]),
                "mixed progress differs from the chain's segments")
        for i in range(bs):
            o_i, l_i = segment(x8[i:i + 1], mixed[i:i + 1], norms[i:i + 1],
                               progress[i:i + 1], replay([i]))
            require(torch.equal(o_i[0], o_m[i])
                    and torch.equal(l_i[:, 0], l_m[:, i]),
                    f"instance {i} alone differs from its row of the batch")
        emit("segment_run", band=band, band_k=core.resolve_band(cfg, n),
             instances=bs, seg_len=seg, rounds=rounds, inner_steps=inner,
             progress=progress.tolist(), chain_seconds=seconds,
             chained_equals_one_run=True, mixed_equals_chain=True,
             alone_equals_batch_rows=True, launches=counts,
             loss_last=one_losses[-1].tolist())


def correlated_weight(rng, d, f, rank=16):
    """A (d, f) float32 weight with correlated columns: a rank-``rank``
    product plus small noise, a quarter of its columns duplicated (with
    a little noise) into other places."""
    w = (rng.standard_normal((d, rank)) @ rng.standard_normal((rank, f))
         / np.sqrt(rank) + 0.05 * rng.standard_normal((d, f)))
    dst = rng.permutation(f)[:f // 4]
    src = rng.permutation(f)[:f // 4]
    w[:, dst] = w[:, src] + 0.01 * rng.standard_normal((d, f // 4))
    return w.astype(np.float32)


def sog_codec(torch):
    """Phase 8b: the SOG checkpoint codec (``repro_torch.runtime
    .sog_compress.compress_checkpoint``) on the card: two blocks of a
    (1024, 4096) and a (4096, 1024) weight with correlated columns, made
    from a seed.  Each weight's 4096 or 1024 columns are sorted by
    ``shuffle_soft_sort`` (the reference codec's config: 80 rounds x 4
    inner steps), then quantized, delta-coded and deflated.  Reports the
    seconds and the sog, baseline and raw bytes; requires valid
    permutations and an exact round trip of every weight."""
    from repro_torch.runtime import sog_compress as sog

    rng = np.random.default_rng(0)
    params = {"blocks": [{"w_in": correlated_weight(rng, 1024, 4096),
                          "w_out": correlated_weight(rng, 4096, 1024)}
                         for _ in range(2)]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sog.compress_checkpoint(params, device="cuda")
    seconds = time.perf_counter() - t0
    leaves = [params["blocks"][i][k] for i in range(2)
              for k in ("w_in", "w_out")]
    require(len(out["blobs"]) == 4 and all(out["blobs"]), "blob count")
    per_leaf = []
    for path, leaf, blob in zip(out["paths"], leaves, out["blobs"]):
        require(np.array_equal(np.sort(blob["perm"]),
                               np.arange(leaf.shape[1])),
                f"{path}: the order is not a permutation")
        q, scale = sog._quantize(leaf)
        require(blob["scale"] == scale and np.array_equal(
            sog.sog_decompress_tensor(blob), q.astype(np.float32) * scale),
            f"{path}: the round trip is not exact")
        per_leaf.append({"path": list(path), "shape": list(leaf.shape),
                         "bytes": blob["bytes"],
                         "baseline_bytes": blob["baseline_bytes"]})
    emit("sog_codec", seconds=seconds, leaves=per_leaf,
         sog_bytes=out["stats"]["sog_bytes"],
         baseline_bytes=out["stats"]["baseline_bytes"],
         raw_bytes=out["stats"]["raw_bytes"],
         gain_vs_baseline=out["stats"]["gain_vs_baseline"],
         ratio_vs_raw=out["stats"]["ratio_vs_raw"], round_trip="exact")


def v1_pipeline(K, ws, w, x, tau):
    """The v1 split forward's two kernels in order; returns m, l, y."""
    m, l = K.v1_stats(ws, w, tau)
    return m, l, K.v1_apply(ws, w, x, tau, m, l)


def v1_kernel_phase(torch, K):
    """Phase 9: v1_stats and v1_apply against their twins at the shapes of
    phase 2, float32; times at the main shape, and the v1 forward against
    the fused one; then the per-instance temperature case."""
    stats = {}
    cases = [(s, False) for s in DENSE_SHAPES] + [(INDEPENDENT_SHAPE, True)]
    for (bsz, n, d), independent in cases:
        ws, w, x, tau, _, _ = kernel_operands(
            torch, bsz, n, d, torch.float32, seed=n + d + 1,
            independent=independent)
        outs = v1_pipeline(K, ws, w, x, tau)
        m, l, y = outs
        m0, l0 = K.v1_stats_plain(ws, w, tau)
        y0 = K.v1_apply_plain(ws, w, x, tau, m, l)
        torch.cuda.synchronize()
        # 9a's first sweep takes the maximum of the same scores as the
        # twin's running maximum: equal bitwise.
        require(torch.equal(m, m0), "v1 m differs from the twin's")
        require(independent == bool((m < 0).any()),
                "v1 row maxima: -0 exactly when ws is sort(w)")
        require_batch_invariant(torch, lambda *a: v1_pipeline(K, *a),
                                (ws, w, x, tau), outs)
        errs = {"v1_stats": max(check("m", m, m0, atol=FWD_ATOL),
                                check("l", l, l0, rtol=FWD_ATOL)),
                "v1_apply": check("y", y, y0, atol=FWD_ATOL)}
        emit("v1_kernel_check", shape=[bsz, n, d], dtype="torch.float32",
             independent_keys=independent, max_abs_err=errs,
             batch_invariant=True)
        if independent or (bsz, n, d) != MAIN_SHAPE:
            continue
        stats = {k: {"max_abs_err": v} for k, v in errs.items()}

        def calls_at(t):
            return [(lambda: K.v1_stats(ws, w, t),
                     lambda: K.v1_stats_plain(ws, w, t)),
                    (lambda: K.v1_apply(ws, w, x, t, m, l),
                     lambda: K.v1_apply_plain(ws, w, x, t, m, l))]

        # The (B,) tau of the autograd Function, as in kernel_phase.
        tau_b = tau.expand(bsz).contiguous()
        calls = calls_at(tau_b)
        time_kernels(torch, stats, V1, calls, (bsz, n, d))
        for k, (kern, _) in zip(V1, calls):
            stats[k]["graph_ms"] = graph_ms(torch, kern)
        for k, (kern, _) in zip(V1, calls_at(tau)):
            stats[k]["graph_ms_shared_tau"] = graph_ms(torch, kern)
        inv_tau = 1.0 / tau

        def library_fwd():   # yardstick only: the port never calls it
            s = -(ws[:, :, None] - w[:, None, :]).abs() * inv_tau
            return torch.softmax(s, dim=-1) @ x

        stats["v1_apply"]["library_ms"] = time_ms(torch, library_fwd,
                                                  reps=5)
        emit("v1_kernel_times", shape=[bsz, n, d], dtype="torch.float32",
             times=stats)

        # The two forwards the kernel bench compares, each one graph: v1
        # (m and l through device memory between three passes) and fused.
        def v1_fwd():
            m_, l_ = K.v1_stats(ws, w, tau_b)
            return K.v1_apply(ws, w, x, tau_b, m_, l_), K.colsum(
                ws, w, tau_b, m_, l_)

        def fused_fwd():
            y_, m_, l_ = K.fwd_fused(ws, w, x, tau_b)
            return y_, K.colsum(ws, w, tau_b, m_, l_)

        v1_ms, fused_ms = graph_ms(torch, v1_fwd), graph_ms(torch, fused_fwd)
        emit("v1_vs_fused", shape=[bsz, n, d], dtype="torch.float32",
             v1_forward_graph_ms=v1_ms, fused_forward_graph_ms=fused_ms,
             v1_over_fused=v1_ms / fused_ms)
    per_instance_tau_case(torch, K, "v1")
    return stats


def kernel_bench_phase(torch, kernels):
    """Phase 10: the kernel bench's full sweep with its parity gate, in
    this process.  Returns the launch counts of the sweep."""
    from repro_torch.bench import kernel_bench

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    doc = kernel_bench.main(["--check"])     # SystemExit if the gate fails
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for cell in doc["cells"]:
        emit("kernel_bench", **{k: cell[k] for k in (
            "N", "d", "B", "K", "dtype", "wall_clock", "fwd_s", "fwdgrad_s",
            "bound_ms")}, worst_parity=max(cell["parity"].values()),
             band_vs_oracle=max(v for k, v in cell["band"].items()
                                if k.startswith("vs_oracle")))
    require(doc["wall_clock"] == "measured", "kernel bench not on the card")
    moved = ("v1_stats", "v1_apply", "colsum")
    require(all(counts[k] > 0 for k in moved),
            f"kernel bench launch counts {counts}: {moved} must move")
    emit("kernel_bench_summary", seconds=seconds, cells=len(doc["cells"]),
         gate="passed", launches=counts)
    return counts


def flash_operands(torch, b, tq, s, h, hkv, dh, seed):
    """q (B, Tq, H, Dh), k and v (B, S, Hkv, Dh), float32 normal."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(b, tq, h, dh, generator=g)
    k = torch.randn(b, s, hkv, dh, generator=g)
    v = torch.randn(b, s, hkv, dh, generator=g)
    return tuple(t.to("cuda") for t in (q, k, v))


def sdpa(torch, q, k, v, causal):
    """The yardstick: one scaled_dot_product_attention call on the same
    inputs, float32 (TF32 off), as a function to time.  The port never
    calls it.  SDPA's causal mask is aligned to the first key, which is
    the NeMo prefill's (q_offset 0); the decode row sees every key, which
    is no mask."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True)


def l2_flush(torch):
    """A function that writes 128 MB, more than the card's 50 MB L2, so
    that the next launch finds K and V in device memory only."""
    buf = torch.empty(32 * 2 ** 20, dtype=torch.float32, device="cuda")
    return lambda: buf.fill_(1.0)


def flash_errors(F, views, folded, causal, off, splits, s):
    """flash_forward at ``splits`` on the in-place views against the twins
    on the folded planes; max errors keyed by check, and the split count
    run."""
    qf, kf, vf = folded
    o, m, l = F.flash_forward(*views, causal, off, splits)
    o, m, l = o.reshape(qf.shape), m.reshape(qf.shape[:2]), l.reshape(
        qf.shape[:2])
    n = F.split_plan(s, splits)[0]
    m0, l0 = F.flash_stats_plain(qf, kf, causal, off)
    o0 = F.flash_apply_plain(qf, kf, vf, m, l, causal, off)
    o1, m1, l1 = F.flash_forward_plain(qf, kf, vf, causal, off, n)
    return {"m_vs_stats": check("m", m, m0, atol=FWD_ATOL),
            "l_vs_stats": check("l", l, l0, rtol=FWD_ATOL),
            "o_vs_apply": check("o", o, o0, atol=FWD_ATOL),
            "o_vs_forward_twin": check("o", o, o1, atol=FWD_ATOL),
            "m_vs_forward_twin": check("m", m, m1, atol=FWD_ATOL),
            "l_vs_forward_twin": check("l", l, l1, rtol=FWD_ATOL)}, n


def flash_kernel_phase(torch, F, fops):
    """Phase 11: flash_forward (and flash_combine) against the twins at
    FLASH_SHAPES and the NeMo shapes; flash_combine against its twin on
    the decode step's partials; the Function against the oracle; times at
    the NeMo shapes, decode warm and cold.  Returns the stats of both
    kernels: flash_forward at the prefill, flash_combine at decode."""
    from repro_torch.kernels.bounds import flash_bound_ms

    stats = {}
    flush = l2_flush(torch)
    for shape in FLASH_SHAPES + [NEMO_PREFILL, NEMO_DECODE]:
        b, tq, s, h, hkv, dh, causal, off = shape
        q, k, v = flash_operands(torch, b, tq, s, h, hkv, dh, seed=tq + s)
        views = [fops.heads_major(t) for t in (q, k, v)]
        folded = [fops.fold_heads(t) for t in (q, k, v)]
        auto = F.decode_splits(b * hkv, h // hkv * tq, s)
        nemo = shape in (NEMO_PREFILL, NEMO_DECODE)
        worst = {}
        for splits in sorted({auto} if nemo else {auto, 3}):
            errs, n = flash_errors(F, views, folded, causal, off, splits, s)
            emit("flash_check", shape=list(shape), splits=n, max_abs_err=errs)
            worst[n] = max(errs.values())
        if not nemo:
            continue
        n, _ = F.split_plan(s, auto)
        bh, bhkv = b * h, b * hkv
        qf, kf, vf = folded

        def fwd():
            return F.flash_forward_split(*views, causal, off, auto)

        def total():
            return F.flash_forward(*views, causal, off, auto)

        lib = sdpa(torch, q, k, v, causal and tq > 1)
        # ms: device time (graph replay); call_ms: an eager call, host
        # time included, as everywhere else in this script.
        row = {"max_abs_err": worst[n], "shape": list(shape), "splits": n,
               "ms": graph_ms(torch, fwd), "call_ms": time_ms(torch, fwd),
               "plain_ms": time_ms(torch, lambda: F.flash_forward_plain(
                   qf, kf, vf, causal, off, n), reps=5),
               "library_ms": graph_ms(torch, lib, reps=5),
               "library_call_ms": time_ms(torch, lib, reps=5)}
        row["bound_ms"], row["bound_by"] = flash_bound_ms(
            "flash_forward", bh, bhkv, tq, s, dh, causal, off)
        times = {"flash_forward": row}
        if n > 1:
            parts = fwd()
            got = F.flash_combine(*parts)
            want = F.flash_combine_plain(*parts)
            torch.cuda.synchronize()
            err = max(check("combine o", got[0], want[0], atol=FWD_ATOL),
                      check("combine m", got[1], want[1], atol=FWD_ATOL),
                      check("combine l", got[2], want[2], rtol=FWD_ATOL))
            merge = lambda: F.flash_combine(*parts)  # noqa: E731
            comb = {"max_abs_err": err, "shape": list(shape), "splits": n,
                    "ms": graph_ms(torch, merge),
                    "call_ms": time_ms(torch, merge),
                    "plain_ms": time_ms(torch, lambda: F.flash_combine_plain(
                        *parts), reps=5),
                    "library_ms": None}
            comb["bound_ms"], comb["bound_by"] = flash_bound_ms(
                "flash_combine", bh, bhkv, tq, s, dh, causal, off, n)
            times["flash_combine"] = comb
            # Warm: K and V stay in the 50 MB L2 from launch to launch;
            # cold: 128 MB written before each launch, as a decode step
            # after the other layers' work would find them.
            row["decode"] = {
                "total_ms_warm": graph_ms(torch, total),
                "total_ms_cold": graph_ms(torch, total, flush=flush),
                "forward_ms_cold": graph_ms(torch, fwd, flush=flush),
                "combine_ms_cold": graph_ms(torch, merge, flush=flush),
                "sdpa_ms_warm": row["library_ms"],
                "sdpa_ms_cold": graph_ms(torch, lib, reps=5, flush=flush),
                "total_call_ms_warm": time_ms(torch, total),
                "total_call_ms_cold": time_ms(torch, total, flush=flush),
                "sdpa_call_ms_warm": row["library_call_ms"],
                "sdpa_call_ms_cold": time_ms(torch, lib, reps=5,
                                             flush=flush)}
            del parts
        emit("flash_times", shape=list(shape), dtype="torch.float32",
             cuts=NEMO_CUTS, times=times)
        if shape == NEMO_PREFILL:
            stats["flash_forward"] = row
        else:
            stats["flash_combine"] = times["flash_combine"]
        del qf, kf, vf, folded, views, q, k, v

    # The Function: values and dq, dk, dv against the oracle's autograd.
    q, k, v = flash_operands(torch, 2, 64, 64, 4, 2, 32, seed=9)
    dout = torch.randn(q.shape, generator=torch.Generator().manual_seed(10)
                       ).to("cuda")
    results = []
    for fn in (lambda *a: fops.flash_attention(*a, True, 0, 16),
               lambda *a: fops.flash_attention_ref(*a, causal=True)):
        args = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o = fn(*args)
        results.append((o, *torch.autograd.grad(o, args, dout)))
    torch.cuda.synchronize()
    (o, dq, dk, dv), (o_r, dq_r, dk_r, dv_r) = results
    emit("flash_function_check", shape=[2, 64, 64, 4, 2, 32, True, 0],
         max_abs_err={"o": check("o", o, o_r, atol=FWD_ATOL),
                      "dq": check("dq", dq, dq_r, rtol=GRAD_RTOL),
                      "dk": check("dk", dk, dk_r, rtol=GRAD_RTOL),
                      "dv": check("dv", dv, dv_r, rtol=GRAD_RTOL)})
    return stats


def flash_main_run(torch, kernels, F, fops):
    """Phase 12: one Mistral-NeMo-12B attention layer through
    ``flash_attention``, prefill then one decode step, counts set to 0
    just before and read just after.  Returns the counts."""
    b, tq, s, h, hkv, dh, _, _ = NEMO_PREFILL
    q, k, v = flash_operands(torch, b, tq, s, h, hkv, dh, seed=123)
    q_dec = q[:, -1:].clone()
    splits = sum(F.decode_splits(b * hkv, h // hkv * t, s) > 1
                 for t in (tq, 1))    # the steps whose keys split
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    o_pre = fops.flash_attention(q, k, v, True, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    o_dec = fops.flash_attention(q_dec, k, v, True, NEMO_DECODE[-1])
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    counts = kernels.launch_counts()
    require_counts(counts, {"flash_forward": 2, "flash_combine": splits})
    require(o_pre.shape == q.shape and o_dec.shape == q_dec.shape,
            "flash output shapes")
    require(bool(torch.isfinite(o_pre).all() and torch.isfinite(o_dec).all()),
            "non-finite attention output")
    errs = {"prefill_vs_oracle": check(
                "prefill", o_pre, fops.flash_attention_ref(q, k, v),
                atol=FWD_ATOL),
            "decode_vs_oracle": check(
                "decode", o_dec, fops.flash_attention_ref(
                    q_dec, k, v, q_offset=NEMO_DECODE[-1]), atol=FWD_ATOL),
            "decode_vs_prefill_last_row": check(
                "decode row", o_dec, o_pre[:, -1:], atol=FWD_ATOL)}
    emit("flash_main_run", model="mistral-nemo-12b", heads=h, kv_heads=hkv,
         head_dim=dh, prefill_tokens=tq, decode_q_offset=NEMO_DECODE[-1],
         dtype="torch.float32", reduced=NEMO_CUTS,
         prefill_host_ms=(t1 - t0) * 1e3, decode_host_ms=(t2 - t1) * 1e3,
         max_abs_err=errs, launches={k_: counts[k_] for k_ in FLASH})
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import importlib

    from repro_torch import core, kernels
    from repro_torch.kernels import build, flash_ops, ops, ref
    K = importlib.import_module("repro_torch.kernels.softsort_apply")
    F = importlib.import_module("repro_torch.kernels.flash_attention")

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
             if "registers" in ln or "spill" in ln or "entry function" in ln]
    emit("build", seconds=time.perf_counter() - t0, sources=sorted(logs),
         flags=build.NVCC_FLAGS, ptxas=ptxas)
    stats = kernel_phase(torch, K)
    band_stats = band_kernel_phase(torch, K, core)
    stats.update(band_stats[SOG_SHAPE])
    stats.update(v1_kernel_phase(torch, K))
    stats.update(flash_kernel_phase(torch, F, flash_ops))
    function_phase(torch, ops, ref, core)
    xs, launches, fixed = catalog_runs(torch, core, K)
    adaptive_phases(torch, core, K, xs, fixed)
    loss_block_check(torch)
    tournament_run(torch, core, K, xs)
    tournament_adaptive_run(torch, core, K, xs)
    segment_run(torch, core, K, xs)
    launches.update({k: v for k, v in sog_run(torch, core, K).items()
                     if k in BAND})
    sog_codec(torch)
    launches.update({k: v for k, v in kernel_bench_phase(
        torch, kernels).items() if k in V1})
    launches.update({k: v for k, v in flash_main_run(
        torch, kernels, F, flash_ops).items() if k in FLASH})

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": FLASH_CU if k in FLASH else SOFTSORT_CU,
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

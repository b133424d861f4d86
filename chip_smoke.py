#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with an NVIDIA Hopper GPU and
the CUDA toolkit (``nvcc``).  It imports nothing of JAX or of the JAX
package, and stops at the first failed check with a non-zero exit code.

Phases, one JSON line each (``"phase"`` key, ``"t"`` seconds since the
start):

1. ``env`` / ``build`` — versions, the card, and the ``nvcc`` build of
   ``src/repro_torch/kernels/csrc/*.cu`` for sm_90a, with its time, each
   kernel's ``-Xptxas -v`` registers and spills, the clusters of the
   merging flash forward resident at once at 2 to 8 blocks
   (``cudaOccupancyMaxActiveClusters``), and the threefry hash's SASS
   instruction mix (``threefry_sass``).
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
   and none of a banded one; its ``digest`` (orders, then losses).
   ``c10_check``: the same run with the parent's sampled loss normaliser
   given as ``norms=`` is the parent's digest (``PARENT_MAIN_DIGEST``):
   Queue C10's repair of the normaliser moved nothing else; the new
   normaliser is printed beside the old one.
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
   ``checkpoint_run`` — ``band_main_run``'s configuration with a
   checkpoint every 4 rounds (8 rungs): bitwise ``band_main_run``'s
   result; an ``AnnealSupervisor`` with a ``FaultInjector`` as
   ``rung_hook`` kills it at every rung and each resumed result is
   bitwise; the same for the dense configuration at one rung,
   ``adaptive_run``'s at every rung and ``tournament_run``'s banded one
   at every rung; a child process that dies with ``os._exit`` at rung 3
   and a fresh one that resumes from its directory, bitwise; ms per round
   with checkpoints against none in alternating pairs, and the bytes of a
   snapshot.  ``guardrail_run`` — the same configuration unguarded (a
   no-op ``rung_hook``), with the invariants, and with the shadow at 1/32
   and at rate 1, each bitwise the unguarded run, the overhead the
   minimum over interleaved repetitions; the rate-1 shadow (a bitwise
   same-tier replay of each rung and the kernel-vs-plain apply check)
   clean on all 8 rungs, and again on one dense kernel-tier run and on
   the banded plain tier (ROADMAP.md Queue C8, repaired).  Chaos through
   the rung seam: a sign-flipped loss at one dispatch is repaired by one
   verified replay, bitwise; a corruption that persists on the kernel
   tier retires it, and the launch counters show the kernels stop at
   that rung.  ``serve_run`` — the continuous-batching ``SortServer``
   (``repro_torch.launch.serve``) on the kernel tier, ``band="auto"``,
   32 rounds x 8 inner steps in rungs of 8, two shape buckets (4096
   product vectors on 64 x 64, 1024 RGB colours on 32 x 32): the
   scenarios steady (Poisson at half the measured service rate; its
   banded launches join the kernels line), faults (every 5th dispatch
   fails), faults_stall (closed loop), overload, preempt,
   tournament (4 restarts, cull 0.5), guarded (the shadow at 1/32 and
   1) and capacity (a 2-restart tournament on a mesh of 8 slots of the
   card, slots 3 and 5 lost, slot 3 back), each with the exactly-once
   identity, valid permutations with falling losses and 4 requests
   bitwise their solo runs (the preempted ones first); faults_stall's
   stall of 3 rungs' time at a full bucket of 8 flagged and
   the cap halved, no straggler flagged in steady, tournament and
   guarded; no plain tier on the unguarded dispatches; then the
   guardrail bench's detection grid on the card.  ``mesh_run`` — the
   main run's catalog at 4 x 4 restarts on meshes of 1, 3 and 8 slots of
   the card (``repro_torch.launch.mesh``), dense and banded, each bitwise
   ``mesh=None``, with ms per round; a tournament on 3 slots, evictions
   through ``mesh_hook``, a checkpoint on 8 slots resumed on 3 and a
   supervised eviction, each bitwise.
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
    kernel ``flash_forward`` (merging 2 to 8 key splits in its cluster
    epilogue, more in the split-K merge ``flash_combine``) on
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
    warm and with the L2 cache flushed before each launch; the merge also
    per launch from one CUDA graph of 100 back-to-back launches
    (``graph100_ms``).  ``flash_cluster_check``: at one Qwen1.5-0.5B
    decode call (``QWEN_DECODE``) with 2, 3 and 4 key splits, the cluster
    merge bitwise the two-launch path, its launches, and both routes'
    ms, ``graph100_ms`` and call ms, the forward and the combine apart.
12. ``flash_main_run`` — that NeMo layer's attention through
    ``flash_attention``, prefill then one decode step, against the oracle,
    the decode row against the prefill's last row; 2 launches of
    ``flash_forward`` and 1 of ``flash_combine`` (the decode step's 64
    splits).

13. ``threefry_run`` — the threefry kernels (``threefry_bits``, the
    fused shuffle round ``threefry_round`` and ``threefry_given``,
    ``csrc/threefry.cu``) bitwise
    their twins on the card: ``threefry_bits`` in its four layouts at
    ``THREEFRY_SHAPES``, ``fold_in`` (one launch) at ``FOLD_DATA``, the
    round in both counter layouts at ``THREEFRY_ROUND_SHAPES``; jax's
    known-answer vectors through ``threefry_2x32`` on the kernel, and
    ``threefry_2x32`` of counts held on the card at ``THREEFRY_COUNTS``
    (1 to 7 words, 4096, a (3, 5) count; Queue C15), each one
    ``threefry_given`` launch bitwise the host's twin; the
    draws of ``threefry_draws`` (split, bits, permutation, uniform) in
    both counter layouts against jax's digests (``THREEFRY_DIGESTS``); ms
    per shuffle round at B.S = 8, N = 4096 of ``ThreefryShuffleSource``
    (one launch) and ``TorchShuffleSource``; the kernels' times, also per
    launch from one CUDA graph of 100 launches (``graph100_ms``), beside
    their bounds and an empty kernel's (the launch floor);
    ``threefry_given`` (on no main path) at its largest checked count,
    4096 words, beside its bound.
14. ``paper_table_run`` — the paper's Table III at N = 1024, full budget,
    kernel tier (``repro_torch.bench.paper_table``): each row's
    parameters, seconds, DPQ_16, neighbour distance and validity, its
    ``--check`` (ShuffleSoftSort's DPQ_16 above SoftSort's, every row but
    Kissing's valid, exact parameter counts; Kissing's validity as
    found), 16000 launches of each dense kernel (8000 steps of each
    SoftSort row) and the threefry kernels'.

15. ``serve_key_check`` (after ``serve_run``) — raw ``jax.random`` keys on
    ``SortServer.submit`` (ROADMAP.md Queue C11), kernel tier, 1024
    colours on 32 x 32: a one-restart request with ``prng_key(7)``
    bitwise ``shuffle_soft_sort(key=prng_key(7))``; a two-restart
    request's keys the reference server's chain ``[key] +
    split(fold_in(key, 1), 1)``, its first round's shuffles that chain's
    and its result the batched engine's on those keys, bitwise; an
    injected admission fault resolves its future with ``RequestFailed``
    within 10 s and the accounting holds.
16. ``autotune_run`` (after ``mesh_run``) — the payload-tile autotune
    (``repro_torch.kernels.autotune``): the full search over its cells in
    both dtypes, every candidate tile held to the twins, into a scratch
    table read back through ``lookup_blocks``; whether the tiles agree
    bitwise, cell by cell and per quantity; the committed table's rows
    read back, the fallback elsewhere; main_run and band_main_run again
    with the committed table moved aside, their digests unchanged.
17. ``batched_bench_run`` — the batched bench
    (``repro_torch.bench.batched_bench``, kernel tier) with ``--check``:
    B in {1, 8, 64} at N = 1024 and ``--full``'s N = 4096 at B in {1, 8}
    (B = 64 cut for time), each seed's order and losses bitwise on the
    batched and sequential paths (Queue C12: every loss in blocks of 8);
    the scaling sweep on meshes of 1 and 8 slots of the card, the mesh's
    orders bitwise the unsharded run's; the cull sweep; the adaptive rows
    and their gate (at least 20% of the rounds saved at a final-loss gap
    of at most 1%), and the same rows in jax 0.9.0's counter layout,
    reported ungated.

18. ``lm_arch_run`` — the LM zoo (``repro_torch.models``) served by
    ``repro_torch.launch.serve.serve_lm``: each of the ten architectures
    at the serve CLI's ``tiny`` preset, float32, 4 requests, prompts <= 24,
    8 new tokens; exactly the ``flash_forward`` launches its layer kinds
    and steps make (``lm_flash_calls``: the encoder again at each decode
    step for the audio model), the cluster merges and ``flash_combine``
    wherever the keys split; every step's logits against the same weights
    on the host (the
    plain twins), teacher-forced with the card's tokens, within
    ``LM_ARCH_ATOL``; whether the greedy tokens agree.
19. ``lm_serve_run`` — Qwen1.5-0.5B at its full published size (24
    layers, d = 1024, 16 heads of 64, vocab 151936 padded to 152064,
    619832320 parameters, bfloat16), random weights from seed 0, through
    ``serve_lm`` at (a) the reference CLI's defaults (8 requests, prompts
    <= 24, 32 new tokens) and (b) 8 requests, prompts <= 1024, 64 new
    tokens, where the decode keys split: init seconds, prefill ms, ms per
    decode step, tok/s, peak memory and exact flash launches; logits
    finite, tokens in range; ``lm_serve_checks``: prefill(T) +
    decode_step(T) against forward(T + 1) at the last position, layer
    0's attention on its own q/k/v against the oracle (float32 within
    FWD_ATOL, bf16 within one bf16 rounding), the teacher-forced logits
    of the kernel route against the oracle route (the attention function
    swapped in this script) within ``LM_BF16_RTOL`` of the largest logit,
    and the times of the float32 head and of the wrapper's cast of a
    bf16 KV cache.

20. ``lm_train_arch_run`` — one train step (``repro_torch.launch.steps.
    make_train_step``) of each of the ten architectures at the ``tiny``
    preset, float32, with the published remat setting ("full", or "dots"
    for the NeMo, Llama-3 405B and vision models), on a
    ``synthetic_batch`` of 2 x 32 tokens: exactly the ``flash_forward``
    launches of its attention calls, doubled by the remat recompute; loss
    and gradients finite; the card's gradients against the host's from
    the same weights, per leaf within ``LM_TRAIN_GRAD_RTOL`` x max |g|.
21. ``lm_train_run`` — Qwen1.5-0.5B trained at its full published size
    (bfloat16 parameters, float32 Adam moments, remat "full"), random
    weights from seed 0, ``LM_TRAIN["steps"]`` steps at batch 2 x seq
    4096 (the train_4k cell's length), lr 3e-4, clip 1.0: exactly 48
    ``flash_forward`` launches per step and no ``flash_combine``; a
    finite, falling loss; ms per step, tokens/s, peak memory with remat
    and for one step without, model TFLOP/s and ``mfu`` against the bf16
    dense peak, and the device ms of one layer's attention forward and
    backward (the reference's oracle recompute) and of the float32 head;
    ``lm_train_checks``: one float32 step at the same size, the kernel
    route against the oracle route (loss, and the gradients of
    ``lm_head.w`` and layer 0's ``attn.wq.w``).
22. ``lm_train_recovery_run`` — the train CLI's ``main`` at ``--preset
    10m --steps 30 --fail-at 15 --ckpt-every 10``: one restart, the
    final checkpoint bitwise the uninterrupted run's, and
    ``--compress-grads`` with a falling loss.

23. ``lm_dryrun_run`` — the dry-run (``repro_torch.launch.dryrun``) on
    the host: one process as rank 0 of 256 or 512 under torch's in-process
    ``fake`` group, ``meta`` tensors, Qwen1.5-0.5B at full size in the
    four shape cells on the (16, 16) and (2, 16, 16) meshes (train_4k,
    prefill_32k, decode_32k ``ok``, long_500k ``skipped``), and one arch
    of each other family on (16, 16) at ``LM_DRYRUN_FAMILIES``' cells;
    each record's argument bytes per device within the card's memory, its
    four roofline inputs and its roofline row at the H100's peaks
    (``repro_torch.bench.roofline``).  The child also makes the paper
    cell (``--paper``: one ShuffleSoftSort round at N = 2^20, d = 59) on
    both meshes, ``ok``, with wire bytes 475791360 and 253755392 per
    device (``PAPER_COLLECTIVE_BYTES``, the hand arithmetic of
    ``repro_torch.launch.paper``), and hillclimb's five ``paper_sort``
    variants on (16, 16), each one's wire bytes its own hand arithmetic;
    each is printed with its roofline terms at the H100's peaks
    (``paper_dryrun``, ``paper_sort_variant``).  The records are made in
    a child process started after the build (``start_lm_dryrun``), so
    that this host work overlaps the card's phases and its fake group
    never meets the card's process group.
24. ``lm_mesh_run`` — the sharded builders (``repro_torch.launch.steps.
    lower_cell``) on the card: an ``nccl`` group of one rank, a (1, 1)
    ("data", "model") mesh, Qwen1.5-0.5B at full size (bfloat16, random
    weights from seed 0) in the three cells cut to one card
    (``LM_MESH_CUTS``): each step bitwise the unsharded path on the same
    inputs (``make_train_step``'s state and metrics; ``prefill``'s logits
    and caches; ``decode_step``'s logits and its cache writes), the
    dry-run's per-device argument bytes of the cut cell equal to the
    bytes of the step's real arguments, and exactly the flash launches
    ``lm_train_calls`` / ``lm_flash_calls`` give (kernel 10 everywhere,
    merging in its cluster epilogue at decode); ms per step (host clock,
    a sync, the first apart),
    peak memory, the cost source's FLOPs of the step (``CostMode`` over
    the card's ops) against ``model_flops`` of the cut cell, and
    ``roofline_frac`` (model FLOPs over the bf16 peak, over the measured
    seconds).
25. ``paper_round_run`` — the paper cell's per-shard round
    (``repro_torch.launch.paper.paper_round``) on an ``nccl`` group of
    one rank at N = 2^14 on the 128 x 128 grid and at N = 2^16 (the
    largest that fits) on 256 x 256, d = 59, chunk 512, 2 inner steps,
    tau_r = 1.0: order and loss bitwise the unsharded ``_outer_round`` on
    the card, one ``threefry_round`` launch per round; host ms per round,
    peak memory.

Phases 9, 11 and 13 run right after phase 3, so that a faulty kernel
stops the script before the long runs; 10, 12 and 14 run after phase 8,
and 18 to 25 right after 12.

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
THREEFRY_CU = "src/repro_torch/kernels/csrc/threefry.cu"
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
    "flash_forward_cluster": "src/repro/kernels/flash_attention.py:42, "
                             "src/repro/kernels/flash_attention.py:62",
    "threefry_bits": "none: the reference draws through XLA's threefry2x32 "
                     "op (jax._src.prng), no Pallas kernel",
    "threefry_round": "none: the reference draws through XLA's threefry2x32 "
                      "op (jax._src.prng), no Pallas kernel",
}
DENSE = ("fwd_fused", "colsum", "bwd_dws_delta", "bwd_dx")
BAND = ("fwd_band", "colsum_band", "bwd_band_dws_delta", "bwd_band_dcol")
V1 = ("v1_stats", "v1_apply")
# flash_forward counts every forward launch, flash_forward_cluster those
# that merged their key splits in the cluster epilogue, flash_combine the
# standalone merges.
FLASH = ("flash_forward", "flash_combine", "flash_forward_cluster")
THREEFRY = ("threefry_bits", "threefry_round")
FWD_ATOL, GRAD_RTOL, BF16_RTOL = 2e-5, 1e-4, 2e-2
# ... and (1, 1024, 3): paper_table_run's SoftSort row (1024 colours).
SHAPES = [(8, 4096, 50), (3, 1000, 3), (1, 17, 1), (1, 1024, 3)]
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
# One Qwen1.5-0.5B decode attention call of lm_serve_run's traffic (b): 8
# requests x 16 heads (16 kv heads, Dh 64) over a 1088-key cache, merged
# in the cluster epilogue and in two launches at S = 2 key splits (what
# decode_splits gives it: 128 clusters are resident at once), 3 and 4
# (which take a second wave of clusters; 4 was the count before the
# cluster route).
QWEN_DECODE = (8, 1, 1088, 16, 16, 64, True, 1087)
# flash_cluster_check's cases, (name, shape, split counts): the Qwen
# decode call; the 10m recovery run's train attention (8 x 8 heads of 32
# over 128 tokens, 64-row tiles); lm_mesh_run's decode over a 32 K cache
# (2 splits, and 4, the count before the cluster route).
CLUSTER_CASES = [("qwen_decode", QWEN_DECODE, (2, 3, 4)),
                 ("recovery_10m", (8, 128, 128, 8, 8, 32, True, 0), (2,)),
                 ("mesh_decode_32k", (8, 1, 32768, 16, 16, 64, True, 32767),
                  (2, 4))]
# threefry_run: the draws of ``threefry_draws`` in each counter layout,
# sha256 (first 16 hex digits) of their words (uint32), int32 permutations
# or float32 values, computed from jax 0.9.0's jax.random on the CPU
# (tests/test_torch_threefry.py recomputes them there), and jax's
# known-answer vectors of the hash: (key, count) -> words.
THREEFRY_DIGESTS = {
    True: {"split_8": "11deb0153b5d7d21", "bits_8x4096": "bd3c04e484d0c7be",
           "bits_1x1048576": "7a5f93479f388954",
           "bits_3x1001": "811a3d4dd24b413a",
           "permutation_8x4096": "67022e81d6ddde8d",
           "uniform_1024x3": "21d19e3bd73b84aa"},
    False: {"split_8": "7c4a3853480e53f8", "bits_8x4096": "732ae64955b83fb9",
            "bits_1x1048576": "e5633c1d3b714950",
            "bits_3x1001": "a0c5ebd698aa35e4",
            "permutation_8x4096": "89421b32a48ea4c1",
            "uniform_1024x3": "624dcfe3d4361d8d"},
}
THREEFRY_KNOWN = [((0x00000000, 0x00000000), (0x00000000, 0x00000000),
                   (0x6B200159, 0x99BA4EFE)),
                  ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                   (0x1CB996FC, 0xBB002BE7)),
                  ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                   (0xC4923A9C, 0x483DF7A0))]
# (R, M) of the kernel checks: main_run's shuffle round (B.S = 8, N =
# 4096), the paper table's Gumbel noise (N^2 at N = 1024), an odd size.
THREEFRY_SHAPES = [(8, 4096), (1, 1024 * 1024), (3, 1001)]
# (R, N) of the fused shuffle round's checks: main_run's round (2
# permutation rounds), Table III's N = 1024 (1 round), odd sizes whose
# rows and second halves are not 16-byte aligned.
THREEFRY_ROUND_SHAPES = [(8, 4096), (2, 1024), (3, 1001), (5, 4098), (1, 1)]
# threefry_2x32's counts on the card (Queue C15): 1 to 7 words, 4096, and
# a 2-D count, each bitwise the host's twin in one launch.
THREEFRY_COUNTS = [(1,), (2,), (3,), (4,), (7,), (4096,), (3, 5)]
# fold_in's data words of the checks: 0, 1, 2^31, 2^32 - 1 (and 2^32 + 5,
# folded mod 2^32).
FOLD_DATA = (0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5)
# The previous sampled loss normaliser (pairs from a torch.Generator,
# ``parent_norm``) gave main_run these orders and losses (sha256 of
# all_orders, then all_losses, as repro_torch.bench.fixed_path_ab digests
# them), NVIDIA H100 80GB HBM3: the check of Queue C10's repair that
# nothing else moved.
PARENT_MAIN_DIGEST = ("d7852086b69df36a66fb1040b2afa48287c2b5a8f45bf467679f9"
                      "20f442b2e38")


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


def graph100_ms(torch, fn, launches=100, reps=15):
    """Milliseconds per call of ``fn()`` from one CUDA graph of
    ``launches`` back-to-back calls (median replay over ``launches``):
    the kernel's own time once one replay's fixed cost is spread."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return time_ms(torch, graph.replay, reps) / launches


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


def anneal(torch, core, K, xs, hw, cfg, restarts, norms=None):
    """One ``shuffle_soft_sort_batched`` run on the card, launch counts
    set to 0 just before it and read just after (``norms``: the loss
    normalisers, None for the engine's own).  Checks valid permutations
    and finite, falling losses; returns the result, the counts and the
    host-clock ms of each round."""
    n = hw[0] * hw[1]
    stamps = []
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    res = core.shuffle_soft_sort_batched(
        xs, hw, cfg, n_restarts=restarts, seed=0, device="cuda", norms=norms,
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


def run_digest(res):
    """sha256 of a batched result's orders, then losses (the digest of
    ``repro_torch.bench.fixed_path_ab``)."""
    import hashlib
    return hashlib.sha256(res.all_orders.tobytes()
                          + res.all_losses.tobytes()).hexdigest()


def parent_norm(torch, x, sample=2048):
    """The parent's sampled loss normaliser (before Queue C10's repair):
    2048 pairs from a CPU ``torch.Generator`` seeded with 0, moved to
    ``x``'s device."""
    n = x.shape[0]
    gen = torch.Generator().manual_seed(0)
    i = torch.randint(0, n, (sample,), generator=gen).to(x.device)
    j = torch.randint(0, n, (sample,), generator=gen).to(x.device)
    return torch.mean(torch.sqrt(torch.sum(torch.square(x[i] - x[j]),
                                           dim=-1) + 1e-12))


def c10_check(torch, core, K, xs, hw, cfg, restarts):
    """Queue C10: main_run again with the parent's normaliser given as
    ``norms=``; its orders and losses must be the parent's digest, so the
    repair moved the fixed path through the normaliser alone.  Prints the
    new default normaliser beside the old one."""
    xt = torch.as_tensor(xs, device="cuda")
    old = torch.stack([parent_norm(torch, x) for x in xt])
    new = torch.stack([core.mean_pairwise_distance(x) for x in xt])
    res, _, timing = anneal(torch, core, K, xs, hw, cfg, restarts,
                            norms=old)
    digest = run_digest(res)
    emit("c10_check", norm_parent=old.tolist(), norm_new=new.tolist(),
         norm_ratio=(new / old).tolist(), digest=digest,
         parent_digest=PARENT_MAIN_DIGEST,
         ms_per_round=timing["ms_per_round"])
    require(digest == PARENT_MAIN_DIGEST,
            f"main_run with the parent's normaliser: digest {digest}, the "
            f"parent's {PARENT_MAIN_DIGEST}")


def catalog_runs(torch, core, K):
    """Phases 5-7 on the clustered 4096-item catalog (d = 50): the dense
    main run, the all-banded main run, the run across the band switch.
    Returns the catalog, the launch counts of the dense main run, the
    all-banded run's result and timing (the fixed schedule that
    ``adaptive_run`` is held against), and the digests of the dense and
    the all-banded main run."""
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
    digests = {}
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
        digests[phase] = run_digest(res)
        emit(phase, **timing, mean_neighbor_distance_unsorted=nbr_before,
             mean_neighbor_distance_sorted=nbr_after,
             digest=digests[phase])
        if band is None:
            dense_counts = counts
            c10_check(torch, core, K, xs, hw, cfg, s)
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
         rounds=16, inner_steps=inner, switch_round=switch,
         digest=run_digest(res), **timing)
    return xs, dense_counts, fixed, digests


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
    and as the engine's padded blocks (``_loss_fn``),
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
                                cfg, lambda w, xs_, t: (yv, cv))
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

        one_orders, one_losses, _ = _run_rounds(
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


# Phases 7e and 7f on band_main_run's configuration (4 problems x 2
# restarts, N = 4096, d = 50, band="auto", K = 256, 32 rounds x 8 inner
# steps, float32), in rungs of CKPT_EVERY rounds: 8 rungs.
CKPT_EVERY = 4
CKPT_PAIRS = 5
GUARD_REPS = 5
# The child process of the real preemption: it runs band_main_run's
# configuration with checkpoints and either dies with os._exit(17) at the
# top of rung KILL_RUNG ("kill") or resumes from the directory ("resume")
# and saves the result beside it.
KILL_RUNG = 3
CHILD = r"""
import os, sys
import numpy as np
root, ckpt, mode = sys.argv[1:4]
sys.path.insert(0, os.path.join(root, "src"))
from repro_torch import core
xs = np.load(os.path.join(os.path.dirname(ckpt), "xs.npy"))
cfg = core.ShuffleSoftSortConfig(rounds=32, inner_steps=8, use_kernel=True,
                                 band="auto")
calls = []
def hook(start):
    calls.append(start)
    if mode == "kill" and len(calls) == int(sys.argv[4]) + 1:
        os._exit(17)
res = core.shuffle_soft_sort_batched(
    xs, (64, 64), cfg, n_restarts=2, seed=0, device="cuda",
    checkpoint_dir=ckpt, checkpoint_every=int(sys.argv[5]),
    resume=mode == "resume", rung_hook=hook)
np.savez(os.path.join(os.path.dirname(ckpt), "result.npz"),
         all_orders=res.all_orders,
         all_losses=res.all_losses, best_restart=res.best_restart,
         rung_starts=np.array(calls))
"""


def batched_fields(res):
    return {"all_orders": res.all_orders, "all_losses": res.all_losses,
            "best_restart": res.best_restart}


def tournament_fields(res):
    out = {"order": res.order, "all_losses": res.all_losses,
           "best_restart": res.best_restart,
           "rounds_run": np.asarray(res.rounds_run)}
    for i, sv in enumerate(res.survivors):
        out[f"survivors_{i}"] = sv
    return out


def require_fields(want, got, what):
    for name, a in want.items():
        require(np.array_equal(a, got[name], equal_nan=True),
                f"{what}: field {name} differs")


def kill_sweep(run, fields, want, root, kills):
    """A ``FaultInjector`` as ``rung_hook`` raises ``WorkerFailure`` at the
    top of rung k, for each k of ``kills``; an ``AnnealSupervisor`` over a
    fresh directory resumes from the newest checkpoint, and every field of
    the result must be bitwise ``want``'s."""
    from repro_torch.runtime.fault_tolerance import (AnnealSupervisor,
                                                     FaultInjector,
                                                     RetryPolicy)
    for k in kills:
        hook = FaultInjector(lambda start: None, fail_calls={k})
        sup = AnnealSupervisor(
            lambda xs_, hw_, cfg_, **kw: run(**kw),
            checkpoint_dir=os.path.join(root, f"kill{k}"),
            retry=RetryPolicy(max_retries=1, backoff_base_s=0.0))
        got = fields(sup.run(None, None, None, rung_hook=hook))
        require(hook.faults == 1 and sup.stats["restarts"] == 1,
                f"kill at rung {k}: faults {hook.faults}, stats {sup.stats}")
        require_fields(want, got, f"kill at rung {k}")
    return list(kills)


def rung_count(run):
    """(result, rung starts) of an uninterrupted run with a counting
    ``rung_hook``."""
    starts = []
    return run(rung_hook=starts.append), starts


def checkpoint_run(torch, core, K, xs, fixed, hw=(64, 64)):
    """Phase 7e: rung-boundary checkpoints and resume on the card.

    band_main_run's configuration with ``checkpoint_every=4`` (8 rungs):
    the checkpointed run, counts set to 0 just before it, is bitwise
    band_main_run's result (``fixed``) with 256 launches of each banded
    kernel; an ``AnnealSupervisor`` with a ``FaultInjector`` as
    ``rung_hook`` kills it at every rung, and each resumed result is
    bitwise; the same for main_run's dense configuration at one rung, for
    adaptive_run's configuration at every rung and for tournament_run's
    banded configuration at every rung; one real preemption, a child
    process that dies with ``os._exit`` at the top of rung 3 and a fresh
    process that resumes from its directory, bitwise.  Reports ms per
    round with checkpoints against none in CKPT_PAIRS rotating triples
    (neither with a per-round callback), the third the same rungs with no
    checkpoint, and the checkpoint's cost split into the per-rung sync
    and loss copy, the copy of the orders and stream state, and the
    publish (the time inside ``AnnealCheckpointer.save``); and the bytes
    of one snapshot."""
    import dataclasses
    import tempfile

    from repro_torch.runtime.anneal_checkpoint import AnnealCheckpointer

    b, s = xs.shape[0], 2
    rounds = 32
    cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=8,
                                     use_kernel=True, band="auto")
    want = batched_fields(fixed[0])

    def band_run(cfg_=cfg, **kw):
        return core.shuffle_soft_sort_batched(
            xs, hw, cfg_, n_restarts=s, seed=0, device="cuda",
            checkpoint_every=CKPT_EVERY, **kw)

    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        K.reset_launch_counts()
        res = band_run(checkpoint_dir=os.path.join(root, "plain"))
        counts = K.launch_counts()
        require_counts(counts, {**{k: rounds * 8 for k in BAND},
                                **{k: 0 for k in DENSE}})
        require_fields(want, batched_fields(res),
                       "checkpointed band_main_run")
        ck = AnnealCheckpointer(os.path.join(root, "plain"))
        latest = ck.latest_round()
        step_dir = os.path.join(root, "plain", f"step-{latest:09d}")
        snapshot_bytes = {f: os.path.getsize(os.path.join(step_dir, f))
                          for f in os.listdir(step_dir)}
        state, _, meta = ck.restore_latest()
        n_rungs = rounds // CKPT_EVERY
        band_kills = kill_sweep(band_run, batched_fields, want, root,
                                range(n_rungs))

        dense = dataclasses.replace(cfg, band=None)
        dense_ref, starts = rung_count(lambda **kw: band_run(dense, **kw))
        dense_kills = kill_sweep(lambda **kw: band_run(dense, **kw),
                                 batched_fields, batched_fields(dense_ref),
                                 os.path.join(root, "dense"), [len(starts) // 2])

        acfg = adaptive_config(core, "adaptive_run")

        def adaptive(**kw):
            return core.shuffle_soft_sort_batched(
                xs, hw, acfg, n_restarts=s, seed=0, device="cuda", **kw)

        a_ref, a_starts = rung_count(adaptive)
        a_fields = lambda r: {**batched_fields(r),  # noqa: E731
                              "rounds_executed": r.rounds_executed}
        adaptive_kills = kill_sweep(adaptive, a_fields, a_fields(a_ref),
                                    os.path.join(root, "adaptive"),
                                    range(len(a_starts)))

        t = TOURNAMENT

        def tournament(**kw):
            return core.restart_tournament(
                xs, hw, cfg, n_restarts=t["restarts"], seed=0,
                device="cuda", cull_fraction=t["cull_fraction"],
                n_rungs=t["n_rungs"], **kw)

        t_ref, t_starts = rung_count(tournament)
        tournament_kills = kill_sweep(
            tournament, tournament_fields, tournament_fields(t_ref),
            os.path.join(root, "tournament"), range(len(t_starts)))

        # One real preemption, across processes.
        np.save(os.path.join(root, "xs.npy"), xs)
        ckdir = os.path.join(root, "child")
        codes = []
        for mode in ("kill", "resume"):
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, ROOT, ckdir, mode,
                 str(KILL_RUNG), str(CKPT_EVERY)], timeout=600)
            codes.append(proc.returncode)
            if mode == "kill":
                require(proc.returncode == 17,
                        f"the child did not die at rung {KILL_RUNG}: exit "
                        f"{proc.returncode}")
                require(AnnealCheckpointer(ckdir).latest_round()
                        == KILL_RUNG * CKPT_EVERY,
                        "the killed child's newest checkpoint")
        require(codes[1] == 0, f"the resuming child exited {codes[1]}")
        with np.load(os.path.join(root, "result.npz")) as got:
            require_fields(want, dict(got), "resumed in a fresh process")
            resumed_starts = got["rung_starts"].tolist()

        # ms per round, checkpoints every 4 rounds against none, and the
        # split of their cost: "rungs" runs the same rungs with a no-op
        # rung_hook (a sync and a copy of the rung's losses per rung);
        # the checkpoint adds the copy of the orders and the stream state
        # and the publish, timed inside AnnealCheckpointer.save.
        plain_s, rungs_s, ckpt_s, save_s = [], [], [], []
        save = AnnealCheckpointer.save

        def timed_save(self, *a, **kw):
            t = time.perf_counter()
            save(self, *a, **kw)
            save_s[-1] += time.perf_counter() - t

        AnnealCheckpointer.save = timed_save
        try:
            for i in range(CKPT_PAIRS):
                trio = [(lambda: core.shuffle_soft_sort_batched(
                            xs, hw, cfg, n_restarts=s, seed=0,
                            device="cuda"), plain_s),
                        (lambda: band_run(rung_hook=lambda start: None),
                         rungs_s),
                        (lambda: band_run(checkpoint_dir=os.path.join(
                            root, f"pair{i}")), ckpt_s)]
                for fn, out in (trio if i % 2 == 0 else trio[::-1]):
                    if out is ckpt_s:
                        save_s.append(0.0)
                    out.append(timed(torch, fn)[0])
        finally:
            AnnealCheckpointer.save = save
    ms = lambda v: [x * 1e3 / rounds for x in v]  # noqa: E731
    emit("checkpoint_run", checkpoint_every=CKPT_EVERY, rungs=n_rungs,
         checkpointed_equals_band_main_run=True, launches=counts,
         snapshot_fields={k: [list(np.shape(v)), str(np.asarray(v).dtype)]
                          for k, v in state.items()},
         snapshot_bytes=snapshot_bytes, meta_fingerprint={
             k: v for k, v in meta.items() if k != "cfg"},
         band_kills=band_kills, dense_kills=dense_kills,
         adaptive_kills=adaptive_kills, adaptive_rung_starts=a_starts,
         tournament_kills=tournament_kills, tournament_rung_starts=t_starts,
         all_kills_bitwise=True, process_kill_rung=KILL_RUNG,
         process_exit_codes=codes, resumed_rung_starts=resumed_starts,
         process_resume_bitwise=True,
         ms_per_round_plain=ms(plain_s), ms_per_round_rungs=ms(rungs_s),
         ms_per_round_checkpointed=ms(ckpt_s),
         ms_per_round_in_save=ms(save_s),
         overhead=[c / p - 1 for p, c in zip(plain_s, ckpt_s)],
         median_overhead=float(np.median(
             [c / p - 1 for p, c in zip(plain_s, ckpt_s)])),
         median_split_ms_per_round={
             "rungs_sync_and_loss_copy": float(np.median(
                 ms([r - p for p, r in zip(plain_s, rungs_s)]))),
             "save_publish": float(np.median(ms(save_s))),
             "orders_and_state_copy": float(np.median(
                 ms([c - r - v for r, c, v in
                     zip(rungs_s, ckpt_s, save_s)])))})


class SegmentCorruptor:
    """Wraps the engine's rung seam ``_run_segment``: sign-flips the first
    loss of the calls in ``corrupt_calls``, and, with ``kernel_from``, of
    every call from that index on while the kernel tier is on.  Records
    each call's tier and the kernel launches it made."""

    def __init__(self, inner, K, corrupt_calls=(), kernel_from=None):
        self.inner, self.K = inner, K
        self.corrupt_calls = set(corrupt_calls)
        self.kernel_from = kernel_from
        self.calls = []

    def __call__(self, *args, **kwargs):
        i = len(self.calls)
        before = sum(self.K.launch_counts().values())
        orders, losses = self.inner(*args, **kwargs)
        use_kernel = kwargs["cfg"].use_kernel
        corrupt = i in self.corrupt_calls or (
            self.kernel_from is not None and i >= self.kernel_from
            and use_kernel)
        if corrupt:
            losses = losses.clone()
            losses.view(-1)[0] *= -1.0
        self.calls.append(dict(
            start=args[4], use_kernel=use_kernel, corrupted=corrupt,
            launches=sum(self.K.launch_counts().values()) - before))
        return orders, losses


def guardrail_run(torch, core, K, xs, fixed, hw=(64, 64)):
    """Phase 7f: the integrity probes on band_main_run's configuration, in
    rungs of 4 rounds (8 rungs).

    On the banded kernel tier: unguarded (a no-op ``rung_hook``, so it
    runs on the same rung seam), ``invariants``, and the shadow at the
    default rate 1/32 and at rate 1, timed in GUARD_REPS interleaved
    repetitions (the overhead is the minimum over them); each bitwise
    band_main_run's result with no incident, and the rate-1 shadow (a
    bitwise same-tier replay and the kernel-vs-plain apply check) clean on
    all 8 rungs (ROADMAP.md Queue C8, repaired), with 256 launches of each
    banded kernel on the main run and more in the shadow's replay and
    apply checks.  The rate-1 shadow also on one dense kernel-tier run
    (main_run's configuration) and on the banded plain tier (1 problem x
    2 restarts, for time), each clean on its 8 rungs and bitwise its
    unguarded run, both timed.  Chaos through the rung seam: one
    sign-flipped loss is repaired by one verified replay, bitwise clean; a
    corruption that persists while the kernel tier is on retires it, and
    the launch counters show that the kernels stopped at that rung."""
    import dataclasses
    import tempfile

    from repro_torch.core import shufflesoftsort as eng
    from repro_torch.runtime.fault_tolerance import (AnnealSupervisor,
                                                     DivergencePolicy)
    from repro_torch.runtime.guardrails import (GuardrailMonitor,
                                                GuardrailPolicy,
                                                shadow_sampled)

    s, rounds = 2, 32
    cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=8,
                                     use_kernel=True, band="auto")
    want = batched_fields(fixed[0])
    full = GuardrailPolicy(mode="shadow", shadow_rate=1.0)
    modes = {"unguarded": None,
             "invariants": GuardrailPolicy(mode="invariants"),
             "shadow_default": GuardrailPolicy(mode="shadow"),
             "shadow_full": full}
    starts = list(range(0, rounds, CKPT_EVERY))
    sampled = {m: [st for st in starts if shadow_sampled(
        p.seed, st, p.shadow_rate)] for m, p in modes.items()
        if p is not None and p.mode == "shadow"}

    def run(policy, cfg_=cfg, xs_=xs, restarts=s):
        mon = None if policy is None else GuardrailMonitor(policy)
        kw = ({"rung_hook": lambda start: None} if mon is None
              else {"guardrail": mon})
        res = core.shuffle_soft_sort_batched(
            xs_, hw, cfg_, n_restarts=restarts, seed=0, device="cuda",
            checkpoint_every=CKPT_EVERY, **kw)
        return res, mon

    seconds = {m: [] for m in modes}
    summaries, launches = {}, {}
    for rep in range(GUARD_REPS):
        for m in (list(modes) if rep % 2 == 0 else list(modes)[::-1]):
            torch.cuda.synchronize()
            K.reset_launch_counts()
            sec, (res, mon) = timed(torch, lambda: run(modes[m]))
            counts = K.launch_counts()
            require(all(counts[k] == 0 for k in DENSE)
                    and all(counts[k] >= rounds * 8 for k in BAND)
                    and (m != "unguarded"
                         or all(counts[k] == rounds * 8 for k in BAND)),
                    f"{m}: launch counts {counts}")
            require_fields(want, batched_fields(res), f"guarded run {m}")
            seconds[m].append(sec)
            launches[m] = counts
            if mon is not None:
                summaries[m] = mon.summary()
                require(not mon.incidents, f"{m}: incidents {mon.incidents}")
    require(summaries["shadow_full"]["rungs_shadowed"] == len(starts),
            f"rate-1 shadow: {summaries['shadow_full']}")
    base = min(seconds["unguarded"])
    overhead = {m: min(seconds[m]) / base - 1 for m in modes
                if m != "unguarded"}

    other_tiers = {}
    for tier, cfg_t, xs_t, restarts in (
            ("dense_kernel", dataclasses.replace(cfg, band=None), xs, s),
            ("banded_plain", dataclasses.replace(cfg, use_kernel=False),
             xs[:1], 2)):
        sec_u, (ref, _) = timed(torch, lambda: run(None, cfg_t, xs_t,
                                                   restarts))
        sec_g, (got, mon) = timed(torch, lambda: run(full, cfg_t, xs_t,
                                                     restarts))
        require(not mon.incidents and mon.rungs_shadowed == len(starts),
                f"{tier}: rate-1 shadow {mon.summary()}")
        require_fields(batched_fields(ref), batched_fields(got),
                       f"{tier}: guarded run")
        other_tiers[tier] = dict(problems=xs_t.shape[0], restarts=restarts,
                                 unguarded_seconds=sec_u,
                                 shadow_full_seconds=sec_g,
                                 overhead=sec_g / sec_u - 1,
                                 rungs_shadowed=mon.rungs_shadowed,
                                 incidents=mon.incidents)

    # Chaos through the rung seam.
    inner = eng._run_segment
    with tempfile.TemporaryDirectory() as root:
        chaos = SegmentCorruptor(inner, K, corrupt_calls={1})
        eng._run_segment = chaos
        try:
            sup = AnnealSupervisor(
                checkpoint_dir=os.path.join(root, "transient"),
                degrade=DivergencePolicy(integrity_retries=2))
            out = sup.run(xs, hw, cfg, n_restarts=s, seed=0, device="cuda",
                          checkpoint_every=CKPT_EVERY,
                          guardrail=modes["invariants"])
        finally:
            eng._run_segment = inner
        require(sup.stats["verified_replays"] == 1
                and not sup.stats["fallbacks"]
                and [r["probe"] for r in sup.stats["integrity_incidents"]]
                == ["loss_sign"], f"transient repair: {sup.stats}")
        require_fields(want, batched_fields(out), "repaired transient")
        transient = dict(stats=sup.stats, calls=chaos.calls)

        strike = 2                       # the rung the corruption starts at
        chaos = SegmentCorruptor(inner, K, kernel_from=strike)
        eng._run_segment = chaos
        try:
            sup = AnnealSupervisor(
                checkpoint_dir=os.path.join(root, "persistent"),
                degrade=DivergencePolicy(integrity_retries=1))
            out = sup.run(xs, hw, cfg, n_restarts=s, seed=0, device="cuda",
                          checkpoint_every=CKPT_EVERY,
                          guardrail=modes["invariants"])
        finally:
            eng._run_segment = inner
    calls = chaos.calls
    require(sup.stats["verified_replays"] == 1
            and sup.stats["fallbacks"] == [
                "retired kernel tier -> plain PyTorch apply "
                "(use_kernel=False)"], f"persistent repair: {sup.stats}")
    require([c["use_kernel"] for c in calls]
            == [True] * (strike + 2) + [False] * (len(starts) - strike)
            and all(c["launches"] > 0 for c in calls[:strike + 2])
            and all(c["launches"] == 0 for c in calls[strike + 2:])
            and [c["start"] for c in calls[strike + 2:]] == starts[strike:],
            f"the kernels did not stop at rung {strike}: {calls}")
    cut = strike * CKPT_EVERY
    require(np.array_equal(out.all_losses[:, :, :cut],
                           want["all_losses"][:, :, :cut]),
            "persistent: the rungs before the strike differ")
    for row in out.all_orders.reshape(-1, xs.shape[1]):
        require(core.is_valid_permutation(row), "invalid permutation")
    emit("guardrail_run", checkpoint_every=CKPT_EVERY, rungs=len(starts),
         seconds=seconds, overhead_min_over_reps=overhead,
         clean_incidents_at_rate_1=0, sampled_rungs=sampled,
         launches=launches, summaries=summaries, other_tiers=other_tiers,
         guarded_equals_unguarded=True, transient=transient,
         persistent=dict(stats=sup.stats, calls=calls, strike_rung=strike))


# Phase 7h: instance sharding over a device mesh, on the one card.
MESH = dict(problems=4, restarts=4, rounds=32, inner_steps=8)
MESH_SLOTS = (1, 3, 8)
MESH_TOURNAMENT = dict(restarts=8, n_rungs=3, cull_fraction=0.5, slots=3)
# The elastic runs: from 4 slots, (rung, slot id) evicted at that rung;
# the supervised run loses slot 2 of 4; the 8-slot run is killed at rung
# 2 and resumed on 3 slots.  (Each slot of one card adds a round's host
# time, so the elastic runs start from 4 slots, for time.)
MESH_ELASTIC_SLOTS = 4
MESH_EVICT = ((2, 3), (5, 1))
MESH_KILL_RUNG = 2


def mesh_run(torch, core, K, xs, hw=(64, 64)):
    """Phase 7h: ``mesh=`` (``repro_torch.launch.mesh``) at main_run's
    width, B x S = 4 x 4 = 16 instances of the catalog (N = 4096, d = 50,
    32 rounds x 8 inner steps, kernel tier, float32), with meshes of 1, 3
    (uneven: 16 rows padded to 18) and 8 slots, every slot on this card
    (one card: the slots run one after the other, so this measures the
    sharding's overhead, not a speedup).  ``make_sort_mesh()`` has one
    slot per visible card, and one more raises.  Dense and
    ``band="auto"``: each mesh's orders, losses and winners bitwise
    ``mesh=None``'s, and ms per round of each.  Then, banded: a 4 x 8
    tournament on 3 slots, its winners bitwise its ``mesh=None`` twin's;
    a ``mesh_hook`` on 4 slots evicting slot 3 at rung 2 and slot 1 at
    rung 5 (rungs of 4 rounds), bitwise the uninterrupted run; a run
    checkpointed on 8 slots, killed at rung 2, resumed on 3, bitwise; an
    ``AnnealSupervisor`` over a ``FaultInjector`` with ``device_loss``
    on 4 slots: one eviction, bitwise.  Counts set to 0 at the phase's start and read
    at its end (the kernels line adds them).  Returns them."""
    import tempfile

    from repro_torch.core.shufflesoftsort import _rung_boundaries
    from repro_torch.launch.mesh import make_sort_mesh
    from repro_torch.runtime.fault_tolerance import (AnnealSupervisor,
                                                     FaultInjector,
                                                     RetryPolicy,
                                                     WorkerFailure)
    cards = torch.cuda.device_count()
    require(len(make_sort_mesh()) == cards,
            f"make_sort_mesh() has {len(make_sort_mesh())} slots, "
            f"{cards} cards")
    try:
        make_sort_mesh(cards + 1)
        require(False, "make_sort_mesh(count + 1) did not raise")
    except RuntimeError:
        pass
    s, n = MESH["restarts"], hw[0] * hw[1]
    xs = xs[:MESH["problems"]]
    rounds, inner = MESH["rounds"], MESH["inner_steps"]

    def slots(k):
        return make_sort_mesh(devices=["cuda"] * k)

    torch.cuda.synchronize()
    K.reset_launch_counts()
    timing, fixed = {}, {}
    for band in (None, "auto"):
        cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner,
                                         use_kernel=True, band=band)
        emit("mesh_run_config", **MESH, n=n, d=xs.shape[2], grid=hw,
             band=band, band_k=core.resolve_band(cfg, n), slots=MESH_SLOTS,
             cut="rounds 1000 -> 32 for time; main_run's catalog at 4 x 4 "
                 "restarts; every slot on one card")
        row = {}
        seconds, want = timed(torch, lambda: core.shuffle_soft_sort_batched(
            xs, hw, cfg, n_restarts=s, seed=0, device="cuda"))
        row["none"] = seconds / rounds * 1e3
        for k in MESH_SLOTS:
            seconds, got = timed(torch, lambda: core.shuffle_soft_sort_batched(
                xs, hw, cfg, n_restarts=s, seed=0, mesh=slots(k)))
            row[k] = seconds / rounds * 1e3
            require_fields(batched_fields(want), batched_fields(got),
                           f"mesh of {k} slots, band {band}")
            require(np.array_equal(got.order, want.order),
                    f"mesh of {k} slots, band {band}: winners' orders")
        timing["dense" if band is None else "banded"] = row
        fixed[band] = want
    cfg = core.ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner,
                                     use_kernel=True, band="auto")
    want = batched_fields(fixed["auto"])
    t = MESH_TOURNAMENT

    def tournament(mesh=None):
        return core.restart_tournament(
            xs, hw, cfg, n_restarts=t["restarts"], seed=0, mesh=mesh,
            device="cuda", cull_fraction=t["cull_fraction"],
            n_rungs=t["n_rungs"])

    tour_s, tour = timed(torch, lambda: tournament(slots(t["slots"])))
    twin_s, twin = timed(torch, tournament)
    want_t = tournament_fields(twin)
    del want_t["rounds_run"]          # the mesh's counts its padding
    require_fields(want_t, tournament_fields(tour),
                   f"tournament on {t['slots']} slots")
    edges = _rung_boundaries(rounds, t["n_rungs"])
    spans = np.diff([0] + edges)
    live = [t["restarts"]] + [sv.shape[1] for sv in tour.survivors[:-1]]
    rows = [xs.shape[0] * k for k in live]
    padded = sum(r * -(-m // t["slots"]) * t["slots"]
                 for r, m in zip(spans, rows))
    require(tour.rounds_run == padded
            and twin.rounds_run == sum(r * m for r, m in zip(spans, rows)),
            f"rounds_run {tour.rounds_run} / {twin.rounds_run}, padded "
            f"{padded}")
    evicted = []

    def evict(start, mesh):
        for rung, dead in MESH_EVICT:
            if start == rung * CKPT_EVERY:
                evicted.append((start, dead))
                return mesh.without([dead])
        return None

    evict_s, got = timed(torch, lambda: core.shuffle_soft_sort_batched(
        xs, hw, cfg, n_restarts=s, seed=0, mesh=slots(MESH_ELASTIC_SLOTS),
        mesh_hook=evict, checkpoint_every=CKPT_EVERY))
    require(len(evicted) == len(MESH_EVICT), f"evictions {evicted}")
    require_fields(want, batched_fields(got), "mesh_hook evictions")
    with tempfile.TemporaryDirectory() as root:
        kill = FaultInjector(lambda start: None, fail_calls={MESH_KILL_RUNG})
        try:
            core.shuffle_soft_sort_batched(
                xs, hw, cfg, n_restarts=s, seed=0, mesh=slots(8),
                checkpoint_every=CKPT_EVERY, rung_hook=kill,
                checkpoint_dir=os.path.join(root, "kill"))
            require(False, "the killed run finished")
        except WorkerFailure:
            pass
        with open(os.path.join(root, "kill", sorted(os.listdir(
                os.path.join(root, "kill")))[-1], "manifest.json")) as f:
            saved_on = json.load(f)["mesh_shape"]
        got = core.shuffle_soft_sort_batched(
            xs, hw, cfg, n_restarts=s, seed=0, mesh=slots(3),
            checkpoint_every=CKPT_EVERY, resume=True,
            checkpoint_dir=os.path.join(root, "kill"))
        require(saved_on == [8], f"checkpoint saved on mesh {saved_on}")
        require_fields(want, batched_fields(got), "resume on 3 of 8 slots")
        mesh = slots(MESH_ELASTIC_SLOTS)
        run = FaultInjector(core.shuffle_soft_sort_batched,
                            device_loss={1: mesh.ids[2]})
        sup = AnnealSupervisor(run, checkpoint_dir=os.path.join(root, "sup"),
                               retry=RetryPolicy(backoff_base_s=0.0))
        kill = FaultInjector(lambda start: None, fail_calls={3})
        got = sup.run(xs, hw, cfg, n_restarts=s, seed=0, mesh=mesh,
                      rung_hook=kill, checkpoint_every=CKPT_EVERY)
        require(sup.stats.get("evictions") == 1 and run.device_faults == 1,
                f"supervisor stats {sup.stats}, history {sup.history}")
        require_fields(want, batched_fields(got), "supervised eviction")
    counts = K.launch_counts()
    require(all(counts[k] > 0 for k in DENSE + BAND),
            f"mesh_run launch counts {counts}")
    emit("mesh_run", cards=cards, slots=MESH_SLOTS,
         ms_per_round=timing, tournament_seconds=tour_s,
         tournament_twin_seconds=twin_s,
         tournament_rounds_run=tour.rounds_run,
         twin_rounds_run=twin.rounds_run, evictions=evicted,
         evict_seconds=evict_s, checkpoint_mesh_shape=saved_on,
         supervisor=dict(stats=sup.stats, history=sup.history),
         bitwise_mesh_none=True, launches=counts)
    return counts


# Phase 7g: the continuous-batching SortServer on the card.
SERVE = dict(rounds=32, inner_steps=8, max_batch=8, sched_rungs=4)
SERVE_SHAPES = (((64, 64), 50), ((32, 32), 3))
SERVE_REQUESTS = 24              # per scenario, cut for time
SERVE_SAMPLES = 4
# The faults_stall scenario's straggler (ROADMAP.md Queue C9): a stall of
# STRAGGLER_RUNGS times one rung's dispatch at a full bucket of 8 of the
# 64 x 64 shape, at the first such dispatch from dispatch STRAGGLER_AFTER
# on (past the monitor's warm-up of 8 judged dispatches; a signature's
# first dispatch is learnt from, not judged).  The monitor judges a
# dispatch against what its own signature costs, so the stall shows at a
# full bucket.
STRAGGLER_RUNGS = 3
STRAGGLER_AFTER = 20
# faults_stall's requests, offered closed loop so that full buckets of 8
# last past STRAGGLER_AFTER.  It injects no failures: the Poisson
# ``faults`` scenario does (every 5th dispatch).
SERVE_STALL_REQUESTS = 48
# The capacity scenario (8 slots of the card, each dispatch's slots one
# after the other): requests cut for time (the reference bench's 48).
SERVE_CAPACITY_REQUESTS = 8


def serve_problems(count, seed):
    """``count`` requests alternating two shape buckets: 4096 clustered
    50-d product vectors on 64 x 64 (main_run's generator, a catalog of
    its own per request) and 1024 RGB colours on 32 x 32 (the
    quickstart's uniform draw)."""
    from repro_torch.examples.image_grid_sorting import synthetic_catalog
    out = []
    for i in range(count):
        hw, d = SERVE_SHAPES[i % 2]
        n = hw[0] * hw[1]
        if i % 2 == 0:
            x = synthetic_catalog(n, d, clusters=24, seed=1000 * seed + i)[0]
        else:
            x = np.random.default_rng(1000 * seed + i).random(
                (n, d), dtype=np.float32)
        out.append((hw, d, x))
    return out


def server_seeds(seed, count):
    """The seeds a server seeded ``seed`` gives its first ``count``
    keyless submits, in submission order."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return [int(rng.integers(0, 2**31 - 1)) for _ in range(count)]


def solo_chain(torch, core, cfg, hw, x, seed, seg_len, restarts=1,
               cull_fraction=0.5, n_rungs=1):
    """A served request alone on the card: chained ``run_round_segment``
    calls from ``TorchShuffleSource([seed])`` at the server's norm, or
    with restarts the engine's tournament on the server's streams.
    Returns (order, losses)."""
    from repro_torch.core.prng import TorchShuffleSource, instance_seeds
    n = x.shape[0]
    x_t = torch.as_tensor(x, device="cuda")
    norm = float(core.mean_pairwise_distance(x_t))
    if restarts > 1:
        res = core.restart_tournament(
            x[None], hw, cfg, n_restarts=restarts,
            seeds=[seed] + instance_seeds(seed, restarts)[1:],
            cull_fraction=cull_fraction, n_rungs=n_rungs, device="cuda",
            norms=[norm])
        return res.order[0], res.all_losses[0, res.best_restart[0]]
    src = TorchShuffleSource([seed], n, "cuda")
    orders, parts = torch.arange(n, device="cuda")[None], []
    for p0 in range(0, cfg.rounds, seg_len):
        orders, ls = core.run_round_segment(
            x_t[None], orders, [norm], [p0], seg_len, source=src, hw=hw,
            cfg=cfg, device="cuda")
        parts.append(ls[:, 0].cpu().numpy())
    return orders[0].cpu().numpy().astype(np.int32), np.concatenate(parts)


def check_served(torch, core, cfg, cell, problems, seed, seg_len, solos,
                 **solo):
    """Every completed result a valid permutation whose loss fell; then
    SERVE_SAMPLES of them (half from each bucket where it can, the
    preempted ones first; fewer only where fewer completed) bitwise their
    solo runs.  ``solos`` caches the solo runs by problem and seed across
    scenarios.  Returns the checked problem indices."""
    seeds = server_seeds(seed, len(cell["problem_index"]))
    done = [(j, i) for j, (i, r) in enumerate(zip(cell["problem_index"],
                                                  cell["results"]))
            if r is not None]
    for j, i in done:
        order, _, losses = cell["results"][j]
        require(core.is_valid_permutation(order), "invalid permutation")
        last = losses[np.isfinite(losses)][-1]
        require(last < losses[0], f"request {i}: loss did not fall")
    # A request the brownout ladder degraded ran another config.
    degraded = set(cell.get("degraded_seqs", ()))
    done = [(j, i) for j, i in done if j not in degraded]
    preempted = cell.get("preempted_problems", [])
    picked = []
    for b in (0, 1):                  # half of the samples per bucket
        cands = [ji for ji in done if ji[1] % 2 == b]
        cands.sort(key=lambda ji: ji[1] not in preempted)
        picked += cands[:SERVE_SAMPLES // 2]
    picked += [ji for ji in done if ji not in picked][
        :SERVE_SAMPLES - len(picked)]  # a bucket short: top up
    require(len(picked) == min(SERVE_SAMPLES, len(done)),
            f"{cell['scenario']}: sampled {len(picked)} of {len(done)}")
    require(not preempted or any(i in preempted for _, i in picked),
            "no preempted request was sampled")
    for j, i in picked:
        hw, _, x = problems[i]
        key = (id(problems), i, seeds[j])
        if key not in solos:
            solos[key] = solo_chain(torch, core, cfg, hw, x, seeds[j],
                                    seg_len, **solo)
        order, losses = solos[key]
        got = cell["results"][j]
        require(np.array_equal(got[0], order)
                and np.array_equal(got[2], losses),
                f"{cell['scenario']}: request {i} differs from its solo run")
    return [i for _, i in picked]


def check_outcomes(cell):
    """No request of ``cell`` failed, and outside ``overload`` (whose
    misses are its point) every offered request completed or was shed at
    the queue: a server that fails its requests passes no scenario."""
    name = cell["scenario"]
    require(cell["failed"] == 0, f"{name}: {cell['failed']} requests failed")
    if name != "overload":
        require(cell["completed"] + cell["queue_rejected"]
                == cell["requests"],
                f"{name}: {cell['completed']} completed and "
                f"{cell['queue_rejected']} shed of {cell['requests']}")
    if name == "preempt":
        require(cell["completed_gen2"] == cell["preempted_inflight"],
                f"preempt: the successor completed {cell['completed_gen2']}"
                f" of {cell['preempted_inflight']} preempted requests")


def serve_run(torch, core, K):
    """Phase 7g: ``SortServer`` on the card (``repro_torch.launch.serve``),
    kernel tier, float32, ``band="auto"``, ``max_batch=8``, 32 rounds x 8
    inner steps, ``sched_rungs=4`` (rungs of 8 rounds), two shape buckets
    (``serve_problems``).  A closed-loop warm-up of 16 requests (all 16
    outstanding: 8 per bucket) measures the service rate, and one request
    alone its service time.  Scenarios
    (``repro_torch.bench.serving_bench``): ``steady`` (SERVE_REQUESTS
    Poisson arrivals at 50% of the service rate; counts set to 0 just
    before it and read just after: every banded kernel launched, no dense
    one, no plain tier), ``faults`` (``steady``'s traffic with a dispatch
    failure every 5th dispatch), ``faults_stall`` (SERVE_STALL_REQUESTS
    offered closed loop, so that full buckets of 8 occur, and one
    straggler: a stall of 3 rungs' dispatch time at a full bucket of 8
    past the monitor's warm-up (``STRAGGLER_*``), which must be flagged
    and halve the bucket cap), ``overload`` (3x the service rate into
    ``queue_depth=8``, each deadline 2x one request's service time),
    ``preempt`` (``close(drain=False)`` after a quarter completed, a
    successor adopts the rest), ``tournament`` (8 requests x 4 restarts,
    a cull of 0.5 at every rung edge), and ``guarded`` (``steady`` under
    the shadow at 1/32 and at rate 1: no incident), and ``capacity``
    (``SERVE_CAPACITY_REQUESTS`` requests of a 2-restart tournament on a
    mesh of 8 slots of the card; slots 3 and 5 lost at dispatches 1 and
    3, slot 3 back at 8; the brownout ladder armed: 2 evictions, 2
    re-shards, 1 return, no lost future; the samples from the requests
    the ladder left alone).  ``steady``, ``tournament`` and the guarded
    scenarios flag no straggler.  Each: the exactly-once identity, no
    failed request and (but ``overload``) every request completed or
    shed (``check_outcomes``), valid permutations with falling losses, 4
    requests bitwise their solo runs (the preempted ones first; in
    ``preempt`` the successor completes every preempted request).  Then
    the guardrail bench's detection grid on the card (N = 16, where every
    kernel path runs the dense kernels 1-4): every corruption on every
    serving path detected and repaired bitwise.  Returns the steady
    scenario's launch counts (the kernels line adds them)."""
    from repro_torch.bench import guardrail_bench, serving_bench as sb
    from repro_torch.core import shufflesoftsort as eng
    from repro_torch.runtime.guardrails import GuardrailPolicy

    cfg = core.ShuffleSoftSortConfig(
        rounds=SERVE["rounds"], inner_steps=SERVE["inner_steps"],
        use_kernel=True, band="auto")
    seg_len = SERVE["rounds"] // SERVE["sched_rungs"]
    base = dict(max_batch=SERVE["max_batch"], device="cuda",
                shapes=SERVE_SHAPES, sched_rungs=SERVE["sched_rungs"],
                keep_results=True)
    sb.warm(cfg, seg_len, SERVE["max_batch"], SERVE_SHAPES, "cuda")
    emit("serve_run_config", **SERVE, shapes=SERVE_SHAPES, band="auto",
         band_k=[core.resolve_band(cfg, hw[0] * hw[1])
                 for hw, _ in SERVE_SHAPES],
         cut="rounds 1000 -> 32 for time; the paper's section IV-A tasks")

    # The plain tier must not run on the unguarded dispatches.
    plain = {"calls": 0}
    originals = (eng.softsort_apply_banded, eng.softsort_apply_chunked)

    def counting(fn):
        def wrapped(*a, **k):
            plain["calls"] += 1
            return fn(*a, **k)
        return wrapped

    eng.softsort_apply_banded, eng.softsort_apply_chunked = map(counting,
                                                                originals)
    try:
        one = sb.run_scenario("single", cfg, requests=1, rate_hz=1e6,
                              window=1, queue_depth=64,
                              problems=serve_problems(1, 7), **base)
        warm = sb.run_scenario("warmup", cfg, requests=16, rate_hz=1e6,
                               window=16, queue_depth=64,
                               problems=serve_problems(16, 8), **base)
        rate = warm["goodput_rps"]
        service_s = one["wall_s"]
        cells, seed = {}, 0
        problems = serve_problems(SERVE_REQUESTS, seed)
        torch.cuda.synchronize()
        K.reset_launch_counts()
        cells["steady"] = sb.run_scenario(
            "steady", cfg, requests=SERVE_REQUESTS, rate_hz=0.5 * rate,
            window=16, queue_depth=64, problems=problems, seed=seed, **base)
        counts = K.launch_counts()
        require(all(counts[k] > 0 for k in BAND)
                and all(counts[k] == 0 for k in DENSE),
                f"steady: launch counts {counts}")
        full = SERVE["max_batch"]
        (hw0, d0), n0 = SERVE_SHAPES[0], SERVE_SHAPES[0][0][0] ** 2
        rung_s = statistics.median(timed(torch, lambda: core.run_round_segment(
            np.stack([problems[0][2]] * full), np.tile(np.arange(n0), (full, 1)),
            np.ones(full, np.float32), np.zeros(full, np.int64), seg_len,
            source=core.TorchShuffleSource(list(range(full)), n0, "cuda"),
            hw=hw0, cfg=cfg, device="cuda"))[0] for _ in range(3))
        delay_s = STRAGGLER_RUNGS * rung_s
        cells["faults"] = sb.run_scenario(
            "faults", cfg, requests=SERVE_REQUESTS, rate_hz=0.5 * rate,
            window=16, queue_depth=64, fail_every=5, problems=problems,
            seed=seed, **base)
        stall_problems = serve_problems(SERVE_STALL_REQUESTS, seed)
        cells["faults_stall"] = sb.run_stall_scenario(
            cfg, requests=SERVE_STALL_REQUESTS, delay_s=delay_s,
            after=STRAGGLER_AFTER, problems=stall_problems, seed=seed,
            **base)
        flags = cells["faults_stall"]["straggler_events"]
        require(cells["faults_stall"]["injected_delays"] == 1 and any(
            e["dt_s"] >= delay_s
            and e["bucket_cap"] == max(1, e["cap_before"] // 2)
            for e in flags),
            f"faults_stall: the {delay_s:.3f} s straggler ({STRAGGLER_RUNGS}"
            f" x {rung_s:.3f} s at a bucket of {full}) was not flagged "
            f"with the cap halved: {flags}")
        cells["overload"] = sb.run_scenario(
            "overload", cfg, requests=SERVE_REQUESTS, rate_hz=3.0 * rate,
            window=SERVE_REQUESTS, queue_depth=8,
            deadline_s=2.0 * service_s, problems=problems, seed=seed,
            **base)
        pre = sb.run_preempt_scenario(
            cfg, requests=SERVE_REQUESTS, rate_hz=0.5 * rate,
            window=SERVE_REQUESTS, queue_depth=64, problems=problems,
            seed=seed, **base)
        cells["preempt"] = pre
        tour = serve_problems(8, 1)
        cells["tournament"] = sb.run_scenario(
            "tournament", cfg, requests=8, rate_hz=0.5 * rate, window=8,
            queue_depth=64, problems=tour, seed=1,
            server_kw=dict(n_restarts=4, tournament_rungs=4,
                           cull_fraction=0.5), **base)
        cells["capacity"] = sb.run_capacity_scenario(
            cfg, requests=SERVE_CAPACITY_REQUESTS, rate_hz=1e6, window=16,
            queue_depth=16, max_batch=SERVE["max_batch"], deadline_s=600.0,
            device="cuda", seed=2,
            problems=serve_problems(SERVE_CAPACITY_REQUESTS, 2),
            shapes=SERVE_SHAPES, sched_rungs=SERVE["sched_rungs"],
            keep_results=True)
        cap = cells["capacity"]
        elastic = {k: cap[k] for k in ("evictions", "reshards",
                                       "device_returns", "lost_futures",
                                       "mesh_slots_end")}
        require(elastic == dict(evictions=2, reshards=2, device_returns=1,
                                lost_futures=0, mesh_slots_end=7),
                f"capacity: {elastic}")
        require(plain["calls"] == 0,
                f"the plain tier ran {plain['calls']} applies")
    finally:
        eng.softsort_apply_banded, eng.softsort_apply_chunked = originals
    for rate_name, pol in (("guarded_default", GuardrailPolicy(
            mode="shadow")), ("guarded_full", GuardrailPolicy(
            mode="shadow", shadow_rate=1.0))):
        cells[rate_name] = sb.run_scenario(
            rate_name, cfg, requests=SERVE_REQUESTS, rate_hz=0.5 * rate,
            window=16, queue_depth=64, problems=problems, seed=seed,
            guardrail=pol, **base)
        require(cells[rate_name]["integrity_violations"] == 0,
                f"{rate_name}: clean shadow incidents")
    for name in ("steady", "tournament", "guarded_default",
                 "guarded_full"):
        require(cells[name]["stragglers"] == 0,
                f"{name}: clean dispatches flagged as stragglers: "
                f"{cells[name]['straggler_events']}")
    bad = sb.gate([c for c in cells.values()])
    require(not bad, f"serving gate: {bad}")
    for cell in cells.values():
        check_outcomes(cell)
    # The preempted requests: the gen-2 server adopted them by seq, which
    # is their submission order, so their problem indices are known.
    pre["preempted_problems"] = [pre["problem_index"][q]
                                 for q in pre["preempted_seqs"]]
    sampled, solos = {}, {}
    for name, cell in cells.items():
        solo = (dict(restarts=4, cull_fraction=0.5, n_rungs=4)
                if name == "tournament" else
                dict(restarts=2, cull_fraction=0.25, n_rungs=2)
                if name == "capacity" else {})
        served = {"tournament": (tour, 1), "capacity": (
            serve_problems(SERVE_CAPACITY_REQUESTS, 2), 2),
            "faults_stall": (stall_problems, seed)}
        probs, seed_ = served.get(name, (problems, seed))
        sampled[name] = check_served(torch, core, cfg, cell, probs, seed_,
                                     seg_len, solos, **solo)
    torch.cuda.synchronize()
    K.reset_launch_counts()
    det = guardrail_bench.run_detection_grid(
        sorted(guardrail_bench.PATHS), sorted(guardrail_bench.CORRUPTIONS),
        "cuda")
    det_counts = K.launch_counts()
    require(all(c["injected"] == 1 and c["detected"] and c["repaired"]
                and c["bit_identical"] for c in det),
            f"detection grid: {det}")
    # N = 16: the banded path's switch falls past its last rung, so every
    # kernel path of the grid runs the dense kernels.
    require(all(det_counts[k] > 0 for k in DENSE),
            f"detection grid launches {det_counts}")
    steady = cells["steady"]
    for name, cell in cells.items():
        emit("serve_run", **{
            k: v for k, v in cell.items()
            if k not in ("results", "problem_index")},
            p50_vs_steady=cell["p50_ms"] / max(steady["p50_ms"], 1e-9),
            goodput_vs_steady=cell["goodput_rps"]
            / max(steady["goodput_rps"], 1e-9),
            sampled_bitwise_solo=sampled[name])
    emit("serve_run_summary", service_rate_rps=rate, solo_runs=len(solos),
         service_s_one_request=service_s, warmup=dict(
             p50_ms=warm["p50_ms"], mean_batch=warm["mean_batch"]),
         steady_launches=counts, plain_tier_calls=plain["calls"],
         detection=[{k: c[k] for k in ("path", "corruption", "probe",
                                       "detected", "repaired",
                                       "bit_identical")} for c in det],
         detection_launches=det_counts)
    return counts


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
    """Phase 11: flash_forward (merging in its cluster epilogue or in
    flash_combine) against the twins at FLASH_SHAPES and the NeMo shapes;
    flash_combine against its twin on the NeMo decode step's partials; the
    cluster merge against the two-launch path (``flash_cluster_check``);
    the Function against the oracle; times at the NeMo shapes, decode warm
    and cold.  Returns the stats of the kernels line: flash_forward at the
    prefill, flash_combine at decode, flash_forward_cluster at
    QWEN_DECODE."""
    from repro_torch.kernels.bounds import flash_bound_ms

    stats = {}
    flush = l2_flush(torch)
    for shape in FLASH_SHAPES + [NEMO_PREFILL, NEMO_DECODE]:
        b, tq, s, h, hkv, dh, causal, off = shape
        q, k, v = flash_operands(torch, b, tq, s, h, hkv, dh, seed=tq + s)
        views = [fops.heads_major(t) for t in (q, k, v)]
        folded = [fops.fold_heads(t) for t in (q, k, v)]
        auto = F.decode_splits(b * hkv, h // hkv * tq, s, dh, "cuda")
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
                    "graph100_ms": graph100_ms(torch, merge),
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

    stats["flash_forward_cluster"] = flash_cluster_check(torch, F, fops)

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


def max_active_clusters(F):
    """``F.resident_clusters`` (cudaOccupancyMaxActiveClusters of the
    forward's merging variant, which ``decode_splits`` reads), "rows tile
    x Dh tile x stages" -> {splits: clusters resident at once}; 16 x 128 x
    1 is a decode block of 81 KB of shared memory.  Raises if any cluster
    of up to 8 blocks cannot be resident."""
    out = {}
    for rows, dh, stages in ((16, 64, 1), (16, 128, 1), (16, 128, 2),
                             (64, 64, 1), (64, 128, 1), (64, 128, 2)):
        row = {}
        for splits in range(2, 9):
            n = F.resident_clusters("cuda", rows, dh, stages, splits)
            require(n > 0, f"clusters of {splits} blocks at {rows} x {dh} "
                           f"x {stages}: {n} resident")
            row[splits] = n
        out[f"{rows}x{dh}x{stages}"] = row
    return out


def flash_cluster_check(torch, F, fops):
    """The key splits merged in the forward's cluster epilogue against the
    two-launch path (``flash_forward_split`` then ``flash_combine``) at
    CLUSTER_CASES: o, m and l bitwise, one launch counted on
    ``flash_forward`` and on ``flash_forward_cluster``, each route's ms
    (one graph replay), and but for the 32 K decode its graph100_ms and
    call_ms and the forward and the combine apart; at QWEN_DECODE o, m and
    l within FWD_ATOL of the twin.  Returns the kernels line's stats at
    QWEN_DECODE and decode_splits' S."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.bounds import flash_bound_ms

    row = None
    for case, shape, split_counts in CLUSTER_CASES:
        b, tq, s, h, hkv, dh, causal, off = shape
        heavy = s > 4096
        if heavy:     # 2.1 GB of K and V: drawn on the card
            g = torch.Generator(device="cuda").manual_seed(31)
            q, k, v = (torch.randn(b, t, n_, dh, device="cuda", generator=g)
                       for t, n_ in ((tq, h), (s, hkv), (s, hkv)))
        else:
            q, k, v = flash_operands(torch, b, tq, s, h, hkv, dh, seed=29)
        views = [fops.heads_major(t) for t in (q, k, v)]
        auto = F.decode_splits(b * hkv, h // hkv * tq, s, dh, "cuda")
        require(auto in split_counts, f"decode_splits at {shape}: {auto}")
        for splits in split_counts:
            n = F.split_plan(s, splits)[0]
            require(n == splits and F.merges_in_cluster(n),
                    f"{splits} splits of {s} keys: {n} ranges")
            torch.cuda.synchronize()
            reset_launch_counts()
            got = F.flash_forward(*views, causal, off, splits)
            torch.cuda.synchronize()
            counts = {k_: v_ for k_, v_ in launch_counts().items() if v_}
            require(counts == {"flash_forward": 1,
                               "flash_forward_cluster": 1},
                    f"the cluster route launched {counts}")
            parts = F.flash_forward_split(*views, causal, off, splits)
            want = F.flash_combine(*parts)
            torch.cuda.synchronize()
            for name, g_, w_ in zip("oml", got, want):
                require(torch.equal(g_.reshape(w_.shape), w_),
                        f"cluster merge {name} != two-launch {name} at "
                        f"{case}, S = {splits}: max diff "
                        f"{max_err(g_.reshape(w_.shape), w_)}")
            fields = {}
            if shape == QWEN_DECODE:
                qf, kf, vf = (fops.fold_heads(t) for t in (q, k, v))
                o1, m1, l1 = F.flash_forward_plain(qf, kf, vf, causal, off, n)
                fields["max_abs_err_vs_twin"] = max(
                    check("cluster o", got[0].reshape(o1.shape), o1,
                          atol=FWD_ATOL),
                    check("cluster m", got[1].reshape(m1.shape), m1,
                          atol=FWD_ATOL),
                    check("cluster l", got[2].reshape(l1.shape), l1,
                          rtol=FWD_ATOL))
            routes = {
                "cluster": lambda: F.flash_forward(*views, causal, off,
                                                   splits),
                "two_launch": lambda: F.flash_combine(*F.flash_forward_split(
                    *views, causal, off, splits))}
            if not heavy:
                routes["forward_split"] = lambda: F.flash_forward_split(
                    *views, causal, off, splits)
                routes["combine"] = lambda: F.flash_combine(*parts)
            times = {k_: {"ms": graph_ms(torch, fn)} if heavy else
                     {"ms": graph_ms(torch, fn),
                      "graph100_ms": graph100_ms(torch, fn),
                      "call_ms": time_ms(torch, fn)}
                     for k_, fn in routes.items()}
            if not heavy:
                fields["merge_in_epilogue_graph100_ms"] = (
                    times["cluster"]["graph100_ms"]
                    - times["forward_split"]["graph100_ms"])
            bound = flash_bound_ms("flash_forward", b * h, b * hkv, tq, s,
                                   dh, causal, off)
            merge_bound = flash_bound_ms("flash_merge_cluster", b * h,
                                         b * hkv, tq, s, dh, causal, off, n)
            emit("flash_cluster_check", case=case, shape=list(shape),
                 splits=n, decode_splits=auto, bitwise_two_launch=True,
                 launches=counts, times=times, merge_bound_ms=merge_bound[0],
                 merge_bound_by=merge_bound[1], bound_ms=bound[0],
                 bound_by=bound[1], **fields)
            if shape == QWEN_DECODE and n == auto:
                plain = lambda: F.flash_forward_plain(  # noqa: E731
                    qf, kf, vf, causal, off, n)
                row = {"max_abs_err": fields["max_abs_err_vs_twin"],
                       "shape": list(shape), "splits": n,
                       "ms": times["cluster"]["ms"],
                       "graph100_ms": times["cluster"]["graph100_ms"],
                       "plain_ms": time_ms(torch, plain, reps=5),
                       "library_ms": graph_ms(torch, sdpa(
                           torch, q, k, v, False), reps=5),
                       "bound_ms": bound[0], "bound_by": bound[1]}
            del parts, got, want
        del q, k, v, views
    torch.cuda.empty_cache()
    return row


def flash_main_run(torch, kernels, F, fops):
    """Phase 12: one Mistral-NeMo-12B attention layer through
    ``flash_attention``, prefill then one decode step, counts set to 0
    just before and read just after.  Returns the counts."""
    b, tq, s, h, hkv, dh, _, _ = NEMO_PREFILL
    q, k, v = flash_operands(torch, b, tq, s, h, hkv, dh, seed=123)
    q_dec = q[:, -1:].clone()
    want = flash_routes(F, [(b * hkv, h // hkv * t, s) for t in (tq, 1)],
                        dh)
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
    require_counts(counts, want)
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


# The LM phases: every architecture at the CLI's tiny preset (float32),
# then Qwen1.5-0.5B at its full published size (bfloat16, as its config
# says) at two traffic points of the reference CLI's parameters.
LM_ARCH_TRAFFIC = dict(requests=4, prompt_len=24, max_new=8)
LM_QWEN = "qwen1.5-0.5b"
LM_QWEN_PARAMS = 619_832_320      # the reference's eval_shape count
LM_SERVE_POINTS = {
    "a": dict(requests=8, prompt_len=24, max_new=32),    # the CLI defaults
    "b": dict(requests=8, prompt_len=1024, max_new=64),  # decode keys split
}
# lm_arch_run: card against host, both float32 (TF32 off): sums in other
# orders, as the CPU tests' logits bound.
LM_ARCH_ATOL = 1e-4
# lm_serve_run, bfloat16 through 24 layers: max abs error over max |logit|
# of the reference side, for routes that round activations to bf16 at
# other places (another product shape, the oracle's attention).
LM_BF16_RTOL = 5e-2


def lm_flash_calls(cfg, requests, max_len, max_new):
    """(kv planes, packed query rows, keys) of every flash_attention call
    of ``serve_lm``: the encoder (audio), then each layer's self- and
    cross-attention, at the prefill and at each of the max_new - 1 decode
    steps (which run the encoder again) over the padded cache."""
    unit, repeats = cfg.block_program()
    kinds = unit * repeats
    planes, rep = requests * cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    ctx_len = cfg.vision_tokens if cfg.family == "vlm" else cfg.audio_frames
    enc = [(planes, rep * cfg.audio_frames, cfg.audio_frames)] * (
        cfg.encoder_layers if cfg.is_encdec else 0)
    calls = []
    for rows, keys in [(max_len, max_len)] + [(1, max_len + max_new)] * (
            max_new - 1):
        calls += enc
        for kind in kinds:
            if kind.startswith("attn") or kind == "cross_attn":
                calls.append((planes, rep * rows, keys))
            if kind == "cross_attn":
                calls.append((planes, rep * rows, ctx_len))
    return calls


def flash_routes(F, calls, dh, device="cuda"):
    """The launch counts of flash_attention ``calls`` (kv planes, packed
    query rows, keys) of head width ``dh`` on ``device``: ``flash_forward``
    each; of
    those, ``flash_forward_cluster`` where the keys split into 2 to
    ``MAX_CLUSTER`` ranges, merged in the kernel's epilogue; and
    ``flash_combine`` where they split into more."""
    n = [F.split_plan(tk, F.decode_splits(bhkv, rows, tk, dh, device))[0]
         for bhkv, rows, tk in calls]
    return {"flash_forward": len(calls),
            "flash_combine": sum(s > F.MAX_CLUSTER for s in n),
            "flash_forward_cluster": sum(F.merges_in_cluster(s) for s in n)}


def lm_want(F, cfg, requests, max_len, max_new, device="cuda"):
    return flash_routes(F, lm_flash_calls(cfg, requests, max_len, max_new),
                        cfg.resolved_head_dim, device)


def lm_teacher_forced(torch, model, cfg, prompts, tokens, device):
    """Each step's logits of ``model`` fed the prompts, then ``tokens``
    (requests, max_new) one by one, as ``serve_lm`` runs them."""
    from repro_torch.launch.serve import lm_context, pad_caches
    from repro_torch.models import decode_step, prefill
    max_new, max_len = tokens.shape[1], prompts.shape[1]
    ctx = lm_context(cfg, tokens.shape[0], device)
    toks = torch.from_numpy(tokens).to(device)
    with torch.inference_mode():
        logits, caches = prefill(model, torch.from_numpy(prompts).to(
            device, torch.long), ctx)
        caches = pad_caches(caches, max_new)
        out = [logits]
        for i in range(max_new - 1):
            logits, caches = decode_step(model, toks[:, i:i + 1], caches,
                                         max_len + i, ctx)
            out.append(logits)
    return out


def lm_step_errors(got, want, vocab):
    """Max abs error of each step's logits over the ``vocab`` real
    columns (the padded ones are -1e30 on both sides), and max |want|."""
    want = [w[..., :vocab].to(g.device) for g, w in zip(got, want)]
    return ([max_err(g[..., :vocab], w) for g, w in zip(got, want)],
            max(float(w.abs().max()) for w in want))


def lm_arch_run(torch, kernels, F):
    """Phase 18: each of the ten architectures at the serve CLI's tiny
    preset, float32, through ``serve_lm`` on the card: 4 requests, prompts
    <= 24, 8 new tokens.  Counts set to 0 just before each serve and read
    just after: exactly the flash launches of its layer kinds and steps.
    Every step's logits against the same weights on the host (plain
    twins), teacher-forced with the card's tokens, within LM_ARCH_ATOL;
    whether the host's greedy tokens agree.  Returns the summed counts."""
    import copy

    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.serve import serve_lm
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import init_model, reduced_config

    total = {k: 0 for k in FLASH}
    for arch in list_archs():
        cfg = reduced_config(get_config(arch), **PRESETS["tiny"])
        model = init_model(cfg, "cuda", seed=0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = serve_lm(cfg, device="cuda", model=model, **LM_ARCH_TRAFFIC)
        counts = kernels.launch_counts()
        want = lm_want(F, cfg, LM_ARCH_TRAFFIC["requests"], out["max_len"],
                       LM_ARCH_TRAFFIC["max_new"])
        require_counts(counts, want)
        host = lm_teacher_forced(torch, copy.deepcopy(model).to("cpu"), cfg,
                                 out["prompts"], out["tokens"], "cpu")
        errs, scale = lm_step_errors(out["logits"], host, cfg.vocab_size)
        require(max(errs) <= LM_ARCH_ATOL,
                f"{arch}: card vs host logits {max(errs):.3g} > "
                f"{LM_ARCH_ATOL}")
        host_tokens = torch.cat([h.argmax(-1) for h in host], 1).numpy()
        agree = int((host_tokens == out["tokens"]).sum())
        unit, repeats = cfg.block_program()
        emit("lm_arch_run", arch=arch, family=cfg.family,
             kinds=list(unit * repeats), encoder_layers=cfg.encoder_layers,
             dtype=cfg.param_dtype, traffic=LM_ARCH_TRAFFIC,
             max_len=out["max_len"], launches={k: counts[k] for k in FLASH},
             expected=want, max_abs_err=max(errs), max_abs_logit=scale,
             atol=LM_ARCH_ATOL, greedy_tokens_agree=agree,
             greedy_tokens=int(out["tokens"].size),
             prefill_ms=out["prefill_s"] * 1e3,
             decode_ms_per_step=out["decode_s"] * 1e3 / (
                 LM_ARCH_TRAFFIC["max_new"] - 1),
             tok_per_s=out["tok_per_s"])
        for k in FLASH:
            total[k] += counts[k]
        del model, host, out
    return total


def lm_oracle_attention(fops):
    """The plain oracle in the place of the flash attention: float32
    scores and softmax, the output in q's dtype."""
    def attention(q, k, v, causal=True, q_offset=0):
        return fops.flash_attention_ref(q, k, v, causal=causal,
                                        q_offset=q_offset).to(q.dtype)
    return attention


def lm_attention_check(torch, model, cfg, prompts, fops):
    """Layer 0's attention on the model's own q, k, v (bf16) at prefill
    and at a decode row (q_offset T - 1, the keys split): the kernel in
    float32 against the oracle within FWD_ATOL, and as the model runs it
    (bf16 operands, bf16 output) within one bf16 rounding of the
    output."""
    from repro_torch.models import attention as A
    from repro_torch.models.layers import embed, rmsnorm
    layer = model.blocks[0]
    toks = torch.from_numpy(prompts).to("cuda", torch.long)
    b, t = toks.shape
    with torch.inference_mode():
        h = rmsnorm(layer.norm1, embed(model.embed, toks), cfg.norm_eps)
        q, k, v = A.qkv(layer.attn, cfg, h, torch.arange(
            t, device="cuda").expand(b, t))
        errs = {}
        for name, qq, off in (("prefill", q, 0), ("decode", q[:, -1:], t - 1)):
            ref = fops.flash_attention_ref(qq, k, v, q_offset=off)
            o32 = fops.flash_attention(qq.float(), k.float(), v.float(),
                                       True, off)
            o16 = fops.flash_attention(qq, k, v, True, off)
            torch.cuda.synchronize()
            errs[name + "_f32"] = check(f"{name} f32", o32, ref,
                                        atol=FWD_ATOL)
            errs[name + "_bf16"] = check(
                f"{name} bf16", o16, ref,
                atol=2.0 ** -8 * float(ref.abs().max()))
    return errs


def lm_serve_run(torch, kernels, F, fops):
    """Phase 19: Qwen1.5-0.5B at its full published size (24 layers,
    d = 1024, 16 heads of 64, vocab 151936 padded to 152064, bfloat16),
    random weights from seed 0, through ``serve_lm`` at traffic points (a)
    and (b) (LM_SERVE_POINTS), counts set to 0 just before each and read
    just after: every attention call on ``flash_forward``, merging (b)'s
    decode splits in its cluster epilogue (no ``flash_combine``).  Logits
    finite and tokens in
    range; prefill(T) + decode_step(T) against forward(T + 1) at the last
    position; layer 0's attention on its own q/k/v against the oracle;
    the teacher-forced logits of the kernel route against the oracle
    route (the attention function swapped here) within LM_BF16_RTOL; the
    head's float32 product and the wrapper's float32 cast of a bf16 KV
    cache, timed.  Returns the summed counts of (a) and (b)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import pad_caches, serve_lm
    from repro_torch.models import (attention as A, decode_step, forward,
                                    init_model, model as M, param_count,
                                    prefill)

    cfg = get_config(LM_QWEN)
    t0 = time.perf_counter()
    model = init_model(cfg, "cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    require(param_count(model) == LM_QWEN_PARAMS,
            f"{param_count(model)} parameters, expected {LM_QWEN_PARAMS}")
    total = {k: 0 for k in FLASH}
    outs = {}
    for name, traffic in LM_SERVE_POINTS.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        out = serve_lm(cfg, device="cuda", model=model, **traffic)
        counts = kernels.launch_counts()
        want = lm_want(F, cfg, traffic["requests"], out["max_len"],
                       traffic["max_new"])
        require_counts(counts, want)
        require(all(bool(torch.isfinite(lg).all()) for lg in out["logits"]),
                "non-finite logits")
        steps = traffic["max_new"] - 1
        emit("lm_serve_run", point=name, model=LM_QWEN, traffic=traffic,
             max_len=out["max_len"], dtype=cfg.param_dtype,
             params=param_count(model), init_s=init_s,
             prefill_ms=out["prefill_s"] * 1e3,
             decode_ms_per_step=out["decode_s"] * 1e3 / steps,
             tok_per_s=out["tok_per_s"],
             peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             launches={k: counts[k] for k in FLASH}, expected=want,
             kv_splits=F.decode_splits(
                 traffic["requests"] * cfg.num_kv_heads, 1,
                 out["max_len"] + traffic["max_new"], cfg.resolved_head_dim,
                 "cuda"),
             nvidia_smi=nvidia_smi_line())
        for k in FLASH:
            total[k] += counts[k]
        outs[name] = out

    # prefill(T) + decode_step(T) against forward(T + 1), prompts of (a)
    a = outs["a"]
    prompts = torch.from_numpy(a["prompts"]).to("cuda", torch.long)
    nxt = torch.from_numpy(a["tokens"][:, :1]).to("cuda")
    t = prompts.shape[1]
    with torch.inference_mode():
        full = forward(model, torch.cat([prompts, nxt], 1)).logits
        lp, caches = prefill(model, prompts)
        ld, _ = decode_step(model, nxt, pad_caches(caches, 1), t)
    full, lp, ld = (x_[..., :cfg.vocab_size] for x_ in (full, lp, ld))
    scale = float(full.abs().max())
    consistency = {
        "prefill_vs_forward": check("prefill vs forward", lp,
                                    full[:, t - 1:t],
                                    atol=LM_BF16_RTOL * scale),
        "decode_vs_forward": check("decode vs forward", ld, full[:, t:],
                                   atol=LM_BF16_RTOL * scale),
        "max_abs_logit": scale}
    del full, caches

    attn_errs = lm_attention_check(torch, model, cfg, outs["b"]["prompts"],
                                   fops)

    # The kernel route against the oracle route, teacher-forced with (a)'s
    # tokens: only the attention function differs.
    kernel_route = lm_teacher_forced(torch, model, cfg, a["prompts"],
                                     a["tokens"], "cuda")
    saved = A.flash_attention
    A.flash_attention = lm_oracle_attention(fops)
    try:
        kernels.reset_launch_counts()
        oracle_route = lm_teacher_forced(torch, model, cfg, a["prompts"],
                                         a["tokens"], "cuda")
        oracle_counts = kernels.launch_counts()
    finally:
        A.flash_attention = saved
    require(not any(oracle_counts[k] for k in FLASH),
            f"the oracle route launched {oracle_counts}")
    errs, scale = lm_step_errors(kernel_route, oracle_route,
                                 cfg.vocab_size)
    require(max(errs) <= LM_BF16_RTOL * scale,
            f"kernel vs oracle route {max(errs):.3g} > "
            f"{LM_BF16_RTOL * scale:.3g}")
    agree = int(sum((k_.argmax(-1) == o.argmax(-1)).sum().item()
                    for k_, o in zip(kernel_route, oracle_route)))

    # What the float32 head and the wrapper's cast of a bf16 cache cost.
    b = outs["b"]
    x = torch.randn(8, 1, cfg.d_model, device="cuda", dtype=torch.bfloat16)
    w = model.lm_head.w
    keys = b["max_len"] + LM_SERVE_POINTS["b"]["max_new"]
    kv = [torch.randn(8, keys, cfg.num_kv_heads, cfg.resolved_head_dim,
                      device="cuda", dtype=torch.bfloat16) for _ in range(2)]
    q = torch.randn(8, 1, cfg.num_heads, cfg.resolved_head_dim,
                    device="cuda", dtype=torch.bfloat16)
    kv32 = [t_.float() for t_ in kv]
    with torch.inference_mode():
        costs = {
            "head_ms": time_ms(torch, lambda: M._head(model, x)),
            "head_weight_cast_ms": time_ms(torch, lambda: w.float()),
            "head_bf16_product_ms": time_ms(torch, lambda: x @ w),
            "cache_cast_ms_per_layer": time_ms(torch, lambda: [
                fops.heads_major(t_) for t_ in kv]),
            "decode_attention_bf16_cache_ms": time_ms(
                torch, lambda: fops.flash_attention(q, *kv, True, keys - 1)),
            "decode_attention_f32_cache_ms": time_ms(
                torch, lambda: fops.flash_attention(q.float(), *kv32, True,
                                                    keys - 1)),
        }
    # Device time of one decode step and of the prefill, as CUDA-graph
    # replays: the step's launches without the host's dispatch between
    # them, against the host-clock step of the serve.
    for name, o in outs.items():
        prompts = torch.from_numpy(o["prompts"]).to("cuda", torch.long)
        tok = torch.from_numpy(o["tokens"][:, :1]).to("cuda")
        with torch.inference_mode():
            _, caches = prefill(model, prompts)
            caches = pad_caches(caches, LM_SERVE_POINTS[name]["max_new"])
            costs[f"decode_step_graph_ms_{name}"] = graph_ms(
                torch, lambda: decode_step(model, tok, caches,
                                           o["max_len"]))
            costs[f"prefill_graph_ms_{name}"] = graph_ms(
                torch, lambda: prefill(model, prompts), reps=5)
        del caches
    emit("lm_serve_checks", model=LM_QWEN, consistency=consistency,
         attention_vs_oracle=attn_errs,
         kernel_vs_oracle_route={"max_abs_err": max(errs),
                                 "max_abs_logit": scale,
                                 "rtol": LM_BF16_RTOL,
                                 "greedy_tokens_agree": agree,
                                 "greedy_tokens": int(a["tokens"].size)},
         costs=costs, layers=cfg.num_layers, cache_keys=keys,
         nvidia_smi=nvidia_smi_line())
    del model, outs, kernel_route, oracle_route
    torch.cuda.empty_cache()
    return total


# The LM training phases: one train step of every architecture at the
# tiny preset (float32, card against host), Qwen1.5-0.5B trained at its
# full published size (bfloat16 parameters, float32 moments, remat
# "full"), then the train CLI's failure recovery at the 10m preset.
LM_TRAIN_ARCH = dict(batch=2, seq=32)
LM_TRAIN = dict(batch=2, seq=4096, steps=12, lr=3e-4, grad_clip=1.0)
LM_TRAIN_CUTS = ["the train_4k cell's global batch 256 -> 2 (one card)"]
# card against host, float32 (TF32 off), per leaf: max abs error over
# max |g| of the host's leaf, plus 1e-7 (the CPU tests' gradient bound)
LM_TRAIN_GRAD_RTOL = 1e-5
# the full-size float32 step, kernel route against oracle route
LM_TRAIN_F32_LOSS_RTOL = 1e-5
LM_TRAIN_F32_GRAD_RTOL = 1e-4
LM_RECOVERY = ["--preset", "10m", "--steps", "30", "--fail-at", "15",
               "--ckpt-every", "10"]

def lm_train_calls(cfg, batch, seq):
    """(kv planes, packed query rows, keys) of every flash_attention call
    of one forward of ``loss_fn``: the encoder (audio), then each layer's
    self- and cross-attention."""
    unit, repeats = cfg.block_program()
    planes, rep = batch * cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads
    ctx_len = cfg.vision_tokens if cfg.family == "vlm" else cfg.audio_frames
    calls = [(planes, rep * cfg.audio_frames, cfg.audio_frames)] * (
        cfg.encoder_layers if cfg.is_encdec else 0)
    for kind in unit * repeats:
        if kind.startswith("attn") or kind == "cross_attn":
            calls.append((planes, rep * seq, seq))
        if kind == "cross_attn":
            calls.append((planes, rep * seq, ctx_len))
    return calls


def lm_train_want(F, cfg, batch, seq, steps=1, device="cuda"):
    """Exact launches of ``steps`` train steps on ``device``: each
    forward's calls, run again by the backward under remat."""
    calls = lm_train_calls(cfg, batch, seq) * (2 if cfg.remat else 1)
    return {k: steps * v for k, v in flash_routes(
        F, calls, cfg.resolved_head_dim, device).items()}


def threefry_per_batch(cfg):
    """``threefry_bits`` launches of one ``synthetic_batch``: the step's
    ``fold_in``, the key's split, randint's split and its two draws, and
    the context's draw of a vlm or audio model."""
    return 5 + (cfg.family == "vlm" or cfg.is_encdec)


def to_host(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.detach().to("cpu", copy=True), tree)


def grad_errors(got, want):
    """Per leaf: max abs error of ``got`` over 1e-5 x max |want| + 1e-7,
    the largest such ratio, and its leaf."""
    worst, name = 0.0, None
    for k, w in want.items():
        limit = LM_TRAIN_GRAD_RTOL * float(w.abs().max()) + 1e-7
        ratio = max_err(got[k].cpu(), w) / limit
        if ratio > worst:
            worst, name = ratio, k
    return worst, name


def lm_train_arch_run(torch, kernels, F):
    """Phase 20: one train step (``make_train_step``) of each of the ten
    architectures at the tiny preset, float32, with its published remat
    setting, on the card from random weights of seed 0 and a
    ``synthetic_batch`` made there; counts set to 0 just before the step
    and read just after: exactly the flash launches of its attention calls
    (doubled under remat).  Loss and gradients finite; the card's
    gradients (``value_and_grad``) against the host's from the same
    weights, per leaf within LM_TRAIN_GRAD_RTOL x max |g| + 1e-7.
    Returns the summed counts."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.steps import (make_train_step, model_params,
                                          value_and_grad)
    from repro_torch.launch.train import PRESETS
    from repro_torch.models import init_model, reduced_config
    from repro_torch.optim import adam_init

    total = {k: 0 for k in FLASH}
    b, t = LM_TRAIN_ARCH["batch"], LM_TRAIN_ARCH["seq"]
    for arch in list_archs():
        full = get_config(arch)
        cfg = reduced_config(full, **PRESETS["tiny"], remat=full.remat,
                             remat_policy=full.remat_policy)
        params = model_params(init_model(cfg, "cuda", seed=0))
        batch = synthetic_batch(cfg, b, t, 0, device="cuda")
        state = {"params": params, "opt": adam_init(params)}
        step = make_train_step(cfg)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        new, metrics = step(state, batch)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        want = lm_train_want(F, cfg, b, t)
        require_counts(counts, want)
        require(all(bool(torch.isfinite(v).all()) for v in metrics.values()),
                f"{arch}: non-finite metrics {metrics}")
        (loss, _), grads = value_and_grad(cfg)(params, batch)
        (hloss, _), hgrads = value_and_grad(cfg)(to_host(params),
                                                 to_host(batch))
        require(all(bool(torch.isfinite(g).all()) for g in grads.values()),
                f"{arch}: non-finite gradients")
        worst, leaf = grad_errors(grads, hgrads)
        require(worst <= 1.0, f"{arch}: card vs host gradient of {leaf} "
                f"{worst:.3g} x its bound")
        emit("lm_train_arch_run", arch=arch, family=cfg.family,
             remat=cfg.remat, remat_policy=cfg.remat_policy,
             batch=b, seq=t, loss=float(loss), host_loss=float(hloss),
             grad_norm=float(metrics["grad_norm"]),
             worst_grad_err_over_bound=worst, worst_leaf=leaf,
             rtol=LM_TRAIN_GRAD_RTOL,
             launches={k: counts[k] for k in FLASH}, expected=want)
        for k in FLASH:
            total[k] += counts[k]
        del params, state, new, grads, hgrads
    return total


def attention_costs(torch, fops, cfg, b, t):
    """Device ms (CUDA events) of one layer's attention at the train
    shape, bfloat16 operands as the model runs them: the flash forward,
    and the backward (the reference's oracle recomputed per 128-row
    chunk)."""
    h, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    g = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn(b, t, h, dh, device="cuda", generator=g).to(
        torch.bfloat16).requires_grad_()
    k, v = (torch.randn(b, t, hkv, dh, device="cuda", generator=g).to(
        torch.bfloat16).requires_grad_() for _ in range(2))
    o = fops.flash_attention(q, k, v, True, 0)
    dout = torch.randn_like(o)
    with torch.no_grad():
        fwd = time_ms(torch, lambda: fops.flash_attention(q, k, v, True, 0),
                      reps=5)
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        o, (q, k, v), dout, retain_graph=True), reps=5, warmup=1)
    return fwd, bwd


def head_costs(torch, params, cfg, b, t):
    """Device ms of the float32 head (``model._head``'s ops: the bf16
    weight cast to float32, the product, the vocab-padding mask) forward
    and backward at the train shape."""
    import types

    from repro_torch.models.layers import linear
    p = types.SimpleNamespace(w=params["lm_head.w"].detach().requires_grad_(),
                              b=None)
    x = torch.randn(b, t, cfg.d_model, device="cuda",
                    dtype=torch.bfloat16).requires_grad_()

    def head():
        logits = linear(p, x.float())
        logits[..., cfg.vocab_size:] = -1e30
        return logits

    with torch.no_grad():
        fwd = time_ms(torch, head, reps=5)
    logits = head()
    dl = torch.randn_like(logits)
    bwd = time_ms(torch, lambda: torch.autograd.grad(
        logits, (x, p.w), dl, retain_graph=True), reps=5, warmup=1)
    del logits, dl
    return fwd, bwd


def lm_train_run(torch, kernels, F, fops):
    """Phase 21: Qwen1.5-0.5B at its full published size (24 layers, d =
    1024, vocab 151936 padded to 152064, bfloat16 parameters, float32
    Adam moments, remat "full"), random weights from seed 0, trained for
    LM_TRAIN["steps"] steps of ``make_train_step`` on ``synthetic_batch``
    at batch 2 x seq 4096 (the train_4k cell's length; its global batch
    256 cut for one card).  Counts set to 0 just before the steps and read
    just after: exactly 48 ``flash_forward`` launches per step (24 layers,
    recomputed under remat), no ``flash_combine``.  The loss finite at
    every step and its last below its first, the gradient norm finite.
    Host ms per step after the first, tokens/s, peak memory (and, for one
    step, without remat), model TFLOP/s (6 x parameters x tokens) and its
    share of the bf16 dense peak as ``mfu``; device ms of one layer's
    attention forward and backward and of the f32 head.  Then one float32
    step at the same size, kernel route against oracle route (attention
    swapped for ``flash_attention_ref``): loss within
    LM_TRAIN_F32_LOSS_RTOL, ``lm_head.w`` and layer 0's ``attn.wq.w``
    gradients within LM_TRAIN_F32_GRAD_RTOL x max |g|.  Returns the
    counts."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.steps import (make_train_step, model_params,
                                          value_and_grad)
    from repro_torch.kernels.bounds import PEAK_BF16_FLOPS
    from repro_torch.models import attention as A
    from repro_torch.models import init_model, param_count
    from repro_torch.optim import adam_init

    cfg = get_config(LM_QWEN)
    b, t, n = LM_TRAIN["batch"], LM_TRAIN["seq"], LM_TRAIN["steps"]
    params = model_params(init_model(cfg, "cuda", seed=0))
    nparams = param_count(params)
    require(nparams == LM_QWEN_PARAMS, f"{nparams} parameters")
    state = {"params": params, "opt": adam_init(params)}
    del params
    step = make_train_step(cfg, lr=LM_TRAIN["lr"],
                           grad_clip=LM_TRAIN["grad_clip"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    batches = [synthetic_batch(cfg, b, t, i, device="cuda")
               for i in range(n)]
    losses, norms, secs = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))      # syncs the card
        norms.append(float(metrics["grad_norm"]))
        secs.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = lm_train_want(F, cfg, b, t, n)
    require(want == {"flash_forward": 2 * cfg.num_layers * n,
                     "flash_combine": 0, "flash_forward_cluster": 0},
            f"expected launches {want}")
    want["threefry_bits"] = threefry_per_batch(cfg) * n
    require_counts(counts, want)
    require(all(np.isfinite(losses)) and all(np.isfinite(norms)),
            f"non-finite loss or gradient norm: {losses}, {norms}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    step_s = statistics.median(secs[1:])
    tokens = b * t
    tflops = 6 * nparams * tokens / step_s / 1e12

    # one step without remat, for its peak memory
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        no_remat = make_train_step(dataclasses.replace(cfg, remat=False))
        s2, _ = no_remat(state, batches[0])
        torch.cuda.synchronize()
        peak_no_remat = torch.cuda.max_memory_allocated() / 1e9
        del s2
    except torch.cuda.OutOfMemoryError:
        peak_no_remat = "did not fit"
    torch.cuda.empty_cache()

    attn_fwd, attn_bwd = attention_costs(torch, fops, cfg, b, t)
    head_fwd, head_bwd = head_costs(torch, state["params"], cfg, b, t)
    step_ms = step_s * 1e3
    emit("lm_train_run", model=LM_QWEN, params=nparams,
         dtype=cfg.param_dtype, moments="float32", remat=cfg.remat,
         remat_policy=cfg.remat_policy, batch=b, seq=t, steps=n,
         cuts=LM_TRAIN_CUTS, lr=LM_TRAIN["lr"], losses=losses,
         grad_norms=norms, step_ms=step_ms, step_ms_all=[s * 1e3
                                                         for s in secs],
         tokens_per_s=tokens / step_s, peak_memory_gb=peak_gb,
         peak_memory_gb_no_remat=peak_no_remat, model_tflops=tflops,
         mfu=tflops * 1e12 / PEAK_BF16_FLOPS,
         attention_fwd_ms_per_layer=attn_fwd,
         attention_bwd_ms_per_layer=attn_bwd,
         attention_bwd_share=cfg.num_layers * attn_bwd / step_ms,
         attention_fwd_share=2 * cfg.num_layers * attn_fwd / step_ms,
         head_fwd_ms=head_fwd, head_bwd_ms=head_bwd,
         head_share=(head_fwd + head_bwd) / step_ms,
         launches={k: counts[k] for k in want}, expected=want,
         nvidia_smi=nvidia_smi_line())
    del state, batches
    torch.cuda.empty_cache()

    # float32 at the same size: the kernel route against the oracle route
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params = model_params(init_model(cfg32, "cuda", seed=0))
    batch = synthetic_batch(cfg32, b, t, 0, device="cuda")
    keep = ("lm_head.w", "blocks.0.attn.wq.w")
    (k_loss, _), grads = value_and_grad(cfg32)(params, batch)
    k_grads = {k: grads[k] for k in keep}
    del grads
    saved = A.flash_attention
    A.flash_attention = lm_oracle_attention(fops)
    try:
        kernels.reset_launch_counts()
        (o_loss, _), grads = value_and_grad(cfg32)(params, batch)
        oracle_counts = kernels.launch_counts()
    finally:
        A.flash_attention = saved
    require(not any(oracle_counts[k] for k in FLASH),
            f"the oracle route launched {oracle_counts}")
    o_grads = {k: grads[k] for k in keep}
    del grads
    loss_err = abs(float(k_loss) - float(o_loss)) / abs(float(o_loss))
    require(loss_err <= LM_TRAIN_F32_LOSS_RTOL,
            f"f32 kernel vs oracle loss {loss_err:.3g}")
    grad_errs = {k: check(f"f32 grad {k}", k_grads[k], o_grads[k],
                          rtol=LM_TRAIN_F32_GRAD_RTOL) for k in keep}
    emit("lm_train_checks", model=LM_QWEN, dtype="float32",
         kernel_loss=float(k_loss), oracle_loss=float(o_loss),
         loss_rel_err=loss_err, loss_rtol=LM_TRAIN_F32_LOSS_RTOL,
         grad_max_abs_err=grad_errs,
         grad_max_abs={k: float(o_grads[k].abs().max()) for k in keep},
         grad_rtol=LM_TRAIN_F32_GRAD_RTOL)
    del params, batch, k_grads, o_grads
    torch.cuda.empty_cache()
    return counts


def final_params(directory):
    """The arrays of the newest checkpoint in ``directory``."""
    from repro_torch.runtime.checkpoint import CheckpointManager
    mgr = CheckpointManager(directory)
    step = mgr.latest_step()
    path = os.path.join(directory, f"step-{step:09d}", "arrays.npz")
    with np.load(path) as data:
        return step, {k: data[k] for k in data.files}


def lm_train_recovery_run(torch, kernels, F):
    """Phase 22: the train CLI's ``main`` on the card at the 10m preset,
    30 steps, a ``WorkerFailure`` injected at step 15 with checkpoints
    every 10 steps, in a temporary directory: one restart, 30 steps, and
    the final checkpoint's arrays (parameters, moments, step) bitwise
    those of the same run uninterrupted.  Then ``--compress-grads``: the
    loss falls.  Counts set to 0 just before each run and read just
    after: 6 ``flash_forward`` launches per step run (35 steps with the
    replay from step 10), and the batches' ``threefry_bits`` (36 batches:
    the failed step's too).  Returns the summed counts."""
    import tempfile

    from repro_torch.configs import get_config
    from repro_torch.launch.train import PRESETS, main
    from repro_torch.models import reduced_config

    cfg = reduced_config(get_config(LM_QWEN), **PRESETS["10m"])
    total = {k: 0 for k in FLASH + ("threefry_bits",)}
    runs = {}
    with tempfile.TemporaryDirectory() as root:
        for name, extra, steps_run, batches in (
                ("failed", LM_RECOVERY, 35, 36),
                ("clean", LM_RECOVERY[:4] + LM_RECOVERY[6:], 30, 30),
                ("compressed", LM_RECOVERY[:4] + ["--compress-grads"], 30,
                 30)):
            d = os.path.join(root, name)
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            stats = main(extra + ["--ckpt-dir", d])
            seconds = time.perf_counter() - t0
            counts = kernels.launch_counts()
            want = lm_train_want(F, cfg, 8, 128, steps_run)
            want["threefry_bits"] = threefry_per_batch(cfg) * batches
            require_counts(counts, want)
            runs[name] = (stats, final_params(d))
            emit("lm_train_recovery_run", run=name, argv=extra,
                 stats=stats, seconds=seconds,
                 launches={k: counts[k] for k in want}, expected=want)
            for k in total:
                total[k] += counts[k]
    (fs, (fstep, fa)), (cs, (cstep, ca)) = runs["failed"], runs["clean"]
    require(fs["restarts"] == 1 and fs["steps"] == 30,
            f"recovery run: {fs}")
    require(fstep == cstep == 30 and sorted(fa) == sorted(ca),
            "final checkpoints differ in layout")
    differ = [k for k in fa if fa[k].tobytes() != ca[k].tobytes()]
    require(not differ, f"resumed run not bitwise the clean run: {differ}")
    comp = runs["compressed"][0]
    require(comp["last_loss"] < comp["first_loss"],
            f"compressed run's loss did not fall: {comp}")
    emit("lm_train_recovery_checks", bitwise=True, leaves=len(fa),
         losses={k: (v[0]["first_loss"], v[0]["last_loss"])
                 for k, v in runs.items()})
    return total


LM_DRYRUN_FAMILIES = {            # one arch per other family, (16, 16)
    "granite-moe-3b-a800m": ("decode_32k",),
    "mamba2-370m": ("decode_32k", "long_500k"),
    "jamba-v0.1-52b": ("decode_32k", "long_500k"),
    "whisper-small": ("decode_32k",),
    "llama-3.2-vision-90b": ("decode_32k",),
}
LM_DRYRUN_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
# the three cells on one card: (cell, seq, global batch)
LM_MESH_CELLS = (("train_4k", 4096, 2), ("prefill_32k", 32768, 1),
                 ("decode_32k", 32768, 8))
LM_MESH_CUTS = ["train_4k: global batch 256 -> 2 (lm_train_run's cut)",
                "prefill_32k: global batch 32 -> 1",
                "decode_32k: global batch 128 -> 8 (a 25.8 GB bf16 cache), "
                "4 steps at positions 32764..32767 of a random-filled cache"]
LM_MESH_DECODE_STEPS = 4


DRYRUN_CHILD = r"""
import json, os, sys, time
root, out, qwen, shapes, families = sys.argv[1:6]
sys.path.insert(0, os.path.join(root, "src"))
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
shapes, families = json.loads(shapes), json.loads(families)
t0 = time.perf_counter()
records = (dryrun.run([qwen], shapes, "single")
           + dryrun.run([qwen], shapes, "multi"))
for arch, cells in families.items():
    records += dryrun.run([arch], cells, "single")
lm_s = time.perf_counter() - t0
paper = (dryrun.run([], [], "single", paper=True)
         + dryrun.run([], [], "multi", paper=True))
from repro_torch.bench import hillclimb
from repro_torch.launch.mesh import make_production_mesh
dryrun.init_fake_group(256)
try:
    variants = hillclimb.run_paper_variants(make_production_mesh())
finally:
    dryrun.destroy_group()
with open(out, "w") as f:
    json.dump({"records": records, "paper": paper, "paper_sort": variants,
               "lm_seconds": lm_s, "seconds": time.perf_counter() - t0}, f)
"""


def start_lm_dryrun():
    """Start ``lm_dryrun_run``'s records in a child process: host work on
    ``meta`` tensors under its own fake group, which overlaps the card's
    phases.  The child is killed at exit if it is still running."""
    import atexit
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    out, log = os.path.join(tmp, "records.json"), os.path.join(tmp, "log")
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", DRYRUN_CHILD, ROOT, out, LM_QWEN,
             json.dumps(LM_DRYRUN_SHAPES), json.dumps(LM_DRYRUN_FAMILIES)],
            stdout=f, stderr=subprocess.STDOUT)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    atexit.register(stop)
    return proc, out, log


def lm_dryrun_run(torch, child):
    """Phase 23: the dry-run records (``repro_torch.launch.dryrun.run``,
    each mesh under its own fake group, destroyed after) of Qwen1.5-0.5B
    in the four cells on both meshes and of one arch per other family,
    made by the child of ``start_lm_dryrun``; each cell's status as the
    reference's, its per-device argument bytes within the card's memory.
    Returns the records."""
    from repro_torch.bench.roofline import analyze

    proc, out, log = child
    memory = torch.cuda.get_device_properties(0).total_memory
    t0 = time.perf_counter()
    rc = proc.wait(timeout=600)
    with open(log) as f:
        tail = f.read()[-2000:]
    require(rc == 0 and os.path.exists(out),
            f"the dry-run child exited {rc}: {tail}")
    with open(out) as f:
        done = json.load(f)
    records, seconds = done["records"], done["seconds"]
    rows = {(r["arch"], r["shape"], r["mesh"]): r for r in analyze(records)}
    for rec in records:
        want = ("skipped" if rec["shape"] == "long_500k"
                and rec["arch"] == LM_QWEN else "ok")
        require(rec["status"] == want, f"dry-run {rec['arch']} x "
                f"{rec['shape']} x {rec['mesh']}: {rec['status']} "
                f"{rec.get('error', '')}")
        if rec["status"] != "ok":
            emit("lm_dryrun_run", **rec)
            continue
        args = rec["memory_analysis"]["argument_size_in_bytes"]
        require(args <= memory, f"{rec['arch']} x {rec['shape']} x "
                f"{rec['mesh']}: {args} argument bytes per device")
        emit("lm_dryrun_run", arch=rec["arch"], shape=rec["shape"],
             mesh=rec["mesh"], status=rec["status"],
             argument_size_in_bytes=args,
             output_size_in_bytes=rec["memory_analysis"][
                 "output_size_in_bytes"],
             roofline_inputs=rec["roofline_inputs"],
             collectives={k: v for k, v in rec["collectives"].items()
                          if k == "total_bytes" or v["count"]},
             roofline_h100=rows[(rec["arch"], rec["shape"], rec["mesh"])],
             run_s=rec["run_s"])
    paper_dryrun_checks(done["paper"], done["paper_sort"])
    emit("lm_dryrun_summary", records=len(records), seconds=seconds,
         lm_seconds=done["lm_seconds"], waited_s=time.perf_counter() - t0,
         memory_per_device=memory)
    return records


# The paper cell's wire bytes per device at N = 2^20, d = 59 (the hand
# arithmetic of repro_torch.launch.paper's docstring), by mesh.
PAPER_COLLECTIVE_BYTES = {"single": 475_791_360, "multi": 253_755_392}


def paper_dryrun_checks(paper, variants):
    """The dry-run child's paper records: the cell (``--paper``) on both
    meshes, ``ok``, its wire bytes the hand arithmetic; hillclimb's five
    ``paper_sort`` variants on (16, 16), each one's wire bytes its own
    (``paper_sort_collectives``).  Each emitted with its roofline terms
    at the H100's peaks."""
    from repro_torch.bench.hillclimb import PAPER_VARIANTS
    from repro_torch.bench.roofline import HBM_BW, LINK_BW, PEAK_FLOPS
    from repro_torch.launch.paper import paper_sort_collectives

    require(sorted(r["mesh"] for r in paper) == ["multi", "single"],
            f"paper records: {[r.get('mesh') for r in paper]}")
    for rec in paper:
        require(rec["status"] == "ok", f"paper cell x {rec['mesh']}: "
                f"{rec['status']} {rec.get('error', '')}")
        coll = rec["collectives"]["total_bytes"]
        require(coll == PAPER_COLLECTIVE_BYTES[rec["mesh"]],
                f"paper cell x {rec['mesh']}: {coll} wire bytes, hand "
                f"arithmetic {PAPER_COLLECTIVE_BYTES[rec['mesh']]}")
        cost = rec["cost_analysis"]
        terms = {"compute_s": cost["flops"] / PEAK_FLOPS,
                 "memory_s": cost["bytes_accessed"] / HBM_BW,
                 "collective_s": coll / LINK_BW}
        emit("paper_dryrun", **rec, roofline_h100=dict(
            terms, bound_s=max(terms.values())))
    require([v["variant"] for v in variants] == [
        v[0] for v in PAPER_VARIANTS], f"paper_sort: {variants}")
    for rec, (_, chunk, bf16, all_axes) in zip(variants, PAPER_VARIANTS):
        want = paper_sort_collectives(1 << 20, 59, chunk,
                                      256 if all_axes else 16,
                                      2 if bf16 else 4)["total_bytes"]
        require(abs(rec["coll"] - want) <= 1e-9 * want,
                f"paper_sort {rec['variant']}: {rec['coll']} wire bytes, "
                f"hand arithmetic {want}")
        emit("paper_sort_variant", **rec)


def _same(torch, got, want, what):
    """``got`` (DTensors on a one-rank mesh, or tensors) bitwise ``want``,
    leaf by leaf."""
    from repro_torch.tree import flatten
    gl, gs = flatten(got)
    wl, ws = flatten(want)
    require(gs == ws, f"{what}: trees differ")
    for i, (g, w) in enumerate(zip(gl, wl)):
        g = g.to_local() if hasattr(g, "to_local") else g
        require(g.dtype == w.dtype and g.shape == w.shape
                and torch.equal(g, w), f"{what}: leaf {i} differs")
    return len(gl)


def _tensor_bytes(tree):
    from repro_torch.tree import flatten
    return sum(t.numel() * t.element_size() for t in flatten(tree)[0]
               if hasattr(t, "numel"))


def lm_mesh_run(torch, kernels, F):
    """Phase 24: the builders' steps on a (1, 1) mesh against the
    unsharded path, bitwise, on the card (see the module docstring).
    Returns the flash counts of the builders' steps."""
    import torch.distributed as dist

    from repro_torch.bench.roofline import model_flops
    from repro_torch.configs import get_config
    from repro_torch.kernels.bounds import PEAK_BF16_FLOPS
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_model
    from repro_torch.models.config import ShapeCell

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    total = {k: 0 for k in FLASH}
    try:
        mesh = make_production_mesh(shape=(1, 1))
        require(mesh.device_type == "cuda", f"mesh on {mesh.device_type}")
        cfg = get_config(LM_QWEN)
        model = init_model(cfg, "cuda", seed=0)
        params = steps.model_params(model)
        for name, seq, batch in LM_MESH_CELLS:
            cell = ShapeCell(name, seq, batch, name.split("_")[0])
            low = steps.lower_cell(cfg, cell, mesh)
            fn = {"train": _mesh_train, "prefill": _mesh_prefill,
                  "decode": _mesh_decode}[cell.kind]
            counts, fields = fn(torch, kernels, F, cfg, model, params, low,
                                cell)
            for k in FLASH:
                total[k] += counts[k]
            mf = model_flops(LM_QWEN, "decode_32k" if cell.kind == "decode"
                             else name, cell.kind)
            # model_flops reads the published cell; scale to the cut
            full = {"train": 256 * 4096, "prefill": 32 * 32768,
                    "decode": 128}[cell.kind]
            cut = batch * (1 if cell.kind == "decode" else seq)
            mf = mf / full * cut
            step_s = fields["step_ms"] / 1e3
            emit("lm_mesh_run", model=LM_QWEN, cell=name, seq=seq,
                 batch=batch, cuts=LM_MESH_CUTS, mesh=[1, 1],
                 model_flops=mf, roofline_frac=mf / PEAK_BF16_FLOPS / step_s,
                 flops_over_model_flops=fields["cost_flops"] / mf,
                 nvidia_smi=nvidia_smi_line(), **fields)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return total


# paper_round_run: the paper cell's round cut to one card, at N = 2^14
# (5 timed rounds) and at N = 2^16, the largest power of two whose
# autograd fits on an 80 GB card (3 timed rounds): the plain chunked
# apply keeps ~2.5 N^2 float32 of score blocks, 2.7 GB at 2^14, ~43 GB at
# 2^16 and ~172 GB at 2^17.
PAPER_ROUND = dict(d=59, chunk=512, inner_steps=2, tau=1.0)
PAPER_ROUND_SIZES = [dict(n=1 << 14, hw=(128, 128), reps=5),
                     dict(n=1 << 16, hw=(256, 256), reps=3)]


def paper_round_run(torch):
    """Phase 25: the paper cell's per-shard round
    (``repro_torch.launch.paper.paper_round``, the dry-run's ``--paper``)
    on an ``nccl`` group of one rank, at ``PAPER_ROUND`` and each of
    ``PAPER_ROUND_SIZES``: N uniform 59-d rows on the square grid, the
    plain chunked apply at chunk 512, 2 inner steps, tau_r = 1.0.  Its
    order and loss bitwise the unsharded ``_outer_round`` with
    ``softsort_apply_chunked`` on the card, on the same shuffle; exactly
    one ``threefry_round`` launch per round and no other kernel of the
    package; host ms per round (a sync, the first apart, the median of
    ``reps``), peak memory.

    The full N = 2^20 stays a dry-run (``lm_dryrun_run``'s paper records):
    the plain chunked apply's autograd keeps each chunk's score block for
    the backward, 2048 blocks of 512 x 2^20 float32 = 4 TiB, and the
    reference records no memory for the cell either.  N = 2^16 is the
    largest power of two that fits on the card.  Returns the path's
    launch counts."""
    import functools

    import torch.distributed as dist

    from repro_torch.core import threefry as tf
    from repro_torch.core.losses import mean_pairwise_distance
    from repro_torch.core.shufflesoftsort import (ShuffleSoftSortConfig,
                                                  _adam_bias, _inner_ramp,
                                                  _outer_round)
    from repro_torch.core.softsort import softsort_apply_chunked
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.paper import paper_round

    c = PAPER_ROUND
    dev = torch.device("cuda", 0)
    tau = torch.tensor(c["tau"], dtype=torch.float32, device=dev)
    cfg = ShuffleSoftSortConfig(inner_steps=c["inner_steps"],
                                chunk=c["chunk"])
    total = 0
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, device_id=dev)
    try:
        for size in PAPER_ROUND_SIZES:
            n, hw, reps = size["n"], tuple(size["hw"]), size["reps"]
            rng = np.random.default_rng(31)
            x = torch.as_tensor(rng.random((n, c["d"]), dtype=np.float32),
                                device=dev)
            order = torch.as_tensor(rng.permutation(n).astype(np.int32),
                                    device=dev)
            key = torch.as_tensor(tf.prng_key(31).astype(np.int64),
                                  device=dev)
            norm = mean_pairwise_distance(x).reshape(())

            def run():
                return paper_round(x, order, key, tau, norm, hw=hw, cfg=cfg,
                                   group=dist.group.WORLD)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            new, loss = run()
            torch.cuda.synchronize()
            first_ms = (time.perf_counter() - t0) * 1e3
            launched = {k: v for k, v in launch_counts().items() if v}
            require(launched == {"threefry_round": 1},
                    f"one paper round at N = {n} launched {launched}")
            peak = torch.cuda.max_memory_allocated()
            _, median_ms, all_ms = _timed_steps(torch, run, reps + 1)
            path = launch_counts()["threefry_round"]
            require(path == reps + 2,
                    f"{reps + 2} paper rounds at N = {n} launched {path} "
                    "threefry_round kernels")
            total += path
            # the unsharded round on the same shuffle (not the path's draw)
            shuf = tf.permutation(key, n)
            ramp = torch.as_tensor(_inner_ramp(cfg), device=dev)
            want_order, want_loss, _ = _outer_round(
                x[None], order.to(torch.int64)[None], shuf[None],
                (tau * ramp)[None], norm.reshape(1), *_adam_bias(cfg, dev),
                hw=hw, cfg=cfg, apply_fn=functools.partial(
                    softsort_apply_chunked, chunk=c["chunk"]))
            require(new.dtype == torch.int32 and torch.equal(
                new.to(torch.int64), want_order[0]),
                    f"the paper round's order at N = {n} != the unsharded "
                    "round's")
            require(torch.equal(loss, want_loss[0]),
                    f"the paper round's loss {float(loss)!r} at N = {n} != "
                    f"the unsharded round's {float(want_loss[0])!r}")
            require(bool(torch.isfinite(loss)),
                    f"paper round loss {float(loss)}")
            emit("paper_round_run", **c, n=n, hw=hw, reps=reps,
                 cuts=[f"N = 2^20 -> 2^{n.bit_length() - 1} and the grid "
                       f"1024 x 1024 -> {hw[0]} x {hw[1]} (one card; see "
                       "paper_round_run)"],
                 first_ms=first_ms, median_ms=median_ms, all_ms=all_ms,
                 peak_memory_bytes=peak, loss=float(loss),
                 order_bitwise=True, loss_bitwise=True,
                 threefry_round_per_round=1, launches=path,
                 nvidia_smi=nvidia_smi_line())
            del x, new, loss, want_order, want_loss, shuf
    finally:
        dist.destroy_process_group()
        torch.cuda.empty_cache()
    return {"threefry_round": total}


def _timed_steps(torch, run, n):
    """Host ms of ``n`` calls of ``run`` (a sync after each), the first
    apart: (first, median of the rest, all)."""
    secs = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        secs.append((time.perf_counter() - t0) * 1e3)
    return secs[0], statistics.median(secs[1:]), secs


def _cost_flops(torch, run):
    from repro_torch.launch.dryrun import CostMode
    with CostMode() as mode:
        run()
    torch.cuda.synchronize()
    return float(mode.flops)


def _mesh_train(torch, kernels, F, cfg, model, params, low, cell):
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import adam_init
    b, t = cell.global_batch, cell.seq_len
    state = {"params": params, "opt": adam_init(params)}
    batch = synthetic_batch(cfg, b, t, 0, device="cuda")
    want_state, want_m = make_train_step(cfg)(state, batch)
    want_bytes = _tensor_bytes((state, batch))
    require(low.argument_bytes() == want_bytes,
            f"train argument bytes {low.argument_bytes()} != {want_bytes}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got_state, got_m = low(state, batch)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = lm_train_want(F, cfg, b, t)
    require_counts(counts, want)
    leaves = _same(torch, (got_state, got_m), (want_state, want_m),
                   "train step")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del want_state, got_state
    first, step_ms, all_ms = _timed_steps(torch, lambda: low(state, batch), 3)
    cost = _cost_flops(torch, lambda: low(state, batch))
    return counts, dict(bitwise=True, leaves=leaves,
                        argument_bytes=want_bytes, peak_memory_gb=peak,
                        first_ms=first, step_ms=step_ms, step_ms_all=all_ms,
                        cost_flops=cost, loss=float(want_m["loss"]),
                        launches={k: counts[k] for k in FLASH},
                        expected=want)


def _mesh_prefill(torch, kernels, F, cfg, model, params, low, cell):
    from repro_torch.models import model as model_lib
    b, t = cell.global_batch, cell.seq_len
    g = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (b, t), device="cuda",
                           generator=g, dtype=torch.int32)
    with torch.no_grad():
        want = model_lib.prefill(model, tokens)
    want_bytes = _tensor_bytes((params, tokens))
    require(low.argument_bytes() == want_bytes,
            f"prefill argument bytes {low.argument_bytes()} != {want_bytes}")
    require(tuple(want[0].shape) == (b, 1, cfg.padded_vocab),
            f"prefill logits {tuple(want[0].shape)}: not the last position")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got = low(params, tokens)
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    calls = [(b * cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads * t,
              t)] * cfg.num_layers
    expect = flash_routes(F, calls, cfg.resolved_head_dim)
    require_counts(counts, expect)
    leaves = _same(torch, got, want, "prefill")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del got, want
    first, step_ms, all_ms = _timed_steps(torch, lambda: low(params, tokens),
                                          3)
    cost = _cost_flops(torch, lambda: low(params, tokens))
    return counts, dict(bitwise=True, leaves=leaves,
                        argument_bytes=want_bytes, peak_memory_gb=peak,
                        first_ms=first, step_ms=step_ms, step_ms_all=all_ms,
                        cost_flops=cost,
                        launches={k: counts[k] for k in FLASH},
                        expected=expect)


def _mesh_decode(torch, kernels, F, cfg, model, params, low, cell):
    from repro_torch.models import model as model_lib
    b, s = cell.global_batch, cell.seq_len
    g = torch.Generator(device="cuda").manual_seed(2)
    caches = model_lib.make_caches(cfg, b, s, torch.bfloat16, "cuda")
    for c in caches:
        for t in c:
            t.normal_(generator=g)
    token = torch.randint(0, cfg.vocab_size, (b, 1), device="cuda",
                          generator=g, dtype=torch.int32)
    pos = s - LM_MESH_DECODE_STEPS
    want_bytes = _tensor_bytes((params, token, caches)) + 4
    require(low.argument_bytes() == want_bytes,
            f"decode argument bytes {low.argument_bytes()} != {want_bytes}")
    saved = [(c.k[:, pos].clone(), c.v[:, pos].clone()) for c in caches]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    got_logits, _ = low(params, token, caches,
                        torch.tensor(pos, dtype=torch.int32))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    calls = [(b * cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads, s)
             ] * cfg.num_layers
    expect = flash_routes(F, calls, cfg.resolved_head_dim)
    require_counts(counts, expect)
    written = [(c.k[:, pos].clone(), c.v[:, pos].clone()) for c in caches]
    for c, (k, v) in zip(caches, saved):        # the cache as it was
        c.k[:, pos], c.v[:, pos] = k, v
    with torch.no_grad():
        want_logits, _ = model_lib.decode_step(model, token, caches, pos)
    want_written = [(c.k[:, pos].clone(), c.v[:, pos].clone())
                    for c in caches]
    leaves = _same(torch, got_logits, want_logits, "decode logits")
    leaves += _same(torch, written, want_written, "decode cache writes")
    peak = torch.cuda.max_memory_allocated() / 1e9
    steps_run = iter(range(pos, s))
    first, step_ms, all_ms = _timed_steps(torch, lambda: low(
        params, token, caches, torch.tensor(next(steps_run),
                                            dtype=torch.int32)),
        LM_MESH_DECODE_STEPS)
    cost = _cost_flops(torch, lambda: low(params, token, caches,
                                          torch.tensor(s - 1,
                                                       dtype=torch.int32)))
    del caches
    return counts, dict(bitwise=True, leaves=leaves,
                        argument_bytes=want_bytes, peak_memory_gb=peak,
                        first_ms=first, step_ms=step_ms, step_ms_all=all_ms,
                        cost_flops=cost, decode_position=pos,
                        launches={k: counts[k] for k in FLASH},
                        expected=expect)


def draw_digest(t):
    """sha256 (16 hex digits) of a draw: float32 values, or words and
    indices as uint32."""
    import hashlib
    a = t.detach().cpu().numpy() if hasattr(t, "detach") else np.asarray(t)
    raw = (a.astype(np.float32).tobytes() if a.dtype.kind == "f"
           else a.astype(np.int64).astype(np.uint32).tobytes())
    return hashlib.sha256(raw).hexdigest()[:16]


def threefry_draws(tf, device, partitionable):
    """The draws ``THREEFRY_DIGESTS`` holds, on ``device``."""
    kw = dict(partitionable=partitionable)
    k0 = tf.prng_key(0)
    keys8 = tf.split(k0, 8, device=device, **kw)
    return {
        "split_8": keys8,
        "bits_8x4096": tf.random_bits(keys8, (4096,), **kw),
        "bits_1x1048576": tf.random_bits(k0, (1048576,), device=device,
                                         **kw),
        "bits_3x1001": tf.random_bits(
            tf.split(tf.prng_key(3), 3, device=device, **kw), (1001,), **kw),
        "permutation_8x4096": tf.permutation(keys8, 4096, **kw),
        "uniform_1024x3": tf.uniform(tf.prng_key(42), (1024, 3),
                                     device=device, **kw),
    }


def threefry_sass(build):
    """The integer instruction mix of the built threefry library's
    ``threefry_round_kernel`` (``cuobjdump -sass``), and per hash (its
    SHF.L.W rotations / 20) the hash's opcodes: the rotations, the xors
    (LOP3.LUT) and the adds (IMAD.IADD, IADD3, VIADD), and their sums on
    the INT32 (ALU) pipe (SHF, LOP3, IADD3) and the FMA pipe (IMAD.IADD,
    and VIADD counted there), ``kernels/bounds.py``'s
    THREEFRY_ALU_OPS_PER_HASH and THREEFRY_FMA_OPS_PER_HASH."""
    import re
    import shutil
    from pathlib import Path
    tool = str(Path(build.nvcc_path()).with_name("cuobjdump"))
    if not Path(tool).exists():
        tool = shutil.which("cuobjdump")
    lib = build._lib_path(build.CSRC / "threefry.cu")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=120).stdout
    mix, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            inside = "threefry_round_kernel" in line
            continue
        hit = re.search(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                        line)
        if inside and hit:
            op = hit.group(1)
            mix[op] = mix.get(op, 0) + 1
    alu, fma = ("SHF.L.W.U32.HI", "LOP3.LUT", "IADD3"), ("IMAD.IADD", "VIADD")
    hashes = mix.get("SHF.L.W.U32.HI", 0) / 20      # 20 rotations a hash
    per_hash = {k: mix.get(k, 0) / hashes for k in alu + fma} if hashes \
        else {}
    pipe = (lambda ops: sum(per_hash[k] for k in ops) if hashes  # noqa: E731
            else None)
    return {"hashes_in_kernel": hashes, "per_hash": per_hash,
            "ops_per_hash": pipe(alu + fma), "alu_ops_per_hash": pipe(alu),
            "fma_ops_per_hash": pipe(fma),
            "mix": dict(sorted(mix.items(), key=lambda kv: -kv[1]))}


def threefry_run(torch, core):
    """The threefry kernels bitwise their twins on the card:
    ``threefry_bits`` in every layout at ``THREEFRY_SHAPES``, ``fold_in``
    on the kernel's FOLD layout at ``FOLD_DATA`` over a batch of keys, and
    the fused shuffle round (``threefry_round``) in both layouts, with
    and without the source's split, at ``THREEFRY_ROUND_SHAPES``;
    ``threefry_given`` (``threefry_2x32`` of counts on the card) at
    ``THREEFRY_COUNTS`` and the known-answer vectors; the draws bitwise jax's
    (``THREEFRY_DIGESTS``); the ms of one shuffle round of main_run's
    shape (B.S = 8, N = 4096) from ``ThreefryShuffleSource`` beside
    ``TorchShuffleSource`` and its launches; each kernel's times beside
    its bound (``kernels/bounds.py``) and the launch floor (an empty
    kernel in a graph of 100), ``threefry_given``'s at 4096 words (it is
    on no main path, so it has no row in the kernels line).  Returns the
    kernels' stats for the kernels line: ``threefry_bits`` at the paper
    table's Gumbel noise shape, ``threefry_round`` at main_run's round."""
    import ctypes
    import importlib

    from repro_torch.core import threefry as tf
    from repro_torch.kernels import clib
    from repro_torch.kernels.bounds import (threefry_bound_ms,
                                            threefry_given_bound_ms,
                                            threefry_round_bound_ms)
    TK = importlib.import_module("repro_torch.kernels.threefry")

    dev = torch.device("cuda")
    checked = []
    TK.threefry_given.launches = 0
    for key, count, want in THREEFRY_KNOWN:
        got = tf.threefry_2x32(np.array(key, np.uint32),
                               np.array(count, np.uint32), device=dev)
        require(got.tolist() == list(want),
                f"threefry_2x32{key, count}: {got.tolist()} != {want}")
    require(TK.threefry_given.launches == len(THREEFRY_KNOWN),
            f"threefry_2x32 on the card: {TK.threefry_given.launches} "
            f"launches for {len(THREEFRY_KNOWN)} hashes")
    # Queue C15: counts of any shape, on the card, one launch each
    from repro_torch.kernels import launch_counts, reset_launch_counts
    rng = np.random.default_rng(15)
    for shape in THREEFRY_COUNTS:
        key = rng.integers(0, 2 ** 32, 2, dtype=np.uint32)
        count = rng.integers(0, 2 ** 32, shape, dtype=np.uint32)
        on_card = torch.as_tensor(count.astype(np.int64), device=dev)
        reset_launch_counts()
        got = tf.threefry_2x32(key, on_card, device=dev)
        launched = {k: v for k, v in launch_counts().items() if v}
        require(launched == {"threefry_given": 1},
                f"threefry_2x32 of a {shape} count launched {launched}")
        require(tuple(got.shape) == shape and torch.equal(
            got.cpu(), tf.threefry_2x32(key, count, device="cpu")),
                f"threefry_2x32 of a {shape} count on the card != its twin")
    got = TK.threefry_bits(torch.zeros((1, 2), dtype=torch.int64,
                                       device=dev), 2, TK.PAIRS)
    require(TK.words(got)[0].tolist() == list(THREEFRY_KNOWN[0][2]),
            f"kernel counter 0 of key 0: {got.tolist()}")
    err = 0
    for r, m in THREEFRY_SHAPES:
        keys = tf.split(tf.prng_key(r + m), r, device=dev)
        for mode in (TK.XOR, TK.ORIGINAL, TK.PAIRS, TK.FOLD):
            mm = m + (m % 2 if mode in (TK.PAIRS, TK.FOLD) else 0)
            a = TK.threefry_bits(keys, mm, mode, 7)
            b = TK.threefry_bits_plain(keys, mm, mode, 7)
            torch.cuda.synchronize()
            require(torch.equal(a, b),
                    f"threefry kernel != twin at {(r, mm)} mode {mode}")
            err = max(err, int((a.long() - b.long()).abs().max()))
            checked.append([r, mm, mode])
    # fold_in: one counted launch, bitwise its twin on the host
    keys = tf.split(tf.prng_key(11), 6, device=dev)
    for data in FOLD_DATA:
        TK.threefry_bits.launches = 0
        got = tf.fold_in(keys, data)
        require(TK.threefry_bits.launches == 1,
                f"fold_in launched {TK.threefry_bits.launches} kernels")
        want = tf.fold_in(keys.cpu(), data)
        require(torch.equal(got.cpu(), want), f"fold_in(keys, {data}) on "
                f"the card != its twin")
    # the fused round against its twin, and against the unfused draws
    rounds_checked = []
    for r, n in THREEFRY_ROUND_SHAPES:
        keys = tf.split(tf.prng_key(r * n), r, device=dev)
        for part in (True, False):
            for split_keys in (True, False):
                rounds = TK.permutation_rounds(n)
                TK.threefry_round.launches = 0
                kept, words_ = TK.threefry_round(keys, n, rounds, part,
                                                 split_keys)
                launched = int(split_keys or bool(rounds and n))
                require(TK.threefry_round.launches == launched,
                        "threefry_round launched "
                        f"{TK.threefry_round.launches} kernels")
                kp, wp = TK.threefry_round_plain(keys, n, rounds, part,
                                                 split_keys)
                torch.cuda.synchronize()
                require(torch.equal(words_, wp) and (
                    kept is None and kp is None or torch.equal(kept, kp)),
                        f"threefry_round != twin at {(r, n)} "
                        f"partitionable={part} split={split_keys}")
                rounds_checked.append([r, n, rounds, part, split_keys])
    digests = {}
    for part in (True, False):
        got = {k: draw_digest(v) for k, v in
               threefry_draws(tf, dev, part).items()}
        require(got == THREEFRY_DIGESTS[part],
                f"threefry draws (partitionable={part}) {got} != jax's "
                f"{THREEFRY_DIGESTS[part]}")
        digests["partitionable" if part else "original"] = got

    # One shuffle round at main_run's shape, each source.
    n, bs = 4096, 8
    th = core.ThreefryShuffleSource(tf.split(tf.prng_key(0), bs,
                                             device=dev), n, dev)
    to = core.TorchShuffleSource(core.instance_seeds(0, bs), n, dev)
    round_ms = {"threefry": time_ms(torch, th.next_round),
                "torch": time_ms(torch, to.next_round)}
    for k_ in TK.KERNELS:
        k_.launches = 0
    th.next_round()
    per_round = {k_.__name__: k_.launches for k_ in TK.KERNELS}
    require(per_round == {"threefry_bits": 0, "threefry_round": 1,
                          "threefry_given": 0},
            f"one shuffle round launched {per_round}")

    noop = clib._symbol("threefry", "tf_noop", (clib.P,), ctypes.c_int)
    floor_ms = graph100_ms(torch, lambda: noop(
        torch.cuda.current_stream().cuda_stream))

    stats, times = {}, {}
    for r, m in THREEFRY_SHAPES[:2]:
        keys = tf.split(tf.prng_key(1), r, device=dev)
        kern = lambda: TK.threefry_bits(keys, m, TK.XOR)      # noqa: E731
        plain = lambda: TK.threefry_bits_plain(keys, m, TK.XOR)  # noqa: E731
        bound, by = threefry_bound_ms(r, m, TK.XOR)
        stats[(r, m)] = {"ms": time_ms(torch, kern),
                         "graph_ms": graph_ms(torch, kern),
                         "graph100_ms": graph100_ms(torch, kern),
                         "plain_ms": time_ms(torch, plain, reps=5),
                         "bound_ms": bound, "bound_by": by,
                         "library_ms": None, "max_abs_err": float(err),
                         "shape": [r, m]}
        times[f"bits_{r}x{m}"] = stats[(r, m)]
    keys = tf.split(tf.prng_key(1), bs, device=dev)
    rounds = TK.permutation_rounds(n)
    fused = lambda: TK.threefry_round(keys, n, rounds, True,  # noqa: E731
                                      True)
    twin = lambda: TK.threefry_round_plain(keys, n, rounds,  # noqa: E731
                                           True, True)
    bound, by = threefry_round_bound_ms(bs, n, rounds, True)
    rnd = {"ms": time_ms(torch, fused), "graph_ms": graph_ms(torch, fused),
           "graph100_ms": graph100_ms(torch, fused),
           "plain_ms": time_ms(torch, twin, reps=5), "bound_ms": bound,
           "bound_by": by, "library_ms": None, "max_abs_err": 0.0,
           "shape": [bs, n, rounds]}
    times[f"round_{bs}x{n}x{rounds}"] = rnd
    # threefry_given at its largest checked count, one key
    m = max(int(np.prod(c)) for c in THREEFRY_COUNTS)
    key1 = tf.prng_key(2)[None]
    keys = torch.as_tensor(key1.astype(np.int64), device=dev)
    counts = torch.as_tensor(np.random.default_rng(2).integers(
        0, 2 ** 32, m), device=dev)
    given = lambda: TK.threefry_given(keys, counts)  # noqa: E731
    plain = lambda: TK.threefry_given_plain(keys, counts)  # noqa: E731
    require(torch.equal(given(), plain()), "threefry_given != its twin")
    bound, by = threefry_given_bound_ms(1, m)
    times[f"given_1x{m}"] = {
        "ms": time_ms(torch, given), "graph_ms": graph_ms(torch, given),
        "graph100_ms": graph100_ms(torch, given),
        "plain_ms": time_ms(torch, plain, reps=5), "bound_ms": bound,
        "bound_by": by, "library_ms": None, "max_abs_err": 0.0,
        "shape": [1, m]}
    emit("threefry_run", known_answers=len(THREEFRY_KNOWN) + 1,
         kernel_vs_twin=checked, fold_in_data=list(FOLD_DATA),
         threefry_2x32_counts=[list(c) for c in THREEFRY_COUNTS],
         round_vs_twin=rounds_checked, bitwise=True, digests=digests,
         shuffle_round_ms=round_ms,
         threefry_launches_per_shuffle_round=sum(per_round.values()),
         launches_per_shuffle_round=per_round,
         launch_floor_graph100_ms=floor_ms, times=times)
    return {"threefry_bits": stats[THREEFRY_SHAPES[1]],
            "threefry_round": rnd}


def paper_table_step_check(torch, paper_table, n):
    """One SoftSort loss-and-gradient step of the table's SoftSort row on
    the kernel tier against the plain tier, on the table's colours: keys
    ``arange(N)`` at tau_start (the first step) and jittered keys at
    tau_end (late in the anneal), loss within rtol 1e-5 and the gradient
    within GRAD_RTOL of its maximum."""
    import dataclasses

    from repro_torch.core import shufflesoftsort as eng
    from repro_torch.core.losses import mean_pairwise_distance
    side = int(round(n ** 0.5))
    x = paper_table.colours(n, 42, "cuda")[None]
    cfg = paper_table.configs(n, "full", "kernel")[2]
    plain_cfg = dataclasses.replace(cfg, use_kernel=False)
    norm = mean_pairwise_distance(x[0]).reshape(1)
    ident = torch.arange(n, device="cuda")[None]
    g = torch.Generator().manual_seed(n)
    jitter = 0.8 * (torch.rand(1, n, generator=g) - 0.5)
    errs = {}
    for name, w0, tau in (("first_step", torch.zeros(1, n), cfg.tau_start),
                          ("late_step", jitter, cfg.tau_end)):
        w0 = (torch.arange(n, dtype=torch.float32)[None] + w0).cuda()
        t = torch.full((1,), tau, dtype=torch.float32, device="cuda")
        out = []
        for c in (cfg, plain_cfg):
            w = w0.clone().requires_grad_(True)
            loss = eng._loss_fn(w, x, ident, t, (side, side), norm, c,
                                eng._select_apply_fn(c))
            (grad,) = torch.autograd.grad(loss.sum(), w)
            out.append((loss.detach(), grad))
        (lk, gk), (lp, gp) = out
        torch.cuda.synchronize()
        errs[name] = {"loss": check(f"table step {name} loss", lk, lp,
                                    rtol=1e-5),
                      "grad": check(f"table step {name} grad", gk, gp,
                                    rtol=GRAD_RTOL)}
    emit("paper_table_step_check", shape=[1, n, 3], max_abs_err=errs)


def paper_table_run(torch, kernels):
    """The paper's Table III at N = 1024, ``budget="full"``, kernel tier
    (``repro_torch.bench.paper_table``), with its ``--check``, after one
    SoftSort step of the table held to the plain tier
    (``paper_table_step_check``).  Launch counts set to 0 just before the
    table and read just after; the SoftSort rows launch each dense kernel
    once per step (8000 steps each), and the Gumbel-Sinkhorn noise,
    Kissing's factors and ShuffleSoftSort's shuffles the threefry kernel.
    Returns the counts."""
    from repro_torch.bench import paper_table

    n = 1024
    paper_table_step_check(torch, paper_table, n)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    rows = paper_table.run(n, "full", device="cuda", tier="kernel")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for r in rows:
        emit("paper_table_row", **r)
    bad = paper_table.check(rows, n)
    steps = 2 * 1000 * 8
    emit("paper_table_run", n=n, budget="full", tier="kernel",
         seconds=seconds, check=bad or "passed",
         kissing_valid=[r["valid"] for r in rows
                        if r["method"] == "kissing"][0],
         launches={k: v for k, v in counts.items() if v})
    require(not bad, f"paper table check: {bad}")
    require_counts(counts, {**{k: steps for k in DENSE},
                            **{k: 0 for k in BAND}})
    require(all(counts[k] > 0 for k in THREEFRY), "no threefry launch")
    return counts


SERVE_KEY = dict(rounds=16, inner_steps=4, sched_rungs=4, max_batch=8)


def serve_key_check(torch, core, K):
    """Queue C11 on the card: raw ``jax.random`` keys on
    ``SortServer.submit``, kernel tier, 1024 colours on 32 x 32.  A
    one-restart request with ``prng_key(7)`` is bitwise
    ``shuffle_soft_sort(key=prng_key(7))``; a two-restart request's
    streams start at the reference server's chain ``[key] +
    split(fold_in(key, 1), 1)`` (drawn here through ``threefry.fold_in``
    and ``split``), its first round's shuffles are that chain's, and its
    result is the batched engine's on those keys, bitwise; an admission
    that raises resolves its future with ``RequestFailed`` within 10 s
    and the accounting holds.  Returns the launch counts of the served
    requests."""
    from repro_torch.core import threefry as tf
    from repro_torch.launch.serve import RequestFailed, SortServer

    hw, d = (32, 32), 3
    n = hw[0] * hw[1]
    cfg = core.ShuffleSoftSortConfig(
        rounds=SERVE_KEY["rounds"], inner_steps=SERVE_KEY["inner_steps"],
        use_kernel=True)
    x = tf.uniform(tf.prng_key(3), (n, d), device="cuda")
    x_np = x.cpu().numpy()

    def server(restarts, **kw):
        return SortServer(hw, d=d, cfg=cfg, n_restarts=restarts,
                          max_batch=SERVE_KEY["max_batch"],
                          sched_rungs=SERVE_KEY["sched_rungs"],
                          device="cuda", **kw)

    def drain(srv):
        for _ in range(256):
            with srv._cv:
                if not srv._pending and not srv._active:
                    return
            srv._tick()
        require(False, "serve_key_check: the server did not drain")

    torch.cuda.synchronize()
    K.reset_launch_counts()
    one = server(1, autostart=False)
    fut = one.submit(x_np, key=tf.prng_key(7))
    drain(one)
    one.close()
    got = fut.result(timeout=0)
    counts = K.launch_counts()
    want = core.shuffle_soft_sort(x, hw, cfg, key=tf.prng_key(7),
                                  device="cuda")
    require(np.array_equal(got[0], want[0])
            and np.array_equal(got[2], np.asarray(want[2], np.float32)),
            "a one-restart raw-key request is not shuffle_soft_sort(key=)")

    base = tf.as_keys(tf.prng_key(7), "cuda")
    chain = torch.cat([base[None], tf.split(tf.fold_in(base, 1), 1)])
    two = server(2, autostart=False)
    fut2 = two.submit(x_np, key=tf.prng_key(7))
    req = two._pending[0]
    two._admit(req)
    require(np.array_equal(req.src.state_dict(), tf.key_data(chain)),
            "a two-restart request's keys are not the reference's chain")
    first = req.src.fork().next_round()
    want_first = tf.permutation(tf.split(chain)[:, 1], n)
    require(torch.equal(first, want_first),
            "a two-restart request's first shuffles are not the chain's")
    drain(two)
    two.close()
    got2 = fut2.result(timeout=0)
    res = core.shuffle_soft_sort_batched(x[None], hw, cfg, n_restarts=2,
                                         keys=chain, device="cuda")
    require(np.array_equal(got2[0], res.order[0])
            and np.array_equal(got2[2], res.losses[0]),
            "a two-restart raw-key request is not the batched engine's run "
            "on the chain")

    srv = server(1, max_wait_ms=0.0)
    real, fired = srv._admit, []

    def admit(r):
        if not fired:
            fired.append(r.seq)
            raise RuntimeError("injected admission fault")
        return real(r)

    srv._admit = admit
    t0 = time.perf_counter()
    bad = srv.submit(x_np, key=tf.prng_key(8))
    try:
        bad.result(timeout=10)
        typed = False
    except RequestFailed:
        typed = True
    resolved_s = time.perf_counter() - t0
    ok = srv.submit(x_np, key=tf.prng_key(9)).result(timeout=120)
    srv.close()
    st = srv.stats
    offered = st["requests"]
    accounted = (st["completed"] + st["failed"] + st["deadline_missed"]
                 + st["queue_rejected"])
    require(typed and resolved_s < 10, "an admission fault left its "
            "future unresolved or untyped")
    require(accounted == offered == 2 and st["failed"] == 1
            and core.is_valid_permutation(ok[0]),
            f"accounting after an admission fault: {st}")
    emit("serve_key_check", n=n, d=d, grid=hw, rounds=cfg.rounds,
         inner_steps=cfg.inner_steps, one_restart_bitwise_keyed_run=True,
         two_restart_chain=tf.key_data(chain).tolist(),
         two_restart_bitwise_batched_on_chain=True,
         admission_fault_resolved_s=resolved_s, accounting={
             k: st[k] for k in ("requests", "completed", "failed",
                                "deadline_missed", "queue_rejected")},
         launches={k: v for k, v in counts.items() if v})
    require(all(counts[k] > 0 for k in DENSE),
            f"serve_key_check launched no dense kernel: {counts}")
    return counts


# The batched bench's runs (repro_torch.bench.batched_bench), each with
# --check.  --full's N = 4096 cells at B = 1 and 8 only: the B = 64 cell
# (64 sequential anneals of 50 rounds) is cut for time.  The adaptive rows
# run in the pinned jax<0.5's counter layout (the bench's default, that of
# the reference's committed rows the gate was set on) and, reported beside
# them ungated, in jax 0.9.0's.
BATCHED_BENCH = [
    ("sweep", ["--check"]),
    ("full", ["--full", "--ns", "4096", "--bs", "1", "8", "--check"]),
    ("scaling", ["--devices", "1", "8", "--check"]),
    ("cull", ["--cull-sweep", "--check"]),
    ("adaptive", ["--adaptive", "--check"]),
    ("adaptive_partitionable", ["--adaptive", "--partitionable"]),
]
BATCHED_BENCH_CUTS = ["--full at N = 4096: B = 64 cut for time (B = 1, 8 "
                      "run)"]


def batched_bench_run(torch, kernels):
    """The batched bench on the card (kernel tier), its modes in turn
    with ``--check``: batched bitwise sequential per seed, the mesh's
    orders bitwise the unsharded run's on 1 and 8 slots, cull 0 at no
    gap, and the adaptive gate (at least 20% of the rounds saved at a
    final-loss gap of at most 1%).  Launch counts set to 0 just before
    and read just after; returns them."""
    from repro_torch.bench import batched_bench

    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    seconds = {}
    for mode, argv in BATCHED_BENCH:
        t0 = time.perf_counter()
        doc = batched_bench.main(argv)
        seconds[mode] = time.perf_counter() - t0
        for row in doc["cells"]:
            emit("batched_bench_row", bench_mode=mode, **row)
    counts = kernels.launch_counts()
    emit("batched_bench_run", seconds=seconds, cut=BATCHED_BENCH_CUTS,
         check="passed (adaptive_partitionable ungated)",
         launches={k: v for k, v in counts.items() if v})
    require(all(counts[k] > 0 for k in DENSE + THREEFRY),
            f"the batched bench missed a kernel: {counts}")
    return counts


def autotune_run(torch, core, K, xs, main_digests):
    """The payload-tile autotune on the card: the full search over
    ``FULL_CELLS`` x ``DTYPES`` (every candidate tile held to the twins
    before it is timed) into a scratch table, read back through
    ``lookup_blocks``; whether the tiles agree bitwise, cell by cell and
    per quantity; ``lookup_blocks`` on the committed table returns its
    rows (and the fallback elsewhere); and with the committed table moved
    aside, main_run's and band_main_run's digests as ``catalog_runs``
    found them (``main_digests``)."""
    import tempfile

    from repro_torch.kernels import autotune

    out = os.path.join(tempfile.mkdtemp(), "autotune.json")
    t0 = time.perf_counter()
    rows = autotune.main(["--out", out, "--check", "--reps", "20"])
    search_s = time.perf_counter() - t0
    for r in rows:
        emit("autotune_cell", **r)
    committed = autotune._load_table(autotune.TABLE_PATH)
    require(committed is not None, "the committed autotune table does not "
            "load")
    for key, dt in committed.items():
        require(autotune.lookup_blocks(*key) == dt,
                f"lookup_blocks misses the committed row {key}")
    for r in rows:
        key = autotune._cell_key(r["tier"], r["N"], r["d"], r["K"],
                                 r["dtype"], "cuda")
        require(key in committed or autotune.lookup_blocks(*key)
                == K.band_payload_tile(r["d"])[0],
                f"lookup_blocks at {key} is not the fallback")
        require(r["bitwise"] or key not in committed,
                f"the committed table holds a row whose tiles differ: {key}")

    # main_run and band_main_run again, the committed table moved aside
    digests = {}
    table = autotune.TABLE_PATH
    autotune.TABLE_PATH = os.path.join(os.path.dirname(out), "absent.json")
    try:
        for phase, band in (("main_run", None), ("band_main_run", "auto")):
            cfg = core.ShuffleSoftSortConfig(rounds=32, inner_steps=8,
                                             use_kernel=True, band=band)
            res, _, _ = anneal(torch, core, K, xs, (64, 64), cfg, 2)
            digests[phase] = run_digest(res)
    finally:
        autotune.TABLE_PATH = table
    require(digests == main_digests,
            f"digests without the table {digests}, with it {main_digests}")
    emit("autotune_run", cells=len(rows), search_s=search_s,
         committed_rows=len(committed),
         bitwise_by_cell={f"{r['tier']}/{r['N']}/{r['d']}/{r['K']}/"
                          f"{r['dtype']}": r["bitwise_by"] for r in rows},
         winners={f"{r['tier']}/{r['N']}/{r['d']}/{r['K']}/{r['dtype']}":
                  r["winner"][0] for r in rows},
         digests_without_table=digests)


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
         flags=build.NVCC_FLAGS, ptxas=ptxas,
         max_active_clusters=max_active_clusters(F),
         threefry_sass=threefry_sass(build))
    dryrun_child = start_lm_dryrun()
    stats = kernel_phase(torch, K)
    band_stats = band_kernel_phase(torch, K, core)
    stats.update(band_stats[SOG_SHAPE])
    stats.update(v1_kernel_phase(torch, K))
    stats.update(flash_kernel_phase(torch, F, flash_ops))
    stats.update(threefry_run(torch, core))
    function_phase(torch, ops, ref, core)
    xs, launches, fixed, main_digests = catalog_runs(torch, core, K)
    adaptive_phases(torch, core, K, xs, fixed)
    loss_block_check(torch)
    tournament_run(torch, core, K, xs)
    tournament_adaptive_run(torch, core, K, xs)
    segment_run(torch, core, K, xs)
    checkpoint_run(torch, core, K, xs, fixed)
    guardrail_run(torch, core, K, xs, fixed)
    serve_counts = serve_run(torch, core, K)
    key_counts = serve_key_check(torch, core, K)
    mesh_counts = mesh_run(torch, core, K, xs)
    autotune_run(torch, core, K, xs, main_digests)
    bench_counts = batched_bench_run(torch, kernels)
    launches.update({k: v for k, v in sog_run(torch, core, K).items()
                     if k in BAND})
    for k in BAND:
        launches[k] += serve_counts[k]
    for k in DENSE + BAND:
        launches[k] += mesh_counts[k] + key_counts[k] + bench_counts[k]
    sog_codec(torch)
    launches.update({k: v for k, v in kernel_bench_phase(
        torch, kernels).items() if k in V1})
    launches.update({k: v for k, v in flash_main_run(
        torch, kernels, F, flash_ops).items() if k in FLASH})
    lm_counts = (lm_arch_run(torch, kernels, F),
                 lm_serve_run(torch, kernels, F, flash_ops),
                 lm_train_arch_run(torch, kernels, F),
                 lm_train_run(torch, kernels, F, flash_ops),
                 lm_train_recovery_run(torch, kernels, F))
    lm_dryrun_run(torch, dryrun_child)
    lm_counts += (lm_mesh_run(torch, kernels, F), paper_round_run(torch))
    for k in FLASH:
        launches[k] += sum(c.get(k, 0) for c in lm_counts)
    table_counts = paper_table_run(torch, kernels)
    for k in DENSE:
        launches[k] += table_counts[k]
    for k in THREEFRY:
        launches[k] = (table_counts[k] + bench_counts[k]
                       + sum(c.get(k, 0) for c in lm_counts[2:]))
    require(all(launches[k] > 0 for k in stats),
            f"a kernel of the line was never launched on the main paths: "
            f"{ {k: launches[k] for k in stats} }")

    print(json.dumps({"kernels": [
        {"name": k, "route": "cuda",
         "source": (FLASH_CU if k in FLASH else THREEFRY_CU
                    if k in THREEFRY else SOFTSORT_CU),
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

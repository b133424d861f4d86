"""Throughput sweep: the batched engine against the sequential loop, in
PyTorch.

The port of ``benchmarks/batched_bench.py``, with its four modes and
flags, plus ``--device`` (the card unless ``--device cpu``), ``--ns``,
``--partitionable`` and ``--check``.  The apply is the kernel tier on the
card and the plain tier on the CPU, where the kernels' twins are not
batch-invariant (ROADMAP.md Queue C6) and the bitwise gates would not
hold.  The problems and
keys are the reference bench's, bitwise: ``uniform(PRNGKey(0), (B, N,
d))`` and ``split(PRNGKey(1), B)`` through ``repro_torch.core.threefry``,
so every instance draws the reference's shuffles.

    python -m repro_torch.bench.batched_bench [--full]     # on the card
    python -m repro_torch.bench.batched_bench --device cpu --bs 2 \\
        --rounds 3 --check

* **Sequential vs batched** (the default): for each (B, N) cell, B
  ``shuffle_soft_sort(key=keys[i])`` calls (one host sync per round each)
  against one ``shuffle_soft_sort_batched(keys=keys)``; sorts/s of both
  and the speedup, on the host clock around work that ends in a device
  sync, after one warm-up of each path per shape.  B in {1, 8, 64} at N =
  1024, 10 rounds x 4 inner steps; ``--full`` adds N = 4096 and 50
  rounds.  ``--check``: every seed's order and losses bitwise equal on
  the two paths.
* **Scaling** (``--devices D ...``): the B x S grid over the batched
  engine, the same run on a mesh of D slots of the one device
  (``make_sort_mesh(devices=[device] * D)``) and the restart tournament
  on that mesh.  On one card the slots share it, so the mesh times are
  the sharding's overhead, not a speedup.  ``--check``: the mesh run's
  orders bitwise the unsharded run's.
* **Cull sweep** (``--cull-sweep``): the tournament at cull 0, 0.25, 0.5
  and 0.75 against the full engine: rounds fraction and loss gap.
  ``--check``: cull 0 runs every round at no gap.
* **Adaptive** (``--adaptive``): the fixed schedule against
  ``schedule="adaptive"`` on the reference's over-provisioned cell (cold
  ``tau_end``, 80 rounds); ``--check`` holds the reference's gate, at
  least 20% of the rounds saved at a final-loss gap of at most 1%.

The JSON goes only where ``--out`` points.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.prng import ThreefryShuffleSource
from repro_torch.core.shufflesoftsort import (
    ShuffleSoftSortConfig,
    resolve_device,
    restart_tournament,
    shuffle_soft_sort,
    shuffle_soft_sort_batched,
)

# tools/check_bench.py's bar for the reference's adaptive rows.
ADAPTIVE_MIN_SAVED_FRAC = 0.20
ADAPTIVE_MAX_LOSS_GAP_PCT = 1.0
CULLS = (0.0, 0.25, 0.5, 0.75)
SCALING_NOTE = ("mesh slots of one device share it: the mesh and "
                "tournament-on-mesh times are the sharding's overhead, not "
                "a speedup; the loss columns are exact")


def _square_hw(n: int) -> tuple[int, int]:
    h = int(np.sqrt(n))
    if h * h != n:
        raise ValueError(f"N={n} is not square")
    return (h, h)


def problems(b: int, n: int, d: int, device,
             partitionable: bool = False) -> torch.Tensor:
    """The reference bench's problems, ``uniform(PRNGKey(0), (b, n, d))``,
    bitwise, in the counter layout ``partitionable`` names."""
    return threefry.uniform(threefry.prng_key(0), (b, n, d),
                            partitionable=partitionable, device=device)


def problem_keys(count: int, device, partitionable: bool = False):
    """The reference bench's keys, ``split(PRNGKey(1), count)``."""
    return threefry.split(threefry.prng_key(1), count,
                          partitionable=partitionable, device=device)


def _source(keys, n: int, device, partitionable: bool):
    """The instances' shuffles: the reference's ``key=`` chains."""
    return ThreefryShuffleSource(keys, n, device, partitionable)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, device):
    """(result, host seconds) of ``fn``, synced before and after."""
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def bench_cell(b: int, n: int, d: int, cfg: ShuffleSoftSortConfig,
               device, warm: bool = True, partitionable: bool = False) -> dict:
    """B sequential anneals against one batched anneal of the same B
    problems and keys; per seed, whether the two paths agree bitwise."""
    hw = _square_hw(n)
    xs = problems(b, n, d, device, partitionable)
    keys = problem_keys(b, device, partitionable)

    def one(i):
        return shuffle_soft_sort(
            xs[i], hw, cfg, device=device,
            source=_source(keys[i:i + 1], n, device, partitionable))

    def run_sequential():
        return [one(i) for i in range(b)]

    def run_batched():
        return shuffle_soft_sort_batched(
            xs, hw, cfg, n_restarts=1, device=device,
            source=_source(keys, n, device, partitionable))

    if warm:
        one(0)
        run_batched()
    seq, t_seq = _timed(run_sequential, device)
    bat, t_bat = _timed(run_batched, device)
    orders = [i for i in range(b)
              if not np.array_equal(seq[i][0], bat.all_orders[i, 0])]
    losses = [i for i in range(b) if not np.array_equal(
        np.asarray(seq[i][2], np.float32), bat.all_losses[i, 0])]
    return {
        "B": b, "N": n, "d": d, "rounds": cfg.rounds,
        "inner_steps": cfg.inner_steps,
        "seq_s": t_seq, "bat_s": t_bat,
        "seq_sorts_per_s": b / t_seq,
        "bat_sorts_per_s": b / t_bat,
        "speedup": t_seq / t_bat,
        "seeds_orders_differ": orders,
        "seeds_losses_differ": losses,
        "bitwise": not orders and not losses,
    }


# --------------------------------------------------------------------------
# Scaling sweep: mesh slots x B x S over the batched, mesh and tournament
# engines.
# --------------------------------------------------------------------------

def bench_scaling_cell(b: int, s: int, n: int, d: int,
                       cfg: ShuffleSoftSortConfig, n_slots: int,
                       rungs: int, cull: float, device,
                       partitionable: bool = False) -> dict:
    """One slots x B x S cell: the three engines on the same problems and
    keys, and whether the mesh run's orders are the unsharded run's."""
    from repro_torch.launch.mesh import make_sort_mesh

    hw = _square_hw(n)
    xs = problems(b, n, d, device, partitionable)
    keys = problem_keys(b * s, device, partitionable)
    mesh = make_sort_mesh(devices=[device] * n_slots)

    def src():
        return _source(keys, n, device, partitionable)

    def run_vmap():
        return shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s,
                                         source=src(), device=device)

    def run_shard():
        return shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s,
                                         source=src(), mesh=mesh,
                                         device=device)

    def run_tour():
        return restart_tournament(xs, hw, cfg, n_restarts=s, source=src(),
                                  cull_fraction=cull, n_rungs=rungs,
                                  mesh=mesh, device=device)

    ref, shd, _ = run_vmap(), run_shard(), run_tour()     # warm-up
    mesh_bitwise = bool(np.array_equal(ref.all_orders, shd.all_orders))
    ref, t_vmap = _timed(run_vmap, device)
    _, t_shard = _timed(run_shard, device)
    tour, t_tour = _timed(run_tour, device)
    full_loss = float(ref.losses[:, -1].mean())
    tour_loss = float(tour.final_loss.mean())
    return {
        "devices": n_slots, "B": b, "S": s, "N": n,
        "rounds": cfg.rounds, "rungs": rungs, "cull_fraction": cull,
        "vmap_s": t_vmap, "shard_s": t_shard, "tournament_s": t_tour,
        "shard_speedup": t_vmap / t_shard,
        "tournament_speedup": t_vmap / t_tour,
        "full_best_loss": full_loss,
        "tournament_best_loss": tour_loss,
        "tournament_loss_gap": tour_loss - full_loss,
        "tournament_rounds_frac": tour.rounds_run / tour.rounds_full,
        "mesh_bitwise": mesh_bitwise,
    }


def run_scaling_sweep(args, cfg_kw: dict, device) -> list[dict]:
    cfg = ShuffleSoftSortConfig(rounds=args.rounds or 8, inner_steps=4,
                                chunk=256, **cfg_kw)
    rows = []
    for n_slots in args.devices:
        for b in (args.bs or (4, 16)):
            for s in (args.restarts or (2, 8)):
                r = bench_scaling_cell(b, s, args.n, args.d, cfg, n_slots,
                                       args.tournament_rungs,
                                       args.cull_fraction, device,
                                       args.partitionable)
                rows.append(r)
                print(f"  slots={n_slots} B={b} S={s}: shard "
                      f"{r['shard_speedup']:.2f}x, tournament "
                      f"{r['tournament_speedup']:.2f}x at "
                      f"{r['tournament_rounds_frac']:.2f} of the rounds "
                      f"(loss gap {r['tournament_loss_gap']:+.4f}), mesh "
                      f"bitwise {r['mesh_bitwise']}", flush=True)
    return rows


def run_cull_sweep(args, cfg_kw: dict, device) -> list[dict]:
    """Tournament quality against compute: the cull fraction at fixed
    B x S against the run-everything engine."""
    b = (args.bs or [4])[0]
    s = (args.restarts or [8])[0]
    n = args.n
    cfg = ShuffleSoftSortConfig(rounds=args.rounds or 12, inner_steps=4,
                                chunk=256, **cfg_kw)
    hw = _square_hw(n)
    xs = problems(b, n, args.d, device, args.partitionable)
    keys = problem_keys(b * s, device, args.partitionable)

    def src():
        return _source(keys, n, device, args.partitionable)

    full = shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s,
                                     source=src(), device=device)
    full_loss = float(full.losses[:, -1].mean())
    print(f"cull sweep: B={b} S={s} N={n} rounds={cfg.rounds} "
          f"rungs={args.tournament_rungs}; full-engine loss {full_loss:.4f}")
    rows = []
    for cull in CULLS:
        res = restart_tournament(xs, hw, cfg, n_restarts=s, source=src(),
                                 cull_fraction=cull,
                                 n_rungs=args.tournament_rungs,
                                 device=device)
        loss = float(res.final_loss.mean())
        row = {"mode": "cull", "B": b, "S": s, "N": n,
               "cull_fraction": cull,
               "rounds_frac": res.rounds_run / res.rounds_full,
               "final_loss": loss, "loss_gap_vs_full": loss - full_loss}
        rows.append(row)
        print(f"  cull={cull:.2f}: rounds_frac={row['rounds_frac']:.3f} "
              f"loss={loss:.4f} gap={row['loss_gap_vs_full']:+.4f}")
    return rows


def bench_adaptive_cell(b: int, n: int, d: int, rounds: int, args,
                        cfg_kw: dict, device) -> dict:
    """Fixed against adaptive schedule on one over-provisioned cell: the
    fraction of the schedule's rounds the controller saved and the
    final-loss gap it cost, on the same problems and keys."""
    hw = _square_hw(n)
    xs = problems(b, n, d, device, args.partitionable)
    keys = problem_keys(b, device, args.partitionable)
    base = dict(rounds=rounds, inner_steps=4, chunk=min(n, 256),
                tau_end=args.adaptive_tau_end, **cfg_kw)
    fixed = ShuffleSoftSortConfig(**base)
    adapt = ShuffleSoftSortConfig(
        **base, schedule="adaptive", adapt_every=args.adapt_every,
        patience=args.patience, plateau_rtol=args.plateau_rtol,
        decay_rungs=args.decay_rungs)

    def run(cfg):
        return shuffle_soft_sort_batched(
            xs, hw, cfg, device=device,
            source=_source(keys, n, device, args.partitionable))

    run(fixed), run(adapt)                                 # warm-up
    rf, t_fixed = _timed(lambda: run(fixed), device)
    ra, t_adapt = _timed(lambda: run(adapt), device)
    executed = ra.rounds_executed[:, 0]
    fixed_loss = float(rf.losses[:, -1].mean())
    adapt_loss = float(ra.losses[np.arange(b), executed - 1].mean())
    return {
        "mode": "adaptive",
        "devices": 1, "B": b, "N": n, "rounds": rounds,
        "tau_end": args.adaptive_tau_end,
        "adapt_every": args.adapt_every, "patience": args.patience,
        "plateau_rtol": args.plateau_rtol,
        "decay_rungs": args.decay_rungs,
        "fixed_s": t_fixed, "adaptive_s": t_adapt,
        "fixed_final_loss": fixed_loss,
        "adaptive_final_loss": adapt_loss,
        "mean_rounds_executed": float(executed.mean()),
        "rounds_saved_frac": float(1.0 - executed.sum() / (b * rounds)),
        "final_loss_gap_pct": (adapt_loss - fixed_loss) / fixed_loss * 100,
    }


def run_adaptive_sweep(args, cfg_kw: dict, device) -> list[dict]:
    rounds = args.rounds or 80
    rows = [bench_adaptive_cell(b, n, args.d, rounds, args, cfg_kw, device)
            for n in (args.adaptive_ns or (64, 256))
            for b in (args.bs or (4,))]
    for r in rows:
        print(f"  B={r['B']} N={r['N']} R={r['rounds']}: saved "
              f"{r['rounds_saved_frac']:.1%} of rounds at "
              f"{r['final_loss_gap_pct']:+.2f}% final-loss gap "
              f"({r['mean_rounds_executed']:.1f}/{r['rounds']} rounds, "
              f"{r['fixed_s']:.2f}s -> {r['adaptive_s']:.2f}s)")
    return rows


def gate(mode: str, rows) -> list[str]:
    """The failures of ``--check`` on a mode's rows (empty when every gate
    holds)."""
    bad = []
    for i, r in enumerate(rows):
        if mode == "sweep" and (r["seeds_orders_differ"]
                                or r["seeds_losses_differ"]):
            bad.append(f"cells[{i}] B={r['B']} N={r['N']}: batched is not "
                       f"sequential bitwise (orders differ at seeds "
                       f"{r['seeds_orders_differ']}, losses at "
                       f"{r['seeds_losses_differ']})")
        elif mode == "scaling" and not r["mesh_bitwise"]:
            bad.append(f"cells[{i}] slots={r['devices']} B={r['B']} "
                       f"S={r['S']}: mesh orders are not the unsharded "
                       "run's")
        elif mode == "cull" and r["cull_fraction"] == 0.0 and (
                r["rounds_frac"] != 1.0 or r["loss_gap_vs_full"] != 0.0):
            bad.append(f"cells[{i}] cull 0 ran {r['rounds_frac']} of the "
                       f"rounds at gap {r['loss_gap_vs_full']}")
        elif mode == "adaptive":
            if not r["rounds_saved_frac"] >= ADAPTIVE_MIN_SAVED_FRAC:
                bad.append(f"cells[{i}] N={r['N']}: saved "
                           f"{r['rounds_saved_frac']:.3f} of the rounds, "
                           f"under {ADAPTIVE_MIN_SAVED_FRAC}")
            if not r["final_loss_gap_pct"] <= ADAPTIVE_MAX_LOSS_GAP_PCT:
                bad.append(f"cells[{i}] N={r['N']}: final-loss gap "
                           f"{r['final_loss_gap_pct']:+.3f}% over "
                           f"{ADAPTIVE_MAX_LOSS_GAP_PCT}%")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="add N=4096 and a longer round budget")
    ap.add_argument("--ns", type=int, nargs="+", default=None,
                    help="N values of the sequential-vs-batched sweep "
                         "(default 1024, with --full also 4096)")
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--d", type=int, default=3)
    ap.add_argument("--bs", type=int, nargs="+", default=None)
    ap.add_argument("--devices", type=int, nargs="+", default=None,
                    help="run the scaling sweep on meshes of these many "
                         "slots of the device")
    ap.add_argument("--restarts", type=int, nargs="+", default=None,
                    help="S values for the scaling sweep")
    ap.add_argument("--n", type=int, default=256,
                    help="N for the scaling and cull sweeps")
    ap.add_argument("--tournament-rungs", type=int, default=3)
    ap.add_argument("--cull-fraction", type=float, default=0.5)
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--cull-sweep", action="store_true",
                    help="sweep tournament cull fractions at fixed B x S")
    ap.add_argument("--adaptive", action="store_true",
                    help="fixed-vs-adaptive schedule rows (rounds saved "
                         "vs final-loss gap)")
    ap.add_argument("--adaptive-ns", type=int, nargs="+", default=None,
                    help="N values for the adaptive sweep")
    ap.add_argument("--adaptive-tau-end", type=float, default=0.02,
                    help="the cold schedule end of the adaptive sweep")
    ap.add_argument("--adapt-every", type=int, default=5)
    ap.add_argument("--patience", type=int, default=1)
    ap.add_argument("--plateau-rtol", type=float, default=0.02)
    ap.add_argument("--decay-rungs", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a CUDA "
                         "device) or cpu")
    ap.add_argument("--partitionable", action="store_true",
                    help="draw in jax 0.9.0's default counter layout "
                         "instead of the pinned jax<0.5's")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero unless every row passes its gate")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg_kw = {"use_kernel": device.type == "cuda"}

    if args.cull_sweep:
        mode, rows = "cull", run_cull_sweep(args, cfg_kw, device)
    elif args.adaptive:
        mode, rows = "adaptive", run_adaptive_sweep(args, cfg_kw, device)
    elif args.devices:
        mode, rows = "scaling", run_scaling_sweep(args, cfg_kw, device)
    else:
        mode = "sweep"
        ns = tuple(args.ns or ((1024, 4096) if args.full else (1024,)))
        bs = tuple(args.bs) if args.bs else (1, 8, 64)
        rounds = args.rounds or (50 if args.full else 10)
        cfg = ShuffleSoftSortConfig(rounds=rounds, inner_steps=4, chunk=256,
                                    **cfg_kw)
        print("name,us_per_call,derived")
        rows = []
        for n in ns:
            for b in bs:
                r = bench_cell(b, n, args.d, cfg, device,
                               partitionable=args.partitionable)
                rows.append(r)
                print(f"batched_bench.B{b}_N{n},{r['bat_s'] * 1e6 / b:.0f},"
                      f"seq={r['seq_sorts_per_s']:.2f}sorts/s;"
                      f"bat={r['bat_sorts_per_s']:.2f}sorts/s;"
                      f"speedup={r['speedup']:.2f}x;"
                      f"bitwise={r['bitwise']}", flush=True)
    doc = {"bench": "batched_bench", "mode": mode, "device": str(device),
           "device_name": (torch.cuda.get_device_name(device)
                           if device.type == "cuda" else "cpu"),
           "tier": "kernel" if cfg_kw["use_kernel"] else "plain",
           "partitionable": args.partitionable,
           "cells": rows}
    if mode == "scaling":
        doc["note"] = SCALING_NOTE
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    if args.check:
        bad = gate(mode, rows)
        if bad:
            raise SystemExit("batched bench gate failed: " + "; ".join(bad))
        print(f"batched bench gate OK ({mode}, {len(rows)} cells)")
    return doc


if __name__ == "__main__":
    main()

"""Load generator for the port's continuous-batching ``SortServer``
(``repro_torch.launch.serve``), the counterpart of the reference's
``benchmarks/serving_bench.py``: the same scenarios, columns and gate.

    python -m repro_torch.bench.serving_bench [--smoke] [--inject-faults]
        [--capacity] [--device cpu] [--check] [--out serving.json]

Poisson arrivals (seeded) of a mixed-shape problem population (two shape
buckets) into a live server, with a closed-loop window of outstanding
requests:

  * ``steady``   — in-budget load: the baseline p50/p99 and goodput row.
  * ``faults``   — the same load with injected dispatch failures every
    ``fail_every``-th dispatch and one injected straggler delay
    (``FaultInjector``); every fault is retried from the last committed
    round boundary.
  * ``overload`` — arrivals above the service rate into a shallow queue
    with tight deadlines: load shedding (``queue_rejected`` +
    ``deadline_missed``) while admitted, in-deadline requests complete.
  * ``preempt``  — warm restart under load: ``close(drain=False)`` once a
    quarter of the traffic completed, and a successor adopts the rest;
    exactly-once accounting across the two generations.
  * ``capacity`` — elastic capacity loss: Poisson load against a mesh of
    8 slots of the bench's device (``make_sort_mesh(devices=[device] *
    8)``) while a ``FaultInjector`` takes slots 3 and 5 down at dispatches
    1 and 3 and brings slot 3 back at dispatch 8; the
    ``DeviceHealthMonitor`` evicts, the server re-shards at rung
    boundaries, and the armed brownout ladder degrades deadline-bound
    admissions of a 2-restart tournament (cull 0.25) instead of shedding
    them.  Every future resolves exactly once (``lost_futures == 0``),
    two evictions each re-shard once, one slot returns.

Every request is accounted for exactly once:

    completed + failed + deadline_missed + queue_rejected == offered

``--check`` gates that in every cell, with ``tools/check_bench.py``'s
serving rules: latency order, a recovery path that engaged wherever faults
were injected, a preempt row that preempted something and resumed all
of it, and a capacity row with no lost future, a re-shard per eviction
and no more returns than evictions.  ``wall_clock`` is "measured" on CUDA and "cpu" on the host (CPU
times say nothing about the card).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

# (hw, d) mix: two shape buckets, as the reference's.
SHAPES = (((4, 4), 2), ((8, 8), 2))


def gen_problems(rng, count, shapes=SHAPES):
    """``count`` problems cycling through ``shapes``, uniform in [0, 1)."""
    out = []
    for i in range(count):
        hw, d = shapes[i % len(shapes)]
        out.append((hw, d, rng.rand(hw[0] * hw[1], d).astype(np.float32)))
    return out


def _percentile(vals, q):
    return (float(np.percentile(np.asarray(vals, np.float64), q))
            if len(vals) else 0.0)


def warm(cfg, seg_len, max_batch, shapes, device):
    """One dispatch per (shape, power-of-two bucket) through the engine,
    so that first-call costs (the kernels' load, the allocator's first
    blocks) stay out of the recorded latencies."""
    import torch

    from repro_torch.core import TorchShuffleSource, run_round_segment
    for hw, d in shapes:
        n = hw[0] * hw[1]
        b = 1
        while b <= max_batch:
            run_round_segment(
                np.zeros((b, n, d), np.float32),
                np.tile(np.arange(n), (b, 1)), np.ones(b, np.float32),
                np.zeros(b, np.int64), seg_len,
                source=TorchShuffleSource(list(range(b)), n, device), hw=hw,
                cfg=cfg, device=device)
            b *= 2
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _server(cfg, *, shapes, max_batch, queue_depth, seed, device,
            engine=None, resume=None, guardrail=None, sched_rungs=None,
            server_kw=None):
    from repro_torch.launch.serve import SortServer
    from repro_torch.runtime.fault_tolerance import RetryPolicy
    from repro_torch.runtime.straggler import StragglerMonitor
    hw0, d0 = shapes[0]
    return SortServer(
        hw0, d=d0, cfg=cfg, max_batch=max_batch, max_wait_ms=2.0,
        queue_depth=queue_depth, seed=seed,
        retry=RetryPolicy(max_retries=4, backoff_base_s=0.01,
                          backoff_max_s=0.1),
        straggler=StragglerMonitor(z=4.0, min_ratio=2.0, warmup=8),
        engine_fn=engine, resume=resume, guardrail=guardrail,
        sched_rungs=sched_rungs, device=device, **(server_kw or {}))


def _offer(server, problems, gaps, window, deadline_s):
    """Offer ``problems`` at the Poisson ``gaps``, never more than
    ``window`` outstanding; returns the futures, the count shed by
    ``QueueFull`` and the problem index of each future."""
    from repro_torch.launch.serve import QueueFull
    futs, rejected, index = [], 0, []
    next_at = time.perf_counter()
    for i, (hw, _, x) in enumerate(problems):
        next_at += gaps[i]
        pause = next_at - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        while sum(not f.done() for f in futs) >= window:
            time.sleep(0.002)
        try:
            futs.append(server.submit(x, hw=hw, priority=i % 3,
                                      deadline_s=deadline_s))
            index.append(i)
        except QueueFull:
            rejected += 1
    return futs, rejected, index


def _outcomes(futs):
    from repro_torch.launch.serve import (DeadlineExceeded, RequestFailed,
                                          ServerClosed)
    out = {"completed": 0, "failed": 0, "deadline_missed": 0}
    results = []
    for f in futs:
        try:
            results.append(f.result(timeout=600))
            out["completed"] += 1
        except DeadlineExceeded:
            results.append(None)
            out["deadline_missed"] += 1
        except (RequestFailed, ServerClosed):
            results.append(None)
            out["failed"] += 1
    return out, results


def _cell(name, cfg, device, shapes, requests, rate_hz, deadline_s, wall,
          outcomes, rejected, stats_list):
    lat = [v for st in stats_list for v in st["latencies_ms"]]
    sizes = [v for st in stats_list for v in st["batch_sizes"]]

    def total(key):
        return sum(st[key] for st in stats_list)

    import torch
    return {
        "scenario": name,
        "requests": requests,
        "arrival_rate_hz": rate_hz,
        "deadline_s": deadline_s,
        "shapes": [[list(hw), d] for hw, d in shapes],
        "rounds": cfg.rounds,
        "device": str(device),
        "wall_clock": ("measured" if torch.device(device).type == "cuda"
                       else "cpu"),
        "wall_s": wall,
        **outcomes,
        "queue_rejected": rejected,
        "goodput_rps": outcomes["completed"] / max(wall, 1e-9),
        "p50_ms": _percentile(lat, 50),
        "p99_ms": _percentile(lat, 99),
        "deadline_miss_rate": outcomes["deadline_missed"] / requests,
        "retries": total("retries"),
        "recoveries": total("recoveries"),
        "stragglers": total("stragglers"),
        "batches": total("batches"),
        "mean_batch": float(np.mean(sizes)) if sizes else 0.0,
        "compile_programs": len(set().union(
            *(st["compile_keys"] for st in stats_list))),
        "integrity_violations": total("integrity_violations"),
        "dispatch_s": total("dispatch_s"),
        "probe_s": total("probe_s"),
    }


def run_scenario(name, cfg, *, requests, rate_hz, window, queue_depth,
                 max_batch, device, deadline_s=None, fail_every=0,
                 delay_call=None, delay_s=0.25, delay_when=None, seed=0,
                 shapes=SHAPES, problems=None, guardrail=None,
                 sched_rungs=None, server_kw=None, keep_results=False):
    """Offer ``requests`` Poisson arrivals at ``rate_hz`` to a fresh
    server (``server_kw`` goes on to ``SortServer``); returns the metrics
    cell.  ``delay_call`` is the dispatch that stalls ``delay_s`` seconds
    (the injected straggler), or with ``delay_when(xs, ...)`` the first
    unfailed dispatch from ``delay_call`` on that it accepts
    (``FaultInjector``'s predicate); the cell's ``straggler_events`` are the
    server's flags, each with its dispatch's seconds, the seconds
    expected of it and the bucket cap before and after.  With
    ``keep_results`` the cell also holds
    ``results`` (each accepted request's result, None where it was
    rejected) and ``problem_index`` (its problem's index), in submission
    order: keyless submits draw their seeds from the server's stream in
    that order."""
    from repro_torch.core import run_round_segment
    from repro_torch.runtime.fault_tolerance import FaultInjector
    inject = fail_every > 0 or delay_call is not None
    engine = FaultInjector(
        run_round_segment,
        fail_calls=set(range(fail_every, 10_000, fail_every))
        if fail_every else set(),
        delay_calls={delay_call: delay_s} if delay_call is not None else {},
        delay_when=delay_when)
    server = _server(cfg, shapes=shapes, max_batch=max_batch,
                     queue_depth=queue_depth, seed=seed, device=device,
                     engine=engine if inject else None, guardrail=guardrail,
                     sched_rungs=sched_rungs, server_kw=server_kw)
    rng = np.random.RandomState(seed)
    problems = problems or gen_problems(rng, requests, shapes)
    gaps = rng.exponential(1.0 / rate_hz, size=requests)
    t0 = time.perf_counter()
    futs, rejected, index = _offer(server, problems, gaps, window,
                                   deadline_s)
    outcomes, results = _outcomes(futs)
    wall = time.perf_counter() - t0
    server.close()
    st = server.stats
    assert st["queue_rejected"] == rejected, (st["queue_rejected"], rejected)
    assert st["completed"] == outcomes["completed"], (st, outcomes)
    cell = _cell(name, cfg, device, shapes, requests, rate_hz, deadline_s,
                 wall, outcomes, rejected, [st])
    cell["injected_faults"] = engine.faults if inject else 0
    cell["injected_delays"] = engine.delays if inject else 0
    cell["straggler_events"] = [
        {k: e[k] for k in ("dt_s", "expected_s", "cap_before",
                           "bucket_cap")}
        for e in server.events if e["event"] == "straggler"]
    if keep_results:
        cell.update(results=results, problem_index=index)
    return cell


def run_stall_scenario(cfg, *, requests, max_batch, device, delay_s=1.0,
                       after=16, seed=0, shapes=SHAPES, **kw):
    """The straggler of ROADMAP.md Queue C9: ``requests`` offered closed
    loop (16 outstanding, so full buckets occur), no failure, and one
    stall of ``delay_s`` seconds at the first full bucket of the first
    shape from dispatch ``after`` on, past the monitor's warm-up.  The
    cell's ``straggler_events`` show whether it was flagged and the bucket
    cap halved."""
    (hw, _), full = shapes[0], max_batch
    return run_scenario(
        "faults_stall", cfg, requests=requests, rate_hz=1e6, window=16,
        queue_depth=64, max_batch=max_batch, delay_call=after,
        delay_s=delay_s, seed=seed, shapes=shapes, device=device,
        delay_when=lambda xs, *a, **k: tuple(xs.shape[:2]) == (
            full, hw[0] * hw[1]), **kw)


def run_preempt_scenario(cfg, *, requests, rate_hz, window, queue_depth,
                         max_batch, device, seed=0, shapes=SHAPES,
                         problems=None, sched_rungs=None,
                         keep_results=False):
    """Kill-and-resume under load: preempt generation 1
    (``close(drain=False)``) once a quarter of the requests completed,
    hand its in-flight requests to generation 2, and account for every
    future exactly once across both."""
    kw = dict(shapes=shapes, max_batch=max_batch, queue_depth=queue_depth,
              seed=seed, device=device, sched_rungs=sched_rungs)
    server = _server(cfg, **kw)
    rng = np.random.RandomState(seed)
    problems = problems or gen_problems(rng, requests, shapes)
    gaps = rng.exponential(1.0 / rate_hz, size=requests)
    t0 = time.perf_counter()
    futs, rejected, index = _offer(server, problems, gaps, window, None)
    quarter = max(1, requests // 4)
    while (server.stats["completed"] < quarter
           and any(not f.done() for f in futs)):
        time.sleep(0.002)
    handoff = server.close(drain=False)
    server2 = _server(cfg, resume=handoff, **kw)
    outcomes, results = _outcomes(futs)
    wall = time.perf_counter() - t0
    server2.close()
    gen1, gen2 = server.stats, server2.stats
    cell = _cell("preempt", cfg, device, shapes, requests, rate_hz, None,
                 wall, outcomes, rejected, [gen1, gen2])
    cell.update(injected_faults=0, injected_delays=0,
                preempted_inflight=len(handoff.requests),
                preempted_seqs=[r.seq for r in handoff.requests],
                resumed_requests=gen2["resumed"],
                completed_gen1=gen1["completed"],
                completed_gen2=gen2["completed"])
    if keep_results:
        cell.update(results=results, problem_index=index)
    return cell


def run_capacity_scenario(cfg, *, requests, rate_hz, window, queue_depth,
                          max_batch, deadline_s, device, seed=0,
                          shapes=SHAPES, problems=None, sched_rungs=None,
                          keep_results=False):
    """Elastic capacity loss under Poisson load: serve from a mesh of 8
    slots of ``device``, take slots 3 and 5 down at dispatches 1 and 3
    (the health monitor evicts each and the server re-shards over the
    survivors at the next rung), bring slot 3 back at dispatch 8, and let
    the armed brownout ladder degrade the deadline-bound admissions of a
    2-restart tournament instead of shedding them.  Requests with a
    deadline inside the policy's full-level slack band (10 s) take the
    full ladder level.  With ``keep_results`` the cell also holds the
    results, their problem indices and ``degraded_seqs``, the submission
    indices of the requests the ladder degraded."""
    from repro_torch.core import run_round_segment
    from repro_torch.launch.mesh import make_sort_mesh
    from repro_torch.launch.serve import BrownoutPolicy
    from repro_torch.runtime.fault_tolerance import FaultInjector
    from repro_torch.runtime.straggler import DeviceHealthMonitor

    mesh = make_sort_mesh(devices=[device] * 8)
    lose_a, lose_b = mesh.ids[3], mesh.ids[5]
    engine = FaultInjector(run_round_segment,
                           device_loss={1: lose_a, 3: lose_b},
                           device_return={8: lose_a})
    server = _server(cfg, shapes=shapes, max_batch=max_batch,
                     queue_depth=queue_depth, seed=seed, device=device,
                     engine=engine, sched_rungs=sched_rungs, server_kw=dict(
                         mesh=mesh, n_restarts=2, tournament_rungs=2,
                         cull_fraction=0.25,
                         brownout=BrownoutPolicy(slack_full_s=10.0),
                         device_health=DeviceHealthMonitor(
                             lost_after=1, probe=engine.healthy)))
    rng = np.random.RandomState(seed)
    problems = problems or gen_problems(rng, requests, shapes)
    gaps = rng.exponential(1.0 / rate_hz, size=requests)
    t0 = time.perf_counter()
    futs, rejected, index = _offer(server, problems, gaps, window,
                                   deadline_s)
    outcomes, results = _outcomes(futs)
    wall = time.perf_counter() - t0
    server.close()
    st = server.stats
    assert st["completed"] == outcomes["completed"], (st, outcomes)
    cell = _cell("capacity", cfg, device, shapes, requests, rate_hz,
                 deadline_s, wall, outcomes, rejected, [st])
    resolved = sum(outcomes.values()) + rejected
    cell.update(
        injected_faults=engine.faults, injected_delays=engine.delays,
        devices_start=len(mesh), device_faults=engine.device_faults,
        evictions=st["evictions"], reshards=st["reshards"],
        device_returns=st["device_returns"],
        degraded_requests=st["brownouts"],
        degradations={k: int(v) for k, v in st["degradations"].items()},
        lost_futures=requests - resolved,
        mesh_slots_end=0 if server.mesh is None else len(server.mesh))
    if keep_results:
        cell.update(results=results, problem_index=index, degraded_seqs=[
            e["seq"] for e in server.events
            if e["event"] == "brownout_degrade"])
    return cell


def gate(cells) -> list[str]:
    """``tools/check_bench.py``'s serving rules on the bench's cells;
    returns the failures."""
    bad = []
    for i, c in enumerate(cells):
        counts = [c[k] for k in ("completed", "failed", "deadline_missed",
                                 "queue_rejected")]
        if any(not isinstance(v, int) or v < 0 for v in counts) or \
                sum(counts) != c["requests"]:
            bad.append(f"cells[{i}] ({c['scenario']}) breaks exactly-once "
                       f"accounting: {counts} vs requests {c['requests']}")
        if not 0.0 <= c["deadline_miss_rate"] <= 1.0:
            bad.append(f"cells[{i}] deadline_miss_rate out of [0, 1]")
        if c["p50_ms"] < 0 or c["p99_ms"] < c["p50_ms"]:
            bad.append(f"cells[{i}] latency order violated: p50 "
                       f"{c['p50_ms']} p99 {c['p99_ms']}")
        if c["injected_faults"] > 0 and c["retries"] + c["failed"] < 1:
            bad.append(f"cells[{i}] injected faults but neither retried "
                       "nor failed")
        if c["scenario"] == "preempt":
            if c["preempted_inflight"] < 1:
                bad.append(f"cells[{i}] preempt row with no in-flight "
                           "request at the kill")
            if c["resumed_requests"] != c["preempted_inflight"]:
                bad.append(f"cells[{i}] leaked preempted requests: "
                           f"{c['resumed_requests']} resumed of "
                           f"{c['preempted_inflight']}")
            if c["completed_gen1"] + c["completed_gen2"] != c["completed"]:
                bad.append(f"cells[{i}] completions do not add up across "
                           "generations")
        if c["scenario"] == "capacity":
            if c["lost_futures"] != 0:
                bad.append(f"cells[{i}] lost {c['lost_futures']} futures")
            if c["reshards"] != c["evictions"] or c["evictions"] < 1:
                bad.append(f"cells[{i}] re-shard ledger broken: "
                           f"{c['reshards']} reshards, {c['evictions']} "
                           "evictions")
            if c["device_returns"] > c["evictions"]:
                bad.append(f"cells[{i}] more returns than evictions")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="small load (fewer requests, short anneal)")
    ap.add_argument("--inject-faults", action="store_true",
                    help="add the fault-injection scenario")
    ap.add_argument("--capacity", action="store_true",
                    help="add the elastic-capacity scenario (a mesh of 8 "
                         "slots of the device, two lost, one back)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a CUDA "
                         "device) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="fail unless every cell passes the serving gate")
    ap.add_argument("--out", default=None, help="write the JSON here")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    from repro_torch.core import ShuffleSoftSortConfig, resolve_device
    device = resolve_device(args.device)

    requests = 16 if args.smoke else 48
    rounds = 4 if args.smoke else 8
    cfg = ShuffleSoftSortConfig(rounds=rounds, inner_steps=2, chunk=64)
    seg_len = rounds // 4
    warm(cfg, seg_len, 8, SHAPES, device)
    cells = [run_scenario(
        "steady", cfg, requests=requests, rate_hz=40.0, window=16,
        queue_depth=64, max_batch=8, seed=args.seed, device=device)]
    if args.inject_faults:
        cells.append(run_scenario(
            "faults", cfg, requests=requests, rate_hz=40.0, window=16,
            queue_depth=64, max_batch=8, fail_every=7, delay_call=11,
            seed=args.seed, device=device))
        cells.append(run_stall_scenario(
            cfg, requests=3 * requests, max_batch=8, seed=args.seed,
            device=device))
    cells.append(run_scenario(
        "overload", cfg, requests=requests, rate_hz=500.0, window=requests,
        queue_depth=12, max_batch=4, deadline_s=0.5, seed=args.seed,
        device=device))
    cells.append(run_preempt_scenario(
        cfg, requests=requests, rate_hz=80.0, window=requests,
        queue_depth=64, max_batch=4, seed=args.seed, device=device))
    if args.capacity:
        cells.append(run_capacity_scenario(
            cfg, requests=requests, rate_hz=60.0, window=16,
            queue_depth=16, max_batch=8, deadline_s=5.0, seed=args.seed,
            device=device))

    doc = {"bench": "serving_bench", "device": str(device),
           "smoke": bool(args.smoke), "cells": cells}
    for c in cells:
        print(f"{c['scenario']:>9}: {c['completed']}/{c['requests']} ok, "
              f"p50 {c['p50_ms']:.0f}ms p99 {c['p99_ms']:.0f}ms, "
              f"goodput {c['goodput_rps']:.1f}/s, "
              f"missed {c['deadline_missed']}, shed {c['queue_rejected']}, "
              f"retries {c['retries']}, recoveries {c['recoveries']}"
              + (f", evicted {c['evictions']} resharded {c['reshards']} "
                 f"returned {c['device_returns']}, degraded "
                 f"{c['degraded_requests']}"
                 if c["scenario"] == "capacity" else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    if args.check:
        bad = gate(cells)
        if bad:
            raise SystemExit("serving gate failed: " + "; ".join(bad))
        print(f"serving gate OK ({len(cells)} cells)")
    return doc


if __name__ == "__main__":
    main()

"""Guardrail detection and probe-overhead benchmark of the port, the
counterpart of the reference's ``benchmarks/guardrail_bench.py``.

    python -m repro_torch.bench.guardrail_bench [--smoke] [--device cpu]
        [--check] [--out guardrails.json]

Two cell families, both deterministic per seed:

* ``"kind": "detection"`` — every ``FaultInjector`` value corruption
  (bit-flip / sign-flip / stale buffer / NaN splat) injected at dispatch
  1 of every serving path (plain tier / dense kernel tier / banded kernel
  tier / bfloat16 kernel tier) of a ``SortServer`` under a rate-1 shadow.
  Each cell records whether the corruption was *detected* (an
  ``IntegrityViolation`` incident and the probe that fired), *repaired*
  (the request still completed) and *bit_identical* (the repaired result
  equals an uninjected run of the same path and seed).
* ``"kind": "overhead"`` — the cost of the probes on a clean batched
  anneal, one cell per (mode, shadow_rate), the default serving rate 1/32
  included.  Guarded and unguarded runs take the same rung-segmented
  schedule (the unguarded one gets a no-op ``rung_hook``, so both pay the
  same host syncs), and ``overhead_pct`` is min-of-reps over interleaved
  repetitions.

``--check`` carries ``tools/check_bench.py``'s guardrail rules: every
detection cell injected, detected with a named probe, repaired and
bitwise; ``detection_rate`` exactly 1.0; exactly one default overhead
cell; and, outside ``--smoke``, that cell's overhead at most 5%.
``wall_clock`` is "measured" on CUDA and "cpu" on the host.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_DET, HW_DET, D_DET = 16, (4, 4), 3
PATHS = {
    "plain": {},
    "kernel": {"use_kernel": True},
    "banded": {"use_kernel": True, "band": 8},
    "bf16": {"use_kernel": True, "compute_dtype": "bfloat16"},
}
CORRUPTIONS = {
    "bitflip": ("orders", 5),
    "signflip": ("losses", 1),
    "stale": ("losses", 0),
    "nan": ("losses", 2),
}
MAX_DEFAULT_OVERHEAD_PCT = 5.0


def _det_cfg(path):
    from repro_torch.core import ShuffleSoftSortConfig
    return ShuffleSoftSortConfig(rounds=4, inner_steps=2, chunk=N_DET,
                                 **PATHS[path])


def _serve_once(cfg, x, key, device, *, engine=None, guardrail=None):
    from repro_torch.launch.serve import SortServer
    from repro_torch.runtime.fault_tolerance import RetryPolicy
    server = SortServer(HW_DET, d=D_DET, cfg=cfg, max_wait_ms=0.0,
                        sched_rungs=2, engine_fn=engine,
                        guardrail=guardrail, device=device,
                        retry=RetryPolicy(max_retries=4, backoff_base_s=0.0))
    try:
        out = server.submit(x, key=key).result(timeout=300)
    finally:
        stats = server.stats
        server.close()
    return out, stats


def run_detection_grid(paths, corruptions, device):
    from repro_torch.core import run_round_segment
    from repro_torch.runtime.fault_tolerance import (CorruptionSpec,
                                                     FaultInjector)
    from repro_torch.runtime.guardrails import GuardrailPolicy
    full = GuardrailPolicy(mode="shadow", shadow_rate=1.0)
    x = np.random.RandomState(0).rand(N_DET, D_DET).astype(np.float32)
    key = 11
    cells = []
    for path in paths:
        cfg = _det_cfg(path)
        clean, _ = _serve_once(cfg, x, key, device)
        for name in corruptions:
            target, index = CORRUPTIONS[name]
            inj = FaultInjector(
                run_round_segment,
                corrupt_calls={1: CorruptionSpec(name, target, index)})
            t0 = time.perf_counter()
            try:
                out, stats = _serve_once(cfg, x, key, device, engine=inj,
                                         guardrail=full)
                repaired = True
            except Exception:
                out, stats, repaired = None, {}, False
            wall = time.perf_counter() - t0
            incidents = stats.get("integrity_incidents", [])
            probe = incidents[0]["probe"] if incidents else None
            identical = repaired and all(
                np.array_equal(np.asarray(a), np.asarray(b))
                for a, b in zip(out, clean))
            cells.append({
                "kind": "detection", "path": path, "corruption": name,
                "target": target, "dispatch_index": 1,
                "injected": int(inj.corruptions),
                "detected": stats.get("integrity_violations", 0) >= 1,
                "probe": probe, "repaired": bool(repaired),
                "bit_identical": bool(identical),
                "violations": int(stats.get("integrity_violations", 0)),
                "self_heals": int(stats.get("self_heals", 0)),
                "wall_s": wall,
            })
            c = cells[-1]
            flag = ("ok" if c["detected"] and repaired and identical
                    else "FAIL")
            print(f"  detection {path:7s} x {name:9s} -> "
                  f"probe={probe!s:13s} {flag}", flush=True)
    return cells


def overhead_points(default_rate):
    from repro_torch.runtime.guardrails import GuardrailPolicy
    return [
        ("off", None, False),
        ("invariants", GuardrailPolicy(mode="invariants", seed=3), False),
        ("shadow", GuardrailPolicy(mode="shadow", shadow_rate=default_rate,
                                   seed=3), True),
        ("shadow", GuardrailPolicy(mode="shadow", shadow_rate=0.25,
                                   seed=3), False),
        ("shadow", GuardrailPolicy(mode="shadow", shadow_rate=1.0,
                                   seed=3), False),
    ]


def run_overhead(*, hw, b, rounds, inner_steps, every, reps, default_rate,
                 device, cfg_kw=None, d=D_DET):
    """The probes' cost on one clean batched anneal per point, every point
    on the same rung-segmented schedule, min over interleaved reps."""
    import torch

    from repro_torch.core import (ShuffleSoftSortConfig,
                                  shuffle_soft_sort_batched)
    from repro_torch.runtime.guardrails import shadow_sampled
    n = hw[0] * hw[1]
    cfg = ShuffleSoftSortConfig(rounds=rounds, inner_steps=inner_steps,
                                chunk=min(n, 256), **(cfg_kw or {}))
    xs = np.random.RandomState(0).rand(b, n, d).astype(np.float32)
    cuda = torch.device(device).type == "cuda"

    def once(guardrail):
        kw = ({"guardrail": guardrail} if guardrail is not None
              else {"rung_hook": lambda start: None})
        t0 = time.perf_counter()
        shuffle_soft_sort_batched(xs, hw, cfg, seed=0, device=device,
                                  checkpoint_every=every, **kw)
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    points = overhead_points(default_rate)
    once(None)                    # first-call costs out of the timings
    once(points[-1][1])
    best = [float("inf")] * len(points)
    for _ in range(reps):         # interleaved: drift hits all points
        for i, (_, pol, _) in enumerate(points):
            best[i] = min(best[i], once(pol))
    base = best[0]
    starts = range(0, rounds, every)
    cells = []
    for i, (mode, pol, is_default) in enumerate(points):
        rate = (0.0 if pol is None or pol.mode != "shadow"
                else pol.shadow_rate)
        cells.append({
            "kind": "overhead", "mode": mode, "shadow_rate": rate,
            "default": bool(is_default), "B": b, "N": n, "d": d,
            "rounds": rounds, "inner_steps": inner_steps,
            "rungs": len(starts), "tier": dict(cfg_kw or {}),
            "rungs_shadowed": int(sum(shadow_sampled(pol.seed, s, rate)
                                      for s in starts)) if pol else 0,
            "reps": reps, "unguarded_s": base, "guarded_s": best[i],
            "overhead_pct": 100.0 * (best[i] - base) / base,
        })
        print(f"  overhead {mode:10s} rate={rate:<7.5g} {best[i]:.3f}s "
              f"{cells[-1]['overhead_pct']:+.1f}%"
              + ("  [default]" if is_default else ""), flush=True)
    return cells


def gate(doc) -> list[str]:
    """``tools/check_bench.py``'s guardrail rules; returns the failures."""
    bad = []
    det = [c for c in doc["cells"] if c["kind"] == "detection"]
    over = [c for c in doc["cells"] if c["kind"] == "overhead"]
    if not det or not over:
        bad.append("need detection and overhead cells")
    for c in det:
        where = f"{c['path']}/{c['corruption']}"
        if c["injected"] < 1:
            bad.append(f"{where} never injected its corruption")
        if not (c["detected"] and c["repaired"] and c["bit_identical"]):
            bad.append(f"{where} failed the chaos gate: detected="
                       f"{c['detected']} repaired={c['repaired']} "
                       f"bit_identical={c['bit_identical']}")
        if c["detected"] and not c["probe"]:
            bad.append(f"{where} detected with no probe recorded")
    if det and doc["detection_rate"] != 1.0:
        bad.append(f"detection_rate = {doc['detection_rate']} != 1.0")
    defaults = [c for c in over if c["default"]]
    if len(defaults) != 1:
        bad.append(f"{len(defaults)} default overhead cells, need one")
    for c in over:
        if not 0.0 <= c["shadow_rate"] <= 1.0:
            bad.append(f"overhead shadow_rate {c['shadow_rate']}")
    for c in defaults:
        if not doc["smoke"] and not (
                c["overhead_pct"] <= MAX_DEFAULT_OVERHEAD_PCT):
            bad.append(f"default-rate overhead {c['overhead_pct']:.2f}% > "
                       f"{MAX_DEFAULT_OVERHEAD_PCT}%")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced grid and a small overhead problem, "
                         "exempt from the timing gate")
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a CUDA "
                         "device) or cpu")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the detection and overhead gates "
                         "pass")
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.core import resolve_device
    from repro_torch.runtime.guardrails import GuardrailPolicy
    device = resolve_device(args.device)
    default_rate = GuardrailPolicy().shadow_rate
    print("detection grid:", flush=True)
    if args.smoke:
        det = run_detection_grid(("plain", "kernel"), ("signflip", "nan"),
                                 device)
        print("probe overhead:", flush=True)
        over = run_overhead(hw=(8, 8), b=4, rounds=8, inner_steps=2,
                            every=1, reps=2, default_rate=default_rate,
                            device=device)
    else:
        det = run_detection_grid(sorted(PATHS), sorted(CORRUPTIONS), device)
        print("probe overhead:", flush=True)
        over = run_overhead(hw=(16, 16), b=16, rounds=96, inner_steps=4,
                            every=2, reps=4, default_rate=default_rate,
                            device=device)
    ok = [c for c in det if c["detected"] and c["repaired"]
          and c["bit_identical"]]
    doc = {
        "bench": "guardrail_bench", "device": str(device),
        "smoke": bool(args.smoke),
        "wall_clock": "measured" if device.type == "cuda" else "cpu",
        "torch": torch.__version__,
        "default_shadow_rate": default_rate,
        "detection_rate": len(ok) / max(1, len(det)),
        "cells": det + over,
    }
    print(f"{len(det)} detection cells (rate {doc['detection_rate']:.2f}), "
          f"{len(over)} overhead cells")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
        print(f"wrote {args.out}")
    if args.check:
        bad = gate(doc)
        if bad:
            raise SystemExit("guardrail gate failed: " + "; ".join(bad))
        print("guardrail gate OK")
    return doc


if __name__ == "__main__":
    main()

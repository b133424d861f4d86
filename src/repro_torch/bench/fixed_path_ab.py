"""A/B of the fixed path between two checkouts on one card.

    python -m repro_torch.bench.fixed_path_ab A_ROOT B_ROOT [--cycles 2]
        [--reps 3] [--out FILE]

Runs ``chip_smoke.py``'s ``anneal`` of its ``main_run`` (dense) and
``band_main_run`` (``band="auto"``) configurations, each checkout from its
own root in its own processes, in the order a b b a per cycle, ``reps``
runs of each configuration per process.  Each process builds (or finds)
its checkout's kernels first.  Prints one JSON line per process and a
summary line: the ms per round of every run by checkout and
configuration, their medians, B's median over A's, and whether the two
checkouts' orders and losses are bitwise equal.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

CHILD = r"""
import hashlib, json, os, sys
root, reps = sys.argv[1], int(sys.argv[2])
sys.path[:0] = [root, os.path.join(root, "src")]
os.chdir(root)
import importlib
import numpy as np
import torch
import chip_smoke as cs
from repro_torch import core
from repro_torch.examples.image_grid_sorting import synthetic_catalog
from repro_torch.kernels import build
K = importlib.import_module("repro_torch.kernels.softsort_apply")
torch.backends.cuda.matmul.allow_tf32 = False
build.build_all()
hw, d = (64, 64), 50
xs = np.stack([synthetic_catalog(4096, d, clusters=24, seed=i)[0]
               for i in range(4)])
out = {}
for phase, band in (("main_run", None), ("band_main_run", "auto")):
    cfg = core.ShuffleSoftSortConfig(rounds=32, inner_steps=8,
                                     use_kernel=True, band=band)
    ms, digests = [], set()
    for _ in range(reps):
        res, _, timing = cs.anneal(torch, core, K, xs, hw, cfg, 2)
        ms.append(timing["ms_per_round"])
        digests.add(hashlib.sha256(res.all_orders.tobytes()
                                   + res.all_losses.tobytes()).hexdigest())
    out[phase] = {"ms_per_round": ms, "digests": sorted(digests)}
print(json.dumps(out), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a_root")
    ap.add_argument("b_root")
    ap.add_argument("--cycles", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    roots = {"a": os.path.abspath(args.a_root),
             "b": os.path.abspath(args.b_root)}
    runs = {"a": [], "b": []}
    for _ in range(args.cycles):
        for side in "abba":
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, roots[side], str(args.reps)],
                capture_output=True, text=True, timeout=900)
            if proc.returncode:
                sys.stderr.write(proc.stderr)
                return proc.returncode
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            print(json.dumps({"side": side, **got}), flush=True)
            runs[side].append(got)
    summary = {"roots": roots, "order": "abba" * args.cycles,
               "reps": args.reps}
    for phase in ("main_run", "band_main_run"):
        ms = {s: [v for r in runs[s] for v in r[phase]["ms_per_round"]]
              for s in "ab"}
        digests = {s: sorted({h for r in runs[s] for h in r[phase]["digests"]})
                   for s in "ab"}
        med = {s: float(np.median(ms[s])) for s in "ab"}
        summary[phase] = {
            "ms_per_round": ms, "median": med,
            "range": {s: [min(ms[s]), max(ms[s])] for s in "ab"},
            "b_over_a": med["b"] / med["a"],
            "bitwise_equal": digests["a"] == digests["b"]
            and len(digests["a"]) == 1}
    line = json.dumps({"summary": summary})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

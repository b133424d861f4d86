"""Before / after roofline comparison of two dry-run sweeps as a markdown
table, the port's counterpart of ``benchmarks/compare_sweeps.py``.

    python -m repro_torch.bench.compare_sweeps \
        --before dryrun_single.json --after dryrun_single_final.json
"""
from __future__ import annotations

import argparse
import json

from repro_torch.bench.roofline import analyze


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", default="dryrun_single.json")
    ap.add_argument("--after", default="dryrun_single_final.json")
    args = ap.parse_args(argv)

    def load(path):
        with open(path) as f:
            rows = analyze(json.load(f))
        return {(r["arch"], r["shape"]): r for r in rows}

    b, a = load(args.before), load(args.after)
    print("| arch | shape | bound before | bound after | Δ | dominant after |")
    print("|---|---|---:|---:|---:|---|")
    better = worse = same = 0
    for key in sorted(b):
        if key not in a:
            continue
        rb, ra = b[key], a[key]
        bb = max(rb["compute_s"], rb["memory_s"], rb["collective_s"])
        ba = max(ra["compute_s"], ra["memory_s"], ra["collective_s"])
        delta = (ba - bb) / bb * 100 if bb else 0.0
        if delta < -2:
            better += 1
        elif delta > 2:
            worse += 1
        else:
            same += 1
        print(f"| {key[0]} | {key[1]} | {bb:.3f}s | {ba:.3f}s "
              f"| {delta:+.0f}% | {ra['dominant']} |")
    print(f"\nimproved: {better}, unchanged(±2%): {same}, regressed: {worse}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

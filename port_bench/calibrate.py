"""The readings the limits of ``correct`` are set from: one process runs a
cell's path on many seeds, sound, as the control and with each planted
fault of ``port_bench.faults``, each a short window at the cell's own
sizes and load, and prints each run's numbers compared.

    python3 port_bench/calibrate.py --workload grid8192_gallery \
        --seconds 10 --seeds 11 12 13 --variants sound control \
        --out chiprun_out/cal.jsonl

Limits play no part here: every number is printed as it reads.  It runs
on the card alone, and refuses to run without one.  Not run by the
benchmark itself.
"""
import argparse
import importlib.util
import itertools
import json
import sys
import time
from pathlib import Path

# run.py beside this file: its set-up of caches and import paths.
_run_spec = importlib.util.spec_from_file_location(
    "port_bench_run", Path(__file__).with_name("run.py"))
run = importlib.util.module_from_spec(_run_spec)
_run_spec.loader.exec_module(run)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--variants", nargs="+", default=["sound"])
    ap.add_argument("--out", required=True)
    ap.add_argument("--rates", type=float, nargs="*", default=[None],
                    help="open-loop rates to sweep (req/s) in place of "
                         "the mix's own")
    args = ap.parse_args(argv)
    run.setup_env()
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device: every reading behind a limit comes "
              "from the card", file=sys.stderr)
        return 3
    from port_bench import faults, harness

    spec = harness.resolve(run.ROOT, args.workload)
    counts = ("start_groups", "quality_instances")
    open_limits = {k: (v if k in counts else float("inf"))
                   for k, v in spec["limits"].items()}
    spec = dict(spec, limits=open_limits)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as f:
        for name, seed, rate in itertools.product(args.variants, args.seeds,
                                                  args.rates):
            run_spec, ctx = faults.variant(spec, name)
            if rate is not None:
                run_spec = dict(run_spec, traffic=dict(run_spec["traffic"],
                                                       rate_per_s=rate))
            t = time.monotonic()
            try:
                with ctx:
                    line = harness.run(run_spec, seed=seed,
                                       seconds=args.seconds, trace=False,
                                       device="cuda", t_start=t)
                rec = {"checks": {k: v["value"]
                                  for k, v in line["checks"].items()},
                       "metrics": {k: v["value"]
                                   for k, v in line["metrics"].items()},
                       "attempted": line["attempted"],
                       "failed": line["failed"]}
            except Exception as e:          # a crash reads as a failure
                rec = {"error": repr(e)}
            rec.update(variant=name, seed=seed, rate=rate,
                       s=time.monotonic() - t)
            print(json.dumps(rec), flush=True)
            f.write(json.dumps(rec) + "\n")
            f.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())

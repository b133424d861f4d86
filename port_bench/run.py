"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout holding ``BENCHMARK.json``, ``port_bench/``
and the program (``src/repro_torch``), on a machine with as many CUDA
cards as the cell asks for.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, then ``checks``: each number compared,
beside its limit); the same numbers close standard error.  Without a
card, with too few, without the program, or with JAX or the JAX package
loaded once the window has closed, it exits non-zero and prints no
result.
"""
import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "port_bench" / ".cache"


def setup_env() -> None:
    """The program's kernel builds and any Triton cache stay in the
    checkout, at fixed paths, so only a checkout's first run builds; the
    benchmark and the program import from the checkout."""
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    setup_env()
    from port_bench import harness

    try:
        spec = harness.resolve(ROOT, args.workload)
    except harness.CellError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"error: no program at {ROOT / 'src' / 'repro_torch'}",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < spec["chips"]:
        print(f"error: {args.workload} needs {spec['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 3
    torch.cuda.set_device(0)

    line = harness.run(spec, seed=args.seed, seconds=args.seconds,
                       trace=bool(args.trace), device="cuda",
                       t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"error: loaded {bad}: the benchmark runs the port alone",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())

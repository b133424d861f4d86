"""Benchmark entry point of the port: one section per paper table.  Prints
``name,us_per_call,derived`` CSV, as the reference's ``benchmarks/run.py``.

    python -m repro_torch.bench.run [--full] [--device cpu] [--n 64]
        [--smoke]

* ``paper_table.<method>`` — Table III (``repro_torch.bench.paper_table``):
  microseconds of the whole run, then DPQ_16, parameters and validity.
  ``--full`` is the paper's N = 1024 with the full budgets; the default
  fast mode is N = 256 (``--n`` overrides N).
* ``kernel.<cell>.<tier>`` — the port's ``kernel_bench`` cells: one
  fwd+grad call of each tier, with its parity and bound (``--smoke``: the
  bench's small cell).
* ``roofline.<arch>.<shape>`` — the bound of each dry-run record of
  ``--records`` (``repro_torch.launch.dryrun --all --out ...``) at an
  H100 SXM's peaks (``repro_torch.bench.roofline``); without the file, the
  reference's note that the records are missing.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a CUDA device) "
                         "or cpu, where the plain twins run")
    ap.add_argument("--smoke", action="store_true",
                    help="the kernel bench's small cell only")
    ap.add_argument("--records", default="dryrun_single.json")
    args = ap.parse_args(argv)

    from repro_torch.bench import kernel_bench, paper_table
    from repro_torch.core.shufflesoftsort import resolve_device
    device = resolve_device(args.device)
    print("name,us_per_call,derived")

    # ---- paper Table III: method comparison ---------------------------
    n = args.n or (1024 if args.full else 256)
    budget = "full" if args.full else "fast"
    t0 = time.time()
    for r in paper_table.run(n=n, budget=budget, device=device):
        print(f"paper_table.{r['method']},{r['runtime_s'] * 1e6:.0f},"
              f"dpq16={r['dpq16']};params={r['params']};"
              f"valid={r['valid']}")
    sys.stderr.write(f"[paper_table n={n} done in {time.time()-t0:.0f}s]\n")

    # ---- kernel microbench (the runtime column's analogue) ------------
    cells = (kernel_bench.SMOKE_CELLS if args.smoke
             else kernel_bench.FULL_CELLS)
    for nn, d, bsz, band in cells:
        for dtype in kernel_bench.DTYPES:
            cell = kernel_bench.run_cell(nn, d, bsz, band, dtype,
                                         device=device)
            for tier, secs in cell["fwdgrad_s"].items():
                derived = [f"bound_ms={cell['bound_ms'][tier]:.4g}"] \
                    if tier in cell["bound_ms"] else []
                derived += [f"{k.split('_', 1)[1]}={v:.2e}"
                            for k, v in cell["parity"].items()
                            if k.startswith(tier + "_")]
                derived.append(f"wall_clock={cell['wall_clock']}")
                print(f"kernel.N{nn}_d{d}_B{bsz}_K{band}_{dtype}.{tier},"
                      f"{secs * 1e6:.0f},{';'.join(derived)}")

    # ---- roofline terms from the dry-run (figure analogue) ------------
    roofline_rows(args.records)
    return 0


def roofline_rows(path: str) -> None:
    """Print one CSV row per analysed record of ``path``, or the note that
    it is missing."""
    if not os.path.exists(path):
        sys.stderr.write(f"[no {path}; run repro_torch.launch.dryrun "
                         "--all --out ... for roofline rows]\n")
        return
    from repro_torch.bench.roofline import analyze
    with open(path) as f:
        recs = json.load(f)
    for r in analyze(recs):
        bound_s = max(r["compute_s"], r["memory_s"], r["collective_s"])
        print(f"roofline.{r['arch']}.{r['shape']},{bound_s * 1e6:.0f},"
              f"dominant={r['dominant']};useful={r['useful_ratio']:.3f};"
              f"roofline_frac={r['roofline_frac']:.3f}")


if __name__ == "__main__":
    sys.exit(main())

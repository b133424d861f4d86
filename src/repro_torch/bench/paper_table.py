"""The paper's Table III in the port: Gumbel-Sinkhorn (N^2 parameters),
Kissing (2NM), plain SoftSort (N) and ShuffleSoftSort (N) on random RGB
colours.

Counterpart of the reference's ``benchmarks/paper_table.py``: the same
colours (``uniform(prng_key(seed), (N, 3))``, bitwise the reference's),
the methods in its order with its configs and keys, and its columns:
learnable-parameter count, wall-clock seconds (on the device the run
names: the card's, or the CPU's for the plain twins, which say nothing
about the card), DPQ_16, mean neighbour distance and permutation
validity.  ``tier="kernel"`` (the default on the card) runs the two
SoftSort rows on the kernel tier (the dense SoftSort kernels 1-4);
``"plain"`` on the plain PyTorch apply.

    python -m repro_torch.bench.paper_table [--n 1024] [--budget full]
        [--device cpu] [--tier plain] [--check]

``--check`` exits non-zero unless ShuffleSoftSort's DPQ_16 is above
SoftSort's, every row but Kissing's is a valid permutation, and the
parameter column is exactly N^2, 2NM, N, N.  Kissing's validity is
reported as found (the paper reports the method failing on colours).
"""
from __future__ import annotations

import argparse
import math
import sys
import time

import numpy as np
import torch

from repro_torch.core import threefry
from repro_torch.core.baselines.gumbel_sinkhorn import (
    GumbelSinkhornConfig,
    gumbel_sinkhorn_sort,
)
from repro_torch.core.baselines.kissing import KissingConfig, kissing_sort
from repro_torch.core.metrics import dpq, mean_neighbor_distance
from repro_torch.core.shufflesoftsort import (
    ShuffleSoftSortConfig,
    resolve_device,
    shuffle_soft_sort,
    soft_sort_baseline,
)
from repro_torch.core.softsort import is_valid_permutation

METHODS = ("gumbel-sinkhorn", "kissing", "softsort", "shufflesoftsort")


def kissing_rank(n: int) -> int:
    """M of the reference's table: 13 at N = 1024 (2NM = 26624)."""
    return max(int(np.ceil(np.sqrt(n) / 2.46)), 13 if n >= 1024 else 8)


def expected_params(n: int) -> dict:
    return {"gumbel-sinkhorn": n * n, "kissing": 2 * n * kissing_rank(n),
            "softsort": n, "shufflesoftsort": n}


def configs(n: int, budget: str, tier: str):
    """The reference's configs of each row at ``budget``."""
    fast = budget == "fast"
    return (GumbelSinkhornConfig(steps=200 if fast else 1200),
            KissingConfig(rank=kissing_rank(n), steps=200 if fast else 1200),
            ShuffleSoftSortConfig(rounds=250 if fast else 1000,
                                  inner_steps=8, chunk=min(256, n),
                                  use_kernel=tier == "kernel"))


def colours(n: int, seed: int, device) -> torch.Tensor:
    """``jax.random.uniform(PRNGKey(seed), (n, 3))``, bitwise."""
    return threefry.uniform(threefry.prng_key(seed), (n, 3), device=device)


def _timed(fn, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0, out


def run(n: int = 1024, budget: str = "full", seed: int = 42, *,
        device=None, tier: str | None = None) -> list[dict]:
    """The table's rows, in the reference's order.  ``tier`` None means
    "kernel" on CUDA and "plain" elsewhere."""
    device = resolve_device(device)
    tier = tier or ("kernel" if device.type == "cuda" else "plain")
    if tier not in ("kernel", "plain"):
        raise ValueError(f"tier must be 'kernel' or 'plain', got {tier!r}")
    side = int(round(math.sqrt(n)))
    hw = (side, side)
    if side * side != n:
        raise ValueError(f"N = {n} is not a square")
    x = colours(n, seed, device)
    gs_cfg, ki_cfg, ss_cfg = configs(n, budget, tier)
    params = expected_params(n)
    rows = []

    def add(name, seconds, order, xsorted, valid=None):
        ok = bool(is_valid_permutation(order) if valid is None else valid)
        rows.append({
            "method": name, "params": params[name], "runtime_s": seconds,
            "dpq16": round(dpq(xsorted, hw), 3) if ok else float("nan"),
            "nbr_dist": round(mean_neighbor_distance(xsorted, hw), 3),
            "valid": ok, "tier": tier,
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")})

    t, (o, xsr, _) = _timed(lambda: gumbel_sinkhorn_sort(
        x, hw, gs_cfg, device=device), device)
    add("gumbel-sinkhorn", t, o, xsr)
    t, (o, xsr, _, valid) = _timed(lambda: kissing_sort(
        x, hw, ki_cfg, device=device), device)
    add("kissing", t, o, xsr, valid=valid)
    t, (o, xsr, _) = _timed(lambda: soft_sort_baseline(
        x, hw, ss_cfg, device=device), device)
    add("softsort", t, o, xsr)
    t, (o, xsr, _) = _timed(lambda: shuffle_soft_sort(
        x, hw, ss_cfg, key=threefry.prng_key(1), device=device), device)
    add("shufflesoftsort", t, o, xsr)
    return rows


def check(rows, n: int) -> list[str]:
    """The table's gate: the failures (empty when it holds)."""
    by = {r["method"]: r for r in rows}
    bad = []
    want = expected_params(n)
    for r in rows:
        if r["params"] != want[r["method"]]:
            bad.append(f"{r['method']}: params {r['params']} != "
                       f"{want[r['method']]}")
        if r["method"] != "kissing" and not r["valid"]:
            bad.append(f"{r['method']}: not a valid permutation")
    if not by["shufflesoftsort"]["dpq16"] > by["softsort"]["dpq16"]:
        bad.append(f"shufflesoftsort DPQ16 {by['shufflesoftsort']['dpq16']}"
                   f" not above softsort's {by['softsort']['dpq16']}")
    return bad


def print_table(rows, file=sys.stdout):
    hdr = (f"{'method':18s} {'params':>9s} {'runtime[s]':>10s} "
           f"{'DPQ16':>6s} {'nbr':>6s} {'valid':>5s}")
    print(hdr, file=file)
    print("-" * len(hdr), file=file)
    for r in rows:
        print(f"{r['method']:18s} {r['params']:>9,d} "
              f"{r['runtime_s']:>10.1f} {r['dpq16']:>6.3f} "
              f"{r['nbr_dist']:>6.3f} {str(r['valid']):>5s}", file=file)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--budget", choices=("fast", "full"), default="full")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None,
                    help="cuda (the default: raises without a CUDA device) "
                         "or cpu")
    ap.add_argument("--tier", choices=("kernel", "plain"), default=None,
                    help="the SoftSort rows' apply (default: kernel on "
                         "CUDA, plain elsewhere)")
    ap.add_argument("--check", action="store_true",
                    help="fail unless the table's ordering, validity and "
                         "parameter counts hold")
    args = ap.parse_args(argv)
    rows = run(args.n, args.budget, args.seed, device=args.device,
               tier=args.tier)
    print_table(rows)
    if args.check:
        bad = check(rows, args.n)
        if bad:
            print("paper table check failed: " + "; ".join(bad),
                  file=sys.stderr)
            return 1
        print("paper table check OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())

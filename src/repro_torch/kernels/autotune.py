"""Per-shape payload-tile autotuning of the SoftSort-apply kernels.

The port's counterpart of ``repro.kernels.autotune``.  There the
candidate axis is the Pallas block tiling; here it is the payload tile DT
of kernels 1, 3, 4, 5, 7, 8 and 9b, the one tile the launchers take at
run time (16, 32 or 64 columns of the payload per block,
``launch_*_dt`` in ``csrc/softsort_apply.cu``; 16 and 32 only when they
hold d).  Row and column tiles stay compile-time constants.

* ``search_cell`` / ``search_cells`` time every candidate DT of a cell,
  fwd+grad of the autograd Function (``repro_torch.kernels.ops``) on
  shuffled-arange keys and a normal payload, after holding the
  candidate's y, colsum, dw and dx to the plain twins (the same Function
  on CPU copies) within the kernels' file tolerances
  (``runtime.guardrails.APPLY_TOL``), and record the winner per (tier, N,
  d, K, dtype, backend), with whether every candidate gave the same bits.
* ``write_table`` merges rows into a JSON table (envelope ``bench:
  "autotune"``), keyed by backend; ``autotune_table.json`` beside this
  file is the committed one.
* ``lookup_blocks`` is what the kernel wrappers ask at every launch on
  the card (``softsort_apply._payload_dt``, when the caller names no
  tile).  A miss (no table, another backend, an unknown shape, a corrupt
  file or row) returns ``band_payload_tile(d)[0]``, the tile the kernels
  used before the table: dispatch never searches and never raises.

A candidate ``dt_ok`` rejects at d (16 or 32 below d) is timed as the
tile it clamps to, ``max(DT, band_payload_tile(d)[0])``, once, as the
reference collapses clamped tilings: three tiles at d <= 16, two at d <=
32 and one above.  The CPU runs the twins, which have no tile, so a CPU
search ranks copies of one computation and the CPU route never reads the
table.

    python -m repro_torch.kernels.autotune --out table.json --check  # card
    python -m repro_torch.kernels.autotune --device cpu --smoke --check
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import torch

from repro_torch.kernels.softsort_apply import band_payload_tile

TABLE_PATH = os.path.join(os.path.dirname(__file__), "autotune_table.json")

CANDIDATES = {"fused": [16, 32, 64], "banded": [16, 32, 64]}
SMOKE_CANDIDATES = {"fused": [16, 64], "banded": [16, 64]}

# (tier, N, d, K) cells of the full search, the reference's (K = 0: the
# dense tier).
FULL_CELLS = [
    ("fused", 1024, 8, 0),
    ("fused", 1024, 50, 0),
    ("banded", 1024, 8, 128),
    ("banded", 1024, 50, 128),
    ("banded", 2048, 8, 128),
    ("banded", 4096, 8, 256),
]
SMOKE_CELLS = [
    ("fused", 256, 8, 0),
    ("banded", 384, 8, 64),
]

DTYPES = ("float32", "bfloat16")
TIERS = ("fused", "banded")
_QUANTITIES = ("y", "colsum", "dw", "dx")
TAU = 0.5


def _cell_key(tier: str, n: int, d: int, k: int, dtype: str,
              backend: str) -> tuple:
    return (tier, int(n), int(d), int(k or 0), str(dtype), str(backend))


def _dt_ok(dt: int, d: int) -> bool:
    """``dt_ok`` of ``csrc/softsort_apply.cu``: 64 always, 16 and 32 when
    they hold d."""
    return dt == 64 or (dt in (16, 32) and d <= dt)


def _effective(dt: int, d: int) -> int:
    """The tile candidate ``dt`` launches as at payload width d."""
    return max(int(dt), band_payload_tile(d)[0])


@functools.lru_cache(maxsize=8)
def _load_table(path: str):
    """The table's rows, key -> DT, parsed once per path; None when the
    file is absent, unreadable or not an autotune table.  A row whose
    winner is not a tile the launcher takes at its d is left out."""
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or doc.get("bench") != "autotune":
        return None
    rows = {}
    for cell in doc.get("cells", ()):
        try:
            key = _cell_key(cell["tier"], cell["N"], cell["d"], cell["K"],
                            cell["dtype"], cell["backend"])
            win = cell["winner"]
            dt = int(win[0] if isinstance(win, list) else win)
        except (KeyError, TypeError, ValueError, IndexError):
            continue
        if _dt_ok(dt, key[2]):
            rows[key] = dt
    return rows


def lookup_blocks(tier: str, n: int, d: int, k: int | None = None,
                  dtype: str = "float32", backend: str = "cuda",
                  path: str | None = None) -> int:
    """The payload tile DT for (tier, N, d, K, dtype) on ``backend``: the
    table's winner, or ``band_payload_tile(d)[0]`` on any miss.  A table
    read (parsed once per path), never a search, never an error.
    ``path`` None reads ``TABLE_PATH`` as it is at the call."""
    rows = _load_table(TABLE_PATH if path is None else path)
    if rows:
        dt = rows.get(_cell_key(tier, n, d, k or 0, dtype, backend))
        if dt is not None:
            return dt
    return band_payload_tile(d)[0]


# --------------------------------------------------------------------------
# Search.
# --------------------------------------------------------------------------

def _make_operands(n: int, d: int, device):
    """Shuffled-arange keys (1, N) and a normal payload (1, N, d), drawn
    with ``jax.random``'s threefry from ``PRNGKey(n + d)`` as the
    reference draws its operands (the payload within 4 ulp of its own),
    and seeded cotangents for y and colsum."""
    from repro_torch.core import threefry
    k1, k2 = threefry.split(threefry.prng_key(n + d), device="cpu")
    w = threefry.permutation(k1, n).to(torch.float32)[None]
    x = threefry.normal(k2, (1, n, d))
    gen = torch.Generator().manual_seed(n + d)
    gy = torch.randn((1, n, d), generator=gen)
    gc = torch.randn((1, n), generator=gen)
    return [t.to(device) for t in (w, x, gy, gc)]


def _fwd_grad(tier: str, k: int, dtype: str, dt, w, x, gy, gc):
    """y, colsum, dw and dx of one fwd+grad through the Function."""
    from repro_torch.kernels import ops
    wv = w.clone().requires_grad_(True)
    xv = x.clone().requires_grad_(True)
    with torch.enable_grad():
        if tier == "fused":
            y, c = ops.softsort_apply(wv, xv, TAU, compute_dtype=dtype,
                                      payload_tile=dt)
        else:
            y, c = ops.softsort_apply_banded(wv, xv, TAU, band=k,
                                             compute_dtype=dtype,
                                             payload_tile=dt)
        dw, dx = torch.autograd.grad((y * gy).sum() + (c * gc).sum(),
                                     (wv, xv))
    return [t.detach() for t in (y, c, dw, dx)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_fwd_grad(run, reps: int, device) -> float:
    """Mean seconds of one fwd+grad after a warm-up: CUDA events around
    ``reps`` calls on the card, the host clock on the CPU."""
    run()
    _sync(device)
    if torch.device(device).type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / max(reps, 1)
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - t0) / max(reps, 1)


def twin_errors(got, want) -> dict[str, float]:
    """Per quantity, the largest difference over the largest entry of the
    twins' (the measure of ``APPLY_TOL``)."""
    return {q: float((a.float().cpu() - b.float()).abs().max()
                     / b.float().abs().max().clamp_min(1e-30))
            for q, a, b in zip(_QUANTITIES, got, want)}


def search_cell(tier: str, n: int, d: int, k: int, dtype: str,
                candidates, reps: int = 10, device="cuda") -> dict:
    """Time every distinct candidate tile of one cell and return its table
    row: the winner, every candidate's seconds, the largest error against
    the twins and whether every candidate gave the same bits.  Raises
    ``ValueError`` if a candidate misses the twins' tolerance."""
    from repro_torch.runtime.guardrails import APPLY_TOL
    if tier not in TIERS:
        raise ValueError(f"tier must be one of {TIERS}, got {tier!r}")
    dev = torch.device(device)
    ops_in = _make_operands(n, d, dev)
    twin = _fwd_grad(tier, k, dtype, None, *[t.cpu() for t in ops_in])
    tol = APPLY_TOL[dtype]
    timings: dict[str, float] = {}
    seen: dict[int, str] = {}
    outs: dict[int, list] = {}
    worst = {q: 0.0 for q in _QUANTITIES}
    best, best_s = None, float("inf")
    for cand in candidates:
        eff = _effective(cand, d)
        if eff in seen:               # clamps to an already-timed tile
            timings[str(cand)] = timings[seen[eff]]
            continue
        seen[eff] = str(cand)
        out = _fwd_grad(tier, k, dtype, eff, *ops_in)
        errs = twin_errors(out, twin)
        bad = {q: e for q, e in errs.items() if not e <= tol[q]}
        if bad:
            raise ValueError(f"autotune {tier} N={n} d={d} K={k} {dtype} "
                             f"DT={eff}: off the twins {bad} (tolerance "
                             f"{tol})")
        worst = {q: max(worst[q], errs[q]) for q in _QUANTITIES}
        outs[eff] = out
        secs = _time_fwd_grad(
            lambda: _fwd_grad(tier, k, dtype, eff, *ops_in), reps, dev)
        timings[str(cand)] = secs
        if secs < best_s:
            best, best_s = eff, secs
    first = next(iter(outs.values()))
    bitwise_by = {q: all(torch.equal(out[i], first[i])
                         for out in outs.values())
                  for i, q in enumerate(_QUANTITIES)}
    return {
        "tier": tier, "N": n, "d": d, "K": int(k or 0), "dtype": dtype,
        "backend": dev.type,
        "winner": [best],
        "winner_s": best_s,
        "candidate_s": timings,
        "tiles": sorted(outs),
        "bitwise": all(bitwise_by.values()),
        "bitwise_by": bitwise_by,
        "max_err_vs_twin": worst,
    }


def search_cells(cells, candidates_by_tier, reps: int = 10, device="cuda",
                 verbose: bool = True) -> list[dict]:
    rows = []
    for tier, n, d, k in cells:
        for dtype in DTYPES:
            row = search_cell(tier, n, d, k, dtype, candidates_by_tier[tier],
                              reps=reps, device=device)
            rows.append(row)
            if verbose:
                print(f"autotune {tier} N={n} d={d} K={k} {dtype}: winner "
                      f"DT={row['winner'][0]} ({row['winner_s'] * 1e3:.4f} "
                      f"ms), tiles {row['tiles']}, bitwise "
                      f"{row['bitwise']}", flush=True)
    return rows


def write_table(rows, candidates_by_tier, path: str) -> dict:
    """Merge ``rows`` into the table at ``path`` and rewrite it: a row
    replaces the row of its (tier, N, d, K, dtype, backend) and leaves
    every other row, other backends' too; the candidate grids are the
    union per tier, so every committed winner stays in its grid."""
    cells: dict[tuple, dict] = {}
    grid: dict[str, list[int]] = {}
    if _load_table(path) is not None:
        with open(path) as f:
            old = json.load(f)
        for c in old.get("cells", ()):
            if isinstance(c, dict):
                try:
                    cells[_cell_key(c["tier"], c["N"], c["d"], c["K"],
                                    c["dtype"], c["backend"])] = c
                except KeyError:
                    continue
        for t, cands in old.get("candidates", {}).items():
            if isinstance(cands, list):
                grid[t] = [int(v) for v in cands]
    for row in rows:
        cells[_cell_key(row["tier"], row["N"], row["d"], row["K"],
                        row["dtype"], row["backend"])] = row
    for t, cands in candidates_by_tier.items():
        have = grid.setdefault(t, [])
        have += [int(c) for c in cands if int(c) not in have]
    doc = {
        "bench": "autotune",
        "version": 1,
        "note": ("payload-tile (DT) winners of the SoftSort-apply kernels "
                 "per (tier, N, d, K, dtype, backend), fwd+grad of the "
                 "autograd Function, each candidate held to the plain "
                 "twins; read by the kernel wrappers on the card "
                 "(band_payload_tile(d)[0] on a miss).  'bitwise': every "
                 "candidate gave the same y, colsum, dw and dx."),
        "candidates": {t: sorted(v) for t, v in grid.items()},
        "cells": [cells[k] for k in sorted(cells)],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")
    _load_table.cache_clear()
    return doc


def check_round_trip(rows, path: str) -> list:
    """Rows whose winner ``lookup_blocks`` does not read back from
    ``path`` (empty when the table round-trips)."""
    return [(r, got) for r in rows
            if (got := lookup_blocks(r["tier"], r["N"], r["d"], r["K"],
                                     r["dtype"], r["backend"], path))
            != r["winner"][0]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="the small cells and candidate grid")
    ap.add_argument("--device", default=None,
                    help="where to search (default: the card)")
    ap.add_argument("--out", default=None,
                    help="table to merge into (default: a file in a new "
                         "temporary directory; the committed table is "
                         "written only when named)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--check", action="store_true",
                    help="re-read every searched winner through "
                         "lookup_blocks; exit 1 on a mismatch")
    args = ap.parse_args(argv)

    from repro_torch.core.shufflesoftsort import resolve_device
    device = resolve_device(args.device)
    cells = SMOKE_CELLS if args.smoke else FULL_CELLS
    cands = SMOKE_CANDIDATES if args.smoke else CANDIDATES
    out = args.out or os.path.join(tempfile.mkdtemp(), "autotune.json")
    rows = search_cells(cells, cands, reps=args.reps, device=device)
    write_table(rows, cands, out)
    print(f"wrote {out} ({len(rows)} cells)")
    if args.check:
        bad = check_round_trip(rows, out)
        if bad:
            raise SystemExit(f"autotune round-trip failed: {bad}")
        print(f"round-trip OK ({len(rows)} cells)")
    return rows


if __name__ == "__main__":
    main()

"""Hillclimb driver: cost one cell under named variants on the dry-run's
mesh and report the roofline terms at an H100 SXM's peaks, the port's
counterpart of ``benchmarks/hillclimb.py``.

    python -m repro_torch.bench.hillclimb --cell granite_train
    python -m repro_torch.bench.hillclimb --cell llama4_prefill
    python -m repro_torch.bench.hillclimb --cell 405b_decode

Each cell lists (variant name, opts) pairs (``repro_torch.launch.steps.
lower_cell``'s opts) in hypothesis order; the results go to
``hillclimb_<cell>.json`` (``--out`` elsewhere).  The reference's
``paper_sort`` cell is not ported (ROADMAP.md A16d).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.bench.roofline import HBM_BW, LINK_BW, PEAK_FLOPS

CELLS = {
    "granite_train": {
        "arch": "granite-moe-3b-a800m", "shape": "train_4k",
        "variants": [
            ("baseline", {}),
            ("moe_shard", {"moe_shard": True}),
            ("group256", {"moe_group_size": 256}),
            ("group256+moe_shard", {"moe_group_size": 256,
                                    "moe_shard": True}),
            ("group128+moe_shard", {"moe_group_size": 128,
                                    "moe_shard": True}),
            ("no_remat+group256+moe_shard", {"moe_group_size": 256,
                                             "moe_shard": True,
                                             "remat": False}),
            ("gather_moe+group256", {"moe_impl": "gather",
                                     "moe_group_size": 256,
                                     "moe_shard": True}),
            ("gather_moe+group256+no_remat", {"moe_impl": "gather",
                                              "moe_group_size": 256,
                                              "moe_shard": True,
                                              "remat": False}),
        ],
    },
    "llama4_prefill": {
        "arch": "llama4-scout-17b-a16e", "shape": "prefill_32k",
        "variants": [
            ("baseline", {}),
            ("moe_shard", {"moe_shard": True}),
            ("moe_shard+group256", {"moe_shard": True,
                                    "moe_group_size": 256}),
            ("moe_shard+group1024", {"moe_shard": True,
                                     "moe_group_size": 1024}),
            ("gather_moe", {"moe_impl": "gather", "moe_shard": True}),
            ("gather_moe+group1024", {"moe_impl": "gather",
                                      "moe_shard": True,
                                      "moe_group_size": 1024}),
            ("router_bf16", {}),     # the router product in bf16 (code)
            ("router_bf16+seq_parallel", {"force_sp": True}),
            ("router_bf16+gather_moe", {"moe_impl": "gather",
                                        "moe_shard": True}),
            ("router_bf16+sp+gather", {"force_sp": True,
                                       "moe_impl": "gather",
                                       "moe_shard": True}),
        ],
    },
    "405b_decode": {
        "arch": "llama3-405b", "shape": "decode_32k",
        "variants": [
            ("baseline", {}),
            ("weight_stationary_2dtp", {"decode_dshard": True}),
        ],
    },
}


def run_cell_variants(name, mesh) -> list[dict]:
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import probe_corrected_costs
    from repro_torch.models.config import cell_by_name
    spec = CELLS[name]
    cfg = get_config(spec["arch"])
    cell = cell_by_name(spec["shape"])
    out = []
    for vname, opts in spec["variants"]:
        t0 = time.time()
        try:
            costs = probe_corrected_costs(cfg, cell, mesh, opts)
            rec = {
                "variant": vname, "opts": opts,
                "flops": costs["flops"],
                "bytes": costs["bytes_accessed"],
                "coll": costs["collective_bytes"],
                "compute_s": costs["flops"] / PEAK_FLOPS,
                "memory_s": costs["bytes_accessed"] / HBM_BW,
                "collective_s": costs["collective_bytes"] / LINK_BW,
                "wall_s": round(time.time() - t0, 1),
            }
            rec["bound_s"] = max(rec["compute_s"], rec["memory_s"],
                                 rec["collective_s"])
        except Exception as e:                              # noqa: BLE001
            rec = {"variant": vname, "opts": opts, "error": repr(e)}
        out.append(rec)
        if "bound_s" in rec:
            print(f"  {vname:32s} compute={rec['compute_s']:8.3f}s "
                  f"memory={rec['memory_s']:8.3f}s "
                  f"coll={rec['collective_s']:8.3f}s "
                  f"bound={rec['bound_s']:8.3f}s", flush=True)
        else:
            print(f"  {vname:32s} ERROR {rec['error'][:80]}", flush=True)
    return out


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import destroy_group, init_fake_group
    from repro_torch.launch.mesh import make_production_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS), required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    args = ap.parse_args(argv)
    init_fake_group(512 if args.mesh == "multi" else 256)
    try:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
        print(f"hillclimbing {args.cell} on {args.mesh} mesh", flush=True)
        out = run_cell_variants(args.cell, mesh)
    finally:
        destroy_group()
    path = f"hillclimb_{args.cell}.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

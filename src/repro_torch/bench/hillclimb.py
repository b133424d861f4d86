"""Hillclimb driver: cost one cell under named variants on the dry-run's
mesh and report the roofline terms at an H100 SXM's peaks, the port's
counterpart of ``benchmarks/hillclimb.py``.

    python -m repro_torch.bench.hillclimb --cell granite_train
    python -m repro_torch.bench.hillclimb --cell llama4_prefill
    python -m repro_torch.bench.hillclimb --cell 405b_decode

    python -m repro_torch.bench.hillclimb --cell paper_sort

Each cell lists (variant name, opts) pairs (``repro_torch.launch.steps.
lower_cell``'s opts) in hypothesis order; the results go to
``hillclimb_<cell>.json`` in the working directory.

``paper_sort`` is the paper's own workload: one SoftSort grad step
(``softsort_apply_chunked`` + ``grid_sorting_loss``, value and w
gradient) over N = 2^20 splat attributes (d = 59) on the 1024 x 1024
grid, w replicated and x row-sharded, in the reference's five variants
(``PAPER_VARIANTS``): rows over the mesh's first axis or all its axes,
chunk 512 or 2048, a float32 or bfloat16 payload.  Each runs
``repro_torch.launch.paper.sort_grad_step`` once on ``meta`` under the
dry-run's ``CostMode``: every chunk's products and every per-chunk
collective counted as often as it runs (that module's docstring sets its
collectives beside the reference's compiled ones).
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


# (variant, chunk, bf16 payload, rows over all mesh axes), the reference's
PAPER_VARIANTS = (
    ("baseline_rows_axis0_c512", 512, False, False),
    ("rows_all_axes_c512", 512, False, True),
    ("rows_all_axes_c2048", 2048, False, True),
    ("rows_all_axes_c512_bf16x", 512, True, True),
    ("rows_all_axes_c2048_bf16x", 2048, True, True),
)


def mesh_group(mesh):
    """The process group of all of the mesh's ranks: the world's, which
    the dry-run's meshes span."""
    import torch.distributed as dist
    if mesh.mesh.flatten().tolist() != list(range(dist.get_world_size())):
        raise ValueError(f"the mesh {tuple(mesh.shape)} does not span the "
                         f"{dist.get_world_size()} ranks of the group")
    return dist.group.WORLD


def run_paper_variants(mesh, n=1 << 20, d=59, *, hw=(1 << 10, 1 << 10)
                       ) -> list[dict]:
    """The paper's own workload, one SoftSort grad step, in the reference's
    variants (``PAPER_VARIANTS``), each on ``meta`` under ``CostMode`` and
    priced at the H100's peaks."""
    import torch

    from repro_torch.launch.dryrun import CostMode, collective_stats
    from repro_torch.launch.paper import sort_grad_step
    meta = torch.device("meta")
    groups = {False: mesh.get_group(0), True: mesh_group(mesh)}
    out = []
    for name, chunk, bf16, all_axes in PAPER_VARIANTS:
        group = groups[all_axes]
        shards = torch.distributed.get_world_size(group)
        w = torch.empty((n,), dtype=torch.float32, device=meta)
        x = torch.empty((n // shards, d), dtype=torch.float32, device=meta)
        tau = torch.empty((), dtype=torch.float32, device=meta)
        norm = torch.empty((), dtype=torch.float32, device=meta)
        with CostMode() as mode:
            sort_grad_step(w, x, tau, norm, hw=tuple(hw), chunk=chunk,
                           group=group, payload_dtype=(
                               torch.bfloat16 if bf16 else torch.float32))
        rec = {"variant": name, "flops": float(mode.flops),
               "bytes": float(mode.bytes_accessed),
               "coll": collective_stats(mode.collectives)["total_bytes"]}
        rec["compute_s"] = rec["flops"] / PEAK_FLOPS
        rec["memory_s"] = rec["bytes"] / HBM_BW
        rec["collective_s"] = rec["coll"] / LINK_BW
        rec["bound_s"] = max(rec["compute_s"], rec["memory_s"],
                             rec["collective_s"])
        print(f"  {name:32s} compute={rec['compute_s']:8.4f}s "
              f"memory={rec['memory_s']:8.4f}s "
              f"coll={rec['collective_s']:8.4f}s "
              f"bound={rec['bound_s']:8.4f}s", flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    from repro_torch.launch.dryrun import destroy_group, init_fake_group
    from repro_torch.launch.mesh import make_production_mesh
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(CELLS) + ["paper_sort"],
                    required=True)
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    args = ap.parse_args(argv)
    init_fake_group(512 if args.mesh == "multi" else 256)
    try:
        mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
        print(f"hillclimbing {args.cell} on {args.mesh} mesh", flush=True)
        if args.cell == "paper_sort":
            out = run_paper_variants(mesh)
        else:
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

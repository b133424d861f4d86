"""Dry-run of every (arch x shape x mesh) cell on the production meshes,
the port's counterpart of ``repro.launch.dryrun``.

    python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b --shape train_4k --mesh multi
    python -m repro_torch.launch.dryrun --all --mesh single --out dryrun.json
    python -m repro_torch.launch.dryrun --paper --mesh multi

One process stands for rank 0 of the mesh's 256 or 512: torch's in-process
``fake`` process group (``FakeStore``; its collectives move nothing), a
``DeviceMesh`` of the reference's shape, and ``meta`` tensors (shapes,
no memory).  Each cell's step (``repro_torch.launch.steps.lower_cell``)
runs once on ``meta`` DTensors placed by the cell's shardings.  The
reference lowers and compiles each cell with XLA and reads its HLO; the
port records the same keys from the step it runs:

* ``memory_analysis.argument_size_in_bytes`` / ``output_size_in_bytes``:
  the bytes of this rank's shards of the arguments and of the outputs,
  exact (XLA's temporaries have no eager counterpart and are not given);
* ``cost_analysis`` {flops, bytes_accessed}: every op this rank runs on
  its local shards (``CostMode``), FLOPs by PyTorch's formulas
  (``torch.utils.flop_counter``; the flash op by SDPA's), bytes as each
  op's tensor inputs read and outputs written, views excluded: eager
  PyTorch moves what every op reads and writes, where XLA fuses;
* ``collectives``: the collectives this rank issues (DTensor's
  redistributions and the sharded ops' gathers), priced by the
  reference's wire model (``collective_stats``);
* ``roofline_inputs`` {flops, bytes_accessed, collective_bytes}: the
  same totals.  The port runs its layers in a Python loop, so nothing is
  counted once per scan body; ``probe_corrected_costs`` (the reference's
  extrapolation from 1- and 2-unit probes) is kept for its record keys.

The checked property is the reference's: each cell builds, and its state
fits on a device (``argument_size_in_bytes``).  ``long_500k`` is skipped
for pure full-attention archs, as the reference skips it.

    python -m repro_torch.launch.dryrun --paper --mesh single

adds the paper's own cell (``run_paper_cell``, alone or beside ``--arch``
/ ``--all``): one ShuffleSoftSort round at N = 2^20, d = 59 on the
1024 x 1024 grid, ``inner_steps=2``, the plain chunked apply at chunk
512, x and the order sharded on the mesh's first axis.  It runs
``repro_torch.launch.paper.paper_round`` once on ``meta`` under
``CostMode``, its collectives on the group of the mesh's first axis, the
shuffle as one ``repro_torch::threefry_round`` op.  Its record has the
reference's keys: ``lower_s`` is that run's seconds and ``compile_s``
0.0 (nothing is compiled), ``cost_analysis`` counts every chunk's
products (the reference's XLA counts one ``lax.map`` body, so its FLOPs
grow with the chunk: ROADMAP.md Queue C's known properties), and
``collectives`` are 475 791 360 bytes per device on (16, 16) and
253 755 392 on (2, 16, 16) (``repro_torch.launch.paper``'s docstring
gives the arithmetic).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import get_config, list_archs
from repro_torch.models.config import SHAPE_CELLS, cell_by_name

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# torch's functional collectives, by the reference's HLO kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}
_UNCOUNTED = {"wait_tensor", "_wrap_tensor_autograd"}

def _group_size(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [t for t in torch.utils._pytree.tree_leaves(tree)
            if isinstance(t, torch.Tensor)]


class CostMode(TorchDispatchMode):
    """Counts the ops this rank runs on its local tensors: ``flops``,
    ``bytes_accessed`` (inputs read and outputs written by each op that is
    not a view) and ``collectives`` (one record per collective: its
    reference kind, the bytes of its HLO result type, its group size).

    An op on DTensors is handed back to DTensor (``NotImplemented``),
    whose local ops then reach this mode with local shapes; the global
    shape propagation DTensor runs under a fake mode is not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: list[dict] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE) is not None:
            return out              # DTensor's global shape propagation
        ns, name = func.namespace, func._opname
        if ns == "_dtensor" and name == "shard_dim_alltoall":
            self.collectives.append({"kind": "all-to-all",
                                     "bytes": _nbytes(args[0]),
                                     "group": _group_size(args[-1])})
            return out
        if ns == "_c10d_functional":
            if name not in _UNCOUNTED:
                self._collective(name, args, out)
            return out
        if func.is_view:
            return out
        formula = self.registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        seen = {}
        for t in _tensors((args, kwargs)) + _tensors(out):
            seen[id(t)] = _nbytes(t)
        self.bytes_accessed += sum(seen.values())
        return out

    def _collective(self, name, args, out):
        kind = _KINDS.get(name)
        if kind is None:
            raise NotImplementedError(f"collective {name} has no wire model")
        group = _group_size(args[-1])
        result = out if kind != "all-to-all" else args[0]
        self.collectives.append({"kind": kind, "bytes": _nbytes(result),
                                 "group": group})


def collective_stats(records) -> dict:
    """Per-device bytes moved per collective kind.  Bytes-on-the-wire
    model per op (g = group size, size = the bytes of its result), the
    reference's:
      all-gather:   result * (g-1)/g      all-reduce: 2 * size * (g-1)/g
      reduce-scatter: result * (g-1)      all-to-all: size * (g-1)/g
      collective-permute: size
    ``records``: dicts with ``kind``, ``bytes`` and ``group``."""
    stats = {k: {"count": 0, "bytes": 0.0} for k in _COLLECTIVES}
    for rec in records:
        kind, size, g = rec["kind"], rec["bytes"], rec["group"]
        if g <= 1:
            wire = 0.0 if kind != "collective-permute" else float(size)
        elif kind == "all-gather":
            wire = size * (g - 1) / g
        elif kind == "all-reduce":
            wire = 2.0 * size * (g - 1) / g
        elif kind == "reduce-scatter":
            wire = float(size) * (g - 1)
        elif kind == "all-to-all":
            wire = size * (g - 1) / g
        else:
            wire = float(size)
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += wire
    stats["total_bytes"] = sum(v["bytes"] for v in stats.values()
                               if isinstance(v, dict))
    return stats


def _local_bytes(tree) -> int:
    from repro_torch.models.sharded import is_dtensor
    return sum(_nbytes(t.to_local() if is_dtensor(t) else t)
               for t in _tensors(tree))


@contextlib.contextmanager
def nccl_shard_moves():
    """DTensor moves a tensor from one shard dim to another with an
    all-to-all on NCCL, but on a "cpu" mesh (the fake group's) with an
    all-gather and a local chunk, since gloo has none.  The fake group
    stands for an NCCL cluster: inside this context the move takes the
    all-to-all op on any mesh."""
    from torch.distributed.tensor import placement_types
    if not hasattr(placement_types, "shard_dim_alltoall"):
        raise RuntimeError("this torch moves shard dims elsewhere; the "
                           "dry-run cannot price them as all-to-alls")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            mesh.get_group(mesh_dim).group_name)

    saved = placement_types.shard_dim_alltoall
    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = saved


def step_costs(lowered) -> dict:
    """Run ``lowered``'s step once on ``meta`` under ``CostMode``:
    {flops, bytes_accessed, collective_bytes, collectives,
    argument_size_in_bytes, output_size_in_bytes}."""
    placed = lowered.place()
    args = _local_bytes(placed)
    with nccl_shard_moves(), CostMode() as mode:
        out = lowered.run(placed)
    coll = collective_stats(mode.collectives)
    return {"flops": float(mode.flops),
            "bytes_accessed": float(mode.bytes_accessed),
            "collective_bytes": coll["total_bytes"], "collectives": coll,
            "argument_size_in_bytes": args,
            "output_size_in_bytes": _local_bytes(out)}


def _cell_costs(cfg, cell, mesh, opts=None) -> dict:
    from repro_torch.launch.steps import lower_cell
    return step_costs(lower_cell(cfg, cell, mesh, opts))


def probe_corrected_costs(cfg, cell, mesh, opts=None) -> dict:
    """The reference's extrapolation from probes of 1 and 2 repeats of the
    block unit: total(R) = p1 + (R - 1) * (p2 - p1).  XLA counts a scan
    body once, which it corrects; the port counts every layer, and this
    gives the direct count again (the costs are linear in the repeats)."""
    unit, repeats = cfg.block_program()

    def probe_cfg(k):
        return dataclasses.replace(
            cfg, num_layers=k * len(unit),
            encoder_layers=(k if cfg.encoder_layers else 0),
            scan_unroll=True)

    p1 = _cell_costs(probe_cfg(1), cell, mesh, opts)
    p2 = _cell_costs(probe_cfg(2), cell, mesh, opts)
    out = {}
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        body = max(p2[key] - p1[key], 0.0)
        out[key] = p1[key] + (repeats - 1) * body
    out["probe1"] = {k: p1[k] for k in
                     ("flops", "bytes_accessed", "collective_bytes")}
    out["probe2"] = {k: p2[k] for k in
                     ("flops", "bytes_accessed", "collective_bytes")}
    out["repeats"] = repeats
    return out


def run_cell(arch: str, shape: str, mesh, mesh_name: str,
             verbose: bool = True) -> dict:
    from repro_torch.launch.steps import lower_cell
    cfg = get_config(arch)
    cell = cell_by_name(shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "kind": cell.kind}
    if cell.name == "long_500k" and not cfg.supports_long_context:
        rec["status"] = "skipped"
        rec["reason"] = ("pure full-attention arch: 500k dense decode is "
                         "quadratic in sequence length, so the cell is "
                         "excluded by design rather than left to OOM")
        return rec
    t0 = time.time()
    lowered = lower_cell(cfg, cell, mesh)
    rec["lower_s"] = round(time.time() - t0, 1)
    t0 = time.time()
    costs = lowered.cost()
    rec["run_s"] = round(time.time() - t0, 1)
    rec["memory_analysis"] = {
        k: costs[k] for k in ("argument_size_in_bytes",
                              "output_size_in_bytes")}
    rec["cost_analysis"] = {"flops": costs["flops"],
                            "bytes_accessed": costs["bytes_accessed"]}
    rec["collectives"] = costs["collectives"]
    rec["roofline_inputs"] = {k: costs[k] for k in
                              ("flops", "bytes_accessed",
                               "collective_bytes")}
    rec["torch"] = torch.__version__     # DTensor's strategies vary by it
    rec["status"] = "ok"
    if verbose:
        ri = rec["roofline_inputs"]
        print(f"  [{arch} x {shape} x {mesh_name}] run={rec['run_s']}s "
              f"args={costs['argument_size_in_bytes']:.3e}B "
              f"flops={ri['flops']:.3e} bytes={ri['bytes_accessed']:.3e} "
              f"coll={ri['collective_bytes']:.3e}B", flush=True)
    return rec


def run_paper_cell(mesh, mesh_name: str, n: int = 1 << 20, d: int = 59,
                   chunk: int = 512, *, hw=(1 << 10, 1 << 10)) -> dict:
    """The paper's own workload at Self-Organizing-Gaussians scale: one
    ShuffleSoftSort round over N = 2^20 splat attribute vectors (d = 59),
    x and the order sharded on the mesh's first axis, run once on
    ``meta`` by ``repro_torch.launch.paper.paper_round`` under
    ``CostMode``.  ``hw`` (the grid, h * w = n) is the reference's
    1024 x 1024 unless a smaller n needs another."""
    import torch.distributed as dist

    from repro_torch.core.shufflesoftsort import ShuffleSoftSortConfig
    from repro_torch.launch.paper import paper_round
    group = mesh.get_group(0)
    shards = dist.get_world_size(group)
    if n % shards:
        raise ValueError(f"N = {n} rows do not split over {shards} ranks")
    cfg = ShuffleSoftSortConfig(inner_steps=2, chunk=chunk)
    meta = torch.device("meta")
    x = torch.empty((n // shards, d), dtype=torch.float32, device=meta)
    order = torch.empty((n // shards,), dtype=torch.int32, device=meta)
    key = torch.empty((2,), dtype=torch.int64, device=meta)
    tau = torch.empty((), dtype=torch.float32, device=meta)
    norm = torch.empty((), dtype=torch.float32, device=meta)
    rec = {"arch": "paper-sort-2^20x59", "shape": f"N={n} d={d}",
           "mesh": mesh_name, "kind": "paper"}
    t0 = time.time()
    with CostMode() as mode:
        paper_round(x, order, key, tau, norm, hw=tuple(hw), cfg=cfg,
                    group=group)
    rec["lower_s"] = round(time.time() - t0, 1)   # the one run on meta
    rec["compile_s"] = 0.0                        # nothing is compiled
    rec["cost_analysis"] = {"flops": float(mode.flops),
                            "bytes_accessed": float(mode.bytes_accessed)}
    rec["collectives"] = collective_stats(mode.collectives)
    rec["torch"] = torch.__version__
    rec["status"] = "ok"
    print(f"  [paper-sort x {mesh_name}] run={rec['lower_s']}s "
          f"flops={rec['cost_analysis']['flops']:.3e} "
          f"coll={rec['collectives']['total_bytes']:.3e}B", flush=True)
    return rec


def init_fake_group(world_size: int):
    """Initialise torch's in-process ``fake`` process group of
    ``world_size`` ranks, this process rank 0 (no network, no peers)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def destroy_group():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def run(archs, shapes, mesh_name: str, paper: bool = False) -> list[dict]:
    """Records of the paper cell (with ``paper``) and of every (arch x
    shape) cell on the named mesh, under a fake group made for it and
    destroyed after; a cell that raises is an ``error`` record."""
    from repro_torch.launch.mesh import make_production_mesh
    init_fake_group(512 if mesh_name == "multi" else 256)
    try:
        mesh = make_production_mesh(multi_pod=(mesh_name == "multi"))
        print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"({mesh.size()} ranks, fake group)", flush=True)
        records = []
        if paper:
            try:
                records.append(run_paper_cell(mesh, mesh_name))
            except Exception as e:                       # noqa: BLE001
                records.append({"arch": "paper-sort-2^20x59",
                                "mesh": mesh_name, "kind": "paper",
                                "status": "error", "error": repr(e)})
                print(f"  [paper-sort x {mesh_name}] ERROR: {e!r}",
                      flush=True)
        for arch in archs:
            for shape in shapes:
                try:
                    records.append(run_cell(arch, shape, mesh, mesh_name))
                except Exception as e:                   # noqa: BLE001
                    records.append({"arch": arch, "shape": shape,
                                    "mesh": mesh_name, "status": "error",
                                    "error": repr(e)})
                    print(f"  [{arch} x {shape}] ERROR: {e!r}", flush=True)
        return records
    finally:
        destroy_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs())
    ap.add_argument("--shape", choices=[c.name for c in SHAPE_CELLS])
    ap.add_argument("--mesh", choices=("single", "multi"), default="single")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--paper", action="store_true",
                    help="run the paper's own sorting workload")
    ap.add_argument("--out", default=None, help="write JSON records here")
    args = ap.parse_args(argv)

    archs, shapes = [], []
    if args.all:
        archs, shapes = list_archs(), [c.name for c in SHAPE_CELLS]
    elif args.arch:
        archs = [args.arch]
        shapes = [args.shape] if args.shape else [c.name
                                                  for c in SHAPE_CELLS]
    elif not args.paper:
        ap.error("give --arch, --all or --paper")
    records = run(archs, shapes, args.mesh, paper=args.paper)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(records, f, indent=1)
        print(f"wrote {len(records)} records to {args.out}")
    return 1 if any(r.get("status") == "error" for r in records) else 0


if __name__ == "__main__":
    sys.exit(main())

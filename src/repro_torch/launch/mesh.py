"""Device meshes, the port's counterpart of ``repro.launch.mesh``.

Two workload families share this module.

**LM training and serving** (``make_production_mesh``): a
``torch.distributed`` ``DeviceMesh`` of the reference's shapes and axis
names,

    single-pod: (16, 16)      axes ("data", "model")        256 ranks
    multi-pod : (2, 16, 16)   axes ("pod", "data", "model") 512 ranks

The batch shards over ("pod", "data"); parameters and optimizer moments
FSDP over "data"; tensor and expert parallelism over "model", the
innermost axis, so that its collectives stay on the fastest links (on
H100s, NVLink inside a node of 8: a "model" axis of 16 spans two nodes).
The factory takes any shape for elastic restarts.  The mesh needs a
process group of at least as many ranks: the dry-run
(``repro_torch.launch.dryrun``) makes one process stand for rank 0 of 256
or 512 with torch's in-process ``fake`` group; on a card the group is
``nccl`` (a (1, 1) mesh on one card, world size 1).

**Permutation workloads** (``make_sort_mesh``): ShuffleSoftSort instances are embarrassingly parallel (N parameters each,
no cross-instance communication until the best-restart argmin), so the
mesh is one-dimensional: the engines flatten the B problems x S restarts
grid and split it over the mesh's "data" axis, padding the tail slot with
copies of instance 0 (``repro_torch.core.shufflesoftsort``).  Per seed the
results are bitwise those of ``mesh=None`` on any mesh size, so the mesh
is a throughput knob.

A ``SortMesh`` is an ordered tuple of slots, each a stable integer ``id``
and a ``torch.device``.  ``make_sort_mesh(devices=[...])`` may name one
device more than once, ``"cpu"`` included: each entry is one slot.  That
is how the tests get 8 slots on the CPU and how one card runs a mesh of
several slots.  ``mesh.without(ids)``, the mesh over the survivors of an
eviction, keeps their ids, so a health monitor's verdicts keep naming the
same slots.

"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.models.layers import AxisRules, P, axis_names, placements


def make_production_mesh(*, multi_pod: bool = False,
                         shape: tuple[int, ...] | None = None):
    """The LM mesh: ``shape`` (default (16, 16), or (2, 16, 16) with
    ``multi_pod``) over ranks 0.. of the initialised process group, axes
    ("data", "model") or ("pod", "data", "model"); a "cuda" mesh on an
    ``nccl`` group, else a "cpu" one (the ``fake`` and ``gloo`` groups).
    Raises ``RuntimeError`` when the group has fewer ranks than
    the shape needs; it never shrinks the mesh."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    shape = tuple(int(s) for s in shape)
    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    ndev = 1
    for s in shape:
        ndev *= s
    avail = dist.get_world_size() if dist.is_initialized() else 0
    if avail < ndev:
        raise RuntimeError(
            f"mesh {shape} needs {ndev} ranks, have {avail}; the dry-run "
            "entry point initialises torch's in-process 'fake' process "
            "group (torch.testing._internal.distributed.fake_pg.FakeStore, "
            f"world_size >= {ndev}) before building the mesh")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(ndev).reshape(shape),
                      mesh_dim_names=axes)


def axis_rules_for(mesh) -> AxisRules:
    names = axis_names(mesh)
    dp = ("pod", "data") if "pod" in names else ("data",)
    return AxisRules(fsdp="data", tp="model", dp=dp)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A tensor laid out as ``spec`` on ``mesh`` (the counterpart of
    ``jax.sharding.NamedSharding``); a leaf of the port's trees."""
    mesh: object
    spec: P

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


@dataclasses.dataclass(frozen=True)
class MeshSlot:
    """One slot of a ``SortMesh``: its stable id and its device."""
    id: int
    device: torch.device


class SortMesh:
    """A 1-D ("data",) mesh: an ordered tuple of ``MeshSlot``."""

    axis_names = ("data",)

    def __init__(self, slots: Sequence[MeshSlot]):
        self.slots = tuple(slots)
        ids = self.ids
        if not self.slots or len(set(ids)) != len(ids):
            raise ValueError(f"a sort mesh needs one or more slots with "
                             f"distinct ids, got ids {list(ids)}")

    @property
    def shape(self) -> dict[str, int]:
        return {"data": len(self.slots)}

    @property
    def ids(self) -> tuple[int, ...]:
        return tuple(s.id for s in self.slots)

    def __len__(self) -> int:
        return len(self.slots)

    def without(self, ids) -> "SortMesh | None":
        """The mesh over the slots whose ids are not in ``ids``, in order
        and keeping their ids (the survivors of an eviction); None when no
        slot is left."""
        gone = {int(i) for i in ids}
        survivors = [s for s in self.slots if s.id not in gone]
        return SortMesh(survivors) if survivors else None

    def __repr__(self) -> str:
        return "SortMesh([" + ", ".join(
            f"{s.id}: {s.device}" for s in self.slots) + "])"


def _device(entry) -> torch.device:
    dev = torch.device(entry)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"a mesh slot runs on 'cpu' or 'cuda', got {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_sort_mesh(n_devices: int | None = None, *,
                   devices=None) -> SortMesh:
    """1-D ("data",) mesh for sharded permutation workloads.

    ``devices=None`` takes the first ``n_devices`` visible CUDA cards (all
    of them when ``n_devices`` is None), slot ids 0, 1, ...  An explicit
    ``devices=`` list may name one device more than once: each entry is a
    slot, its id its position in the list, except that a ``MeshSlot``
    entry keeps its own id (the survivors of an eviction).  Raises
    ``RuntimeError`` for ``n_devices <= 0`` or more devices than there
    are, as the reference does.
    """
    if devices is None:
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    else:
        avail = list(devices)
    n = len(avail) if n_devices is None else int(n_devices)
    if n <= 0:
        raise RuntimeError(
            f"sort mesh wants {n} devices; n_devices must be >= 1 (None = "
            f"every visible device; with no CUDA device visible, pass "
            f"devices=['cpu'] * k)")
    if n > len(avail):
        raise RuntimeError(
            f"sort mesh wants {n} devices, have {len(avail)}; pass an "
            f"explicit devices= list (one device may fill several slots)")
    return SortMesh([
        MeshSlot(e.id, _device(e.device)) if isinstance(e, MeshSlot)
        else MeshSlot(i, _device(e)) for i, e in enumerate(avail[:n])])

"""Fault-tolerant checkpointing, the port's counterpart of
``repro.runtime.checkpoint``, with the same on-disk format:

  * **Atomic**: a save writes ``<dir>/tmp-<step>`` and renames it to
    ``<dir>/step-%09d``; a crash mid-save never corrupts the newest
    published checkpoint, and stale ``tmp-*`` directories are swept when a
    manager opens the directory.
  * **Layout**: ``arrays.npz`` holds the leaves as ``leaf_%05d`` in
    flatten order; ``manifest.json`` holds ``step``, ``time``,
    ``mesh_shape``, ``mesh_axes``, ``extra``, ``treedef`` and
    ``num_leaves``.
  * **Keep-k GC**, resume-latest, and an **async save** (the host snapshot
    is taken at once, the write overlaps the caller's work).

The flatten is ``repro_torch.tree``'s: dict keys sorted, lists, tuples
and named tuples in order, ``None`` an empty subtree, every other value a
leaf, which is the order ``jax.tree.flatten`` gives the same containers.
So each package reads the other's checkpoints of a flat dict.  Leaves are
stored in logical layout: a torch tensor is copied to host numpy, a
bfloat16 one as its bit patterns in a ``|V2`` entry, as ``np.savez``
stores the reference's bfloat16 arrays (ROADMAP.md Queue C13), and
restored bit for bit into a bfloat16 leaf of ``like``.  ``mesh_shape``
and ``mesh_axes`` record the ``SortMesh`` a state was saved under
(``[n]`` and ``["data"]``; null without one), for audit only: the state
is layout-free, so it restores onto any mesh, or none.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import LEAF, flatten, unflatten

PyTree = Any


def _render(node) -> str:
    """The structure as ``jax``'s treedef string renders it."""
    if node is LEAF:
        return "*"
    kind, keys, subs = node
    if kind is dict:
        return "{" + ", ".join(f"{k!r}: {_render(s)}"
                               for k, s in zip(keys, subs)) + "}"
    if kind is None:
        return "None"
    inner = ", ".join(_render(s) for s in subs)
    if hasattr(kind, "_fields"):
        return f"CustomNode(namedtuple[{kind.__name__}], [{inner}])"
    if kind is tuple:
        return "(" + inner + ("," if len(subs) == 1 else "") + ")"
    return "[" + inner + "]"


def _host(leaf) -> np.ndarray:
    """A host copy of a tensor (a DTensor gathered whole; an array as it
    is).  A bfloat16 tensor comes back as its bit patterns in a 2-byte void array, the ``|V2``
    entry ``np.savez`` writes of the reference's bfloat16 arrays."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if type(leaf) is not torch.Tensor and hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()            # a DTensor: the whole
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).cpu().numpy().view("V2")
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype on its device; a
    ``|V2`` entry is read as bfloat16 bit patterns."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        if like.dtype != torch.bfloat16:
            raise ValueError(f"a bfloat16 (|V2) leaf restores only into a "
                             f"bfloat16 tensor, not {like.dtype}")
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(like.device)
    return torch.as_tensor(a, device=like.device).to(like.dtype)


def _savez(path: str, arrays: dict) -> None:
    """``np.savez(path, **arrays)``, byte for byte, except that a bfloat16
    leaf (``_host``'s 2-byte void array) gets the header descr ``'<V2'``
    that numpy writes for the reference's ``ml_dtypes`` bfloat16 arrays,
    where a plain void array would get ``'|V2'``."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            a = np.asanyarray(a)
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                    a = np.ascontiguousarray(a)
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False,
                              "shape": a.shape})
                    fid.write(a.tobytes())
                else:
                    np.lib.format.write_array(fid, a, allow_pickle=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._save_thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)
        # A crash mid-save strands its tmp-<step> staging directory (the
        # publish is the rename), so sweep them at open.  One manager owns
        # a directory at a time.
        for name in os.listdir(directory):
            if name.startswith("tmp-"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

    # ----------------------------------------------------------- saving

    def save(self, step: int, state: PyTree, *, mesh=None,
             extra: dict | None = None, block: bool = False):
        """Snapshot now; write (a)synchronously."""
        self.wait()                                # one write in flight
        flat, structure = flatten(state)
        flat = [_host(a) for a in flat]            # the snapshot
        meta = {
            "step": int(step),
            "time": time.time(),
            "mesh_shape": (None if mesh is None
                           else list(dict(mesh.shape).values())),
            "mesh_axes": None if mesh is None else list(mesh.axis_names),
            "extra": extra or {},
        }

        def _write():
            tmp = os.path.join(self.directory, f"tmp-{step}")
            final = os.path.join(self.directory, f"step-{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            _savez(os.path.join(tmp, "arrays.npz"),
                   {f"leaf_{i:05d}": a for i, a in enumerate(flat)})
            meta["treedef"] = f"PyTreeDef({_render(structure)})"
            meta["num_leaves"] = len(flat)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)                 # atomic publish
            self._gc()

        if self.async_save and not block:
            self._save_thread = threading.Thread(target=_write, daemon=True)
            self._save_thread.start()
        else:
            _write()

    def wait(self):
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step-{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- loading

    def all_steps(self) -> list[int]:
        return sorted(int(name.split("-")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step-"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: PyTree, step: int | None = None, *,
                shardings: PyTree = None) -> tuple[PyTree, int]:
        """Load into the structure of ``like``.  A leaf of ``like`` that is
        a torch tensor comes back as a tensor of its dtype on its device,
        one with a numpy dtype as an array of that dtype, any other (a
        plain int) as the stored array, uncast.  ``shardings`` (a tree of
        ``repro_torch.launch.mesh.NamedSharding`` of ``like``'s structure,
        or one for every leaf) reshards elastically: each tensor leaf comes
        back as a DTensor laid out on the new mesh
        (``distribute_tensor``), whatever mesh it was saved under; a
        DTensor leaf of ``like`` gives its local dtype and the device of
        the new mesh."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        final = os.path.join(self.directory, f"step-{step:09d}")
        flat_like, structure = flatten(like)
        saved = self.manifest(step).get("num_leaves")
        if saved is not None and saved != len(flat_like):
            raise ValueError(
                f"checkpoint step {step} in {self.directory} holds "
                f"{saved} leaves but `like` has {len(flat_like)} — the "
                f"state layout changed since this checkpoint was "
                f"written; restore with the layout it was saved under")
        with np.load(os.path.join(final, "arrays.npz")) as data:
            flat = [data[f"leaf_{i:05d}"] for i in range(len(flat_like))]
        out = []
        for a, lk in zip(flat, flat_like):
            if isinstance(lk, torch.Tensor):
                a = _tensor(a, lk)
            elif hasattr(lk, "dtype"):
                a = np.asarray(a, dtype=lk.dtype)
            out.append(a)
        state = unflatten(structure, out)
        if shardings is not None:
            from repro_torch.launch.steps import place_tree
            state = place_tree(state, shardings)
        return state, step

    def manifest(self, step: int | None = None) -> dict:
        step = step if step is not None else self.latest_step()
        final = os.path.join(self.directory, f"step-{step:09d}")
        with open(os.path.join(final, "manifest.json")) as f:
            return json.load(f)

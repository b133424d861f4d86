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

The flatten is the port's own: dict keys sorted, lists and tuples in
order, ``None`` an empty subtree, every other value a leaf, which is the
order ``jax.tree.flatten`` gives the same containers.  So each package
reads the other's checkpoints of a flat dict.  Leaves are stored in
logical layout: a torch tensor is copied to host numpy.  ``mesh_shape``
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
from typing import Any, Optional

import numpy as np
import torch

PyTree = Any


class _Leaf:
    pass


_LEAF = _Leaf()


def _flatten(tree: PyTree):
    """(leaves, structure): leaves in ``jax.tree.flatten`` order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        leaves, subs = [], []
        for k in keys:
            lv, sub = _flatten(tree[k])
            leaves += lv
            subs.append(sub)
        return leaves, ("dict", keys, subs)
    if isinstance(tree, (list, tuple)):
        leaves, subs = [], []
        for v in tree:
            lv, sub = _flatten(v)
            leaves += lv
            subs.append(sub)
        return leaves, (type(tree).__name__, None, subs)
    if tree is None:
        return [], ("none", None, [])
    return [tree], _LEAF


def _unflatten(structure, leaves):
    it = iter(leaves)

    def build(node):
        if node is _LEAF:
            return next(it)
        kind, keys, subs = node
        if kind == "dict":
            return {k: build(sub) for k, sub in zip(keys, subs)}
        if kind == "none":
            return None
        vals = [build(sub) for sub in subs]
        return tuple(vals) if kind == "tuple" else vals

    return build(structure)


def _render(node) -> str:
    """The structure as ``jax``'s treedef string renders it."""
    if node is _LEAF:
        return "*"
    kind, keys, subs = node
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_render(s)}"
                               for k, s in zip(keys, subs)) + "}"
    if kind == "none":
        return "None"
    inner = ", ".join(_render(s) for s in subs)
    if kind == "tuple":
        return "(" + inner + ("," if len(subs) == 1 else "") + ")"
    return "[" + inner + "]"


def _host(leaf) -> np.ndarray:
    """A host copy of a tensor (or an array, as it is)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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
        flat, structure = _flatten(state)
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
            np.savez(os.path.join(tmp, "arrays.npz"),
                     **{f"leaf_{i:05d}": a for i, a in enumerate(flat)})
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

    def restore(self, like: PyTree, step: int | None = None
                ) -> tuple[PyTree, int]:
        """Load into the structure of ``like``.  A leaf of ``like`` that is
        a torch tensor comes back as a tensor of its dtype on its device,
        one with a numpy dtype as an array of that dtype, any other (a
        plain int) as the stored array, uncast."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        final = os.path.join(self.directory, f"step-{step:09d}")
        flat_like, structure = _flatten(like)
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
                a = torch.as_tensor(a, device=lk.device).to(lk.dtype)
            elif hasattr(lk, "dtype"):
                a = np.asarray(a, dtype=lk.dtype)
            out.append(a)
        return _unflatten(structure, out), step

    def manifest(self, step: int | None = None) -> dict:
        step = step if step is not None else self.latest_step()
        final = os.path.join(self.directory, f"step-{step:09d}")
        with open(os.path.join(final, "manifest.json")) as f:
            return json.load(f)

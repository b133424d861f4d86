"""Rung-boundary checkpointing for the annealing engines, the port's
counterpart of ``repro.runtime.anneal_checkpoint``.

``AnnealCheckpointer`` is the persistence layer behind the
``checkpoint_dir=`` / ``resume=`` knobs of ``shuffle_soft_sort``,
``shuffle_soft_sort_batched`` and ``restart_tournament``: at each rung
boundary the engine hands it a flat ``{name: ndarray}`` snapshot of the
whole per-instance carry (orders, the shuffle source's state, the loss
traces, the tournament's alive sets, the adaptive controller's state) and
a small JSON ``meta`` record (engine, position, structural fingerprint).
It writes them through ``CheckpointManager``: atomic publish, manifest,
keep-k GC and resume-latest.

The carry between rounds is the orders and the streams only: every round
starts its keys again at ``arange(N)`` with fresh Adam moments, so a
snapshot at a rung boundary is the whole state.  The snapshots are host
numpy in logical (instance-major) layout.

Structural fingerprint: the ``meta`` fields listed in ``expect`` at
restore must match exactly (engine, rounds, N, instances, schedule, grid,
and in the port the shuffle source's kind): a checkpoint of another
problem, or one whose generator states were taken on another device
type, is a ``ValueError``, never a quiet mix.  ``compute_dtype``,
``tau_end``, ``band`` and ``use_kernel`` are deliberately not in it: the
divergence ladder (``repro_torch.runtime.fault_tolerance
.DivergencePolicy``) resumes the same run under an adjusted config.  The
full config repr is stored for audit.
"""
from __future__ import annotations

import json
from typing import Any, Optional

import numpy as np

from repro_torch.runtime.checkpoint import CheckpointManager


def _jsonable(v: Any) -> Any:
    """A meta value as a JSON round trip returns it (tuples become lists,
    numpy scalars Python scalars), so fingerprints compare stably."""
    return json.loads(json.dumps(v, default=lambda o: (
        o.item() if isinstance(o, np.generic) else list(o))))


class AnnealCheckpointer:
    """Flat-dict checkpoint store for annealing engine state.

    Synchronous by default: a rung's state is a few N-sized arrays, and a
    synchronous publish means a crash at any point leaves the previous
    rung's checkpoint or the new one, never a half-written newest.
    """

    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.mgr = CheckpointManager(directory, keep=keep,
                                     async_save=async_save)

    def save(self, round_idx: int, state: dict[str, np.ndarray],
             meta: dict, mesh=None) -> None:
        """Publish ``state`` (a flat ``{str: array-like}`` dict) as the
        checkpoint of rung/round ``round_idx``; ``meta`` is JSON-able;
        ``mesh`` (the run's ``SortMesh``, or None) goes into the manifest
        for audit."""
        assert all(isinstance(k, str) for k in state), state.keys()
        self.mgr.save(int(round_idx),
                      {k: np.asarray(v) for k, v in state.items()},
                      mesh=mesh,
                      extra={"anneal": meta,
                             "state_keys": sorted(state)})

    def wait(self) -> None:
        self.mgr.wait()

    def latest_round(self) -> Optional[int]:
        return self.mgr.latest_step()

    def restore_latest(self, expect: dict | None = None):
        """The newest checkpoint as ``(state, round_idx, meta)``, or None
        for a directory with none (a fresh ``resume=True`` run starts from
        the beginning, so a supervisor passes ``resume=True`` always).

        ``expect`` maps meta field -> required value; a mismatch raises
        ``ValueError``.
        """
        self.mgr.wait()
        step = self.mgr.latest_step()
        if step is None:
            return None
        man = self.mgr.manifest(step)
        meta = man["extra"]["anneal"]
        if expect:
            for k, v in expect.items():
                if meta.get(k) != _jsonable(v):
                    raise ValueError(
                        f"checkpoint at {self.mgr.directory} (round "
                        f"{step}) does not match this run: meta[{k!r}] "
                        f"= {meta.get(k)!r}, expected {_jsonable(v)!r}")
        keys = man["extra"]["state_keys"]
        # Plain-int like-leaves carry no dtype, so the stored arrays come
        # back uncast: dtypes round-trip exactly, which a bitwise resume
        # needs (a uint8 generator state cast through float would be
        # corruption, not restoration).
        state, _ = self.mgr.restore({k: 0 for k in keys}, step)
        return state, int(step), meta

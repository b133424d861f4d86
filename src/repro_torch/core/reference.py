"""Carry a run of the reference JAX package across to the port.

This system has no weights: the keys are re-initialized every round, so
a run's whole state at a round boundary is its orders, its loss trace and
its shuffle streams, plus the config.  These functions read them in the
plain forms the reference hands out — ``dataclasses.asdict`` of its
config, and the checkpoint directory its ``AnnealCheckpointer`` writes,
read here through the port's own reader (``read_reference_checkpoint``;
the two packages share the on-disk format) — so the port can continue the
run from that boundary.  The port cannot draw JAX's shuffles (ROADMAP.md
Queue A3b): the remaining rounds' shuffles come from a replay source
(``repro_torch.core.prng``) filled from the checkpoint's ``keys``.

* ``state_from_reference``: the ``{"order", "losses"}`` (sequential) or
  ``{"orders", "losses"}`` (batched) carry as a ``state=`` argument.
* ``controller_state_from_reference``: the ``ctrl_*`` arrays of an
  adaptive checkpoint for the port's ``AdaptiveController.load_state_dict``
  (the same fields in the same dtypes: both go on to the same decisions
  on the same observations).
* ``carry_reference_checkpoint``: a reference checkpoint rewritten as a
  port checkpoint of the same engine and round, its ``keys`` replaced by
  a given source's state; a port run with that source and ``resume=True``
  continues it (any engine, the adaptive one included).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.shufflesoftsort import ShuffleSoftSortConfig
from repro_torch.runtime.anneal_checkpoint import AnnealCheckpointer


def config_from_reference(fields: dict) -> ShuffleSoftSortConfig:
    """The port's config from ``dataclasses.asdict`` of the reference's."""
    known = {f.name for f in dataclasses.fields(ShuffleSoftSortConfig)}
    unknown = sorted(set(fields) - known)
    if unknown:
        raise ValueError(f"unknown config fields: {unknown}")
    return ShuffleSoftSortConfig(**fields)


def state_from_reference(state: dict[str, np.ndarray], device
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(orders (BS, N) int64, losses (BS, R0) float32)`` on ``device``
    from a reference carry: ``order`` (N,) with ``losses`` (R0,), or
    ``orders`` (BS, N) with ``losses`` (R0, BS).  Pass the result as
    ``state=`` to ``shuffle_soft_sort``/``shuffle_soft_sort_batched``."""
    orders = np.asarray(state["orders"] if "orders" in state
                        else state["order"])
    losses = np.asarray(state["losses"], np.float32)
    if orders.ndim == 1:
        orders, losses = orders[None], losses.reshape(1, -1)
    else:
        losses = losses.reshape(-1, orders.shape[0]).T
    return (torch.as_tensor(orders.astype(np.int64), device=device),
            torch.as_tensor(np.ascontiguousarray(losses), device=device))


def read_reference_checkpoint(directory, expect: dict | None = None):
    """The newest checkpoint of a reference ``AnnealCheckpointer``
    directory, read by the port's reader: ``(state, round, meta)`` with
    ``state`` a flat dict of numpy arrays in their stored dtypes, or None
    for a directory with no checkpoint.  ``expect`` as in
    ``AnnealCheckpointer.restore_latest``."""
    return AnnealCheckpointer(str(directory)).restore_latest(expect)


def controller_state_from_reference(state: dict[str, np.ndarray]) -> dict:
    """The ``ctrl_*`` arrays of a reference adaptive checkpoint as a
    ``state_dict`` for ``AdaptiveController.load_state_dict``."""
    return {k[len("ctrl_"):]: np.asarray(v) for k, v in state.items()
            if k.startswith("ctrl_")}


def carry_reference_checkpoint(reference_dir, port_dir, source) -> int:
    """Write the newest checkpoint of the reference run in
    ``reference_dir`` into ``port_dir`` as the port's checkpoint of the
    same engine at the same round, its PRNG ``keys`` (``key``,
    sequential) replaced by ``source``'s state.  ``source`` must draw the
    rounds the reference would have drawn after that boundary: typically
    a ``ReplayShuffleSource`` of each instance's remaining shuffles from
    its own key chain, at ``pos`` 0.  Then the port's engine with
    ``source=source, checkpoint_dir=port_dir, resume=True`` and the
    reference's config continues the run.  Returns the round (or rung
    step) of the checkpoint."""
    got = read_reference_checkpoint(reference_dir)
    if got is None:
        raise FileNotFoundError(f"no checkpoint in {reference_dir}")
    state, step, meta = got
    state = {k: v for k, v in state.items() if k not in ("keys", "key")}
    state["source"] = source.state_dict()
    AnnealCheckpointer(str(port_dir)).save(
        step, state, meta=dict(meta, source=source.kind))
    return step

"""Carry a run of the reference JAX package across to the port.

This system has no weights: the keys are re-initialized every round, so
a run's whole state at a round boundary is its orders, its loss trace and
its shuffle streams, plus the config.  These functions read them in the
plain forms the reference hands out — ``dataclasses.asdict`` of its
config, and the checkpoint directory its ``AnnealCheckpointer`` writes,
read here through the port's own reader (``read_reference_checkpoint``;
the two packages share the on-disk format) — so the port can continue the
run from that boundary.  The remaining rounds' shuffles come from the
checkpoint's own ``keys`` (``key``, sequential), continued by a
``ThreefryShuffleSource`` bitwise along the reference's key chains, or
from a source the caller gives (a replay of them, say).

* ``state_from_reference``: the ``{"order", "losses"}`` (sequential) or
  ``{"orders", "losses"}`` (batched) carry as a ``state=`` argument.
* ``controller_state_from_reference``: the ``ctrl_*`` arrays of an
  adaptive checkpoint for the port's ``AdaptiveController.load_state_dict``
  (the same fields in the same dtypes: both go on to the same decisions
  on the same observations).
* ``carry_reference_checkpoint``: a reference checkpoint rewritten as a
  port checkpoint of the same engine and round, its ``keys`` kept as a
  ``ThreefryShuffleSource``'s state (or replaced by a given source's); a
  port run with ``key=`` / ``keys=`` (or that source) and ``resume=True``
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


def carry_reference_checkpoint(reference_dir, port_dir, source=None) -> int:
    """Write the newest checkpoint of the reference run in
    ``reference_dir`` into ``port_dir`` as the port's checkpoint of the
    same engine at the same round.  Returns the round (or rung step) of
    the checkpoint.

    With no ``source``, the reference's PRNG ``keys`` (``key``, sequential)
    become the state of a ``ThreefryShuffleSource`` (kind ``"threefry"``):
    the port's engine with ``key=`` or ``keys=`` (any of the right shape:
    the checkpoint's keys replace them), ``checkpoint_dir=port_dir``,
    ``resume=True`` and the reference's config continues the run on its
    own key chains.  The fixed tournament stores the keys of its live
    restarts only; they go to their instances' rows (``alive``), and a
    culled row, which never draws again, holds zeros.

    With a ``source``, the keys are replaced by its state: it must draw
    the rounds the reference would have drawn after that boundary, e.g.
    a ``ReplayShuffleSource`` of each instance's remaining shuffles from
    its own key chain, at ``pos`` 0; the port's engine then runs with
    ``source=source``."""
    got = read_reference_checkpoint(reference_dir)
    if got is None:
        raise FileNotFoundError(f"no checkpoint in {reference_dir}")
    state, step, meta = got
    keys = state.get("keys", state.get("key"))
    state = {k: v for k, v in state.items() if k not in ("keys", "key")}
    if source is not None:
        state["source"], kind = source.state_dict(), source.kind
    else:
        keys = np.asarray(keys).reshape(-1, 2).astype(np.uint32)
        bs = int(meta.get("instances", keys.shape[0]))
        if keys.shape[0] != bs:            # the tournament's live rows
            alive = np.asarray(state["alive"])
            s = bs // alive.shape[0]
            rows = (np.arange(alive.shape[0])[:, None] * s + alive)
            full = np.zeros((bs, 2), np.uint32)
            full[rows.reshape(-1)] = keys
            keys = full
        state["source"], kind = keys, "threefry"
    AnnealCheckpointer(str(port_dir)).save(
        step, state, meta=dict(meta, source=kind))
    return step

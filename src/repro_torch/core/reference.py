"""Carry a run of the reference JAX package across to the port.

This system has no weights: the keys are re-initialized every round, so
a run's whole state at a round boundary is its orders and its loss trace
plus the config.  These two functions read them in the plain forms the
reference hands out — ``dataclasses.asdict`` of its config, and the
``{"order", "losses"}`` (sequential) or ``{"orders", "losses"}``
(batched) arrays its anneal checkpointer stores — so the port can
continue the run from that boundary.  The shuffles of the remaining
rounds come from a replay source (``repro_torch.core.prng``).

The adaptive schedule's controller state needs nothing here: the port's
``AdaptiveController`` (``repro_torch.core.annealing``) keeps the same
fields in the same dtypes as the reference's, so a reference
controller's ``state_dict()`` (or the ``ctrl_*`` arrays its anneal
checkpointer stores) loads into it with ``load_state_dict`` unchanged,
and both go on to the same decisions on the same observations.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.shufflesoftsort import ShuffleSoftSortConfig


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

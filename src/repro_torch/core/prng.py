"""Where each round's shuffles come from.

The anneal re-shuffles every instance once per outer round (the
``jax.random.permutation`` calls of ``repro.core.shufflesoftsort``).
Here a *shuffle source* yields one round's ``(BS, N)`` int64 shuffles at a
time:

* ``TorchShuffleSource`` — one ``torch.Generator`` per instance on the
  run's device, seeded from the instance's seed, so instance ``i`` of a
  batched run and a sequential run with the same seed draw identical
  shuffles.  The default.
* ``ReplayShuffleSource`` — replays a given ``(R, BS, N)`` array; row
  ``shuffles[t, i]`` is instance ``i``'s ``t``-th shuffle.  Parity tests
  fill it from each instance's own JAX key chain.

Each instance owns its stream and its position in it.  ``next_round(rows)``
draws for the instances ``rows`` only, so a run that leaves some
instances out of a round (the adaptive schedule's early stops and
groups) advances no other instance's stream: instance ``i``'s ``t``-th
round always sees its ``t``-th shuffle, as in the reference, where each
instance splits its own key once per round it runs.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch


class ShuffleSource(Protocol):
    def next_round(self, rows=None) -> torch.Tensor:
        """The next round's shuffles of the instances ``rows`` (a sequence
        of instance indices; None: every instance), (len(rows), N) int64 on
        the run's device.  Only those instances' streams advance."""
        ...


def _rows(rows, count: int) -> np.ndarray:
    return (np.arange(count) if rows is None
            else np.asarray(rows, np.int64).reshape(-1))


def instance_seeds(seed: int, count: int) -> list[int]:
    """``count`` well-spread instance seeds derived from one run seed."""
    state = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [int(s) & (2**63 - 1) for s in state]


class TorchShuffleSource:
    """Per-instance ``torch.Generator`` streams of ``randperm(n)``."""

    def __init__(self, seeds: Sequence[int], n: int, device):
        self.n = int(n)
        self.device = torch.device(device)
        self.generators = [torch.Generator(device=self.device).manual_seed(
            int(s)) for s in seeds]

    def next_round(self, rows=None) -> torch.Tensor:
        return torch.stack([
            torch.randperm(self.n, generator=self.generators[i],
                           device=self.device)
            for i in _rows(rows, len(self.generators))])


class ReplayShuffleSource:
    """Replays ``shuffles[t, i]`` as instance ``i``'s ``t``-th shuffle;
    ``shuffles`` is (R, BS, N), and ``pos`` (BS,) counts the rounds each
    instance has drawn."""

    def __init__(self, shuffles, device):
        self.shuffles = torch.as_tensor(np.asarray(shuffles), dtype=torch.int64,
                                        device=device)
        assert self.shuffles.dim() == 3, self.shuffles.shape
        self.pos = np.zeros(self.shuffles.shape[1], np.int64)

    def next_round(self, rows=None) -> torch.Tensor:
        rows = _rows(rows, self.pos.size)
        t = self.pos[rows]
        if rows.size and t.max() >= self.shuffles.shape[0]:
            raise IndexError(f"replay source exhausted after "
                             f"{self.shuffles.shape[0]} rounds")
        dev = self.shuffles.device
        out = self.shuffles[torch.as_tensor(t, device=dev),
                            torch.as_tensor(rows, device=dev)]
        self.pos[rows] += 1
        return out

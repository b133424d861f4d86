"""Where each round's shuffles come from.

The anneal re-shuffles every instance once per outer round (the
``jax.random.permutation`` calls of ``repro.core.shufflesoftsort``).
Here a *shuffle source* yields one round's ``(BS, N)`` int64 shuffles at a
time:

* ``TorchShuffleSource`` — one ``torch.Generator`` per instance on the
  run's device, seeded from the instance's seed, so instance ``i`` of a
  batched run and a sequential run with the same seed draw identical
  shuffles.  The default.
* ``ReplayShuffleSource`` — replays a given ``(R, BS, N)`` array round by
  round; parity tests fill it from the JAX key chain.
"""
from __future__ import annotations

from typing import Protocol, Sequence

import numpy as np
import torch


class ShuffleSource(Protocol):
    def next_round(self) -> torch.Tensor:
        """The next round's shuffles, (BS, N) int64 on the run's device."""
        ...


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

    def next_round(self) -> torch.Tensor:
        return torch.stack([
            torch.randperm(self.n, generator=g, device=self.device)
            for g in self.generators])


class ReplayShuffleSource:
    """Replays ``shuffles[r]`` at round ``r``; ``shuffles`` is (R, BS, N)."""

    def __init__(self, shuffles, device):
        self.shuffles = torch.as_tensor(np.asarray(shuffles), dtype=torch.int64,
                                        device=device)
        assert self.shuffles.dim() == 3, self.shuffles.shape
        self.pos = 0

    def next_round(self) -> torch.Tensor:
        if self.pos >= self.shuffles.shape[0]:
            raise IndexError(f"replay source exhausted after {self.pos} "
                             "rounds")
        out = self.shuffles[self.pos]
        self.pos += 1
        return out

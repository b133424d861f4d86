"""Where each round's shuffles come from.

The anneal re-shuffles every instance once per outer round (the
``jax.random.permutation`` calls of ``repro.core.shufflesoftsort``).
Here a *shuffle source* yields one round's ``(BS, N)`` int64 shuffles at a
time:

* ``TorchShuffleSource`` — one ``torch.Generator`` per instance on the
  run's device, seeded from the instance's seed, so instance ``i`` of a
  batched run and a sequential run with the same seed draw identical
  shuffles.  The default.
* ``ThreefryShuffleSource`` — the reference's own draws: instance ``i``
  holds a ``jax.random`` key and each round runs ``key, sub =
  split(key); permutation(sub, N)`` (``repro_torch.core.threefry``),
  bitwise ``jax.random.permutation`` along the reference's key chain.
  The engines use it when given ``key=`` / ``keys=``.
* ``ReplayShuffleSource`` — replays a given ``(R, BS, N)`` array; row
  ``shuffles[t, i]`` is instance ``i``'s ``t``-th shuffle.

Each instance owns its stream and its position in it.  ``next_round(rows)``
draws for the instances ``rows`` only, so a run that leaves some
instances out of a round (the adaptive schedule's early stops and
groups) advances no other instance's stream: instance ``i``'s ``t``-th
round always sees its ``t``-th shuffle, as in the reference, where each
instance splits its own key once per round it runs.

``take(rows, device)`` copies some streams out at their current states
(onto another device, for a mesh slot) and ``stack_sources`` joins
sources of one kind row-wise: the sort server builds one source per
dispatch from the streams of the requests it coalesces, and commits each
request's rows back when the dispatch is verified; a sharded dispatch
hands each slot its rows' streams and commits them back in instance
order.
"""
from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core import threefry


@runtime_checkable
class ShuffleSource(Protocol):
    kind: str

    def next_round(self, rows=None) -> torch.Tensor:
        """The next round's shuffles of the instances ``rows`` (a sequence
        of instance indices; None: every instance), (len(rows), N) int64 on
        the run's device.  Only those instances' streams advance."""
        ...

    def state_dict(self) -> np.ndarray: ...

    def load_state_dict(self, state) -> None: ...

    def fork(self, state=None) -> "ShuffleSource": ...

    def advanced(self, state, rows, draws: int) -> np.ndarray: ...

    def take(self, rows, device=None) -> "ShuffleSource": ...

    def __len__(self) -> int: ...


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
        self.kind = f"torch:{self.device.type}"
        self.generators = [torch.Generator(device=self.device).manual_seed(
            int(s)) for s in seeds]

    def next_round(self, rows=None) -> torch.Tensor:
        return torch.stack([
            torch.randperm(self.n, generator=self.generators[i],
                           device=self.device)
            for i in _rows(rows, len(self.generators))])

    def state_dict(self) -> np.ndarray:
        """(BS, L) uint8: row i is generator i's ``get_state()``, read on
        the host without a device sync (on the card, a seed and an
        offset)."""
        return np.stack([g.get_state().numpy() for g in self.generators])

    def load_state_dict(self, state) -> None:
        state = np.asarray(state)
        want = self.generators[0].get_state().numel() if self.generators \
            else 0
        if (state.dtype != np.uint8 or state.ndim != 2
                or state.shape[0] != len(self.generators)
                or state.shape[1] != want):
            raise ValueError(
                f"a {self.kind} source of {len(self.generators)} streams "
                f"takes a ({len(self.generators)}, {want}) uint8 state, got "
                f"{state.dtype} {state.shape} (a state taken on another "
                f"device type?)")
        for g, row in zip(self.generators, state):
            g.set_state(torch.from_numpy(np.ascontiguousarray(row)))

    def fork(self, state=None) -> "TorchShuffleSource":
        out = TorchShuffleSource([0] * len(self.generators), self.n,
                                 self.device)
        out.load_state_dict(self.state_dict() if state is None else state)
        return out

    def advanced(self, state, rows, draws: int) -> np.ndarray:
        """The state after ``draws`` more rounds of instances ``rows``,
        replayed on scratch generators."""
        scratch = self.fork(state)
        for _ in range(int(draws)):
            scratch.next_round(rows)
        return scratch.state_dict()

    def take(self, rows, device=None) -> "TorchShuffleSource":
        """A new source of the streams ``rows``, at their current states,
        on ``device`` (None: this source's).  A card generator's state is
        a seed and an offset, so it moves to another card; a CPU state
        does not load into a card generator (``ValueError``)."""
        rows = _rows(rows, len(self.generators))
        out = TorchShuffleSource([0] * rows.size, self.n,
                                 self.device if device is None else device)
        if rows.size:
            out.load_state_dict(self.state_dict()[rows])
        return out

    def __len__(self) -> int:
        return len(self.generators)


class ThreefryShuffleSource:
    """Per-instance ``jax.random`` key chains: the state is the (BS, 2)
    uint32 keys, the reference's ``keys``; a round of instances ``rows``
    splits their keys, keeps the first halves and draws
    ``permutation(second, n)`` for all of them at once: on CUDA the whole
    chain of hashes in one launch (``threefry.shuffle_round``,
    ``repro_torch.kernels.threefry.threefry_round``), then the stable
    sorts.
    ``partitionable`` as in ``repro_torch.core.threefry``; the kind names
    it, so a checkpoint resumes only on the layout that wrote it."""

    def __init__(self, keys, n: int, device, partitionable: bool = True):
        self.n = int(n)
        self.device = torch.device(device)
        self.partitionable = bool(partitionable)
        self.kind = "threefry" if self.partitionable else "threefry-original"
        self.keys = threefry.as_keys(keys, self.device).reshape(-1, 2)

    def next_round(self, rows=None) -> torch.Tensor:
        if rows is None:
            kept, out = threefry.shuffle_round(
                self.keys, self.n, partitionable=self.partitionable)
            self.keys = kept.contiguous()
        else:
            idx = torch.as_tensor(_rows(rows, len(self)), device=self.device)
            kept, out = threefry.shuffle_round(
                self.keys[idx], self.n, partitionable=self.partitionable)
            self.keys = self.keys.index_copy(0, idx, kept)
        return out

    def state_dict(self) -> np.ndarray:
        """(BS, 2) uint32 keys (a copy from the device)."""
        return threefry.key_data(self.keys)

    def load_state_dict(self, state) -> None:
        state = np.asarray(state)
        if (state.shape != (len(self), 2) or state.dtype.kind not in "iu"
                or (state < 0).any() or (state > threefry.MASK).any()):
            raise ValueError(f"a {self.kind} source of {len(self)} streams "
                             f"takes ({len(self)}, 2) uint32 keys, got "
                             f"{state.dtype} {state.shape}")
        self.keys = threefry.as_keys(state, self.device)

    def fork(self, state=None) -> "ThreefryShuffleSource":
        return ThreefryShuffleSource(
            self.state_dict() if state is None else state, self.n,
            self.device, self.partitionable)

    def advanced(self, state, rows, draws: int) -> np.ndarray:
        """The keys after ``draws`` more rounds of instances ``rows``: the
        split chain alone, on the host
        (``repro_torch.runtime.guardrails.expected_key_chain``)."""
        from repro_torch.runtime.guardrails import expected_key_chain
        keys = threefry.key_data(np.asarray(state)).reshape(-1, 2)
        idx = _rows(rows, keys.shape[0])
        keys[idx] = expected_key_chain(keys[idx], draws, self.partitionable)
        return keys

    def take(self, rows, device=None) -> "ThreefryShuffleSource":
        idx = torch.as_tensor(_rows(rows, len(self)), device=self.device)
        return ThreefryShuffleSource(
            self.keys[idx], self.n, self.device if device is None else device,
            self.partitionable)

    def __len__(self) -> int:
        return int(self.keys.shape[0])


class ReplayShuffleSource:
    """Replays ``shuffles[t, i]`` as instance ``i``'s ``t``-th shuffle;
    ``shuffles`` is (R, BS, N), and ``pos`` (BS,) counts the rounds each
    instance has drawn."""

    kind = "replay"

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

    def state_dict(self) -> np.ndarray:
        return self.pos.copy()

    def load_state_dict(self, state) -> None:
        state = np.asarray(state)
        if state.shape != self.pos.shape or state.dtype.kind not in "iu":
            raise ValueError(f"a replay source of {self.pos.size} streams "
                             f"takes ({self.pos.size},) integer positions, "
                             f"got {state.dtype} {state.shape}")
        self.pos = state.astype(np.int64)

    def fork(self, state=None) -> "ReplayShuffleSource":
        out = ReplayShuffleSource.__new__(ReplayShuffleSource)
        out.shuffles = self.shuffles
        out.pos = self.pos.copy()
        if state is not None:
            out.load_state_dict(state)
        return out

    def advanced(self, state, rows, draws: int) -> np.ndarray:
        pos = np.asarray(state, np.int64).copy()
        pos[_rows(rows, pos.size)] += int(draws)
        return pos

    def take(self, rows, device=None) -> "ReplayShuffleSource":
        rows = _rows(rows, self.pos.size)
        out = ReplayShuffleSource.__new__(ReplayShuffleSource)
        out.shuffles = self.shuffles[:, torch.as_tensor(
            rows, device=self.shuffles.device)]
        if device is not None:
            out.shuffles = out.shuffles.to(device)
        out.pos = self.pos[rows].copy()
        return out

    def __len__(self) -> int:
        return int(self.pos.size)


def stack_sources(sources: Sequence[ShuffleSource]) -> ShuffleSource:
    """One source whose rows are the rows of ``sources``, in order, at
    their current states; the sources themselves do not advance.  All of
    one kind (and a replay's of one round count and N)."""
    kinds = {src.kind for src in sources}
    if len(kinds) != 1:
        raise ValueError(f"cannot stack shuffle sources of kinds {kinds}")
    parts = [src.take(None) for src in sources]
    out = parts[0]
    if isinstance(out, TorchShuffleSource):
        out.generators = [g for part in parts for g in part.generators]
    elif isinstance(out, ThreefryShuffleSource):
        out.keys = torch.cat([part.keys.to(out.device) for part in parts])
    else:
        out.shuffles = torch.cat([part.shuffles for part in parts], dim=1)
        out.pos = np.concatenate([part.pos for part in parts])
    return out

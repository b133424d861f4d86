"""Straggler and device-health detection, the port's counterpart of
``repro.runtime.straggler`` (pure Python, the reference's code).

Per-step wall time feeds an EWMA mean/variance; a step slower than
``mean + z * std`` (and at least ``min_ratio`` x mean) is flagged.
Flagged steps never update the baseline, so one straggler cannot poison
the statistics it is judged against.  The consumer is the sort server
(``repro_torch.launch.serve.SortServer``), which halves its batch bucket
cap on a flag, so one slow coalesced batch stops stalling the traffic
behind it.

What the server feeds the monitor is the port's own (ROADMAP.md Queue
C9): a dispatch's seconds over the seconds ``DispatchCost`` expects of
its signature.  The reference feeds seconds per instance-round, which is
fair where a dispatch's time grows with its batch (the CPU) and spreads
~8x with the batch alone where a host-bound card pays about the same at
1 instance as at 8.  ``DispatchCost`` keeps each signature's mean over
its clean dispatches: within one signature the work is fixed, so the
host's fixed cost per dispatch cancels out.

``DeviceHealthMonitor`` is the sibling layer for hard failures: it
classifies dispatch exceptions as transient (anonymous: retry under the
caller's ``RetryPolicy``) or lost (a ``DeviceLost`` naming the device,
past the strike budget: evict it and re-shard over the survivors).  Its
consumer is the server's eviction branch (``SortServer(mesh=...,
device_health=...)``).
"""
from __future__ import annotations

import math
from typing import Callable, Hashable, Optional


class StragglerMonitor:
    def __init__(self, z: float = 4.0, min_ratio: float = 1.5,
                 alpha: float = 0.05, warmup: int = 5,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None):
        self.z = z
        self.min_ratio = min_ratio
        self.alpha = alpha
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.mean = 0.0
        self.var = 0.0
        self.count = 0
        self.flagged: list[tuple[int, float]] = []

    def record(self, step: int, dt: float) -> bool:
        self.count += 1
        if self.count <= self.warmup:
            # prime the EWMA
            self.mean = dt if self.count == 1 else (
                self.mean + (dt - self.mean) / self.count)
            self.var = max(self.var, (dt - self.mean) ** 2)
            return False
        std = math.sqrt(self.var) + 1e-9
        is_straggler = (dt > self.mean + self.z * std
                        and dt > self.min_ratio * self.mean)
        if is_straggler:
            self.flagged.append((step, dt))
            if self.on_straggler is not None:
                self.on_straggler(step, dt, self.mean)
        else:
            # only update stats with healthy steps so one straggler does
            # not poison the baseline
            d = dt - self.mean
            self.mean += self.alpha * d
            self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return is_straggler


class DispatchCost:
    """Expected seconds of a dispatch, learnt from clean dispatches.

    A dispatch's ``signature`` is everything that fixes its work: shape,
    regime, rung length, mesh slots and batch bucket.
    ``observe(signature, dt)`` folds a clean dispatch into that
    signature's mean: a running mean over its first ``1 / alpha``
    dispatches, an EWMA with ``alpha`` after.  ``expected(signature)`` is
    that mean, or None before the signature's first clean dispatch
    (nothing to judge by yet).
    """

    def __init__(self, alpha: float = 0.05):
        self.alpha = alpha
        self.means: dict[Hashable, list] = {}

    def expected(self, signature: Hashable) -> Optional[float]:
        m = self.means.get(signature)
        return None if m is None else m[0]

    def observe(self, signature: Hashable, dt: float) -> None:
        m = self.means.setdefault(signature, [0.0, 0])
        m[1] += 1
        m[0] += (dt - m[0]) / min(m[1], 1.0 / self.alpha)


class DeviceHealthMonitor:
    """Classify per-shard dispatch failures: transient vs lost device.

    ``classify(exc)`` inspects one dispatch failure.  An exception that
    names a device (a ``device_id`` attribute, e.g.
    ``runtime.fault_tolerance.DeviceLost``) counts a strike against it;
    once the device has ``lost_after`` strikes it is declared LOST and
    its id is returned — the caller evicts it from the mesh and
    re-shards at the next rung boundary.  Anything else (anonymous
    failures, devices still under the strike budget) returns ``None``:
    transient, retry under the caller's ``RetryPolicy``.

    ``record_success(device_ids)`` clears strikes for devices that just
    served a clean dispatch, so intermittent flakes never accumulate
    into a false eviction.  ``poll_returns()`` re-probes the evicted
    set against ``probe(device_id) -> bool`` (e.g.
    ``FaultInjector.healthy``) and returns the devices that came back —
    the caller grows the mesh at the next boundary.

    State round-trips through ``state_dict``/``load_state_dict`` so a
    preempted server resumes with the same evicted-device set and
    strike counts (``WarmHandoff``; tests/test_serving.py).
    """

    def __init__(self, lost_after: int = 1,
                 probe: Optional[Callable[[int], bool]] = None):
        if lost_after < 1:
            raise ValueError(f"lost_after must be >= 1, got {lost_after}")
        self.lost_after = int(lost_after)
        self.probe = probe
        self.strikes: dict[int, int] = {}
        self.evicted: list[int] = []          # eviction order

    def classify(self, exc: BaseException) -> Optional[int]:
        dev = getattr(exc, "device_id", None)
        if dev is None:
            return None
        dev = int(dev)
        if dev in self.evicted:
            # already evicted; the dispatch raced the re-shard
            return None
        self.strikes[dev] = self.strikes.get(dev, 0) + 1
        if self.strikes[dev] >= self.lost_after:
            self.evicted.append(dev)
            return dev
        return None

    def record_success(self, device_ids) -> None:
        for d in device_ids:
            self.strikes.pop(int(d), None)

    def poll_returns(self, probe: Optional[Callable[[int], bool]] = None
                     ) -> list[int]:
        probe = self.probe if probe is None else probe
        if probe is None:
            return []
        back = [d for d in self.evicted if probe(d)]
        for d in back:
            self.evicted.remove(d)
            self.strikes.pop(d, None)
        return back

    def state_dict(self) -> dict:
        return {"lost_after": self.lost_after,
                "strikes": {str(k): int(v)
                            for k, v in self.strikes.items()},
                "evicted": [int(d) for d in self.evicted]}

    def load_state_dict(self, state: dict) -> None:
        self.lost_after = int(state.get("lost_after", self.lost_after))
        self.strikes = {int(k): int(v)
                        for k, v in state.get("strikes", {}).items()}
        self.evicted = [int(d) for d in state.get("evicted", [])]

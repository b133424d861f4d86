"""Fault tolerance for the annealing engines: retry policies, the
divergence and integrity repair ladder, the checkpoint/restart
supervisor, and deterministic chaos injection.  The port's counterpart
of ``repro.runtime.fault_tolerance``.

Failures surface as exceptions raised by a dispatch function; tests and
``chip_smoke.py`` inject them deterministically with ``FaultInjector``
(a worker failure at a rung, a corrupted result at a dispatch, a mesh
slot lost from a dispatch on and back at a later one).
``AnnealSupervisor`` restarts a run from its newest rung checkpoint
(``checkpoint_dir=`` / ``resume=`` of the engines), so a supervised run
finishes bitwise the uninterrupted one; a ``DeviceLost`` naming a slot of
the run's ``mesh=`` rebuilds the mesh over the survivors first (the
carry is layout-free, so the resumed run is still bitwise).

``TrainSupervisor`` runs the LM trainer's steps
(``repro_torch.launch.train``) with checkpoints and restarts.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.runtime.checkpoint import _host
from repro_torch.runtime.straggler import StragglerMonitor
from repro_torch.tree import tree_map

log = logging.getLogger("repro_torch.runtime")


class WorkerFailure(RuntimeError):
    """Simulated node failure (tests / chaos injection)."""


class DeviceLost(WorkerFailure):
    """A mesh slot stopped serving mid-dispatch; ``device_id`` names its
    slot id, so a ``DeviceHealthMonitor`` can evict it and the caller
    rebuild the mesh over the survivors."""

    def __init__(self, message: str, *, device_id: int | None = None):
        super().__init__(message)
        self.device_id = device_id


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry budget and exponential backoff for failed dispatches.

    ``max_retries`` is per unit of work (a run's restarts); exhausting it
    turns the transient-failure path into a terminal error at the caller.
    ``backoff(attempt)`` is the delay before the retry after the
    ``attempt``-th consecutive failure (1-based): base * mult^(a-1),
    capped.
    """
    max_retries: int = 2
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_max_s: float = 2.0

    def backoff(self, attempt: int) -> float:
        if attempt < 1:
            raise ValueError(f"attempt is 1-based, got {attempt}")
        return min(self.backoff_base_s * self.backoff_mult ** (attempt - 1),
                   self.backoff_max_s)


@dataclasses.dataclass(frozen=True)
class CorruptionSpec:
    """One injected value corruption at an exact dispatch index.

    ``target`` names the element of the engine's result tuple to corrupt,
    in the layout of the port's ``run_round_segment``: ``orders`` /
    ``losses`` / ``ws`` (the port's segment returns no keys: its streams
    live in the shuffle source); ``index`` is the flat element index.
    Modes, as the reference's:

    * ``"bitflip"`` — XOR one bit: the high exponent bit for floats, the
      low bit for integer orders (a duplicate entry), bit 7 for uint32;
    * ``"signflip"`` — negate the element (flip the top bit for uint32);
    * ``"stale"`` — the whole target replaced by the previous call's
      value (a repeated buffer); zeros when there is none;
    * ``"nan"`` — NaN at the element (float targets only).
    """
    mode: str
    target: str = "losses"
    index: int = 0

    _MODES = ("bitflip", "signflip", "stale", "nan")
    _TARGETS = {"orders": 0, "losses": 1, "ws": 2}

    def __post_init__(self):
        if self.mode not in self._MODES:
            raise ValueError(f"mode must be one of {self._MODES}, "
                             f"got {self.mode!r}")
        if self.target not in self._TARGETS:
            raise ValueError(
                f"target must be one of {sorted(self._TARGETS)}, "
                f"got {self.target!r}")
        if not isinstance(self.index, int):
            # A None/str index would raise mid-dispatch instead, where a
            # retry path swallows it and the corruption never fires.
            raise ValueError(f"index must be an int, got {self.index!r}")

    def apply(self, arr: np.ndarray,
              prev: Optional[np.ndarray]) -> np.ndarray:
        out = np.array(arr)  # a host copy: never mutate engine buffers
        flat = out.reshape(-1)
        idx = int(self.index) % flat.size
        if self.mode == "stale":
            if prev is not None and prev.shape == out.shape:
                return np.array(prev)
            return np.zeros_like(out)
        if self.mode == "nan":
            if not np.issubdtype(out.dtype, np.floating):
                raise ValueError(
                    f"nan corruption needs a float target, "
                    f"{self.target} is {out.dtype}")
            flat[idx] = np.nan
        elif self.mode == "bitflip":
            if np.issubdtype(out.dtype, np.floating):
                bits = flat.view(np.uint32) if out.dtype == np.float32 \
                    else flat.view(np.uint16)
                bits[idx] ^= np.array(
                    1 << (30 if out.dtype == np.float32 else 14),
                    bits.dtype)
            elif out.dtype == np.uint32:
                flat[idx] ^= np.uint32(1 << 7)
            else:
                flat[idx] ^= np.array(1, out.dtype)
        elif self.mode == "signflip":
            if out.dtype == np.uint32:
                flat[idx] ^= np.uint32(1 << 31)
            else:
                flat[idx] = -flat[idx]
        return out


def _like(new: np.ndarray, old):
    """``new`` in the form of ``old``: a tensor on its device, or numpy."""
    if isinstance(old, torch.Tensor):
        return torch.as_tensor(new, device=old.device).to(old.dtype)
    return new


class FaultInjector:
    """Deterministic chaos harness around a dispatch callable.

    Wraps ``engine_fn``; the i-th call (0-based) first sleeps
    ``delay_calls[i]`` seconds if present (a straggler), then raises
    ``exc_type`` if ``i`` is in ``fail_calls`` (a worker failure), else
    calls the engine, and when ``i`` is in ``corrupt_calls`` corrupts the
    engine's RESULT as its ``CorruptionSpec`` says (silent corruption for
    the guardrail probes to catch; a tensor result comes back as a tensor
    on its device).  With ``delay_when(*args, **kwargs)`` a delay
    scheduled at ``i`` waits for the first call from ``i`` on that the
    predicate accepts and that is not failed (a stall at a full batch,
    say).  Everything is counted (``calls`` / ``faults`` /
    ``delays`` / ``corruptions`` / ``device_faults``).  As an engine's
    ``rung_hook`` it kills a run at the top of a chosen rung, where a
    preemption lands.

    **Device loss and return**: ``device_loss`` maps a dispatch index to a
    slot id taken DOWN from that index on, ``device_return`` a dispatch
    index to a slot id brought BACK.  The down set is state: every
    dispatch whose ``mesh=`` (a ``SortMesh``) holds a downed slot raises
    ``DeviceLost`` naming it, until the caller rebuilds the mesh without
    it; a dispatch with ``mesh=None`` has no slots and is never hit.
    ``healthy(slot_id)`` is the probe a ``DeviceHealthMonitor`` polls for
    returns.

    The cursor, schedules and down set are JSON-able (``state_dict`` /
    ``load_state_dict``), so a chaos scenario survives a ``WarmHandoff``.
    """

    def __init__(self, engine_fn: Callable, fail_calls=(),
                 delay_calls: Optional[dict[int, float]] = None,
                 exc_type: type = WorkerFailure,
                 sleep_fn: Callable[[float], None] = time.sleep,
                 corrupt_calls: Optional[dict] = None,
                 device_loss: Optional[dict[int, int]] = None,
                 device_return: Optional[dict[int, int]] = None,
                 delay_when: Optional[Callable[..., bool]] = None):
        self.engine_fn = engine_fn
        self.fail_calls = set(fail_calls)
        self.delay_calls = dict(delay_calls or {})
        self.delay_when = delay_when
        self.corrupt_calls = {
            int(k): (v if isinstance(v, CorruptionSpec)
                     else CorruptionSpec(**v))
            for k, v in (corrupt_calls or {}).items()}
        self.device_loss = {int(k): int(v)
                            for k, v in (device_loss or {}).items()}
        self.device_return = {int(k): int(v)
                              for k, v in (device_return or {}).items()}
        self.down: set[int] = set()
        self.exc_type = exc_type
        self.sleep_fn = sleep_fn
        self.calls = 0
        self.faults = 0
        self.delays = 0
        self.corruptions = 0
        self.device_faults = 0
        # The previous call's clean result per target: the stale source.
        self._prev: dict[str, np.ndarray] = {}
        # Covers index assignment and counting only; the sleep and the
        # engine run outside it.
        self._lock = threading.Lock()

    def healthy(self, device_id: int) -> bool:
        """Whether slot ``device_id`` is up: ``DeviceHealthMonitor``'s
        probe for returns."""
        with self._lock:
            return int(device_id) not in self.down

    def __call__(self, *args, **kwargs):
        with self._lock:
            i = self.calls
            self.calls += 1
            fail = i in self.fail_calls
            if self.delay_when is None:
                delay = self.delay_calls.get(i)
            else:
                due = [j for j in self.delay_calls if j <= i]
                delay = (self.delay_calls.pop(min(due))
                         if due and not fail
                         and self.delay_when(*args, **kwargs) else None)
            spec = self.corrupt_calls.get(i)
            # Transitions fire at exact dispatch indices, then persist.
            if i in self.device_loss:
                self.down.add(self.device_loss[i])
            if i in self.device_return:
                self.down.discard(self.device_return[i])
            lost = None
            mesh = kwargs.get("mesh")
            if mesh is not None and self.down:
                hit = [d for d in mesh.ids if d in self.down]
                if hit:
                    lost = hit[0]
                    self.device_faults += 1
            if delay is not None:
                self.delays += 1
            if fail:
                self.faults += 1
        if delay is not None:
            self.sleep_fn(delay)
        if fail:
            raise self.exc_type(f"injected fault at dispatch {i}")
        if lost is not None:
            raise DeviceLost(
                f"device {lost} lost at dispatch {i} (down set "
                f"{sorted(self.down)})", device_id=lost)
        result = self.engine_fn(*args, **kwargs)
        if spec is None and not self.corrupt_calls:
            return result
        out = list(result) if isinstance(result, tuple) else [result]
        if spec is not None:
            pos = CorruptionSpec._TARGETS[spec.target]
            if pos >= len(out):
                raise ValueError(
                    f"corruption target {spec.target!r} needs a "
                    f"{pos + 1}-tuple result, engine returned "
                    f"{len(out)} elements")
            with self._lock:
                prev = self._prev.get(spec.target)
            out[pos] = _like(spec.apply(_host(out[pos]), prev), out[pos])
            with self._lock:
                self.corruptions += 1
        # Record this call's CLEAN targets as the next stale source.
        with self._lock:
            for name, pos in CorruptionSpec._TARGETS.items():
                if pos < len(out):
                    src = result[pos] if isinstance(result, tuple) \
                        else result
                    self._prev[name] = _host(src)
        return tuple(out) if isinstance(result, tuple) else out[0]

    def state_dict(self) -> dict:
        """JSON-able cursor, schedules and down set (not the stale-source
        arrays)."""
        with self._lock:
            return {
                "calls": self.calls, "faults": self.faults,
                "delays": self.delays, "corruptions": self.corruptions,
                "fail_calls": sorted(int(i) for i in self.fail_calls),
                "delay_calls": {str(k): float(v)
                                for k, v in self.delay_calls.items()},
                "corrupt_calls": {
                    str(k): dataclasses.asdict(v)
                    for k, v in self.corrupt_calls.items()},
                "device_loss": {str(k): int(v)
                                for k, v in self.device_loss.items()},
                "device_return": {str(k): int(v)
                                  for k, v in self.device_return.items()},
                "down": sorted(int(d) for d in self.down),
                "device_faults": self.device_faults,
                "exc_type": self.exc_type.__name__,
            }

    def load_state_dict(self, state: dict) -> None:
        with self._lock:
            self.calls = int(state["calls"])
            self.faults = int(state["faults"])
            self.delays = int(state["delays"])
            self.corruptions = int(state.get("corruptions", 0))
            self.fail_calls = set(int(i) for i in state["fail_calls"])
            self.delay_calls = {int(k): float(v)
                                for k, v in state["delay_calls"].items()}
            self.corrupt_calls = {
                int(k): CorruptionSpec(**v)
                for k, v in state.get("corrupt_calls", {}).items()}
            self.device_loss = {
                int(k): int(v)
                for k, v in state.get("device_loss", {}).items()}
            self.device_return = {
                int(k): int(v)
                for k, v in state.get("device_return", {}).items()}
            self.down = set(int(d) for d in state.get("down", []))
            self.device_faults = int(state.get("device_faults", 0))


def _host_copy(x):
    """A host snapshot of one leaf of a train state (a DTensor gathered
    whole)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if type(x) is not torch.Tensor and hasattr(x, "full_tensor"):
            x = x.full_tensor()
        return x.to("cpu", copy=True)
    return np.array(x) if isinstance(x, np.ndarray) else x


def _device_of(x):
    return x.device if isinstance(x, torch.Tensor) else "host"


def _placed(snap, device):
    """A fresh copy of a snapshot leaf on ``device``."""
    if isinstance(snap, torch.Tensor):
        return snap.to(device, copy=True)
    return np.array(snap) if isinstance(snap, np.ndarray) else snap


class TrainSupervisor:
    """Runs a train loop of ``step_fn(state, batch) -> (state, metrics)``
    over ``data_fn(step)`` batches, checkpointing every
    ``checkpoint_every`` steps and at the end, and surviving
    ``WorkerFailure``s: a failure resumes from the newest checkpoint (one
    still being written included: ROADMAP.md known property 10), or,
    before the first one, replays from a host snapshot of the initial
    state.  The state is a tree of tensors (``repro_torch.tree``) and
    comes back on its devices.  ``history`` holds one ``metrics`` entry
    per step, and ``straggler`` and ``failure`` events.  ``shardings`` (a
    tree of ``repro_torch.launch.mesh.NamedSharding``) restores each
    checkpoint onto that layout (``CheckpointManager.restore``), whatever
    mesh wrote it; ``mesh`` is recorded in the manifests."""

    def __init__(
        self,
        step_fn: Callable[[Any, Any], tuple[Any, dict]],
        data_fn: Callable[[int], Any],
        ckpt,
        *,
        checkpoint_every: int = 50,
        max_restarts: int = 10,
        mesh=None,
        shardings=None,
        straggler=None,
    ):
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.ckpt = ckpt
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.mesh = mesh
        self.shardings = shardings
        self.straggler = straggler or StragglerMonitor()
        self.restarts = 0
        self.history: list[dict] = []

    def run(self, state, start_step: int, num_steps: int):
        """Run to ``start_step + num_steps``, surviving step failures."""
        step = start_step
        target = start_step + num_steps
        # Host snapshot of the initial state: a failure before the first
        # checkpoint restarts from here, not from the partly advanced
        # state.
        devices = tree_map(_device_of, state)
        init_state = tree_map(_host_copy, state)
        latest = self.ckpt.latest_step()
        if latest is not None and latest > step:
            state, step = self.ckpt.restore(state, shardings=self.shardings)
            log.info("resumed at step %d", step)

        while step < target:
            try:
                t0 = time.perf_counter()
                batch = self.data_fn(step)
                state, metrics = self.step_fn(state, batch)
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                if self.straggler.record(step, dt):
                    self.history.append({"step": step,
                                         "event": "straggler", "dt": dt})
                step += 1
                self.history.append({"step": step, "metrics": metrics})
                if step % self.checkpoint_every == 0 or step == target:
                    self.ckpt.save(step, state, mesh=self.mesh)
            except WorkerFailure as e:
                self.restarts += 1
                self.history.append({"step": step, "event": "failure",
                                     "error": str(e)})
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                # A save still being written is a checkpoint taken: wait
                # for it before looking (the reference looks first, and a
                # failure during an async save replays from the start).
                self.ckpt.wait()
                latest = self.ckpt.latest_step()
                if latest is None:
                    log.warning("failure before first checkpoint; "
                                "restarting from initial state")
                    state = tree_map(_placed, init_state, devices)
                    if self.shardings is not None:
                        from repro_torch.launch.steps import place_tree
                        state = place_tree(state, self.shardings)
                    step = start_step
                    continue
                state, step = self.ckpt.restore(state,
                                                shardings=self.shardings)
                log.info("restored step %d after failure (%d restarts)",
                         step, self.restarts)
        self.ckpt.wait()
        return state, step


@dataclasses.dataclass(frozen=True)
class DivergencePolicy:
    """Graceful-degradation ladder for ``NumericalDivergence`` failures.

    Each divergence consumes ONE rung, in order: ``promote_f32`` (retry a
    bfloat16 run in float32), ``tau_floor`` (clamp ``tau_end`` up to the
    floor), ``widen_band`` (double an explicit band half-width, or drop
    ``"auto"`` back to dense).

    **Integrity violations** (``repro_torch.runtime.guardrails
    .IntegrityViolation``) reorder it: ``integrity_retries`` plain
    replays from the last verified checkpoint come first (the supervisor
    counts them apart), then ``oracle_fallback`` retires the kernel tier
    to the plain PyTorch tier (``use_kernel=False``, the reference the
    kernels are held to), then band widening for band-tail violations,
    then the generic rungs above.

    ``apply`` returns the degraded config and a description, or None when
    no rung applies; the supervisor then re-raises.
    """
    promote_f32: bool = True
    tau_floor: float = 0.05
    widen_band: bool = True
    max_fallbacks: int = 3
    oracle_fallback: bool = True
    integrity_retries: int = 1

    def apply(self, cfg, failure) -> Optional[tuple[Any, str]]:
        integrity = getattr(failure, "probe", None) is not None
        if integrity:
            probe = failure.probe
            if (probe == "band_tail" and self.widen_band
                    and cfg.band is not None):
                if cfg.band == "auto":
                    return (dataclasses.replace(cfg, band=None),
                            "dropped band 'auto' -> dense")
                return (dataclasses.replace(cfg, band=int(cfg.band) * 2),
                        f"widened band {cfg.band} -> {int(cfg.band) * 2}")
            if self.oracle_fallback and cfg.use_kernel:
                return (dataclasses.replace(cfg, use_kernel=False),
                        "retired kernel tier -> plain PyTorch apply "
                        "(use_kernel=False)")
        if self.promote_f32 and cfg.compute_dtype == "bfloat16":
            return (dataclasses.replace(cfg, compute_dtype="float32"),
                    "promoted compute_dtype bfloat16 -> float32")
        if self.tau_floor and cfg.tau_end < self.tau_floor:
            return (dataclasses.replace(cfg, tau_end=float(self.tau_floor)),
                    f"clamped tau_end {cfg.tau_end:g} -> {self.tau_floor:g}")
        if self.widen_band and cfg.band is not None:
            if cfg.band == "auto":
                return (dataclasses.replace(cfg, band=None),
                        "dropped band 'auto' -> dense")
            return (dataclasses.replace(cfg, band=int(cfg.band) * 2),
                    f"widened band {cfg.band} -> {int(cfg.band) * 2}")
        return None


class AnnealSupervisor:
    """Checkpoint/restart supervision of the annealing engines.

    Wraps one of the resumable entry points (``shuffle_soft_sort_batched``
    by default; ``restart_tournament`` and ``shuffle_soft_sort`` take the
    same knobs) and runs it to completion:

    * **Worker failures** (``failure_types``) restart the engine with
      ``resume=True`` under a ``RetryPolicy`` budget: the engine replays
      from its last committed rung checkpoint, and since a rung's carry
      is whole (orders, stream states, losses, controller state), the
      finished run is bitwise an uninterrupted one.
    * **Numerical divergences** consume rungs of an optional
      ``DivergencePolicy`` ladder; each fallback re-runs only the rounds
      after the last finite rung, its config recorded in
      ``stats["fallbacks"]``.
    * **Integrity violations** first replay from the last verified
      checkpoint, up to ``degrade.integrity_retries`` times, then take
      the ladder.
    * **A lost device** (a ``DeviceLost`` naming a slot of ``mesh=``)
      evicts that slot: the retry runs on a mesh rebuilt over the
      survivors (``stats["evictions"]``, an ``evict`` history entry).

    The checkpoint directory is the whole state: kill the process
    anywhere and a new supervisor over the same directory continues.
    """

    def __init__(self, run_fn: Optional[Callable] = None, *,
                 checkpoint_dir: str,
                 retry: Optional[RetryPolicy] = None,
                 degrade: Optional[DivergencePolicy] = None,
                 failure_types: tuple = (WorkerFailure,),
                 sleep_fn: Callable[[float], None] = time.sleep):
        if run_fn is None:
            from repro_torch.core.shufflesoftsort import (
                shuffle_soft_sort_batched)
            run_fn = shuffle_soft_sort_batched
        self.run_fn = run_fn
        self.checkpoint_dir = checkpoint_dir
        self.retry = retry or RetryPolicy()
        self.degrade = degrade
        self.failure_types = tuple(failure_types)
        self.sleep_fn = sleep_fn
        self.stats: dict[str, Any] = {
            "attempts": 0, "restarts": 0, "fallbacks": [],
            "verified_replays": 0, "integrity_incidents": []}
        self.history: list[dict] = []

    def run(self, xs, hw, cfg, **kwargs):
        """Run ``run_fn(xs, hw, cfg, ...)`` to completion, restarting from
        the newest rung checkpoint after each supervised failure.  Extra
        ``kwargs`` go to ``run_fn`` as they are (``rung_hook`` for chaos,
        ``guardrail=``, ``device=``, ``mesh=``, ...)."""
        from repro_torch.core.shufflesoftsort import NumericalDivergence
        from repro_torch.runtime.guardrails import IntegrityViolation
        cfg_cur = cfg
        restarts = 0
        replays = 0
        while True:
            self.stats["attempts"] += 1
            try:
                return self.run_fn(xs, hw, cfg_cur,
                                   checkpoint_dir=self.checkpoint_dir,
                                   resume=True, **kwargs)
            except (NumericalDivergence, IntegrityViolation) as e:
                integrity = isinstance(e, IntegrityViolation)
                if integrity:
                    self.stats["integrity_incidents"].append(e.incident())
                    budget = (self.degrade.integrity_retries
                              if self.degrade is not None else 0)
                    if replays < budget:
                        replays += 1
                        self.stats["verified_replays"] += 1
                        self.history.append({
                            "event": "integrity", "probe": e.probe,
                            "round": e.round,
                            "fallback": "replayed from last verified "
                                        "checkpoint"})
                        log.warning(
                            "integrity violation (%s) at round %s: "
                            "replaying from last verified checkpoint",
                            e.probe, e.round)
                        continue
                n_fb = len(self.stats["fallbacks"])
                fallback = None
                if (self.degrade is not None
                        and n_fb < self.degrade.max_fallbacks):
                    fallback = self.degrade.apply(cfg_cur, e)
                if fallback is None:
                    raise
                cfg_cur, desc = fallback
                self.stats["fallbacks"].append(desc)
                self.history.append({
                    "event": "integrity" if integrity else "divergence",
                    "round": e.round, "tau": e.tau,
                    "dtype": e.dtype, "fallback": desc})
                log.warning("%s at round %s (tau=%s, %s): %s",
                            "integrity violation" if integrity
                            else "divergence",
                            e.round, e.tau, e.dtype, desc)
            except self.failure_types as e:
                restarts += 1
                self.stats["restarts"] = restarts
                self.history.append({"event": "failure", "error": str(e)})
                if restarts > self.retry.max_retries:
                    raise RuntimeError(
                        f"exceeded {self.retry.max_retries} restarts"
                    ) from e
                # A DeviceLost names its slot: the retry re-shards over
                # the survivors instead of replaying onto the dead slot.
                dev = getattr(e, "device_id", None)
                mesh = kwargs.get("mesh")
                survivors = (None if dev is None or mesh is None
                             else mesh.without([dev]))
                if survivors is not None:
                    kwargs["mesh"] = survivors
                    self.stats.setdefault("evictions", 0)
                    self.stats["evictions"] += 1
                    self.history.append(
                        {"event": "evict", "device": int(dev),
                         "survivors": len(survivors)})
                    log.warning("evicted device %d; re-sharded over %d "
                                "survivors", dev, len(survivors))
                delay = self.retry.backoff(restarts)
                if delay:
                    self.sleep_fn(delay)
                log.info("restarting after failure (%d restarts): %s",
                         restarts, e)

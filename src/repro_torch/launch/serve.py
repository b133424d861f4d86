"""Batched serving in PyTorch: LM decode serving and grid-sort
serving.

The port of ``repro.launch.serve``.  Two workloads share the CLI:

* ``--workload lm`` (the default) — LM decode serving (``serve_lm``).
  Requests arrive with different prompt lengths; they are right-padded
  into one decode batch, prefilled once, then decoded step-locked,
  greedily, over KV caches padded to the decode horizon.  Every attention
  call runs on the port's flash kernels.

      python -m repro_torch.launch.serve --arch qwen1.5-0.5b \\
          --preset tiny --requests 8 --max-new 32      # on the card
      python -m repro_torch.launch.serve --device cpu --preset tiny

* ``--workload sort`` — grid-sort serving.  ``SortServer``
is a continuous-batching scheduler: concurrent ``submit()`` calls (one per
user upload, say) join the annealing loop at the next ROUND boundary and
leave at the boundary where they finish, the tournament's rung structure
as the preemption point, so a slow large request does not stall the
traffic coalesced behind it.  Requests carry optional deadlines and
priorities; admission control sheds load past a bounded queue depth as a
typed ``QueueFull`` raised by ``submit()`` (backpressure, never a hang);
mixed (N, d) traffic is batched per shape bucket with batch sizes padded
to powers of two; and a failed (or straggling) dispatch re-queues its
requests from their last committed round boundary under a retry budget
with exponential backoff (``repro_torch.runtime.fault_tolerance
.RetryPolicy``) instead of failing every coalesced future.

    python -m repro_torch.launch.serve --workload sort --requests 8 \\
        --sort-n 256 --rounds 30                  # on the card
    python -m repro_torch.launch.serve --workload sort --device cpu \\
        --requests 8 --sort-n 64 --rounds 8

Every dispatch is one ``run_round_segment`` call on the server's device
(CUDA unless ``device="cpu"``): ``--use-kernel`` routes the apply through
the kernel tier, ``--band K|auto`` switches it to the banded tier once the
anneal is cold enough, ``--dtype bfloat16`` (with ``--use-kernel``) is the
mixed-precision kernel tier, ``--schedule adaptive`` the plateau
controller, ``--tournament-rungs K --restarts S`` the restart tournament,
``--brownout`` the overload ladder and ``--guardrail`` the integrity
probes with their self-heal.

Each request draws its shuffles from its own streams (a
``repro_torch.core.prng`` source: ``TorchShuffleSource`` seeded by the
request's key, or a source the caller passes as the key); a dispatch
stacks the streams of the requests it carries into one source
(``stack_sources``), and each request's rows of the stream state commit
with its orders once the rung is verified.  So a request's result is
bitwise its own chained ``run_round_segment`` run alone, whatever traffic
shared its dispatches (on the card the kernels are batch-invariant and the
loss runs in blocks of 8 instances; on the CPU the plain tier is).

Scale-out: ``mesh=`` (``--mesh-devices D``) splits every dispatch over
the slots of a ``repro_torch.launch.mesh.SortMesh``, and
``device_health=`` (``--device-health STRIKES``) evicts a slot that a
``DeviceLost`` names: the mesh is rebuilt over the survivors, the rung
replays there without spending retry budget, and a slot that probes
healthy again grows the mesh back at a tick.  Requests carry their state
on the server's device between rungs, so a re-shard moves nothing and
changes no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch


# --------------------------------------------------------------------------
# Typed rejections and the request record.
# --------------------------------------------------------------------------

class RequestRejected(RuntimeError):
    """Base of every typed SortServer rejection.  A request the server
    cannot serve resolves with a subclass of this — never a hang."""


class QueueFull(RequestRejected):
    """Admission control: the bounded queue is at depth.  Raised
    synchronously by ``submit()`` so callers see backpressure at the
    moment they offer load, not as a future that never resolves."""


class DeadlineExceeded(RequestRejected):
    """The request's deadline passed before its anneal finished; it was
    shed at a round boundary (or at admission)."""


class ServerClosed(RequestRejected):
    """The server was closed while this request was queued/in flight."""


class RequestFailed(RequestRejected):
    """Device dispatch failed more than the retry budget allows;
    ``__cause__`` carries the last device error."""


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


# Brownout ladder rungs, mildest first.  Level k applies rungs 1..k:
#   culled   — run the request's restarts as a maximally-culled
#              tournament (keep=1 at every interior rung boundary)
#   adaptive — force schedule="adaptive" so converged restarts exit at
#              the first plateaued boundary instead of running all R
#   banded   — snap the dense apply to the O(N*K) banded tier
#   bf16     — drop the kernel tier to bfloat16 compute
_BROWNOUT_LADDER = ("culled", "adaptive", "banded", "bf16")


@dataclasses.dataclass(frozen=True)
class BrownoutPolicy:
    """Overload brownout: degrade per-request quality BEFORE shedding.

    When measured capacity drops (the straggler monitor halving the batch
    bucket cap) or queue depth crosses the watermarks, the server walks a
    monotone degradation ladder (``_BROWNOUT_LADDER``) one level per
    scheduler tick, and walks it back down, one level per tick, as
    capacity returns.

    Degradations are applied to a request ONCE, at first admission, so an
    in-flight anneal never changes config mid-run (its result stays
    bitwise that of its admitted config); a request with more than
    ``slack_full_s`` of deadline slack (or no deadline at all) is degraded
    one level more gently.  Every applied rung is counted in
    ``stats["degradations"]`` and the request's ``degraded`` tuple.
    ``high_watermark`` / ``low_watermark`` are fractions of
    ``queue_depth``.
    """
    high_watermark: float = 0.5
    low_watermark: float = 0.25
    slack_full_s: float = 2.0


@dataclasses.dataclass(eq=False)      # identity semantics: requests are
class _SortRequest:                   # tracked in lists via `is`
    """One in-flight request: its problem, bookkeeping, and, once
    admitted, its per-restart engine state.  The state committed at each
    round boundary (orders, the streams' state in ``src``, losses) doubles
    as the restart checkpoint: a failed dispatch re-queues the request and
    it resumes from here."""
    x: np.ndarray                      # (N, d) float32
    hw: tuple[int, int]
    d: int
    key: object                        # int seed, raw key or a source
    future: Future
    priority: int
    seq: int
    deadline: float | None             # absolute monotonic, None = none
    submitted: float
    progress: int = 0                  # rounds executed so far
    attempts: int = 0                  # failed dispatches so far
    eligible_at: float = 0.0           # backoff gate for re-admission
    norm: float | None = None          # loss normalization (at admission)
    orders: np.ndarray | None = None   # (S_live, N) int32
    src: object | None = None          # (S_live rows) committed streams
    alive: np.ndarray | None = None    # (S_live,) original restart idx
    losses: np.ndarray | None = None   # (S, R) f32, NaN where culled
    x_dev: torch.Tensor | None = None  # x on the server's device
    # Guardrail state: the request's probe policy (None = server default
    # at admission), its monitor, the integrity-strike count, and the
    # self-healed config override a DivergencePolicy rung installed.
    guardrail: object | None = None    # GuardrailPolicy
    monitor: object | None = None      # GuardrailMonitor (lazy, not saved)
    strikes: int = 0
    cfg_override: object | None = None  # ShuffleSoftSortConfig
    # adaptive mode only: the request's plateau controller (indexed by
    # ORIGINAL restart id) and which alive rows have left the anneal.
    ctrl: object | None = None
    done_mask: np.ndarray | None = None  # (S_live,) bool
    # Brownout bookkeeping: the ladder rungs applied at admission.
    degraded: tuple = ()
    brownout_cull: bool = False

    @property
    def n_live(self) -> int:
        """Instances the next dispatch must carry (pre-admission: 1)."""
        if self.alive is None:
            return 1
        if self.done_mask is not None:
            return int((~self.done_mask).sum())
        return len(self.alive)


@dataclasses.dataclass
class WarmHandoff:
    """In-flight state a preempted ``SortServer`` hands its successor.

    ``close(drain=False)`` returns one: every unresolved request, with its
    future, committed round-boundary state (orders, streams, losses) and
    controller, plus the server-owned seed stream's position and the
    sequence counter.  A server built with ``resume=handoff`` adopts the
    requests and finishes them from their last committed rung: the
    original futures resolve from the new server, exactly once, bitwise
    what the first server would have produced.  With a ``checkpoint_dir``
    the same state is persisted there, so a successor in a NEW process can
    ``resume=<dir>`` (fresh futures, on ``server.resumed``)."""
    requests: list            # unresolved _SortRequests, seq order
    rng_state: dict           # np.random PCG64 bit-generator state
    seq: int                  # next submission sequence number
    # The engine's FaultInjector cursor (chaos scenarios), if it has one.
    injector_state: dict | None = None
    brownout_level: int = 0
    # The slot ids out of the mesh, and the health monitor's strikes.
    evicted_devices: tuple = ()
    health_state: dict | None = None


def _source_arrays(prefix: str, src) -> tuple[dict, str]:
    """A shuffle source as flat arrays for the handoff, and its kind."""
    arrays = {f"{prefix}_state": np.asarray(src.state_dict())}
    if src.kind == "replay":
        arrays[f"{prefix}_shuffles"] = src.shuffles.cpu().numpy()
    return arrays, src.kind


def _source_from(prefix: str, kind: str, arrays: dict, n: int, device):
    """The source ``_source_arrays`` flattened, on ``device``."""
    from repro_torch.core.prng import (ReplayShuffleSource,
                                       ThreefryShuffleSource,
                                       TorchShuffleSource)
    state = arrays[f"{prefix}_state"]
    if kind == "replay":
        src = ReplayShuffleSource(arrays[f"{prefix}_shuffles"], device)
    elif kind.startswith("threefry"):
        src = ThreefryShuffleSource(state, n, device,
                                    partitionable=kind == "threefry")
    else:
        src = TorchShuffleSource([0] * len(state), n, device)
    src.load_state_dict(state)
    return src


def _request_key(key, n_restarts: int):
    """``submit``'s ``key`` as the request keeps it: an int seed, raw key
    data as a (2,) uint32 numpy array, or the shuffle source itself.
    Raises ``TypeError`` / ``ValueError`` for anything else."""
    from repro_torch.core import threefry
    from repro_torch.core.prng import ShuffleSource
    if isinstance(key, (bool, np.bool_)):
        raise TypeError(f"key must be an int seed, raw key data or a "
                        f"shuffle source, got {key!r}")
    if isinstance(key, (int, np.integer)):
        return int(key)
    if isinstance(key, (np.ndarray, torch.Tensor, list, tuple)):
        if isinstance(key, torch.Tensor):
            if key.dtype == torch.uint32:      # numpy takes no uint32 view
                key = key.view(torch.int32).to(torch.int64) & threefry.MASK
            key = key.detach().cpu().numpy()
        data = np.asarray(key)
        if data.dtype.kind not in "iu":
            raise TypeError(f"raw key data must be integers, got "
                            f"{data.dtype}")
        if data.shape != (2,):
            raise ValueError(f"raw key data must be (2,), got {data.shape}")
        if (data.astype(np.int64) < 0).any() or (data > threefry.MASK).any():
            raise ValueError(f"raw key data must be uint32 words, got "
                             f"{data.tolist()}")
        return data.astype(np.uint32)
    if not isinstance(key, ShuffleSource):
        raise TypeError(f"key must be an int seed, raw key data or a "
                        f"shuffle source, got {type(key).__name__}")
    if len(key) != n_restarts:
        raise ValueError(f"a shuffle source key needs n_restarts = "
                         f"{n_restarts} streams, got {len(key)}")
    return key


def restart_keys(key, n_restarts: int, device) -> torch.Tensor:
    """A raw-key request's restart keys, the reference server's chain:
    ``[key] + split(fold_in(key, 1), S - 1)``, and ``[key]`` at S = 1.
    (S, 2) int64 key data on ``device``."""
    from repro_torch.core import threefry
    base = threefry.as_keys(key, device).reshape(1, 2)
    if n_restarts == 1:
        return base
    return torch.cat([base, threefry.split(threefry.fold_in(base[0], 1),
                                           n_restarts - 1)])


# --------------------------------------------------------------------------
# The server.
# --------------------------------------------------------------------------

class SortServer:
    """Continuous-batching scheduler for grid-sort requests.

    Requests join and leave the annealing loop at ROUND boundaries: the
    R-round schedule is split into ``sched_rungs`` equal rungs and each
    scheduler tick advances every active instance by one rung via
    ``repro_torch.core.run_round_segment``: one device call per (shape
    bucket, apply regime) in which instances at different anneal positions
    coexist, each on its own slice of the tau schedule and its own
    shuffle streams.  A finished request leaves at its boundary while its
    batchmates keep annealing, and a newly admitted one joins at the next
    tick.

    Semantics (per request, ``n_restarts == 1``, no culling): the result
    is bitwise the request's own chained ``run_round_segment`` run alone
    (same streams, same norm), whatever traffic interleaved the rounds.
    With ``cfg.band`` the dense->banded switch snaps UP to the next rung
    boundary (``rung_aligned_switch``) so no segment straddles regimes.

    Behaviors, as the reference's:

    * **Deadlines / priorities**: ``submit(..., deadline_s=, priority=)``;
      expired requests are shed at boundaries with ``DeadlineExceeded``;
      admission is priority-then-FIFO.
    * **Backpressure**: at most ``queue_depth`` requests wait for
      admission; past that ``submit()`` raises ``QueueFull``.
    * **Shape buckets**: mixed (N, d) traffic batches per ``(hw, d)``,
      with per-call batch sizes padded to the next power of two (capped at
      ``max_batch``); ``stats["compile_keys"]`` holds the distinct
      dispatch signatures (bucket x regime x padded batch).
    * **Fault tolerance**: a dispatch that raises (a CUDA error included)
      re-queues its requests from their last committed boundary under
      ``retry``; budget exhaustion resolves the future with
      ``RequestFailed``.  Every future resolves exactly once.
    * **Elastic capacity** (``mesh=``, ``device_health=``): a
      ``DeviceHealthMonitor`` that declares a slot lost evicts it, the
      mesh is rebuilt over the survivors (``mesh=None``, the server's own
      device, once every slot is out: logged as an ``evict`` event with no
      survivors) and the rung replays there without spending retry
      budget; returned slots grow the mesh back at a tick boundary; an
      eviction raises the brownout pressure by one level while it lasts.
    * **Straggler rerouting**: a dispatch's wall time over the time
      ``DispatchCost`` expects of its signature, batch bucket included
      (ROADMAP.md Queue C9: the reference's time per instance-round
      misjudges host-bound dispatches) feeds the ``straggler`` monitor; a
      signature's first dispatch is learnt from, not judged.  A flagged
      dispatch halves the bucket cap (restored after
      ``straggler_recovery`` healthy dispatches).
    * **Brownout ladder** (``brownout=BrownoutPolicy()``).
    * **Guardrails** (``guardrail=GuardrailPolicy(...)``, or per request):
      the probes of ``repro_torch.runtime.guardrails`` run per request
      slice before any commit; a slice that fails re-queues alone from its
      last verified boundary, and past ``heal_after`` strikes a
      ``DivergencePolicy`` rung (``degrade``) becomes its config override.
    * **Reproducibility**: requests submitted without a key draw a seed
      from a server-owned stream seeded by ``seed``: same seed and same
      submission order give bitwise results, end to end.
    * **Warm restart**: ``close(drain=False)`` returns a ``WarmHandoff``;
      ``resume=`` adopts one (or a ``checkpoint_dir`` it was saved to).

    ``tournament_rungs > 1`` (with ``n_restarts > 1``) culls the worst
    ``cull_fraction`` of each request's restarts at its interior rung
    boundaries.  ``cfg.schedule="adaptive"`` gives each request its own
    ``AdaptiveController`` (decision quantum = the scheduler rung): the
    request resolves at the first boundary where every surviving restart
    has converged.

    The scheduler thread does all device work; ``submit`` never touches
    the device (the server's ``device``, by default the mesh's first
    slot's, and CUDA without a mesh).
    """

    def __init__(self, hw, d, cfg=None, max_batch: int = 8,
                 max_wait_ms: float = 2.0, n_restarts: int = 1,
                 mesh=None, tournament_rungs: int = 1,
                 cull_fraction: float = 0.5, *,
                 queue_depth: int = 64, max_active: int | None = None,
                 sched_rungs: int | None = None, seed: int = 0,
                 default_deadline_s: float | None = None,
                 retry=None, straggler=None,
                 straggler_recovery: int = 8,
                 checkpoint_dir: str | None = None, resume=None,
                 engine_fn=None, autostart: bool = True,
                 guardrail=None, degrade=None,
                 brownout=None, device_health=None, device=None):
        from repro_torch.core.shufflesoftsort import (
            ShuffleSoftSortConfig,
            _rung_boundaries,
            run_round_segment,
        )
        from repro_torch.runtime.fault_tolerance import (
            DivergencePolicy,
            RetryPolicy,
        )
        from repro_torch.core.shufflesoftsort import _check_mesh, _run_device
        from repro_torch.runtime.guardrails import GuardrailPolicy
        from repro_torch.runtime.straggler import (
            DeviceHealthMonitor,
            DispatchCost,
            StragglerMonitor,
        )

        self.mesh = _check_mesh(mesh)
        if device_health is not None and not isinstance(
                device_health, DeviceHealthMonitor):
            raise TypeError(
                f"device_health must be a DeviceHealthMonitor or None, "
                f"got {device_health!r}")
        self.device = _run_device(device, self.mesh)
        self.hw = tuple(hw)
        self.n = self.hw[0] * self.hw[1]
        self.d = d
        self.cfg = cfg or ShuffleSoftSortConfig()
        self.max_batch = int(max_batch)
        self.max_wait_s = max_wait_ms / 1e3
        self.n_restarts = int(n_restarts)
        self.tournament_rungs = int(tournament_rungs)
        self.cull_fraction = float(cull_fraction)
        self.queue_depth = int(queue_depth)
        self.max_active = (2 * self.max_batch if max_active is None
                           else int(max_active))
        self.default_deadline_s = default_deadline_s
        self.retry = retry or RetryPolicy()
        self.straggler = straggler or StragglerMonitor()
        self.straggler_recovery = int(straggler_recovery)
        self._cost = DispatchCost(alpha=self.straggler.alpha)
        self._engine = engine_fn or run_round_segment
        if guardrail is not None and not isinstance(guardrail,
                                                    GuardrailPolicy):
            raise TypeError(
                f"guardrail must be a GuardrailPolicy or None, "
                f"got {guardrail!r}")
        self.guardrail = guardrail          # server-default probe policy
        self.degrade = degrade or DivergencePolicy()
        if brownout is not None and not isinstance(brownout,
                                                   BrownoutPolicy):
            raise TypeError(
                f"brownout must be a BrownoutPolicy or None, "
                f"got {brownout!r}")
        self.brownout = brownout
        self.device_health = device_health

        rounds = self.cfg.rounds
        self.adaptive = self.cfg.schedule == "adaptive"
        tournament = self.tournament_rungs > 1 and self.n_restarts > 1
        if sched_rungs is None:
            if self.adaptive:
                # Scheduler rung == controller decision quantum, so every
                # boundary the server preempts at is one the controller
                # observed at.
                from repro_torch.core.annealing import adaptive_seg_len
                sched_rungs = rounds // adaptive_seg_len(self.cfg)
            else:
                sched_rungs = (
                    self.tournament_rungs if tournament else
                    next(k for k in (4, 3, 2, 1) if rounds % k == 0))
        self.sched_rungs = int(sched_rungs)
        if not 1 <= self.sched_rungs <= rounds or rounds % self.sched_rungs:
            raise ValueError(
                f"sched_rungs={self.sched_rungs} must divide "
                f"cfg.rounds={rounds} (uniform preemption quantum)")
        if tournament and (rounds % self.tournament_rungs
                           or self.sched_rungs % self.tournament_rungs):
            raise ValueError(
                f"tournament_rungs={self.tournament_rungs} must divide "
                f"cfg.rounds={rounds} and sched_rungs={self.sched_rungs} "
                "so cull boundaries land on scheduler boundaries")
        self.seg_len = rounds // self.sched_rungs
        self._cull_edges = (
            set(_rung_boundaries(rounds, self.tournament_rungs)[:-1])
            if tournament else set())

        self._rng = np.random.Generator(np.random.PCG64(seed))
        self.stats = {
            "requests": 0, "batches": 0, "batch_sizes": [],
            "completed": 0, "failed": 0, "deadline_missed": 0,
            "queue_rejected": 0, "retries": 0, "recoveries": 0,
            "stragglers": 0, "culled": 0, "latencies_ms": [],
            "adaptive_exits": 0, "rounds_saved": 0, "resumed": 0,
            "integrity_violations": 0, "self_heals": 0,
            "integrity_incidents": [],
            "compile_keys": set(),
            "evictions": 0, "reshards": 0, "device_returns": 0,
            "brownouts": 0,
            "degradations": {r: 0 for r in _BROWNOUT_LADDER},
            # Seconds in the dispatches' device calls (to the host copy of
            # their results), and in the guarded dispatches' probes (the
            # shadow's replay and apply check included).
            "dispatch_s": 0.0, "probe_s": 0.0,
        }
        self.events: list[dict] = []
        self._cv = threading.Condition()
        self._pending: list[_SortRequest] = []
        self._active: list[_SortRequest] = []
        self._stop = False
        self._preempt = False
        self._seq = 0
        self._dispatch_idx = 0
        self._bucket_cap = self.max_batch
        self._healthy_streak = 0
        self._switch_cache: dict[tuple, int] = {}
        # Elastic capacity: the mesh as constructed, and the slot ids
        # evicted from it (which also raise the brownout target).
        self._mesh_full = self.mesh
        self._evicted: list[int] = []
        self._brownout_level = 0
        self.checkpoint_dir = checkpoint_dir
        self.resumed: list[_SortRequest] = []
        if resume is not None:
            handoff = (resume if isinstance(resume, WarmHandoff)
                       else self._load_handoff(resume))
            self._adopt(handoff)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False
        if autostart:
            self.start()

    def start(self):
        """Start the scheduler thread (no-op if already running).
        ``autostart=False`` + ``start()`` lets tests enqueue a batch of
        requests and observe one deterministic admission pass."""
        if not self._started:
            self._started = True
            self._worker.start()

    # ---- client API ------------------------------------------------------

    def submit(self, x: np.ndarray, key=None, *, hw=None,
               priority: int = 0, deadline_s: float | None = None,
               guardrail=None) -> Future:
        """Enqueue one (N, d) problem; returns a Future of
        ``(order (N,) int32, sorted (N, d), losses (R,))``.

        ``key`` — an int seed of the request's shuffle streams (restart 0
        draws from ``TorchShuffleSource([key])``, so a one-restart result
        is bitwise that seed's solo run); raw ``jax.random`` key data, a
        (2,) uint32 array or integer tensor (``threefry.prng_key(i)``),
        whose restarts draw the reference's chain (``restart_keys``: a
        one-restart result is bitwise ``shuffle_soft_sort(key=key)``); or
        a shuffle source of ``n_restarts`` streams (the request's own;
        parity tests pass a ``ReplayShuffleSource`` of the reference's
        shuffles); missing, a seed drawn from the server-owned seeded
        stream.  Any other key raises ``TypeError`` or ``ValueError``
        here.  ``hw`` defaults
        to the server's signature; another grid (with a matching x) routes
        the request to its own shape bucket.  ``priority`` — higher admits
        first.  ``deadline_s`` — relative seconds; past it the request is
        shed with ``DeadlineExceeded``.  ``guardrail`` — a per-request
        ``GuardrailPolicy`` overriding the server default.  Raises ``QueueFull`` / ``ServerClosed`` synchronously.  Host work
        only: the device is touched by the scheduler thread alone.
        """
        from repro_torch.runtime.guardrails import GuardrailPolicy
        if guardrail is not None and not isinstance(guardrail,
                                                    GuardrailPolicy):
            raise TypeError(
                f"guardrail must be a GuardrailPolicy or None, "
                f"got {guardrail!r}")
        x = np.asarray(x, np.float32)
        req_hw = self.hw if hw is None else tuple(hw)
        if x.ndim != 2 or x.shape[0] != req_hw[0] * req_hw[1]:
            raise ValueError(
                f"x shape {x.shape} does not fit grid {req_hw}")
        if hw is None and x.shape != (self.n, self.d):
            raise ValueError(
                f"x shape {x.shape} != server signature "
                f"{(self.n, self.d)}; pass hw= to use another bucket")
        if key is not None:
            key = _request_key(key, self.n_restarts)
        if deadline_s is None:
            deadline_s = self.default_deadline_s
        now = time.monotonic()
        with self._cv:
            if self._stop:
                raise ServerClosed("SortServer is closed")
            if len(self._pending) >= self.queue_depth:
                self.stats["queue_rejected"] += 1
                raise QueueFull(
                    f"queue depth {self.queue_depth} reached; retry later")
            if key is None:
                key = int(self._rng.integers(0, 2**31 - 1))
            fut: Future = Future()
            req = _SortRequest(
                x=x, hw=req_hw, d=x.shape[1],
                key=key,
                future=fut, priority=int(priority), seq=self._seq,
                deadline=None if deadline_s is None else now + deadline_s,
                submitted=now,
                guardrail=self.guardrail if guardrail is None
                else guardrail)
            self._seq += 1
            self.stats["requests"] += 1
            self._pending.append(req)
            self._cv.notify()
        return fut

    def close(self, drain: bool = True):
        """Stop the scheduler.

        ``drain=True`` (the default): every queued or in-flight future
        resolves with ``ServerClosed``.

        ``drain=False`` — **warm restart** (preemption): stop WITHOUT
        rejecting.  Waits for the dispatch in flight, syncs the device,
        and returns a ``WarmHandoff`` of every unresolved request at its
        last committed round boundary; a successor built with ``resume=``
        finishes them and the original futures resolve exactly once.  With
        ``checkpoint_dir`` the handoff is also persisted there.
        """
        with self._cv:
            self._stop = True
            if not drain:
                self._preempt = True
            self._cv.notify_all()
        if self._started:
            self._worker.join(timeout=120)
        if drain:
            self._reject_all(ServerClosed("SortServer closed"))
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._cv:
            inflight = self._pending + self._active
            self._pending, self._active = [], []
        inflight = sorted((r for r in inflight if not r.future.done()),
                          key=lambda r: r.seq)
        handoff = WarmHandoff(requests=inflight,
                              rng_state=self._rng.bit_generator.state,
                              seq=self._seq,
                              injector_state=(
                                  self._engine.state_dict()
                                  if hasattr(self._engine, "state_dict")
                                  else None),
                              brownout_level=self._brownout_level,
                              evicted_devices=tuple(self._evicted),
                              health_state=(
                                  self.device_health.state_dict()
                                  if self.device_health is not None
                                  else None))
        self.events.append({"event": "preempt",
                            "inflight": len(inflight)})
        if self.checkpoint_dir is not None:
            self._save_handoff(handoff)
        return handoff

    # ---- warm restart (preemption handoff) ------------------------------

    def _adopt(self, handoff: WarmHandoff):
        """Adopt a predecessor's in-flight requests: they re-enter the
        admission queue at their last committed round boundary (backoff
        gates cleared) and their futures resolve from THIS server."""
        self._rng.bit_generator.state = handoff.rng_state
        self._seq = max(self._seq, int(handoff.seq))
        if (handoff.injector_state is not None
                and hasattr(self._engine, "load_state_dict")):
            self._engine.load_state_dict(handoff.injector_state)
        # The elastic state: the same evicted set (the mesh rebuilt over
        # the survivors) and the same strikes.
        self._brownout_level = int(handoff.brownout_level)
        evicted = [int(dv) for dv in (handoff.evicted_devices or ())]
        if evicted:
            self._evicted = evicted
            self._reshard()
        if (handoff.health_state is not None
                and self.device_health is not None):
            self.device_health.load_state_dict(handoff.health_state)
        for req in handoff.requests:
            if req.future.done():       # pragma: no cover - defensive
                continue
            req.eligible_at = 0.0
            self.stats["requests"] += 1
            self.stats["resumed"] += 1
            self.resumed.append(req)
            self._pending.append(req)
            self.events.append({"event": "adopt", "seq": req.seq,
                                "progress": req.progress})

    # ---- elastic capacity: eviction, re-shard, return ----------------

    def _reshard(self):
        """Rebuild ``self.mesh`` over the constructed slots not evicted
        (``mesh=None`` once every slot is out: the server's own device
        still serves).  No carry moves: the requests' state lives on the
        server's device between rungs."""
        if self._mesh_full is not None:
            self.mesh = self._mesh_full.without(self._evicted)

    def _device_failure(self, reqs: list[_SortRequest], exc) -> bool:
        """A dispatch failure through the health monitor: a LOST verdict
        evicts the slot, re-shards, and re-queues the rung's requests
        without spending retry budget (the fault was the slot's), so the
        replay at the next tick runs on the survivors.  Returns True when
        handled so."""
        if self.device_health is None:
            return False
        dev = self.device_health.classify(exc)
        if dev is None:
            return False
        self._evicted.append(int(dev))
        self.stats["evictions"] += 1
        self._reshard()
        self.stats["reshards"] += 1
        self.events.append({"event": "evict", "device": int(dev),
                            "survivors": (0 if self.mesh is None
                                          else len(self.mesh)),
                            "requeued": len(reqs)})
        now = time.monotonic()
        for req in reqs:
            self._active.remove(req)
            req.eligible_at = now
            with self._cv:
                self._pending.append(req)
        return True

    def _poll_device_returns(self):
        """Grow the mesh back at a tick boundary when evicted slots probe
        healthy again (``DeviceHealthMonitor.poll_returns``)."""
        if self.device_health is None or not self._evicted:
            return
        grew = False
        for dev in self.device_health.poll_returns():
            dev = int(dev)
            if dev in self._evicted:
                self._evicted.remove(dev)
                self.stats["device_returns"] += 1
                grew = True
                self.events.append({"event": "device_return",
                                    "device": dev})
        if grew:
            self._reshard()

    # ---- brownout ------------------------------------------------------

    def _update_brownout(self, queue_len: int):
        """Step the brownout ladder one level per tick toward the pressure
        target: +1 while capacity is down (an evicted device, the
        straggler cap halving) or the queue is past a watermark, -1 as it
        returns."""
        if self.brownout is None:
            return
        qfrac = queue_len / max(1, self.queue_depth)
        pressure = (2 if qfrac >= self.brownout.high_watermark
                    else 1 if qfrac >= self.brownout.low_watermark else 0)
        target = min(len(_BROWNOUT_LADDER),
                     (1 if self._evicted else 0)
                     + (1 if self._bucket_cap < self.max_batch else 0)
                     + pressure)
        if target > self._brownout_level:
            self._brownout_level += 1
            self.events.append({"event": "brownout_up",
                                "level": self._brownout_level,
                                "target": target, "queue": queue_len})
        elif target < self._brownout_level:
            self._brownout_level -= 1
            self.events.append({"event": "brownout_down",
                                "level": self._brownout_level,
                                "target": target, "queue": queue_len})

    def _apply_brownout(self, req: _SortRequest, now: float):
        """Apply the current ladder level to a request at FIRST admission
        (never mid-anneal).  Requests with more than ``slack_full_s`` of
        deadline slack, or no deadline, take one level less."""
        if (self.brownout is None or self._brownout_level <= 0
                or req.orders is not None):
            return
        level = self._brownout_level
        slack = None if req.deadline is None else req.deadline - now
        if slack is None or slack > self.brownout.slack_full_s:
            level -= 1
        if level <= 0:
            return
        cfg = self._cfg_for(req)
        applied = []
        if (level >= 1 and self._cull_edges and self.n_restarts > 1
                and not req.brownout_cull):
            req.brownout_cull = True
            applied.append("culled")
        if level >= 2 and cfg.schedule != "adaptive":
            cfg = dataclasses.replace(cfg, schedule="adaptive")
            applied.append("adaptive")
        if level >= 3 and cfg.band is None:
            from repro_torch.core.shufflesoftsort import resolve_band
            auto = dataclasses.replace(cfg, band="auto")
            if resolve_band(auto, req.x.shape[0]) is not None:
                cfg = auto
                applied.append("banded")
        if level >= 4 and cfg.use_kernel and cfg.compute_dtype == "float32":
            cfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
            applied.append("bf16")
        if not applied:
            return
        if cfg is not self._cfg_for(req):
            req.cfg_override = cfg
        req.degraded = tuple(applied)
        for rung in applied:
            self.stats["degradations"][rung] += 1
        self.stats["brownouts"] += 1
        self.events.append({"event": "brownout_degrade", "seq": req.seq,
                            "level": self._brownout_level,
                            "applied": applied})

    # ---- handoff on disk ------------------------------------------------

    def _save_handoff(self, handoff: WarmHandoff):
        """Persist the handoff to ``checkpoint_dir`` (atomic, through
        ``CheckpointManager``): flat per-request arrays (the problem, the
        committed orders, the streams' state, losses, the controller) and
        a JSON manifest of the scalars."""
        from repro_torch.core.annealing import AdaptiveController
        from repro_torch.runtime.checkpoint import CheckpointManager
        now = time.monotonic()
        arrays: dict[str, np.ndarray] = {}
        metas = []
        for i, req in enumerate(handoff.requests):
            arrays[f"req{i}_x"] = req.x
            key_kind = None
            if isinstance(req.key, np.ndarray):
                arrays[f"req{i}_key_state"] = req.key
                key_kind = "raw"
            elif not isinstance(req.key, int):
                more, key_kind = _source_arrays(f"req{i}_key", req.key)
                arrays.update(more)
            has_state = req.orders is not None
            src_kind = None
            if has_state:
                arrays[f"req{i}_orders"] = req.orders
                arrays[f"req{i}_alive"] = req.alive
                arrays[f"req{i}_losses"] = req.losses
                more, src_kind = _source_arrays(f"req{i}_src", req.src)
                arrays.update(more)
                if req.done_mask is not None:
                    arrays[f"req{i}_done"] = req.done_mask
                if req.ctrl is not None:
                    for f in AdaptiveController._STATE_FIELDS:
                        arrays[f"req{i}_ctrl_{f}"] = getattr(req.ctrl, f)
            metas.append({
                "hw": list(req.hw), "d": int(req.d),
                "seed": req.key if isinstance(req.key, int) else None,
                "key_kind": key_kind, "src_kind": src_kind,
                "priority": int(req.priority), "seq": int(req.seq),
                "progress": int(req.progress),
                "attempts": int(req.attempts),
                "norm": None if req.norm is None else float(req.norm),
                "deadline_left": (None if req.deadline is None
                                  else max(0.0, req.deadline - now)),
                "has_state": has_state,
                "has_ctrl": req.ctrl is not None,
                "has_done": req.done_mask is not None,
                "strikes": int(req.strikes),
                "guardrail": (None if req.guardrail is None
                              else dataclasses.asdict(req.guardrail)),
                "cfg_override": (None if req.cfg_override is None
                                 else dataclasses.asdict(req.cfg_override)),
                "degraded": list(req.degraded),
                "brownout_cull": bool(req.brownout_cull),
            })
        mgr = CheckpointManager(self.checkpoint_dir, keep=1,
                                async_save=False)
        mgr.save(0, arrays, extra={
            "kind": "sort-server-handoff",
            "rng_state": handoff.rng_state,
            "seq": int(handoff.seq),
            "requests": metas,
            "injector_state": handoff.injector_state,
            "brownout_level": int(handoff.brownout_level),
            "evicted_devices": [int(dv) for dv in
                                handoff.evicted_devices],
            "health_state": handoff.health_state,
        })

    def _load_handoff(self, path: str) -> WarmHandoff:
        """Rebuild a ``WarmHandoff`` persisted by ``_save_handoff``, its
        streams on this server's device.  Requests get FRESH futures (the
        writer's died with its process), exposed on ``self.resumed``."""
        from repro_torch.core.annealing import AdaptiveController
        from repro_torch.core.shufflesoftsort import (
            ShuffleSoftSortConfig,
            make_adaptive_controller,
        )
        from repro_torch.runtime.checkpoint import CheckpointManager
        from repro_torch.runtime.guardrails import GuardrailPolicy
        mgr = CheckpointManager(path, keep=1, async_save=False)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no server handoff in {path}")
        extra = mgr.manifest(step).get("extra", {})
        if extra.get("kind") != "sort-server-handoff":
            raise ValueError(
                f"{path} step {step} is not a SortServer handoff "
                f"(kind={extra.get('kind')!r})")
        metas = extra["requests"]
        names: list[str] = []
        for i, m in enumerate(metas):
            names.append(f"req{i}_x")
            for prefix, kind in ((f"req{i}_key", m["key_kind"]),
                                 (f"req{i}_src", m["src_kind"])):
                if kind is not None:
                    names.append(f"{prefix}_state")
                    if kind == "replay":
                        names.append(f"{prefix}_shuffles")
            if m["has_state"]:
                names += [f"req{i}_orders", f"req{i}_alive",
                          f"req{i}_losses"]
                if m["has_done"]:
                    names.append(f"req{i}_done")
                if m["has_ctrl"]:
                    names += [f"req{i}_ctrl_{f}"
                              for f in AdaptiveController._STATE_FIELDS]
        # int placeholder leaves carry no dtype: the arrays come back as
        # they were saved.
        arrays, _ = mgr.restore({k: 0 for k in names}, step)
        now = time.monotonic()
        reqs = []
        for i, m in enumerate(metas):
            x = arrays[f"req{i}_x"]
            n = x.shape[0]
            key = (m["seed"] if m["key_kind"] is None else
                   arrays[f"req{i}_key_state"] if m["key_kind"] == "raw"
                   else _source_from(f"req{i}_key", m["key_kind"], arrays,
                                     n, self.device))
            req = _SortRequest(
                x=x, hw=tuple(m["hw"]), d=int(m["d"]), key=key,
                future=Future(), priority=int(m["priority"]),
                seq=int(m["seq"]),
                deadline=(None if m["deadline_left"] is None
                          else now + float(m["deadline_left"])),
                submitted=now, progress=int(m["progress"]),
                attempts=int(m["attempts"]), norm=m["norm"])
            req.strikes = int(m["strikes"])
            req.degraded = tuple(m["degraded"])
            req.brownout_cull = bool(m["brownout_cull"])
            if m["guardrail"] is not None:
                req.guardrail = GuardrailPolicy(**m["guardrail"])
            if m["cfg_override"] is not None:
                req.cfg_override = ShuffleSoftSortConfig(
                    **m["cfg_override"])
            if m["has_state"]:
                req.orders = arrays[f"req{i}_orders"]
                req.alive = arrays[f"req{i}_alive"]
                req.losses = arrays[f"req{i}_losses"]
                req.src = _source_from(f"req{i}_src", m["src_kind"], arrays,
                                       n, self.device)
                if m["has_done"]:
                    req.done_mask = arrays[f"req{i}_done"].astype(bool)
                if m["has_ctrl"]:
                    ctrl = make_adaptive_controller(
                        self._cfg_for(req), len(req.losses), n,
                        seg_len=self.seg_len)
                    ctrl.load_state_dict(
                        {f: arrays[f"req{i}_ctrl_{f}"]
                         for f in AdaptiveController._STATE_FIELDS})
                    req.ctrl = ctrl
            reqs.append(req)
        return WarmHandoff(requests=reqs, rng_state=extra["rng_state"],
                           seq=int(extra["seq"]),
                           injector_state=extra["injector_state"],
                           brownout_level=int(extra["brownout_level"]),
                           evicted_devices=tuple(extra["evicted_devices"]),
                           health_state=extra["health_state"])

    # ---- resolution bookkeeping (every future resolves exactly once) ----

    def _resolve_ok(self, req: _SortRequest, result):
        if req.future.done():       # pragma: no cover - defensive
            return
        self.stats["completed"] += 1
        if req.attempts > 0:
            self.stats["recoveries"] += 1
        latency_ms = (time.monotonic() - req.submitted) * 1e3
        self.stats["latencies_ms"].append(latency_ms)
        self.events.append({"event": "complete", "seq": req.seq,
                            "latency_ms": latency_ms,
                            "attempts": req.attempts})
        req.future.set_result(result)

    def _resolve_exc(self, req: _SortRequest, exc: Exception, counter: str):
        if req.future.done():       # pragma: no cover - defensive
            return
        self.stats[counter] += 1
        self.events.append({"event": counter, "seq": req.seq})
        req.future.set_exception(exc)

    def _reject_all(self, exc: Exception):
        with self._cv:
            doomed = self._pending + self._active
            self._pending, self._active = [], []
        for req in doomed:
            if not req.future.done():
                self._resolve_exc(req, exc, "failed")

    # ---- scheduler -------------------------------------------------------

    def _run(self):
        while True:
            with self._cv:
                while (not self._stop and not self._pending
                       and not self._active):
                    self._cv.wait(timeout=0.5)
                if self._stop:
                    break
                fresh_wake = not self._active
            if fresh_wake and self.max_wait_s > 0:
                time.sleep(self.max_wait_s)   # let a submit burst coalesce
            try:
                did_work = self._tick()
            except Exception as e:  # pragma: no cover - defensive
                # A scheduler bug must never strand futures: fail
                # everything in flight (typed) and keep serving.
                err = RequestFailed(f"scheduler error: {e!r}")
                err.__cause__ = e
                self._reject_all(err)
                continue
            if not did_work:
                time.sleep(0.02)              # pending all in backoff
        # A preempted server leaves its requests for close(drain=False).
        if not self._preempt:
            self._reject_all(ServerClosed("SortServer closed"))

    def _admit(self, req: _SortRequest):
        """First admission: the request's streams, norm and engine state
        on the device.  Restart 0 draws from the key's own seed (or raw
        key), so a one-restart result reproduces that key's solo run;
        re-admissions after a fault keep their committed state."""
        if req.x_dev is None:
            req.x_dev = torch.as_tensor(req.x, device=self.device)
        if req.orders is not None:
            return
        from repro_torch.core.losses import mean_pairwise_distance
        from repro_torch.core.prng import (ThreefryShuffleSource,
                                           TorchShuffleSource,
                                           instance_seeds)
        s, n = self.n_restarts, req.x.shape[0]
        if isinstance(req.key, int):
            seeds = [req.key] + instance_seeds(req.key, s)[1:]
            req.src = TorchShuffleSource(seeds, n, self.device)
        elif isinstance(req.key, np.ndarray):
            req.src = ThreefryShuffleSource(
                restart_keys(req.key, s, self.device), n, self.device)
        else:
            req.src = req.key.take(None)
        req.norm = float(mean_pairwise_distance(req.x_dev))
        req.orders = np.tile(np.arange(n, dtype=np.int32), (s, 1))
        req.alive = np.arange(s)
        req.losses = np.full((s, self.cfg.rounds), np.nan, np.float32)
        # Adaptivity is per REQUEST config: a brownout rung can force it.
        cfg_req = self._cfg_for(req)
        if cfg_req.schedule == "adaptive":
            from repro_torch.core.shufflesoftsort import (
                make_adaptive_controller)
            req.ctrl = make_adaptive_controller(
                cfg_req, s, n, seg_len=self.seg_len)
            req.done_mask = np.zeros(s, bool)
        self.events.append({"event": "admit", "seq": req.seq})

    def _cfg_for(self, req: _SortRequest):
        """The config this request dispatches under: the server config,
        unless a self-heal or the brownout installed an override."""
        return self.cfg if req.cfg_override is None else req.cfg_override

    def _regime(self, req: _SortRequest) -> str:
        from repro_torch.core.shufflesoftsort import (
            resolve_band,
            rung_aligned_switch,
        )
        cfg = self._cfg_for(req)
        n = req.x.shape[0]
        if resolve_band(cfg, n) is None:
            return "dense"
        if req.ctrl is not None:
            # The measured switch: banded once every live restart's own
            # tail bound has cleared (with one restart, the engine's
            # per-instance rule).
            live = req.alive[~req.done_mask]
            return ("banded" if live.size and req.ctrl.banded[live].all()
                    else "dense")
        ck = (n, cfg)
        if ck not in self._switch_cache:
            self._switch_cache[ck] = rung_aligned_switch(
                cfg, n, self.seg_len)
        return "banded" if req.progress >= self._switch_cache[ck] else "dense"

    def _tick(self) -> bool:
        """One scheduler pass: grow back returned slots, step the brownout
        ladder, shed expired, admit (applying the ladder), dispatch one
        rung per (shape bucket, regime) group, cull, finalize."""
        now = time.monotonic()
        self._poll_device_returns()
        with self._cv:
            self._update_brownout(len(self._pending))
        admitted: list[_SortRequest] = []
        with self._cv:
            keep = []
            for req in self._pending:
                if req.deadline is not None and now > req.deadline:
                    self._resolve_exc(
                        req, DeadlineExceeded(
                            f"deadline passed while queued (seq {req.seq})"),
                        "deadline_missed")
                else:
                    keep.append(req)
            keep.sort(key=lambda r: (-r.priority, r.seq))
            active_inst = sum(r.n_live for r in self._active)
            rest = []
            for req in keep:
                need = req.n_live
                fits = (active_inst + need <= self.max_active
                        or (active_inst == 0 and not admitted))
                if now >= req.eligible_at and fits:
                    admitted.append(req)
                    active_inst += need
                else:
                    rest.append(req)
            self._pending = rest
        try:
            for req in admitted:
                self._apply_brownout(req, now)
                self._admit(req)
        except Exception as e:
            # The tick's admissions have left _pending and are not yet in
            # _active: fail them here, typed, or no one ever resolves them.
            err = RequestFailed(f"admission failed: {e!r}")
            err.__cause__ = e
            for req in admitted:
                self._resolve_exc(req, err, "failed")
            admitted = []
        self._active.extend(admitted)
        if not self._active:
            return False

        # shed expired active requests at the round boundary
        still = []
        for req in self._active:
            if req.deadline is not None and now > req.deadline:
                self._resolve_exc(
                    req, DeadlineExceeded(
                        f"deadline passed at round {req.progress} "
                        f"(seq {req.seq})"),
                    "deadline_missed")
            else:
                still.append(req)
        self._active = still

        groups: dict[tuple, list[_SortRequest]] = {}
        for req in self._active:
            # One dispatch shares a config, a probe policy and a stream
            # kind (one stacked shuffle source).
            groups.setdefault(
                ((req.hw, req.d), self._regime(req),
                 req.guardrail, req.cfg_override, req.src.kind),
                []).append(req)
        for (_sig, regime, _pol, _ovr, _kind), reqs in groups.items():
            chunk: list[_SortRequest] = []
            size = 0
            for req in reqs:
                if chunk and size + req.n_live > self._bucket_cap:
                    self._dispatch(chunk, regime)
                    chunk, size = [], 0
                chunk.append(req)
                size += req.n_live
            if chunk:
                self._dispatch(chunk, regime)
        return True

    def _dispatch(self, reqs: list[_SortRequest], regime: str):
        """One coalesced device call advancing ``reqs`` by one rung.

        Adaptive mode dispatches only each request's LIVE restarts, at
        their controller's schedule positions.  The batch pads to its
        power-of-two bucket with copies of its first row (its stream
        state too: the copies draw the same shuffles and are dropped).
        """
        from repro_torch.core.prng import stack_sources
        from repro_torch.runtime.checkpoint import _host
        hw = reqs[0].hw
        cfg_use = self._cfg_for(reqs[0])   # uniform per group (key'd)
        adaptive = cfg_use.schedule == "adaptive"
        pol = reqs[0].guardrail
        guarded = pol is not None and pol.mode != "off"
        sels = [np.flatnonzero(~r.done_mask) if adaptive
                else np.arange(len(r.alive)) for r in reqs]
        bs = sum(len(sel) for sel in sels)
        bucket = (min(_next_pow2(bs), self.max_batch)
                  if bs <= self.max_batch else _next_pow2(bs))
        rows = [(r, int(i)) for r, sel in zip(reqs, sels) for i in sel]
        rows += [rows[0]] * (bucket - bs)
        xs = torch.stack([r.x_dev for r, _ in rows])
        orders = np.stack([r.orders[i] for r, i in rows])
        norms = np.array([r.norm for r, _ in rows], np.float32)
        if adaptive:
            progress = np.array([r.ctrl.pos[r.alive[i]] for r, i in rows],
                                np.int64)
        else:
            progress = np.array([r.progress for r, _ in rows], np.int64)
        src = stack_sources([r.src.take([i]) for r, i in rows])
        s_in = src.state_dict()
        slots = 0 if self.mesh is None else len(self.mesh)
        signature = (hw, reqs[0].d, regime, bucket, self.seg_len, slots)
        self.stats["compile_keys"].add(signature)
        kw = dict(source=src, hw=hw, cfg=cfg_use, device=self.device)
        if self.mesh is not None:
            kw["mesh"] = self.mesh
        if adaptive:
            # regime= bypasses the model-based switch check (the
            # controller owns the grouping); with_w= feeds the measured
            # tail bound.
            kw.update(regime=regime, with_w=True)

        t0 = time.perf_counter()
        try:
            out = self._engine(xs, orders, norms, progress, self.seg_len,
                               **kw)
            o, l = _host(out[0]).astype(np.int32), _host(out[1])
            w = _host(out[2]) if adaptive else None
        except Exception as e:
            if not self._device_failure(reqs, e):
                self._on_failure(reqs, e)
            return
        if self.device_health is not None and self.mesh is not None:
            self.device_health.record_success(self.mesh.ids)
        s_out = src.state_dict()
        # Divergence sentinel: a non-finite loss (or key) never commits.
        # Guarded groups attribute it per request slice instead (the
        # monitor's "finite" probe), so one corrupted request never fails
        # its clean batchmates.
        if not guarded and (
                not np.isfinite(l).all()
                or (adaptive and not np.isfinite(w).all())):
            from repro_torch.core.shufflesoftsort import NumericalDivergence
            self._on_failure(reqs, NumericalDivergence(
                f"non-finite loss in serving dispatch (regime {regime})",
                round=int(progress[:bs].min()),
                dtype=str(cfg_use.compute_dtype), context="serving"))
            return
        dt = time.perf_counter() - t0
        self.stats["dispatch_s"] += dt
        self._record_timing(dt, signature)
        self.stats["batches"] += 1
        self.stats["batch_sizes"].append(bs)

        bad: list = []
        if guarded:
            t1 = time.perf_counter()
            bad = self._verify_slices(
                reqs, sels, regime, cfg_use, hw, xs, orders, norms,
                progress, src, s_in, s_out, o, l, w)
            self.stats["probe_s"] += time.perf_counter() - t1
        bad_set = {id(r) for r, _ in bad}
        off = 0
        for req, sel in zip(reqs, sels):
            nl = len(sel)
            if id(req) in bad_set:
                off += nl           # corrupted: do NOT commit; the
                continue            # retry replays this rung exactly
            st = req.src.state_dict()
            st[sel] = s_out[off:off + nl]
            req.src.load_state_dict(st)
            req.orders[sel] = o[off:off + nl]
            if adaptive:
                orig = req.alive[sel]
                exec0 = int(req.ctrl.executed[orig[0]])
                seg_losses = l[:, off:off + nl].T        # (nl, seg)
                req.losses[orig, exec0:exec0 + self.seg_len] = seg_losses
                # Controller state commits only on a verified dispatch, so
                # a retried request re-observes nothing.
                req.ctrl.observe(orig, seg_losses, w[off:off + nl])
                req.done_mask[sel] = req.ctrl.done[orig]
            else:
                req.losses[req.alive,
                           req.progress:req.progress + self.seg_len] = (
                    l[:, off:off + nl].T)
            req.progress += self.seg_len
            off += nl
            self._post_rung(req)
        for req, exc in bad:
            self._integrity_failure(req, exc)

    # ---- guardrails: per-request verification + self-healing ------------

    def _verify_slices(self, reqs, sels, regime, cfg_use, hw, xs, orders,
                       norms, progress, src, s_in, s_out, o, l, w):
        """This dispatch's probes per request slice, BEFORE any commit.
        Returns ``[(req, IntegrityViolation), ...]`` for the slices that
        failed: only those re-queue; their clean batchmates commit.

        The shadow (``_shadow_checks``, the engines' helper) replays the
        WHOLE padded dispatch once, through ``run_round_segment`` itself
        (never ``self._engine``: chaos tests wrap the engine, the replay
        must stay clean), on the dispatch's tier and mesh from its inputs
        and a fork of its stacked source; each sampled slice is held to its rows
        of the replay bitwise, and on the kernel tier to its rows of the
        apply check.  Replaying the whole batch keeps the replay bitwise
        where a smaller batch would not be (the CPU twins' batched
        backward, ROADMAP.md Queue C6)."""
        from repro_torch.core.shufflesoftsort import (
            _shadow_checks,
            _tau_schedule,
            resolve_band,
            run_round_segment,
        )
        from repro_torch.runtime.guardrails import (
            GuardrailMonitor,
            IntegrityViolation,
        )
        taus = _tau_schedule(cfg_use)
        monitors, starts, spans = [], [], []
        off = 0
        for req, sel in zip(reqs, sels):
            mon = req.monitor
            if mon is None or mon.policy is not req.guardrail:
                mon = req.monitor = GuardrailMonitor(
                    req.guardrail, context="serving",
                    dtype=cfg_use.compute_dtype)
            monitors.append(mon)
            starts.append(int(progress[off:off + len(sel)].min()))
            spans.append(slice(off, off + len(sel)))
            off += len(sel)
        shadow = None
        if any(m.wants_shadow(st) for m, st in zip(monitors, starts)):
            kw = ({"regime": regime} if cfg_use.schedule == "adaptive"
                  else {})
            if self.mesh is not None:       # the dispatch's own layout
                kw["mesh"] = self.mesh
            band = (resolve_band(cfg_use, xs.shape[1])
                    if regime == "banded" else None)
            shadow = _shadow_checks(
                cfg_use, lambda: run_round_segment(
                    xs, orders, norms, progress, self.seg_len,
                    source=src.fork(s_in), hw=hw, cfg=cfg_use,
                    device=self.device, with_w=True, **kw),
                xs, [(np.arange(len(progress)), band,
                      taus[progress + self.seg_len - 1])])
        bad = []
        for req, mon, start, sl in zip(reqs, monitors, starts, spans):
            try:
                # Adaptive w rows must be finite before ctrl.observe: the
                # unguarded sentinel is skipped for guarded groups.
                if w is not None and not np.isfinite(w[sl]).all():
                    mon._fail("finite",
                              "non-finite soft-sort keys in serving "
                              f"dispatch at round {start}", round=start)
                sh = {}
                if shadow is not None and mon.wants_shadow(start):
                    o_sh, l_sh, errors = shadow
                    sh = dict(oracle_orders=o_sh[sl],
                              oracle_losses=l_sh[:, sl],
                              apply_errors=None if errors is None else
                              {q: float(np.max(e[sl]))
                               for q, e in errors.items()})
                band = None
                if regime == "banded" and req.ctrl is not None:
                    band = req.ctrl.band
                rows = np.arange(sl.start, sl.stop)
                mon.check_rung(
                    start=start, losses=l[:, sl], orders=o[sl],
                    n=req.x.shape[0], source=src.take(rows),
                    stream_in=s_in[sl], stream_out=s_out[sl],
                    seg_len=self.seg_len,
                    ws=None if w is None else w[sl],
                    tau=taus[progress[sl]], band=band, **sh)
            except IntegrityViolation as e:
                bad.append((req, e))
        return bad

    def _integrity_failure(self, req: _SortRequest, exc):
        """Remediation for a probe failure on one request: record the
        incident, count a strike, and past the policy's ``heal_after``
        budget consume a ``DivergencePolicy`` rung as a per-request config
        override (kernel -> plain tier, band widening, dtype promotion);
        then re-queue the request from its last verified boundary."""
        rec = exc.incident() if hasattr(exc, "incident") else {
            "probe": None, "message": str(exc)}
        rec["seq"] = int(req.seq)
        self.stats["integrity_violations"] += 1
        self.stats["integrity_incidents"].append(rec)
        self.events.append({"event": "integrity", "seq": req.seq,
                            "probe": getattr(exc, "probe", None),
                            "round": getattr(exc, "round", None)})
        req.strikes += 1
        if req.strikes > req.guardrail.heal_after:
            step = self.degrade.apply(self._cfg_for(req), exc)
            if step is not None:
                healed, note = step
                req.cfg_override = healed
                req.monitor = None      # dtype/config may have changed
                req.strikes = 0
                self.stats["self_heals"] += 1
                self.events.append({"event": "self_heal",
                                    "seq": req.seq, "action": note})
        self._on_failure([req], exc)

    def _post_rung(self, req: _SortRequest):
        """Rung-boundary bookkeeping: tournament cull, then finalize.

        Adaptive mode ranks every not-yet-culled restart by its
        LAST-EXECUTED loss and finalizes the request at the first boundary
        where no restart is still annealing."""
        from repro_torch.core.shufflesoftsort import _tournament_cull
        s_k = len(req.alive)
        if req.progress in self._cull_edges and s_k > 1:
            keep = (1 if req.brownout_cull else
                    max(1, int(np.ceil(s_k * (1.0 - self.cull_fraction)))))
            if keep < s_k:
                if req.ctrl is not None:
                    last = req.ctrl.executed[req.alive] - 1
                    final = req.losses[req.alive, last][None, :]
                else:
                    final = req.losses[req.alive, req.progress - 1][None, :]
                sel = _tournament_cull(final, keep)[0]
                if req.ctrl is not None:
                    kept = np.zeros(s_k, bool)
                    kept[sel] = True
                    req.ctrl.mark_culled(req.alive[~kept])
                    req.done_mask = req.done_mask[sel]
                req.alive = req.alive[sel]
                req.orders = req.orders[sel]
                req.src = req.src.take(sel)
                self.stats["culled"] += s_k - keep
                self.events.append({"event": "cull", "seq": req.seq,
                                    "kept": keep, "of": s_k})
        if req.ctrl is not None:
            if req.done_mask.all():
                last = req.ctrl.executed[req.alive] - 1
                final = req.losses[req.alive, last]
                win = int(np.argmin(final))
                order = req.orders[win]
                saved = self.cfg.rounds - int(
                    req.ctrl.executed[req.alive].max())
                if saved > 0:
                    self.stats["adaptive_exits"] += 1
                    self.stats["rounds_saved"] += saved
                    self.events.append(
                        {"event": "adaptive_exit", "seq": req.seq,
                         "round": self.cfg.rounds - saved,
                         "saved": saved})
                self._active.remove(req)
                self._resolve_ok(
                    req, (order, req.x[order], req.losses[req.alive[win]]))
            return
        if req.progress >= self.cfg.rounds:
            final = req.losses[req.alive, -1]
            win = int(np.argmin(final))
            order = req.orders[win]
            self._active.remove(req)
            self._resolve_ok(
                req, (order, req.x[order], req.losses[req.alive[win]]))

    def _on_failure(self, reqs: list[_SortRequest], exc: Exception):
        """Restart semantics for a failed dispatch: each request re-queues
        from its last committed round boundary with exponential backoff,
        until its budget runs out."""
        now = time.monotonic()
        for req in reqs:
            req.attempts += 1
            self._active.remove(req)
            if req.attempts > self.retry.max_retries:
                err = RequestFailed(
                    f"dispatch failed {req.attempts} times "
                    f"(budget {self.retry.max_retries}): {exc}")
                err.__cause__ = exc
                self._resolve_exc(req, err, "failed")
                continue
            backoff = self.retry.backoff(req.attempts)
            req.eligible_at = now + backoff
            self.stats["retries"] += 1
            self.events.append({"event": "retry", "seq": req.seq,
                                "attempt": req.attempts,
                                "backoff_s": backoff,
                                "error": str(exc)})
            with self._cv:
                self._pending.append(req)

    def _record_timing(self, dt: float, signature):
        """Judge a dispatch and adapt the bucket cap: flag -> halve,
        healthy streak -> restore.  The straggler monitor gets ``dt`` over
        the mean seconds of the dispatch's ``signature`` (shape, regime,
        rung length, mesh slots, bucket; ``DispatchCost``); a signature's
        first dispatch is learnt from, not judged.  Only unflagged
        dispatches teach the cost model."""
        expected = self._cost.expected(signature)
        flagged = expected is not None and self.straggler.record(
            self._dispatch_idx, dt / max(expected, 1e-12))
        self._dispatch_idx += 1
        if not flagged:
            self._cost.observe(signature, dt)
        if flagged:
            self.stats["stragglers"] += 1
            cap_before = self._bucket_cap
            self._bucket_cap = max(1, self._bucket_cap // 2)
            self._healthy_streak = 0
            self.events.append({"event": "straggler", "dt_s": dt,
                                "expected_s": expected,
                                "cap_before": cap_before,
                                "bucket_cap": self._bucket_cap})
        else:
            self._healthy_streak += 1
            if (self._healthy_streak >= self.straggler_recovery
                    and self._bucket_cap < self.max_batch):
                self._bucket_cap = min(self.max_batch,
                                       self._bucket_cap * 2)
                self._healthy_streak = 0


# --------------------------------------------------------------------------
# CLI.
# --------------------------------------------------------------------------

def _parse_band(value):
    """CLI ``--band`` -> ShuffleSoftSortConfig.band: "none" (or unset) =
    always dense, "auto" = auto-sized band, an integer = half-width K."""
    if value is None or value == "none":
        return None
    if value == "auto":
        return "auto"
    return int(value)


def serve_sorts(args):
    """The CLI: fire concurrent sort requests at a SortServer and print
    the accounting line."""
    from repro_torch.core import threefry
    from repro_torch.core.metrics import mean_neighbor_distance
    from repro_torch.core.shufflesoftsort import ShuffleSoftSortConfig
    from repro_torch.launch.mesh import make_sort_mesh
    from repro_torch.runtime.guardrails import GuardrailPolicy
    from repro_torch.runtime.straggler import DeviceHealthMonitor

    guardrail = (None if args.guardrail == "off" else
                 GuardrailPolicy(mode=args.guardrail,
                                 shadow_rate=args.shadow_rate,
                                 seed=args.seed))
    brownout = BrownoutPolicy() if args.brownout else None
    device_health = (DeviceHealthMonitor(lost_after=args.device_health)
                     if args.device_health else None)
    mesh = None
    if args.mesh_devices:
        # --device names one device for every slot; without it the
        # slots are the first D cards.
        mesh = make_sort_mesh(
            args.mesh_devices,
            devices=None if args.device is None
            else [args.device] * args.mesh_devices)
    hw = (args.sort_hw, args.sort_n // args.sort_hw)
    cfg = ShuffleSoftSortConfig(rounds=args.rounds,
                                chunk=min(256, args.sort_n),
                                use_kernel=args.use_kernel,
                                band=_parse_band(args.band),
                                compute_dtype=args.dtype,
                                schedule=args.schedule)
    server = SortServer(hw, d=args.sort_d, cfg=cfg,
                        max_batch=args.max_batch, max_wait_ms=args.wait_ms,
                        n_restarts=args.restarts, mesh=mesh,
                        tournament_rungs=args.tournament_rungs,
                        cull_fraction=args.cull_fraction,
                        queue_depth=args.queue_depth,
                        sched_rungs=args.sched_rungs or None,
                        seed=args.seed, guardrail=guardrail,
                        brownout=brownout, device_health=device_health,
                        device=args.device)
    rng = np.random.RandomState(0)
    xs = rng.rand(args.requests, args.sort_n, args.sort_d).astype(np.float32)

    t0 = time.time()
    futs, shed = [], 0
    for i in range(args.requests):
        try:
            futs.append(server.submit(xs[i], key=threefry.prng_key(i)))
        except QueueFull:
            shed += 1
    results, outcomes = [], {"completed": 0, "failed": 0,
                             "deadline_missed": 0}
    for f, x in zip(futs, xs):
        try:
            results.append((f.result(timeout=600), x))
            outcomes["completed"] += 1
        except DeadlineExceeded:
            outcomes["deadline_missed"] += 1
        except RequestRejected:
            outcomes["failed"] += 1
    wall = time.time() - t0
    server.close()

    improved = sum(
        mean_neighbor_distance(r[1], hw) < mean_neighbor_distance(x, hw)
        for r, x in results)
    sps = len(results) / max(wall, 1e-9)
    sizes = server.stats["batch_sizes"]
    lat = np.asarray(server.stats["latencies_ms"], np.float64)
    p50 = float(np.percentile(lat, 50)) if lat.size else 0.0
    p99 = float(np.percentile(lat, 99)) if lat.size else 0.0
    adaptive_note = ""
    if cfg.schedule == "adaptive":
        adaptive_note = (
            f"; adaptive: {server.stats['adaptive_exits']} early exits, "
            f"{server.stats['rounds_saved']} rounds saved")
    guard_note = ""
    if guardrail is not None:
        guard_note = (
            f"; guardrail {guardrail.mode}: "
            f"{server.stats['integrity_violations']} violations, "
            f"{server.stats['self_heals']} self-heals")
    deg = server.stats["degradations"]
    brownout_note = ""
    if device_health is not None:
        brownout_note += (
            f"; elastic: {server.stats['evictions']} evictions, "
            f"{server.stats['reshards']} reshards, "
            f"{server.stats['device_returns']} returns")
    if brownout is not None:
        brownout_note += "; degradations " + " ".join(
            f"{r}={deg[r]}" for r in _BROWNOUT_LADDER)
    where = (server.device if mesh is None
             else f"{len(mesh)} mesh slots of {server.device}")
    print(f"served {args.requests} sort requests on {where} in "
          f"{wall:.2f}s ({sps:.2f} sorts/s) across "
          f"{server.stats['batches']} device batches (sizes {sizes}); "
          f"p50 {p50:.1f}ms p99 {p99:.1f}ms; "
          f"{improved}/{len(results)} layouts improved; accounting "
          f"completed {outcomes['completed']} + failed "
          f"{outcomes['failed']} + deadline_missed "
          f"{outcomes['deadline_missed']} + queue_rejected {shed} == "
          f"offered {args.requests}"
          f"{adaptive_note}{guard_note}{brownout_note}")
    return {"sorts_per_s": sps, "batches": server.stats["batches"],
            "improved": int(improved), "p50_ms": p50, "p99_ms": p99,
            "offered": args.requests, "queue_rejected": shed, **outcomes,
            "adaptive_exits": server.stats["adaptive_exits"],
            "rounds_saved": server.stats["rounds_saved"],
            "integrity_violations": server.stats["integrity_violations"],
            "self_heals": server.stats["self_heals"],
            "evictions": server.stats["evictions"],
            "reshards": server.stats["reshards"],
            "device_returns": server.stats["device_returns"],
            "degradations": dict(deg)}


# --------------------------------------------------------------------------
# LM decode serving.
# --------------------------------------------------------------------------

def lm_prompts(cfg, requests: int, prompt_len: int):
    """The reference CLI's prompts, from ``np.random.RandomState(0)``: the
    drawn lengths only set ``max_len``, and every row is ``max_len``
    tokens.  Returns (prompts (requests, max_len) int32, max_len)."""
    rng = np.random.RandomState(0)
    lens = rng.randint(4, prompt_len + 1, size=requests)
    max_len = int(lens.max())
    prompts = rng.randint(0, cfg.vocab_size,
                          size=(requests, max_len)).astype(np.int32)
    return prompts, max_len


def lm_context(cfg, requests: int, device):
    """The stub modality context of a vlm or audio model (zeros, as the
    reference CLI's), or None."""
    if cfg.family == "vlm":
        return torch.zeros(requests, cfg.vision_tokens, cfg.vision_d,
                           device=device)
    if cfg.is_encdec:
        return torch.zeros(requests, cfg.audio_frames, cfg.d_model,
                           device=device)
    return None


def pad_caches(caches, extra: int):
    """The attention caches padded with ``extra`` zero positions along the
    sequence; SSM caches as they are."""
    from repro_torch.models.attention import KVCache
    return [KVCache(*(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, extra))
                      for t in c)) if isinstance(c, KVCache) else c
            for c in caches]


def serve_lm(cfg, requests: int = 8, max_new: int = 32, prompt_len: int = 24,
             device=None, model=None):
    """Serve ``requests`` LM requests as the reference CLI does: the
    reference's prompts, one prefill of the right-padded batch, the caches
    padded to ``max_len + max_new``, then ``max_new - 1`` greedy decode
    steps (a vlm or audio model encodes its context again at each step).

    ``model`` defaults to ``init_model(cfg, device)``; ``device`` to CUDA
    (an error without it).  Returns ``tok_per_s`` and ``prefill_s`` (host
    seconds, ended by a device sync), ``decode_s``, ``tokens`` (requests,
    max_new) int64 numpy, each step's ``logits`` (requests, 1, V) float32
    on the device, ``prompts``, ``max_len`` and ``device``."""
    from repro_torch.core.shufflesoftsort import resolve_device
    from repro_torch.models import decode_step, init_model, prefill

    device = resolve_device(device)
    model = init_model(cfg, device) if model is None else model

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    prompts, max_len = lm_prompts(cfg, requests, prompt_len)
    ctx = lm_context(cfg, requests, device)
    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, caches = prefill(model, torch.from_numpy(prompts).to(
            device, torch.long), ctx)
        caches = pad_caches(caches, max_new)
        sync()
        prefill_s = time.perf_counter() - t0

        tok = logits.argmax(-1)                                 # (B, 1)
        out_tokens, out_logits = [tok], [logits]
        t0 = time.perf_counter()
        for i in range(max_new - 1):
            logits, caches = decode_step(model, tok, caches, max_len + i,
                                         ctx)
            tok = logits.argmax(-1)
            out_tokens.append(tok)
            out_logits.append(logits)
        sync()
        decode_s = time.perf_counter() - t0
    gen = torch.cat(out_tokens, dim=1).cpu().numpy()

    tps = requests * (max_new - 1) / max(decode_s, 1e-9)
    print(f"served {requests} requests (prompt<= {max_len}) on {device}: "
          f"prefill {prefill_s:.2f}s, decode {decode_s:.2f}s "
          f"({tps:.1f} tok/s), output shape {gen.shape}")
    if gen.shape != (requests, max_new):
        raise RuntimeError(f"generated {gen.shape}, expected "
                           f"{(requests, max_new)}")
    if not (np.all(gen >= 0) and np.all(gen < cfg.vocab_size)):
        raise RuntimeError("a generated token lies outside the vocabulary")
    return {"tok_per_s": tps, "prefill_s": prefill_s, "decode_s": decode_s,
            "tokens": gen, "logits": out_logits, "prompts": prompts,
            "max_len": max_len, "device": str(device)}


def main(argv=None):
    from repro_torch.configs import get_config, list_archs
    from repro_torch.launch.train import PRESETS

    ap = argparse.ArgumentParser(
        description="Serve LM decode requests, or grid-sort requests with "
                    "the port's SortServer.")
    ap.add_argument("--workload", choices=("lm", "sort"), default="lm")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, an error without "
                         "it; 'cpu' runs on the host)")
    ap.add_argument("--arch", choices=list_archs(), default="qwen1.5-0.5b")
    ap.add_argument("--preset", choices=PRESETS, default="tiny")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=24)
    # sort-workload knobs
    ap.add_argument("--sort-n", type=int, default=256)
    ap.add_argument("--sort-hw", type=int, default=16,
                    help="grid height; width = sort-n / sort-hw")
    ap.add_argument("--sort-d", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--restarts", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--wait-ms", type=float, default=5.0)
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="shard coalesced batches over a mesh of this many "
                         "slots: the first D cards, or with --device D "
                         "slots of that one device (0 = no mesh)")
    ap.add_argument("--tournament-rungs", type=int, default=1,
                    help=">1 runs restarts as a successive-halving "
                         "tournament (needs --restarts > 1)")
    ap.add_argument("--cull-fraction", type=float, default=0.5)
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the SoftSort apply (fwd+bwd) through the "
                         "CUDA kernel tier instead of the plain PyTorch one")
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32",
                    help="kernel-tier compute precision (with "
                         "--use-kernel)")
    ap.add_argument("--band", default=None,
                    help="banded O(N*K) apply: an integer half-width K, "
                         "'auto', or 'none' (default) for the dense apply")
    ap.add_argument("--queue-depth", type=int, default=64,
                    help="admission-control bound: submits past this many "
                         "waiting requests raise QueueFull")
    ap.add_argument("--sched-rungs", type=int, default=0,
                    help="scheduler preemption quantum: split the round "
                         "schedule into this many rungs (0 = auto)")
    ap.add_argument("--schedule", choices=("fixed", "adaptive"),
                    default="fixed")
    ap.add_argument("--seed", type=int, default=0,
                    help="server-owned seed stream for requests submitted "
                         "without a key")
    ap.add_argument("--guardrail", choices=("off", "invariants", "shadow"),
                    default="off",
                    help="integrity probes at every rung boundary: "
                         "'invariants' runs the host-side checks, 'shadow' "
                         "adds the sampled same-tier replay and, on the "
                         "kernel tier, the kernel-vs-plain apply check")
    ap.add_argument("--shadow-rate", type=float, default=None,
                    help="fraction of rungs to shadow under --guardrail "
                         "shadow (default 1/32)")
    ap.add_argument("--brownout", action="store_true",
                    help="arm the overload brownout ladder")
    ap.add_argument("--device-health", type=int, default=0,
                    metavar="STRIKES",
                    help="evict a mesh slot after this many DeviceLost "
                         "dispatch failures and re-shard over the "
                         "survivors (0 = off; needs --mesh-devices)")
    args = ap.parse_args(argv)

    if args.workload == "lm":
        from repro_torch.models import reduced_config
        if args.requests < 1 or args.max_new < 1:
            ap.error("--requests and --max-new must be >= 1")
        if args.prompt_len < 4:
            ap.error(f"--prompt-len {args.prompt_len} must be >= 4 (prompt "
                     "lengths are drawn from [4, --prompt-len])")
        cfg = reduced_config(get_config(args.arch), **PRESETS[args.preset])
        return serve_lm(cfg, args.requests, args.max_new, args.prompt_len,
                        args.device)
    # CLI validation as argparse errors (exit 2), as the reference's.
    if args.sort_hw <= 0 or args.sort_n % args.sort_hw != 0:
        ap.error(f"--sort-hw {args.sort_hw} must be a positive "
                 f"divisor of --sort-n {args.sort_n} (grid height)")
    if args.dtype != "float32" and not args.use_kernel:
        ap.error("--dtype bfloat16 requires --use-kernel (the plain "
                 "apply tier has no bf16 mode)")
    if args.shadow_rate is not None and args.guardrail != "shadow":
        ap.error("--shadow-rate requires --guardrail shadow (the "
                 f"'{args.guardrail}' tier runs no shadow)")
    if args.shadow_rate is not None and not (
            0.0 <= args.shadow_rate <= 1.0):
        ap.error(f"--shadow-rate {args.shadow_rate} must be in [0, 1]")
    if args.shadow_rate is None:
        args.shadow_rate = 0.03125
    if args.mesh_devices < 0:
        ap.error(f"--mesh-devices {args.mesh_devices} must be >= 0")
    if args.device_health < 0:
        ap.error(f"--device-health {args.device_health} must be >= 0 "
                 "(strike budget; 0 disables)")
    if args.device_health and not args.mesh_devices:
        ap.error("--device-health needs --mesh-devices (eviction re-shards "
                 "a mesh; without one there is no slot to lose)")
    return serve_sorts(args)


if __name__ == "__main__":
    main()

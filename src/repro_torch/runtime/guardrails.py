"""Permutation-integrity guardrails: silent-corruption probes at rung
boundaries, the port's counterpart of ``repro.runtime.guardrails``.

The non-finite sentinel catches runs that explode; these probes catch a
run that finishes wrong: a kernel that returns a subtly corrupted buffer,
a banded tier whose real dropped softmax mass exceeds the analytic
``band_tail_bound``, a stream that skipped or repeated draws.  The output
contract is cheap to audit (a permutation of ``arange(N)`` and a loss per
round), so the engines do it at the rung boundaries where they already
bring state to the host.

Three probe families, in increasing cost:

* **Invariants** (mode ``"invariants"`` and up): committed orders are
  permutations, losses are finite and non-negative (the grid loss is a
  sum of squared distances), no explosion against the committed loss
  history, no bitwise-stale loss segment (a repeated buffer), and the
  **stream audit**: the shuffle source's state after the rung is its
  state before, advanced by exactly ``seg_len`` draws of the instances
  that ran (``ShuffleSource.advanced``: a cloned generator replays the
  draws, a replay source adds ``seg_len`` to ``pos``, a threefry source
  runs ``expected_key_chain``).  It keeps the
  reference's probe name ``key_chain``, whose counterpart audits JAX's
  split chain.
* **Band-tail audit**: where the rung's trained keys ``w`` are at hand
  (the adaptive engine, ``run_round_segment(with_w=True)``), the bound is
  evaluated on the live keys, and at sampled rungs the dropped mass is
  measured densely (``measured_dropped_mass``) and held under the bound.
* **Shadow** (mode ``"shadow"``): a hash of ``(policy.seed, rung
  start)`` samples ``shadow_rate`` of the rungs.  A sampled rung runs two
  checks, each raising ``probe="shadow"`` with a ``check`` field in the
  incident.  ``check="replay"``: the rung runs again on the tier the run
  used, from the rung's input orders and stream state, and its orders and
  losses must be bitwise the committed ones (the port's kernels and its
  plain tiers are deterministic, so a clean rung replays exactly, and a
  value corrupted after the run or a transient fault inside it does not).
  ``check="apply"`` (kernel tier only): the rung's last trained keys go
  once through the kernel tier's apply and the plain tier's, forward and
  backward, and y, colsum, dw and dx must agree within the apply's own
  tolerance (float32: 2e-5 of the largest entry forward, 1e-4 for the
  gradients; bfloat16: 2e-2), which catches a kernel that is wrong on
  every call.  No trajectory is followed across tiers, so the Adam steps'
  amplification of rounding noise (ROADMAP.md Queue C1) cannot fire the
  probe on a clean rung, as the reference's order compare across tiers
  did on the port's kernel tier (Queue C8).

A failed probe raises :class:`IntegrityViolation` (a sibling of
``NumericalDivergence``) with the probe's name, the round and an incident
record.  ``AnnealSupervisor`` repairs it through the ``DivergencePolicy``
ladder from the last verified checkpoint: every engine runs its probes
before ``ckpt.save``, so a corrupted rung is never committed.

Probes are read-only (they never advance a stream or change state) and
sampling is a pure function of ``(seed, rung start)``, so a guarded run
commits the unguarded run's results bitwise.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch.core.softsort import band_tail_bound

_VALID_MODES = ("off", "invariants", "shadow")

# The shadow's apply check (``check="apply"``): the largest error of y and
# colsum (forward) and of dw and dx (gradients), over the largest entry of
# the plain tier's, in float32; of every quantity in bfloat16.  The
# port's kernel-vs-twin file tolerances (ROADMAP.md Queue C5).
APPLY_TOL = {"float32": {"y": 2e-5, "colsum": 2e-5, "dw": 1e-4, "dx": 1e-4},
             "bfloat16": {"y": 2e-2, "colsum": 2e-2, "dw": 2e-2,
                          "dx": 2e-2}}

class IntegrityViolation(RuntimeError):
    """A guardrail probe failed: the run produced state that violates
    the output contract (invalid permutation, corrupted losses, stale
    buffers, broken key chain, band-tail excess, or shadow-recompute
    mismatch).  Sibling of ``NumericalDivergence`` — carries the same
    location attributes plus the probe name and a structured incident
    record, so ``AnnealSupervisor`` can log exactly what fired and route repair through the ``DivergencePolicy``
    ladder."""

    def __init__(self, message: str, *, probe: str,
                 round: Optional[int] = None,
                 tau: Optional[float] = None,
                 dtype: Optional[str] = None,
                 context: Optional[str] = None,
                 detail: Optional[dict] = None):
        super().__init__(message)
        self.probe = probe
        self.round = round
        self.tau = tau
        self.dtype = dtype
        self.context = context
        self.detail = dict(detail or {})

    def incident(self) -> dict:
        """JSON-able structured record for stats / audit surfaces."""
        rec = {"probe": self.probe, "round": self.round,
               "context": self.context, "message": str(self)}
        if self.tau is not None:
            rec["tau"] = float(self.tau)
        if self.dtype is not None:
            rec["dtype"] = self.dtype
        rec.update(self.detail)
        return rec


@dataclasses.dataclass(frozen=True)
class GuardrailPolicy:
    """Per-run (or per-request) probe configuration.

    ``mode`` selects the probe tier: ``"off"`` disables everything,
    ``"invariants"`` runs the free host-side checks, ``"shadow"`` adds
    the sampled replay and apply checks at ``shadow_rate``.  Sampling is a
    pure hash of ``(seed, rung start)`` — deterministic, replayable, and
    independent of wall clock and of the shuffle streams.  ``heal_after``
    is the number of integrity strikes on one unit of work before the
    serving tier consumes a ``DivergencePolicy`` rung (the first strike is
    a plain replay from the last verified boundary — the right repair for
    transient SDC).  ``tail_slack`` is the multiplicative grace on the
    band-tail audit (the measured mass is itself a float sum).
    """
    mode: str = "invariants"
    shadow_rate: float = 0.03125          # 1/32 of rungs; overhead ~ rate
    seed: int = 0
    explosion_factor: float = 1e3
    tail_slack: float = 1.05
    heal_after: int = 1

    def __post_init__(self):
        if self.mode not in _VALID_MODES:
            raise ValueError(
                f"guardrail mode must be one of {_VALID_MODES}, "
                f"got {self.mode!r}")
        if not (0.0 <= self.shadow_rate <= 1.0):
            raise ValueError(
                f"shadow_rate must be in [0, 1], got {self.shadow_rate}")



def shadow_sampled(seed: int, start: int, rate: float) -> bool:
    """Deterministic rung sampler: hash ``(seed, start)`` to [0, 1).

    crc32 of the decimal rendering — stable across platforms and
    processes (unlike ``hash()``), cheap, and uniform enough for a
    sampling decision.  ``rate=1.0`` samples every rung (chaos tests),
    ``rate=0.0`` none.
    """
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = zlib.crc32(f"{int(seed)}:{int(start)}".encode()) & 0xFFFFFFFF
    return (h / 2.0 ** 32) < rate


def expected_key_chain(keys_in, seg_len: int,
                       partitionable: bool = True) -> np.ndarray:
    """The ``jax.random`` keys a clean rung must carry after ``seg_len``
    rounds: every round runs ``key, sub = split(key)`` and keeps ``key``
    (``repro_torch.core.threefry.split``, on the host), so the keys out
    are a function of the keys in, and a corrupted key state shows.
    ``keys_in`` (R, 2) raw key data; returns (R, 2) uint32.  The chain of
    ``ThreefryShuffleSource`` (its ``advanced``), the stream audit's."""
    from repro_torch.core import threefry
    keys = threefry.as_keys(np.asarray(keys_in), "cpu").reshape(-1, 2)
    for _ in range(int(seg_len)):
        keys = threefry.split(keys, partitionable=partitionable)[:, 0]
    return threefry.key_data(keys)


# Rows of one block of ``measured_dropped_mass``: (block, N) float64
# temporaries per instance, never (N, N) ones.
_ROW_BLOCK = 512


def measured_dropped_mass(w, tau, band: int,
                          descending: bool = False) -> float:
    """The largest softmax mass any SoftSort row drops outside a
    ±``band`` rank window, measured densely: the quantity
    ``band_tail_bound`` bounds.  Row i of the dense relaxation targets
    the i-th largest key (ascending commit; the i-th smallest with
    ``descending``), and the window is the ±band neighbourhood of rank i
    in the same ordering.

    ``w`` (N,) or (B, N), numpy or a tensor on any device; ``tau`` a
    scalar or (B,).  float64 throughout, in blocks of ``_ROW_BLOCK`` rows,
    on the device that holds ``w``.
    """
    w = torch.as_tensor(w).to(torch.float64)
    if w.dim() == 1:
        w = w[None]
    bsz, n = w.shape
    tau_a = torch.as_tensor(np.broadcast_to(
        np.asarray(tau, np.float64).reshape(-1), (bsz,)).copy(),
        device=w.device)
    worst = 0.0
    ar = torch.arange(n, device=w.device)
    for b in range(bsz):
        row = w[b]
        srt = torch.sort(row, descending=not descending).values
        order = torch.argsort(row if descending else -row, stable=True)
        rank = torch.empty_like(ar)
        rank[order] = ar
        t = torch.clamp(tau_a[b], min=1e-30)
        for i0 in range(0, n, _ROW_BLOCK):
            i1 = min(i0 + _ROW_BLOCK, n)
            logits = -torch.abs(srt[i0:i1, None] - row[None, :]) / t
            logits = logits - logits.amax(dim=1, keepdim=True)
            p = torch.exp(logits)
            p = p / p.sum(dim=1, keepdim=True)
            out = (rank[None, :] - ar[i0:i1, None]).abs() > int(band)
            worst = max(worst, float((p * out).sum(dim=1).max()))
    return worst


class GuardrailMonitor:
    """Stateful probe runner for one engine run (or one serving
    request).  Engines call :meth:`check_rung` at every rung-boundary
    host sync, *after* the finite sentinel and *before* committing a
    checkpoint — so the newest checkpoint is always the last verified
    rung.  It reads host copies of the rung's state; the stream audit
    replays draws on scratch copies, never on the run's own streams.

    History carried across rungs: the committed loss ceiling (for the
    explosion sentinel) and the previous segment's loss bytes (for the
    stale-buffer probe).  Both reset per monitor — a fresh monitor
    re-establishes them on its first rung, which keeps warm restarts
    simple (sampling stays deterministic regardless, being keyed on
    ``(seed, start)``).
    """

    def __init__(self, policy: GuardrailPolicy,
                 context: str = "engine",
                 dtype: str = "float32"):
        if not isinstance(policy, GuardrailPolicy):
            raise TypeError(f"expected GuardrailPolicy, got {policy!r}")
        self.policy = policy
        self.context = context
        self.dtype = str(dtype)
        self.incidents: list[dict] = []
        self.rungs_checked = 0
        self.rungs_shadowed = 0
        self._loss_ref: Optional[float] = None
        self._prev_loss_bytes: Optional[bytes] = None

    # -- sampling ----------------------------------------------------
    @property
    def active(self) -> bool:
        return self.policy.mode != "off"

    def wants_shadow(self, start: int) -> bool:
        """Should the rung starting at round ``start`` be shadow
        recomputed?  Callers snapshot the rung's input orders and
        stream state before they run it."""
        return (self.policy.mode == "shadow"
                and shadow_sampled(self.policy.seed, start,
                                   self.policy.shadow_rate))

    # -- probes ------------------------------------------------------
    def _fail(self, probe: str, message: str, *, round=None, tau=None,
              **detail):
        if tau is not None:
            # Per-instance tau vectors (mixed-progress serving batches)
            # label the incident with the hottest value in the rung.
            t = np.asarray(tau, np.float64).reshape(-1)
            tau = float(t.max()) if t.size else None
        exc = IntegrityViolation(
            f"[guardrail:{probe}] {message} (context={self.context})",
            probe=probe, round=round, tau=tau,
            dtype=self.dtype, context=self.context, detail=detail)
        self.incidents.append(exc.incident())
        raise exc

    def check_rung(self, *, start: int, losses=None, orders=None,
                   n: Optional[int] = None, source=None, stream_in=None,
                   stream_out=None, rows=None,
                   seg_len: Optional[int] = None, ws=None, tau=None,
                   band: Optional[int] = None, banded_mask=None,
                   descending: bool = False,
                   oracle_losses=None, oracle_orders=None,
                   apply_errors: Optional[dict] = None) -> None:
        """Run every applicable probe on one rung's synced state.

        ``losses`` is round-major ``(T, B)`` (or ``(T,)``); ``orders``
        is ``(B, N)`` committed permutations; ``stream_in``/``stream_out``
        bracket the rung's draws from ``source`` (the states
        ``source.state_dict()`` gave before and after the rung; ``rows``
        the instances that drew, None: all); ``ws``/``tau``/``band`` feed the
        band-tail audit (``banded_mask`` restricts it to the banded
        instances); ``oracle_losses``/``oracle_orders`` are the shadow's
        same-tier replay, compared bitwise, and ``apply_errors`` its apply
        check, ``{quantity: error}`` held to ``APPLY_TOL``.  Raises
        IntegrityViolation on the first failing probe; returns None when
        the rung verifies.
        """
        if not self.active:
            return
        self.rungs_checked += 1
        pol = self.policy

        if losses is not None:
            seg = np.asarray(losses, np.float32)
            if seg.ndim == 1:
                seg = seg[:, None]
            if not np.isfinite(seg).all():
                t_bad = int(np.argwhere(
                    ~np.isfinite(seg).all(axis=1)).min())
                self._fail("finite",
                           f"non-finite loss at round {start + t_bad}",
                           round=start + t_bad, tau=tau)
            # The grid layout loss is a sum of squared pairwise
            # distances — strictly non-negative by construction.
            if float(seg.min()) < -1e-6:
                t_bad, b_bad = np.unravel_index(int(seg.argmin()),
                                                seg.shape)
                self._fail("loss_sign",
                           f"negative loss {float(seg.min()):.4g} at "
                           f"round {start + int(t_bad)}",
                           round=start + int(t_bad), tau=tau,
                           value=float(seg.min()))
            # Explosion vs. committed history: the anneal only ever
            # shrinks the loss across rungs, so anything orders of
            # magnitude above the committed ceiling is corruption, not
            # optimization.  First rung bootstraps the ceiling from its
            # own median (within-rung dynamic range is small).
            # Ceiling comes from COMMITTED rungs only — folding the
            # current segment in would let a corrupt value raise its
            # own limit.  The first rung bootstraps from its median.
            med = float(np.median(seg))
            ref = med if self._loss_ref is None else self._loss_ref
            lim = pol.explosion_factor * max(ref, 1e-6)
            if float(seg.max()) > lim:
                t_bad, b_bad = np.unravel_index(int(seg.argmax()),
                                                seg.shape)
                self._fail("loss_explosion",
                           f"loss {float(seg.max()):.4g} exceeds "
                           f"{pol.explosion_factor:g}x committed ceiling "
                           f"{ref:.4g} at round {start + int(t_bad)}",
                           round=start + int(t_bad), tau=tau,
                           value=float(seg.max()), limit=float(lim))
            # Stale buffer: consecutive rung segments bitwise equal is
            # a repeated DMA buffer, never a legitimate anneal (each
            # round draws a fresh shuffle).  Only meaningful for
            # multi-element segments.
            cur = seg.tobytes()
            if (seg.size >= 2 and self._prev_loss_bytes is not None
                    and cur == self._prev_loss_bytes):
                self._fail("stale_losses",
                           f"rung at round {start} returned a loss "
                           "segment bitwise-identical to the previous "
                           "rung", round=start, tau=tau)
            # History commits only after EVERY probe passes (end of this
            # method): a failing rung is replayed from the last verified
            # boundary and legitimately reproduces the same bytes — the
            # stale probe must compare against the last VERIFIED rung.
            commit_losses = (cur, max(ref, float(seg.max())))
        else:
            commit_losses = None

        if orders is not None:
            o = np.asarray(orders)
            if o.ndim == 1:
                o = o[None]
            nn = int(n if n is not None else o.shape[1])
            ok = (np.sort(o, axis=1) == np.arange(nn)).all(axis=1)
            if not ok.all():
                b_bad = int(np.argwhere(~ok).min())
                self._fail("permutation",
                           f"instance {b_bad} committed an invalid "
                           f"permutation after round "
                           f"{start + (seg_len or 0)}",
                           round=start, tau=tau, instance=b_bad)

        if (source is not None and stream_in is not None
                and stream_out is not None and seg_len is not None):
            exp = np.asarray(source.advanced(stream_in, rows, seg_len))
            got = np.asarray(stream_out)
            if exp.shape != got.shape or not (exp == got).all():
                self._fail("key_chain",
                           f"shuffle stream state after rung at round "
                           f"{start} is not its input state advanced by "
                           f"{seg_len} draws ({source.kind})",
                           round=start, tau=tau)

        if ws is not None and band is not None and tau is not None:
            w = np.asarray(ws, np.float32)
            if w.ndim == 1:
                w = w[None]
            mask = np.ones(w.shape[0], bool) if banded_mask is None \
                else np.asarray(banded_mask, bool)
            if mask.any():
                wv = w[mask]
                tv = np.broadcast_to(
                    np.asarray(tau, np.float32).reshape(-1),
                    (w.shape[0],))[mask] if np.ndim(tau) \
                    else np.full((int(mask.sum()),), float(tau),
                                 np.float32)
                if not np.isfinite(wv).all():
                    self._fail("band_tail", "non-finite live keys in "
                               f"banded rung at round {start}",
                               round=start, tau=None)
                bound = float(np.max(band_tail_bound(
                    torch.as_tensor(wv), torch.as_tensor(tv),
                    int(band)).numpy()))
                if self.wants_shadow(start):
                    meas = measured_dropped_mass(
                        wv, tv, int(band), descending=descending)
                    lim = bound * pol.tail_slack + 1e-6
                    if meas > lim:
                        self._fail(
                            "band_tail",
                            f"measured dropped mass {meas:.4g} exceeds "
                            f"analytic band_tail_bound {bound:.4g} at "
                            f"round {start} (band={band})",
                            round=start, measured=meas, bound=bound)

        self.check_shadow(start=start, tau=tau, losses=losses,
                          orders=orders, oracle_losses=oracle_losses,
                          oracle_orders=oracle_orders,
                          apply_errors=apply_errors)

        if commit_losses is not None:
            self._prev_loss_bytes, self._loss_ref = commit_losses

    def check_shadow(self, *, start: int, tau=None, losses=None,
                     orders=None, oracle_losses=None, oracle_orders=None,
                     apply_errors: Optional[dict] = None) -> None:
        """The shadow's two checks on one rung (``check_rung`` runs them
        after the invariants): the committed ``losses`` and ``orders``
        bitwise those of the same-tier replay, and each of
        ``apply_errors`` within ``APPLY_TOL``."""
        if oracle_losses is not None and losses is not None:
            self.rungs_shadowed += 1
            a = np.asarray(losses, np.float32).reshape(-1)
            b = np.asarray(oracle_losses, np.float32).reshape(-1)
            if a.shape != b.shape:
                self._fail("shadow", "shadow replay shape mismatch at "
                           f"round {start}", round=start, tau=tau,
                           check="replay")
            # Bitwise: a replay on the same tier reproduces a clean rung
            # exactly (NaN in both sides trips the finite probe above).
            if a.tobytes() != b.tobytes():
                a64, b64 = a.astype(np.float64), b.astype(np.float64)
                rel = np.abs(a64 - b64) / np.maximum(np.abs(b64), 1e-6)
                worst = float(np.nanmax(rel)) \
                    if np.isfinite(rel).any() else float("inf")
                self._fail(
                    "shadow",
                    f"losses differ from the same-tier replay at rung round "
                    f"{start}: rel err {worst:.4g} ({self.dtype})",
                    round=start, tau=tau, rel_err=worst, tol=0.0,
                    check="replay")
        if oracle_orders is not None and orders is not None:
            a = np.asarray(orders)
            b = np.asarray(oracle_orders)
            if a.shape != b.shape or not (a == b).all():
                self._fail("shadow",
                           f"committed orders differ from the same-tier "
                           f"replay at rung round {start}",
                           round=start, tau=tau, check="replay")
        for quantity, err in (apply_errors or {}).items():
            lim = APPLY_TOL[self.dtype][quantity]
            # `not (err <= lim)` so NaN trips the probe.
            if not float(err) <= lim:
                self._fail(
                    "shadow",
                    f"kernel-vs-plain apply {quantity} error {float(err):.4g}"
                    f" > tol {lim:g} at rung round {start} ({self.dtype})",
                    round=start, tau=tau, rel_err=float(err), tol=lim,
                    check="apply", quantity=quantity)

    def summary(self) -> dict:
        return {"mode": self.policy.mode,
                "shadow_rate": self.policy.shadow_rate,
                "rungs_checked": self.rungs_checked,
                "rungs_shadowed": self.rungs_shadowed,
                "incidents": list(self.incidents)}

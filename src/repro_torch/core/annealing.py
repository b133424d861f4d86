"""Convergence-driven adaptive annealing: the plateau controller of
``ShuffleSoftSortConfig(schedule="adaptive")``.

Counterpart of ``repro.core.annealing``; host-side numpy, decision for
decision the reference's.  The fixed schedule runs its R rounds to the
end, though the loss trace of a long anneal is flat over its last
rounds.  This controller turns measured convergence into skipped rounds:

* **Plateau-driven tau decay** — a per-instance EWMA of the per-round
  loss; when its relative improvement stays below ``plateau_rtol`` for
  ``patience`` consecutive rungs, the instance JUMPS ``decay_rungs``
  rungs ahead in the nominal schedule (colder tau sooner).  A jump past
  the schedule end is an early stop: the instance leaves the anneal at
  that rung boundary.
* **Measured dense->banded switch** — instead of the linear-init model
  (``_band_switch_round``), each still-dense instance evaluates the
  tail bound ``band_tail_bound`` on its own end-of-round keys; it
  switches once its measured bound clears ``band_eps`` (one-way: a
  switched instance stays banded).
* **Per-instance early stop** — a stopped instance leaves every later
  dispatch; each instance owns its shuffle stream
  (``repro_torch.core.prng``), so stopping one never perturbs another.

Determinism contract: every decision is an elementwise function of ONE
instance's observations (its loss trace, its keys), in host-side
float32, with no batch-global reduction.  An engine that feeds an
instance the same per-round losses gets the same decisions for it.

Decision quantum: the controller observes only at rung boundaries,
every ``seg_len`` rounds, with ``seg_len`` dividing ``rounds`` and every
jump a multiple of ``seg_len``: a live instance's remaining schedule is
always a positive multiple of ``seg_len``, and every dispatch advances
its group by exactly one rung.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.softsort import band_tail_bound


def adaptive_seg_len(cfg) -> int:
    """The adaptive controller's decision quantum, in rounds.

    ``cfg.adapt_every`` if set (must divide ``cfg.rounds``); otherwise
    the largest divisor of ``rounds`` not exceeding ``rounds // 8`` —
    about 8 decision points across the schedule, and always a divisor
    so rung dispatches are uniform (see module docstring).
    """
    rounds = int(cfg.rounds)
    if cfg.adapt_every:
        seg = int(cfg.adapt_every)
        if not 1 <= seg <= rounds or rounds % seg:
            raise ValueError(
                f"adapt_every={cfg.adapt_every} must divide "
                f"cfg.rounds={rounds} (uniform decision quantum)")
        return seg
    target = max(1, rounds // 8)
    return max(d for d in range(1, target + 1) if rounds % d == 0)


@dataclasses.dataclass(frozen=True)
class RungDecision:
    """What the controller decided at one rung boundary (a host record for
    counters and tables)."""
    step: int                  # 1-based rung index
    boundary: int              # executed rounds at this boundary
    n_live: int                # instances that ran this rung
    fired: int                 # instances whose plateau fired (tau jump)
    stopped: int               # instances that left the anneal here
    switched: int              # instances that went dense->banded here


class AdaptiveController:
    """Plateau-driven schedule controller over BS flattened instances.

    Construct via ``repro_torch.core.shufflesoftsort
    .make_adaptive_controller`` (which supplies the tau schedule and
    resolved band half-width from a config) unless you are wiring a
    custom schedule.

    State is per-instance numpy (host-side): ``pos`` — the instance's
    next position in the nominal tau schedule (jumps move it forward),
    ``executed`` — rounds actually run, ``done`` / ``culled`` — out of
    the anneal (converged / culled from outside), ``banded`` — apply
    regime, plus the EWMA plateau bookkeeping.  ``observe`` is the only
    mutator the engine calls; ``mark_culled`` takes instances out of the
    anneal from outside.
    """

    def __init__(self, cfg, n_instances: int, *, taus, band: int | None,
                 seg_len: int):
        rounds = int(cfg.rounds)
        self.cfg = cfg
        self.taus = np.asarray(taus, np.float32)
        assert self.taus.shape == (rounds,), (self.taus.shape, rounds)
        self.band = band
        self.seg_len = int(seg_len)
        if not 1 <= self.seg_len <= rounds or rounds % self.seg_len:
            raise ValueError(
                f"seg_len={seg_len} must divide cfg.rounds={rounds}")
        self.rounds = rounds
        self.patience = int(cfg.patience)
        self.plateau_rtol = np.float32(cfg.plateau_rtol)
        self.alpha = np.float32(cfg.ewma_alpha)
        self.jump = self.seg_len * max(1, int(cfg.decay_rungs))
        if self.patience < 1:
            raise ValueError(f"patience={cfg.patience} must be >= 1")
        if not 0.0 < cfg.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha={cfg.ewma_alpha} not in (0, 1]")

        bs = int(n_instances)
        self.pos = np.zeros(bs, np.int64)        # next schedule round
        self.executed = np.zeros(bs, np.int64)   # rounds actually run
        self.done = np.zeros(bs, bool)
        self.culled = np.zeros(bs, bool)
        self.banded = np.zeros(bs, bool)
        self.ewma = np.zeros(bs, np.float32)
        self.best = np.full(bs, np.inf, np.float32)
        self.plateau = np.zeros(bs, np.int64)
        self.fired = np.zeros(bs, np.int64)      # tau jumps taken
        self.decisions: list[RungDecision] = []

    # ---- state ------------------------------------------------------------

    # Every mutable per-instance array `observe` / `mark_culled` touch.
    # `decisions` (the host audit log) is deliberately not state: it
    # feeds counters and tables, never a decision, so a continued run's
    # log simply restarts at the rung it continues from.
    _STATE_FIELDS = ("pos", "executed", "done", "culled", "banded",
                     "ewma", "best", "plateau", "fired")

    def state_dict(self) -> dict[str, np.ndarray]:
        """Copy of the full decision state, keyed by field name: numpy
        arrays, the same fields and dtypes as the reference controller's,
        so either controller loads the other's state unchanged."""
        return {f: getattr(self, f).copy() for f in self._STATE_FIELDS}

    def load_state_dict(self, state: dict) -> None:
        """Restore ``state_dict`` output (or its numpy round-trip).
        Arrays are cast back to the constructor dtypes so decisions
        after a resume are bitwise the ones an uninterrupted run makes.
        """
        for f in self._STATE_FIELDS:
            cur = getattr(self, f)
            new = np.asarray(state[f], dtype=cur.dtype)
            if new.shape != cur.shape:
                raise ValueError(
                    f"controller state {f!r} has shape {new.shape}, "
                    f"expected {cur.shape} (wrong instance count?)")
            setattr(self, f, new.copy())

    # ---- engine-facing queries ------------------------------------------

    def live_indices(self) -> np.ndarray:
        """Instances that should run the next rung."""
        return np.flatnonzero(~self.done & ~self.culled)

    def tau_rows(self, idx: np.ndarray) -> np.ndarray:
        """(seg_len, k) float32 — each selected instance's OWN slice of
        the nominal schedule starting at its current position (the
        layout ``_run_rounds_ragged`` consumes)."""
        idx = np.asarray(idx)
        steps = self.pos[idx][:, None] + np.arange(self.seg_len)
        assert (steps < self.rounds).all(), "live instance past schedule end"
        return self.taus[steps].T.astype(np.float32)

    def rounds_saved(self) -> int:
        """Schedule rounds NOT executed across all instances (early
        stops, jumps, and culls all count — this is the compute the
        fixed engine would have spent)."""
        return int((self.rounds - self.executed).sum())

    # ---- mutators --------------------------------------------------------

    def mark_culled(self, idx) -> None:
        self.culled[np.asarray(idx)] = True

    def observe(self, idx: np.ndarray, losses: np.ndarray,
                ws: np.ndarray | None = None) -> RungDecision:
        """Commit one rung's observations for instances ``idx``.

        Args:
          idx: (k,) instance rows that just ran ``seg_len`` rounds.
          losses: (k, seg_len) float32 per-round losses, round-major
            per row.
          ws: optional (k, N) float32 end-of-rung soft-sort keys (the
            final round's trained ``w``), consulted for the measured
            dense->banded switch when a band is configured.

        All arithmetic is elementwise float32 per instance — see the
        module docstring's determinism contract.
        """
        idx = np.asarray(idx)
        losses = np.asarray(losses, np.float32)
        assert losses.shape == (idx.size, self.seg_len), (
            losses.shape, idx.size, self.seg_len)
        assert not (self.done[idx] | self.culled[idx]).any(), \
            "observed a rung for a stopped instance"

        # EWMA over the rung's rounds (first-ever round initializes).
        e = self.ewma[idx]
        seeded = self.executed[idx] > 0
        for t in range(self.seg_len):
            lt = losses[:, t]
            e = np.where(seeded, self.alpha * lt + (1 - self.alpha) * e, lt)
            seeded = np.ones_like(seeded)
        e = e.astype(np.float32)
        self.ewma[idx] = e
        self.executed[idx] += self.seg_len
        self.pos[idx] += self.seg_len

        # Relative improvement of the EWMA vs the best EWMA seen at any
        # prior boundary; first boundary never counts as a plateau.
        best = self.best[idx]
        finite = np.isfinite(best)
        with np.errstate(invalid="ignore", divide="ignore"):
            imp = (best - e) / np.maximum(np.abs(best), np.float32(1e-12))
        imp = np.where(finite, imp, np.float32(np.inf)).astype(np.float32)
        plat = np.where(imp < self.plateau_rtol, self.plateau[idx] + 1, 0)
        self.best[idx] = np.minimum(best, e)

        fire = plat >= self.patience
        plat[fire] = 0
        self.plateau[idx] = plat
        self.fired[idx] += fire
        pos = self.pos[idx]
        pos = np.where(fire, np.minimum(pos + self.jump, self.rounds), pos)
        self.pos[idx] = pos
        stopped = pos >= self.rounds
        self.done[idx] = stopped

        # Measured band switch: a still-dense, still-live instance goes
        # banded once the tail bound ON ITS OWN KEYS at its next-round
        # temperature clears band_eps (one-way switch).
        n_switched = 0
        if self.band is not None and ws is not None:
            sel = np.flatnonzero(~self.banded[idx] & ~stopped)
            if sel.size:
                rows = idx[sel]
                tau_next = self.taus[np.minimum(self.pos[rows],
                                                self.rounds - 1)]
                bound = band_tail_bound(
                    torch.as_tensor(np.asarray(ws, np.float32)[sel]),
                    torch.as_tensor(tau_next), self.band).numpy()
                flip = bound <= np.float32(self.cfg.band_eps)
                self.banded[rows] = flip
                n_switched = int(flip.sum())

        decision = RungDecision(
            step=len(self.decisions) + 1,
            boundary=int(self.executed[idx][0]) if idx.size else 0,
            n_live=int(idx.size),
            fired=int(fire.sum()),
            stopped=int(stopped.sum()),
            switched=n_switched,
        )
        self.decisions.append(decision)
        return decision

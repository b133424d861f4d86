"""ShuffleSoftSort — Algorithm 1 of the paper, in PyTorch.

Learns a permutation of N items with only N parameters by iterating:

  for r in 1..R:                      (outer: anneal tau, re-shuffle)
      tau_r = tau_start * (tau_end / tau_start) ** (r / R)
      w     = arange(N)               (linear init preserves incoming order)
      shuf  = randperm(N)
      for i in 1..I:                  (inner: a few SoftSort grad steps)
          tau_i = tau_r * (0.2 .. 1.0 ramp)
          P     = SoftSort_tau_i(w)           (streamed, never N^2)
          y     = unshuffle(P @ x[order][shuf])
          loss  = L_nbr(y) + l_s * L_s + l_sig * L_sigma      (eq. 2)
          w    <- Adam step
      order <- commit argsort(w) through the shuffle

Counterpart of ``repro.core.shufflesoftsort`` on its single-device path,
fixed and adaptive schedules.  The engine runs B problems x S restarts as
one (BS, N) batch; ``shuffle_soft_sort`` is the BS = 1 case of the same
code.  Each round's shuffles come from a shuffle source
(``repro_torch.core.prng``): per-instance ``torch.Generator`` streams by
default, or a replayed array.  ``cfg.use_kernel`` routes the SoftSort
apply, forward and backward, through the kernel tier
(``repro_torch.kernels.ops``).  ``cfg.band`` (K or "auto") swaps the
O(N^2) apply for the O(N K) banded one from the round
``_band_switch_round`` names on, in both engines alike.

``cfg.schedule="adaptive"`` runs the same nominal schedule under the
plateau controller of ``repro_torch.core.annealing``: at every rung
boundary (``adapt_every`` rounds) an instance may jump ahead in the
schedule, stop early, or switch to the banded apply on its measured tail
bound.  Instances then sit at different temperatures, so the ragged
engine ``_run_rounds_ragged`` gives each its own row of inner
temperatures and the kernels read one tau per instance; the live
instances run as at most two groups per rung (dense and banded), each
one batch.

Entry points run on CUDA unless ``device`` says otherwise; without a CUDA
device they raise rather than fall back to the CPU.

Return contract: ``order`` is the (N,) int32 permutation mapping grid
cell -> input row, ``sorted`` is ``x[order]``, and ``losses`` is the
per-round loss trace (the last inner step's loss of each round; with
the adaptive schedule, NaN past an instance's early stop).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.annealing import AdaptiveController, adaptive_seg_len
from repro_torch.core.losses import grid_sorting_loss, mean_pairwise_distance
from repro_torch.core.prng import (
    ShuffleSource,
    TorchShuffleSource,
    instance_seeds,
)
from repro_torch.core.softsort import (
    softsort_apply_banded,
    softsort_apply_chunked,
)

_F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class ShuffleSoftSortConfig:
    rounds: int = 1000          # R — outer iterations (paper: "few hundred")
    inner_steps: int = 8        # I — SoftSort grad steps per round (paper: 4)
    tau_start: float = 1.0
    tau_end: float = 0.2        # below ~0.2 the SoftSort gradient vanishes
    inner_tau_ramp: float = 0.2  # inner tau starts at ramp*tau_r
    lr: float = 0.3
    b1: float = 0.5             # short inner runs want fast-adapting Adam
    b2: float = 0.9
    lambda_s: float = 1.0       # eq. 2 regularizer weights (paper values)
    lambda_sigma: float = 2.0
    chunk: int = 256            # row-block size for streamed softsort
    use_kernel: bool = False    # route the apply through the kernel tier
    band: int | str | None = None   # K or "auto": O(N*K) banded apply
                                    # once the anneal is cold enough
    band_eps: float = 1e-6
    compute_dtype: str = "float32"  # kernel tier: "float32" or "bfloat16"
    schedule: str = "fixed"     # "fixed" | "adaptive" (core.annealing)
    adapt_every: int = 0
    patience: int = 2
    plateau_rtol: float = 1e-3
    ewma_alpha: float = 0.5
    decay_rungs: int = 1


class NumericalDivergence(RuntimeError):
    """A per-round loss is not finite.

    Carries ``round`` (first non-finite global round), ``tau`` (the
    schedule temperature there), ``dtype`` (``cfg.compute_dtype``) and
    ``context`` (which engine tripped).
    """

    def __init__(self, message: str, *, round: int | None = None,
                 tau: float | None = None, dtype: str | None = None,
                 context: str | None = None):
        super().__init__(message)
        self.round = round
        self.tau = tau
        self.dtype = dtype
        self.context = context


def _check_finite(losses_seg, start: int, cfg: ShuffleSoftSortConfig,
                  context: str, ws=None) -> None:
    """Raise ``NumericalDivergence`` at the first non-finite round of
    ``losses_seg`` ((T, ...) round-major, global rounds [start, start+T)),
    or, given ``ws`` (the end-of-rung keys), at the segment's last round
    if a key is not finite."""
    losses_seg = np.asarray(losses_seg)
    bad = ~np.isfinite(losses_seg)
    if bad.any():
        per_round = bad.reshape(losses_seg.shape[0], -1).any(axis=1)
        rnd = start + int(np.argmax(per_round))
        what = "loss"
    elif ws is not None and not np.isfinite(np.asarray(ws)).all():
        rnd = start + losses_seg.shape[0] - 1
        what = "trained keys"
    else:
        return
    tau = float(_tau_schedule(cfg)[min(rnd, cfg.rounds - 1)])
    raise NumericalDivergence(
        f"non-finite {what} at round {rnd} (tau~{tau:.4g}, "
        f"compute_dtype={cfg.compute_dtype}, engine={context})",
        round=rnd, tau=tau, dtype=cfg.compute_dtype, context=context)


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA; without a CUDA device that is an error, never a
    quiet move to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device=\"cpu\" to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def _check_schedule(cfg: ShuffleSoftSortConfig) -> None:
    if cfg.schedule not in ("fixed", "adaptive"):
        raise ValueError(
            f"cfg.schedule={cfg.schedule!r} must be 'fixed' or 'adaptive'")


def _check_ported(cfg: ShuffleSoftSortConfig, **features) -> None:
    """Refuse every setting whose code is not ported yet."""
    _check_schedule(cfg)
    todo = {
        "mesh": (features.get("mesh") is not None,
                 "multi-GPU instance sharding (ROADMAP.md Queue A11)"),
        "mesh_hook": (features.get("mesh_hook") is not None,
                      "elastic re-sharding (ROADMAP.md Queue A11)"),
        "checkpoint_dir": (features.get("checkpoint_dir") is not None,
                           "checkpoint and resume (ROADMAP.md Queue A10)"),
        "resume": (bool(features.get("resume")),
                   "checkpoint and resume (ROADMAP.md Queue A10)"),
        "guardrail": (features.get("guardrail") is not None,
                      "guardrails (ROADMAP.md Queue A12)"),
    }
    for name, (is_set, item) in todo.items():
        if is_set:
            raise NotImplementedError(
                f"{name} is not ported to repro_torch yet: {item}")
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cfg.compute_dtype}")


# Rows of one loss evaluation.  PyTorch's CUDA reductions choose how they
# split each row's sum from the number of rows they reduce, so an
# instance's loss can change in its last bits with the batch around it (on
# an H100 at N = 4096, d = 50, against 32 instances: the loss values at 4,
# 8 and 12, the std term's gradient at one; ``chip_smoke.py``'s
# ``loss_block_check``).  A batch of more than _LOSS_ROWS instances,
# and with ``pad_rows`` any batch, is therefore evaluated in blocks of
# exactly _LOSS_ROWS rows, a short block padded: every instance then sees
# one reduction however many instances share its dispatch.  A fixed-engine
# batch of at most _LOSS_ROWS is evaluated whole, as it always was.
_LOSS_ROWS = 8


def _loss_fn(w, x_shuf, inv_shuf, tau, hw, norm, cfg: ShuffleSoftSortConfig,
             apply_fn, pad_rows: bool = False) -> torch.Tensor:
    """(BS,) losses of a (BS, N) key batch; ``norm`` is (BS,)."""
    y_shuf, colsum = apply_fn(w, x_shuf, tau)
    d = y_shuf.shape[-1]
    y = torch.gather(y_shuf, 1, inv_shuf[..., None].expand(-1, -1, d))
    loss = functools.partial(grid_sorting_loss, hw=hw,
                             lambda_s=cfg.lambda_s,
                             lambda_sigma=cfg.lambda_sigma)
    bs = y.shape[0]
    if bs == _LOSS_ROWS or (bs < _LOSS_ROWS and not pad_rows):
        return loss(y, colsum, x_shuf, norm=norm)
    out = []
    for b0 in range(0, bs, _LOSS_ROWS):
        block = [t[b0:b0 + _LOSS_ROWS] for t in (y, colsum, x_shuf, norm)]
        k = block[0].shape[0]
        if k < _LOSS_ROWS:
            # Copies of the block's first row, cut off from autograd: they
            # only fill the block and are dropped with their losses.
            block = [torch.cat([t, t[:1].detach().expand(
                _LOSS_ROWS - k, *t.shape[1:])]) for t in block]
        out.append(loss(block[0], block[1], block[2], norm=block[3])[:k])
    return torch.cat(out)


def _inner_ramp(cfg: ShuffleSoftSortConfig) -> np.ndarray:
    """(I,) float32 factors ``ramp + (1 - ramp) * frac_i`` of the inner
    temperatures, every operation in float32 as the reference does it."""
    f32 = np.float32
    frac = (np.arange(cfg.inner_steps, dtype=f32)
            / f32(max(cfg.inner_steps - 1, 1)))
    return f32(cfg.inner_tau_ramp) + f32(1.0 - cfg.inner_tau_ramp) * frac


def _inner_taus(cfg: ShuffleSoftSortConfig) -> np.ndarray:
    """(R, I) float32 inner-step temperatures ``tau_r * ramp_i``."""
    return _tau_schedule(cfg)[:, None] * _inner_ramp(cfg)[None, :]


def _adam_bias(cfg: ShuffleSoftSortConfig, device):
    """(I,) Adam bias corrections ``1 - b1 ** t`` and ``1 - b2 ** t``."""
    t = torch.arange(1, cfg.inner_steps + 1, dtype=_F32, device=device)
    return 1 - cfg.b1 ** t, 1 - cfg.b2 ** t


def _outer_round(xs, orders, shuf, tau_inner, norms, bias1, bias2, *,
                 hw, cfg: ShuffleSoftSortConfig, apply_fn,
                 pad_rows: bool = False):
    """One outer round for a (BS, N) batch of instances.

    ``shuf`` (BS, N) is the round's shuffles, ``tau_inner`` the
    device-resident inner temperatures, (BS, I) with a row per instance or
    (1, I) shared by the batch, ``bias1``/``bias2`` (I,) the Adam bias
    corrections ``1 - b ** t``, ``pad_rows`` as in ``_loss_fn``.  Returns
    the committed orders, the last inner step's losses (BS,) and its
    trained keys ``w`` (BS, N).
    """
    bs, n = orders.shape
    d = xs.shape[-1]
    inv_shuf = torch.argsort(shuf, dim=-1, stable=True)
    x_cur = torch.gather(xs, 1, orders[..., None].expand(-1, -1, d))
    x_shuf = torch.gather(x_cur, 1, shuf[..., None].expand(-1, -1, d))

    w = torch.arange(n, dtype=_F32, device=xs.device).repeat(bs, 1)
    mu = torch.zeros_like(w)
    nu = torch.zeros_like(w)
    taus = tau_inner.t().contiguous()       # row i: step i's temperatures
    loss = None
    for i in range(cfg.inner_steps):
        wv = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _loss_fn(wv, x_shuf, inv_shuf, taus[i], hw, norms, cfg,
                            apply_fn, pad_rows)
            (g,) = torch.autograd.grad(loss.sum(), wv)
        mu = cfg.b1 * mu + (1 - cfg.b1) * g
        nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
        mhat = mu / bias1[i]
        nuhat = nu / bias2[i]
        w = w - cfg.lr * mhat / (torch.sqrt(nuhat) + 1e-8)

    # Commit the hard permutation through the shuffle:
    #   new_grid[shuf[i]] = x_shuf[sort_idx[i]] = x_cur[shuf[sort_idx[i]]]
    sort_idx = torch.argsort(w, dim=-1, stable=True)
    g = torch.empty_like(shuf).scatter_(1, shuf, torch.gather(shuf, 1,
                                                              sort_idx))
    return torch.gather(orders, 1, g), loss.detach(), w


def _tau_schedule(cfg: ShuffleSoftSortConfig) -> np.ndarray:
    """Outer-round temperatures, (R,) float32: geometric anneal from
    tau_start to tau_end, computed in float64 and cast once."""
    return np.float32(cfg.tau_start * (cfg.tau_end / cfg.tau_start)
                      ** (np.arange(1, cfg.rounds + 1) / cfg.rounds))


def _select_apply_fn(cfg: ShuffleSoftSortConfig, band: int | None = None):
    """The apply of one round, from ``cfg.use_kernel`` and a resolved band
    half-width (``resolve_band``; None means dense):

    * ``use_kernel=False`` — the streamed ``softsort_apply_chunked``, or
      with a band the windowed oracle ``softsort_apply_banded``;
    * ``use_kernel=True`` — the kernel tier, forward and backward: the
      dense ``softsort_apply``, or with a band ``softsort_apply_banded``
      of ``repro_torch.kernels.ops``.

    ``cfg.compute_dtype`` reaches only the kernel tier; the plain applies
    are float32.
    """
    if cfg.use_kernel:
        from repro_torch.kernels import ops
        if band is not None:
            return functools.partial(ops.softsort_apply_banded, band=band,
                                     compute_dtype=cfg.compute_dtype)
        return functools.partial(ops.softsort_apply,
                                 compute_dtype=cfg.compute_dtype)
    if band is not None:
        return functools.partial(softsort_apply_banded, band=band)
    return functools.partial(softsort_apply_chunked, chunk=cfg.chunk)


def resolve_band(cfg: ShuffleSoftSortConfig, n: int) -> int | None:
    """``cfg.band`` as a half-width K, or None for the dense apply.

    ``"auto"`` takes the largest of 64, the K at which the modeled tail
    ``(N - K) exp(-(K/2) / tau)`` clears ``band_eps`` at the coldest
    temperature ``tau_end`` (``K >= 2 tau_end ln(N / eps)``; the hot
    rounds stay dense through ``_band_switch_round``), and N/16 rounded up
    to a multiple of 64.  A K that covers every pair (K >= N - 1)
    resolves to None: the dense apply is the same math.
    """
    if cfg.band is None:
        return None
    if cfg.band == "auto":
        eps = max(cfg.band_eps, 1e-30)
        safety = int(np.ceil(2.0 * cfg.tau_end * np.log(max(n, 2) / eps)))
        floor = -(-max(n // 16, 1) // 64) * 64
        k = max(64, safety, floor)
    else:
        k = int(cfg.band)
    if k >= n - 1:
        return None
    return max(1, k)


def _band_switch_round(cfg: ShuffleSoftSortConfig, n: int) -> int:
    """The first round that runs banded (``cfg.rounds``: none does).

    Every round re-initializes the keys to ``arange(N)``, so the gap
    across K ranks starts at K; with a factor of 2 for the drift of the
    inner Adam steps, a round switches once ``(N - K) exp(-(K/2) / tau_r)
    <= band_eps`` at its schedule temperature.  The anneal cools
    monotonically, so the rounds split into a dense prefix and a banded
    suffix.
    """
    k = resolve_band(cfg, n)
    if k is None:
        return cfg.rounds
    taus = _tau_schedule(cfg)
    ok = (n - k) * np.exp(-(k / 2.0) / taus) <= cfg.band_eps
    idx = np.flatnonzero(ok)
    return int(idx[0]) if idx.size else cfg.rounds


def _run_rounds(xs_t, orders, source: ShuffleSource, norms_t, start: int,
                end: int | None = None, *, rows=None, hw,
                cfg: ShuffleSoftSortConfig,
                on_round: Optional[Callable] = None,
                pad_rows: bool = False):
    """Rounds ``start .. end - 1`` (``end`` None: to R) over a (BS, N)
    batch, each round dense before the GLOBAL switch round and banded from
    it on, so a run cut into segments runs every round on the apply an
    uninterrupted run gives it.  ``rows`` (BS,) are the batch's instance
    indices in ``source`` (None: all of them, in order); only their
    streams advance.  ``pad_rows`` as in ``_loss_fn``.  Returns the orders
    and the (end - start, BS) losses, both on the device."""
    dev = xs_t.device
    n = orders.shape[1]
    dense_fn = _select_apply_fn(cfg)
    band = resolve_band(cfg, n)
    band_fn = dense_fn if band is None else _select_apply_fn(cfg, band)
    switch = _band_switch_round(cfg, n)
    tau_inner = torch.as_tensor(_inner_taus(cfg), device=dev)
    bias1, bias2 = _adam_bias(cfg, dev)
    losses = []
    for r in range(start, cfg.rounds if end is None else end):
        shuf = source.next_round(rows)
        orders, loss, _ = _outer_round(
            xs_t, orders, shuf, tau_inner[r:r + 1], norms_t, bias1, bias2,
            hw=hw, cfg=cfg, apply_fn=band_fn if r >= switch else dense_fn,
            pad_rows=pad_rows)
        losses.append(loss)
        if on_round is not None:
            on_round(r, orders, loss)
    if not losses:
        return orders, torch.zeros((0, orders.shape[0]), dtype=_F32,
                                   device=dev)
    return orders, torch.stack(losses)


def _run_rounds_ragged(xs, orders, source: ShuffleSource, rows, tau_rows,
                       norms, *, hw, cfg: ShuffleSoftSortConfig, apply_fn):
    """T rounds of a group of k instances, each at its own temperatures.

    ``xs`` (k, N, d), ``orders`` (k, N) and ``norms`` (k,) are the group's
    rows, gathered on the device; ``rows`` (k,) are their instance
    indices, whose shuffle streams alone advance (one draw per round);
    ``tau_rows`` (T, k) float32 holds column j's outer temperatures, so
    instances at different points of the schedule share every launch.
    The inner temperatures are ``tau_rows[t, j] * ramp_i`` in float32, the
    fixed schedule's values wherever the temperatures are its own.  The
    loss runs on padded blocks (``_loss_fn``): a group's size changes from
    rung to rung.

    Returns orders (k, N), losses (T, k) and the last round's trained
    keys ws (k, N), all on the device.
    """
    dev = xs.device
    tau_rows = np.asarray(tau_rows, np.float32)
    tau_inner = torch.as_tensor(tau_rows[:, :, None] * _inner_ramp(cfg),
                                device=dev)               # (T, k, I)
    bias1, bias2 = _adam_bias(cfg, dev)
    losses, w = [], None
    for t in range(tau_rows.shape[0]):
        orders, loss, w = _outer_round(
            xs, orders, source.next_round(rows), tau_inner[t], norms, bias1,
            bias2, hw=hw, cfg=cfg, apply_fn=apply_fn, pad_rows=True)
        losses.append(loss)
    return orders, torch.stack(losses), w


def make_adaptive_controller(cfg: ShuffleSoftSortConfig, n_instances: int,
                             n: int, seg_len: int | None = None
                             ) -> AdaptiveController:
    """An ``AdaptiveController`` on this config's tau schedule and band
    half-width for problem size ``n``; ``seg_len`` (a divisor of
    ``cfg.rounds``) overrides the decision quantum."""
    return AdaptiveController(
        cfg, n_instances, taus=_tau_schedule(cfg),
        band=resolve_band(cfg, n),
        seg_len=adaptive_seg_len(cfg) if seg_len is None else int(seg_len))


def _run_adaptive(xs_t, orders, source: ShuffleSource, norms_t, *, hw,
                  cfg: ShuffleSoftSortConfig, controller: AdaptiveController,
                  boundary_hook: Optional[Callable] = None,
                  rung_hook: Optional[Callable[[int], None]] = None,
                  check_finite: bool = True):
    """The adaptive schedule: rung by rung until no instance is live.

    Each rung advances every live instance by ``seg_len`` rounds.  The
    live instances split by the controller's measured regime into a dense
    and a banded group; each group runs as one ragged dispatch at its
    instances' own temperatures (one launch per kernel per inner step per
    group).  Rows are gathered and scattered on the device; only the
    rung's losses and last keys go to the host, where the controller
    observes them and decides jumps, stops and switches for the next
    rung.  Stopped (or culled) instances leave the groups and draw no more
    shuffles.

    ``rung_hook(executed_rounds)`` runs at the top of each rung, before
    any work; ``boundary_hook(step, controller, losses)`` after each
    boundary's observe (the tournament culls from it).

    Returns orders (BS, N) on the device, losses (BS, R) float32, NaN at
    the rounds an instance never ran (``controller.executed`` counts the
    rounds each ran), and the instance-rounds run on the device, the sum
    over dispatches of rounds x group size.
    """
    ctrl = controller
    seg = ctrl.seg_len
    dev = xs_t.device
    bs, n = orders.shape
    dense_fn = _select_apply_fn(cfg)
    band_fn = (dense_fn if ctrl.band is None
               else _select_apply_fn(cfg, ctrl.band))
    losses_mat = np.full((bs, cfg.rounds), np.nan, np.float32)
    device_rounds = 0
    step = 0
    while True:
        live = ctrl.live_indices()
        if live.size == 0:
            break
        if rung_hook is not None:
            rung_hook(step * seg)
        # Stopped instances never rejoin, so every live instance has run
        # exactly step * seg rounds.
        exec0 = step * seg
        seg_losses = np.empty((live.size, seg), np.float32)
        ws_live = np.empty((live.size, n), np.float32)
        banded_mask = ctrl.banded[live]
        for is_banded in (False, True):
            sel = np.flatnonzero(banded_mask == is_banded)
            if sel.size == 0:
                continue
            gidx = live[sel]
            rows = torch.as_tensor(gidx, device=dev)
            o, l, w = _run_rounds_ragged(
                xs_t[rows], orders[rows], source, gidx, ctrl.tau_rows(gidx),
                norms_t[rows], hw=hw, cfg=cfg,
                apply_fn=band_fn if is_banded else dense_fn)
            orders = orders.index_copy(0, rows, o)
            seg_losses[sel] = l.cpu().numpy().T
            ws_live[sel] = w.cpu().numpy()
            device_rounds += seg * gidx.size
        if check_finite:
            _check_finite(seg_losses.T, exec0, cfg, "adaptive", ws=ws_live)
        losses_mat[live, exec0:exec0 + seg] = seg_losses
        ctrl.observe(live, seg_losses, ws_live)
        if boundary_hook is not None:
            boundary_hook(step + 1, ctrl, losses_mat)
        step += 1
    return orders, losses_mat, device_rounds


def rung_aligned_switch(cfg: ShuffleSoftSortConfig, n: int,
                        seg_len: int) -> int:
    """The dense->banded switch round snapped UP to the next multiple of
    ``seg_len`` (capped at ``cfg.rounds``).

    A scheduler that preempts only at rung boundaries (multiples of its
    segment length) cannot split a segment at a mid-rung switch the way
    ``_run_rounds`` does; the switch is deferred to the next boundary
    instead (a few more rounds run dense: exact, only costlier), so that
    no segment straddles regimes.  ``run_round_segment`` requires of its
    callers that every instance of a segment is in one regime relative to
    this round.
    """
    switch = _band_switch_round(cfg, n)
    if switch >= cfg.rounds:
        return cfg.rounds
    return min(-(-switch // seg_len) * seg_len, cfg.rounds)


def run_round_segment(xs, orders, norms, progress, seg_len: int, *,
                      source: ShuffleSource, rows=None, hw,
                      cfg: ShuffleSoftSortConfig, device=None, mesh=None,
                      regime: str | None = None, with_w: bool = False,
                      guardrail=None):
    """Round-boundary join/leave hook for continuous-batching servers.

    Runs ``seg_len`` outer rounds on BS instances where instance i takes
    ITS OWN slice ``[progress[i], progress[i] + seg_len)`` of the tau
    schedule, so one batch can mix instances that joined the anneal at
    different times, and an instance leaves at any boundary without
    perturbing the others.  Each instance draws its shuffles from its own
    stream in ``source`` (``rows``), which carries the stream state from
    call to call: chaining the returned orders through successive calls
    reproduces an uninterrupted run bitwise.

    All instances of one call must be in the same apply regime relative to
    ``rung_aligned_switch``; a batch that mixes regimes or straddles the
    switch raises ``ValueError``.  ``regime="dense"`` / ``"banded"``
    selects the apply explicitly instead (an adaptive scheduler that
    decides regimes on the measured tail bound owns the grouping), and
    ``with_w=True`` also returns each instance's end-of-segment trained
    keys, the observation ``AdaptiveController`` consumes.

    Args:
      xs: (BS, N, d) instances.
      orders: (BS, N) current permutations.
      norms: (BS,) per-instance loss normalizations.
      progress: (BS,) int, each instance's current global round.
      seg_len: rounds to run (the scheduler's preemption quantum).
      source: the shuffle source (``repro_torch.core.prng``).
      rows: (BS,) the instances' indices in ``source`` (None: 0..BS-1).
      device: where to run (None: CUDA, and an error without it).
      regime: None infers the apply from ``rung_aligned_switch`` and
        checks the batch against it; "dense" / "banded" selects it.
      with_w: also return the end-of-segment trained keys.

    Returns:
      (orders (BS, N), losses (seg_len, BS)) on the device, plus
      ``ws (BS, N)`` with ``with_w=True``.
    """
    _check_ported(cfg, mesh=mesh, guardrail=guardrail)
    device = resolve_device(device)
    xs = torch.as_tensor(xs, dtype=_F32, device=device)
    orders = torch.as_tensor(orders, device=device).to(torch.int64)
    if not isinstance(norms, torch.Tensor):
        norms = np.array(norms, np.float32)
    norms = torch.as_tensor(norms, dtype=_F32, device=device)
    seg_len = int(seg_len)
    bs, n = xs.shape[0], xs.shape[1]
    p = np.asarray(progress, np.int64)
    rows = np.arange(bs) if rows is None else np.asarray(rows, np.int64)
    if seg_len < 1 or p.shape != (bs,) or rows.shape != (bs,):
        raise ValueError(f"need seg_len >= 1 and progress and rows of shape "
                         f"({bs},), got seg_len={seg_len}, progress "
                         f"{p.shape}, rows {rows.shape}")
    if (p < 0).any() or (p + seg_len > cfg.rounds).any():
        raise ValueError(
            f"segment [{p.min()}, {p.max() + seg_len}) escapes the "
            f"{cfg.rounds}-round schedule")
    band = resolve_band(cfg, n)
    if regime is not None:
        if regime not in ("dense", "banded"):
            raise ValueError(f"regime={regime!r} must be 'dense' or "
                             "'banded'")
        if regime == "banded" and band is None:
            raise ValueError("regime='banded' requires a resolvable "
                             "cfg.band for this problem size")
        banded = regime == "banded"
    else:
        switch = rung_aligned_switch(cfg, n, seg_len)
        if band is None or (p + seg_len <= switch).all():
            banded = False
        elif (p >= switch).all():
            banded = True
        else:
            raise ValueError(
                f"instances at rounds {sorted(set(p.tolist()))} mix apply "
                f"regimes across the rung-aligned dense->banded switch "
                f"{switch}; group instances by regime "
                f"(rung_aligned_switch)")
    tau_rows = _tau_schedule(cfg)[p[:, None] + np.arange(seg_len)].T
    orders, losses, ws = _run_rounds_ragged(
        xs, orders, source, rows, tau_rows, norms, hw=hw, cfg=cfg,
        apply_fn=_select_apply_fn(cfg, band if banded else None))
    return (orders, losses, ws) if with_w else (orders, losses)


def _prep_instances(xs, hw, n_restarts, seed, seeds, source, norms, state,
                    device):
    """Normalize the engine inputs into flattened (BS, ...) instances,
    problem-major (restart s of problem b at row ``b * S + s``).

    Returns (xs (B, N, d), B, S, N, source, xs_t, norms_t, orders,
    prior losses (BS, start))."""
    xs = torch.as_tensor(xs if isinstance(xs, torch.Tensor) else
                         np.asarray(xs), dtype=_F32, device=device)
    if xs.dim() != 3:
        raise ValueError(f"xs must be (B, N, d), got {tuple(xs.shape)}")
    b, n, _ = xs.shape
    s = int(n_restarts)
    if s < 1 or n != hw[0] * hw[1]:
        raise ValueError(f"need n_restarts >= 1 and N == h * w, got "
                         f"n_restarts={n_restarts}, N={n}, hw={hw}")
    bs = b * s
    if norms is None:
        norms = torch.stack([mean_pairwise_distance(xi) for xi in xs])
    elif not isinstance(norms, torch.Tensor):
        norms = torch.as_tensor(np.array(norms, np.float32))
    norms = norms.to(device=device, dtype=_F32).reshape(b)
    xs_t = torch.repeat_interleave(xs, s, dim=0)
    norms_t = torch.repeat_interleave(norms, s, dim=0)
    if state is None:
        orders = torch.arange(n, device=device).repeat(bs, 1)
        prior = torch.zeros((bs, 0), dtype=_F32, device=device)
    else:
        orders = torch.as_tensor(state[0], device=device).to(torch.int64)
        prior = torch.as_tensor(state[1], dtype=_F32, device=device)
        if (orders.shape != (bs, n) or prior.dim() != 2
                or prior.shape[0] != bs):
            raise ValueError(f"state must be (orders ({bs}, {n}), losses "
                             f"({bs}, R0)), got {tuple(orders.shape)}, "
                             f"{tuple(prior.shape)}")
    if source is None:
        if seeds is None:
            seeds = instance_seeds(seed, bs)
        seeds = [int(v) for v in np.asarray(seeds, np.int64).reshape(bs)]
        source = TorchShuffleSource(seeds, n, device)
    return xs, b, s, n, source, xs_t, norms_t, orders, prior


def shuffle_soft_sort(
    x,
    hw: tuple[int, int],
    cfg: ShuffleSoftSortConfig = ShuffleSoftSortConfig(),
    seed: int = 0,
    callback: Optional[Callable[[int, np.ndarray, float], None]] = None,
    *,
    device=None,
    source=None,
    norm=None,
    state=None,
    checkpoint_dir: str | None = None,
    guardrail=None,
) -> tuple[np.ndarray, np.ndarray, list[float]]:
    """Sort x (N, d) onto an (h, w) grid.  Returns (order, x[order], losses).

    ``seed`` seeds the shuffle stream; ``source`` (a shuffle source of
    ``repro_torch.core.prng``) replaces it.  ``norm`` overrides the loss
    normalization ``mean_pairwise_distance(x)``.  ``state`` =
    ``(orders (1, N), losses (1, R0))`` continues a run after round R0
    (see ``repro_torch.core.reference``).  ``callback(r, order, loss)``
    is called after every round.  ``losses`` is the per-round list, one
    host sync per round, with a ``NumericalDivergence`` check on each.

    ``cfg.schedule="adaptive"`` runs the plateau controller
    (``repro_torch.core.annealing``): the run may stop at a rung boundary,
    so ``losses`` holds the executed rounds only.  It decides at rung
    boundaries, so it takes no per-round ``callback`` and no ``state``.
    """
    _check_ported(cfg, checkpoint_dir=checkpoint_dir, guardrail=guardrail)
    if cfg.schedule == "adaptive":
        _check_adaptive(callback, state)
        res = shuffle_soft_sort_batched(
            x[None], hw, cfg, 1, seeds=[seed], device=device, source=source,
            norms=None if norm is None else [norm])
        executed = int(res.rounds_executed[0, 0])
        return (res.order[0], res.sorted[0],
                [float(v) for v in res.losses[0][:executed]])
    device = resolve_device(device)
    x_t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                          else x, dtype=_F32, device=device)
    xs, _, _, n, source, xs_t, norms_t, orders, prior = _prep_instances(
        x_t[None], hw, 1, None, [seed], source,
        None if norm is None else [norm], state, device)
    losses = [float(v) for v in prior[0].cpu()]
    start = len(losses)

    def on_round(r, orders_r, loss_r):
        losses.append(float(loss_r[0]))
        _check_finite(np.asarray(losses[start:], np.float32)[:, None],
                      start, cfg, "sequential")
        if callback is not None:
            callback(r, orders_r[0].to(torch.int32).cpu().numpy(),
                     losses[-1])

    orders, _ = _run_rounds(xs_t, orders, source, norms_t, start, hw=hw,
                            cfg=cfg, on_round=on_round)
    order = orders[0].to(torch.int32).cpu().numpy()
    return order, xs[0].cpu().numpy()[order], losses


def _check_adaptive(callback, state) -> None:
    if callback is not None:
        raise ValueError(
            "callback streaming is not supported with schedule='adaptive' "
            "(decisions happen at rung boundaries, not per round)")
    if state is not None:
        raise ValueError("state= continues a fixed-schedule run; "
                         "schedule='adaptive' starts from round 0")


@dataclasses.dataclass(frozen=True)
class BatchedSortResult:
    """Result of ``shuffle_soft_sort_batched`` over B problems x S restarts.

    The per-problem fields report the winning restart, the one whose
    final-round loss is lowest (with the adaptive schedule: whose
    last-executed loss is lowest); the ``all_*`` fields keep every
    restart.
    """
    order: np.ndarray          # (B, N) int32 — best restart's permutation
    sorted: np.ndarray         # (B, N, d) — xs gathered by ``order``
    losses: np.ndarray         # (B, R) — per-round losses of the best restart
    best_restart: np.ndarray   # (B,) int — argmin_s all_losses[:, s, -1]
    all_orders: np.ndarray     # (B, S, N) int32 — every restart's permutation
    all_losses: np.ndarray     # (B, S, R) — every restart's loss trace
    # schedule="adaptive" only (None on the fixed schedule): the rounds
    # each restart ran; its loss trace is NaN past them.
    rounds_executed: np.ndarray | None = None   # (B, S) int64


def shuffle_soft_sort_batched(
    xs,
    hw: tuple[int, int],
    cfg: ShuffleSoftSortConfig = ShuffleSoftSortConfig(),
    n_restarts: int = 1,
    seed: int = 0,
    seeds: Sequence[int] | None = None,
    callback: Optional[Callable[[int, np.ndarray, np.ndarray], None]] = None,
    mesh=None,
    *,
    device=None,
    source=None,
    norms=None,
    state=None,
    checkpoint_dir: str | None = None,
    guardrail=None,
) -> BatchedSortResult:
    """Sort B problems at once, S random restarts each, as one (B*S, N)
    batch: each inner step launches every kernel once for all instances.

    Instance i (row ``b * S + s``) draws its shuffles from a generator
    seeded with ``seeds[i]`` (default: ``instance_seeds(seed, B * S)``),
    so it matches ``shuffle_soft_sort(xs[b], ..., seed=seeds[i])``.
    ``source`` (a shuffle source of ``repro_torch.core.prng``) replaces
    the shuffle stream; ``norms`` (B,) overrides the per-problem
    loss normalization; ``state`` = ``(orders (B*S, N), losses (B*S, R0))``
    continues a run after round R0.  ``callback(r, orders (B*S, N),
    losses (B*S,))`` is called after every round (a host sync); without
    it the losses stay on the device until the end.

    ``cfg.schedule="adaptive"`` runs every instance under the plateau
    controller; the result then carries ``rounds_executed`` (B, S), loss
    traces NaN past each early stop, and winners chosen by their
    last-executed loss.  It takes no ``callback`` and no ``state``.
    """
    _check_ported(cfg, mesh=mesh, checkpoint_dir=checkpoint_dir,
                  guardrail=guardrail)
    if cfg.schedule == "adaptive":
        _check_adaptive(callback, state)
    device = resolve_device(device)
    xs, b, s, n, source, xs_t, norms_t, orders, prior = _prep_instances(
        xs, hw, n_restarts, seed, seeds, source, norms, state, device)
    if cfg.schedule == "adaptive":
        return _batched_adaptive(xs, b, s, n, source, xs_t, norms_t, orders,
                                 hw=hw, cfg=cfg)
    start = prior.shape[1]

    on_round = None
    if callback is not None:
        def on_round(r, orders_r, loss_r):
            loss_np = loss_r.cpu().numpy()
            _check_finite(loss_np[None], r, cfg, "batched")
            callback(r, orders_r.to(torch.int32).cpu().numpy(), loss_np)

    orders, losses_rb = _run_rounds(xs_t, orders, source, norms_t, start,
                                    hw=hw, cfg=cfg, on_round=on_round)
    losses_np = losses_rb.cpu().numpy()
    if callback is None:
        _check_finite(losses_np, start, cfg, "batched")
    all_losses = np.concatenate([prior.cpu().numpy(), losses_np.T], axis=1)
    all_losses = all_losses.reshape(b, s, cfg.rounds)
    all_orders = orders.to(torch.int32).cpu().numpy().reshape(b, s, n)
    best = np.argmin(all_losses[:, :, -1], axis=1)
    order = all_orders[np.arange(b), best]
    xs_np = xs.cpu().numpy()
    return BatchedSortResult(
        order=order,
        sorted=np.take_along_axis(xs_np, order[:, :, None].astype(np.int64),
                                  axis=1),
        losses=all_losses[np.arange(b), best],
        best_restart=best,
        all_orders=all_orders,
        all_losses=all_losses,
    )


def _batched_adaptive(xs, b, s, n, source, xs_t, norms_t, orders, *, hw,
                      cfg: ShuffleSoftSortConfig) -> BatchedSortResult:
    """``shuffle_soft_sort_batched`` on the adaptive schedule."""
    bs = b * s
    ctrl = make_adaptive_controller(cfg, bs, n)
    orders, losses_bs, _ = _run_adaptive(xs_t, orders, source, norms_t,
                                         hw=hw, cfg=cfg, controller=ctrl)
    all_losses = losses_bs.reshape(b, s, cfg.rounds)
    all_orders = orders.to(torch.int32).cpu().numpy().reshape(b, s, n)
    final = losses_bs[np.arange(bs), ctrl.executed - 1].reshape(b, s)
    best = np.argmin(final, axis=1)
    order = all_orders[np.arange(b), best]
    xs_np = xs.cpu().numpy()
    return BatchedSortResult(
        order=order,
        sorted=np.take_along_axis(xs_np, order[:, :, None].astype(np.int64),
                                  axis=1),
        losses=all_losses[np.arange(b), best],
        best_restart=best,
        all_orders=all_orders,
        all_losses=all_losses,
        rounds_executed=ctrl.executed.reshape(b, s),
    )


# --------------------------------------------------------------------------
# Restart tournament: successive halving over the restart axis.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TournamentResult:
    """Result of ``restart_tournament``: successive-halving restarts.

    ``rounds_run / rounds_full`` is the compute fraction the tournament
    spent against running every restart to the end; culling can drop a
    late-blooming restart, which is the quality it risks for it.
    """
    order: np.ndarray          # (B, N) int32: winning restart's permutation
    sorted: np.ndarray         # (B, N, d): xs gathered by ``order``
    final_loss: np.ndarray     # (B,): winner's last-round loss
    best_restart: np.ndarray   # (B,): winner's ORIGINAL restart index
    survivors: tuple           # per rung: (B, S_k) original restart indices
    all_losses: np.ndarray     # (B, S, R): NaN after a restart is culled
    rounds_run: int            # instance-rounds executed on the device
    rounds_full: int           # B * S * R: the no-culling engine's cost


def _rung_boundaries(rounds: int, n_rungs: int) -> list[int]:
    """Split the R-round anneal into ``n_rungs`` contiguous segments;
    returns the (strictly increasing) end round of each rung, last == R."""
    if n_rungs < 1:
        raise ValueError(f"n_rungs must be >= 1, got {n_rungs}")
    edges, prev = [], 0
    for k in range(n_rungs):
        end = round(rounds * (k + 1) / n_rungs)
        if end > prev:
            edges.append(end)
            prev = end
    return edges


def _tournament_cull(final_losses: np.ndarray, keep: int) -> np.ndarray:
    """The ``keep`` best restart slots per problem of (B, S_k) rung-end
    losses: (B, keep) int64 slots of the CURRENT live set, ascending per
    problem (a stable sort: ties keep the lower slot)."""
    s_k = final_losses.shape[1]
    if not 1 <= keep <= s_k:
        raise ValueError(f"keep={keep} outside 1..{s_k}")
    sel = np.argsort(final_losses, axis=1, kind="stable")[:, :keep]
    sel.sort(axis=1)
    return sel


def _survivor_count(s_k: int, cull_fraction: float) -> int:
    return max(1, int(np.ceil(s_k * (1.0 - cull_fraction))))


def restart_tournament(
    xs,
    hw: tuple[int, int],
    cfg: ShuffleSoftSortConfig = ShuffleSoftSortConfig(),
    n_restarts: int = 8,
    seed: int = 0,
    seeds: Sequence[int] | None = None,
    cull_fraction: float = 0.5,
    n_rungs: int = 3,
    mesh=None,
    *,
    device=None,
    source=None,
    norms=None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    rung_hook: Optional[Callable[[int], None]] = None,
    check_finite: bool = True,
    guardrail=None,
    mesh_hook=None,
) -> TournamentResult:
    """Successive-halving restart scheduler over the batched engine.

    Runs S restarts per problem for the first ``1/n_rungs`` of the anneal,
    then at each rung boundary culls the worst ``cull_fraction`` of the
    live restarts (per problem, by rung-end loss) and anneals only the
    survivors, so the batch shrinks and later rounds launch on fewer
    instances.  The survivors' rows are gathered on the device; only each
    culled rung's (B * S_k,) last losses cross to the host for the
    decision.  Each restart draws its own shuffle stream, so a culled
    restart's stream simply stops, and a restart that survives every cull
    finishes bitwise the same (b, s) instance of
    ``shuffle_soft_sort_batched``.

    Args:
      xs, hw, cfg, n_restarts, seed, seeds, device, source, norms: as in
        ``shuffle_soft_sort_batched``.
      cull_fraction: fraction of live restarts dropped at each rung
        boundary (0 disables culling; 0.5 halves).
      n_rungs: number of anneal segments; culls happen at the
        ``n_rungs - 1`` interior boundaries.  With
        ``schedule="adaptive"`` the rungs are counted in controller steps
        (``adapt_every`` rounds), and a restart ranks by its
        last-executed loss.
      rung_hook: ``f(start_round)``, called before each rung.
      check_finite: raise ``NumericalDivergence`` on a non-finite loss.
      mesh, mesh_hook, checkpoint_dir, resume, guardrail: not ported yet
        (``NotImplementedError``).

    Returns:
      ``TournamentResult``, see its field docs.
    """
    if not 0.0 <= cull_fraction < 1.0:
        raise ValueError(f"cull_fraction must be in [0, 1), got "
                         f"{cull_fraction}")
    _check_ported(cfg, mesh=mesh, mesh_hook=mesh_hook,
                  checkpoint_dir=checkpoint_dir, resume=resume,
                  guardrail=guardrail)
    device = resolve_device(device)
    xs, b, s, n, source, xs_t, norms_t, orders, _ = _prep_instances(
        xs, hw, n_restarts, seed, seeds, source, norms, None, device)
    if cfg.schedule == "adaptive":
        return _restart_tournament_adaptive(
            xs, b, s, n, source, xs_t, norms_t, orders, hw=hw, cfg=cfg,
            cull_fraction=cull_fraction, n_rungs=n_rungs,
            rung_hook=rung_hook, check_finite=check_finite)
    edges = _rung_boundaries(cfg.rounds, n_rungs)

    # The live set is problem-major: live slot j of problem p at row
    # p * S_k + j; ``alive`` maps live slots to original restart indices.
    alive = np.tile(np.arange(s), (b, 1))                 # (B, S_k)
    rungs = []              # (start, end, alive, losses (T, B * S_k))
    survivors_log = []
    rounds_run = start = 0
    for k, end in enumerate(edges):
        if rung_hook is not None:
            rung_hook(start)
        s_k = alive.shape[1]
        rows = (np.arange(b)[:, None] * s + alive).reshape(-1)
        orders, losses = _run_rounds(xs_t, orders, source, norms_t, start,
                                     end, rows=rows, hw=hw, cfg=cfg,
                                     pad_rows=True)
        rounds_run += (end - start) * b * s_k
        rungs.append((start, end, alive, losses))
        keep = _survivor_count(s_k, cull_fraction)
        if k < len(edges) - 1 and keep < s_k:
            last = losses[-1].cpu().numpy().reshape(b, s_k)
            sel = _tournament_cull(last, keep)            # (B, keep)
            alive = np.take_along_axis(alive, sel, axis=1)
            idx = torch.as_tensor(
                (np.arange(b)[:, None] * s_k + sel).reshape(-1),
                device=device)
            xs_t = torch.repeat_interleave(xs, keep, dim=0)
            orders = orders.index_select(0, idx)
            norms_t = norms_t.index_select(0, idx)
        survivors_log.append(alive.copy())
        start = end

    all_losses = np.full((b, s, cfg.rounds), np.nan, np.float32)
    for s0, s1, alive_k, losses in rungs:
        seg = losses.cpu().numpy()                        # (T, B * S_k)
        if check_finite:
            _check_finite(seg, s0, cfg, "tournament")
        all_losses[np.arange(b)[:, None], alive_k, s0:s1] = (
            seg.T.reshape(b, alive_k.shape[1], s1 - s0))
    final = all_losses[np.arange(b)[:, None], alive, -1]  # (B, S_fin)
    win = np.argmin(final, axis=1)                        # live slot
    order = orders.to(torch.int32).cpu().numpy().reshape(
        b, alive.shape[1], n)[np.arange(b), win]
    return _tournament_result(xs, order, final[np.arange(b), win],
                              alive[np.arange(b), win], survivors_log,
                              all_losses, rounds_run, b * s * cfg.rounds)


def _tournament_result(xs, order, final_loss, best_restart, survivors_log,
                       all_losses, rounds_run, rounds_full
                       ) -> TournamentResult:
    xs_np = xs.cpu().numpy()
    return TournamentResult(
        order=order,
        sorted=np.take_along_axis(xs_np, order[:, :, None].astype(np.int64),
                                  axis=1),
        final_loss=final_loss,
        best_restart=best_restart,
        survivors=tuple(survivors_log),
        all_losses=all_losses,
        rounds_run=int(rounds_run),
        rounds_full=int(rounds_full),
    )


def _restart_tournament_adaptive(xs, b, s, n, source, xs_t, norms_t, orders,
                                 *, hw, cfg: ShuffleSoftSortConfig,
                                 cull_fraction: float, n_rungs: int,
                                 rung_hook=None, check_finite: bool = True
                                 ) -> TournamentResult:
    """The tournament on the adaptive schedule: ``_run_adaptive`` with a
    cull hook at the rung edges.

    Edges are counted in controller steps (``_rung_boundaries`` over the
    R / seg_len decision points), so culls land on the boundaries the
    controller observes at.  A cull ranks every restart still in the
    tournament by its LAST-EXECUTED loss: an early-stopped restart keeps
    competing with its final loss, and a culled one leaves through
    ``AdaptiveController.mark_culled``; the survivors' streams never see
    a perturbation.  The cross-rung cull state (the alive set and the
    survivors log) lives in one dict, ``hstate``, for a checkpoint to
    carry.
    """
    ctrl = make_adaptive_controller(cfg, b * s, n)
    n_steps = cfg.rounds // ctrl.seg_len
    edges = _rung_boundaries(n_steps, min(n_rungs, n_steps))
    interior, edge_set = set(edges[:-1]), set(edges)
    # "alive": the live (B, S_k) map; "surv_<i>": the survivors log, one
    # entry per edge (numbered keys: the widths shrink).
    hstate: dict[str, np.ndarray] = {"alive": np.tile(np.arange(s), (b, 1))}

    def hook(step, ctrl_, losses_mat):
        if step not in edge_set:
            return
        alive = hstate["alive"]
        s_k = alive.shape[1]
        keep = _survivor_count(s_k, cull_fraction)
        if step in interior and keep < s_k:
            rows = np.arange(b)[:, None] * s + alive      # flattened rows
            last = losses_mat[rows, ctrl_.executed[rows] - 1]
            sel = _tournament_cull(last, keep)           # (B, keep)
            kept = np.zeros((b, s_k), bool)
            np.put_along_axis(kept, sel, True, axis=1)
            ctrl_.mark_culled(rows[~kept])
            alive = np.take_along_axis(alive, sel, axis=1)
            hstate["alive"] = alive
        n_logged = sum(1 for kk in hstate if kk.startswith("surv_"))
        hstate[f"surv_{n_logged:03d}"] = alive.copy()

    orders, losses_mat, device_rounds = _run_adaptive(
        xs_t, orders, source, norms_t, hw=hw, cfg=cfg, controller=ctrl,
        boundary_hook=hook, rung_hook=rung_hook, check_finite=check_finite)
    # If every restart stopped before a late edge, its hook never fired;
    # the live set was already final, so it stands for those rungs too.
    alive = hstate["alive"]
    survivors_log = [hstate[kk] for kk in
                     sorted(kk for kk in hstate if kk.startswith("surv_"))]
    while len(survivors_log) < len(edges):
        survivors_log.append(alive.copy())
    rows = np.arange(b)[:, None] * s + alive              # (B, S_fin)
    final = losses_mat[rows, ctrl.executed[rows] - 1]
    win = np.argmin(final, axis=1)
    best_restart = alive[np.arange(b), win]
    order = orders.to(torch.int32).cpu().numpy().reshape(b, s, n)[
        np.arange(b), best_restart]
    return _tournament_result(xs, order, final[np.arange(b), win],
                              best_restart, survivors_log,
                              losses_mat.reshape(b, s, cfg.rounds),
                              device_rounds, b * s * cfg.rounds)

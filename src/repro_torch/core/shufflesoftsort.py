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

Counterpart of ``repro.core.shufflesoftsort``, fixed and adaptive
schedules.  The engine runs B problems x S restarts as one (BS, N) batch;
``shuffle_soft_sort`` is the BS = 1 case of the same code.  With ``mesh=``
(a ``repro_torch.launch.mesh.SortMesh``) every engine splits that batch
over the mesh's slots (``_sharded``), bitwise the same per instance, and
``mesh_hook=`` re-shards at rung boundaries.  Each round's shuffles come from a shuffle source
(``repro_torch.core.prng``): per-instance ``torch.Generator`` streams by
default, the reference's own ``jax.random`` key chains with ``key=`` /
``keys=`` (bitwise its shuffles), or a replayed array.
``cfg.use_kernel`` routes the SoftSort
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

Preemption safety and integrity probes, as in the reference: every
engine takes ``checkpoint_dir=``, ``resume=``, ``rung_hook=``,
``check_finite=`` and ``guardrail=`` (``run_round_segment`` takes
``guardrail=`` only), the fixed batched engine and ``shuffle_soft_sort``
also ``checkpoint_every=``.  At each rung boundary the engine publishes
its carry through ``repro_torch.runtime.anneal_checkpoint`` after the
finite sentinel and the probes of ``repro_torch.runtime.guardrails``, so
the newest checkpoint is always the last verified rung; a resumed run
finishes bitwise the uninterrupted one.  The snapshots are the
reference's field for field (orders, losses, the adaptive controller's
``ctrl_*`` and the hook's ``hs_*`` state, the tournament's ``norms``,
``alive``, ``all_losses`` and ``surv_%03d``) but one: the reference's
(BS, 2) uint32 ``keys`` (``key`` in the sequential engine) is the
shuffle source's state here, ``source`` (``ShuffleSource.state_dict``),
and the fingerprint names the source's kind.  With none of these knobs
set, the fixed batched engine runs one segment and brings nothing to the
host before the run's end.  A shadow-sampled rung is replayed on its own
tier and compared bitwise, and on the kernel tier its last trained keys
also go through the kernel and the plain apply (``_shadow_checks``).

``soft_sort_baseline`` is the paper's plain SoftSort (Table III): one key
vector trained end to end, no shuffles.

Under ``torch.profiler`` the engines mark their phases as spans of
``repro_torch.spans`` (``call``, ``prep``, ``round``, ``shuffle``,
``step``, ``loss``, ``apply.fwd``, ``backward``, ``adam``, ``commit``,
``fetch``; the kernel tier's backward adds ``apply.bwd``); with no
profiler recording a span is one flag check.

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

from repro_torch import spans
from repro_torch.core.annealing import AdaptiveController, adaptive_seg_len
from repro_torch.core.losses import grid_sorting_loss, mean_pairwise_distance
from repro_torch.core import threefry
from repro_torch.core.prng import (
    ShuffleSource,
    ThreefryShuffleSource,
    TorchShuffleSource,
    _rows,
    instance_seeds,
)
from repro_torch.core.softsort import (
    softsort_apply_banded,
    softsort_apply_chunked,
)
from repro_torch.runtime.checkpoint import _host

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


def _check_config(cfg: ShuffleSoftSortConfig) -> None:
    _check_schedule(cfg)
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, got "
                         f"{cfg.compute_dtype}")


def _check_mesh(mesh):
    """``mesh`` as a ``SortMesh`` (or None); anything else is a
    ``TypeError``."""
    if mesh is None:
        return None
    from repro_torch.launch.mesh import SortMesh
    if not isinstance(mesh, SortMesh):
        raise TypeError(
            "mesh= must be a SortMesh (repro_torch.launch.mesh"
            f".make_sort_mesh) or None, got {mesh!r}")
    return mesh


def _run_device(device, mesh) -> torch.device:
    """Where a run's carry lives: ``device``, or with none given the first
    slot's device of ``mesh`` (and CUDA without a mesh)."""
    if device is None and mesh is not None:
        return mesh.slots[0].device
    return resolve_device(device)


def _swap_mesh(mesh_hook, start: int, mesh):
    """The elastic re-shard seam: ``mesh_hook(start, mesh)`` may return a
    replacement mesh for the rungs from ``start`` on (None keeps it).  The
    carry is layout-free (orders and streams on the run's device, copied
    to the slots per dispatch), so a swap changes no result."""
    if mesh_hook is None:
        return mesh
    new = mesh_hook(start, mesh)
    return mesh if new is None else _check_mesh(new)


def _padded(bs: int, mesh) -> int:
    """The rows a dispatch of ``bs`` instances runs: a multiple of the
    mesh's slot count (the tail padded with copies of instance 0)."""
    d = 1 if mesh is None else len(mesh)
    return -(-bs // d) * d


def _sharded(mesh, run, xs, orders, norms, source: ShuffleSource, rows,
             cols=None):
    """One dispatch of a (BS, N) batch split over ``mesh``'s slots.

    The rows pad to a multiple of the slot count with copies of instance
    0; slot j runs the contiguous slice j on its own device through
    ``run(xs, orders, source, norms, cols)`` (``cols``: the slice's columns
    of a (T, BS) array, the ragged engine's temperatures), one slot after
    the other from this thread.  Each slot draws from a copy of its
    instances' streams (``source.take(rows, device)``) taken at the
    dispatch's start, a padding row from a copy of instance 0's, so every
    stream advances once per round; the slots' streams are committed back
    in instance order, and the outputs (orders, (T, BS) losses, last keys)
    are gathered onto the batch's device, the padding cut off.  A slot's
    loss runs in blocks of exactly 8 instances, as every loss does
    (``_loss_fn``, Queues C7 and C12), so each instance's results are
    bitwise the unsharded dispatch's."""
    home = xs.device
    bs = xs.shape[0]
    per = _padded(bs, mesh) // len(mesh)
    idx = np.concatenate([np.arange(bs),
                          np.zeros(per * len(mesh) - bs, np.int64)])
    src_rows = _rows(rows, len(source))
    slots = []
    for j, slot in enumerate(mesh.slots):
        part = idx[j * per:(j + 1) * per]
        sel = torch.as_tensor(part, device=home)
        slots.append((slot.device, part, sel,
                      source.take(src_rows[part], slot.device)))
    outs = [run(xs[sel].to(dev), orders[sel].to(dev), src,
                norms[sel].to(dev), None if cols is None else cols[:, part])
            for dev, part, sel, src in slots]
    state = source.state_dict()
    for j, (dev, part, sel, src) in enumerate(slots):
        real = np.arange(j * per, (j + 1) * per) < bs
        state[src_rows[part[real]]] = src.state_dict()[real]
    source.load_state_dict(state)
    o = torch.cat([out[0].to(home) for out in outs])[:bs]
    l = torch.cat([out[1].to(home) for out in outs], dim=1)[:, :bs]
    w = (None if outs[0][2] is None else
         torch.cat([out[2].to(home) for out in outs])[:bs])
    return o, l, w


# Rows of one loss evaluation.  PyTorch's CUDA reductions choose how they
# split each row's sum from the number of rows they reduce, so an
# instance's loss can change in its last bits with the batch around it (on
# an H100 at N = 4096, d = 50, against 32 instances: the loss values at 4,
# 8 and 12, the std term's gradient at one; ``chip_smoke.py``'s
# ``loss_block_check``; at N = 1024, d = 3 one row against 8 moved a
# sequential run off its batched row, Queue C12).  Every batch is
# therefore evaluated in blocks of exactly _LOSS_ROWS rows, a short block
# padded: every instance sees one reduction however many instances share
# its dispatch, a sequential run's one instance too.
_LOSS_ROWS = 8


def _loss_fn(w, x_shuf, inv_shuf, tau, hw, norm, cfg: ShuffleSoftSortConfig,
             apply_fn) -> torch.Tensor:
    """(BS,) losses of a (BS, N) key batch; ``norm`` is (BS,)."""
    with spans.span("loss", x_shuf.device):
        with spans.span("apply.fwd", x_shuf.device):
            y_shuf, colsum = apply_fn(w, x_shuf, tau)
        d = y_shuf.shape[-1]
        y = torch.gather(y_shuf, 1, inv_shuf[..., None].expand(-1, -1, d))
        loss = functools.partial(grid_sorting_loss, hw=hw,
                                 lambda_s=cfg.lambda_s,
                                 lambda_sigma=cfg.lambda_sigma)
        bs = y.shape[0]
        out = []
        for b0 in range(0, bs, _LOSS_ROWS):
            block = [t[b0:b0 + _LOSS_ROWS] for t in (y, colsum, x_shuf, norm)]
            k = block[0].shape[0]
            if k < _LOSS_ROWS:
                # Copies of the block's first row, cut off from autograd:
                # they only fill the block and are dropped with their losses.
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
                 hw, cfg: ShuffleSoftSortConfig, apply_fn):
    """One outer round for a (BS, N) batch of instances.

    ``shuf`` (BS, N) is the round's shuffles, ``tau_inner`` the
    device-resident inner temperatures, (BS, I) with a row per instance or
    (1, I) shared by the batch, ``bias1``/``bias2`` (I,) the Adam bias
    corrections ``1 - b ** t``.  Returns
    the committed orders, the last inner step's losses (BS,) and its
    trained keys ``w`` (BS, N).
    """
    bs, n = orders.shape
    d, dev = xs.shape[-1], xs.device
    with spans.span("shuffle", dev):
        inv_shuf = torch.argsort(shuf, dim=-1, stable=True)
        x_cur = torch.gather(xs, 1, orders[..., None].expand(-1, -1, d))
        x_shuf = torch.gather(x_cur, 1, shuf[..., None].expand(-1, -1, d))

    w = torch.arange(n, dtype=_F32, device=dev).repeat(bs, 1)
    mu = torch.zeros_like(w)
    nu = torch.zeros_like(w)
    taus = tau_inner.t().contiguous()       # row i: step i's temperatures
    loss = None
    for i in range(cfg.inner_steps):
        with spans.span("step", dev):
            held = spans.allocated_bytes(dev)
            wv = w.detach().requires_grad_(True)
            with torch.enable_grad():
                loss = _loss_fn(wv, x_shuf, inv_shuf, taus[i], hw, norms,
                                cfg, apply_fn)
                with spans.span("backward", dev):
                    # What the step's forward graph holds for its backward.
                    spans.gauge_max("step_graph_bytes",
                                    spans.allocated_bytes(dev) - held)
                    (g,) = torch.autograd.grad(loss.sum(), wv)
            with spans.span("adam", dev):
                mu = cfg.b1 * mu + (1 - cfg.b1) * g
                nu = cfg.b2 * nu + (1 - cfg.b2) * torch.square(g)
                mhat = mu / bias1[i]
                nuhat = nu / bias2[i]
                w = w - cfg.lr * mhat / (torch.sqrt(nuhat) + 1e-8)

    # Commit the hard permutation through the shuffle:
    #   new_grid[shuf[i]] = x_shuf[sort_idx[i]] = x_cur[shuf[sort_idx[i]]]
    with spans.span("commit", dev):
        sort_idx = torch.argsort(w, dim=-1, stable=True)
        g = torch.empty_like(shuf).scatter_(1, shuf, torch.gather(shuf, 1,
                                                                  sort_idx))
        orders = torch.gather(orders, 1, g)
    return orders, loss.detach(), w


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
                on_round: Optional[Callable] = None, mesh=None):
    """Rounds ``start .. end - 1`` (``end`` None: to R) over a (BS, N)
    batch, each round dense before the GLOBAL switch round and banded from
    it on, so a run cut into segments runs every round on the apply an
    uninterrupted run gives it.  ``rows`` (BS,) are the batch's instance
    indices in ``source`` (None: all of them, in order); only their
    streams advance.  With a ``mesh`` the
    batch is split over its slots (``_sharded``).  Returns the orders,
    the (end - start, BS) losses and the last round's trained keys (BS, N)
    (None when no round ran), all on the device."""
    if mesh is not None:
        if on_round is not None:
            raise ValueError("a per-round callback is not supported on the "
                             "sharded path; use mesh=None")
        return _sharded(
            mesh, lambda x, o, src, nm, _: _run_rounds(
                x, o, src, nm, start, end, hw=hw, cfg=cfg),
            xs_t, orders, norms_t, source, rows)
    dev = xs_t.device
    n = orders.shape[1]
    dense_fn = _select_apply_fn(cfg)
    band = resolve_band(cfg, n)
    band_fn = dense_fn if band is None else _select_apply_fn(cfg, band)
    switch = _band_switch_round(cfg, n)
    tau_inner = torch.as_tensor(_inner_taus(cfg), device=dev)
    bias1, bias2 = _adam_bias(cfg, dev)
    losses, w = [], None
    for r in range(start, cfg.rounds if end is None else end):
        with spans.span("round", dev):
            with spans.span("shuffle", dev):
                shuf = source.next_round(rows)
            orders, loss, w = _outer_round(
                xs_t, orders, shuf, tau_inner[r:r + 1], norms_t, bias1,
                bias2, hw=hw, cfg=cfg,
                apply_fn=band_fn if r >= switch else dense_fn)
            losses.append(loss)
            if on_round is not None:
                on_round(r, orders, loss)
    if not losses:
        return orders, torch.zeros((0, orders.shape[0]), dtype=_F32,
                                   device=dev), None
    return orders, torch.stack(losses), w


# --------------------------------------------------------------------------
# Rung-boundary checkpoints and guardrails.
# --------------------------------------------------------------------------

def _open_checkpointer(checkpoint_dir, resume):
    """The ``checkpoint_dir=`` / ``resume=`` knobs as an
    ``AnnealCheckpointer`` (or None)."""
    if checkpoint_dir is None:
        if resume:
            raise ValueError("resume=True requires checkpoint_dir=")
        return None
    from repro_torch.runtime.anneal_checkpoint import AnnealCheckpointer
    return AnnealCheckpointer(str(checkpoint_dir))


def _open_guardrails(guardrail, cfg: ShuffleSoftSortConfig, context: str):
    """The ``guardrail=`` knob as a ``GuardrailMonitor`` (or None): a
    ``GuardrailPolicy`` gets a fresh monitor, a monitor is used as it is
    (a caller that reads its incidents afterwards)."""
    if guardrail is None:
        return None
    from repro_torch.runtime.guardrails import (GuardrailMonitor,
                                                GuardrailPolicy)
    if isinstance(guardrail, GuardrailMonitor):
        mon = guardrail
    elif isinstance(guardrail, GuardrailPolicy):
        mon = GuardrailMonitor(guardrail, context=context,
                               dtype=cfg.compute_dtype)
    else:
        raise TypeError(
            "guardrail= must be a GuardrailPolicy or GuardrailMonitor, "
            f"got {guardrail!r}")
    return mon if mon.active else None


def _checkpoint_edges(rounds: int, every: int) -> list[int]:
    """The rounds at which the fixed engines checkpoint: every ``every``
    rounds, and a last edge at ``rounds``."""
    every = max(1, int(every))
    edges = list(range(every, rounds, every))
    if not edges or edges[-1] != rounds:
        edges.append(rounds)
    return edges


def _engine_meta(kind: str, cfg: ShuffleSoftSortConfig, n: int, bs: int,
                 hw, source: ShuffleSource) -> dict:
    """A checkpoint's meta record: the fingerprint a resume must match
    (the reference's, and the shuffle source's kind: a generator state
    taken on the card does not load into a CPU generator) and the config's
    repr for audit (not matched: the repair ladder changes it mid-run)."""
    return {"engine": kind, "rounds": int(cfg.rounds), "n": int(n),
            "instances": int(bs), "hw": list(hw),
            "schedule": cfg.schedule, "source": source.kind,
            "cfg": repr(cfg)}


def _meta_expect(meta: dict) -> dict:
    return {k: v for k, v in meta.items() if k != "cfg"}


def _orders_np(orders) -> np.ndarray:
    """Orders as the checkpoint stores them: int32, as the reference."""
    return _host(orders).astype(np.int32)


def _orders_t(orders, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(orders), device=device).to(torch.int64)


_APPLY_QUANTITIES = ("y", "colsum", "dw", "dx")


def _apply_errors(cfg: ShuffleSoftSortConfig, ws, xs,
                  groups) -> dict[str, np.ndarray]:
    """The shadow's apply check: the rung's last trained keys ``ws``
    (BS, N) with its payload ``xs`` (BS, N, d) through the kernel tier's
    apply and the plain tier's, forward and backward against one seeded
    cotangent.  ``groups`` is ``_shadow_checks``'s.  Returns, per quantity
    (y, colsum, dw, dx), the (BS,) errors of each instance: the largest
    difference over the largest entry of the plain tier's row."""
    out = {q: np.zeros(xs.shape[0]) for q in _APPLY_QUANTITIES}
    ws = torch.as_tensor(ws, dtype=_F32, device=xs.device)
    last_ramp = _inner_ramp(cfg)[-1]
    for rows, band, tau in groups:
        idx = torch.as_tensor(np.asarray(rows), device=xs.device)
        w, x = ws[idx].detach(), xs[idx].detach()
        tau = torch.as_tensor(np.asarray(tau, np.float32).reshape(-1)
                              * last_ramp, device=xs.device)
        gen = torch.Generator().manual_seed(0)
        gy = torch.randn(tuple(x.shape), generator=gen).to(x.device)
        gc = torch.randn(tuple(w.shape), generator=gen).to(w.device)
        tiers = []
        for cfg_ in (cfg, _plain_cfg(cfg)):
            wv = w.clone().requires_grad_(True)
            xv = x.clone().requires_grad_(True)
            with torch.enable_grad():
                y, colsum = _select_apply_fn(cfg_, band)(wv, xv, tau)
                dw, dx = torch.autograd.grad(
                    (y * gy).sum() + (colsum * gc).sum(), (wv, xv))
            tiers.append([t.detach().float().reshape(t.shape[0], -1)
                          for t in (y, colsum, dw, dx)])
        for q, got, want in zip(_APPLY_QUANTITIES, *tiers):
            err = ((got - want).abs().amax(dim=1)
                   / want.abs().amax(dim=1).clamp_min(1e-30))
            out[q][np.asarray(rows)] = _host(err)
    return out


def _shadow_checks(cfg: ShuffleSoftSortConfig, replay, xs, groups):
    """The shadow of one rung, for the engines, ``run_round_segment`` and
    the server alike.  ``replay()`` runs the rung again on ``cfg``'s tier
    from its input orders and a fork of its input stream state and returns
    (orders, losses, last trained keys).  ``xs`` (BS, N, d) is the rung's
    payload on the device and ``groups`` ``[(rows, band, tau), ...]`` the
    apply of the rung's last round for each group of rows: its band (None:
    dense) and its outer temperature (a scalar, or one per row).  Returns
    the replay's orders and losses on the host, and on the kernel tier
    ``_apply_errors`` of the replay's keys (None on the plain tier, which
    is the reference the kernels are held to)."""
    orders, losses, ws = replay()
    errors = (_apply_errors(cfg, ws, xs, groups) if cfg.use_kernel
              else None)
    return _host(orders), _host(losses), errors


def _fixed_groups(cfg: ShuffleSoftSortConfig, n: int, bs: int, end: int):
    """``_shadow_checks``'s groups for a fixed-schedule rung of ``bs`` rows
    ending at round ``end``: one, at round ``end - 1``'s apply."""
    band = resolve_band(cfg, n)
    if end - 1 < _band_switch_round(cfg, n):
        band = None
    return [(np.arange(bs), band, _tau_schedule(cfg)[end - 1])]


def _verify_rung(mon, cfg: ShuffleSoftSortConfig, source: ShuffleSource,
                 s_in, start: int, seg_len: int, rerun, *, xs, groups,
                 losses, orders, **probe_kw) -> None:
    """The probes on one rung, after the finite sentinel and before the
    save.  ``s_in`` is the source's state at the rung's start and
    ``rerun(source)`` the engine's own call of the rung from its input
    orders on ``cfg``'s tier, returning (orders, losses, last keys); a
    shadow-sampled rung runs it with a fork of the source at ``s_in``.
    ``xs`` and ``groups`` are as ``_shadow_checks`` takes them.
    ``losses`` and ``orders`` are the rung's host copies; ``probe_kw``
    goes on to ``GuardrailMonitor.check_rung``."""
    shadow = {}
    if mon.wants_shadow(start):
        o_sh, l_sh, errors = _shadow_checks(
            cfg, lambda: rerun(source.fork(s_in)), xs, groups)
        shadow = dict(oracle_orders=o_sh, oracle_losses=l_sh,
                      apply_errors=None if errors is None else
                      {q: float(np.max(e)) for q, e in errors.items()})
    mon.check_rung(start=start, losses=losses, orders=orders, source=source,
                   stream_in=s_in, stream_out=source.state_dict(),
                   seg_len=seg_len, **shadow, **probe_kw)


def _plain_cfg(cfg: ShuffleSoftSortConfig) -> ShuffleSoftSortConfig:
    """The plain PyTorch tier of ``cfg``: the apply check's reference."""
    return dataclasses.replace(cfg, use_kernel=False)


def _run_segment(xs_t, orders, source: ShuffleSource, norms_t, start: int,
                 end: int, *, rows=None, hw, cfg: ShuffleSoftSortConfig,
                 on_round: Optional[Callable] = None, mesh=None):
    """One rung of the fixed schedule, rounds ``[start, end)``: the seam
    the fixed engines go through, the counterpart of the reference's
    ``_run_segments`` (the shadow's replay calls ``_run_rounds`` itself,
    so a chaos wrapper on the seam never reaches it).  ``_run_rounds``
    splits it at the global switch round, so chained rungs are bitwise one
    uninterrupted run.  Returns the orders and the (end - start, BS)
    losses."""
    return _run_rounds(xs_t, orders, source, norms_t, start, end, rows=rows,
                       hw=hw, cfg=cfg, on_round=on_round,
                       mesh=mesh)[:2]


def _run_fixed_checkpointed(xs_t, orders, source: ShuffleSource, norms_t, *,
                            hw, cfg: ShuffleSoftSortConfig, ckpt,
                            resume: bool, every: int, rung_hook, meta: dict,
                            check_finite: bool = True, monitor=None,
                            prior=None, on_round: Optional[Callable] = None,
                            mesh=None, mesh_hook=None):
    """The fixed schedule of the batched engine in rung segments.

    Chains ``_run_segment`` across the checkpoint edges, bitwise one
    uninterrupted ``_run_rounds``; with ``every >= rounds`` that is one
    segment and one host copy of its losses at the end.  After each rung
    the whole carry (orders, the source's state, the losses so far) is
    published to ``ckpt``; with ``resume`` the run starts from the newest
    checkpoint (a bare directory from the beginning, or from ``prior``,
    the (BS, R0) losses of a ``state=`` carry).  ``rung_hook(start_round)``
    fires before each rung, where a preemption lands; ``on_round`` after
    each round, as in ``_run_rounds``.  ``mesh`` splits each rung over its
    slots; ``mesh_hook(start_round, mesh)`` fires right after ``rung_hook``
    and may return a replacement mesh (``_swap_mesh``).

    With a ``monitor`` the probes (``_verify_rung``) run on each rung after
    the finite sentinel and before ``ckpt.save``, so the newest checkpoint
    is always the last verified rung.

    Returns the orders (BS, N) on the device and the losses (R, BS) float32
    on the host.
    """
    rounds = int(cfg.rounds)
    dev = xs_t.device
    parts: list[np.ndarray] = []
    start = 0
    if prior is not None and prior.shape[1]:
        parts.append(_host(prior).T.astype(np.float32))
        start = prior.shape[1]
    mon = monitor if (monitor is not None and monitor.active) else None
    taus = _tau_schedule(cfg)
    if resume and ckpt is not None:
        got = ckpt.restore_latest(_meta_expect(meta))
        if got is not None:
            state, start, _ = got
            orders = _orders_t(state["orders"], dev)
            source.load_state_dict(state["source"])
            parts = [np.asarray(state["losses"], np.float32)] if start else []
    for end in _checkpoint_edges(rounds, every):
        if end <= start:
            continue
        if rung_hook is not None:
            rung_hook(start)
        mesh = _swap_mesh(mesh_hook, start, mesh)
        s_in = source.state_dict() if mon is not None else None
        o_in = orders
        orders, seg = _run_segment(xs_t, orders, source, norms_t, start, end,
                                   hw=hw, cfg=cfg, on_round=on_round,
                                   mesh=mesh)
        seg_np = _host(seg).astype(np.float32)
        if check_finite:
            _check_finite(seg_np, start, cfg, meta["engine"])
        if mon is not None:
            _verify_rung(
                mon, cfg, source, s_in, start, end - start,
                lambda src: _run_rounds(xs_t, o_in, src, norms_t, start, end,
                                        hw=hw, cfg=cfg, mesh=mesh),
                xs=xs_t, groups=_fixed_groups(cfg, o_in.shape[1],
                                              o_in.shape[0], end),
                losses=seg_np, orders=_host(orders), tau=float(taus[start]))
        parts.append(seg_np)
        if ckpt is not None:
            ckpt.save(end, {"orders": _orders_np(orders),
                            "source": source.state_dict(),
                            "losses": np.concatenate(parts, axis=0)},
                      meta=dict(meta, round=end), mesh=mesh)
        start = end
    return orders, np.concatenate(parts, axis=0)


def _run_rounds_ragged(xs, orders, source: ShuffleSource, rows, tau_rows,
                       norms, *, hw, cfg: ShuffleSoftSortConfig, apply_fn,
                       mesh=None):
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

    With a ``mesh`` the group is split over its slots (``_sharded``),
    each padding row at instance 0's temperatures.

    Returns orders (k, N), losses (T, k) and the last round's trained
    keys ws (k, N), all on the device.
    """
    tau_rows = np.asarray(tau_rows, np.float32)
    if mesh is not None:
        return _sharded(
            mesh, lambda x, o, src, nm, tau: _run_rounds_ragged(
                x, o, src, None, tau, nm, hw=hw, cfg=cfg,
                apply_fn=apply_fn),
            xs, orders, norms, source, rows, cols=tau_rows)
    dev = xs.device
    tau_inner = torch.as_tensor(tau_rows[:, :, None] * _inner_ramp(cfg),
                                device=dev)               # (T, k, I)
    bias1, bias2 = _adam_bias(cfg, dev)
    losses, w = [], None
    for t in range(tau_rows.shape[0]):
        with spans.span("round", dev):
            with spans.span("shuffle", dev):
                shuf = source.next_round(rows)
            orders, loss, w = _outer_round(
                xs, orders, shuf, tau_inner[t], norms, bias1, bias2, hw=hw,
                cfg=cfg, apply_fn=apply_fn)
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
                  check_finite: bool = True, ckpt=None, resume: bool = False,
                  meta: dict | None = None,
                  hook_state: dict | None = None, monitor=None,
                  mesh=None, mesh_hook=None):
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
    boundary's observe (the tournament culls from it).  ``mesh`` splits
    each group over its slots, each group on its own (the reference's
    ``_ragged_w_run``); ``mesh_hook(executed_rounds, mesh)`` fires right
    after ``rung_hook`` and may swap the mesh (``_swap_mesh``).

    With ``ckpt`` every committed rung publishes the orders, the source's
    state, the losses, the controller's ``ctrl_*`` state and the entries
    of ``hook_state`` as ``hs_*`` (a dict the caller owns, restored in
    place on resume, so its hook sees the resumed values).  A kill at the
    top of a rung loses that rung only; the resumed run replays it from
    the last boundary bitwise.  With a ``monitor`` the probes run after
    the finite sentinel and before the save; a shadow-sampled rung runs
    each group again on its tier from the group's input orders and a fork
    of the source at the rung's input state (``_shadow_checks``).

    Returns orders (BS, N) on the device, losses (BS, R) float32, NaN at
    the rounds an instance never ran (``controller.executed`` counts the
    rounds each ran), and the instance-rounds run on the device, the sum
    over dispatches of rounds x group size (the mesh's padding included).
    """
    ctrl = controller
    seg = ctrl.seg_len
    dev = xs_t.device
    bs, n = orders.shape
    mon = monitor if (monitor is not None and monitor.active) else None
    losses_mat = np.full((bs, cfg.rounds), np.nan, np.float32)
    device_rounds = 0
    step = 0
    if resume and ckpt is not None:
        got = ckpt.restore_latest(_meta_expect(meta or {}))
        if got is not None:
            state, _, m = got
            orders = _orders_t(state["orders"], dev)
            source.load_state_dict(state["source"])
            losses_mat = np.asarray(state["losses"], np.float32).copy()
            ctrl.load_state_dict(
                {f: state["ctrl_" + f] for f in ctrl._STATE_FIELDS})
            if hook_state is not None:
                hook_state.clear()
                hook_state.update({k[3:]: np.asarray(v)
                                   for k, v in state.items()
                                   if k.startswith("hs_")})
            step = int(m["step"])
            device_rounds = int(m["device_rounds"])
    while True:
        live = ctrl.live_indices()
        if live.size == 0:
            break
        if rung_hook is not None:
            rung_hook(step * seg)
        mesh = _swap_mesh(mesh_hook, step * seg, mesh)
        # Stopped instances never rejoin, so every live instance has run
        # exactly step * seg rounds.
        exec0 = step * seg
        banded_mask = ctrl.banded[live]
        s_in = source.state_dict() if mon is not None else None
        groups = []                  # (sel, rows, tau rows, input orders, K)
        for is_banded in (False, True):
            sel = np.flatnonzero(banded_mask == is_banded)
            if sel.size:
                rows = torch.as_tensor(live[sel], device=dev)
                groups.append((sel, rows, ctrl.tau_rows(live[sel]),
                               orders[rows], ctrl.band if is_banded else None))

        def run_groups(src):
            """The rung's groups in order, each from its input orders:
            orders (live, N) on the device, losses (seg, live) and last
            keys (live, N) on the host."""
            o_live = torch.empty((live.size, n), dtype=torch.int64,
                                 device=dev)
            l_live = np.empty((seg, live.size), np.float32)
            w_live = np.empty((live.size, n), np.float32)
            for sel, rows, tau_g, o_in, band in groups:
                o, l, w = _run_rounds_ragged(
                    xs_t[rows], o_in, src, live[sel], tau_g, norms_t[rows],
                    hw=hw, cfg=cfg, apply_fn=_select_apply_fn(cfg, band),
                    mesh=mesh)
                o_live[torch.as_tensor(sel, device=dev)] = o
                l_live[:, sel], w_live[sel] = _host(l), _host(w)
            return o_live, l_live, w_live

        o_live, seg_t, ws_live = run_groups(source)
        orders = orders.index_copy(0, torch.as_tensor(live, device=dev),
                                   o_live)
        seg_losses = np.ascontiguousarray(seg_t.T)          # (live, seg)
        device_rounds += seg * sum(_padded(g[0].size, mesh)
                                   for g in groups)
        if check_finite:
            _check_finite(seg_t, exec0, cfg, "adaptive", ws=ws_live)
        if mon is not None:
            _verify_rung(
                mon, cfg, source, s_in, exec0, seg,
                run_groups,
                xs=xs_t[torch.as_tensor(live, device=dev)],
                groups=[(sel, band, tau_g[-1])
                        for sel, _, tau_g, _, band in groups],
                losses=seg_t, orders=_host(o_live), rows=live, ws=ws_live,
                tau=ctrl.tau_rows(live)[0], band=ctrl.band,
                banded_mask=banded_mask)
        losses_mat[live, exec0:exec0 + seg] = seg_losses
        ctrl.observe(live, seg_losses, ws_live)
        if boundary_hook is not None:
            boundary_hook(step + 1, ctrl, losses_mat)
        step += 1
        if ckpt is not None:
            st = {"orders": _orders_np(orders),
                  "source": source.state_dict(),
                  "losses": losses_mat.copy()}
            for f in ctrl._STATE_FIELDS:
                st["ctrl_" + f] = getattr(ctrl, f).copy()
            for k, v in (hook_state or {}).items():
                st["hs_" + k] = np.asarray(v)
            ckpt.save(step, st, meta=dict(meta or {}, step=step,
                                          device_rounds=device_rounds),
                      mesh=mesh)
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
      device: where to run (None: CUDA, and an error without it; with a
        mesh, its first slot's device).
      mesh: a ``SortMesh`` (``repro_torch.launch.mesh``): the batch is
        split over its slots, the tail padded with copies of instance 0;
        per instance bitwise ``mesh=None``.
      regime: None infers the apply from ``rung_aligned_switch`` and
        checks the batch against it; "dense" / "banded" selects it.
      with_w: also return the end-of-segment trained keys.

      guardrail: a ``GuardrailPolicy`` (or monitor of
        ``repro_torch.runtime.guardrails``): the integrity probes on this
        segment's results (permutations, loss sanity, the stream audit of
        ``source``, the band-tail audit with ``with_w``, and the sampled
        shadow: a bitwise same-tier replay and, on the kernel tier, the
        kernel-vs-plain apply check), raising ``IntegrityViolation``.
        Probes are read-only: the results are unchanged.

    Returns:
      (orders (BS, N), losses (seg_len, BS)) on the device, plus
      ``ws (BS, N)`` with ``with_w=True``.
    """
    _check_config(cfg)
    mesh = _check_mesh(mesh)
    device = _run_device(device, mesh)
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
    mon = _open_guardrails(guardrail, cfg, "segment")
    s_in = source.state_dict() if mon is not None else None
    taus = _tau_schedule(cfg)
    tau_rows = taus[p[:, None] + np.arange(seg_len)].T
    band_use = band if banded else None

    def segment(src):
        return _run_rounds_ragged(xs, orders, src, rows, tau_rows, norms,
                                  hw=hw, cfg=cfg,
                                  apply_fn=_select_apply_fn(cfg, band_use),
                                  mesh=mesh)

    o_out, losses, ws = segment(source)
    if mon is not None:
        _verify_rung(
            mon, cfg, source, s_in, int(p.min()), seg_len, segment, xs=xs,
            groups=[(np.arange(bs), band_use, tau_rows[-1])],
            losses=_host(losses), orders=_host(o_out), n=n, rows=rows,
            ws=_host(ws) if with_w else None, tau=taus[p],
            band=band if (banded and with_w) else None)
    return (o_out, losses, ws) if with_w else (o_out, losses)


def _key_source(key, keys, bs: int, n: int, device, taken: bool):
    """The ``ThreefryShuffleSource`` of ``key=`` / ``keys=``, as the
    reference derives its instance keys: ``keys`` (BS, 2) as given, or
    ``split(key, BS)``; None when neither is given.  ``taken``: the caller
    also gave ``seeds=`` or ``source=`` (a ``ValueError``)."""
    if key is None and keys is None:
        return None
    if taken or (key is not None and keys is not None):
        raise ValueError("key=/keys= draw the reference's shuffles: pass one "
                         "of them, and no seeds= or source=")
    if keys is None:
        keys = threefry.split(key, bs, device=device)
    keys = threefry.as_keys(keys, device).reshape(-1, 2)
    if keys.shape[0] != bs:
        raise ValueError(f"keys must be ({bs}, 2), got {tuple(keys.shape)}")
    return ThreefryShuffleSource(keys, n, device)


def _prep_instances(xs, hw, n_restarts, seed, seeds, source, norms, state,
                    device, key=None, keys=None):
    """Normalize the engine inputs into flattened (BS, ...) instances,
    problem-major (restart s of problem b at row ``b * S + s``).
    ``key`` / ``keys`` as ``_key_source`` takes them; they override
    ``seed``.

    Returns (xs (B, N, d), B, S, N, source, xs_t, norms_t, orders,
    prior losses (BS, start))."""
    with spans.span("prep", device):
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
        key_src = _key_source(key, keys, bs, n, device,
                              seeds is not None or source is not None)
        source = key_src if key_src is not None else source
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
    key=None,
    norm=None,
    state=None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    checkpoint_every: int | None = None,
    rung_hook: Optional[Callable[[int], None]] = None,
    check_finite: bool = True,
    guardrail=None,
) -> tuple[np.ndarray, np.ndarray, list[float]]:
    """Sort x (N, d) onto an (h, w) grid.  Returns (order, x[order], losses).

    ``seed`` seeds the shuffle stream; ``source`` (a shuffle source of
    ``repro_torch.core.prng``) replaces it, and ``key`` (raw
    ``jax.random`` key data, e.g. ``threefry.prng_key(1)``) overrides
    ``seed`` and draws the reference's shuffles from it: the reference's
    ``key=``, whose chain is ``key, sub = split(key)`` per round
    (``key`` with ``source`` is a ``ValueError``).  ``norm`` overrides the loss
    normalization ``mean_pairwise_distance(x)``.  ``state`` =
    ``(orders (1, N), losses (1, R0))`` continues a run after round R0
    (see ``repro_torch.core.reference``).  ``callback(r, order, loss)``
    is called after every round.  ``losses`` is the per-round list, one
    host sync per round, with a ``NumericalDivergence`` check on each
    (``check_finite=False`` turns it off).

    Preemption safety: ``checkpoint_dir`` publishes the carry (order, the
    shuffle source's state, losses) every ``checkpoint_every`` rounds
    (default ``rounds // 8``) through
    ``repro_torch.runtime.anneal_checkpoint.AnnealCheckpointer``;
    ``resume=True`` starts from the newest checkpoint there (a bare
    directory from the beginning) and finishes bitwise an uninterrupted
    run.  ``rung_hook(start_round)`` fires before each rung.
    ``guardrail=`` (a ``repro_torch.runtime.guardrails.GuardrailPolicy``)
    runs the integrity probes at every rung edge, raising
    ``IntegrityViolation``; a guarded run returns the unguarded results
    bitwise.

    ``cfg.schedule="adaptive"`` runs the plateau controller
    (``repro_torch.core.annealing``): the run may stop at a rung boundary,
    so ``losses`` holds the executed rounds only.  It decides at rung
    boundaries, so it takes no per-round ``callback`` and no ``state``.
    """
    _check_config(cfg)
    if cfg.schedule == "adaptive":
        _check_adaptive(callback, state)
        res = shuffle_soft_sort_batched(
            x[None], hw, cfg, 1,
            seeds=[seed] if key is None else None, device=device,
            source=source,
            keys=None if key is None else threefry.as_keys(key, "cpu")[None],
            norms=None if norm is None else [norm],
            checkpoint_dir=checkpoint_dir, resume=resume,
            checkpoint_every=checkpoint_every, rung_hook=rung_hook,
            check_finite=check_finite, guardrail=guardrail)
        executed = int(res.rounds_executed[0, 0])
        return (res.order[0], res.sorted[0],
                [float(v) for v in res.losses[0][:executed]])
    ckpt = _open_checkpointer(checkpoint_dir, resume)
    if callback is not None and (ckpt is not None or rung_hook is not None):
        raise ValueError("checkpoint_dir/rung_hook are incompatible with "
                         "the per-round callback stream")
    device = resolve_device(device)
    with spans.span("call", device):
        mon = _open_guardrails(guardrail, cfg, "sequential")
        x_t = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                              else x, dtype=_F32, device=device)
        xs, _, _, n, source, xs_t, norms_t, orders, prior = _prep_instances(
            x_t[None], hw, 1, seed, [seed] if key is None else None, source,
            None if norm is None else [norm], state, device,
            keys=None if key is None else threefry.as_keys(key, "cpu")[None])
        losses = [float(v) for v in prior[0].cpu()]
        start = len(losses)
        meta = _engine_meta("sequential", cfg, n, 1, hw, source)
        if resume and ckpt is not None:
            got = ckpt.restore_latest(_meta_expect(meta))
            if got is not None:
                st, start, _ = got
                orders = _orders_t(st["order"], device)[None]
                source.load_state_dict(st["source"])
                losses = [float(v) for v in st["losses"]]
        rungs = ckpt is not None or mon is not None or rung_hook is not None
        edges = (_checkpoint_edges(cfg.rounds,
                                   checkpoint_every or max(1, cfg.rounds // 8))
                 if rungs else [cfg.rounds])
        taus = _tau_schedule(cfg)
        seg_start = start

        def on_round(r, orders_r, loss_r):
            losses.append(float(loss_r[0]))
            if check_finite:
                # The whole rung so far: the error names its FIRST bad round.
                _check_finite(
                    np.asarray(losses[seg_start:], np.float32)[:, None],
                    seg_start, cfg, "sequential")
            if callback is not None:
                callback(r, orders_r[0].to(torch.int32).cpu().numpy(),
                         losses[-1])

        for end in edges:
            if end <= seg_start:
                continue
            if rung_hook is not None:
                rung_hook(seg_start)
            s_in = source.state_dict() if mon is not None else None
            o_in = orders
            orders, _ = _run_segment(xs_t, orders, source, norms_t, seg_start,
                                     end, hw=hw, cfg=cfg, on_round=on_round)
            if mon is not None:
                _verify_rung(
                    mon, cfg, source, s_in, seg_start, end - seg_start,
                    lambda src: _run_rounds(xs_t, o_in, src, norms_t,
                                            seg_start, end, hw=hw, cfg=cfg),
                    xs=xs_t, groups=_fixed_groups(cfg, n, 1, end),
                    losses=np.asarray(losses[seg_start:], np.float32),
                    orders=_host(orders), n=n, tau=float(taus[seg_start]))
            if ckpt is not None:
                ckpt.save(end, {"order": _orders_np(orders[0]),
                                "source": source.state_dict(),
                                "losses": np.asarray(losses, np.float32)},
                          meta=dict(meta, round=end))
            seg_start = end
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
    key=None,
    keys=None,
    norms=None,
    state=None,
    checkpoint_dir: str | None = None,
    resume: bool = False,
    checkpoint_every: int | None = None,
    rung_hook: Optional[Callable[[int], None]] = None,
    check_finite: bool = True,
    guardrail=None,
    mesh_hook=None,
) -> BatchedSortResult:
    """Sort B problems at once, S random restarts each, as one (B*S, N)
    batch: each inner step launches every kernel once for all instances.

    Instance i (row ``b * S + s``) draws its shuffles from a generator
    seeded with ``seeds[i]`` (default: ``instance_seeds(seed, B * S)``),
    so it matches ``shuffle_soft_sort(xs[b], ...,
    seed=seeds[i])``.  ``source`` (a shuffle source of
    ``repro_torch.core.prng``) replaces the shuffle stream.  ``keys``
    (B*S, 2) raw ``jax.random`` key data, or ``key`` split into B*S as
    ``jax.random.split(key, B * S)``, draw the reference's own shuffles
    (``ThreefryShuffleSource``): the reference's ``key=`` / ``keys=``, so
    instance i matches ``shuffle_soft_sort(xs[b], key=keys[i])``.  They
    override ``seed``; with ``seeds`` or ``source`` they raise
    ``ValueError``.  ``norms`` (B,)
    overrides the per-problem
    loss normalization; ``state`` = ``(orders (B*S, N), losses (B*S, R0))``
    continues a run after round R0.  ``callback(r, orders (B*S, N),
    losses (B*S,))`` is called after every round (a host sync); without
    it the losses stay on the device until the end.

    ``cfg.schedule="adaptive"`` runs every instance under the plateau
    controller; the result then carries ``rounds_executed`` (B, S), loss
    traces NaN past each early stop, and winners chosen by their
    last-executed loss.  It takes no ``callback`` and no ``state``.

    ``checkpoint_dir`` / ``resume`` / ``checkpoint_every`` / ``rung_hook``
    / ``check_finite`` / ``guardrail``: rung-boundary preemption safety
    and integrity probes, as in ``shuffle_soft_sort``.  On the fixed
    schedule any of ``checkpoint_dir``, ``rung_hook``, ``guardrail`` and
    ``mesh_hook`` cuts the rounds into rungs of ``checkpoint_every``
    (bitwise one segment of all of them); the adaptive schedule
    checkpoints at its controller's rungs.  Without them the run is one
    segment and brings nothing to the host before its end.

    ``mesh`` (a ``SortMesh`` of ``repro_torch.launch.mesh``) splits the
    flattened B x S instances over its slots, the tail slot padded with
    copies of instance 0, and gathers the outputs onto ``device``; each
    problem's winner is the host argmin of its final losses, as without a
    mesh.  Per seed the results are bitwise ``mesh=None``'s: every run
    evaluates its loss in blocks of 8 (ROADMAP.md Queues C7, C12).  The
    run's carry lives on
    ``device`` (default: the first slot's).  ``mesh_hook(start_round,
    mesh) -> mesh | None`` fires at each rung boundary after
    ``rung_hook``: a returned mesh runs the rungs after it (elastic
    re-sharding over the survivors of an eviction), bitwise the same.  A
    checkpoint written on one mesh resumes on another, or on none.
    """
    _check_config(cfg)
    mesh = _check_mesh(mesh)
    if cfg.schedule == "adaptive":
        _check_adaptive(callback, state)
    if mesh is not None and callback is not None:
        raise ValueError("callback streaming is not supported on the "
                         "sharded path; use mesh=None")
    ckpt = _open_checkpointer(checkpoint_dir, resume)
    device = _run_device(device, mesh)
    with spans.span("call", device):
        mon = _open_guardrails(guardrail, cfg, "batched")
        rungs = (ckpt is not None or rung_hook is not None or mon is not None
                 or mesh_hook is not None)
        if callback is not None and rungs:
            raise ValueError("checkpoint_dir/rung_hook/guardrail/mesh_hook "
                             "are incompatible with the per-round callback "
                             "stream")
        xs, b, s, n, source, xs_t, norms_t, orders, prior = _prep_instances(
            xs, hw, n_restarts, seed, seeds, source, norms, state, device,
            key=key, keys=keys)
        if cfg.schedule == "adaptive":
            return _batched_adaptive(
                xs, b, s, n, source, xs_t, norms_t, orders, hw=hw, cfg=cfg,
                ckpt=ckpt, resume=resume, rung_hook=rung_hook,
                check_finite=check_finite, monitor=mon, mesh=mesh,
                mesh_hook=mesh_hook)
        on_round = None
        if callback is not None:
            def on_round(r, orders_r, loss_r):
                loss_np = loss_r.cpu().numpy()
                if check_finite:
                    _check_finite(loss_np[None], r, cfg, "batched")
                callback(r, orders_r.to(torch.int32).cpu().numpy(), loss_np)

        orders, losses_np = _run_fixed_checkpointed(
            xs_t, orders, source, norms_t, hw=hw, cfg=cfg, ckpt=ckpt,
            resume=resume,
            every=((checkpoint_every or max(1, cfg.rounds // 8)) if rungs
                   else cfg.rounds),
            rung_hook=rung_hook,
            meta=_engine_meta("batched", cfg, n, b * s, hw, source),
            check_finite=check_finite, monitor=mon, prior=prior,
            on_round=on_round, mesh=mesh, mesh_hook=mesh_hook)
        with spans.span("fetch", device):
            all_losses = losses_np.T
            all_losses = all_losses.reshape(b, s, cfg.rounds)
            all_orders = orders.to(torch.int32).cpu().numpy().reshape(b, s, n)
            best = np.argmin(all_losses[:, :, -1], axis=1)
            order = all_orders[np.arange(b), best]
            xs_np = xs.cpu().numpy()
            return BatchedSortResult(
                order=order,
                sorted=np.take_along_axis(
                    xs_np, order[:, :, None].astype(np.int64), axis=1),
                losses=all_losses[np.arange(b), best],
                best_restart=best,
                all_orders=all_orders,
                all_losses=all_losses,
            )


def _batched_adaptive(xs, b, s, n, source, xs_t, norms_t, orders, *, hw,
                      cfg: ShuffleSoftSortConfig, ckpt=None,
                      resume: bool = False, rung_hook=None,
                      check_finite: bool = True, monitor=None, mesh=None,
                      mesh_hook=None) -> BatchedSortResult:
    """``shuffle_soft_sort_batched`` on the adaptive schedule."""
    bs = b * s
    ctrl = make_adaptive_controller(cfg, bs, n)
    orders, losses_bs, _ = _run_adaptive(
        xs_t, orders, source, norms_t, hw=hw, cfg=cfg, controller=ctrl,
        rung_hook=rung_hook, check_finite=check_finite, ckpt=ckpt,
        resume=resume,
        meta=_engine_meta("adaptive", cfg, n, bs, hw, source),
        monitor=monitor, mesh=mesh, mesh_hook=mesh_hook)
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
    key=None,
    keys=None,
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
    instances.  The survivors' rows are gathered on the device; each rung's
    (T, B * S_k) losses cross to the host at its end, where the cull
    decides.  Each restart draws its own shuffle stream, so a culled
    restart's stream simply stops, and a restart that survives every cull
    finishes bitwise the same (b, s) instance of
    ``shuffle_soft_sort_batched``.

    Args:
      xs, hw, cfg, n_restarts, seed, seeds, device, source, key, keys,
        norms: as in ``shuffle_soft_sort_batched``.
      cull_fraction: fraction of live restarts dropped at each rung
        boundary (0 disables culling; 0.5 halves).
      n_rungs: number of anneal segments; culls happen at the
        ``n_rungs - 1`` interior boundaries.  With
        ``schedule="adaptive"`` the rungs are counted in controller steps
        (``adapt_every`` rounds), and a restart ranks by its
        last-executed loss.
      rung_hook: ``f(start_round)``, called before each rung.
      check_finite: raise ``NumericalDivergence`` on a non-finite loss.
      checkpoint_dir, resume: rung-boundary checkpoints at the
        tournament's own rung edges (the cull boundaries), so the alive
        sets and the survivors log always agree with the stored orders.
      guardrail: integrity probes at every rung, as in
        ``shuffle_soft_sort``.
      mesh: a ``SortMesh``: each rung's (shrinking) live set is split over
        its slots, padded to a multiple of the slot count; ``rounds_run``
        counts the padding.  Winners are bitwise ``mesh=None``'s.
      mesh_hook: ``f(start_round, mesh) -> mesh | None`` at each rung
        boundary after ``rung_hook``; a returned mesh runs the rungs after
        it (elastic re-sharding), bitwise the same.

    Returns:
      ``TournamentResult``, see its field docs.
    """
    if not 0.0 <= cull_fraction < 1.0:
        raise ValueError(f"cull_fraction must be in [0, 1), got "
                         f"{cull_fraction}")
    _check_config(cfg)
    mesh = _check_mesh(mesh)
    ckpt = _open_checkpointer(checkpoint_dir, resume)
    device = _run_device(device, mesh)
    with spans.span("call", device):
        mon = _open_guardrails(guardrail, cfg, "tournament")
        xs, b, s, n, source, xs_t, norms_t, orders, _ = _prep_instances(
            xs, hw, n_restarts, seed, seeds, source, norms, None, device,
            key=key, keys=keys)
        if cfg.schedule == "adaptive":
            return _restart_tournament_adaptive(
                xs, b, s, n, source, xs_t, norms_t, orders, hw=hw, cfg=cfg,
                cull_fraction=cull_fraction, n_rungs=n_rungs,
                rung_hook=rung_hook, check_finite=check_finite, ckpt=ckpt,
                resume=resume, monitor=mon, mesh=mesh, mesh_hook=mesh_hook)
        edges = _rung_boundaries(cfg.rounds, n_rungs)
        taus = _tau_schedule(cfg)

        # The live set is problem-major: live slot j of problem p at row
        # p * S_k + j; ``alive`` maps live slots to original restart indices.
        alive = np.tile(np.arange(s), (b, 1))                 # (B, S_k)
        survivors_log = []
        rounds_run = start = k_done = 0
        all_losses = np.full((b, s, cfg.rounds), np.nan, np.float32)
        meta = _engine_meta("tournament", cfg, n, b * s, hw, source)
        if resume and ckpt is not None:
            got = ckpt.restore_latest(_meta_expect(meta))
            if got is not None:
                state, _, m = got
                alive = np.asarray(state["alive"])
                all_losses = np.asarray(state["all_losses"], np.float32).copy()
                k_done = int(m["rung"])
                survivors_log = [np.asarray(state[f"surv_{i:03d}"])
                                 for i in range(k_done)]
                # The live set's xs is a gather of the inputs: only the carry
                # (orders, streams, norms, alive) is stored.
                xs_t = torch.repeat_interleave(xs, alive.shape[1], dim=0)
                orders = _orders_t(state["orders"], device)
                source.load_state_dict(state["source"])
                norms_t = torch.as_tensor(state["norms"], device=device)
                start = int(m["start"])
                rounds_run = int(m["rounds_run"])
        for k, end in enumerate(edges):
            if k < k_done:
                continue
            if rung_hook is not None:
                rung_hook(start)
            mesh = _swap_mesh(mesh_hook, start, mesh)
            s_k = alive.shape[1]
            rows = (np.arange(b)[:, None] * s + alive).reshape(-1)
            s_in = source.state_dict() if mon is not None else None
            o_in = orders
            orders, losses = _run_segment(xs_t, orders, source, norms_t, start,
                                          end, rows=rows, hw=hw, cfg=cfg,
                                          mesh=mesh)
            rounds_run += (end - start) * _padded(b * s_k, mesh)
            seg = _host(losses).astype(np.float32)            # (T, B * S_k)
            if check_finite:
                _check_finite(seg, start, cfg, "tournament")
            if mon is not None:
                _verify_rung(
                    mon, cfg, source, s_in, start, end - start,
                    lambda src: _run_rounds(
                        xs_t, o_in, src, norms_t, start, end, rows=rows, hw=hw,
                        cfg=cfg, mesh=mesh),
                    xs=xs_t, groups=_fixed_groups(cfg, n, len(rows), end),
                    losses=seg, orders=_host(orders), rows=rows,
                    tau=float(taus[start]))
            all_losses[np.arange(b)[:, None], alive, start:end] = (
                seg.T.reshape(b, s_k, end - start))
            keep = _survivor_count(s_k, cull_fraction)
            if k < len(edges) - 1 and keep < s_k:
                last = seg[-1].reshape(b, s_k)
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
            if ckpt is not None:
                st = {"orders": _orders_np(orders),
                      "source": source.state_dict(),
                      "norms": _host(norms_t), "alive": alive.copy(),
                      "all_losses": all_losses.copy()}
                for i, sv in enumerate(survivors_log):
                    st[f"surv_{i:03d}"] = sv
                ckpt.save(end, st, meta=dict(meta, rung=k + 1, start=end,
                                             rounds_run=rounds_run), mesh=mesh)
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
                                 rung_hook=None, check_finite: bool = True,
                                 ckpt=None, resume: bool = False,
                                 monitor=None, mesh=None,
                                 mesh_hook=None) -> TournamentResult:
    """The tournament on the adaptive schedule: ``_run_adaptive`` with a
    cull hook at the rung edges.

    Edges are counted in controller steps (``_rung_boundaries`` over the
    R / seg_len decision points), so culls land on the boundaries the
    controller observes at.  A cull ranks every restart still in the
    tournament by its LAST-EXECUTED loss: an early-stopped restart keeps
    competing with its final loss, and a culled one leaves through
    ``AdaptiveController.mark_culled``; the survivors' streams never see
    a perturbation.  The cross-rung cull state (the alive set and the
    survivors log) lives in one dict, ``hstate``, which ``_run_adaptive``
    checkpoints beside the controller and restores in place on resume.
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
        boundary_hook=hook, rung_hook=rung_hook, check_finite=check_finite,
        ckpt=ckpt, resume=resume,
        meta=_engine_meta("tournament-adaptive", cfg, n, b * s, hw, source),
        hook_state=hstate, monitor=monitor, mesh=mesh, mesh_hook=mesh_hook)
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


# --------------------------------------------------------------------------
# Plain SoftSort baseline (paper Table III, row 3): one weight vector
# trained end to end with the same loss and tau anneal, no shuffling.
# --------------------------------------------------------------------------

def _softsort_train(x, norm, *, hw, cfg: ShuffleSoftSortConfig, apply_fn,
                    steps: int):
    """``steps`` Adam steps (beta 0.9 / 0.999, the reference's baseline,
    not the engine's 0.5 / 0.9) on keys ``w = arange(N)``, tau annealed
    per step as ``tau_start * (tau_end / tau_start) ** (i / steps)``
    (float32), the loss ``_loss_fn`` with the identity shuffle.  Returns
    ``argsort(w)`` (stable) and the last step's loss, on the device."""
    from repro_torch.core.baselines._common import (adam_bias, adam_step,
                                                    anneal)
    n = x.shape[0]
    dev = x.device
    w = torch.arange(n, dtype=_F32, device=dev)[None]
    ident = torch.arange(n, device=dev)[None]
    taus = anneal(cfg.tau_start, cfg.tau_end, steps, dev)
    bias1, bias2 = adam_bias(steps, dev)
    norm = norm.reshape(1)
    mu, nu = torch.zeros_like(w), torch.zeros_like(w)
    loss = torch.zeros((1,), dtype=_F32, device=dev)
    for i in range(steps):
        wv = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _loss_fn(wv, x[None], ident, taus[i:i + 1], hw, norm,
                            cfg, apply_fn)
            (g,) = torch.autograd.grad(loss.sum(), wv)
        w, mu, nu = adam_step(w, g, mu, nu, cfg.lr, bias1[i], bias2[i])
    return torch.argsort(w[0], stable=True), loss.detach()[0]


def soft_sort_baseline(
    x,
    hw: tuple[int, int],
    cfg: ShuffleSoftSortConfig = ShuffleSoftSortConfig(),
    steps: int | None = None,
    *,
    device=None,
) -> tuple[np.ndarray, np.ndarray, float]:
    """Pure SoftSort with the same budget (R * I steps by default).
    Returns (order, x[order], final loss).

    The baseline anneals tau continuously in one loop, so there is no
    round boundary to switch at: ``cfg.band`` is honoured only when the
    switch model admits the band for the WHOLE schedule
    (``_band_switch_round`` 0), otherwise the run stays dense, as in the
    reference.  ``cfg.use_kernel`` runs the apply on the kernel tier: the
    dense SoftSort kernels 1-4 (or the banded 5-8), one forward and one
    backward per step.  Runs on CUDA unless ``device`` says otherwise."""
    from repro_torch.core.baselines._common import as_input
    _check_config(cfg)
    x = as_input(x, device)
    n = x.shape[0]
    if n != hw[0] * hw[1]:
        raise ValueError(f"N = {n} does not fill the grid {hw}")
    norm = mean_pairwise_distance(x)
    band = resolve_band(cfg, n)
    use_band = band is not None and _band_switch_round(cfg, n) == 0
    apply_fn = _select_apply_fn(cfg, band if use_band else None)
    order, loss = _softsort_train(x, norm, hw=hw, cfg=cfg, apply_fn=apply_fn,
                                  steps=steps or cfg.rounds * cfg.inner_steps)
    order = order.to(torch.int32).cpu().numpy()
    return order, x.cpu().numpy()[order], float(loss)

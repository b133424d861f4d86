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

Counterpart of ``repro.core.shufflesoftsort`` on its fixed-schedule,
single-device path.  The engine runs B problems x S restarts as one
(BS, N) batch; ``shuffle_soft_sort`` is the BS = 1 case of the same
code.  Each round's shuffles come from a shuffle source
(``repro_torch.core.prng``): per-instance ``torch.Generator`` streams by
default, or a replayed array.  ``cfg.use_kernel`` routes the SoftSort
apply, forward and backward, through the kernel tier
(``repro_torch.kernels.ops``).  ``cfg.band`` (K or "auto") swaps the
O(N^2) apply for the O(N K) banded one from the round
``_band_switch_round`` names on, in both engines alike.

Entry points run on CUDA unless ``device`` says otherwise; without a CUDA
device they raise rather than fall back to the CPU.

Return contract: ``order`` is the (N,) int32 permutation mapping grid
cell -> input row, ``sorted`` is ``x[order]``, and ``losses`` is the
per-round loss trace (the last inner step's loss of each round).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence

import numpy as np
import torch

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
    schedule: str = "fixed"     # "adaptive": not ported yet
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
                  context: str) -> None:
    """Raise ``NumericalDivergence`` at the first non-finite round of
    ``losses_seg`` ((T, ...) round-major, global rounds [start, start+T))."""
    losses_seg = np.asarray(losses_seg)
    bad = ~np.isfinite(losses_seg)
    if bad.any():
        per_round = bad.reshape(losses_seg.shape[0], -1).any(axis=1)
        rnd = start + int(np.argmax(per_round))
        tau = float(_tau_schedule(cfg)[min(rnd, cfg.rounds - 1)])
        raise NumericalDivergence(
            f"non-finite loss at round {rnd} (tau~{tau:.4g}, "
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


def _check_ported(cfg: ShuffleSoftSortConfig, **features) -> None:
    """Refuse every setting whose code is not ported yet."""
    if cfg.schedule not in ("fixed", "adaptive"):
        raise ValueError(
            f"cfg.schedule={cfg.schedule!r} must be 'fixed' or 'adaptive'")
    todo = {
        "schedule='adaptive'": (cfg.schedule == "adaptive",
                                "adaptive annealing (ROADMAP.md Queue A8)"),
        "mesh": (features.get("mesh") is not None,
                 "multi-GPU instance sharding (ROADMAP.md Queue A11)"),
        "checkpoint_dir": (features.get("checkpoint_dir") is not None,
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


def _loss_fn(w, x_shuf, inv_shuf, tau, hw, norm, cfg: ShuffleSoftSortConfig,
             apply_fn) -> torch.Tensor:
    """(BS,) losses of a (BS, N) key batch."""
    y_shuf, colsum = apply_fn(w, x_shuf, tau)
    d = y_shuf.shape[-1]
    y = torch.gather(y_shuf, 1, inv_shuf[..., None].expand(-1, -1, d))
    return grid_sorting_loss(y, colsum, x_shuf, hw, norm,
                             lambda_s=cfg.lambda_s,
                             lambda_sigma=cfg.lambda_sigma)


def _inner_taus(cfg: ShuffleSoftSortConfig) -> np.ndarray:
    """(R, I) float32 inner-step temperatures ``tau_r * (ramp + (1 - ramp)
    * frac_i)``, every operation in float32 as the reference does it."""
    f32 = np.float32
    frac = (np.arange(cfg.inner_steps, dtype=f32)
            / f32(max(cfg.inner_steps - 1, 1)))
    ramp = f32(cfg.inner_tau_ramp) + f32(1.0 - cfg.inner_tau_ramp) * frac
    return _tau_schedule(cfg)[:, None] * ramp[None, :]


def _outer_round(xs, orders, shuf, tau_inner, norms, bias1, bias2, *,
                 hw, cfg: ShuffleSoftSortConfig, apply_fn):
    """One outer round for a (BS, N) batch of instances.

    ``shuf`` (BS, N) is the round's shuffles, ``tau_inner`` (I,) the
    device-resident inner temperatures, ``bias1``/``bias2`` (I,) the Adam
    bias corrections ``1 - b ** t``.  Returns the committed orders and
    the last inner step's losses (BS,).
    """
    bs, n = orders.shape
    d = xs.shape[-1]
    inv_shuf = torch.argsort(shuf, dim=-1, stable=True)
    x_cur = torch.gather(xs, 1, orders[..., None].expand(-1, -1, d))
    x_shuf = torch.gather(x_cur, 1, shuf[..., None].expand(-1, -1, d))

    w = torch.arange(n, dtype=_F32, device=xs.device).repeat(bs, 1)
    mu = torch.zeros_like(w)
    nu = torch.zeros_like(w)
    loss = None
    for i in range(cfg.inner_steps):
        wv = w.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _loss_fn(wv, x_shuf, inv_shuf, tau_inner[i:i + 1], hw,
                            norms, cfg, apply_fn)
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
    return torch.gather(orders, 1, g), loss.detach()


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


def _run_rounds(xs_t, orders, source: ShuffleSource, norms_t, start: int, *,
                hw, cfg: ShuffleSoftSortConfig,
                on_round: Optional[Callable] = None):
    """Rounds ``start .. R-1`` over a (BS, N) batch: dense before the
    switch round, banded from it on.  Returns the orders and the
    (R - start, BS) losses, both on the device."""
    dev = xs_t.device
    n = orders.shape[1]
    dense_fn = _select_apply_fn(cfg)
    band = resolve_band(cfg, n)
    band_fn = dense_fn if band is None else _select_apply_fn(cfg, band)
    switch = _band_switch_round(cfg, n)
    tau_inner = torch.as_tensor(_inner_taus(cfg), device=dev)
    t = torch.arange(1, cfg.inner_steps + 1, dtype=_F32, device=dev)
    bias1 = 1 - cfg.b1 ** t
    bias2 = 1 - cfg.b2 ** t
    losses = []
    for r in range(start, cfg.rounds):
        shuf = source.next_round()
        orders, loss = _outer_round(
            xs_t, orders, shuf, tau_inner[r], norms_t, bias1, bias2,
            hw=hw, cfg=cfg, apply_fn=band_fn if r >= switch else dense_fn)
        losses.append(loss)
        if on_round is not None:
            on_round(r, orders, loss)
    if not losses:
        return orders, torch.zeros((0, orders.shape[0]), dtype=_F32,
                                   device=dev)
    return orders, torch.stack(losses)


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
    """
    _check_ported(cfg, checkpoint_dir=checkpoint_dir, guardrail=guardrail)
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


@dataclasses.dataclass(frozen=True)
class BatchedSortResult:
    """Result of ``shuffle_soft_sort_batched`` over B problems x S restarts.

    The per-problem fields report the winning restart, the one whose
    final-round loss is lowest; the ``all_*`` fields keep every restart.
    """
    order: np.ndarray          # (B, N) int32 — best restart's permutation
    sorted: np.ndarray         # (B, N, d) — xs gathered by ``order``
    losses: np.ndarray         # (B, R) — per-round losses of the best restart
    best_restart: np.ndarray   # (B,) int — argmin_s all_losses[:, s, -1]
    all_orders: np.ndarray     # (B, S, N) int32 — every restart's permutation
    all_losses: np.ndarray     # (B, S, R) — every restart's loss trace


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
    """
    _check_ported(cfg, mesh=mesh, checkpoint_dir=checkpoint_dir,
                  guardrail=guardrail)
    device = resolve_device(device)
    xs, b, s, n, source, xs_t, norms_t, orders, prior = _prep_instances(
        xs, hw, n_restarts, seed, seeds, source, norms, state, device)
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

"""The plain reference of ShuffleSoftSort (Algorithm 1 of the paper, with
the configuration's band), in plain PyTorch float32.

It reads nothing of the program: the instance seeds, the shuffle draws,
the loss normaliser, the temperatures, the band and its switch round are
worked out here again from the inputs and the configuration.  The SoftSort
apply is formed block by block with autograd, dense or banded in rank
space; TF32 is switched off, so every product is float32.

One outer round of an instance (the configuration's ``cfg`` keys):

    shuf  = randperm(N) from the instance's generator
    x_s   = x[order][shuf];  w = arange(N)
    for i in 0..I-1:  tau_i = tau_r * (ramp + (1 - ramp) * i / (I - 1))
        P    = softmax_rows(-|sort(w)_r - w_c| / tau_i)
               (banded: only |r - c| <= K, both in rank order)
        y    = (P @ x_s)[argsort(shuf)]
        loss = L_nbr(y on the grid) / (2 norm) + l_s mean((colsum P - 1)^2)
               + l_sig mean(|std x - std y| / std x)        (eq. 2)
        w   <- Adam(b1, b2, lr, eps 1e-8, bias-corrected) step on sum(loss)
    order[shuf[i]] <- order[shuf[argsort(w)[i]]]
"""
from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.reference import threefry

F32 = torch.float32


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---- what the configuration derives -----------------------------------

def instance_seeds(seed: int, count: int) -> list[int]:
    """A call's per-instance seeds from its seed (NumPy's SeedSequence,
    63 bits), the convention the engine documents for ``seed=``."""
    state = np.random.SeedSequence(int(seed)).generate_state(count, np.uint64)
    return [int(s) & (2 ** 63 - 1) for s in state]


def generators(seeds, device) -> list[torch.Generator]:
    return [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]


def draw_shuffles(gens, n: int, device) -> torch.Tensor:
    return torch.stack([torch.randperm(n, generator=g, device=device)
                        for g in gens])


def tau_schedule(cfg: dict) -> np.ndarray:
    r = cfg["rounds"]
    return np.float32(cfg["tau_start"] * (cfg["tau_end"] / cfg["tau_start"])
                      ** (np.arange(1, r + 1) / r))


def inner_taus(cfg: dict) -> np.ndarray:
    """(R, I) float32 temperatures of every inner step."""
    f32 = np.float32
    i = cfg["inner_steps"]
    frac = np.arange(i, dtype=f32) / f32(max(i - 1, 1))
    ramp = f32(cfg["inner_tau_ramp"]) + f32(1.0 - cfg["inner_tau_ramp"]) * frac
    return tau_schedule(cfg)[:, None] * ramp[None, :]


def band_k(cfg: dict, n: int) -> int | None:
    """The band half-width K (None: dense).  ``"auto"`` is the largest of
    64, the K whose modelled tail clears ``band_eps`` at ``tau_end``, and
    N/16 rounded up to a multiple of 64; a K covering every pair is
    dense."""
    band = cfg.get("band")
    if band is None:
        return None
    if band == "auto":
        eps = max(cfg["band_eps"], 1e-30)
        safety = int(math.ceil(2.0 * cfg["tau_end"]
                               * math.log(max(n, 2) / eps)))
        k = max(64, safety, -(-max(n // 16, 1) // 64) * 64)
    else:
        k = int(band)
    return None if k >= n - 1 else max(1, k)


def switch_round(cfg: dict, n: int) -> int:
    """The first banded round: the first whose temperature puts the
    modelled tail ``(N - K) exp(-(K/2) / tau_r)`` under ``band_eps``."""
    k = band_k(cfg, n)
    if k is None:
        return cfg["rounds"]
    ok = (n - k) * np.exp(-(k / 2.0) / tau_schedule(cfg)) <= cfg["band_eps"]
    idx = np.flatnonzero(ok)
    return int(idx[0]) if idx.size else cfg["rounds"]


def normaliser(x: torch.Tensor, sample: int = 2048,
               block: int = 1024) -> torch.Tensor:
    """Mean pairwise distance of the (N, d) rows, as the loss normalises
    by it: all N^2 distances over N (N - 1) up to N^2 = 2^22, else the mean
    over ``sample`` pairs drawn by ``jax.random.randint`` from the split
    of ``PRNGKey(0)``.  sqrt(|a - b|^2 + 1e-12) per pair."""
    n = x.shape[0]
    if n * n <= 4_194_304:
        total = torch.zeros((), dtype=torch.float64, device=x.device)
        for r0 in range(0, n, block):
            d2 = torch.square(x[r0:r0 + block, None] - x[None]).sum(-1)
            total += torch.sqrt(d2 + 1e-12).sum().double()
        return (total / (n * (n - 1))).float()
    k1, k2 = threefry.split(threefry.prng_key(0))
    i = torch.as_tensor(threefry.randint(k1, sample, 0, n), device=x.device)
    j = torch.as_tensor(threefry.randint(k2, sample, 0, n), device=x.device)
    return torch.sqrt(torch.square(x[i] - x[j]).sum(-1) + 1e-12).mean()


# ---- the SoftSort apply -------------------------------------------------

def apply_dense(w, x, tau, block: int = 1024):
    """(P @ x, colsum P) of (B, N) keys and (B, N, d) rows; tau (B,)."""
    ws = torch.gather(w, 1, torch.argsort(w.detach(), dim=1, stable=True))
    t = tau[:, None, None]
    ys, colsum = [], torch.zeros_like(w)
    for r0 in range(0, w.shape[1], block):
        p = torch.softmax(-torch.abs(ws[:, r0:r0 + block, None]
                                     - w[:, None, :]) / t, dim=-1)
        ys.append(p @ x)
        colsum = colsum + p.sum(1)
    return torch.cat(ys, 1), colsum


def apply_banded(w, x, tau, k: int, block: int = 2048):
    """The banded apply: rank r's row holds only the ranks within K of
    r, rows and columns both in rank order; colsum back in the columns'
    own order."""
    b, n = w.shape
    perm = torch.argsort(w.detach(), dim=1, stable=True)
    ws = torch.gather(w, 1, perm)
    xs = torch.gather(x, 1, perm[..., None].expand(-1, -1, x.shape[-1]))
    t = tau[:, None, None]
    ar = torch.arange(n, device=w.device)
    ys, parts = [], []
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        c0, c1 = max(0, r0 - k), min(n, r1 + k)
        inband = (ar[r0:r1, None] - ar[None, c0:c1]).abs() <= k
        s = -torch.abs(ws[:, r0:r1, None] - ws[:, None, c0:c1]) / t
        p = torch.softmax(torch.where(inband, s, float("-inf")), dim=-1)
        ys.append(p @ xs[:, c0:c1])
        parts.append((c0, c1, p.sum(1)))
    colsum_rank = torch.zeros_like(w)
    for c0, c1, part in parts:
        colsum_rank = colsum_rank + torch.nn.functional.pad(
            part, (c0, n - c1))
    inv = torch.argsort(perm, dim=1)
    return torch.cat(ys, 1), torch.gather(colsum_rank, 1, inv)


# ---- eq. 2 ----------------------------------------------------------------

def grid_loss(y, colsum, x, hw, norm, lambda_s: float, lambda_sigma: float):
    """(B,) losses of (B, N, d) rows y laid on the (h, w) grid."""
    h, wd = hw
    g = y.reshape(y.shape[0], h, wd, y.shape[-1])
    dh = torch.sqrt(torch.square(g[:, :, 1:] - g[:, :, :-1]).sum(-1) + 1e-12)
    dv = torch.sqrt(torch.square(g[:, 1:] - g[:, :-1]).sum(-1) + 1e-12)
    nbr = (dh.mean((1, 2)) + dv.mean((1, 2))) / (2.0 * norm)
    stoch = torch.square(colsum - 1.0).mean(-1)
    sx = x.std(1, correction=0)
    sy = y.std(1, correction=0)
    std = (torch.abs(sx - sy) / (sx + 1e-12)).mean(-1)
    return nbr + lambda_s * stoch + lambda_sigma * std


# ---- the anneal -------------------------------------------------------------

class Anneal:
    """Instances (B, N, d) of one grid under one configuration, each with
    its own shuffle generator, norm and order; ``round()`` runs the next
    outer round of every instance and returns its (B,) last-step losses."""

    def __init__(self, xs, hw, cfg: dict, seeds, norms, device):
        self.xs = xs
        self.hw = tuple(hw)
        self.cfg = cfg
        self.n = xs.shape[1]
        self.norms = norms
        self.gens = generators(seeds, device)
        self.orders = torch.arange(self.n, device=device).repeat(
            xs.shape[0], 1)
        self.taus = torch.as_tensor(inner_taus(cfg), device=device)
        self.k = band_k(cfg, self.n)
        self.switch = switch_round(cfg, self.n)
        self.r = 0

    def _apply(self, w, x, tau):
        if self.k is not None and self.r >= self.switch:
            return apply_banded(w, x, tau, self.k)
        return apply_dense(w, x, tau)

    def round(self) -> torch.Tensor:
        cfg, b, n = self.cfg, self.xs.shape[0], self.n
        d = self.xs.shape[-1]
        shuf = draw_shuffles(self.gens, n, self.xs.device)
        inv = torch.argsort(shuf, dim=1)
        x_cur = torch.gather(self.xs, 1, self.orders[..., None].expand(-1, -1,
                                                                       d))
        x_s = torch.gather(x_cur, 1, shuf[..., None].expand(-1, -1, d))
        w = torch.arange(n, dtype=F32, device=self.xs.device).repeat(b, 1)
        mu, nu = torch.zeros_like(w), torch.zeros_like(w)
        b1, b2 = cfg["b1"], cfg["b2"]
        loss = None
        for i in range(cfg["inner_steps"]):
            tau = self.taus[self.r, i].expand(b)
            wv = w.detach().requires_grad_(True)
            with torch.enable_grad():
                y_s, colsum = self._apply(wv, x_s, tau)
                y = torch.gather(y_s, 1, inv[..., None].expand(-1, -1, d))
                loss = grid_loss(y, colsum, x_s, self.hw, self.norms,
                                 cfg["lambda_s"], cfg["lambda_sigma"])
                (g,) = torch.autograd.grad(loss.sum(), wv)
            mu = b1 * mu + (1 - b1) * g
            nu = b2 * nu + (1 - b2) * g * g
            mhat = mu / (1 - b1 ** (i + 1))
            nhat = nu / (1 - b2 ** (i + 1))
            w = w - cfg["lr"] * mhat / (torch.sqrt(nhat) + 1e-8)
        rank = torch.argsort(w, dim=1, stable=True)
        src = torch.gather(shuf, 1, rank)  # cell shuf[i] <- shuf[rank[i]]
        new = torch.empty_like(self.orders)
        new.scatter_(1, shuf, torch.gather(self.orders, 1, src))
        self.orders = new
        self.r += 1
        return loss.detach()


def run(xs, hw, cfg: dict, seeds, norms, device, rounds: int | None = None):
    """``rounds`` outer rounds (None: all of ``cfg``) of instances xs with
    the given seeds and norms.  Returns the (rounds, B) losses and the
    (B, N) orders."""
    a = Anneal(xs, hw, cfg, seeds, norms, device)
    losses = [a.round() for _ in range(cfg["rounds"] if rounds is None
                                       else rounds)]
    return torch.stack(losses), a.orders

"""The comparison that decides ``correct``: the answers the timed path
returned, held against the plain reference (``port_bench.reference``).

A group is one call's problems (the batch kinds) or one request (the
serve kind): G problems of (N, d) rows, S restarts each, instance
``g * S + s`` drawing its shuffles from its own seed.  Four numbers:

* ``bad_answers`` (limit 0): answers that never came or say something
  impossible: a call or request that raised or never resolved, an order
  that is not a permutation, ``sorted`` that is not the rows in that
  order, a best restart that is not the one with the lowest final loss,
  a non-finite loss.
* ``round0_loss_gap``: the reference runs round 0 of every instance of
  the checked groups from the same inputs and seeds (its own shuffles,
  normaliser, temperatures, apply forward and backward, eq. 2 and Adam);
  the largest relative gap of the program's round-0 losses.
* ``round1_loss_gap``: the same of round 1, which starts from the first
  commit of the permutation; the median over the instances.  A commit
  turns float rounding into a discrete choice: where two trained keys lie
  closer than the two sides' rounding, the orders part by one swap, and
  that instance's round-1 loss moves by about 1/N of itself.  The median
  looks past those instances; a commit that is wrong for all reads in it.
* ``final_quality_gap``: rounds 2 to R cannot be followed from the
  program's state, which a call does not return, so the final answer is
  judged by what it says: the reference runs the whole anneal of
  ``limits["quality_instances"]`` instances drawn from the answered
  groups, and each side's final order is scored by eq. 2's neighbour
  term (the loss of the rows laid out in that order); the largest
  relative gap of the two scores.  Sound runs part at a commit's near tie
  and end in layouts of nearly the same quality; a driver that stops
  committing, or a server that loses a request's state between rungs,
  ends far from sorted.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from port_bench.reference import anneal


def exact_faults(xs_np: np.ndarray, s: int, losses, all_orders, best, order,
                 sorted_) -> int:
    """Impossible answers of one group (numpy arrays: xs (G, N, d),
    losses (G*S, R), all_orders (G*S, N), best (G,), order (G, N),
    sorted (G, N, d))."""
    g, n = xs_np.shape[:2]
    ref = np.arange(n)
    bad = 0
    for o in np.concatenate([np.asarray(all_orders).reshape(-1, n),
                             np.asarray(order).reshape(-1, n)]):
        bad += int(not np.array_equal(np.sort(o), ref))
    losses = np.asarray(losses, np.float64).reshape(g, s, -1)
    bad += int(not np.isfinite(losses).all())
    all_orders = np.asarray(all_orders).reshape(g, s, n)
    for i in range(g):
        o = np.asarray(order[i], np.int64)
        bad += int(int(best[i]) != int(np.argmin(losses[i, :, -1])))
        bad += int(not np.array_equal(o, all_orders[i, int(best[i])]))
        if np.array_equal(np.sort(o), ref):
            bad += int(not np.array_equal(np.asarray(sorted_[i]),
                                          xs_np[i][o]))
    return bad


def start_gaps(xs, s: int, seeds, prog_losses, hw, cfg: dict,
               device) -> np.ndarray:
    """(G*S, 2) relative gaps of rounds 0 and 1's losses of a group's
    instances (xs (G, N, d) on ``device``)."""
    x_t = torch.repeat_interleave(xs, s, dim=0)
    norms = torch.repeat_interleave(
        torch.stack([anneal.normaliser(x) for x in xs]), s)
    ref, _ = anneal.run(x_t, hw, cfg, seeds, norms, device, rounds=2)
    ref = ref.T.double().cpu().numpy()
    prog = np.asarray(prog_losses, np.float64).reshape(len(seeds), -1)[:, :2]
    return np.abs(prog - ref) / np.abs(ref)


def quality(xs, orders, hw, norms) -> np.ndarray:
    """(B,) eq. 2's neighbour term of (B, N, d) rows laid out in (B, N)
    orders: a permutation's rows have the inputs' spread and column sums
    of one, so the loss's other terms are nought."""
    rows = torch.gather(xs, 1, orders[..., None].expand(-1, -1,
                                                        xs.shape[-1]))
    ones = torch.ones(orders.shape, dtype=xs.dtype, device=xs.device)
    return anneal.grid_loss(rows, ones, rows, hw, norms, 0.0,
                            0.0).double().cpu().numpy()


def final_gaps(picks, hw, cfg: dict, device) -> np.ndarray:
    """Relative gaps of the final layouts' quality of the instances
    ``picks`` ((group, instance) pairs), each side's order scored alike."""
    xs = torch.stack([g["xs"][j // g["s"]] for g, j in picks]).to(device)
    seeds = [g["seeds"][j] for g, j in picks]
    prog = torch.as_tensor(np.stack([
        np.asarray(g["all_orders"]).reshape(len(g["seeds"]), -1)[j]
        for g, j in picks]), dtype=torch.int64, device=device)
    norms = torch.stack([anneal.normaliser(x) for x in xs])
    _, ref = anneal.run(xs, hw, cfg, seeds, norms, device)
    q_ref = quality(xs, ref, hw, norms)
    return np.abs(quality(xs, prog, hw, norms) - q_ref) / q_ref


def decide(groups: list[dict], *, hw, cfg: dict, limits: dict, rng,
           device, log=print) -> dict:
    """The four numbers over the window's groups, each beside its limit.

    A group: ``xs`` (G, N, d) tensor, ``s``, ``seeds`` (G*S,),
    and the program's ``losses`` (G*S, R), ``all_orders`` (G*S, N),
    ``best`` (G,), ``order`` (G, N), ``sorted`` (G, N, d), or ``error``
    (what it raised, or that it never came) instead of those.  Every
    group is checked for impossible answers; ``limits["start_groups"]``
    of them, drawn by ``rng``, against the reference's rounds 0 and 1,
    and ``limits["quality_instances"]`` instances, drawn by ``rng`` from
    all answered groups, against its whole anneal."""
    anneal.no_tf32()
    t0 = time.perf_counter()
    bad = 0
    answered = []
    for grp in groups:
        if grp.get("error") is not None:
            bad += grp["xs"].shape[0]
            continue
        bad += exact_faults(grp["xs"].cpu().numpy(), grp["s"],
                            grp["losses"], grp["all_orders"], grp["best"],
                            grp["order"], grp["sorted"])
        answered.append(grp)
    gaps = np.full((1, 2), np.inf)
    if answered:
        pick = rng.choice(len(answered), min(limits["start_groups"],
                                             len(answered)), replace=False)
        gaps = np.concatenate([
            start_gaps(answered[i]["xs"].to(device), answered[i]["s"],
                       answered[i]["seeds"], answered[i]["losses"], hw, cfg,
                       device) for i in sorted(pick)])
    t1 = time.perf_counter()
    qgaps = np.full(1, np.inf)
    if answered:
        inst = [(g, j) for g in answered for j in range(len(g["seeds"]))]
        pick = rng.choice(len(inst), min(limits["quality_instances"],
                                         len(inst)), replace=False)
        qgaps = final_gaps([inst[i] for i in sorted(pick)], hw, cfg, device)
    log(f"reference check: {time.perf_counter() - t0:.3f} s, "
        f"{len(groups)} groups, {gaps.shape[0]} instances against the "
        f"reference's rounds 0-1; round-1 gaps: median "
        f"{np.median(gaps[:, 1]):.3g}, max {gaps[:, 1].max():.3g}; "
        f"{qgaps.size} against its whole anneal in "
        f"{time.perf_counter() - t1:.3f} s, quality gaps "
        f"{[float(f'{q:.4g}') for q in qgaps]}")

    def num(value, key):
        return {"value": float(value), "limit": float(limits[key])}

    return {"bad_answers": num(bad, "bad_answers"),
            "round0_loss_gap": num(gaps[:, 0].max(), "round0_loss_gap"),
            "round1_loss_gap": num(np.median(gaps[:, 1]), "round1_loss_gap"),
            "final_quality_gap": num(qgaps.max(), "final_quality_gap")}

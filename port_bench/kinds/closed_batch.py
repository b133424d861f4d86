"""Closed batch, one client: back-to-back ``shuffle_soft_sort_batched``
calls, each on ``problems_per_call`` fresh problems x ``restarts``, with
no per-round callback, as a service that sorts several uploads at once
and takes the answers at the end.

Set-up makes two warm calls of one round, then every call's inputs from
the seed, on the device, and keeps them on the host: a call takes its
problems from the host as a user's would, so the allocator's peak is the
program's alone.  The window holds whole calls only: it starts no call that,
going by the mean call so far (R warm rounds at first), would end after
``--seconds``.
``round_ms`` is the window's wall time over all rounds of its calls;
``peak_mem_mib`` the allocator's peak over the window.  A traced run
profiles the window's first call.
"""
from __future__ import annotations

import dataclasses
import itertools
import sys
import time

import numpy as np

from port_bench import check, counts, trace
from port_bench.kinds import common
from port_bench.reference import anneal


def measure(ctx: dict) -> dict:
    import torch
    from repro_torch.core import shuffle_soft_sort_batched

    config, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    seed, seconds = ctx["seed"], ctx["seconds"]
    hw = tuple(config["grid"])
    n, d = hw[0] * hw[1], config["d"]
    p, s = int(traffic["problems_per_call"]), int(traffic["restarts"])
    rounds = config["cfg"]["rounds"]
    cfg = common.program_config(config)

    def call(xs, call_seed, cfg=cfg):
        return shuffle_soft_sort_batched(xs, hw, cfg, n_restarts=s,
                                         seed=call_seed, device=dev)

    # Set-up: two calls of one round (every round runs the same shapes and
    # kernels; the first also pays the first launches), then the inputs of
    # as many calls as the window can hold, going by the second, with room.
    warm = common.make_inputs(config, p, common.seed_of(seed, 0, 1),
                              dev).cpu()
    one_round = dataclasses.replace(cfg, rounds=1)
    for _ in range(2):
        t = time.perf_counter()
        call(warm, common.seed_of(seed, 0, 2), one_round)
        common.sync(dev)
    t_warm = rounds * (time.perf_counter() - t)
    n_max = int(1.5 * seconds / t_warm) + 2
    xs_all = [common.make_inputs(config, p, common.seed_of(seed, 1, k),
                                 dev).cpu() for k in range(n_max)]
    call_seeds = [common.seed_of(seed, 2, k) for k in range(n_max)]
    common.sync(dev)
    common.reset_peak(dev)
    setup_s = time.monotonic() - ctx["t_start"]

    traced = 0
    span = trace.Span() if ctx["trace"] else None
    results, durations = [], []
    t0 = time.perf_counter()
    for k in itertools.count():
        est = np.mean(durations) if durations else t_warm
        if k and time.perf_counter() - t0 + est > seconds:
            break
        if k == len(xs_all):        # set-up's estimate fell short
            xs_all.append(common.make_inputs(
                config, p, common.seed_of(seed, 1, k), dev).cpu())
            call_seeds.append(common.seed_of(seed, 2, k))
        if span is not None and k == traced:
            span.start()
        t1 = time.perf_counter()
        try:
            res = call(xs_all[k], call_seeds[k])
        except Exception as e:          # a failed call is a failed answer
            res = e
        common.sync(dev)
        durations.append(time.perf_counter() - t1)
        if span is not None and k == traced:
            span.stop()
        results.append(res)
    window_s = time.perf_counter() - t0
    peak = common.peak_bytes(dev)
    common.log_card(dev)
    done = len(results)
    failed = sum(isinstance(r, Exception) for r in results)
    print(f"window: {done} calls, {failed} failed, {window_s:.6f} s; warm "
          f"call x R {t_warm:.6f} s; calls {[round(x, 4) for x in durations]}",
          file=sys.stderr)

    out = {"attempted": done * p, "failed": failed * p,
           "device": common.device_info(dev, peak),
           "end_to_end": {
               "round_ms": 1e3 * window_s / (rounds * done),
               "peak_mem_mib": peak / 2 ** 20,
               "setup_s": setup_s}}

    bs = p * s
    per_call_least = counts.run_least_seconds(
        bs, n, d, common.rounds_k(config), config["cfg"]["inner_steps"])
    if span is not None:
        tr = span.read()
        untraced = [x for i, x in enumerate(durations) if i != traced] \
            or durations
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": trace.top_device_ops(tr),
                            "idle_gaps": trace.top_idle_gaps(tr)}
        out["layer_inputs"] = {
            "trace": tr, "rounds": rounds, "least_s": per_call_least,
            "window_least_s": per_call_least * len(untraced),
            "window_wall_s": float(sum(untraced))}

    groups = []
    for xs, cs, res in zip(xs_all, call_seeds, results):
        grp = {"xs": xs, "s": s, "seeds": anneal.instance_seeds(cs, bs)}
        if isinstance(res, Exception):
            grp["error"] = repr(res)
        else:
            grp.update(losses=res.all_losses.reshape(bs, rounds),
                       all_orders=res.all_orders.reshape(bs, n),
                       best=res.best_restart, order=res.order,
                       sorted=res.sorted)
        groups.append(grp)
    del results
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    out["checks"] = check.decide(
        groups, hw=hw, cfg=config["cfg"], limits=ctx["limits"],
        rng=np.random.default_rng(common.seed_of(seed, 3)), device=dev,
        log=lambda m: print(m, file=sys.stderr))
    return out

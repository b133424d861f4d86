"""Open loop: requests arrive on a fixed schedule, whatever the server
does, one problem each, through ``repro_torch.launch.serve.SortServer``
(``submit(x, key=...)``, no deadline), as independent users each asking
for a layout.

The schedule holds ``round(rate_per_s * (seconds - drain_s))`` arrivals
over the first ``seconds - drain_s`` seconds: the quantiles of an
exponential inter-arrival gap at ``rate_per_s``, in an order drawn from
the mix's ``schedule_seed``.  Every run offers these arrivals; ``--seed``
draws the requests that fill them (catalogs and shuffle keys).  Near the
knee the tail follows the order of the gaps (bursts) far more than the
requests, so a schedule per seed would make the seed change the load.  Each
request's latency runs from its due time to its answer; one that fails
or has not come a minute after the window's close counts as beyond any
latency.  ``request_p<q>_ms`` is the q-th percentile (nearest rank) of
all requests due in the window, for q in ``QUANTILES``; a cell reports
those that ``BENCHMARK.json`` names for it.  Set-up warms one rung of each
power-of-two batch bucket in ``warm_buckets`` on throwaway servers.  A
traced run profiles ``trace_s`` seconds from the window's middle.
"""
from __future__ import annotations

import math
import sys
import threading
import time

import numpy as np

from port_bench import check, trace
from port_bench.kinds import common

GRACE_S = 60.0
QUANTILES = (50, 75, 90)


def schedule(rate: float, offer_s: float, seed: int) -> np.ndarray:
    """Due times (seconds from the window's start) of the arrivals."""
    m = max(1, int(round(rate * offer_s)))
    q = (np.arange(m) + 0.5) / m
    gaps = -np.log1p(-q) / rate
    rng = np.random.default_rng(seed)
    return np.cumsum(gaps[rng.permutation(m)])


def nearest_rank(values, pct: float) -> float:
    v = sorted(values)
    return v[max(0, math.ceil(pct / 100.0 * len(v)) - 1)]


def measure(ctx: dict) -> dict:
    from repro_torch.launch.serve import SortServer

    config, traffic, dev = ctx["config"], ctx["traffic"], ctx["device"]
    seed, seconds = ctx["seed"], ctx["seconds"]
    hw = tuple(config["grid"])
    n, d = hw[0] * hw[1], config["d"]
    cfg = common.program_config(config)
    kw = dict(max_batch=int(traffic["max_batch"]),
              queue_depth=int(traffic["queue_depth"]),
              n_restarts=1, device=dev)

    # Set-up: one rung of each batch bucket, then the window's inputs.
    warm = common.make_inputs(config, max(traffic["warm_buckets"]),
                              common.seed_of(seed, 0, 1), dev).cpu().numpy()
    for b in traffic["warm_buckets"]:
        srv = SortServer(hw, d, cfg, autostart=False,
                         seed=common.seed_of(seed, 0, 2), **kw)
        futs = [srv.submit(warm[i], key=i) for i in range(b)]
        srv._tick()
        common.sync(dev)
        srv.close(drain=True)
        for f in futs:
            f.exception()
    due = schedule(float(traffic["rate_per_s"]),
                   seconds - float(traffic["drain_s"]),
                   int(traffic["schedule_seed"]))
    m = len(due)
    xs = common.make_inputs(config, m, common.seed_of(seed, 1), dev).cpu()
    xs_np = xs.numpy()
    keys = [common.seed_of(seed, 2, i) for i in range(m)]
    server = SortServer(hw, d, cfg, seed=common.seed_of(seed, 3), **kw)
    common.sync(dev)
    common.reset_peak(dev)
    setup_s = time.monotonic() - ctx["t_start"]

    done_at = [None] * m
    futs = [None] * m
    late = np.zeros(m)
    lock = threading.Lock()

    def stamp(i):
        def cb(_f):
            with lock:
                done_at[i] = time.perf_counter()
        return cb

    span = trace.Span() if ctx["trace"] else None
    t_trace = (0.5 * (seconds - float(traffic["drain_s"])),
               0.5 * (seconds - float(traffic["drain_s"]))
               + float(traffic["trace_s"]))
    traced = False
    stats0 = len(server.stats["batch_sizes"])
    t0 = time.perf_counter()
    for i in range(m):
        while True:
            now = time.perf_counter() - t0
            if span is not None and not traced and now >= t_trace[0]:
                span.start()
                traced = True
            if span is not None and traced and span.wall_s is None \
                    and now >= t_trace[1]:
                common.sync(dev)
                span.stop()
            if now >= due[i]:
                break
            nxt = due[i]
            if span is not None and span.wall_s is None:
                nxt = min(nxt, t_trace[1] if traced else t_trace[0])
            time.sleep(max(0.0, min(nxt - now, 0.05)))
        late[i] = time.perf_counter() - t0 - due[i]
        try:
            futs[i] = server.submit(xs_np[i], key=keys[i])
            futs[i].add_done_callback(stamp(i))
        except Exception as e:          # QueueFull, ServerClosed: failed
            futs[i] = e
    while span is not None and span.wall_s is None:
        now = time.perf_counter() - t0
        if now >= t_trace[1]:
            common.sync(dev)
            span.stop()
        else:
            time.sleep(min(0.05, t_trace[1] - now))
    end = t0 + seconds
    while time.perf_counter() < end + GRACE_S and not all(
            not hasattr(f, "done") or f.done() for f in futs):
        time.sleep(0.01)
    batch_sizes = list(server.stats["batch_sizes"][stats0:])
    peak = common.peak_bytes(dev)
    server.close(drain=True)
    common.log_card(dev)

    lat, groups, failed = [], [], 0
    for i, f in enumerate(futs):
        grp = {"xs": xs[i:i + 1], "s": 1, "seeds": [keys[i]]}
        ok = hasattr(f, "done") and f.done() and f.exception() is None \
            and done_at[i] is not None
        if ok:
            order, sorted_, losses = f.result()
            lat.append(1e3 * (done_at[i] - t0 - due[i]))
            grp.update(losses=np.asarray(losses)[None],
                       all_orders=np.asarray(order)[None], best=[0],
                       order=np.asarray(order)[None],
                       sorted=np.asarray(sorted_)[None])
        else:
            failed += 1
            lat.append(math.inf)
            grp["error"] = repr(f.exception() if hasattr(f, "done")
                                and f.done() else f)
        groups.append(grp)
    tails = {f"request_p{q}_ms": nearest_rank(lat, q) for q in QUANTILES}
    half = m // 2
    print(f"window: {m} requests due, {failed} failed or unanswered; "
          + ", ".join(f"{k} {v:.3f}" for k, v in tails.items())
          + f", max {max(lat):.3f} ms; p90 of the first and second half of the "
          f"arrivals {nearest_rank(lat[:max(half, 1)], 90):.3f}, "
          f"{nearest_rank(lat[half:], 90):.3f} ms; generator late by at most "
          f"{late.max():.6f} s;"
          f" {len(batch_sizes)} dispatches, dispatch_s "
          f"{server.stats['dispatch_s']:.3f}; latencies (ms) "
          f"{[round(float(x), 1) for x in lat]}", file=sys.stderr)
    out = {"attempted": m, "failed": failed,
           "device": common.device_info(dev, peak),
           "end_to_end": dict(tails, setup_s=setup_s)}
    if span is not None:
        tr = span.read()
        out["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        out["breakdown"] = {"device_ops": trace.top_device_ops(tr),
                            "idle_gaps": trace.top_idle_gaps(tr)}
        out["layer_inputs"] = {"trace": tr, "batch_sizes": batch_sizes,
                               "latencies_ms": lat}
    out["checks"] = check.decide(
        groups, hw=hw, cfg=config["cfg"], limits=ctx["limits"],
        rng=np.random.default_rng(common.seed_of(seed, 3)), device=dev,
        log=lambda msg: print(msg, file=sys.stderr))
    return out

"""The device trace of a short profiled span: ``torch.profiler`` (CUPTI)
over the span, exported as a Chrome trace into ``TMPDIR``, read back and
deleted.

``Span.read()`` returns the span's device operations (kernels, copies and
sets, with start and length in seconds on the trace's clock) and its host
operations; ``busy_s`` is the union of the device operations' time,
``idle_gaps`` the gaps between them, each named by the innermost host
operation running at its middle.
"""
from __future__ import annotations

import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")


class Span:
    """``start()`` ... ``stop()`` around the traced work (the caller
    synchronises the device before ``stop``)."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        # A first, throwaway profile takes the profiler's start-up cost
        # (CUPTI's) out of the traced span.
        with profile(activities=acts):
            torch.ones(1, device="cuda" if len(acts) > 1 else "cpu").sum()
        self._prof = profile(activities=acts)
        self.wall_s = None

    def start(self):
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        self.wall_s = time.perf_counter() - self._t0
        self._prof.stop()

    def read(self) -> dict:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        return parse(events, self.wall_s)


def parse(events: list, wall_s: float) -> dict:
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        item = (e.get("name", "?"), float(e["ts"]) * 1e-6,
                float(e["dur"]) * 1e-6)
        if e.get("cat") in DEVICE_CATS:
            dev.append(item + (e.get("cat"),))
        elif e.get("cat") in HOST_CATS:
            host.append(item)
    dev.sort(key=lambda t: t[1])
    merged = []
    for _, s, d, _ in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], s + d)
        else:
            merged.append([s, s + d])
    busy = sum(b - a for a, b in merged)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    return {"device_ops": dev, "host_ops": host, "busy_s": busy,
            "window_s": wall_s, "gaps": gaps}


def top_device_ops(tr: dict, count: int = 10) -> list:
    tot = {}
    for name, _, d, _ in tr["device_ops"]:
        tot[name] = tot.get(name, 0.0) + d
    return [[n[:200], s] for n, s in
            sorted(tot.items(), key=lambda kv: -kv[1])[:count]]


def top_idle_gaps(tr: dict, count: int = 10) -> list:
    """The ``count`` longest gaps, each named by the innermost host
    operation running at its middle."""
    out = []
    for a, b in sorted(tr["gaps"], key=lambda g: g[0] - g[1])[:count]:
        mid = 0.5 * (a + b)
        inner = [h for h in tr["host_ops"] if h[1] <= mid <= h[1] + h[2]]
        name = min(inner, key=lambda h: h[2])[0] if inner else "host (no op)"
        out.append([name[:200], b - a])
    return out


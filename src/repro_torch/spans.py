"""Phase spans and gauges inside the port, recorded only while a
``torch.profiler`` session records.

    with spans.span("round", device):
        ...
    spans.gauge_max("step_graph_bytes", nbytes)
    spans.report()      # {"spans": {name: {...}}, "gauges": {name: max}}

Off, whenever no profiler records, ``span`` makes one check of the
profiler's state and returns a shared no-op context, and ``gauge_max`` and
``allocated_bytes`` return at once: nothing is recorded, no
``record_function`` is entered, no CUDA event is made.

On, a span enters ``record_function("ss.<name>")``, so the range lands in
the profiler's Chrome trace as a ``user_annotation`` on the kernels'
clock, and records its host interval (``time.perf_counter``) and its
device interval: a pair of timing CUDA events on ``device``'s current
stream for a CUDA ``device``, the host interval otherwise.  The spans
opened while a ``"call"`` span is open share that call's id, an inner
``"call"`` included.

``report()`` synchronises once, resolves the events, and gives for each
name its spans' number (``calls``), host seconds, device seconds and self
device seconds: the device interval less what the spans nested in it
cover.
Nesting is read from containment of device intervals, within one call on
one device, not from a thread's stack: autograd runs a backward on its
own worker thread.  Spans stay in memory until ``reset()``; nothing is
written to disk.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time

import torch
from torch.autograd.profiler import record_function

recording = torch._C._autograd._profiler_enabled
PREFIX = "ss."
_OFF = contextlib.nullcontext()


class _Span:
    """One span while it is open; its record once closed."""

    __slots__ = ("rec", "name", "device", "call", "seq", "host", "events",
                 "dev", "_rf")

    def __init__(self, rec: "Recorder", name: str, device):
        self.rec, self.name = rec, name
        device = None if device is None else torch.device(device)
        if device is not None and device.type == "cuda":
            self.device = torch.device("cuda", torch.cuda.current_device()
                                       if device.index is None
                                       else device.index)
        else:
            self.device = None
        self.events = self.dev = None

    def __enter__(self):
        self._rf = record_function(PREFIX + self.name)
        self._rf.__enter__()
        if self.device is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.rec._open(self)
        self.host = [time.perf_counter(), None]
        return self

    def __exit__(self, *exc):
        self.host[1] = time.perf_counter()
        if self.device is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        else:
            self.dev = tuple(self.host)
        self._rf.__exit__(*exc)
        self.rec._close(self)
        return False


class Recorder:
    """The spans and gauges recorded since the last ``reset``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._spans: list[_Span] = []
            self._gauges: dict[str, float] = {}
            self._refs: dict[torch.device, torch.cuda.Event] = {}
            self._seq = itertools.count()
            self._call_ids = itertools.count()
            self._call, self._depth = None, 0

    def _open(self, sp: _Span) -> None:
        with self._lock:
            if sp.name == "call":
                if self._depth == 0:
                    self._call = next(self._call_ids)
                self._depth += 1
            sp.call, sp.seq = self._call, next(self._seq)
            if sp.device is not None:
                # Each device's first event times all its spans.
                self._refs.setdefault(sp.device, sp.events[0])

    def _close(self, sp: _Span) -> None:
        with self._lock:
            if sp.name == "call":
                self._depth -= 1
                if self._depth == 0:
                    self._call = None
            self._spans.append(sp)

    def gauge_max(self, name: str, value) -> None:
        with self._lock:
            self._gauges[name] = max(self._gauges.get(name, value), value)

    def _resolve(self) -> None:
        """Device intervals in seconds from each device's first event."""
        todo = [s for s in self._spans if s.dev is None]
        for d in {s.device for s in todo}:
            torch.cuda.synchronize(d)
        for s in todo:
            ref = self._refs[s.device]
            s.dev = tuple(ref.elapsed_time(e) * 1e-3 for e in s.events)
            s.events = None

    def report(self) -> dict:
        """``{"spans": {name: {"calls", "host_s", "device_s", "self_s"}},
        "gauges": {name: max}}`` over every span since ``reset``."""
        with self._lock:
            self._resolve()
            spans = list(self._spans)
            gauges = dict(self._gauges)
        covered = {}
        groups = {}
        for s in spans:
            groups.setdefault((s.call, s.device), []).append(s)
        for group in groups.values():
            # Intervals on one stream nest or follow each other: sorted by
            # start, the longer (then the earlier opened) first, each span
            # is a child of the nearest open span that contains it.
            stack = []
            for s in sorted(group, key=lambda s: (s.dev[0], -s.dev[1],
                                                  s.seq)):
                while stack and s.dev[1] > stack[-1].dev[1]:
                    stack.pop()
                if stack:
                    covered[stack[-1].seq] = (covered.get(stack[-1].seq, 0.0)
                                              + s.dev[1] - s.dev[0])
                stack.append(s)
        out = {}
        for s in spans:
            row = out.setdefault(s.name, {"calls": 0, "host_s": 0.0,
                                          "device_s": 0.0, "self_s": 0.0})
            dev = s.dev[1] - s.dev[0]
            row["calls"] += 1
            row["host_s"] += s.host[1] - s.host[0]
            row["device_s"] += dev
            row["self_s"] += dev - covered.get(s.seq, 0.0)
        return {"spans": out, "gauges": gauges}


_RECORDER = Recorder()


def span(name: str, device=None):
    """A context that records phase ``name`` while a profiler records;
    ``device`` (a CUDA device, or None or another for the host's clock)
    is where its work runs."""
    if not recording():
        return _OFF
    return _Span(_RECORDER, name, device)


def gauge_max(name: str, value) -> None:
    """Keep the largest ``value`` of gauge ``name`` while a profiler
    records."""
    if recording():
        _RECORDER.gauge_max(name, value)


def allocated_bytes(device) -> int:
    """The bytes PyTorch's allocator holds on ``device`` while a profiler
    records and the device is a CUDA one; 0 otherwise."""
    if not recording() or torch.device(device).type != "cuda":
        return 0
    return torch.cuda.memory_allocated(device)


def report() -> dict:
    """What ``Recorder.report`` gives for the spans since ``reset``."""
    return _RECORDER.report()


def reset() -> None:
    _RECORDER.reset()

"""The program's phase spans (``repro_torch.spans``) as the per-layer
readers read them.

In a traced run only the window's first call runs under the profiler, so
the program's report holds that call's spans and gauges alone.  A program
without ``repro_torch.spans`` gives nothing, and neither does a trace
without the program's ``ss.*`` annotations: each reader then returns
None.
"""
from __future__ import annotations


def report():
    """The program's span report, or None without the recorder."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    return spans.report()


def self_ms_round(inputs, names):
    """The self device time of the spans ``names``, summed, in ms a round
    of the traced call; None without those spans."""
    rep = report()
    rounds = inputs.get("rounds")
    if not rep or not rounds:
        return None
    rows = [rep["spans"][n] for n in names if n in rep["spans"]]
    if not rows:
        return None
    return 1e3 * sum(r["self_s"] for r in rows) / rounds


def idle_ms(trace, name):
    """The device's idle gaps in ``trace`` whose middle lies inside a host
    annotation ``ss.<name>``, summed, in ms; None without such
    annotations or without device operations."""
    if not trace or not trace["device_ops"]:
        return None
    marks = sorted((s, s + d) for n, s, d in trace["host_ops"]
                   if n == f"ss.{name}")
    if not marks:
        return None
    total = 0.0
    for a, b in trace["gaps"]:
        mid = 0.5 * (a + b)
        if any(s <= mid <= e for s, e in marks):
            total += b - a
    return 1e3 * total

"""The readers of the program's phase spans and of the idle gaps under
its annotations, on a synthetic trace and a stubbed span report, each
loaded from its file as the harness loads it; and None, never a raise,
where the program or the trace has nothing to read."""
from __future__ import annotations

from pathlib import Path

import pytest

from port_bench import harness, phases

ROOT = Path(__file__).resolve().parents[2]


def _reader(name):
    return harness._module(ROOT / "port_bench" / "layer_metrics"
                           / f"{name}.py", name)


def _row(self_s):
    return {"calls": 1, "host_s": 2 * self_s, "device_s": 2 * self_s,
            "self_s": self_s}


REPORT = {"spans": {"apply.fwd": _row(0.3), "apply.bwd": _row(0.5),
                    "loss": _row(0.02), "backward": _row(0.06),
                    "adam": _row(0.004), "shuffle": _row(0.001),
                    "commit": _row(0.003), "call": _row(0.0)},
          "gauges": {"step_graph_bytes": 3 * 2 ** 20}}

# Gaps (start, end) in seconds: middles at 0.15 and 0.55 inside ss.prep
# (0.1-0.6), 1.25 inside ss.round (1.0-2.0), 2.5 and 4.0 outside both.
TRACE = {"host_ops": [("ss.call", 0.0, 5.0), ("ss.prep", 0.1, 0.5),
                      ("aten::add", 0.12, 0.01), ("ss.round", 1.0, 1.0),
                      ("ss.round", 3.0, 0.5)],
         "gaps": [(0.1, 0.2), (0.5, 0.6), (1.2, 1.3), (2.4, 2.6),
                  (3.9, 4.1)],
         "device_ops": [("k", 0.0, 0.1, "kernel")], "busy_s": 1.0,
         "window_s": 5.0}


@pytest.mark.parametrize("name,want", [
    ("apply_ms_round", 1e3 * 0.8 / 4), ("loss_ms_round", 1e3 * 0.08 / 4),
    ("adam_ms_round", 1e3 * 0.004 / 4),
    ("shuffle_ms_round", 1e3 * 0.004 / 4), ("step_graph_mib", 3.0)])
def test_span_readers_on_a_stubbed_report(monkeypatch, name, want):
    monkeypatch.setattr(phases, "report", lambda: REPORT)
    assert _reader(name).read({"rounds": 4}) == pytest.approx(want)


@pytest.mark.parametrize("name,want", [("prep_idle_ms", 200.0),
                                       ("round_idle_ms", 100.0 / 4)])
def test_idle_readers_on_a_synthetic_trace(name, want):
    got = _reader(name).read({"trace": TRACE, "rounds": 4})
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", ["apply_ms_round", "loss_ms_round",
                                  "adam_ms_round", "shuffle_ms_round",
                                  "step_graph_mib"])
@pytest.mark.parametrize("report", [
    None,                                       # no recorder in the program
    {"spans": {}, "gauges": {}},                # nothing recorded
    {"spans": {"call": _row(1.0)}, "gauges": {"step_graph_bytes": 0}}])
def test_span_readers_give_none_with_nothing_to_read(monkeypatch, name,
                                                     report):
    monkeypatch.setattr(phases, "report", lambda: report)
    assert _reader(name).read({"rounds": 4}) is None


@pytest.mark.parametrize("name", ["prep_idle_ms", "round_idle_ms"])
def test_idle_readers_give_none_without_the_annotations(name):
    bare = dict(TRACE, host_ops=[("aten::add", 0.0, 5.0)])
    assert _reader(name).read({"trace": bare, "rounds": 4}) is None
    # A CPU run's trace: the annotations, but no device operation.
    cpu = dict(TRACE, device_ops=[], gaps=[])
    assert _reader(name).read({"trace": cpu, "rounds": 4}) is None
    assert _reader(name).read({"rounds": 4}) is None


def test_report_is_none_without_the_recorder(monkeypatch):
    import sys

    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    assert phases.report() is None

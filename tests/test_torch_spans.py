"""The port's phase spans (``repro_torch.spans``) over the anneal, on the
CPU, where a span's device interval is its host interval.

* Off (no profiler recording): nothing is recorded, and neither
  ``record_function`` nor a CUDA event is ever made.
* On, under ``torch.profiler.profile`` over a tiny batched call on the
  kernel tier (whose CPU route runs the kernels' twins through the same
  autograd Functions): each span's count, the self times tiling the call,
  the ``ss.*`` ranges as ``user_annotation`` events of the Chrome trace,
  and orders and losses bitwise the unprofiled call's.
* The other entry points and the adaptive schedule's ragged rounds open
  one call each and tile it; ``report`` repeats, ``reset`` empties it.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.core import shufflesoftsort as teng  # noqa: E402

HW, R, I = (8, 8), 2, 2
CFG = teng.ShuffleSoftSortConfig(rounds=R, inner_steps=I, use_kernel=True)


def _xs(b=2, d=3):
    return torch.rand(b, HW[0] * HW[1], d,
                      generator=torch.Generator().manual_seed(5))


def _batched(cfg=CFG):
    return teng.shuffle_soft_sort_batched(_xs(), HW, cfg, n_restarts=2,
                                          seed=11, device="cpu")


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """The tiny call unprofiled, then profiled: both results, the spans'
    report and the profiler's exported Chrome trace."""
    spans.reset()
    off = _batched()
    assert spans.report() == {"spans": {}, "gauges": {}}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = _batched()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())
    report = spans.report()
    spans.reset()
    return {"off": off, "on": on, "report": report,
            "events": events.get("traceEvents", events)}


def test_recording_flag_flips_under_the_profiler():
    assert not spans.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert spans.recording()
    assert not spans.recording()


def test_off_records_nothing_and_makes_no_range_or_event(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("made while no profiler records")

    monkeypatch.setattr(spans, "record_function", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    spans.reset()
    _batched()
    spans.gauge_max("g", 5)
    assert spans.allocated_bytes("cpu") == 0
    assert spans.report() == {"spans": {}, "gauges": {}}
    # Every span off is one shared no-op context: nothing is allocated.
    assert spans.span("a", "cpu") is spans.span("b")


@pytest.mark.parametrize("name,count", [
    ("call", 1), ("prep", 1), ("round", R), ("shuffle", 2 * R),
    ("step", R * I), ("loss", R * I), ("apply.fwd", R * I),
    ("backward", R * I), ("apply.bwd", R * I), ("adam", R * I),
    ("commit", R), ("fetch", 1)])
def test_each_span_has_its_count(traced, name, count):
    assert traced["report"]["spans"][name]["calls"] == count


def test_no_other_span_is_recorded(traced):
    assert set(traced["report"]["spans"]) == {
        "call", "prep", "round", "shuffle", "step", "loss", "apply.fwd",
        "backward", "apply.bwd", "adam", "commit", "fetch"}


def test_self_times_tile_the_call(traced):
    rows = traced["report"]["spans"]
    assert all(r["self_s"] >= 0 and r["self_s"] <= r["device_s"] + 1e-12
               for r in rows.values())
    assert sum(r["self_s"] for r in rows.values()) == pytest.approx(
        rows["call"]["device_s"], rel=1e-9)
    # Nested spans cover part of their parents: the apply inside the loss
    # and the backward, the loss inside the step, the steps in the round.
    for name in ("call", "round", "step", "loss", "backward"):
        assert rows[name]["self_s"] < rows[name]["device_s"]
    # On the CPU a device interval is the host interval.
    assert all(r["host_s"] == r["device_s"] for r in rows.values())


def test_spans_are_user_annotations_of_the_chrome_trace(traced):
    names = {e["name"] for e in traced["events"]
             if e.get("cat") == "user_annotation"}
    assert {spans.PREFIX + n for n in traced["report"]["spans"]} <= names


def test_results_bitwise_the_same_with_the_profiler_on(traced):
    off, on = traced["off"], traced["on"]
    for field in ("order", "all_orders", "all_losses", "best_restart"):
        np.testing.assert_array_equal(getattr(off, field), getattr(on, field))
    assert off.all_losses.tobytes() == on.all_losses.tobytes()


def test_step_graph_gauge_reads_zero_on_the_cpu(traced):
    assert traced["report"]["gauges"] == {"step_graph_bytes": 0}


def test_report_repeats_and_reset_empties_it():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("call", "cpu"):
            with spans.span("round", "cpu"):
                spans.gauge_max("g", 3)
                spans.gauge_max("g", 2)
    first = spans.report()
    assert first == spans.report()
    assert first["gauges"] == {"g": 3}
    assert set(first["spans"]) == {"call", "round"}
    spans.reset()
    assert spans.report() == {"spans": {}, "gauges": {}}


def _sequential():
    return teng.shuffle_soft_sort(_xs(1)[0], HW, CFG, seed=3, device="cpu")


def _tournament():
    cfg = teng.ShuffleSoftSortConfig(rounds=4, inner_steps=I,
                                     use_kernel=True)
    return teng.restart_tournament(_xs(), HW, cfg, n_restarts=2, n_rungs=2,
                                   seed=3, device="cpu")


def _adaptive():
    cfg = teng.ShuffleSoftSortConfig(
        rounds=4, inner_steps=I, use_kernel=True, schedule="adaptive",
        patience=1, plateau_rtol=1.0, adapt_every=2)
    return _batched(cfg)


@pytest.mark.parametrize("run", [_sequential, _tournament, _adaptive])
def test_other_entries_open_one_call_and_tile_it(run):
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    rows = spans.report()["spans"]
    spans.reset()
    assert rows["call"]["calls"] == 1
    assert rows["shuffle"]["calls"] == 2 * rows["round"]["calls"]
    assert rows["step"]["calls"] == I * rows["round"]["calls"]
    assert rows["apply.bwd"]["calls"] == rows["step"]["calls"]
    assert sum(r["self_s"] for r in rows.values()) == pytest.approx(
        rows["call"]["device_s"], rel=1e-9)

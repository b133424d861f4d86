"""Whole runs of tiny cells on the CPU, the harness's look for a card
skipped: the last line's keys, ``correct`` on a sound run, and
``correct`` false with the control and with each fault planted in the
timed path.  A cell, traffic kind and per-layer metric added as files
are found without an edit."""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from port_bench import faults

ROOT = Path(__file__).resolve().parents[2]
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(root, cell, *, trace=False, seconds=1.0, seed=2 ** 31 + 3,
         variant="sound"):
    from port_bench import harness
    spec = harness.resolve(root, cell)
    spec, ctx = faults.variant(spec, variant)
    with ctx:
        return harness.run(spec, seed=seed, seconds=seconds, trace=trace,
                           device="cpu", t_start=time.monotonic())


@pytest.mark.parametrize("cell,seconds", [("tiny_gallery", 1.0),
                                          ("tiny_scene", 1.0),
                                          ("tiny_serve", 4.0)])
def test_sound_runs_are_correct_with_the_contracts_keys(tiny_root, cell,
                                                        seconds):
    from port_bench import harness
    spec = harness.resolve(tiny_root, cell)
    line = _run(tiny_root, cell, seconds=seconds)
    assert set(line) == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    traced = _run(tiny_root, cell, seconds=seconds, trace=True)
    assert set(traced) == KEYS | {"breakdown"}
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["metrics"]) <= {m["name"] for m in spec["per_layer"]}
    json.dumps(traced)


@pytest.mark.parametrize("variant", [faults.CONTROL, *faults.FAULTS])
@pytest.mark.parametrize("cell,seconds", [("tiny_gallery", 1.0),
                                          ("tiny_serve", 3.0)])
def test_control_and_faults_come_out_not_correct(tiny_root, cell, seconds,
                                                 variant):
    line = _run(tiny_root, cell, seconds=seconds, variant=variant)
    assert line["correct"] is False, line["checks"]


def _tree_digest(root):
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted((root / "port_bench").rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found_without_edits(tiny_root):
    before = _tree_digest(tiny_root)
    pb = tiny_root / "port_bench"
    (pb / "kinds" / "canned.py").write_text(
        "def measure(ctx):\n"
        "    return {'attempted': 3, 'failed': 0,\n"
        "            'device': {'platform': 'cpu', 'kind': 'cpu',\n"
        "                       'count': 1,\n"
        "                       'memory_peak_bytes': 0,\n"
        "                       'busy_s': 1.0, 'window_s': 2.0},\n"
        "            'end_to_end': {'setup_s': 1.5, 'widgets_s': 9.0},\n"
        "            'breakdown': {'device_ops': [], 'idle_gaps': []},\n"
        "            'layer_inputs': {'x': ctx['traffic']['x']},\n"
        "            'checks': {'bad_answers': {'value': 0, 'limit': 0}}}\n")
    (pb / "traffic" / "canned_mix.json").write_text(
        json.dumps({"kind": "canned", "x": 4.0}))
    (pb / "configs" / "canned_cfg.json").write_text(json.dumps({"d": 1}))
    (pb / "limits" / "canned_cell.json").write_text(json.dumps({}))
    (pb / "layer_metrics" / "twice_x.canned.py").write_text(
        "def read(inputs):\n    return 2 * inputs['x']\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "canned_cfg", "source": "x",
                             "file": "port_bench/configs/canned_cfg.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "canned_cell", "config": "canned_cfg",
                               "traffic": "canned_mix", "chips": 1,
                               "why": "x"})
    bench["end_to_end"].append({"name": "widgets_s", "unit": "s",
                                "better": "lower", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["canned_cell"]})
    bench["per_layer"].append({"name": "twice_x.canned", "unit": "x",
                               "better": "higher", "source": "host_clock",
                               "layer": "x", "moves": "widgets_s",
                               "workloads": ["canned_cell"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = _run(tiny_root, "canned_cell")
    assert line["metrics"] == {"widgets_s": {"value": 9.0, "unit": "s"},
                               "setup_s": {"value": 1.5, "unit": "s"}}
    traced = _run(tiny_root, "canned_cell", trace=True)
    assert traced["metrics"] == {"twice_x.canned": {"value": 8.0,
                                                    "unit": "x"}}
    after = _tree_digest(tiny_root)
    assert all(after[k] == v for k, v in before.items())


def _command(root, *extra):
    return subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "grid8192_gallery", "--seed", str(2 ** 31 + 1), "--seconds", "1",
         *extra], cwd=root, capture_output=True, text=True, timeout=300)


def test_without_a_card_or_the_program_it_prints_no_result(tmp_path):
    import shutil
    import torch
    if not torch.cuda.is_available():
        out = _command(ROOT)
        assert out.returncode != 0 and not out.stdout.strip()
    bare = tmp_path / "bare"
    shutil.copytree(ROOT / "port_bench", bare / "port_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", bare)
    out = _command(bare)
    assert out.returncode != 0 and not out.stdout.strip()


@pytest.mark.cuda
def test_a_short_gallery_run_on_the_card_is_correct(card):
    out = _command(ROOT, "--trace", "0")
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]


def test_calibration_refuses_to_run_without_a_card(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the calibration would run")
    out = subprocess.run(
        [sys.executable, "port_bench/calibrate.py", "--workload",
         "grid8192_gallery", "--seconds", "1", "--seeds", "1", "--out",
         str(tmp_path / "cal.jsonl")], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
    assert not (tmp_path / "cal.jsonl").exists()


def test_quality_scores_a_sorted_layout_below_a_shuffled_one():
    import torch
    from port_bench import check
    g = torch.Generator().manual_seed(5)
    x = torch.linspace(0, 1, 64)[None, :, None].repeat(1, 1, 3)
    shuffled = torch.randperm(64, generator=g)[None]
    ordered = torch.arange(64)[None]
    norms = torch.ones(1)
    q_sorted = check.quality(x, ordered, (8, 8), norms)
    q_shuffled = check.quality(x, shuffled, (8, 8), norms)
    assert q_sorted[0] < 0.5 * q_shuffled[0]
    assert check.quality(x, shuffled, (8, 8), norms)[0] == q_shuffled[0]

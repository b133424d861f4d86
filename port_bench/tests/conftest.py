"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary checkout with tiny cells that run on the CPU, and the card
fixture of the ``cuda``-marked tests."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

# Tiny cells: the real cells' traffic kinds and limits, on an 8 x 8 grid
# of 5-d rows and 6 rounds, small enough for the CPU.  (At 4 rounds the
# third round's first inner step runs at tau 0.0598 on integer keys, where
# the gradient is round-off and Adam's normalised step turns any rounding
# into a whole step: sound runs and the reference part there.)
TINY = {"tiny_gallery": ("grid8192_gallery", "gallery_4x2", {}),
        "tiny_scene": ("sog65536_scene", "scene_1x2", {}),
        "tiny_serve": ("grid8192_serve", "poisson_open",
                       {"rate_per_s": 6.0, "drain_s": 2,
                        "warm_buckets": [1, 2, 4], "trace_s": 1})}

# The open-loop kind has no cell in BENCHMARK.json yet (its tail spread too
# widely on the card: PERF.md, Open questions).  The tiny serve cell brings
# that cell's entries, as the benchmark PR that adds it would.
SERVE_CELL = {"name": "grid8192_serve", "config": "image_grid_8192_d50",
              "traffic": "poisson_open", "chips": 1, "why": "x"}
SERVE_METRICS = {
    "end_to_end": [("request_p90_ms", "ms", "lower", "host_clock")],
    "per_layer": [("device_idle_frac.serve", "fraction", "lower",
                   "device_trace"),
                  ("mean_batch.serve", "requests", "higher",
                   "program_counter"),
                  ("request_p50_ms.serve", "ms", "lower", "host_clock")]}


def pytest_configure(config):
    import torch
    torch.set_num_threads(1)
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def tiny_root(tmp_path):
    """A checkout of BENCHMARK.json and port_bench/ with the tiny cells,
    the program linked in as src/."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "port_bench", root / "port_bench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    (root / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if all(w["name"] != SERVE_CELL["name"] for w in bench["workloads"]):
        bench["workloads"].append(SERVE_CELL)
        for group, metrics in SERVE_METRICS.items():
            for name, unit, better, source in metrics:
                m = {"name": name, "unit": unit, "better": better,
                     "source": source, "workloads": [SERVE_CELL["name"]]}
                if group == "end_to_end":
                    m["bound"] = 0.25
                else:
                    m.update(layer="x", moves="request_p90_ms")
                bench[group].append(m)
    for name in ("image_grid_8192_d50", "sog_65536_d59"):
        conf = json.loads((root / "port_bench" / "configs"
                           / f"{name}.json").read_text())
        conf.update(grid=[8, 8], d=5 if conf["d"] == 50 else conf["d"])
        conf["cfg"] = dict(conf["cfg"], rounds=6)
        if conf["cfg"]["band"] == "auto":
            conf["cfg"]["band"] = 16
        (root / "port_bench" / "configs" / f"tiny_{name}.json").write_text(
            json.dumps(conf))
        bench["configs"].append({
            "name": f"tiny_{name}", "source": "x", "reduced": [], "why": "x",
            "file": f"port_bench/configs/tiny_{name}.json"})
    for cell, (real, traffic, over) in TINY.items():
        wl = next(w for w in bench["workloads"] if w["name"] == real)
        if over:
            t = json.loads((root / "port_bench" / "traffic"
                            / f"{traffic}.json").read_text())
            t.update(over)
            traffic = f"tiny_{traffic}"
            (root / "port_bench" / "traffic" / f"{traffic}.json").write_text(
                json.dumps(t))
        bench["workloads"].append(dict(wl, name=cell, traffic=traffic,
                                       config=f"tiny_{wl['config']}"))
        shutil.copy(root / "port_bench" / "limits" / f"{real}.json",
                    root / "port_bench" / "limits" / f"{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if real in m.get("workloads", ()):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root

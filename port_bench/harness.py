"""The benchmark's driver: it finds a cell's files by the names in
``BENCHMARK.json`` and turns one run into the result line.

A cell (``workloads`` entry) names a configuration and a traffic mix:

* ``configs`` entry ``file``      the configuration: sizes, generator,
                                  the anneal's ``cfg``;
* ``port_bench/traffic/<traffic>.json``  the mix's parameters, with its
                                  ``kind``;
* ``port_bench/kinds/<kind>.py``  the general driver of that kind of
                                  traffic (``measure(ctx)``);
* ``port_bench/limits/<cell>.json``  the limits of the numbers that
                                  decide ``correct``;
* ``port_bench/layer_metrics/<metric>.py``  one reader per per-layer
                                  metric (``read(inputs)``; None when it
                                  finds nothing to read).

So a new configuration, mix, cell or metric is new files and new
entries, and no edit.
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path

BENCH = "port_bench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class CellError(ValueError):
    """The cell or one of its files is missing or malformed."""


def load_benchmark(root: Path) -> dict:
    path = Path(root) / "BENCHMARK.json"
    if not path.is_file():
        raise CellError(f"no BENCHMARK.json at {root}")
    return json.loads(path.read_text())


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise CellError(f"no {what} named {name!r} in BENCHMARK.json")


def _json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def _module(path: Path, what: str):
    if not path.is_file():
        raise CellError(f"{what}: no file {path}")
    spec = importlib.util.spec_from_file_location(
        f"{BENCH}_{path.parent.name}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def resolve(root: Path, cell: str) -> dict:
    """Everything one run of ``cell`` needs, read from its files."""
    root = Path(root)
    bench = load_benchmark(root)
    wl = _by_name(bench["workloads"], cell, "workload")
    conf_entry = _by_name(bench["configs"], wl["config"], "config")
    config = _json(root / conf_entry["file"], f"config {wl['config']}")
    traffic = _json(root / BENCH / "traffic" / f"{wl['traffic']}.json",
                    f"traffic {wl['traffic']}")
    limits = _json(root / BENCH / "limits" / f"{cell}.json",
                   f"limits of {cell}")
    kind = _module(root / BENCH / "kinds" / f"{traffic['kind']}.py",
                   f"traffic kind {traffic['kind']}")
    e2e = [m for m in bench["end_to_end"] if applies(m, cell)]
    layer = [m for m in bench["per_layer"] if applies(m, cell)]
    readers = {m["name"]: _module(
        root / BENCH / "layer_metrics" / f"{m['name']}.py",
        f"per-layer metric {m['name']}") for m in layer}
    return {"root": root, "cell": cell, "workload": wl, "config": config,
            "traffic": traffic, "limits": limits, "kind": kind,
            "end_to_end": e2e, "per_layer": layer, "readers": readers,
            "chips": int(wl["chips"])}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def _number(value):
    """JSON has no infinity: an infinite reading (a latency or gap of
    answers that never came) is written as the largest float."""
    return value if math.isfinite(value) else math.copysign(
        sys.float_info.max, value)


def _metric(value, unit):
    return {"value": _number(value), "unit": unit}


def result_line(spec: dict, out: dict, trace: bool) -> dict:
    """The last line of a run: ``correct``, ``attempted``, ``failed``,
    ``metrics`` (the cell's end-to-end metrics, or with ``trace`` its
    per-layer ones), ``device``, with ``trace`` ``breakdown``, and last
    the numbers compared beside their limits (``checks``)."""
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            v = spec["readers"][m["name"]].read(out["layer_inputs"])
            if v is not None:
                metrics[m["name"]] = _metric(v, m["unit"])
    else:
        for m in spec["end_to_end"]:
            v = out["end_to_end"].get(m["name"])
            if v is None:
                raise CellError(f"{spec['cell']} does not report "
                                f"{m['name']}")
            metrics[m["name"]] = _metric(v, m["unit"])
    checks = out["checks"]
    correct = (out["attempted"] > 0 and bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values()))
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(out["device"])}
    if trace:
        line["breakdown"] = out["breakdown"]
    line["checks"] = {k: {"value": _number(c["value"]),
                          "limit": _number(c["limit"])}
                      for k, c in checks.items()}
    return line


def run(spec: dict, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of the cell: the kind measures, checks and returns the
    raw readings; this makes them the result line."""
    ctx = dict(spec, seed=int(seed), seconds=float(seconds),
               trace=bool(trace), device=device, t_start=t_start)
    out = spec["kind"].measure(ctx)
    return result_line(spec, out, trace)

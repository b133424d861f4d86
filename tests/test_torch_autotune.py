"""The port's payload-tile autotune (``repro_torch.kernels.autotune``),
on the CPU: the cases of ``tests/test_autotune.py`` on the port, and the
dispatch wiring.

* A cold search writes the table and a warm lookup reads it, with no
  search at lookup.
* ``write_table`` merges across backends and unions the candidate grids.
* A miss (no file, a corrupt file, another bench, another backend, an
  unknown shape, a row whose tile the launcher would reject) returns
  ``band_payload_tile(d)[0]``.
* The kernel wrappers pass the table's tile on the card route (the kernel
  library replaced by a recorder, as in ``tests/test_torch_dense_design.py``),
  the caller's tile when one is named, and never consult the table on
  the CPU route.
* The committed table loads and every winner is in its grid.

On the CPU the search times the plain twins, which have no tile: the rows
it writes carry ``backend: "cpu"`` and rank copies of one computation.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import autotune, clib  # noqa: E402
from repro_torch.kernels.autotune import (  # noqa: E402
    CANDIDATES,
    SMOKE_CANDIDATES,
    lookup_blocks,
    search_cell,
    write_table,
)

K = importlib.import_module("repro_torch.kernels.softsort_apply")


def _row(backend="cuda", **kw):
    row = {"tier": "fused", "N": 512, "d": 8, "K": 0, "dtype": "float32",
           "backend": backend, "winner": [32], "winner_s": 1.0,
           "candidate_s": {"32": 1.0}}
    row.update(kw)
    return row


def test_cold_search_writes_warm_lookup_reads(tmp_path, monkeypatch):
    """A search writes its winners; the lookup reads them back without
    searching (a lookup that searched would call ``search_cell``)."""
    path = str(tmp_path / "table.json")
    rows = [search_cell("fused", 64, 4, 0, "float32",
                        SMOKE_CANDIDATES["fused"], reps=1, device="cpu"),
            search_cell("banded", 96, 20, 16, "bfloat16",
                        CANDIDATES["banded"], reps=1, device="cpu")]
    write_table(rows, SMOKE_CANDIDATES, path)
    monkeypatch.setattr(autotune, "search_cell", None)
    assert lookup_blocks("fused", 64, 4, dtype="float32", backend="cpu",
                         path=path) == rows[0]["winner"][0]
    assert lookup_blocks("banded", 96, 20, 16, "bfloat16", "cpu",
                         path) == rows[1]["winner"][0]
    # every candidate has a time; d = 20 clamps 16 to 32: two tiles
    assert set(rows[0]["candidate_s"]) == {"16", "64"}
    assert set(rows[1]["candidate_s"]) == {"16", "32", "64"}
    assert rows[1]["tiles"] == [32, 64]
    assert rows[1]["candidate_s"]["16"] == rows[1]["candidate_s"]["32"]
    for row in rows:
        assert row["bitwise"] is True          # the twins have no tile
        assert row["backend"] == "cpu"
        assert row["winner"][0] in row["tiles"]


@pytest.mark.parametrize("d,tiles", [(8, [16, 32, 64]), (16, [16, 32, 64]),
                                     (17, [32, 64]), (32, [32, 64]),
                                     (33, [64]), (130, [64])])
def test_candidates_clamp_to_the_tiles_the_launcher_takes(d, tiles):
    assert sorted({autotune._effective(c, d)
                   for c in CANDIDATES["fused"]}) == tiles
    assert all(autotune._dt_ok(t, d) for t in tiles)


def test_write_table_merges_across_backends(tmp_path):
    path = str(tmp_path / "merge.json")
    write_table([_row("cpu", winner=[16])], {"fused": [16]}, path)
    write_table([_row("cuda", winner=[64])], {"fused": [64]}, path)
    with open(path) as f:
        doc = json.load(f)
    assert sorted(c["backend"] for c in doc["cells"]) == ["cpu", "cuda"]
    assert doc["candidates"]["fused"] == [16, 64]
    write_table([_row("cuda", winner=[32])], {"banded": [32]}, path)
    with open(path) as f:
        doc = json.load(f)
    assert len(doc["cells"]) == 2
    assert lookup_blocks("fused", 512, 8, path=path) == 32
    assert lookup_blocks("fused", 512, 8, backend="cpu", path=path) == 16
    assert doc["candidates"] == {"banded": [32], "fused": [16, 64]}


@pytest.mark.parametrize("d", [3, 8, 20, 50, 130])
def test_lookup_misses_fall_back(tmp_path, d):
    want = K.band_payload_tile(d)[0]
    assert lookup_blocks("fused", 7777, d, path="/nonexistent/x.json") == want
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert lookup_blocks("banded", 128, d, 16, path=str(bad)) == want
    wrong = tmp_path / "wrong.json"
    wrong.write_text(json.dumps({"bench": "something_else", "cells": []}))
    assert lookup_blocks("fused", 128, d, path=str(wrong)) == want
    # a row naming a tile the launcher rejects at its d is a miss
    illegal = str(tmp_path / "illegal.json")
    write_table([_row(N=128, d=d, winner=[16 if d > 16 else 7])],
                {"fused": [16]}, illegal)
    assert lookup_blocks("fused", 128, d, path=illegal) == want
    garbled = tmp_path / "garbled.json"
    garbled.write_text(json.dumps({"bench": "autotune", "cells": [
        {"tier": "fused", "N": 128}, "junk", dict(_row(N=128, d=d),
                                                  winner="x")]}))
    assert lookup_blocks("fused", 128, d, path=str(garbled)) == want


def test_lookup_keys_are_shape_dtype_backend_specific(tmp_path):
    path = str(tmp_path / "t.json")
    write_table([_row(dtype="bfloat16", winner=[32])], CANDIDATES, path)
    assert lookup_blocks("fused", 512, 8, dtype="bfloat16", path=path) == 32
    fall = K.band_payload_tile(8)[0]
    for kw in (dict(dtype="float32"), dict(n=1024), dict(d=9),
               dict(backend="cpu"), dict(tier="banded"), dict(k=64)):
        args = dict(tier="fused", n=512, d=8, k=0, dtype="bfloat16",
                    backend="cuda", path=path)
        args.update(kw)
        assert lookup_blocks(**args) == fall, kw


@pytest.fixture
def recorded(monkeypatch):
    """Route CPU tensors to the card path with the kernel library
    replaced by a recorder of (symbol, args)."""
    calls = []

    def symbol(stem, name, argtypes, restype):
        def fn(*args):
            calls.append((name, args))
            return 0
        return fn

    monkeypatch.setattr(clib, "route", lambda *tensors: "cuda")
    monkeypatch.setattr(clib, "_symbol", symbol)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: types.SimpleNamespace(cuda_stream=0))
    return calls


def _operands(n, d, cd=torch.float32, bsz=2):
    rng = np.random.default_rng(n + d)
    t = lambda *shape: torch.tensor(  # noqa: E731
        rng.normal(size=shape).astype(np.float32))
    return dict(ws=t(bsz, n), w=t(bsz, n), x=t(bsz, n, d).to(cd),
                tau=torch.full((bsz,), 0.5), m=t(bsz, n), l=t(bsz, n),
                dy=t(bsz, n, d).to(cd), y=t(bsz, n, d).to(cd),
                dc=t(bsz, n).to(cd), D=t(bsz, n))


def _launch_all(o, band, dt=None):
    """Kernels 1, 3, 4, 5, 7, 8 and 9b once each; their payload tiles."""
    K.fwd_fused(o["ws"], o["w"], o["x"], o["tau"], dt)
    K.bwd_dws_delta(o["ws"], o["w"], o["x"], o["tau"], o["m"], o["l"],
                    o["dy"], o["y"], o["dc"], dt)
    K.bwd_dx(o["ws"], o["w"], o["x"], o["tau"], o["m"], o["l"], o["dy"],
             o["dc"], o["D"], dt)
    K.fwd_band(o["ws"], o["x"], o["tau"], band, dt)
    K.bwd_band_dws_delta(o["ws"], o["x"], o["tau"], o["m"], o["l"], o["dy"],
                         o["y"], o["dc"], band, dt)
    K.bwd_band_dcol(o["ws"], o["x"], o["tau"], o["m"], o["l"], o["dy"],
                    o["dc"], o["D"], band, dt)
    if o["x"].dtype == torch.float32:
        K.v1_apply(o["ws"], o["w"], o["x"], o["tau"], o["m"], o["l"], dt)


# the payload-tile argument of each symbol: its position in the args
_DT_ARG = {"ss_fwd_fused": -3, "ss_bwd_dws_delta": -2, "ss_bwd_dx": -2,
           "ss_fwd_band": -2, "ss_bwd_band_dws_delta": -2,
           "ss_bwd_band_dcol": -2, "ss_v1_apply": -2}


def _tiles(calls):
    return {name.rsplit("_", 1)[0]: args[_DT_ARG[name.rsplit("_", 1)[0]]]
            for name, args in calls}


@pytest.mark.parametrize("cd,dtype", [(torch.float32, "float32"),
                                      (torch.bfloat16, "bfloat16")])
def test_wrappers_launch_the_tables_tile(recorded, tmp_path, monkeypatch,
                                         cd, dtype):
    """With a table naming DT = 32 for the dense and DT = 64 for the
    banded cell, the card route passes those tiles (9b: the dense row's);
    without it, ``band_payload_tile(d)[0]``; a caller's tile beats both."""
    n, d, band = 40, 8, 5
    o = _operands(n, d, cd)
    path = str(tmp_path / "t.json")
    write_table([_row(N=n, d=d, dtype=dtype, winner=[32]),
                 _row(tier="banded", N=n, d=d, K=band, dtype=dtype,
                      winner=[64])], CANDIDATES, path)
    dense = {"ss_fwd_fused", "ss_bwd_dws_delta", "ss_bwd_dx", "ss_v1_apply"}

    monkeypatch.setattr(autotune, "TABLE_PATH", path)
    _launch_all(o, band)
    assert {k: (32 if k in dense else 64) for k in _tiles(recorded)} \
        == _tiles(recorded)
    recorded.clear()

    monkeypatch.setattr(autotune, "TABLE_PATH", str(tmp_path / "none.json"))
    _launch_all(o, band)
    assert set(_tiles(recorded).values()) == {16}
    recorded.clear()

    monkeypatch.setattr(autotune, "TABLE_PATH", path)
    _launch_all(o, band, dt=64)
    assert set(_tiles(recorded).values()) == {64}


def test_cpu_route_never_reads_the_table(monkeypatch):
    """The twins have no tile: the CPU route does not consult the table."""
    def boom(*a, **k):
        raise AssertionError("the CPU route looked the table up")

    monkeypatch.setattr(autotune, "lookup_blocks", boom)
    o = _operands(24, 8)
    K.reset_launch_counts()
    _launch_all(o, 4)
    assert sum(K.launch_counts().values()) == 0


def test_ops_carry_the_callers_tile_through_the_backward(recorded):
    """``payload_tile=`` reaches every payload kernel of the Function,
    forward and backward."""
    from repro_torch.kernels import ops
    o = _operands(40, 8)
    for fn, kw in ((ops.softsort_apply, {}),
                   (ops.softsort_apply_banded, {"band": 5})):
        recorded.clear()
        w = o["w"].clone().requires_grad_(True)
        x = o["x"].clone().requires_grad_(True)
        with torch.enable_grad():
            y, c = fn(w, x, 0.5, payload_tile=32, **kw)
            torch.autograd.grad(y.sum() + c.sum(), (w, x))
        tiles = _tiles([(n, a) for n, a in recorded
                        if n.rsplit("_", 1)[0] in _DT_ARG])
        assert len(tiles) == 3 and set(tiles.values()) == {32}


def test_committed_table_loads_and_its_winners_are_in_the_grid():
    with open(autotune.TABLE_PATH) as f:
        doc = json.load(f)
    assert doc["bench"] == "autotune"
    rows = autotune._load_table(autotune.TABLE_PATH)
    assert rows is not None and len(rows) == len(doc["cells"])
    for cell in doc["cells"]:
        assert cell["tier"] in autotune.TIERS
        assert cell["dtype"] in autotune.DTYPES
        assert cell["winner"][0] in doc["candidates"][cell["tier"]]
        assert autotune._dt_ok(cell["winner"][0], cell["d"])
        assert cell["winner"][0] in cell["tiles"]
        assert lookup_blocks(cell["tier"], cell["N"], cell["d"], cell["K"],
                             cell["dtype"], cell["backend"]) \
            == cell["winner"][0]
    for tier in autotune.TIERS:
        assert set(doc["candidates"][tier]) >= set(CANDIDATES[tier])


def test_main_smoke_round_trips(tmp_path):
    out = str(tmp_path / "smoke.json")
    rows = autotune.main(["--device", "cpu", "--smoke", "--reps", "1",
                          "--out", out, "--check"])
    assert len(rows) == len(autotune.SMOKE_CELLS) * len(autotune.DTYPES)
    assert autotune.check_round_trip(rows, out) == []

"""The port's roofline scripts (``repro_torch.bench.roofline``,
``compare_sweeps``, ``hillclimb``, ``run``'s roofline rows) against the
reference's (``benchmarks/roofline.py`` and its siblings) on the CPU."""
import json

import pytest

pytest.importorskip("torch")

from benchmarks import hillclimb as ref_hillclimb  # noqa: E402
from benchmarks import roofline as ref_roofline  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro_torch.bench import compare_sweeps, hillclimb, roofline  # noqa: E402
from repro_torch.bench import run as bench_run  # noqa: E402
from repro_torch.kernels import bounds  # noqa: E402


@pytest.mark.parametrize("arch", list_archs())
def test_active_param_counts_equal_the_references(arch):
    assert roofline.active_param_counts(arch) == \
        ref_roofline.active_param_counts(arch)


def _records():
    out = []
    for i, (arch, shape, kind) in enumerate([
            ("qwen1.5-0.5b", "train_4k", "train"),
            ("granite-moe-3b-a800m", "prefill_32k", "prefill"),
            ("llama3-405b", "decode_32k", "decode"),
            ("jamba-v0.1-52b", "long_500k", "decode")]):
        out.append({"arch": arch, "shape": shape, "kind": kind,
                    "mesh": ("single", "multi")[i % 2], "status": "ok",
                    "roofline_inputs": {
                        "flops": 3.1e13 * (i + 1), "bytes_accessed": 2.2e12,
                        "collective_bytes": 1.7e11 * (4 - i)}})
    out.append({"arch": "qwen1.5-0.5b", "shape": "long_500k",
                "kind": "decode", "mesh": "single", "status": "skipped"})
    out.append({"arch": "qwen1.5-0.5b", "shape": "decode_32k",
                "kind": "decode", "mesh": "single", "status": "error"})
    return out


def test_analyze_at_the_references_rates_equals_the_references():
    """At the reference's TPU v5e rates, the port's analysis of the same
    records (``model_flops`` included) is the reference's, row for row."""
    recs = _records()
    got = roofline.analyze(recs, peak_flops=ref_roofline.PEAK_FLOPS,
                           hbm_bw=ref_roofline.HBM_BW,
                           link_bw=ref_roofline.LINK_BW)
    assert got == ref_roofline.analyze(recs)
    assert len(got) == 4


def test_the_rates_are_an_h100s():
    assert roofline.PEAK_FLOPS == bounds.PEAK_BF16_FLOPS == 989e12
    assert roofline.HBM_BW == bounds.PEAK_BYTES == 3.35e12
    assert roofline.LINK_BW == bounds.PEAK_LINK_BYTES == 450e9
    (row,) = roofline.analyze(_records()[:1])
    ri = _records()[0]["roofline_inputs"]
    assert row["compute_s"] == ri["flops"] / 989e12
    assert row["memory_s"] == ri["bytes_accessed"] / 3.35e12
    assert row["collective_s"] == ri["collective_bytes"] / 450e9
    assert row["dominant"] == "collective"


def test_the_hillclimb_cells_are_the_references():
    assert hillclimb.CELLS == ref_hillclimb.CELLS


def _cell_choices(main, *args):
    """The ``--cell`` choices of a hillclimb ``main``'s parser, read where
    it parses (nothing runs)."""
    import argparse
    import unittest.mock
    seen = []

    def grab(parser, *a, **k):
        seen.extend(next(act.choices for act in parser._actions
                         if act.dest == "cell"))
        raise SystemExit(0)
    with unittest.mock.patch.object(argparse.ArgumentParser, "parse_args",
                                    grab), pytest.raises(SystemExit):
        main(*args)
    return seen


def test_the_hillclimb_cell_choices_are_the_references():
    """``--cell``: the reference's ``CELLS`` and ``paper_sort``."""
    want = _cell_choices(ref_hillclimb.main)
    assert want == list(ref_hillclimb.CELLS) + ["paper_sort"]
    assert _cell_choices(hillclimb.main, []) == want


def test_table_sweeps_and_run_rows_read_the_records(tmp_path, capsys):
    recs = _records()
    before, after = tmp_path / "before.json", tmp_path / "after.json"
    before.write_text(json.dumps(recs))
    faster = json.loads(json.dumps(recs))
    for r in faster:
        if "roofline_inputs" in r:
            r["roofline_inputs"]["bytes_accessed"] /= 2
    after.write_text(json.dumps(faster))

    assert roofline.main(["--records", str(before)]) == 0
    table = capsys.readouterr().out.splitlines()
    assert table[0].split()[:3] == ["arch", "shape", "compute_s"]
    assert len(table) == 2 + 4

    assert compare_sweeps.main(["--before", str(before), "--after",
                                str(after)]) == 0
    out = capsys.readouterr().out
    assert "| qwen1.5-0.5b | train_4k |" in out
    assert "improved: " in out

    bench_run.roofline_rows(str(before))
    rows = capsys.readouterr().out.splitlines()
    assert [r.split(",")[0] for r in rows] == [
        f"roofline.{r['arch']}.{r['shape']}" for r in recs[:4]]
    bench_run.roofline_rows(str(tmp_path / "missing.json"))
    assert "no " in capsys.readouterr().err

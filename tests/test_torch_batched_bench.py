"""The port's batched bench (``repro_torch.bench.batched_bench``) against
the reference's ``benchmarks/batched_bench.py``, on the CPU.

* The problems and keys are the reference bench's, bitwise, in both
  counter layouts (the pinned ``jax<0.5``'s by default).
* ``bench_cell`` anneals what the reference's does: at B = 2, N = 64, 3
  rounds and the std term off (``lambda_sigma=0``, ROADMAP.md Queue C1),
  the batched orders of both benches are equal.
* ``--check`` passes on a clean run and fails, with a non-zero exit, on a
  doctored row of each mode.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from benchmarks import batched_bench as jbench  # noqa: E402
from repro.core.shufflesoftsort import (  # noqa: E402
    ShuffleSoftSortConfig as JConfig,
)
from repro_torch.bench import batched_bench as tbench  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.shufflesoftsort import (  # noqa: E402
    ShuffleSoftSortConfig,
)


@pytest.mark.parametrize("partitionable", [False, True])
def test_inputs_are_the_reference_benchs(partitionable):
    b, n, d = 3, 64, 3
    with jax.threefry_partitionable(partitionable):
        xs = np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (b, n, d)))
        keys = np.asarray(jax.random.split(jax.random.PRNGKey(1), b))
    np.testing.assert_array_equal(
        tbench.problems(b, n, d, "cpu", partitionable).numpy(), xs)
    np.testing.assert_array_equal(
        threefry.key_data(tbench.problem_keys(b, "cpu", partitionable)),
        keys)


def _capture(monkeypatch, module, out):
    real = module.shuffle_soft_sort_batched

    def batched(*a, **k):
        res = real(*a, **k)
        out.append(np.asarray(res.all_orders))
        return res

    monkeypatch.setattr(module, "shuffle_soft_sort_batched", batched)


@pytest.mark.parametrize("partitionable", [False, True])
def test_bench_cell_orders_are_the_reference_benchs(monkeypatch,
                                                    partitionable):
    """Both benches' cells at B = 2, N = 64, 3 rounds x 4 inner steps,
    std term off: the batched runs' orders are equal (the port's on its
    plain tier, the reference's default), and the port's sequential and
    batched paths agree bitwise."""
    kw = dict(rounds=3, inner_steps=4, chunk=256, lambda_sigma=0.0)
    ref, got = [], []
    _capture(monkeypatch, jbench, ref)
    _capture(monkeypatch, tbench, got)
    with jax.threefry_partitionable(partitionable):
        jbench.bench_cell(2, 64, 3, JConfig(**kw))
    row = tbench.bench_cell(2, 64, 3, ShuffleSoftSortConfig(**kw), "cpu",
                            partitionable=partitionable)
    assert row["bitwise"] and row["B"] == 2 and row["N"] == 64
    assert len(ref) == len(got) == 2          # warm-up and timed run
    np.testing.assert_array_equal(got[-1], ref[-1])


def test_check_passes_on_the_cpu(tmp_path):
    """The default sweep's command at N = 64 (the plain tier on the CPU),
    B = 2, 3 rounds, ``--check``; the JSON where ``--out`` points."""
    out = tmp_path / "bench.json"
    doc = tbench.main(["--device", "cpu", "--bs", "2", "--rounds", "3",
                       "--ns", "64", "--check", "--out", str(out)])
    assert doc["mode"] == "sweep" and doc["tier"] == "plain"
    assert json.loads(out.read_text())["cells"][0]["bitwise"]


def test_check_fails_on_a_doctored_row(monkeypatch):
    real = tbench.bench_cell

    def doctored(*a, **k):
        row = real(*a, **k)
        row["seeds_orders_differ"] = [1]
        return row

    monkeypatch.setattr(tbench, "bench_cell", doctored)
    with pytest.raises(SystemExit) as exc:
        tbench.main(["--device", "cpu", "--bs", "2", "--rounds", "1",
                     "--ns", "16", "--check"])
    assert exc.value.code not in (0, None)
    assert "not sequential bitwise" in str(exc.value.code)


def test_scaling_and_cull_modes_pass_their_gates(tmp_path):
    out = tmp_path / "scaling.json"
    doc = tbench.main(["--device", "cpu", "--devices", "1", "2", "--n", "16",
                       "--rounds", "3", "--bs", "2", "--restarts", "2",
                       "--check", "--out", str(out)])
    assert doc["note"] == tbench.SCALING_NOTE
    assert [c["devices"] for c in doc["cells"]] == [1, 2]
    assert all(c["mesh_bitwise"] for c in doc["cells"])
    doc = tbench.main(["--device", "cpu", "--cull-sweep", "--n", "16",
                       "--rounds", "3", "--bs", "2", "--restarts", "4",
                       "--check"])
    fracs = [c["rounds_frac"] for c in doc["cells"]]
    assert fracs[0] == 1.0 and fracs == sorted(fracs, reverse=True)


def test_adaptive_mode_reports_the_gated_columns():
    doc = tbench.main(["--device", "cpu", "--adaptive", "--adaptive-ns",
                       "16", "--rounds", "10", "--bs", "2"])
    (row,) = doc["cells"]
    assert row["mode"] == "adaptive" and row["rounds"] == 10
    assert 0.0 <= row["rounds_saved_frac"] < 1.0
    assert np.isfinite(row["final_loss_gap_pct"])


_CLEAN = {
    "sweep": {"B": 2, "N": 64, "bitwise": True, "seeds_orders_differ": [],
              "seeds_losses_differ": []},
    "scaling": {"devices": 2, "B": 4, "S": 2, "mesh_bitwise": True},
    "cull": {"cull_fraction": 0.0, "rounds_frac": 1.0,
             "loss_gap_vs_full": 0.0},
    "adaptive": {"N": 64, "rounds_saved_frac": 0.3,
                 "final_loss_gap_pct": -0.5},
}


@pytest.mark.parametrize("mode,field,value", [
    ("sweep", "seeds_losses_differ", [0]),
    ("sweep", "seeds_orders_differ", [1]),
    ("scaling", "mesh_bitwise", False),
    ("cull", "loss_gap_vs_full", 0.01),
    ("cull", "rounds_frac", 0.9),
    ("adaptive", "rounds_saved_frac", 0.19),
    ("adaptive", "final_loss_gap_pct", 1.01),
    ("adaptive", "final_loss_gap_pct", float("nan")),
])
def test_gate_rejects_each_doctored_field(mode, field, value):
    assert tbench.gate(mode, [_CLEAN[mode]]) == []
    assert tbench.gate(mode, [dict(_CLEAN[mode], **{field: value})])

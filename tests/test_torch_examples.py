"""The port's section IV-A examples (``repro_torch.examples.quickstart``,
``image_grid_sorting`` and ``batched_image_grids``) against the reference
examples in ``examples/``, on the CPU.

* The data generators (both ``synthetic_catalog``s), the label-agreement
  metric and the PPM writer: bitwise the reference's.
* Each ``main`` at a tiny size with ``--device cpu``, in a scratch
  directory: valid permutations, a better layout than the unsorted one
  (DPQ up, neighbour distance down), and the quickstart's PPM files.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import is_valid_permutation  # noqa: E402
from repro_torch.core.metrics import dpq, mean_neighbor_distance  # noqa: E402
from repro_torch.examples import batched_image_grids as tbatched  # noqa: E402
from repro_torch.examples import image_grid_sorting as tgrid  # noqa: E402
from repro_torch.examples import quickstart as tquick  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference(name):
    spec = importlib.util.spec_from_file_location(
        f"reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_synthetic_catalogs_match_reference():
    ref = _reference("image_grid_sorting")
    for kw in ({}, {"n": 64, "d": 5, "clusters": 3, "seed": 7},
               {"n": 100, "seed": 2}):
        x, labels = tgrid.synthetic_catalog(**kw)
        x_r, labels_r = ref.synthetic_catalog(**kw)
        assert x.dtype == x_r.dtype == np.float32
        np.testing.assert_array_equal(x, x_r)
        np.testing.assert_array_equal(labels, labels_r)
    ref = _reference("batched_image_grids")
    for n, kw in ((256, {}), (64, {"d": 4, "clusters": 5, "seed": 3})):
        x, x_r = tbatched.synthetic_catalog(n, **kw), \
            ref.synthetic_catalog(n, **kw)
        assert x.dtype == x_r.dtype == np.float32
        np.testing.assert_array_equal(x, x_r)


def test_neighbor_label_agreement_matches_reference():
    ref = _reference("image_grid_sorting")
    rng = np.random.default_rng(0)
    for hw in ((4, 4), (8, 8), (3, 5)):
        n = hw[0] * hw[1]
        labels = rng.integers(0, 4, n)
        for order in (np.arange(n), rng.permutation(n)):
            assert tgrid.neighbor_label_agreement(labels, order, hw) == \
                ref.neighbor_label_agreement(labels, order, hw)


def test_save_ppm_matches_reference(tmp_path):
    ref = _reference("quickstart")
    colors = np.random.default_rng(1).random((16, 3), dtype=np.float32)
    tquick.save_ppm(tmp_path / "port.ppm", colors, (4, 4), cell=2)
    ref.save_ppm(tmp_path / "ref.ppm", colors, (4, 4), cell=2)
    assert (tmp_path / "port.ppm").read_bytes() == \
        (tmp_path / "ref.ppm").read_bytes()


def _assert_better(before, after):
    assert after["dpq"] > before["dpq"]
    assert after["nbr"] < before["nbr"]


def test_quickstart_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tquick.main(["--n", "64", "--rounds", "20", "--device", "cpu"])
    assert is_valid_permutation(out["order"])
    _assert_better(out["before"], out["after"])
    assert len(out["losses"]) == 20
    for name in ("colors_before.ppm", "colors_after.ppm"):
        data = (tmp_path / name).read_bytes()
        header = b"P6 64 64 255\n"          # 8 x 8 cells of 8 x 8 pixels
        assert data.startswith(header)
        assert len(data) == len(header) + 64 * 64 * 3


def test_image_grid_sorting_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tgrid.main(["--n", "64", "--rounds", "20", "--device", "cpu"])
    assert is_valid_permutation(out["order"])
    _assert_better(out["before"], out["after"])
    assert out["after"]["label_agree"] > out["before"]["label_agree"]


def test_batched_image_grids_runs_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    out = tbatched.main(["--images", "2", "--n", "64", "--rounds", "20",
                         "--device", "cpu"])
    res, xs, hw = out["result"], out["xs"], (8, 8)
    for b in range(2):
        assert is_valid_permutation(res.order[b])
        _assert_better({"dpq": dpq(xs[b], hw),
                        "nbr": mean_neighbor_distance(xs[b], hw)},
                       {"dpq": dpq(res.sorted[b], hw),
                        "nbr": mean_neighbor_distance(res.sorted[b], hw)})


@pytest.mark.parametrize("main", [tquick.main, tgrid.main, tbatched.main])
def test_examples_refuse_a_non_square_n(main):
    with pytest.raises(SystemExit):
        main(["--n", "63", "--rounds", "1", "--device", "cpu"])

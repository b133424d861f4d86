"""The port's kernel bench (``repro_torch.bench.kernel_bench``) against
the reference's (``benchmarks/kernel_bench.py``), and the bound counts
both it and ``chip_smoke.py`` read (``repro_torch.kernels.bounds``).

On the CPU the bench runs the kernels' plain twins.  On the smoke cell
the same numpy-made operands go through both benches' ``run_cell``: the
port's ``parity`` and ``band`` columns are the reference's, and every
column of both is within its dtype's gate (``--tol`` 2e-3 float32,
``--tol-bf16`` 2e-2, the banded vs-dense columns plus the tail bound).
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from benchmarks import kernel_bench as jbench  # noqa: E402
from repro_torch.bench import kernel_bench as tbench  # noqa: E402
from repro_torch.kernels.bounds import bound_ms, tier_bound_ms  # noqa: E402
from repro_torch.kernels.softsort_apply import TILES  # noqa: E402

TOL = {"float32": 2e-3, "bfloat16": 2e-2}


def test_smoke_check_passes_on_cpu(capsys):
    doc = tbench.main(["--smoke", "--check", "--device", "cpu",
                       "--reps", "1"])
    assert "parity gate OK" in capsys.readouterr().out
    assert [c["dtype"] for c in doc["cells"]] == ["float32", "bfloat16"]
    f32, bf16 = doc["cells"]
    assert doc["wall_clock"] == f32["wall_clock"] == "cpu_twins"
    assert set(f32["fwd_s"]) == {"dense", "chunked", "kernel_v1", "fused",
                                 "banded"}
    assert set(bf16["fwdgrad_s"]) == {"fused", "banded"}
    assert set(f32["bound_ms"]) == {"kernel_v1", "fused", "banded"}
    assert f32["tiles"] == TILES


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        tbench.main(["--smoke"])


def test_gate_flags_a_column_over_its_tolerance():
    cell = {"N": 8, "d": 1, "B": 1, "dtype": "float32",
            "parity": {"fused_y_relerr": 3e-3},
            "band": {"K": 2, "tail_bound": 1e-3, "vs_dense_y_relerr": 2.5e-3,
                     "vs_oracle_y_relerr": float("nan")}}
    bad = tbench.gate([cell], 2e-3, 2e-2)
    assert [b[4] for b in bad] == ["fused_y_relerr", "band.vs_oracle_y_relerr"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_run_cell_matches_the_reference_bench(dtype):
    """One smoke cell, the same operands through both benches."""
    n, d, bsz, band = tbench.SMOKE_CELLS[0]
    assert jbench.SMOKE_CELLS[0] == (n, d, bsz, band)
    rng = np.random.default_rng(5)
    w = np.stack([rng.permutation(n) for _ in range(bsz)]).astype(np.float32)
    x = rng.normal(size=(bsz, n, d)).astype(np.float32)
    a = rng.normal(size=(bsz, n, d)).astype(np.float32)
    b = rng.normal(size=(bsz, n)).astype(np.float32)
    got = tbench.run_cell(n, d, bsz, band, dtype, reps=1, operands=tuple(
        torch.tensor(t) for t in (w, x, a, b)))
    want = jbench.run_cell(n, d, bsz, band, dtype, reps=1, operands=tuple(
        jnp.asarray(t) for t in (w, x, a, b)))
    assert set(got["parity"]) == set(want["parity"])
    assert set(got["band"]) == set(want["band"])
    assert set(got["fwd_s"]) == set(want["fwd_s"])
    assert got["band"]["K"] == want["band"]["K"] == band
    assert got["band"]["tail_bound"] == pytest.approx(
        want["band"]["tail_bound"], abs=1e-30)
    for cell in (got, want):
        assert not tbench.gate([cell], TOL["float32"], TOL["bfloat16"])


# The bounds of PERF.md's kernel table (NVIDIA H100 peaks):
# (kernel, shape) -> ms.
PINNED = {
    ("fwd_fused", (8, 4096, 50)): 0.2123,
    ("colsum", (8, 4096, 50)): 0.01202,
    ("v1_stats", (8, 4096, 50)): 0.01402,
    ("v1_apply", (8, 4096, 50)): 0.2104,
    ("bwd_dws_delta", (8, 4096, 50)): 0.2284,
    ("bwd_dx", (8, 4096, 50)): 0.4267,
    ("fwd_band", (8, 4096, 50, 256)): 0.02576,
    ("colsum_band", (8, 4096, 50, 256)): 0.001458,
    ("bwd_band_dws_delta", (8, 4096, 50, 256)): 0.02771,
    ("bwd_band_dcol", (8, 4096, 50, 256)): 0.05177,
    ("fwd_band", (2, 65536, 14, 4096)): 0.5279,
    ("colsum_band", (2, 65536, 14, 4096)): 0.09316,
    ("bwd_band_dws_delta", (2, 65536, 14, 4096)): 0.6521,
    ("bwd_band_dcol", (2, 65536, 14, 4096)): 1.071,
}


@pytest.mark.parametrize("kernel,shape", sorted(PINNED))
def test_bounds_reproduce_the_recorded_ones(kernel, shape):
    ms, by = bound_ms(kernel, *shape)
    assert by == "operations"
    assert ms == pytest.approx(PINNED[kernel, shape], rel=5e-4)


def test_tier_bound_sums_its_kernels():
    fused = sum(bound_ms(k, 8, 4096, 50)[0]
                for k in ("fwd_fused", "colsum", "bwd_dws_delta", "bwd_dx"))
    assert tier_bound_ms("fused", 8, 4096, 50, 256) == pytest.approx(fused)
    assert tier_bound_ms("banded", 2, 8, 3, 7) == pytest.approx(
        tier_bound_ms("fused", 2, 8, 3, 7))      # K >= N - 1 runs dense
    assert tier_bound_ms("dense", 8, 4096, 50, 256) is None


def test_tiles_are_the_cuda_constants():
    """The bench's ``tiles`` are the v1 kernels' fixed tiles as
    csrc/softsort_apply.cu declares them at namespace scope: kernel 9a's
    rows and threads per block, and kernel 9b's column step."""
    src = (Path(tbench.__file__).parents[1] / "kernels" / "csrc"
           / "softsort_apply.cu").read_text()
    found = dict(re.findall(r"^constexpr int (\w+) = (\d+);", src, re.M))
    assert set(TILES) == {"V1_TR", "V1_NT", "BTC"}
    assert {k: int(found[k]) for k in TILES} == TILES

"""The port's SOG codec (``repro_torch.runtime.sog_compress``) and its SOG
entry point (``repro_torch.examples.self_organizing_gaussians``) against
the JAX reference, on the CPU.

The codec's sort is the only part that differs between the packages (the
port anneals with its own engine and shuffle streams); quantization,
delta coding and zlib are the same numpy code.  So the byte-level tests
replace the sort in both packages by one fixed permutation of the grid
(monkeypatched here, not edited) and require byte-identical blobs: the
payload, the permutation, the scale and the sizes.  A run with the real
sort checks the round trip on its own.
"""
import dataclasses
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.runtime import sog_compress as jsog  # noqa: E402
from repro_torch.examples import self_organizing_gaussians as tex  # noqa: E402
from repro_torch.runtime import sog_compress as tsog  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _reference_example():
    spec = importlib.util.spec_from_file_location(
        "reference_sog_example", ROOT / "examples" /
        "self_organizing_gaussians.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_grid_hw_matches_reference():
    for n in range(1, 5001):
        assert tsog._grid_hw(n) == jsog._grid_hw(n), n


def _fixed_sort(monkeypatch):
    """Replace the sort of both packages by one permutation of the grid
    (a function of its size only); record what each was asked to sort."""
    calls = {"ref": [], "port": []}

    def fake(tag):
        def sort(feats, hw, cfg, **kw):
            feats = np.asarray(feats, np.float32)
            calls[tag].append((feats, tuple(hw), cfg, kw))
            order = np.random.RandomState(feats.shape[0]).permutation(
                feats.shape[0]).astype(np.int32)
            return order, feats[order], []
        return sort

    monkeypatch.setattr(jsog, "shuffle_soft_sort", fake("ref"))
    monkeypatch.setattr(tsog, "shuffle_soft_sort", fake("port"))
    return calls


def _correlated(d, f, seed):
    """Low rank plus duplicated columns: what sorting helps."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d, 3)) @ rng.normal(size=(3, f))
    w[:, f // 2:] = w[:, :f - f // 2] + 0.01 * rng.normal(size=(d, f - f // 2))
    return w.astype(np.float32)


def _assert_same_blob(got, want):
    assert got["payload"] == want["payload"]
    np.testing.assert_array_equal(got["perm"], want["perm"])
    assert got["perm"].dtype == want["perm"].dtype == np.int32
    for k in ("scale", "shape", "bytes", "baseline_bytes", "raw_bytes"):
        assert got[k] == want[k], k


@pytest.mark.parametrize("d,f", [(40, 64), (33, 67), (20, 128)],
                         ids=["square", "padded_prime", "non_square"])
def test_compress_tensor_byte_identical_for_the_same_order(monkeypatch, d, f):
    calls = _fixed_sort(monkeypatch)
    w = _correlated(d, f, seed=f)
    want = jsog.sog_compress_tensor(w, sort_rounds=5,
                                    key=jax.random.PRNGKey(0))
    got = tsog.sog_compress_tensor(torch.tensor(w), sort_rounds=5,
                                   device="cpu")
    _assert_same_blob(got, want)
    (jf, jhw, jcfg, _), = calls["ref"]
    (tf, thw, tcfg, tkw), = calls["port"]
    np.testing.assert_array_equal(tf, jf)
    assert thw == jhw and tkw["device"] == "cpu"
    for field in ("rounds", "inner_steps", "chunk", "use_kernel"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field
    assert (jhw[0] * jhw[1] > f) == (f == 67)
    assert sorted(got["perm"].tolist()) == list(range(f))
    np.testing.assert_array_equal(tsog.sog_decompress_tensor(got),
                                  jsog.sog_decompress_tensor(want))


def test_compress_checkpoint_matches_reference(monkeypatch):
    """Nested dict with lists, a None and small leaves: the same leaf
    order as ``jax.tree.flatten``, the same blobs and stats."""
    _fixed_sort(monkeypatch)
    params = {
        "dec": {"w": _correlated(24, 80, 1), "bias": np.ones(80, np.float32)},
        "blocks": [{"proj": _correlated(12, 96, 2).reshape(3, 4, 96),
                    "norm": None},
                   {"proj": _correlated(16, 64, 3), "norm": None}],
        "emb": _correlated(30, 20, 4),
    }
    want = jsog.compress_checkpoint(params, sort_rounds=3)
    got = tsog.compress_checkpoint(
        {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
         for k, v in params.items()}, sort_rounds=3, device="cpu")
    leaves = jax.tree.leaves(params)
    assert len(got["paths"]) == len(leaves) == len(got["blobs"])
    for path, leaf in zip(got["paths"], leaves):
        node = params
        for k in path:
            node = node[k]
        assert node is leaf
    assert [b is None for b in got["blobs"]] == [b is None
                                                  for b in want["blobs"]]
    assert sum(b is not None for b in got["blobs"]) == 3
    for g, w in zip(got["blobs"], want["blobs"]):
        if w is not None:
            _assert_same_blob(g, w)
    assert got["stats"] == want["stats"]


def test_round_trip_is_exact_with_the_real_sort():
    """The port's own sort (a few rounds on the CPU): a permutation of the
    columns, and the decompressed tensor is the int8-quantized input,
    bitwise."""
    w = _correlated(20, 64, 5)
    blob = tsog.sog_compress_tensor(w, sort_rounds=4, seed=3, device="cpu")
    assert sorted(blob["perm"].tolist()) == list(range(64))
    q, scale = tsog._quantize(w)
    np.testing.assert_array_equal(tsog.sog_decompress_tensor(blob),
                                  q.astype(np.float32) * scale)
    assert blob["scale"] == scale
    again = tsog.sog_compress_tensor(w, sort_rounds=4, seed=3, device="cpu")
    assert again["payload"] == blob["payload"]


def test_scene_and_plane_bytes_match_reference_example():
    ref = _reference_example()
    for n, seed in ((64, 0), (100, 3)):
        a = tex.synthetic_scene(n, seed=seed)
        b = ref.synthetic_scene(n, seed=seed)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    attrs = tex.synthetic_scene(64)
    order = np.random.RandomState(2).permutation(64)
    for o in (np.arange(64), order):
        assert tex.plane_bytes(attrs, o, (8, 8)) == ref.plane_bytes(
            attrs, o, (8, 8))


def test_example_refuses_a_non_square_n():
    with pytest.raises(SystemExit):
        tex.main(["--n", "63", "--rounds", "1", "--device", "cpu"])


def test_example_runs_on_the_cpu_when_asked(monkeypatch):
    """``main`` with ``--device cpu`` at a small size: the port's sort runs
    on the CPU with the example's config.  Its order is then replaced by
    the splats sorted along one coordinate, a layout the codec proxy must
    find smaller than the random one (the anneal's own gain is measured
    on the card at the real size)."""
    seen = {}
    sort = tex.shuffle_soft_sort

    def spy(x, hw, cfg, **kw):
        seen.update(kw, hw=hw, cfg=cfg)
        order, xs, losses = sort(x, hw, cfg, **kw)
        assert sorted(order.tolist()) == list(range(x.shape[0]))
        seen["losses"] = losses
        return np.argsort(x[:, 0], kind="stable"), xs, losses

    monkeypatch.setattr(tex, "shuffle_soft_sort", spy)
    out = tex.main(["--n", "64", "--rounds", "2", "--device", "cpu"])
    assert out["sorted_bytes"] < out["random_bytes"]
    assert seen["device"] == "cpu" and seen["seed"] == 5
    assert seen["hw"] == (8, 8) and len(seen["losses"]) == 2
    assert dataclasses.asdict(seen["cfg"])["inner_steps"] == 8

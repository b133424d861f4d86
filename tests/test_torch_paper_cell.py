"""The paper cell on a mesh (``repro_torch.launch.paper``, the dry-run's
``--paper`` and hillclimb's ``paper_sort``) against the reference's
(``repro.launch.dryrun.run_paper_cell``, ``benchmarks/hillclimb.py``) on
the CPU.

* The per-shard round on a one-rank ``gloo`` group against the reference's
  ``_outer_round`` (unsharded, jax on the CPU) at N = 1024 on the 32 x 32
  grid, two chunks of 512, tau_r = 1.0 (a warm round: ROADMAP.md Queue C's
  known property 1): the shuffle bitwise, the order equal, the loss within
  rtol 1e-5.  On four ``gloo`` ranks the shards, concatenated, are bitwise
  the one-rank round; the grad step's loss and gradient hold to the
  one-rank step's.
* The dry-run's collectives against the reference's compiled round (8
  forced host devices, a (4, 2) mesh, N = 4096): kinds, counts, bytes.
* The hand arithmetic of the module docstring: the cell's wire bytes at
  N = 2^20 on both production meshes, its FLOPs, and each hillclimb
  variant's wire bytes.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import shufflesoftsort as ref_engine  # noqa: E402
from repro.core.losses import mean_pairwise_distance  # noqa: E402
from repro.core.softsort import softsort_apply_chunked as ref_apply  # noqa: E402
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro_torch.bench import hillclimb  # noqa: E402
from repro_torch.core import threefry as tf  # noqa: E402
from repro_torch.core.reference import config_from_reference  # noqa: E402
from repro_torch.launch import dryrun, paper  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, D, HW, CHUNK = 1024, 59, (32, 32), 512


def _problem(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((N, D), dtype=np.float32)
    order = rng.permutation(N).astype(np.int32)
    key = np.asarray(jax.random.PRNGKey(seed + 7))
    norm = np.float32(mean_pairwise_distance(jnp.asarray(x)))
    return x, order, key, norm


def _cfgs():
    ref = ref_engine.ShuffleSoftSortConfig(inner_steps=2, chunk=CHUNK)
    return ref, config_from_reference(dataclasses.asdict(ref))


# ---------------------------------------------- one gloo rank: the round

def _grad_w():
    return (np.arange(N, dtype=np.float32)
            + np.random.default_rng(3).normal(size=N).astype(np.float32))


@pytest.fixture(scope="module")
def one_rank():
    """The round and the grad step on a one-rank ``gloo`` group, made and
    destroyed here (the fake group of the tests below is process-global
    too): {"round": (order, loss), "step": (loss, grad)}."""
    import torch.distributed as dist
    x, order, key, norm = _problem()
    _, cfg = _cfgs()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        group = dist.group.WORLD
        out = {"round": paper.paper_round(
            torch.as_tensor(x), torch.as_tensor(order),
            torch.as_tensor(key.astype(np.int64)), torch.tensor(1.0),
            torch.tensor(norm), hw=HW, cfg=cfg, group=group),
            "step": paper.sort_grad_step(
                torch.as_tensor(_grad_w()), torch.as_tensor(x), 0.5,
                torch.tensor(norm), hw=HW, chunk=CHUNK, group=group)}
    finally:
        dist.destroy_process_group()
    return out


def test_one_rank_round_is_the_references(one_rank):
    x, order, key, norm = _problem()
    rcfg, _ = _cfgs()
    fn = jax.jit(functools.partial(
        ref_engine._outer_round.__wrapped__, hw=HW, cfg=rcfg,
        apply_fn=functools.partial(ref_apply, chunk=CHUNK)))
    want_order, want_loss = fn(jnp.asarray(x), jnp.asarray(order),
                               jnp.asarray(key), jnp.float32(1.0),
                               jnp.float32(norm))
    np.testing.assert_array_equal(
        tf.permutation(key, N, device="cpu").numpy(),
        np.asarray(jax.random.permutation(jnp.asarray(key), N)))
    new, loss = one_rank["round"]
    assert new.dtype == torch.int32
    np.testing.assert_array_equal(new.numpy(), np.asarray(want_order))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)


# ------------------------------------------------ four gloo ranks

_RANK = textwrap.dedent("""
    import json, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store, 4),
                            rank=rank, world_size=4)
    from repro_torch.core.shufflesoftsort import ShuffleSoftSortConfig
    from repro_torch.launch import paper
    inputs = np.load(sys.argv[4])
    x, order, key = inputs["x"], inputs["order"], inputs["key"]
    w = inputs["w"]
    rows = x.shape[0] // 4
    mine = slice(rank * rows, (rank + 1) * rows)
    cfg = ShuffleSoftSortConfig(**json.loads(sys.argv[5]))
    group = dist.group.WORLD
    new, loss = paper.paper_round(
        torch.as_tensor(x[mine]), torch.as_tensor(order[mine]),
        torch.as_tensor(key), torch.tensor(1.0),
        torch.tensor(float(inputs["norm"])), hw=(32, 32), cfg=cfg,
        group=group)
    gl, grad = paper.sort_grad_step(
        torch.as_tensor(w), torch.as_tensor(x[mine]), 0.5,
        torch.tensor(float(inputs["norm"])), hw=(32, 32), chunk=512,
        group=group)
    np.savez(out + f"{rank}.npz", order=new.numpy(), loss=loss.numpy(),
             grad_loss=gl.numpy(), grad=grad.numpy())
    dist.barrier()
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paper_ranks")
    x, order, key, norm = _problem()
    _, cfg = _cfgs()
    np.savez(tmp / "inputs.npz", x=x, order=order,
             key=key.astype(np.int64), norm=norm, w=_grad_w())
    (tmp / "rank.py").write_text(_RANK)
    fields = json.dumps({"inner_steps": cfg.inner_steps,
                         "chunk": cfg.chunk})
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(tmp / "rank.py"), str(r), str(tmp / "store"),
         str(tmp / "out"), str(tmp / "inputs.npz"), fields], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    errs = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=180)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            _, err = p.communicate()
        errs.append(err)
    assert all(p.returncode == 0 for p in procs), "\n".join(
        e[-1500:] for e in errs)
    return [dict(np.load(tmp / f"out{r}.npz")) for r in range(4)]


def test_four_rank_round_is_bitwise_the_one_rank_round(four_ranks,
                                                       one_rank):
    new, loss = one_rank["round"]
    got = np.concatenate([r["order"] for r in four_ranks])
    np.testing.assert_array_equal(got, new.numpy())
    for r in four_ranks:
        assert r["loss"].tobytes() == loss.numpy().tobytes()


def test_four_rank_grad_step_holds_to_the_one_rank_step(four_ranks,
                                                        one_rank):
    """The grad step over four ranks: the loss bitwise (every rank holds
    the whole y), the gradient, summed from four partials, within
    1e-5 x max |g| of the one-rank step's, which is the unsharded one."""
    x, _, _, norm = _problem()
    w = torch.as_tensor(_grad_w())
    loss, grad = one_rank["step"]
    from repro_torch.core.losses import grid_sorting_loss
    from repro_torch.core.softsort import softsort_apply_chunked
    wv = w.clone().requires_grad_(True)
    y, cs = softsort_apply_chunked(wv, torch.as_tensor(x), 0.5, CHUNK)
    want = grid_sorting_loss(y, cs, torch.as_tensor(x), HW,
                             torch.tensor(norm))
    (want_grad,) = torch.autograd.grad(want, wv)
    assert torch.equal(loss, want.detach())
    assert torch.equal(grad, want_grad)
    bound = 1e-5 * float(want_grad.abs().max())
    for r in four_ranks:
        assert r["grad_loss"].tobytes() == loss.numpy().tobytes()
        assert np.abs(r["grad"] - want_grad.numpy()).max() <= bound


# ------------------------------------- the fake group: collectives, FLOPs

_REF_CELL = textwrap.dedent("""
    import functools, json, sys
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.core.shufflesoftsort import (ShuffleSoftSortConfig,
                                            _outer_round)
    from repro.core.softsort import softsort_apply_chunked
    from repro.launch.mesh import make_production_mesh
    n, d, hw = 4096, 59, (64, 64)
    mesh = make_production_mesh(shape=(4, 2))
    from repro.launch.dryrun import collective_stats
    out = {}
    for chunk in (512, 2048):
        cfg = ShuffleSoftSortConfig(inner_steps=2, chunk=chunk)
        fn = functools.partial(_outer_round.__wrapped__, hw=hw, cfg=cfg,
                               apply_fn=functools.partial(
                                   softsort_apply_chunked, chunk=chunk))
        rows, x = (NamedSharding(mesh, P("data")),
                   NamedSharding(mesh, P("data", None)))
        jfn = jax.jit(fn, in_shardings=(x, rows, None, None, None),
                      out_shardings=(rows, None))
        args = (jax.ShapeDtypeStruct((n, d), jnp.float32),
                jax.ShapeDtypeStruct((n,), jnp.int32),
                jax.ShapeDtypeStruct((2,), jnp.uint32),
                jax.ShapeDtypeStruct((), jnp.float32),
                jax.ShapeDtypeStruct((), jnp.float32))
        with jax.set_mesh(mesh):
            compiled = jfn.lower(*args).compile()
        out[chunk] = {"flops": float(compiled.cost_analysis()["flops"]),
                      "collectives": collective_stats(compiled.as_text())}
    json.dump(out, open(sys.argv[1], "w"))
""")


@pytest.fixture(scope="module")
def ref_cell(tmp_path_factory):
    """The reference's round compiled on a (4, 2) mesh of 8 forced host
    devices at N = 4096, chunks 512 and 2048: its FLOPs and collectives."""
    tmp = tmp_path_factory.mktemp("ref_cell")
    (tmp / "cell.py").write_text(_REF_CELL)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    done = subprocess.run([sys.executable, str(tmp / "cell.py"),
                           str(tmp / "out.json")], env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    return {int(k): v for k, v in
            json.loads((tmp / "out.json").read_text()).items()}


@pytest.fixture(scope="module")
def group():
    dryrun.init_fake_group(512)
    yield {"single": make_production_mesh(),
           "multi": make_production_mesh(multi_pod=True),
           "small": make_production_mesh(shape=(4, 2))}
    dryrun.destroy_group()


def _coll(stats):
    return {k: (v["count"], v["bytes"]) for k, v in stats.items()
            if k != "total_bytes"}


def test_cell_collectives_are_the_reference_partitioners(group, ref_cell):
    rec = dryrun.run_paper_cell(group["small"], "small", n=4096, hw=(64, 64))
    assert rec["status"] == "ok"
    assert _coll(rec["collectives"]) == _coll(ref_cell[512]["collectives"])
    assert (rec["collectives"]["total_bytes"]
            == ref_cell[512]["collectives"]["total_bytes"]
            == paper.paper_cell_collectives(4096, 59, 4)["total_bytes"])


@pytest.mark.parametrize("chunk", [512, 2048])
def test_cell_flops_count_every_chunk(group, chunk):
    """Two inner steps of ``p @ x`` and its backward ``dy @ x^T`` over
    every (chunk, N) block: ``2 * 2 * (2 N^2 d)`` at any chunk."""
    rec = dryrun.run_paper_cell(group["small"], "small", n=4096, d=59,
                                chunk=chunk, hw=(64, 64))
    assert rec["cost_analysis"]["flops"] == 2 * 2 * (2 * 4096 ** 2 * 59)
    assert rec["cost_analysis"]["flops"] == paper.round_flops(4096, 59, 2,
                                                              chunk)


def test_references_flops_count_one_map_body(ref_cell):
    """The reference's record counts one ``lax.map`` body of the chunked
    apply, not the loop: the same round counts 4x the FLOPs at chunk
    2048 that it counts at 512 (ROADMAP.md Queue C's known property), and
    both far below every chunk's products."""
    f512, f2048 = ref_cell[512]["flops"], ref_cell[2048]["flops"]
    assert 3.5 < f2048 / f512 < 4.5
    assert f2048 < paper.round_flops(4096, 59, 2, 2048) / 1.5


@pytest.fixture()
def stub_apply(monkeypatch):
    """The chunked apply replaced by a cheap one of the same shapes: the
    cell's collectives do not depend on it."""
    from repro_torch.core import softsort

    def apply(w, x, tau, chunk=256):
        return x * w[..., None], w
    monkeypatch.setattr(softsort, "softsort_apply_chunked", apply)


@pytest.mark.parametrize("mesh_name,total,g", [("single", 475_791_360, 16),
                                               ("multi", 253_755_392, 2)])
def test_cell_collectives_are_the_hand_arithmetic(group, stub_apply,
                                                  mesh_name, total, g):
    rec = dryrun.run_paper_cell(group[mesh_name], mesh_name)
    coll = rec["collectives"]
    assert coll["total_bytes"] == total
    assert coll["all-gather"] == {"count": 1, "bytes": 4 * 2 ** 20 * (g - 1)
                                  / g}
    assert coll["all-reduce"]["count"] == 2
    assert paper.paper_cell_collectives(2 ** 20, 59, g)["total_bytes"] == total


def test_the_shuffle_is_one_op_on_meta():
    """``permutation`` on ``meta`` keys: one ``repro_torch::threefry_round``
    op where the card runs one launch, none of its twin's hash ops."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Ops(TorchDispatchMode):
        seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(f"{func.namespace}::{func._opname}")
            return func(*args, **(kwargs or {}))

    key = torch.empty((2,), dtype=torch.int64, device="meta")
    with Ops() as ops:
        out = tf.permutation(key, 4096)
    assert out.shape == (4096,) and out.device.type == "meta"
    assert ops.seen.count("repro_torch::threefry_round") == 1
    assert not {"aten::bitwise_xor", "aten::__rshift__",
                "aten::bitwise_left_shift"} & set(ops.seen)


# --------------------------------------------------- CLIs and hillclimb

def _with_own_group(group, fn):
    """Run a CLI that makes its own fake group, the fixture's set aside."""
    dryrun.destroy_group()
    try:
        return fn()
    finally:
        dryrun.init_fake_group(512)
        group["single"] = make_production_mesh()
        group["multi"] = make_production_mesh(multi_pod=True)
        group["small"] = make_production_mesh(shape=(4, 2))


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
def test_cli_paper_writes_the_references_keys(group, tmp_path, monkeypatch,
                                              mesh_name):
    monkeypatch.setattr(dryrun, "run_paper_cell", functools.partial(
        dryrun.run_paper_cell, n=4096, hw=(64, 64)))
    out = tmp_path / "paper.json"
    rc = _with_own_group(group, lambda: dryrun.main(
        ["--paper", "--mesh", mesh_name, "--out", str(out)]))
    assert rc == 0
    (rec,) = json.loads(out.read_text())
    assert set(rec) >= {"arch", "shape", "mesh", "kind", "lower_s",
                        "compile_s", "cost_analysis", "collectives",
                        "status"}
    assert (rec["arch"], rec["mesh"], rec["kind"], rec["status"]) == (
        "paper-sort-2^20x59", mesh_name, "paper", "ok")
    assert rec["shape"] == "N=4096 d=59" and rec["compile_s"] == 0.0
    assert set(rec["cost_analysis"]) == {"flops", "bytes_accessed"}
    assert set(rec["collectives"]) == set(ref_dryrun._COLLECTIVES) | {
        "total_bytes"}
    g = 16 if mesh_name == "single" else 2
    assert rec["collectives"]["total_bytes"] == paper.paper_cell_collectives(
        4096, 59, g)["total_bytes"]


def test_cli_needs_a_cell(group):
    with pytest.raises(SystemExit):
        _with_own_group(group, lambda: dryrun.main([]))


def test_paper_sort_writes_the_references_variants(group, tmp_path,
                                                   monkeypatch):
    """``--cell paper_sort`` at N = 4096: the reference's five variants
    and record keys, each variant's wire bytes its hand arithmetic (rows
    over "data", g = 16, or over all 256 ranks; the payload's bytes), its
    FLOPs the products of its own rows, ``4 N (N / g) d``."""
    monkeypatch.setattr(hillclimb, "run_paper_variants", functools.partial(
        hillclimb.run_paper_variants, n=4096, hw=(64, 64)))
    monkeypatch.chdir(tmp_path)
    rc = _with_own_group(group, lambda: hillclimb.main(
        ["--cell", "paper_sort"]))
    out = tmp_path / "hillclimb_paper_sort.json"
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [r["variant"] for r in recs] == [
        "baseline_rows_axis0_c512", "rows_all_axes_c512",
        "rows_all_axes_c2048", "rows_all_axes_c512_bf16x",
        "rows_all_axes_c2048_bf16x"]
    for rec, (_, chunk, bf16, all_axes) in zip(recs,
                                               hillclimb.PAPER_VARIANTS):
        assert set(rec) == {"variant", "flops", "bytes", "coll",
                            "compute_s", "memory_s", "collective_s",
                            "bound_s"}
        g = 256 if all_axes else 16
        assert rec["coll"] == pytest.approx(paper.paper_sort_collectives(
            4096, 59, chunk, g, 2 if bf16 else 4)["total_bytes"], rel=1e-12)
        assert rec["flops"] == 4 * 4096 * (4096 // g) * 59
        assert rec["compute_s"] == rec["flops"] / hillclimb.PEAK_FLOPS
        assert rec["memory_s"] == rec["bytes"] / hillclimb.HBM_BW
        assert rec["collective_s"] == rec["coll"] / hillclimb.LINK_BW
        assert rec["bound_s"] == max(rec["compute_s"], rec["memory_s"],
                                     rec["collective_s"])

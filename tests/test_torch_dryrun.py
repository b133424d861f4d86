"""The port's dry-run (``repro_torch.launch.dryrun``) against the
reference's (``repro.launch.dryrun`` and ``repro.launch.steps``) on the
CPU: one process stands for rank 0 of 256 or 512 under torch's in-process
``fake`` process group, made once for this file and destroyed after it."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.launch import dryrun as ref_dryrun  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models.config import cell_by_name as ref_cell  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import reduced_config  # noqa: E402
from repro_torch.models.config import cell_by_name  # noqa: E402


class FakeMesh:
    def __init__(self, multi):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


@pytest.fixture(scope="module")
def group():
    dryrun.init_fake_group(512)
    meshes = {"single": make_production_mesh(),
              "multi": make_production_mesh(multi_pod=True)}
    yield meshes
    dryrun.destroy_group()


# ---------------------------------------------------- per-device bytes

def _ref_bytes(cfg, cell, mesh):
    """Per-device bytes of the reference's arguments from its sanitized
    specs: each leaf's bytes over the product of its spec's axes."""
    _, args, in_sh, _, _ = ref_steps.build_cell(cfg, cell, mesh)
    total = 0
    for arg, sh in zip(args, in_sh):
        leaves = jax.tree.leaves(arg)
        shards = jax.tree.leaves(sh)
        if len(shards) == 1 and len(leaves) > 1:
            shards = shards * len(leaves)
        assert len(shards) == len(leaves)
        for a, s in zip(leaves, shards):
            spec = ref_steps._sanitize_spec(mesh, s.spec, a.shape)
            axes = tuple(ax for e in spec if e is not None
                         for ax in ((e,) if isinstance(e, str) else e))
            total += (int(np.prod(a.shape)) * a.dtype.itemsize
                      // ref_steps._axis_size(mesh, axes))
    return total


@pytest.fixture()
def ref_named(monkeypatch):
    """The reference's builders only read a mesh's ``shape`` and
    ``axis_names``; its ``NamedSharding`` is swapped for a record of the
    spec, so that they run on a FakeMesh."""
    class Named:
        def __init__(self, mesh, spec):
            self.mesh, self.spec = mesh, spec
    monkeypatch.setattr(ref_steps, "NamedSharding", Named)
    return Named


@pytest.mark.parametrize("arch,shape,mesh_name", [
    ("qwen1.5-0.5b", "train_4k", "single"),
    ("qwen1.5-0.5b", "decode_32k", "multi"),
    ("qwen1.5-0.5b", "prefill_32k", "multi"),
    ("jamba-v0.1-52b", "long_500k", "single"),
    ("llama-3.2-vision-90b", "decode_32k", "single"),
    ("llama3-405b", "train_4k", "multi"),
])
def test_argument_bytes_equal_the_references(group, ref_named, arch, shape,
                                             mesh_name):
    """Per-device argument bytes of the placed ``meta`` arguments equal
    those of the reference's sanitized specs on a FakeMesh (its builders
    need no devices), bf16 moments included (llama3-405b)."""
    got = steps.lower_cell(get_config(arch), cell_by_name(shape),
                           group[mesh_name]).argument_bytes()
    want = _ref_bytes(ref_config(arch), ref_cell(shape),
                      FakeMesh(mesh_name == "multi"))
    assert got == want


# ------------------------------------------------------------ the costs

def test_a_linear_costs_what_hand_arithmetic_gives(group):
    """x (16384, 1024) bf16, rows over data, @ w (1024, 4096) bf16, FSDP
    over data and TP over model, on the (16, 16) mesh: rank 0 gathers its
    w column block over data (1024 x 256 x 2 B, 15/16 of it on the wire),
    the cheaper move than x's, and multiplies (1024 x 1024) by
    (1024 x 256)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = group["single"]

    def dt(shape, local, pl):
        return DTensor.from_local(torch.empty(local, dtype=torch.bfloat16,
                                              device="meta"), mesh, pl,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    x = dt((16384, 1024), (1024, 1024), [Shard(0), Replicate()])
    w = dt((1024, 4096), (64, 256), [Shard(0), Shard(1)])
    with dryrun.CostMode() as mode:
        y = x @ w
    assert y.to_local().shape == (1024, 256)
    assert mode.flops == 2 * 1024 * 1024 * 256
    stats = dryrun.collective_stats(mode.collectives)
    assert stats["all-gather"]["count"] == 1
    assert stats["total_bytes"] == 1024 * 256 * 2 * 15 / 16
    # the product reads x's and the gathered w's bytes and writes y's
    assert mode.bytes_accessed >= (1024 * 1024 + 1024 * 256
                                   + 1024 * 256) * 2


@pytest.mark.parametrize("remat", [False, True])
def test_a_train_steps_flops_are_what_hand_arithmetic_gives(group, remat):
    """Qwen1.5-0.5B at two layers, 16 sequences of 512 tokens, on the
    (16, 16) mesh: rank 0 holds one sequence (N = 512 tokens) and 1/16 of
    every projection's width and of the heads.  Each product costs
    2 N d_in d_out / 16 forward and twice that backward (dx and dw); the
    flash forward 4 T^2 Dh per local head and its backward, the chunked
    oracle, 12 T^2 Dh (the two products recomputed, four more for their
    gradients).  With remat a unit's forward runs again in the backward
    up to its last saved input: all but the MLP's down projection.  The
    count holds whatever torch version DTensor comes from, since the
    gradients are pinned at each constraint."""
    import dataclasses

    from repro_torch.models.config import ShapeCell
    layers, tp, n, seq = 2, 16, 512, 512
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), num_layers=layers,
                              remat=remat)
    d, ff, dh = cfg.d_model, cfg.d_ff, cfg.resolved_head_dim
    qkvo = d * dh * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    attn = 4 * (cfg.num_heads // tp) * seq * seq * dh
    per_layer = 6 * n * (qkvo + 3 * d * ff) // tp + 4 * attn
    if remat:
        per_layer += 2 * n * (qkvo + 2 * d * ff) // tp + attn
    want = layers * per_layer + 6 * n * d * cfg.padded_vocab // tp
    cell = ShapeCell("train_small", seq, 16, "train")
    got = steps.lower_cell(cfg, cell, group["single"]).cost()["flops"]
    assert got == want


_DT = {torch.bfloat16: "bf16", torch.float32: "f32", torch.int32: "s32"}


@pytest.mark.parametrize("kind,dtype,shape,group_size", [
    ("all-gather", torch.bfloat16, (16, 1024), 4),
    ("all-reduce", torch.float32, (256,), 2),
    ("reduce-scatter", torch.float32, (64,), 4),
    ("all-to-all", torch.bfloat16, (8, 32, 64), 16),
    ("collective-permute", torch.int32, (8,), 2),
    ("all-reduce", torch.float32, (3, 5), 1),
])
def test_collective_stats_equal_the_references_parser(kind, dtype, shape,
                                                      group_size):
    """The wire model of one collective, from its result's bytes and group
    size, equals the reference's parse of the HLO line of the same kind,
    type, shape and group."""
    nbytes = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
    got = dryrun.collective_stats([{"kind": kind, "bytes": nbytes,
                                    "group": group_size}])
    groups = "{{" + ",".join(map(str, range(group_size))) + "}}"
    line = (f"  %c = {_DT[dtype]}[{','.join(map(str, shape))}]{{0}} "
            f"{kind}(%p), replica_groups={groups}")
    want = ref_dryrun.collective_stats(line)
    assert got == want


def test_probe_extrapolation_equals_the_direct_count(group):
    """The reference's probe correction (1 and 2 repeats of the unit,
    extrapolated) gives the direct per-layer count: the port loops over
    its layers, so nothing is counted once per scan body."""
    cfg = reduced_config(get_config("jamba-v0.1-52b"), num_layers=24)
    cell = cell_by_name("decode_32k")
    mesh = group["single"]
    direct = dryrun._cell_costs(cfg, cell, mesh)
    probed = dryrun.probe_corrected_costs(cfg, cell, mesh)
    assert probed["repeats"] == 3
    for key in ("flops", "bytes_accessed", "collective_bytes"):
        assert probed[key] == pytest.approx(direct[key], rel=1e-12)


def test_cli_writes_the_references_record_keys(group, tmp_path, capsys):
    """``main`` on qwen1.5-0.5b: prefill_32k ok with the reference's keys,
    long_500k skipped with its reason (a pure full-attention arch); the
    group it makes is its own (the fixture's is set aside meanwhile)."""
    dryrun.destroy_group()
    try:
        out = tmp_path / "records.json"
        rc = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "prefill_32k",
                          "--out", str(out)])
        rc2 = dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k",
                           "--mesh", "multi", "--out",
                           str(tmp_path / "long.json")])
    finally:
        dryrun.init_fake_group(512)
        group["single"] = make_production_mesh()
        group["multi"] = make_production_mesh(multi_pod=True)
    assert rc == 0 and rc2 == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "ok"
    assert set(rec) >= {"arch", "shape", "mesh", "kind", "memory_analysis",
                        "cost_analysis", "collectives", "roofline_inputs"}
    assert set(rec["roofline_inputs"]) == {"flops", "bytes_accessed",
                                           "collective_bytes"}
    assert set(rec["collectives"]) == set(ref_dryrun._COLLECTIVES) | {
        "total_bytes"}
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    (skip,) = json.loads((tmp_path / "long.json").read_text())
    assert skip["status"] == "skipped"
    assert skip["reason"].startswith("pure full-attention arch")


def test_a_cell_that_fails_is_an_error_record(group, monkeypatch):
    """No fallback: a cell that raises is a ``status: error`` record and
    ``main`` returns 1."""
    def boom(*a, **k):
        raise RuntimeError("no rule")
    monkeypatch.setattr(steps, "lower_cell", boom)
    dryrun.destroy_group()
    try:
        assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape",
                            "decode_32k"]) == 1
    finally:
        dryrun.init_fake_group(512)
        group["single"] = make_production_mesh()
        group["multi"] = make_production_mesh(multi_pod=True)


def test_the_mesh_never_shrinks(group):
    """A mesh larger than the group raises, naming the fake group."""
    with pytest.raises(RuntimeError, match="fake"):
        make_production_mesh(shape=(4, 16, 16))

"""The LM meshes and sharded builders of the port
(``repro_torch.launch.mesh``, ``repro_torch.launch.steps``,
``repro_torch.models``' specs) against the reference's
(``repro.launch.steps``, ``repro.models``), on the CPU.

Spec-level parity needs no devices: the reference's builders only read a
mesh's ``shape`` and ``axis_names``.  The steps themselves run on real
meshes: a (1, 1) mesh over a one-rank ``gloo`` group in this process
(bitwise the unsharded path), and a (2, 2) mesh over four ``gloo`` ranks
in subprocesses (within the f32 tolerances of ``test_torch_train``)."""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.config import cell_by_name as ref_cell  # noqa: E402
from repro.models.layers import AxisRules as RefRules  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import reduced_config  # noqa: E402
from repro_torch.models.config import ShapeCell, cell_by_name  # noqa: E402
from repro_torch.models.layers import AxisRules, P  # noqa: E402
from repro_torch.models.model import LM, param_specs  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class FakeMesh:
    def __init__(self, multi=False):
        self.shape = ({"pod": 2, "data": 16, "model": 16} if multi
                      else {"data": 16, "model": 16})
        self.axis_names = tuple(self.shape)


def _t(spec):
    return tuple(spec) if spec is not None else None


# ------------------------------------------------------- spec sanitizer

@pytest.mark.parametrize("spec,shape", [
    (("model", "data"), (40, 1536)),
    (("model", None), (512, 7)),
    ((("data", "model"), None), (512, 7)),
    ((("data", "model"), None), (128, 7)),
])
def test_sanitize_spec_reference_cases(spec, shape):
    m = FakeMesh()
    got = steps._sanitize_spec(m, P(*spec), shape)
    assert tuple(got) == tuple(ref_steps._sanitize_spec(m, JP(*spec), shape))


_ENTRY = st.sampled_from([None, "data", "model", "pod", ("data", "model"),
                          ("pod", "data"), ("pod", "data", "model")])


@settings(max_examples=60, deadline=None)
@given(entries=st.lists(_ENTRY, min_size=0, max_size=4),
       shape=st.lists(st.sampled_from([1, 2, 7, 16, 32, 40, 256, 512, 1536]),
                      min_size=0, max_size=4))
def test_sanitize_spec_sweep_equals_reference(entries, shape):
    m = FakeMesh(multi=True)
    got = steps._sanitize_spec(m, P(*entries), tuple(shape))
    want = ref_steps._sanitize_spec(m, JP(*entries), tuple(shape))
    assert tuple(got) == tuple(want)


# ---------------------------------------------------------- spec trees

def _ref_by_name(cfg, tree, strip):
    """The reference's stacked tree by the port's parameter names (layer
    ``r * len(unit) + i`` is unit position ``i`` of repeat ``r``); a
    stacked leaf becomes ``strip(leaf)`` of each layer."""
    unit_len = len(cfg.block_program()[0])
    out = {}

    def walk(t, pre, fn):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.", fn)
            else:
                fn(f"{pre}{k}", v)

    walk({k: v for k, v in tree.items() if k not in ("blocks", "encoder")},
         "", lambda k, v: out.__setitem__(k, v))
    for key, n, ul in (("blocks", cfg.num_layers, unit_len),
                       ("encoder", cfg.encoder_layers, 1)):
        for layer in range(n if key in tree else 0):
            walk(tree[key][layer % ul], f"{key}.{layer}.",
                 lambda k, v: out.__setitem__(k, strip(v)))
    return out


def _ref_specs(cfg, rules):
    return _ref_by_name(cfg, ref_steps._param_specs(cfg, rules),
                        lambda s: JP(*tuple(s)[1:]))


_RULES = [(RefRules(), AxisRules()),
          (RefRules(dp=("pod", "data")), AxisRules(dp=("pod", "data")))]


@pytest.mark.parametrize("arch", [*list_archs(), "qwen1.5-0.5b@full"])
def test_param_specs_equal_the_references(arch):
    """Every parameter's spec is the one the reference's ``init_model``
    returns beside its array (its stacked leaves without the repeats
    axis), at ``reduced_config`` and, for qwen1.5-0.5b, at full size."""
    name, _, full = arch.partition("@")
    rcfg, tcfg = ref_config(name), get_config(name)
    if not full:
        rcfg, tcfg = ref_model.reduced_config(rcfg), reduced_config(tcfg)
    model = LM(tcfg, None, torch.device("meta"))
    for rrules, trules in _RULES:
        want = {k: _t(v) for k, v in _ref_specs(rcfg, rrules).items()}
        got = {k: _t(v) for k, v in param_specs(model, trules).items()}
        assert got == want


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "llama3-405b",
                                  "jamba-v0.1-52b", "whisper-small"])
def test_model_state_specs_equal_the_references(arch):
    """Shapes, dtypes and specs of {params, opt} at full size equal the
    reference's ``eval_shape`` (``moment_dtype`` bfloat16 for
    llama3-405b)."""
    mesh = FakeMesh()
    rshapes, rspecs = ref_steps.model_state_specs(ref_config(arch), mesh)
    tshapes, tspecs = steps.model_state_specs(get_config(arch), mesh)
    cfg = ref_config(arch)

    def top(leaf):
        return (tuple(leaf.shape), np.dtype(leaf.dtype).name)

    def torch_leaf(t):
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    for part in ("params",):
        want = _ref_by_name(cfg, jax.tree.map(top, rshapes[part]),
                            lambda v: (v[0][1:], v[1]))
        got = {k: torch_leaf(v) for k, v in tshapes[part].items()}
        assert got == want
    for moment in ("mu", "nu"):
        want = _ref_by_name(cfg, jax.tree.map(top, getattr(
            rshapes["opt"], moment)), lambda v: (v[0][1:], v[1]))
        got = {k: torch_leaf(v)
               for k, v in getattr(tshapes["opt"], moment).items()}
        assert got == want
    assert torch_leaf(tshapes["opt"].step) == top(rshapes["opt"].step)
    assert tuple(tspecs["opt"].step) == tuple(rspecs["opt"].step)
    assert {k: _t(v) for k, v in tspecs["params"].items()} == {
        k: _t(v) for k, v in _ref_by_name(
            cfg, rspecs["params"], lambda s: JP(*tuple(s)[1:])).items()}


def _cache_tuple(spec):
    """A KVCache / SSMCache of specs as a tuple of spec tuples."""
    return None if spec is None else tuple(_t(s) for s in spec)


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "mamba2-370m",
                                  "llama-3.2-vision-90b"])
@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("multi", [False, True])
def test_cache_specs_equal_the_references(arch, shape, multi):
    """``_cache_pspecs`` and ``_ctx_kv_pspecs`` of a hybrid, an SSM and a
    cross-attention arch: layer ``r * len(unit) + i`` takes the
    reference's unit position ``i`` without its repeats axis."""
    mesh = FakeMesh(multi)
    cfg = ref_config(arch)
    unit_len = len(cfg.block_program()[0])

    def strip(spec):
        return None if spec is None else type(spec)(
            *(JP(*tuple(s)[1:]) for s in spec))

    ref = ref_steps._cache_pspecs(cfg, ref_cell(shape), mesh)
    got = steps._cache_pspecs(get_config(arch), cell_by_name(shape), mesh)
    assert len(got) == cfg.num_layers
    for layer, spec in enumerate(got):
        assert type(spec).__name__ == type(ref[layer % unit_len]).__name__
        assert _cache_tuple(spec) == _cache_tuple(strip(ref[layer
                                                            % unit_len]))
    rctx = ref_steps._ctx_kv_pspecs(cfg, ref_cell(shape), mesh)
    tctx = steps._ctx_kv_pspecs(get_config(arch), cell_by_name(shape), mesh)
    if rctx is None:
        assert tctx is None
    else:
        assert [_cache_tuple(s) for s in tctx] == [
            _cache_tuple(strip(rctx[i % unit_len]))
            for i in range(cfg.num_layers)]


# -------------------------------------------- placements against JAX's

_INDEX_MAP = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as JP
    import torch
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset as local_block)
    from repro_torch.models.layers import P, placements

    class Mesh:
        shape = (2, 4)
        mesh_dim_names = ("data", "model")

    mesh = jax.make_mesh((2, 4), ("data", "model"))
    shape = (8, 16)
    out = []
    for spec in [("data", None), (None, "model"), ("model", "data"),
                 (("data", "model"), None), (None, ("data", "model")),
                 ("data", "model")]:
        want = NamedSharding(mesh, JP(*spec)).devices_indices_map(shape)
        pl = placements(Mesh(), P(*spec))
        ok = True
        for dev, idx in want.items():
            coord = [int(c) for c in np.argwhere(mesh.devices == dev)[0]]
            size, off = local_block(shape, (2, 4), coord, pl)
            got = tuple(slice(o, o + s) for o, s in zip(off, size))
            full = tuple(slice(0 if i.start is None else i.start,
                               n if i.stop is None else i.stop)
                         for i, n in zip(idx, shape))
            ok = ok and got == full
        out.append([list(map(str, spec)), ok])
    print(json.dumps(out))
""")


def test_placements_index_each_rank_as_jax_does():
    """On a (2, 4) ("data", "model") mesh, each rank's block under the
    port's placements of a spec (DTensor's own block arithmetic) is the
    block ``NamedSharding.devices_indices_map`` gives its device, tuple
    axes included (JAX forced to 8 CPU devices in a subprocess)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _INDEX_MAP], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    rows = json.loads(res.stdout.strip().splitlines()[-1])
    assert len(rows) == 6
    assert all(ok for _, ok in rows), rows


def test_placements_reject_an_axis_order_jax_would_lay_out_otherwise():
    class Mesh:
        shape = (2, 4)
        mesh_dim_names = ("data", "model")
    from repro_torch.models.layers import placements
    with pytest.raises(ValueError, match="order"):
        placements(Mesh(), P(("model", "data")))


# --------------------------------------------- one rank: bitwise steps

@pytest.fixture(scope="module")
def one_rank():
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield make_production_mesh(shape=(1, 1))
    dist.destroy_process_group()


def _tiny(arch):
    """One repeat of the arch's unit at tiny widths."""
    return reduced_config(get_config(arch), num_layers=len(
        get_config(arch).block_program()[0]))


def _local(t):
    return t.to_local() if hasattr(t, "to_local") else t


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "whisper-small"])
def test_one_rank_train_builder_is_bitwise_the_train_step(one_rank, arch):
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.steps import make_train_step, model_params
    from repro_torch.models import init_model
    from repro_torch.optim import adam_init
    from repro_torch.tree import flatten
    cfg = reduced_config(get_config(arch))
    cell = ShapeCell("train_tiny", 16, 2, "train")
    params = model_params(init_model(cfg, "cpu", seed=0))
    state = {"params": params, "opt": adam_init(params)}
    batch = synthetic_batch(cfg, 2, 16, 0, device="cpu")
    want_state, want_m = make_train_step(cfg)(state, batch)
    low = steps.lower_cell(cfg, cell, one_rank)
    got_state, got_m = low(state, batch)
    for k in want_m:
        assert torch.equal(_local(got_m[k]), want_m[k]), k
    gl, gs = flatten(got_state)
    wl, ws = flatten(want_state)
    assert gs == ws
    for g, w in zip(gl, wl):
        assert torch.equal(_local(g), w)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "jamba-v0.1-52b",
                                  "llama-3.2-vision-90b"])
def test_one_rank_serve_builders_are_bitwise_prefill_and_decode(one_rank,
                                                                arch):
    from repro_torch.data.synthetic import synthetic_batch
    from repro_torch.launch.steps import model_params
    from repro_torch.models import init_model
    from repro_torch.models import model as model_lib
    cfg = _tiny(arch)
    b, s = 2, 12
    model = init_model(cfg, "cpu", seed=0)
    params = model_params(model)
    batch = synthetic_batch(cfg, b, s, 0, device="cpu")
    tokens, ctx = batch["tokens"], batch.get("context")
    with torch.no_grad():
        want_logits, want_caches = model_lib.prefill(model, tokens, ctx)
    pre = steps.lower_cell(cfg, ShapeCell("prefill_tiny", s, b, "prefill"),
                           one_rank)
    got_logits, got_caches = pre(params, tokens, *(
        [ctx] if ctx is not None else []))
    assert torch.equal(_local(got_logits), want_logits)
    for g, w in zip(got_caches, want_caches):
        for gt, wt in zip(g, w):
            assert torch.equal(_local(gt), wt)

    # one decode step at position s over caches of length s + 4
    caches = model_lib.make_caches(cfg, b, s + 4, torch.float32, "cpu")
    for c, w in zip(caches, want_caches):
        if hasattr(c, "k"):
            c.k[:, :s], c.v[:, :s] = w.k, w.v
    token = tokens[:, -1:]
    with torch.no_grad():
        ctx_kvs = model_lib.precompute_ctx_kvs(model, ctx)
        mine = [type(c)(*(t.clone() for t in c)) for c in caches]
        want_logits, want_new = model_lib.decode_step(
            model, token, mine, s, ctx_kvs=ctx_kvs)
    dec = steps.lower_cell(cfg, ShapeCell("decode_tiny", s + 4, b, "decode"),
                           one_rank)
    args = [params, token, caches, torch.tensor(s, dtype=torch.int32)]
    if ctx_kvs is not None:
        args.append(ctx_kvs)
    got_logits, got_new = dec(*args)
    assert torch.equal(_local(got_logits), want_logits)
    for g, w in zip(got_new, want_new):
        for gt, wt in zip(g, w):
            assert torch.equal(_local(gt), wt)


def test_restore_with_shardings_places_each_leaf(one_rank, tmp_path):
    """``restore(shardings=)`` gives each leaf as a DTensor laid out by its
    sharding, with the saved values; a supervisor restores through it."""
    from repro_torch.launch.mesh import NamedSharding
    from repro_torch.runtime.checkpoint import CheckpointManager
    state = {"w": torch.arange(12.0).reshape(3, 4),
             "b": torch.arange(4, dtype=torch.bfloat16),
             "step": torch.tensor(7, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, state)
    shardings = {"w": NamedSharding(one_rank, P("data", "model")),
                 "b": NamedSharding(one_rank, P("model")),
                 "step": NamedSharding(one_rank, P())}
    got, step = mgr.restore(state, shardings=shardings)
    assert step == 3
    for k, t in got.items():
        assert tuple(t.placements) == shardings[k].placements
        assert torch.equal(t.to_local(), state[k])
        assert t.dtype == state[k].dtype
    plain, _ = mgr.restore(state)
    assert all(type(v) is torch.Tensor for v in plain.values())


# ---------------------------------------- four ranks: a (2, 2) mesh

_RANK = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    rank, store_path, out_path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 4),
                            rank=rank, world_size=4)
    from repro_torch.configs import get_config
    from repro_torch.data import synthetic_batch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_model, reduced_config
    from repro_torch.models.config import ShapeCell
    from repro_torch.models.layers import activation_sharding_ctx
    from repro_torch.optim import adam_init
    mesh = make_production_mesh(shape=(2, 2))
    results = {}
    for arch in sys.argv[4:]:
        cfg = reduced_config(get_config(arch))
        params = steps.model_params(init_model(cfg, "cpu", seed=0))
        state = {"params": params, "opt": adam_init(params)}
        batch = synthetic_batch(cfg, 4, 16, 0, device="cpu")
        low = steps.lower_cell(cfg, ShapeCell("train_tiny", 16, 4, "train"),
                               mesh)
        placed = low.place((state, batch))
        new, metrics = low.run(placed)
        with activation_sharding_ctx(**low.ctx):
            (loss, _), grads = steps.value_and_grad(cfg)(
                placed[0]["params"], placed[1])
        full = {k: v.full_tensor() for k, v in grads.items()}
        new_full = {k: v.full_tensor() for k, v in new["params"].items()}
        sharded = sum(1 for v in placed[0]["params"].values()
                      if any(p.is_shard() for p in v.placements))
        step_loss = float(metrics["loss"].full_tensor())
        grad_loss = float(loss.full_tensor())
        if rank == 0:
            want_state, want_m = steps.make_train_step(cfg)(state, batch)
            (wloss, _), wgrads = steps.value_and_grad(cfg)(params, batch)
            worst = max(float((full[k] - g).abs().max())
                        / (1e-5 * float(g.abs().max()) + 1e-7)
                        for k, g in wgrads.items())
            pmax = max(float((new_full[k] - w).abs().max())
                       for k, w in want_state["params"].items())
            results[arch] = {
                "loss": step_loss, "want_loss": float(want_m["loss"]),
                "grad_loss": grad_loss, "want_grad_loss": float(wloss),
                "worst_grad_over_bound": worst, "param_max_abs": pmax,
                "sharded_params": sharded, "params": len(params)}
    # decode over a cache split along its sequence: over "model" (batch
    # 4 over "data"), and over ("data", "model") at batch 1
    from repro_torch.models import model as model_lib
    cfg = reduced_config(get_config("qwen1.5-0.5b"))
    model = init_model(cfg, "cpu", seed=0)
    params = steps.model_params(model)
    s, pos = 16, 13
    for b in (4, 1):
        g = torch.Generator().manual_seed(3)
        caches = model_lib.make_caches(cfg, b, s, torch.float32, "cpu")
        for c in caches:
            for t in c:
                t.normal_(generator=g)
        token = torch.randint(0, cfg.vocab_size, (b, 1), generator=g)
        mine = [type(c)(*(t.clone() for t in c)) for c in caches]
        with torch.no_grad():
            want, want_caches = model_lib.decode_step(model, token, mine,
                                                      pos)
        low = steps.lower_cell(cfg, ShapeCell("decode_tiny", s, b,
                                              "decode"), mesh)
        seq_split = [repr(p) for p in low.in_shardings[2][0].k.placements]
        got, got_caches = low(params, token, caches,
                              torch.tensor(pos, dtype=torch.int32))
        got = got.full_tensor()
        keep = torch.ones(s, dtype=torch.bool)
        keep[pos] = False
        full = [(gc.k.full_tensor(), gc.v.full_tensor(), wc.k, wc.v)
                for gc, wc in zip(got_caches, want_caches)]
        untouched = all(torch.equal(gk[:, keep], wk[:, keep])
                        and torch.equal(gv[:, keep], wv[:, keep])
                        for gk, gv, wk, wv in full)
        written = max(float((g[:, pos] - w[:, pos]).abs().max()
                            / w[:, pos].abs().max())
                      for gk, gv, wk, wv in full
                      for g, w in ((gk, wk), (gv, wv)))
        if rank == 0:
            results[f"decode_b{b}"] = {
                "err_over_max": float((got - want).abs().max()
                                      / want.abs().max()),
                "untouched_equal": untouched, "written_err": written,
                "cache_placements": seq_split}
    if rank == 0:
        json.dump(results, open(out_path, "w"))
    dist.barrier()
    dist.destroy_process_group()
""")

_FOUR_RANK_ARCHS = ["qwen1.5-0.5b", "granite-moe-3b-a800m"]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Both archs' results from one run of four gloo ranks."""
    tmp = tmp_path_factory.mktemp("four_ranks")
    script = tmp / "rank.py"
    script.write_text(_RANK)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    out = tmp / "out.json"
    procs = [subprocess.Popen([sys.executable, str(script), str(r),
                               str(tmp / "store"), str(out),
                               *_FOUR_RANK_ARCHS],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
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
        "\n".join(ln for ln in e.splitlines() if "Error" in ln)[-1500:]
        for e in errs)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", _FOUR_RANK_ARCHS)
def test_four_rank_sharded_train_step_holds_to_the_unsharded(four_ranks,
                                                             arch):
    """A tiny arch's train step over a (2, 2) ("data", "model") mesh of
    four gloo ranks: the loss within 1e-6 relative of the unsharded
    step's, every gradient within 1e-5 x max |g| + 1e-7 (the train
    tests' bound), and the parameters after one Adam step within 2 x lr
    (one step's reach, as the train tests hold them)."""
    res = four_ranks[arch]
    assert res["sharded_params"] > res["params"] // 2
    assert res["loss"] == pytest.approx(res["want_loss"], rel=1e-6)
    assert res["grad_loss"] == pytest.approx(res["want_grad_loss"], rel=1e-6)
    assert res["worst_grad_over_bound"] <= 1.0
    assert res["param_max_abs"] <= 2 * 3e-4


@pytest.mark.parametrize("batch,split", [(4, ["Shard(dim=0)", "Shard(dim=1)"]),
                                         (1, ["Shard(dim=1)", "Shard(dim=1)"])])
def test_four_rank_decode_over_a_sequence_split_cache(four_ranks, batch,
                                                      split):
    """A decode step over a KV cache split along its sequence on four
    gloo ranks (over "model" at batch 4, over ("data", "model") at batch
    1, as decode_32k and long_500k lay it out): each rank attends over its
    key range and the partials merge to the unsharded step's logits
    within 1e-5 of their largest; the new K/V land at ``pos`` within 1e-5
    of their largest (their projections are column blocks of the
    unsharded product), every other position untouched."""
    res = four_ranks[f"decode_b{batch}"]
    assert res["cache_placements"] == split
    assert res["err_over_max"] <= 1e-5
    assert res["written_err"] <= 1e-5
    assert res["untouched_equal"]

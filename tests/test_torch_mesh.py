"""Instance sharding over a device mesh in the port
(``repro_torch.launch.mesh``, the ``mesh=`` of every engine of
``repro_torch.core.shufflesoftsort``), on the CPU, against the unsharded
port and the JAX reference's vmap engine.

A mesh here is ``make_sort_mesh(devices=["cpu"] * k)``: k slots of the
host, the port's counterpart of the reference's
``--xla_force_host_platform_device_count``.  Meshes of 1, 3 and 8 slots
split batches evenly, unevenly (the tail slot padded with copies of
instance 0) and with more slots than instances.

* ``make_sort_mesh``: the reference's error cases; the ``devices=`` list
  (one device in several slots, ids kept across a rebuild).
* Sharded against unsharded, bitwise, on the plain tier (the CPU twins'
  batched backward is not batch-invariant, ROADMAP.md Queue C6): orders,
  losses and winners of the fixed engine (dense, banded, across the band
  switch), the adaptive engine with forced firing, the tournament (fixed
  and adaptive) and ``run_round_segment``; every stream advances once per
  round it runs, padding or not.
* Against the reference's vmap run (``mesh=None``, which the reference's
  contract says every mesh gives): each instance's JAX key chain replayed,
  ``lambda_sigma=0`` (Queue C1); orders equal, per-round losses within
  rtol 1e-5.
* Counts: ``rounds_run`` and the adaptive engine's ``device_rounds``
  include the padding, by the reference's formulas.
* Each problem's winner is the host argmin of its final losses on any
  mesh; a checkpoint records the mesh's shape.
"""
import dataclasses
import functools
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core.losses import mean_pairwise_distance as jmpd  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ReplayShuffleSource,
    TorchShuffleSource,
)
from repro_torch.core.reference import config_from_reference  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    MeshSlot,
    SortMesh,
    make_sort_mesh,
)

N, HW, D = 16, (4, 4), 3
LOSS_RTOL = 1e-5
MESHES = (1, 3, 8)
# Always-plateau controller: every boundary past the first fires a jump.
FIRE = dict(schedule="adaptive", patience=1, plateau_rtol=1.0,
            adapt_every=2)
CONFIGS = {
    "dense": dict(rounds=6),
    "banded": dict(rounds=6, band=4, band_eps=1e3),
    # (16 - 4) exp(-2 / tau_r) <= 0.05 from round 3 of 6 on.
    "switch": dict(rounds=6, band=4, band_eps=0.05),
    "adaptive": dict(rounds=8, **FIRE),
}


def _mesh(k):
    return make_sort_mesh(devices=["cpu"] * k)


def _cfg(kind, **kw):
    return teng.ShuffleSoftSortConfig(inner_steps=2, chunk=N,
                                      **{**CONFIGS[kind], **kw})


def _xs(seed, b, n=N):
    return np.random.default_rng(seed).normal(size=(b, n, D)).astype(
        np.float32)


def _same(got, want, fields):
    for f in fields:
        a, b = getattr(got, f), getattr(want, f)
        if a is None or b is None:
            assert a is None and b is None, f
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


BATCHED = ("order", "sorted", "losses", "best_restart", "all_orders",
           "all_losses", "rounds_executed")
TOURNAMENT = ("order", "sorted", "final_loss", "best_restart",
              "all_losses", "rounds_run", "rounds_full")


# ------------------------------------------------------------ the mesh

def test_make_sort_mesh_rejects_what_the_reference_rejects(monkeypatch):
    for n in (0, -3):
        with pytest.raises(RuntimeError, match="n_devices must be >= 1"):
            jmesh.make_sort_mesh(n)
        with pytest.raises(RuntimeError, match="n_devices must be >= 1"):
            make_sort_mesh(n, devices=["cpu"])
    too_many = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match="have"):
        jmesh.make_sort_mesh(too_many)
    with pytest.raises(RuntimeError, match="have 2"):
        make_sort_mesh(3, devices=["cpu"] * 2)
    # devices=None: the visible cards, none on a host without one.
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="n_devices must be >= 1"):
        make_sort_mesh()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_sort_mesh()
    assert [sl.device for sl in mesh.slots] == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    assert mesh.ids == (0, 1) and make_sort_mesh(1).shape == {"data": 1}
    with pytest.raises(RuntimeError, match="have 2"):
        make_sort_mesh(3)


def test_make_sort_mesh_devices_list():
    """One device may fill several slots; ids are list positions, a
    ``MeshSlot`` keeps its own (the survivors of an eviction)."""
    mesh = make_sort_mesh(devices=["cpu"] * 8)
    assert isinstance(mesh, SortMesh) and len(mesh) == 8
    assert mesh.shape == {"data": 8} and mesh.axis_names == ("data",)
    assert mesh.ids == tuple(range(8))
    assert {sl.device for sl in mesh.slots} == {torch.device("cpu")}
    assert make_sort_mesh(3, devices=["cpu"] * 8).ids == (0, 1, 2)
    survivors = [s for s in mesh.slots if s.id not in (3, 5)]
    rebuilt = make_sort_mesh(len(survivors), devices=survivors)
    assert rebuilt.ids == (0, 1, 2, 4, 6, 7)
    assert make_sort_mesh(devices=survivors).ids == rebuilt.ids
    assert mesh.without([5, 3]).ids == rebuilt.ids
    assert mesh.without([]).ids == mesh.ids
    assert mesh.without(range(8)) is None
    # The reference's devices= cases.
    devs = jax.devices()
    assert jmesh.make_sort_mesh(1, devices=devs[:1]).shape["data"] == 1
    assert jmesh.make_sort_mesh(devices=devs[:1]).shape["data"] == 1
    assert make_sort_mesh(devices=["cpu"]).shape["data"] == 1
    with pytest.raises(ValueError, match="distinct ids"):
        SortMesh([MeshSlot(0, torch.device("cpu"))] * 2)
    with pytest.raises(ValueError, match="'cpu' or 'cuda'"):
        make_sort_mesh(devices=["meta"])


# --------------------------------------- sharded == unsharded, bitwise

@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("kind", ["dense", "banded", "switch", "adaptive"])
@pytest.mark.parametrize("b,s", [(3, 3), (1, 5)])
def test_sharded_batched_is_bitwise_unsharded(kind, k, b, s):
    """B x S = 9 (even on 3 slots, padded to 16 on 8) and 5 (padded to
    6 on 3, to 8 on 8): every field of the result bitwise ``mesh=None``'s,
    the winner included."""
    cfg = _cfg(kind)
    if kind == "switch":
        assert teng._band_switch_round(cfg, N) == 3
    run = functools.partial(teng.shuffle_soft_sort_batched, _xs(1, b), HW,
                            cfg, n_restarts=s, seed=7)
    _same(run(mesh=_mesh(k)), run(device="cpu"), BATCHED)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("kind", ["dense", "switch", "adaptive"])
def test_sharded_tournament_is_bitwise_unsharded(kind, k):
    """2 problems x 4 restarts, 3 rungs, cull 0.5: each
    rung's live set (8, 4, 2 rows) split anew; survivors, winners and loss
    traces bitwise; ``rounds_run`` counts the padding."""
    cfg = _cfg(kind)
    run = functools.partial(teng.restart_tournament, _xs(2, 2), HW, cfg,
                            n_restarts=4, seed=5, cull_fraction=0.5,
                            n_rungs=3)
    got, want = run(mesh=_mesh(k)), run(device="cpu")
    _same(got, want, TOURNAMENT[:-2])
    for a, b_ in zip(got.survivors, want.survivors):
        np.testing.assert_array_equal(a, b_)
    assert got.rounds_full == want.rounds_full
    if kind == "adaptive":
        want_run = _adaptive_device_rounds(want.all_losses, cfg, k)
    else:
        edges = teng._rung_boundaries(cfg.rounds, 3)
        want_run = sum(
            (end - start) * -(-sv.size // k) * k
            for start, end, sv in zip([0] + edges[:-1], edges,
                                      [np.zeros((2, 4))] + list(
                                          want.survivors[:-1])))
    assert got.rounds_run == want_run
    if k == 1:
        assert got.rounds_run == want.rounds_run


def _adaptive_device_rounds(all_losses, cfg, k):
    """The reference's count (``_run_adaptive``, ref :943) for one dense
    group per rung: each rung's live instances rounded up to the mesh."""
    seg = cfg.adapt_every
    live = np.isfinite(all_losses.reshape(-1, cfg.rounds))[:, ::seg].sum(
        axis=0)
    return int(sum(seg * -(-int(c) // k) * k for c in live if c))


@pytest.mark.parametrize("k", MESHES)
def test_adaptive_device_rounds_count_the_padding(k):
    """``_run_adaptive``'s instance-rounds with a dense and a banded group
    in one rung (``band=4``, ``band_eps=0.05``: the instances switch on
    their measured tail bounds at different rungs, groups of 2 and 3),
    each group sharded and padded on its own."""
    cfg = _cfg("adaptive", band=4, band_eps=0.05)
    xs = torch.as_tensor(_xs(3, 5))
    out = []
    for mesh in (None, _mesh(k)):
        ctrl = teng.make_adaptive_controller(cfg, 5, N)
        source = TorchShuffleSource(list(range(5)), N, "cpu")
        groups = []
        orig = teng._run_rounds_ragged

        def spy(xs_g, *a, **kw):
            if "mesh" in kw:            # the engine's calls, not a slot's
                groups.append((xs_g.shape[0],
                               kw["apply_fn"].keywords.get("band")))
            return orig(xs_g, *a, **kw)

        teng._run_rounds_ragged = spy
        try:
            res = teng._run_adaptive(
                xs, torch.arange(N).repeat(5, 1), source,
                torch.ones(5), hw=HW, cfg=cfg, controller=ctrl, mesh=mesh)
        finally:
            teng._run_rounds_ragged = orig
        out.append((res, groups, ctrl.seg_len))
    (o0, l0, d0), groups, seg = out[0]
    (o1, l1, d1), groups1, _ = out[1]
    assert torch.equal(o0, o1)
    np.testing.assert_array_equal(l0, l1)
    assert groups == groups1 == [(5, None), (2, None), (3, 4), (5, 4)]
    assert d0 == seg * sum(g for g, _ in groups)
    assert d1 == seg * sum(-(-g // k) * k for g, _ in groups)


@pytest.mark.parametrize("k", MESHES)
@pytest.mark.parametrize("with_w", [False, True])
def test_sharded_segment_is_bitwise_unsharded(k, with_w):
    """``run_round_segment`` on 5 instances at mixed rounds, the source's
    rows out of order: orders, losses and keys bitwise, and every stream
    (padding included) left where the unsharded segment leaves it."""
    cfg = _cfg("dense", rounds=8)
    xs = _xs(4, 5)
    rng = np.random.default_rng(6)
    orders = np.stack([rng.permutation(N) for _ in range(5)])
    progress = np.array([0, 2, 2, 4, 6])
    rows = np.array([4, 0, 6, 2, 5])
    seeds = list(range(10, 17))
    outs, states = [], []
    for mesh in (None, _mesh(k)):
        src = TorchShuffleSource(seeds, N, "cpu")
        outs.append(teng.run_round_segment(
            xs, orders, np.ones(5, np.float32), progress, 2, source=src,
            rows=rows, hw=HW, cfg=cfg, device="cpu", mesh=mesh,
            with_w=with_w))
        states.append(src.state_dict())
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(states[0], states[1])
    untouched = TorchShuffleSource(seeds, N, "cpu").state_dict()
    np.testing.assert_array_equal(states[0][[1, 3]], untouched[[1, 3]])


@pytest.mark.parametrize("k", [1, 3])
def test_sharded_kernel_tier_holds_the_envelope(k):
    """The kernel tier on the CPU runs the twins, whose batched backward
    is not bitwise batch-invariant (Queue C6): a sharded run gives valid
    permutations and losses within the 2e-2 envelope of ``mesh=None``."""
    cfg = _cfg("dense", use_kernel=True)
    run = functools.partial(teng.shuffle_soft_sort_batched, _xs(8, 3), HW,
                            cfg, n_restarts=3, seed=2)
    got, want = run(mesh=_mesh(k)), run(device="cpu")
    for row in got.all_orders.reshape(-1, N):
        assert np.array_equal(np.sort(row), np.arange(N))
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=2e-2)


def test_mesh_run_rejects_a_callback():
    with pytest.raises(ValueError, match="sharded path"):
        teng.shuffle_soft_sort_batched(_xs(0, 1), HW, _cfg("dense"),
                                       mesh=_mesh(2),
                                       callback=lambda r, o, l: None)


# ------------------------------------- against the reference's vmap run

def _key_chain_shuffles(keys, rounds, n=N):
    """(R, BS, N): instance i's t-th shuffle from its own key chain."""
    out, kk = [], keys
    for _ in range(rounds):
        pair = jax.vmap(jax.random.split)(kk)
        kk, subs = pair[:, 0], pair[:, 1]
        out.append(np.stack([np.asarray(jax.random.permutation(sk, n))
                             for sk in subs]))
    return np.stack(out)


@pytest.mark.parametrize("kind", ["dense", "switch", "adaptive",
                                  "tournament"])
def test_sharded_matches_reference_vmap(kind):
    """3 problems x 3 restarts on 8 slots (padded to 16) against the
    reference's ``mesh=None`` run on the same keys: orders and winners
    equal, every per-round loss within rtol 1e-5."""
    b, s = 3, 3
    xs = _xs(9, b)
    ckind = "dense" if kind == "tournament" else kind
    jcfg = jeng.ShuffleSoftSortConfig(inner_steps=2, chunk=N,
                                      lambda_sigma=0.0, **CONFIGS[ckind])
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    keys = jax.random.split(jax.random.PRNGKey(31), b * s)
    norms = np.asarray(jax.vmap(jmpd)(jnp.asarray(xs)))
    source = ReplayShuffleSource(_key_chain_shuffles(keys, jcfg.rounds),
                                 "cpu")
    if kind == "tournament":
        kw = dict(n_restarts=s, cull_fraction=0.5, n_rungs=3)
        want = jeng.restart_tournament(jnp.asarray(xs), HW, jcfg, keys=keys,
                                       **kw)
        got = teng.restart_tournament(xs, HW, cfg, mesh=_mesh(8),
                                      source=source, norms=norms, **kw)
        for a, b_ in zip(got.survivors, want.survivors):
            np.testing.assert_array_equal(a, b_)
        np.testing.assert_array_equal(got.order, want.order)
        np.testing.assert_allclose(got.all_losses, want.all_losses,
                                   rtol=LOSS_RTOL)
        return
    want = jeng.shuffle_soft_sort_batched(jnp.asarray(xs), HW, jcfg,
                                          n_restarts=s, keys=keys)
    got = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=s,
                                         mesh=_mesh(8), source=source,
                                         norms=norms)
    np.testing.assert_array_equal(got.all_orders, want.all_orders)
    np.testing.assert_array_equal(np.isnan(got.all_losses),
                                  np.isnan(np.asarray(want.all_losses)))
    np.testing.assert_allclose(got.all_losses, want.all_losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got.best_restart, want.best_restart)
    np.testing.assert_array_equal(got.order, want.order)


# --------------------------------------------------------- the winner

@pytest.mark.parametrize("b,s", [(1, 1), (2, 3), (3, 5), (4, 2)])
@pytest.mark.parametrize("k", [1, 3, 8, 13])
def test_sharded_winner_is_the_host_argmin(b, s, k):
    """On any mesh, more slots than instances included, each problem's
    winner is the first argmin of its restarts' final losses, and the
    order and losses returned are that restart's."""
    res = teng.shuffle_soft_sort_batched(
        _xs(b * 10 + s, b), HW, _cfg("dense", rounds=3), n_restarts=s,
        seed=k, mesh=_mesh(k))
    want = np.argmin(res.all_losses[:, :, -1], axis=1)
    np.testing.assert_array_equal(res.best_restart, want)
    np.testing.assert_array_equal(res.order, res.all_orders[np.arange(b),
                                                            want])
    np.testing.assert_array_equal(res.losses, res.all_losses[np.arange(b),
                                                             want])


# ----------------------------------------------------------- checkpoints

def test_checkpoint_records_the_mesh(tmp_path):
    """The manifest's ``mesh_shape`` / ``mesh_axes`` name the mesh a rung
    was saved under (null without one), as the reference's manager
    writes them; the carry itself is layout-free."""
    cfg = _cfg("dense")
    for name, mesh in (("none", None), ("three", _mesh(3))):
        teng.shuffle_soft_sort_batched(
            _xs(0, 2), HW, cfg, n_restarts=2, mesh=mesh, device="cpu",
            checkpoint_dir=str(tmp_path / name), checkpoint_every=3)
        root = tmp_path / name
        step = sorted(os.listdir(root))[-1]
        with open(root / step / "manifest.json") as f:
            man = json.load(f)
        if mesh is None:
            assert man["mesh_shape"] is None and man["mesh_axes"] is None
        else:
            assert man["mesh_shape"] == [3] and man["mesh_axes"] == ["data"]

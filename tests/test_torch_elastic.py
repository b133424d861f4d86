"""Elastic capacity in the port: losing a mesh slot mid-anneal costs one
rung's replay and no correctness, as in the reference's
``tests/test_elastic.py``, on the CPU with meshes of ``"cpu"`` slots.

* Chaos primitives: ``FaultInjector``'s ``device_loss`` /
  ``device_return`` give the reference injector's outcomes, down sets,
  counts and state on one schedule (the reference reads only
  ``mesh.devices.flat[i].id``, so it takes a stand-in of the port's mesh).
* Re-shard identity on the plain tier: a ``mesh_hook`` that evicts any
  slot at any rung boundary, a cascading loss, and a run checkpointed on
  one mesh and resumed on another (or none) are bitwise the uninterrupted
  run, on every engine.
* The supervisor evicts the slot a ``DeviceLost`` names and resumes.
* The server: one eviction re-shards once and every request stays
  bitwise its solo run; a returned slot grows the mesh back; losing every
  slot falls back to ``mesh=None`` on the server's device (logged); an
  eviction raises the brownout ladder; a ``WarmHandoff`` carries the
  evicted set and the health monitor's strikes, in process and on disk.
* ``serving_bench``'s ``capacity`` cell on 8 CPU slots.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro_torch.core.losses import mean_pairwise_distance  # noqa: E402
from repro_torch.core.prng import TorchShuffleSource  # noqa: E402
from repro_torch.core.shufflesoftsort import (  # noqa: E402
    ShuffleSoftSortConfig,
    restart_tournament,
    run_round_segment,
    shuffle_soft_sort_batched,
)
from repro_torch.launch.mesh import make_sort_mesh  # noqa: E402
from repro_torch.launch.serve import BrownoutPolicy, SortServer  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    AnnealSupervisor,
    DeviceLost,
    FaultInjector,
    RetryPolicy,
    WorkerFailure,
)
from repro_torch.runtime.straggler import DeviceHealthMonitor  # noqa: E402

N, HW, D = 16, (4, 4), 2
CFG = ShuffleSoftSortConfig(rounds=4, inner_steps=2, chunk=16)
ACFG = ShuffleSoftSortConfig(rounds=8, inner_steps=2, chunk=16,
                             schedule="adaptive", patience=1,
                             plateau_rtol=1.0, adapt_every=2)
NO_BACKOFF = RetryPolicy(max_retries=2, backoff_base_s=0.0)


def _mesh(k):
    return make_sort_mesh(devices=["cpu"] * k)


def _problems(count, seed=0):
    return np.random.RandomState(seed).rand(count, N, D).astype(np.float32)


def _drain(server, max_ticks=200):
    for _ in range(max_ticks):
        with server._cv:
            idle = not server._pending and not server._active
        if idle:
            return
        server._tick()
    raise AssertionError("server did not go idle")


def _solo(x, seed, cfg=CFG, seg_len=1):
    """The request alone: chained ``run_round_segment`` calls from
    ``TorchShuffleSource([seed])`` at the server's norm."""
    src = TorchShuffleSource([seed], N, "cpu")
    norm = np.float32(mean_pairwise_distance(torch.as_tensor(x)))
    orders, parts = np.arange(N)[None], []
    for p0 in range(0, cfg.rounds, seg_len):
        o, ls = run_round_segment(x[None], orders, [norm], [p0], seg_len,
                                  source=src, hw=HW, cfg=cfg, device="cpu")
        orders = o.numpy()
        parts.append(ls.numpy()[:, 0])
    order = orders[0].astype(np.int32)
    return order, x[order], np.concatenate(parts)


def _assert_result(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _elastic_server(mesh, inj, **kw):
    return SortServer(HW, d=D, cfg=CFG, max_batch=8, autostart=False,
                      mesh=mesh, engine_fn=inj, device="cpu",
                      device_health=DeviceHealthMonitor(
                          lost_after=1, probe=inj.healthy),
                      retry=NO_BACKOFF, **kw)


# ----------------------------------------------- FaultInjector device chaos

def _stand_in(mesh):
    """The port's mesh as the reference's injector reads a jax Mesh."""
    flat = np.empty(len(mesh), object)
    flat[:] = [types.SimpleNamespace(id=i) for i in mesh.ids]
    return types.SimpleNamespace(devices=flat)


def test_device_chaos_matches_reference():
    """One schedule through both injectors: each dispatch's outcome (the
    result, or the lost slot's id), the down set, ``healthy``, the counts
    and ``state_dict`` equal, on meshes with and without the downed slots
    and with ``mesh=None`` (never hit)."""
    kw = dict(device_loss={1: 3, 2: 5, 6: 0}, device_return={4: 3, 8: 5},
              fail_calls={7})
    t = FaultInjector(lambda **k: "ok", **kw)
    j = jft.FaultInjector(lambda **k: "ok", **kw)
    full, part = _mesh(8), make_sort_mesh(devices=["cpu"] * 3)
    plan = [full, full, part, None, full, full, full, part, full, full]
    for i, mesh in enumerate(plan):
        outs = []
        for inj, m in ((t, mesh), (j, None if mesh is None
                                   else _stand_in(mesh))):
            try:
                outs.append(inj(mesh=m))
            except DeviceLost as e:
                outs.append(("lost", e.device_id))
            except jft.DeviceLost as e:
                outs.append(("lost", e.device_id))
            except (WorkerFailure, jft.WorkerFailure):
                outs.append("failed")
        assert outs[0] == outs[1], (i, outs)
        assert t.down == j.down
        assert [t.healthy(d) for d in range(8)] == \
            [j.healthy(d) for d in range(8)]
    assert t.device_faults == j.device_faults > 0
    assert t.state_dict() == j.state_dict()


def test_device_chaos_state_roundtrips():
    """Cursor, schedules and the down set survive a handoff: the resumed
    injector keeps raising for a still-down slot and fires the pending
    return on schedule."""
    mesh = _mesh(2)
    inj = FaultInjector(lambda **k: "ok", device_loss={0: 1},
                        device_return={2: 1})
    with pytest.raises(DeviceLost):
        inj(mesh=mesh)
    inj2 = FaultInjector(lambda **k: "ok")
    inj2.load_state_dict(inj.state_dict())
    assert inj2.down == {1} and inj2.calls == 1 and inj2.device_faults == 1
    with pytest.raises(DeviceLost):
        inj2(mesh=mesh)
    assert inj2(mesh=mesh) == "ok"
    assert inj2.healthy(1)


# ------------------------------------- rung-boundary re-shard, bitwise

def _run_engine(engine, xs, mesh, hook, **kw):
    if engine == "tournament":
        r = restart_tournament(xs, HW, CFG, n_restarts=4, seed=2,
                               cull_fraction=0.5, n_rungs=2, mesh=mesh,
                               mesh_hook=hook, device="cpu", **kw)
        return r.order, r.all_losses
    cfg = ACFG if engine == "adaptive" else CFG
    r = shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=2, seed=2,
                                  mesh=mesh, mesh_hook=hook, device="cpu",
                                  checkpoint_every=1, **kw)
    return r.all_orders, r.all_losses


def _boundaries(engine, xs):
    starts = []
    _run_engine(engine, xs, None, lambda s, m: starts.append(int(s)))
    return starts


def _evict_hook(dead_id, at_round):
    """Re-shard over the survivors when the anneal reaches ``at_round``:
    the move the server makes after a health-monitor eviction."""
    def hook(start, mesh):
        if mesh is None or start != at_round:
            return None
        survivors = mesh.without([dead_id])
        return None if len(survivors) == len(mesh) else survivors
    return hook


def _xs_for(engine):
    return _problems(2 if engine == "tournament" else 3, seed=5)


@pytest.mark.parametrize("engine", ["fixed", "adaptive", "tournament"])
def test_elastic_reshard_is_bitwise_per_slot(engine):
    """For every slot k of 8, evict it at rung boundary k mod the number
    of boundaries: bitwise the uninterrupted 8-slot run, and that bitwise
    the unsharded run."""
    xs = _xs_for(engine)
    bounds = _boundaries(engine, xs)
    assert len(bounds) >= 2
    ref = _run_engine(engine, xs, _mesh(8), None)
    plain = _run_engine(engine, xs, None, None)
    for a, b in zip(ref, plain):
        np.testing.assert_array_equal(a, b)
    for k, slot in enumerate(_mesh(8).slots):
        at = bounds[k % len(bounds)]
        got = _run_engine(engine, xs, _mesh(8), _evict_hook(slot.id, at))
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b, err_msg=f"slot {k} at {at}")


def test_elastic_reshard_survives_cascading_loss():
    """8 -> 7 -> 6 slots at two boundaries: still bitwise."""
    xs = _xs_for("fixed")
    bounds = _boundaries("fixed", xs)
    ref = _run_engine("fixed", xs, _mesh(8), None)
    h1, h2 = _evict_hook(1, bounds[1]), _evict_hook(6, bounds[-1])
    seen = []

    def cascade(start, mesh):
        new = h2(start, mesh) or h1(start, mesh)
        seen.append(len(new or mesh))
        return new

    got = _run_engine("fixed", xs, _mesh(8), cascade)
    assert seen[-1] == 6 and 7 in seen
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("engine", ["fixed", "adaptive", "tournament"])
@pytest.mark.parametrize("resume_on", [3, None])
def test_resume_on_another_mesh(engine, resume_on, tmp_path):
    """Checkpointed on 8 slots, killed at the top of the second rung,
    resumed on 3 slots or with no mesh: bitwise the uninterrupted run."""
    xs = _xs_for(engine)
    ref = _run_engine(engine, xs, _mesh(8), None)
    kill = FaultInjector(lambda s: None, fail_calls={1})
    with pytest.raises(WorkerFailure):
        _run_engine(engine, xs, _mesh(8), None, rung_hook=kill,
                    checkpoint_dir=str(tmp_path))
    got = _run_engine(engine, xs,
                      None if resume_on is None else _mesh(resume_on), None,
                      checkpoint_dir=str(tmp_path), resume=True)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_supervisor_evicts_and_resumes(tmp_path):
    """A worker failure kills attempt 0 at rung 2; attempt 1 meets slot 5
    down (``DeviceLost``); the supervisor evicts it and attempt 2 resumes
    from rung 2's checkpoint on the 7 survivors: bitwise the
    uninterrupted run."""
    xs = _problems(3, seed=7)
    mesh = _mesh(8)
    run = FaultInjector(shuffle_soft_sort_batched, device_loss={1: 5})
    kill = FaultInjector(lambda s: None, fail_calls={2})
    sup = AnnealSupervisor(run, checkpoint_dir=str(tmp_path),
                           retry=NO_BACKOFF)
    got = sup.run(xs, HW, CFG, n_restarts=2, seed=4, mesh=mesh,
                  rung_hook=kill, checkpoint_every=1)
    want = shuffle_soft_sort_batched(xs, HW, CFG, n_restarts=2, seed=4,
                                     device="cpu")
    np.testing.assert_array_equal(got.all_orders, want.all_orders)
    np.testing.assert_array_equal(got.all_losses, want.all_losses)
    assert sup.stats["restarts"] == 2 and sup.stats["evictions"] == 1
    assert {"event": "evict", "device": 5, "survivors": 7} in sup.history
    assert run.calls == 3 and run.device_faults == 1


# --------------------------------------------------------------- the server

def test_server_eviction_reshards_once_and_stays_bitwise():
    """One injected loss: the health layer evicts the slot and re-shards
    over the 7 survivors within one rung (the dead slot faults exactly one
    dispatch), the rung replays without spending retry budget, and every
    result is bitwise its solo run."""
    mesh = _mesh(8)
    dead = mesh.ids[3]
    inj = FaultInjector(run_round_segment, device_loss={1: dead})
    server = _elastic_server(mesh, inj)
    xs = _problems(3, seed=11)
    futs = [server.submit(xs[i], key=i) for i in range(3)]
    _drain(server)
    results = [f.result(timeout=0) for f in futs]
    server.close()
    assert server.stats["evictions"] == server.stats["reshards"] == 1
    assert server.stats["retries"] == 0 and server.stats["failed"] == 0
    assert inj.device_faults == 1
    assert len(server.mesh) == 7 and dead not in server.mesh.ids
    ev = [e for e in server.events if e["event"] == "evict"]
    assert ev == [{"event": "evict", "device": dead, "survivors": 7,
                   "requeued": 3}]
    assert any(k[-1] == 7 for k in server.stats["compile_keys"])
    for i, got in enumerate(results):
        _assert_result(got, _solo(xs[i], i))


def test_server_device_return_grows_mesh_back():
    mesh = _mesh(8)
    dead = mesh.ids[5]
    inj = FaultInjector(run_round_segment, device_loss={0: dead},
                        device_return={2: dead})
    server = _elastic_server(mesh, inj)
    xs = _problems(2, seed=13)
    futs = [server.submit(xs[i], key=30 + i) for i in range(2)]
    _drain(server)
    results = [f.result(timeout=0) for f in futs]
    server.close()
    assert server.stats["evictions"] == server.stats["reshards"] == 1
    assert server.stats["device_returns"] == 1
    assert server._evicted == [] and len(server.mesh) == 8
    assert server.mesh.ids == mesh.ids
    assert any(e["event"] == "device_return" for e in server.events)
    for i, got in enumerate(results):
        _assert_result(got, _solo(xs[i], 30 + i))


def test_server_losing_every_device_falls_back_to_no_mesh():
    """Every slot lost: the server runs with ``mesh=None`` on its own
    device (the fallback the reference has), logged as an ``evict`` event
    with no survivors, and the request is still bitwise its solo run."""
    mesh = _mesh(2)
    inj = FaultInjector(run_round_segment,
                        device_loss={0: mesh.ids[0], 2: mesh.ids[1]})
    server = SortServer(HW, d=D, cfg=CFG, max_batch=4, autostart=False,
                        mesh=mesh, engine_fn=inj, device="cpu",
                        device_health=DeviceHealthMonitor(
                            lost_after=1, probe=inj.healthy),
                        retry=NO_BACKOFF)
    x = _problems(1, seed=17)[0]
    fut = server.submit(x, key=6)
    _drain(server)
    got = fut.result(timeout=0)
    server.close()
    assert server.stats["evictions"] == server.stats["reshards"] == 2
    assert server.mesh is None
    assert [e["survivors"] for e in server.events
            if e["event"] == "evict"] == [1, 0]
    _assert_result(got, _solo(x, 6))


def test_eviction_raises_brownout_ladder():
    """An eviction is a capacity signal: the ladder climbs after it and
    steps back down once the slot returns."""
    mesh = _mesh(8)
    dead = mesh.ids[2]
    inj = FaultInjector(run_round_segment, device_loss={0: dead},
                        device_return={3: dead})
    server = _elastic_server(mesh, inj, brownout=BrownoutPolicy())
    xs = _problems(2, seed=19)
    futs = [server.submit(xs[i], key=40 + i) for i in range(2)]
    _drain(server)
    for f in futs:
        f.result(timeout=0)
    for _ in range(4):                   # idle ticks: the ladder decays
        server._tick()
    server.close()
    assert any(e["event"] == "brownout_up" for e in server.events)
    assert server.stats["device_returns"] == 1
    assert server._brownout_level == 0


@pytest.mark.parametrize("disk", [False, True])
def test_warm_handoff_carries_the_evicted_set(tmp_path, disk):
    """A preempted server with slot 3 evicted hands over its evicted set
    and the monitor's strikes; the successor's mesh is rebuilt over the
    survivors and finishes the request bitwise its solo run."""
    mesh = _mesh(8)
    inj = FaultInjector(run_round_segment, device_loss={0: 3})
    server = _elastic_server(mesh, inj,
                             checkpoint_dir=str(tmp_path) if disk else None)
    x = _problems(1, seed=23)[0]
    fut = server.submit(x, key=9)
    server._tick()                      # the loss: evicted, re-queued
    server._tick()                      # one rung on the survivors
    assert server._evicted == [3]
    handoff = server.close(drain=False)
    assert handoff.evicted_devices == (3,)
    assert handoff.health_state["evicted"] == [3]
    health = DeviceHealthMonitor(lost_after=1, probe=inj.healthy)
    server2 = SortServer(HW, d=D, cfg=CFG, max_batch=8, autostart=False,
                         mesh=_mesh(8), engine_fn=inj, device="cpu",
                         device_health=health, retry=NO_BACKOFF,
                         resume=str(tmp_path) if disk else handoff)
    assert server2._evicted == [3] and 3 not in server2.mesh.ids
    assert len(server2.mesh) == 7 and health.evicted == [3]
    _drain(server2)
    server2.close()
    got = (server2.resumed[0].future if disk else fut).result(timeout=0)
    _assert_result(got, _solo(x, 9))


# ------------------------------------------------------ the capacity cell

def test_capacity_cell_on_cpu(capsys):
    """``serving_bench --capacity`` on 8 CPU slots: two evictions, each
    re-sharded once, one return, no lost future, the exactly-once
    identity, the gate passes."""
    from repro_torch.bench import serving_bench
    doc = serving_bench.main(["--device", "cpu", "--smoke", "--check",
                              "--capacity"])
    assert "serving gate OK (4 cells)" in capsys.readouterr().out
    cap = doc["cells"][-1]
    assert cap["scenario"] == "capacity" and cap["wall_clock"] == "cpu"
    assert cap["devices_start"] == 8
    assert cap["evictions"] == cap["reshards"] == 2
    assert cap["device_returns"] == 1 and cap["lost_futures"] == 0
    assert cap["mesh_slots_end"] == 7
    assert (cap["completed"] + cap["failed"] + cap["deadline_missed"]
            + cap["queue_rejected"]) == cap["requests"]
    assert cap["failed"] == 0
    assert set(cap["degradations"]) == {"culled", "adaptive", "banded",
                                        "bf16"}


@pytest.mark.parametrize("use_kernel", [False, True])
def test_guarded_server_on_a_mesh_is_clean(use_kernel):
    """The shadow at rate 1 on a server sharded over 3 slots (the replay
    runs each dispatch on its own mesh, as the reference's segment shadow
    does): no incident, every request bitwise its solo run."""
    import dataclasses

    from repro_torch.runtime.guardrails import GuardrailPolicy
    cfg = dataclasses.replace(CFG, use_kernel=use_kernel)
    server = SortServer(HW, d=D, cfg=cfg, max_batch=8, autostart=False,
                        mesh=_mesh(3), device="cpu",
                        guardrail=GuardrailPolicy(mode="shadow",
                                                  shadow_rate=1.0))
    xs = _problems(5, seed=29)
    futs = [server.submit(xs[i], key=60 + i) for i in range(5)]
    _drain(server)
    server.close()
    assert server.stats["integrity_violations"] == 0
    for i, f in enumerate(futs):
        _assert_result(f.result(timeout=0), _solo(xs[i], 60 + i, cfg=cfg))

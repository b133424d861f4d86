"""The port's continuous-batching ``SortServer``
(``repro_torch.launch.serve``) and ``StragglerMonitor``
(``repro_torch.runtime.straggler``), on the CPU: the sort cases of
``tests/test_serving.py`` and the straggler cases of
``tests/test_runtime.py``, each on the port.

* Bitwise, inside the port: a served request is its own chained
  ``run_round_segment`` run alone (same seed, same norm), whatever
  traffic shared its dispatches, through faults, retries, deadlines of
  batchmates and a warm restart; adaptive requests are the adaptive
  engine's run, tournaments the engine's tournament.  These use the plain
  tier, which is batch-invariant on the CPU (the kernel twins' batched
  backward is not, ROADMAP.md Queue C6); on the card the kernel tier is
  (``tests/test_torch_cuda.py``).
* Against the reference: the reference's server and the port's on the
  same problems, the port replaying each request's JAX key chain, with
  the std term off
  (``lambda_sigma=0``, ROADMAP.md Queue C1): orders equal, losses within
  rtol 1e-5.  The straggler monitor gives the reference's decisions and
  statistics on the same timing streams.
* Deterministic scheduling drives ``server._tick()`` by hand with
  ``autostart=False``.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.runtime import straggler as jstraggler  # noqa: E402
from repro_torch.core.losses import mean_pairwise_distance  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ReplayShuffleSource,
    TorchShuffleSource,
    instance_seeds,
)
from repro_torch.core.shufflesoftsort import (  # noqa: E402
    ShuffleSoftSortConfig,
    restart_tournament,
    run_round_segment,
    shuffle_soft_sort,
)
from repro_torch.launch.serve import (  # noqa: E402
    BrownoutPolicy,
    DeadlineExceeded,
    QueueFull,
    RequestFailed,
    RequestRejected,
    ServerClosed,
    SortServer,
    WarmHandoff,
)
from repro_torch.runtime import straggler as tstraggler  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    FaultInjector,
    RetryPolicy,
    WorkerFailure,
)

N, HW, D = 16, (4, 4), 2
CFG = ShuffleSoftSortConfig(rounds=4, inner_steps=2, chunk=16)
CPU = dict(device="cpu")
# Always-plateau adaptive config: every boundary past the first fires a
# schedule jump, so each request exits the anneal at 6 of 8 rounds.
ACFG = ShuffleSoftSortConfig(rounds=8, inner_steps=2, chunk=16,
                             schedule="adaptive", patience=1,
                             plateau_rtol=1.0, adapt_every=2)
LOSS_RTOL = 1e-5


def _problems(count, d=D, n=N, seed=0):
    return np.random.RandomState(seed).rand(count, n, d).astype(np.float32)


def _server(cfg=CFG, **kw):
    return SortServer(kw.pop("hw", HW), d=kw.pop("d", D), cfg=cfg,
                      **{**CPU, **kw})


def _drain(server, max_ticks=64):
    """Drive manual ticks until the server goes idle."""
    for _ in range(max_ticks):
        with server._cv:
            idle = not server._pending and not server._active
        if idle:
            return
        server._tick()
    raise AssertionError("server did not drain")


def _resolution_is_exactly_once(server, futs):
    assert all(f.done() for f in futs)
    terminal = (server.stats["completed"] + server.stats["failed"]
                + server.stats["deadline_missed"])
    assert terminal == len(futs), server.stats


def _solo(x, seed, cfg=CFG, hw=HW, seg_len=1):
    """The request alone: chained ``run_round_segment`` calls from
    ``TorchShuffleSource([seed])`` at the server's norm."""
    n = x.shape[0]
    src = TorchShuffleSource([seed], n, "cpu")
    norm = np.float32(mean_pairwise_distance(torch.as_tensor(x)))
    orders, parts = np.arange(n)[None], []
    for p0 in range(0, cfg.rounds, seg_len):
        o, ls = run_round_segment(x[None], orders, [norm], [p0], seg_len,
                                  source=src, hw=hw, cfg=cfg, **CPU)
        orders = o.numpy()
        parts.append(ls.numpy()[:, 0])
    order = orders[0].astype(np.int32)
    return order, x[order], np.concatenate(parts)


def _assert_result(got, want):
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------- retry/injector units

def test_retry_policy_backoff_schedule():
    rp = RetryPolicy(max_retries=3, backoff_base_s=0.05,
                     backoff_mult=2.0, backoff_max_s=0.15)
    assert [rp.backoff(a) for a in (1, 2, 3, 9)] == [0.05, 0.10, 0.15, 0.15]
    with pytest.raises(ValueError):
        rp.backoff(0)


def test_fault_injector_is_deterministic():
    calls, slept = [], []
    inj = FaultInjector(lambda v: calls.append(v) or v * 2,
                        fail_calls={1, 3}, delay_calls={0: 0.25, 1: 0.5},
                        sleep_fn=slept.append)
    assert inj(5) == 10
    with pytest.raises(WorkerFailure):
        inj(6)
    assert inj(7) == 14
    with pytest.raises(WorkerFailure):
        inj(8)
    assert (inj.calls, inj.faults, inj.delays) == (4, 2, 2)
    assert slept == [0.25, 0.5] and calls == [5, 7]


def test_fault_injector_delay_waits_for_an_accepted_call():
    """With ``delay_when`` a delay scheduled at call 1 lands on the first
    call from 1 on that the predicate accepts and that is not failed;
    the schedule left in ``state_dict`` loses it."""
    calls, slept = [], []
    inj = FaultInjector(lambda v: calls.append(v) or v, fail_calls={2},
                        delay_calls={1: 0.5}, sleep_fn=slept.append,
                        delay_when=lambda v: v >= 8)
    assert inj(9) == 9 and inj(3) == 3          # call 0: not due yet
    with pytest.raises(WorkerFailure):
        inj(9)                                  # due, but failed
    assert inj(4) == 4 and slept == []          # not accepted
    assert inj(8) == 8 and slept == [0.5]       # call 4: the stall
    assert inj(9) == 9 and slept == [0.5]       # once
    assert (inj.calls, inj.faults, inj.delays) == (6, 1, 1)
    assert inj.state_dict()["delay_calls"] == {} and calls == [9, 3, 4, 8, 9]


# ---------------------------------------------- continuous batching core

def test_mixed_progress_requests_share_one_dispatch_bitwise():
    """A request that joins mid-traffic batches with one already
    mid-anneal (two tau positions in one call); both finish bitwise their
    solo chained-segment runs."""
    xs = _problems(2)
    server = _server(max_batch=8, autostart=False)
    f0 = server.submit(xs[0], key=11)
    server._tick()                         # r0 runs rung 1 alone
    f1 = server.submit(xs[1], key=12)
    _drain(server)
    server.close()
    assert 2 in server.stats["batch_sizes"]
    assert server.seg_len == 1
    for f, x, k in ((f0, xs[0], 11), (f1, xs[1], 12)):
        _assert_result(f.result(timeout=0), _solo(x, k))
    assert {key[3] for key in server.stats["compile_keys"]} == {1, 2}


def test_server_matches_the_reference_server():
    """The reference's server and the port's, four requests of mixed
    progress in one bucket: each port request replays its JAX key chain
    (``ReplayShuffleSource``).  Orders equal, losses within rtol 1e-5
    (std term off)."""
    from repro.core.shufflesoftsort import ShuffleSoftSortConfig as JConfig
    cfg_kw = dict(rounds=4, inner_steps=2, chunk=16, lambda_sigma=0.0)
    xs = _problems(4, seed=3)
    keys = [jax.random.PRNGKey(30 + i) for i in range(4)]
    out = {}
    for name in ("ref", "port"):
        if name == "ref":
            server = jserve.SortServer(HW, d=D, cfg=JConfig(**cfg_kw),
                                       max_batch=4, autostart=False)
        else:
            server = _server(ShuffleSoftSortConfig(**cfg_kw), max_batch=4,
                             autostart=False)
        futs = []
        for i, (x, k) in enumerate(zip(xs, keys)):
            if name == "ref":
                futs.append(server.submit(x, key=k))
            else:
                futs.append(server.submit(
                    x, key=ReplayShuffleSource(
                        _key_chain_shuffles(np.asarray(k)[None], 4), "cpu")))
            if i == 1:
                server._tick()
        _drain(server)
        server.close()
        out[name] = [f.result(timeout=0) for f in futs]
        assert server.stats["batch_sizes"][:2] == [2, 4]
    for (ot, _, lt), (oj, _, lj) in zip(out["port"], out["ref"]):
        np.testing.assert_array_equal(ot, np.asarray(oj))
        np.testing.assert_allclose(lt, np.asarray(lj), rtol=LOSS_RTOL)


def _key_chain_shuffles(keys, rounds, n=N):
    """(R, S, N): each key's shuffles from its own chain, as the
    reference's segments draw them."""
    out, k = [], jnp.asarray(keys)
    for _ in range(rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        out.append(np.stack([np.asarray(jax.random.permutation(sk, n))
                             for sk in subs]))
    return np.stack(out)


def test_priority_admission_order():
    server = _server(max_batch=1, max_active=1, autostart=False)
    xs = _problems(2)
    f_low = server.submit(xs[0], key=0, priority=0)
    f_high = server.submit(xs[1], key=1, priority=5)
    server._tick()
    assert [e["seq"] for e in server.events if e["event"] == "admit"] == [1]
    _drain(server)
    server.close()
    assert f_high.result(timeout=0) and f_low.result(timeout=0)


def test_mixed_shape_traffic_batches_per_bucket():
    xa = _problems(1, d=2, n=16)[0]
    xb = _problems(1, d=3, n=8, seed=3)[0]
    server = _server(max_batch=4, autostart=False)
    fa = server.submit(xa, key=21)
    fb = server.submit(xb, key=22, hw=(2, 4))
    _drain(server)
    server.close()
    _assert_result(fa.result(timeout=0), _solo(xa, 21))
    _assert_result(fb.result(timeout=0), _solo(xb, 22, hw=(2, 4)))
    sigs = {(key[0], key[1]) for key in server.stats["compile_keys"]}
    assert sigs == {((4, 4), 2), ((2, 4), 3)}


def test_submit_validates_shapes_and_keys():
    server = _server(autostart=False)
    for bad in (np.zeros((8, D), np.float32), np.zeros((N, 5), np.float32)):
        with pytest.raises(ValueError):
            server.submit(bad)
    with pytest.raises(ValueError):
        server.submit(np.zeros((N, D), np.float32), hw=(3, 4))
    with pytest.raises(ValueError):              # one restart, two streams
        server.submit(np.zeros((N, D), np.float32),
                      key=TorchShuffleSource([1, 2], N, "cpu"))
    server.close()


def test_sched_rung_alignment_is_validated():
    with pytest.raises(ValueError):
        _server(sched_rungs=3, autostart=False)
    with pytest.raises(ValueError):
        _server(n_restarts=4, tournament_rungs=3, autostart=False)


def test_mesh_and_device_health_are_not_ported():
    """Once refused as unported (ROADMAP.md Queue A11), a mesh and a
    health monitor are now ported: objects of other types are a
    ``TypeError``, and a server on a mesh of CPU slots serves a request
    bitwise its solo run.  The default device is CUDA, an error without
    one (no quiet move to the CPU)."""
    from repro_torch.launch.mesh import make_sort_mesh
    for kw, what in ((dict(mesh=object()), "SortMesh"),
                     (dict(device_health=object()), "DeviceHealthMonitor")):
        with pytest.raises(TypeError, match=what):
            _server(autostart=False, **kw)
    server = SortServer(HW, d=D, cfg=CFG, autostart=False,
                        mesh=make_sort_mesh(devices=["cpu"] * 3),
                        device_health=tstraggler.DeviceHealthMonitor())
    assert server.device == torch.device("cpu")
    x = _problems(1, seed=4)[0]
    fut = server.submit(x, key=5)
    _drain(server)
    server.close()
    _assert_result(fut.result(timeout=0), _solo(x, 5))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SortServer(HW, d=D, cfg=CFG, autostart=False)


# ----------------------------------------------------- fault injection

def test_injected_failures_recover_every_future():
    xs = _problems(3)
    inj = FaultInjector(run_round_segment, fail_calls={0, 2})
    server = _server(max_batch=4, max_wait_ms=20.0, engine_fn=inj,
                     retry=RetryPolicy(max_retries=3, backoff_base_s=0.0))
    futs = [server.submit(xs[i], key=i) for i in range(3)]
    results = [f.result(timeout=120) for f in futs]
    server.close()
    _resolution_is_exactly_once(server, futs)
    assert inj.faults == 2 and server.stats["failed"] == 0
    assert server.stats["retries"] >= 2 and server.stats["recoveries"] >= 1
    for got, x, k in zip(results, xs, range(3)):
        _assert_result(got, _solo(x, k))


def test_retry_budget_exhaustion_is_a_typed_rejection():
    def broken(*a, **k):
        raise WorkerFailure("device on fire")
    server = _server(max_wait_ms=5.0, engine_fn=broken,
                     retry=RetryPolicy(max_retries=1, backoff_base_s=0.0))
    fut = server.submit(_problems(1)[0], key=0)
    with pytest.raises(RequestFailed) as ei:
        fut.result(timeout=60)
    server.close()
    assert isinstance(ei.value.__cause__, WorkerFailure)
    assert isinstance(ei.value, RequestRejected)
    assert server.stats["failed"] == 1 and server.stats["retries"] == 1
    _resolution_is_exactly_once(server, [fut])


def test_straggler_flagged_and_traffic_rerouted():
    server = _server(max_batch=4, autostart=False)
    f = server.submit(_problems(1)[0], key=0)
    _drain(server)
    assert f.result(timeout=0)
    server.straggler = tstraggler.StragglerMonitor(z=3.0, min_ratio=1.5,
                                                   warmup=3)
    server._engine = FaultInjector(run_round_segment, delay_calls={3: 0.5})
    fut = server.submit(_problems(1, seed=9)[0], key=1)
    _drain(server)
    assert fut.result(timeout=0)
    assert server.stats["stragglers"] == 1 and server._bucket_cap == 2
    assert [(e["cap_before"], e["bucket_cap"]) for e in server.events
            if e["event"] == "straggler"] == [(4, 2)]
    burst = [server.submit(x, key=40 + i)
             for i, x in enumerate(_problems(4, seed=11))]
    n_before = len(server.stats["batch_sizes"])
    _drain(server)
    server.close()
    assert all(f.result(timeout=0) for f in burst)
    assert max(server.stats["batch_sizes"][n_before:]) <= 2


# --------------------------------------------- backpressure / deadlines

def test_backpressure_rejects_instead_of_deadlocking():
    server = _server(queue_depth=2, autostart=False)
    xs = _problems(3)
    f0, f1 = server.submit(xs[0]), server.submit(xs[1])
    with pytest.raises(QueueFull):
        server.submit(xs[2])
    assert server.stats["queue_rejected"] == 1
    server.close()
    for f in (f0, f1):
        with pytest.raises(ServerClosed):
            f.result(timeout=0)


def test_deadline_expired_in_queue_is_shed_at_admission():
    server = _server(autostart=False)
    fut = server.submit(_problems(1)[0], deadline_s=-0.001)
    server._tick()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=0)
    assert server.stats["deadline_missed"] == 1
    server.close()
    _resolution_is_exactly_once(server, [fut])


def test_deadline_mid_anneal_is_shed_at_round_boundary():
    server = _server(max_batch=4, autostart=False)
    warm = server.submit(_problems(1)[0], key=0)
    _drain(server)
    assert warm.result(timeout=0)
    server._engine = FaultInjector(run_round_segment,
                                   delay_calls={i: 0.3 for i in range(8)})
    x_ok = _problems(1, seed=13)[0]
    fut = server.submit(_problems(1, seed=12)[0], deadline_s=0.45)
    f_ok = server.submit(x_ok, key=3)
    _drain(server)
    server.close()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=0)
    assert server.stats["deadline_missed"] == 1
    _assert_result(f_ok.result(timeout=0), _solo(x_ok, 3))


def test_close_under_in_flight_load_strands_nothing():
    inj = FaultInjector(run_round_segment,
                        delay_calls={i: 0.05 for i in range(64)})
    server = _server(max_wait_ms=5.0, engine_fn=inj)
    futs = [server.submit(x, key=i)
            for i, x in enumerate(_problems(6, seed=2))]
    time.sleep(0.15)
    server.close()
    for f in futs:
        assert f.done()
        if f.exception() is not None:
            assert isinstance(f.exception(), ServerClosed)
    with pytest.raises(ServerClosed):
        server.submit(_problems(1)[0])


# ------------------------------------------------------ reproducibility

def test_same_seed_servers_are_bitwise():
    xs = _problems(3, seed=4)

    def run(seed):
        server = _server(max_batch=4, seed=seed, autostart=False)
        futs = [server.submit(x) for x in xs]
        _drain(server)
        server.close()
        return [f.result(timeout=0) for f in futs]

    a, b, c = run(7), run(7), run(8)
    for ra, rb in zip(a, b):
        _assert_result(ra, rb)
    assert any(not np.array_equal(x[0], y[0]) for x, y in zip(a, c))


# ------------------------------------------------------- CLI validation

def test_cli_rejects_bad_grid_with_argparse_error(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as ei:
        main(["--workload", "sort", "--sort-n", "16", "--sort-hw", "3",
              "--device", "cpu"])
    assert ei.value.code == 2
    assert "divisor" in capsys.readouterr().err


def test_cli_rejects_bf16_without_kernel(capsys):
    from repro_torch.launch.serve import main
    with pytest.raises(SystemExit) as ei:
        main(["--workload", "sort", "--dtype", "bfloat16", "--device",
              "cpu"])
    assert ei.value.code == 2
    assert "--use-kernel" in capsys.readouterr().err


def test_cli_serves_and_accounts(capsys):
    """The README's command: 8 requests on the CPU; the accounting line
    holds; the LM workload serves; the mesh flags serve on a mesh of CPU
    slots, and --device-health needs --mesh-devices."""
    from repro_torch.launch.serve import main
    out = main(["--workload", "sort", "--device", "cpu", "--requests", "8",
                "--sort-n", "64", "--rounds", "8"])
    line = capsys.readouterr().out
    assert "completed 8 + failed 0 + deadline_missed 0 + queue_rejected 0 " \
           "== offered 8" in line
    assert out["completed"] == 8 and out["improved"] == 8
    out = main(["--workload", "lm", "--device", "cpu", "--requests", "2",
                "--max-new", "3"])
    assert "served 2 requests" in capsys.readouterr().out
    assert out["tokens"].shape == (2, 3)
    out = main(["--workload", "sort", "--device", "cpu", "--requests", "3",
                "--sort-n", "64", "--rounds", "4", "--mesh-devices", "3",
                "--device-health", "1"])
    line = capsys.readouterr().out
    assert "3 mesh slots of cpu" in line and "elastic: 0 evictions" in line
    assert out["completed"] == 3 and out["evictions"] == 0
    with pytest.raises(SystemExit) as ei:
        main(["--workload", "sort", "--device", "cpu", "--device-health",
              "2"])
    assert ei.value.code == 2
    assert "--mesh-devices" in capsys.readouterr().err


# --------------------------------------- adaptive annealing x faults

@pytest.mark.parametrize("fail_calls", [
    frozenset(), frozenset({0}), frozenset({1}), frozenset({0, 2})],
    ids=["clean", "first", "mid", "storm"])
def test_adaptive_early_exit_resolves_exactly_once_under_faults(fail_calls):
    """Requests converge early through a retry storm; each future
    resolves once, bitwise the adaptive engine's run of its seed."""
    xs = _problems(3, seed=9)
    inj = FaultInjector(run_round_segment, fail_calls=fail_calls)
    server = _server(ACFG, max_batch=4, autostart=False, engine_fn=inj,
                     retry=RetryPolicy(max_retries=3, backoff_base_s=0.0))
    futs = [server.submit(xs[i], key=20 + i) for i in range(3)]
    _drain(server, max_ticks=200)
    results = [f.result(timeout=5) for f in futs]
    server.close()
    _resolution_is_exactly_once(server, futs)
    assert inj.faults == len(fail_calls) and server.stats["failed"] == 0
    assert server.stats["retries"] == 3 * len(fail_calls)
    assert server.stats["adaptive_exits"] == 3
    assert server.stats["rounds_saved"] == 3 * 2
    for (order, _, losses), x, k in zip(results, xs, range(20, 23)):
        o_ref, _, l_ref = shuffle_soft_sort(x, HW, ACFG, seed=k, **CPU)
        np.testing.assert_array_equal(order, o_ref)
        np.testing.assert_array_equal(losses[~np.isnan(losses)],
                                      np.float32(l_ref))
        assert np.isnan(losses[len(l_ref):]).all()


def test_adaptive_retry_exhaustion_still_resolves_every_future():
    inj = FaultInjector(run_round_segment, fail_calls={1, 2, 3})
    server = _server(ACFG, autostart=False, engine_fn=inj,
                     retry=RetryPolicy(max_retries=2, backoff_base_s=0.0))
    fut = server.submit(_problems(1, seed=21)[0], key=0)
    _drain(server, max_ticks=200)
    server.close()
    with pytest.raises(RequestRejected):
        fut.result(timeout=0)
    assert server.stats["failed"] == 1 and server.stats["adaptive_exits"] == 0
    _resolution_is_exactly_once(server, [fut])


def _restart_seeds(key, s):
    """The server's restart streams of an int key."""
    return [key] + instance_seeds(key, s)[1:]


@pytest.mark.parametrize("cfg", [CFG, ACFG], ids=["fixed", "adaptive"])
def test_tournament_serving_with_fault_matches_engine(cfg):
    """n_restarts > 1: the server's tournament (culls at rung boundaries,
    and on the adaptive schedule per-restart early stops) recovers from an
    injected fault and returns the engine's tournament winner, bitwise."""
    x = _problems(1, seed=23)[0]
    inj = FaultInjector(run_round_segment, fail_calls={1})
    server = _server(cfg, n_restarts=4, tournament_rungs=2, autostart=False,
                     engine_fn=inj,
                     retry=RetryPolicy(max_retries=3, backoff_base_s=0.0))
    fut = server.submit(x, key=9)
    _drain(server, max_ticks=200)
    order, _, losses = fut.result(timeout=5)
    server.close()
    ref = restart_tournament(x[None], HW, cfg, n_restarts=4,
                             seeds=_restart_seeds(9, 4), cull_fraction=0.5,
                             n_rungs=2, **CPU)
    np.testing.assert_array_equal(order, ref.order[0])
    np.testing.assert_array_equal(
        losses, ref.all_losses[0, ref.best_restart[0]])
    assert inj.faults == 1 and server.stats["recoveries"] >= 1
    assert server.stats["culled"] > 0
    _resolution_is_exactly_once(server, [fut])


# --------------------------------------------- warm restart (preemption)

def test_warm_restart_resolves_in_flight_futures_bitwise():
    xs = _problems(3, seed=31)
    server = _server(max_batch=8, autostart=False)
    futs = [server.submit(x, key=40 + i) for i, x in enumerate(xs)]
    server._tick()
    server._tick()
    handoff = server.close(drain=False)
    assert isinstance(handoff, WarmHandoff)
    assert len(handoff.requests) == 3 and not any(f.done() for f in futs)
    assert all(r.progress > 0 for r in handoff.requests)
    server2 = _server(max_batch=8, autostart=False, resume=handoff)
    assert server2.stats["resumed"] == 3
    _drain(server2)
    server2.close()
    for i, (f, x) in enumerate(zip(futs, xs)):
        _assert_result(f.result(timeout=0), _solo(x, 40 + i))
    assert sum(s.stats["completed"] for s in (server, server2)) == 3


def test_warm_restart_under_live_load_strands_nothing():
    inj = FaultInjector(run_round_segment,
                        delay_calls={i: 0.03 for i in range(64)})
    server = _server(max_wait_ms=2.0, engine_fn=inj)
    futs = [server.submit(x, key=60 + i)
            for i, x in enumerate(_problems(6, seed=33))]
    time.sleep(0.12)
    handoff = server.close(drain=False)
    assert not any(f.done() and f.exception() is not None for f in futs)
    server2 = _server(max_wait_ms=2.0, resume=handoff)
    for f in futs:
        order, _, losses = f.result(timeout=120)
        assert order.shape == (N,) and np.isfinite(losses).all()
    server2.close()
    assert server.stats["completed"] + server2.stats["completed"] == 6
    assert server2.stats["resumed"] == len(handoff.requests)
    with pytest.raises(ServerClosed):
        server2.submit(_problems(1)[0])


@pytest.mark.parametrize("cfg,replay", [(ACFG, False), (CFG, True)],
                         ids=["adaptive", "replay_keys"])
def test_warm_restart_disk_roundtrip(tmp_path, cfg, replay):
    """Cross-process resume: the handoff persists to checkpoint_dir and a
    successor built with resume=<dir> (fresh futures on .resumed) finishes
    every request bitwise an uninterrupted server; the controllers, the
    generator states and replayed key sources (one still queued) all
    round-trip through disk."""
    xs = _problems(3, seed=37)

    def key(i):
        if not replay:
            return 70 + i
        gen = TorchShuffleSource([70 + i], N, "cpu")
        return ReplayShuffleSource(
            torch.stack([gen.next_round() for _ in range(cfg.rounds)]),
            "cpu")

    def submit_all(srv):
        return [srv.submit(x, key=key(i)) for i, x in enumerate(xs)]

    srv = _server(cfg, max_batch=8, autostart=False)
    futs = submit_all(srv)
    _drain(srv)
    srv.close()
    ref = [f.result(timeout=0) for f in futs]

    server = _server(cfg, max_batch=2, max_active=2, autostart=False,
                     checkpoint_dir=str(tmp_path))
    submit_all(server)
    server._tick()                         # one rung of two requests
    handoff = server.close(drain=False)
    assert sum(r.orders is None for r in handoff.requests) == 1
    server2 = _server(cfg, max_batch=8, autostart=False,
                      resume=str(tmp_path))
    assert len(server2.resumed) == 3
    _drain(server2)
    server2.close()
    got = {r.seq: r.future.result(timeout=0) for r in server2.resumed}
    for i, want in enumerate(ref):
        _assert_result(got[i], want)


def test_dispatch_divergence_sentinel_is_typed_and_exactly_once():
    from repro_torch.core.shufflesoftsort import NumericalDivergence

    def poisoned(*a, **kw):
        o, l = run_round_segment(*a, **kw)
        return o, torch.full_like(l, float("nan"))

    server = _server(autostart=False, engine_fn=poisoned,
                     retry=RetryPolicy(max_retries=1, backoff_base_s=0.0))
    fut = server.submit(_problems(1, seed=41)[0], key=5)
    for _ in range(8):
        server._tick()
        time.sleep(0.001)
    server.close()
    exc = fut.exception()
    assert isinstance(exc, RequestFailed)
    assert isinstance(exc.__cause__, NumericalDivergence)
    _resolution_is_exactly_once(server, [fut])


# --------------------------------------------------------- brownout

def test_brownout_ladder_steps_with_hysteresis():
    server = _server(autostart=False, brownout=BrownoutPolicy())
    server._evicted = [99]
    server._bucket_cap = server.max_batch // 2
    levels = []
    for _ in range(3):
        server._update_brownout(0)
        levels.append(server._brownout_level)
    server._evicted = []
    server._bucket_cap = server.max_batch
    for _ in range(2):
        server._update_brownout(0)
        levels.append(server._brownout_level)
    assert levels == [1, 2, 2, 1, 0]
    server.close()


def test_brownout_queue_watermarks():
    server = _server(autostart=False, queue_depth=4,
                     brownout=BrownoutPolicy())
    server._update_brownout(2)
    server._update_brownout(2)
    assert server._brownout_level == 2
    server._update_brownout(1)
    assert server._brownout_level == 1
    server._update_brownout(0)
    assert server._brownout_level == 0
    server.close()


def test_brownout_degrades_to_adaptive_and_matches_engine():
    x = _problems(1, seed=31)[0]
    server = _server(autostart=False,
                     brownout=BrownoutPolicy(slack_full_s=60.0))
    server._bucket_cap = server.max_batch // 2
    server._evicted = [99]
    server._tick()
    server._tick()
    assert server._brownout_level == 2
    fut = server.submit(x, key=7, deadline_s=30.0)
    _drain(server)
    order, _, _ = fut.result(timeout=5)
    server.close()
    assert server.stats["degradations"]["adaptive"] == 1
    assert server.stats["brownouts"] == 1
    o_ref, _, _ = shuffle_soft_sort(
        x, HW, dataclasses.replace(CFG, schedule="adaptive"), seed=7, **CPU)
    np.testing.assert_array_equal(order, o_ref)


def test_brownout_spares_slack_rich_requests():
    server = _server(autostart=False, brownout=BrownoutPolicy())
    server._evicted = [99]
    server._tick()
    assert server._brownout_level == 1
    fut = server.submit(_problems(1, seed=33)[0], key=3)
    _drain(server)
    fut.result(timeout=5)
    server.close()
    assert server.stats["brownouts"] == 0
    assert server.stats["degradations"] == {
        "culled": 0, "adaptive": 0, "banded": 0, "bf16": 0}


def test_brownout_cull_matches_aggressive_tournament():
    x = _problems(1, seed=37)[0]
    server = _server(n_restarts=4, tournament_rungs=2, autostart=False,
                     brownout=BrownoutPolicy(slack_full_s=60.0))
    server._evicted = [99]
    server._tick()
    fut = server.submit(x, key=11, deadline_s=30.0)
    _drain(server, max_ticks=200)
    order, _, _ = fut.result(timeout=5)
    server.close()
    assert server.stats["degradations"]["culled"] == 1
    ref = restart_tournament(x[None], HW, CFG, n_restarts=4,
                             seeds=_restart_seeds(11, 4), cull_fraction=0.99,
                             n_rungs=2, **CPU)
    np.testing.assert_array_equal(order, ref.order[0])


@pytest.mark.parametrize("disk", [False, True])
def test_warm_handoff_roundtrips_the_ladder(tmp_path, disk):
    """The brownout position survives a handoff, in process and through
    the JSON manifest; with no mesh the evicted-device set is empty (a
    mesh's: ``tests/test_torch_elastic.py``)."""
    server = _server(autostart=False, brownout=BrownoutPolicy(),
                     checkpoint_dir=str(tmp_path) if disk else None)
    server._brownout_level = 3
    handoff = server.close(drain=False)
    assert handoff.evicted_devices == () and handoff.health_state is None
    server2 = _server(autostart=False, brownout=BrownoutPolicy(),
                      resume=str(tmp_path) if disk else handoff)
    assert server2._brownout_level == 3 and server2._evicted == []
    server2.close()


# ------------------------------------------------ the straggler monitor

def _both(**kw):
    return (tstraggler.StragglerMonitor(**kw),
            jstraggler.StragglerMonitor(**kw))


@pytest.mark.parametrize("stream,kw", [
    ([0.1 + 0.001 * (i % 3) for i in range(20)] + [0.5],
     dict(z=3.0, min_ratio=1.5, warmup=3)),
    ([0.05] * 10 + [1.0], dict(z=3.0, warmup=3)),
    ([0.1, 0.1, 50.0, 0.1, 0.1], dict(z=3.0, min_ratio=1.5, warmup=5)),
    ([0.1] * 3 + [5.0, 0.1], dict(z=3.0, min_ratio=1.5, warmup=3)),
    ([0.1] * 3 + [0.1 * (1 + (i % 4 == 0) * 9) for i in range(30)],
     dict(z=3.0, min_ratio=1.5, alpha=0.05, warmup=3)),
], ids=["detect", "callback", "warmup_only", "first_post_warmup",
        "healthy_only_baseline"])
def test_straggler_monitor_matches_reference(stream, kw):
    """The reference's straggler cases: the same flags, callbacks,
    baseline and variance as the reference on each timing stream."""
    (t, j) = _both(**kw)
    events = {"t": [], "j": []}
    t.on_straggler = lambda s, dt, m: events["t"].append((s, dt, m))
    j.on_straggler = lambda s, dt, m: events["j"].append((s, dt, m))
    got = [t.record(i, dt) for i, dt in enumerate(stream)]
    want = [j.record(i, dt) for i, dt in enumerate(stream)]
    assert got == want and t.flagged == j.flagged
    assert events["t"] == events["j"]
    assert (t.mean, t.var, t.count) == (j.mean, j.var, j.count)
    if "warmup" in kw and len(stream) <= kw["warmup"] + 1:
        assert not any(got[:kw["warmup"]])


def test_device_health_monitor_matches_reference():
    """Classification, strikes, returns and the state round-trip, as the
    reference's, on the same failure stream."""
    class Lost(RuntimeError):
        def __init__(self, dev):
            super().__init__("lost")
            self.device_id = dev

    back = {3}
    t = tstraggler.DeviceHealthMonitor(lost_after=2, probe=back.__contains__)
    j = jstraggler.DeviceHealthMonitor(lost_after=2, probe=back.__contains__)
    stream = [Lost(3), RuntimeError("x"), Lost(5), Lost(3), Lost(3), Lost(5)]
    assert [t.classify(e) for e in stream] == [j.classify(e) for e in stream]
    t.record_success([5])
    j.record_success([5])
    assert t.state_dict() == j.state_dict()
    assert t.poll_returns() == j.poll_returns() == [3]
    fresh = tstraggler.DeviceHealthMonitor()
    fresh.load_state_dict(t.state_dict())
    assert fresh.state_dict() == t.state_dict() == j.state_dict()
    with pytest.raises(ValueError):
        tstraggler.DeviceHealthMonitor(lost_after=0)


# ------------------------------- the straggler yardstick (Queue C9)

class _Clock:
    """A fake ``time.perf_counter``: dispatches cost what the engine says."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _host_bound(monkeypatch, cost=0.2, stalls=()):
    """The server's dispatch clock made fake, and an engine that costs
    ``cost`` seconds whatever its batch (a host-bound card), 4x that at
    the dispatch indices ``stalls`` (a stall of 3 dispatches' time)."""
    import types
    from repro_torch.launch import serve
    clock = _Clock()
    monkeypatch.setattr(serve, "time", types.SimpleNamespace(
        perf_counter=clock, monotonic=time.monotonic, sleep=time.sleep))
    batches = []

    def engine(xs, *args, **kwargs):
        clock.t += cost * (4 if len(batches) in stalls else 1)
        batches.append(xs.shape[0])
        return run_round_segment(xs, *args, **kwargs)

    return engine, batches


def _reference_yardstick_flags(server, batches, seg_len, **kw):
    """The flags the reference's yardstick (seconds per instance-round)
    gives the same dispatches."""
    mon = tstraggler.StragglerMonitor(**kw)
    times = [0.2 * (4 if i in server._stalls else 1)
             for i in range(len(batches))]
    return [i for i, (dt, b) in enumerate(zip(times, batches))
            if mon.record(i, dt / (seg_len * b))]


def test_dispatch_cost_model():
    """One mean per signature: nothing to judge by before a signature's
    first dispatch; a running mean over the first ``1 / alpha``
    dispatches, an EWMA after; signatures never mix."""
    cost = tstraggler.DispatchCost(alpha=0.5)
    assert cost.expected(("a", 8)) is None
    cost.observe(("a", 8), 1.0)
    assert cost.expected(("a", 8)) == 1.0
    assert cost.expected(("a", 4)) is None
    cost.observe(("a", 8), 2.0)          # a running mean, then the EWMA
    assert cost.expected(("a", 8)) == 1.5
    cost.observe(("a", 8), 2.0)
    assert cost.expected(("a", 8)) == 1.75
    cost.observe(("a", 4), 0.25)
    assert cost.expected(("a", 4)) == 0.25
    assert cost.expected(("a", 8)) == 1.75


def test_host_bound_small_buckets_raise_no_flag(monkeypatch):
    """A host-bound engine (the same seconds at any batch): a warm-up at
    bucket 8, then clean dispatches at buckets 1 and 2, flags nothing,
    where the reference's per-instance-round yardstick flags them; then a
    stall of 3 dispatches' time at bucket 8 is flagged and halves the
    bucket cap."""
    engine, batches = _host_bound(monkeypatch, stalls={13})
    mon = dict(z=4.0, min_ratio=2.0, warmup=3)
    server = _server(max_batch=8, autostart=False, engine_fn=engine,
                     straggler=tstraggler.StragglerMonitor(**mon))
    server._stalls = {13}
    for count, seed in ((8, 0), (1, 1), (2, 2)):
        futs = [server.submit(x, key=10 * seed + i)
                for i, x in enumerate(_problems(count, seed=seed))]
        _drain(server)
        assert all(f.result(timeout=0) for f in futs)
    assert batches == [8] * 4 + [1] * 4 + [2] * 4
    assert server.stats["stragglers"] == 0 and server._bucket_cap == 8
    assert _reference_yardstick_flags(server, batches, 1, **mon)
    futs = [server.submit(x, key=40 + i)
            for i, x in enumerate(_problems(8, seed=4))]
    _drain(server)
    server.close()
    assert all(f.result(timeout=0) for f in futs)
    assert batches[12:14] == [8, 8]
    ev = [e for e in server.events if e["event"] == "straggler"]
    assert server.stats["stragglers"] == 1 and len(ev) == 1
    assert ev[0]["cap_before"] == 8 and ev[0]["bucket_cap"] == 4
    assert ev[0]["dt_s"] == pytest.approx(0.8)
    assert ev[0]["expected_s"] == pytest.approx(0.2)


def test_culled_tournament_raises_no_flag(monkeypatch):
    """Tournament requests culled from 8 live restarts to 4 and 2 on a
    host-bound engine: no flag, where the reference's yardstick flags the
    culled dispatches."""
    engine, batches = _host_bound(monkeypatch)
    mon = dict(z=4.0, min_ratio=2.0, warmup=2)
    cfg = ShuffleSoftSortConfig(rounds=6, inner_steps=2, chunk=16)
    server = _server(cfg, max_batch=8, autostart=False, engine_fn=engine,
                     n_restarts=8, tournament_rungs=3, sched_rungs=3,
                     cull_fraction=0.5,
                     straggler=tstraggler.StragglerMonitor(**mon))
    server._stalls = set()
    for i, x in enumerate(_problems(3, seed=5)):
        fut = server.submit(x, key=50 + i)
        _drain(server)
        assert fut.result(timeout=0)
    server.close()
    assert batches == [8, 4, 2] * 3
    assert server.stats["stragglers"] == 0 and server._bucket_cap == 8
    assert _reference_yardstick_flags(server, batches, 2, **mon)


# ------------------------------------------------------- the serving bench

def test_serving_bench_smoke_check_passes_on_cpu(capsys):
    """``python -m repro_torch.bench.serving_bench --device cpu --smoke
    --check --inject-faults``: every scenario accounts for each offered
    request exactly once, the faults row retried, the preempt row resumed
    every preempted request, the faults_stall row flagged its stall at a
    full bucket and halved the cap (ROADMAP.md Queue C9); ``--capacity``
    adds the elastic cell (its checks: ``tests/test_torch_elastic.py``)."""
    from repro_torch.bench import serving_bench
    doc = serving_bench.main(["--device", "cpu", "--smoke", "--check",
                              "--inject-faults"])
    assert "serving gate OK (5 cells)" in capsys.readouterr().out
    assert [c["scenario"] for c in doc["cells"]] == [
        "steady", "faults", "faults_stall", "overload", "preempt"]
    assert all(c["wall_clock"] == "cpu" for c in doc["cells"])
    faults, stall = doc["cells"][1:3]
    assert faults["injected_faults"] >= 1 and faults["retries"] >= 1
    assert stall["injected_delays"] == 1 and any(
        e["dt_s"] >= 1.0 and e["bucket_cap"] == e["cap_before"] // 2
        for e in stall["straggler_events"]), stall["straggler_events"]


def test_serving_bench_gate_flags_a_leak():
    from repro_torch.bench.serving_bench import gate
    cell = dict(scenario="preempt", requests=4, completed=2, failed=0,
                deadline_missed=0, queue_rejected=1, deadline_miss_rate=0.0,
                p50_ms=5.0, p99_ms=4.0, injected_faults=1, retries=0,
                preempted_inflight=2, resumed_requests=1, completed_gen1=1,
                completed_gen2=0)
    bad = gate([cell])
    assert len(bad) == 5, bad

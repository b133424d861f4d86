"""Raw ``jax.random`` keys on the port's ``SortServer.submit`` (ROADMAP.md
Queue C11), on the CPU.

* ``threefry.fold_in`` is ``jax.random.fold_in``, bitwise, in both counter
  layouts.
* A raw-key request draws the reference server's restart chain ``[key] +
  split(fold_in(key, 1), S - 1)``: one restart is bitwise the port's
  ``shuffle_soft_sort(key=)``; two restarts start from the reference's
  keys and, with the std term off, finish with the reference server's
  orders and losses within rtol 1e-5.
* Keys are validated at ``submit``; an admission that raises resolves
  its future with ``RequestFailed`` and keeps the accounting whole.
* The CLI submits ``prng_key(i)``, as the reference's submits
  ``PRNGKey(i)``.
"""
from __future__ import annotations

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ThreefryShuffleSource,
    TorchShuffleSource,
)
from repro_torch.core.shufflesoftsort import (  # noqa: E402
    ShuffleSoftSortConfig,
    run_round_segment,
    shuffle_soft_sort,
)
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    RequestFailed,
    SortServer,
    restart_keys,
)

N, HW, D = 16, (4, 4), 2
CFG = ShuffleSoftSortConfig(rounds=4, inner_steps=2, chunk=16)
LOSS_RTOL = 1e-5


def _problems(count, seed=0):
    return np.random.RandomState(seed).rand(count, N, D).astype(np.float32)


def _server(cfg=CFG, **kw):
    return SortServer(HW, d=D, cfg=cfg, device="cpu", **kw)


def _drain(server, max_ticks=64):
    for _ in range(max_ticks):
        with server._cv:
            if not server._pending and not server._active:
                return
        server._tick()
    raise AssertionError("server did not drain")


def _accounting_holds(server, offered):
    st = server.stats
    assert (st["completed"] + st["failed"] + st["deadline_missed"]
            + st["queue_rejected"]) == offered == st["requests"], st


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed,data", [(0, 1), (7, 0), (2**31 + 5, 123456),
                                       (42, 2**32 - 1)])
def test_fold_in_is_jax_bitwise(partitionable, seed, data):
    with jax.threefry_partitionable(partitionable):
        want = np.asarray(jax.random.fold_in(jax.random.PRNGKey(seed), data))
    got = threefry.fold_in(threefry.prng_key(seed), data, device="cpu")
    np.testing.assert_array_equal(threefry.key_data(got), want)


def test_fold_in_takes_a_batch_of_keys():
    keys = threefry.split(threefry.prng_key(3), 4, device="cpu")
    got = threefry.fold_in(keys, 9)
    for i in range(4):
        want = jax.random.fold_in(jnp.asarray(threefry.key_data(keys[i])), 9)
        np.testing.assert_array_equal(threefry.key_data(got[i]),
                                      np.asarray(want))


@pytest.mark.parametrize("restarts", [1, 2, 5])
def test_restart_keys_are_the_reference_servers_chain(restarts):
    base = jax.random.PRNGKey(11)
    want = (base[None] if restarts == 1 else jnp.concatenate(
        [base[None], jax.random.split(jax.random.fold_in(base, 1),
                                      restarts - 1)]))
    got = restart_keys(threefry.prng_key(11), restarts, "cpu")
    np.testing.assert_array_equal(threefry.key_data(got), np.asarray(want))


def test_one_restart_raw_key_request_is_the_keyed_solo_run():
    """Bitwise ``shuffle_soft_sort(key=)`` at the server's norm: one rung
    of the whole schedule, and chained rungs of one round."""
    x = _problems(1)[0]
    want = shuffle_soft_sort(x, HW, CFG, key=threefry.prng_key(7),
                             device="cpu")
    for rungs in (1, 4):
        server = _server(max_batch=4, sched_rungs=rungs, autostart=False)
        fut = server.submit(x, key=threefry.prng_key(7))
        _drain(server)
        server.close()
        order, sorted_x, losses = fut.result(timeout=0)
        np.testing.assert_array_equal(order, want[0])
        np.testing.assert_array_equal(sorted_x, want[1])
        np.testing.assert_array_equal(losses,
                                      np.asarray(want[2], np.float32))


@pytest.mark.parametrize("key", [
    np.array([0, 7], np.uint32),
    np.array([0, 7], np.int64),
    torch.tensor([0, 7]),
    [0, 7],
])
def test_raw_key_forms_are_one_key(key):
    """uint32 or int64 numpy data, an integer tensor or a list: the same
    request."""
    x = _problems(1)[0]
    server = _server(autostart=False)
    fut = server.submit(x, key=key)
    _drain(server)
    server.close()
    want = shuffle_soft_sort(x, HW, CFG, key=threefry.prng_key(7),
                             device="cpu")
    np.testing.assert_array_equal(fut.result(timeout=0)[0], want[0])


def test_two_restart_request_follows_the_reference_server():
    """The reference's server and the port's, one 2-restart request each
    on the same raw key: the port's streams start at the reference's
    chain (a round of them is ``jax.random.permutation`` of each key's
    split), and with the std term off the served orders are equal and
    the losses within rtol 1e-5."""
    from repro.core.shufflesoftsort import ShuffleSoftSortConfig as JConfig
    cfg_kw = dict(rounds=4, inner_steps=2, chunk=16, lambda_sigma=0.0)
    x = _problems(1, seed=5)[0]
    base = jax.random.PRNGKey(21)
    chain = jnp.concatenate([base[None], jax.random.split(
        jax.random.fold_in(base, 1), 1)])

    port = _server(ShuffleSoftSortConfig(**cfg_kw), n_restarts=2,
                   autostart=False)
    fut = port.submit(x, key=threefry.prng_key(21))
    req = port._pending[0]
    port._admit(req)
    assert isinstance(req.src, ThreefryShuffleSource)
    np.testing.assert_array_equal(req.src.state_dict(), np.asarray(chain))
    first = req.src.fork().next_round().numpy()
    for s in range(2):
        sub = jax.random.split(chain[s])[1]
        np.testing.assert_array_equal(
            first[s], np.asarray(jax.random.permutation(sub, N)))
    _drain(port)
    port.close()

    ref = jserve.SortServer(HW, d=D, cfg=JConfig(**cfg_kw), n_restarts=2,
                            autostart=False)
    rfut = ref.submit(x, key=base)
    _drain(ref)
    ref.close()
    (ot, _, lt), (oj, _, lj) = fut.result(timeout=0), rfut.result(timeout=0)
    np.testing.assert_array_equal(ot, np.asarray(oj))
    np.testing.assert_allclose(lt, np.asarray(lj), rtol=LOSS_RTOL)


def test_int_keys_keep_their_torch_streams():
    """An int key is still the seed of ``TorchShuffleSource`` streams."""
    server = _server(n_restarts=2, autostart=False)
    server.submit(_problems(1)[0], key=5)
    req = server._pending[0]
    server._admit(req)
    server.close()
    assert isinstance(req.src, TorchShuffleSource)


@pytest.mark.parametrize("key,exc", [
    (np.array([0.5, 1.0]), TypeError),
    (np.array([1, 2, 3], np.uint32), ValueError),
    (np.array([[0, 1]], np.uint32), ValueError),
    (np.array([-1, 2]), ValueError),
    ([0, 2**33], ValueError),
    (torch.tensor([0.0, 1.0]), TypeError),
    ("seed", TypeError),
    (1.5, TypeError),
    (True, TypeError),
    (object(), TypeError),
])
def test_bad_keys_raise_at_submit(key, exc):
    server = _server(autostart=False)
    with pytest.raises(exc):
        server.submit(_problems(1)[0], key=key)
    server.close()
    assert server.stats["requests"] == 0


def test_shuffle_source_key_needs_its_restart_count():
    server = _server(n_restarts=2, autostart=False)
    with pytest.raises(ValueError, match="n_restarts"):
        server.submit(_problems(1)[0],
                      key=TorchShuffleSource([1, 2, 3], N, "cpu"))
    server.close()


def test_failing_admission_resolves_the_tick_typed():
    """An ``_admit`` that raises fails every request it admitted that
    tick with ``RequestFailed`` (the scheduler thread running), within a
    timeout; the accounting stays whole and the server keeps serving."""
    server = _server(max_batch=4, max_wait_ms=0.0)
    boom = threading.Event()
    real = server._admit

    def admit(req):
        if not boom.is_set():
            boom.set()
            raise RuntimeError("injected admission fault")
        return real(req)

    server._admit = admit
    xs = _problems(3)
    futs = [server.submit(x, key=i) for i, x in enumerate(xs[:2])]
    for f in futs:
        with pytest.raises(RequestFailed, match="admission failed"):
            f.result(timeout=10)
    ok = server.submit(xs[2], key=threefry.prng_key(2))
    assert ok.result(timeout=30)[0].shape == (N,)
    server.close()
    _accounting_holds(server, 3)
    assert server.stats["failed"] == 2 and server.stats["completed"] == 1


def test_the_cli_submits_raw_keys(monkeypatch):
    seen = []
    real = SortServer.submit

    def submit(self, x, key=None, **kw):
        seen.append(key)
        return real(self, x, key=key, **kw)

    monkeypatch.setattr(SortServer, "submit", submit)
    tserve.main(["--workload", "sort", "--device", "cpu", "--requests", "2",
                 "--sort-n", "16", "--sort-hw", "4", "--sort-d", "2",
                 "--rounds", "2"])
    assert len(seen) == 2
    for i, key in enumerate(seen):
        np.testing.assert_array_equal(key, threefry.prng_key(i))


def test_raw_key_requests_survive_a_warm_handoff(tmp_path):
    """A raw-key request preempted before admission is handed off on disk
    with its key and finishes, in the successor, as its solo keyed run."""
    x = _problems(1)[0]
    server = _server(autostart=False, checkpoint_dir=str(tmp_path))
    server.submit(x, key=threefry.prng_key(4))
    server.close(drain=False)
    succ = _server(autostart=False, resume=str(tmp_path))
    _drain(succ)
    succ.close()
    want = shuffle_soft_sort(x, HW, CFG, key=threefry.prng_key(4),
                             device="cpu")
    got = succ.resumed[0].future.result(timeout=0)
    np.testing.assert_array_equal(got[0], want[0])


def test_solo_segments_reproduce_the_keyed_run():
    """The chain of the one-restart request, as segments: the keyed
    source run through ``run_round_segment`` is the keyed engine run."""
    x = _problems(1, seed=2)[0]
    src = ThreefryShuffleSource(restart_keys(threefry.prng_key(8), 1, "cpu"),
                                N, "cpu")
    from repro_torch.core.losses import mean_pairwise_distance
    norm = np.float32(mean_pairwise_distance(torch.as_tensor(x)))
    o, _ = run_round_segment(x[None], np.arange(N)[None], [norm], [0],
                             CFG.rounds, source=src, hw=HW, cfg=CFG,
                             device="cpu")
    want = shuffle_soft_sort(x, HW, CFG, key=threefry.prng_key(8),
                             device="cpu")
    np.testing.assert_array_equal(o.numpy()[0], want[0])

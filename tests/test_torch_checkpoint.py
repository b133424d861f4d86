"""Checkpoint and resume in the port (``repro_torch.runtime.checkpoint``,
``repro_torch.runtime.anneal_checkpoint``, the engines' ``checkpoint_dir=``
/ ``resume=`` / ``rung_hook=`` knobs and ``AnnealSupervisor``), on the CPU.

* ``CheckpointManager`` and ``AnnealCheckpointer``: the counterparts of
  the reference's unit tests, and format parity both ways: a flat dict
  written by ``repro.runtime.checkpoint.CheckpointManager`` restores in
  the port with the same leaves and dtypes, and the reverse.
* The shuffle sources' state: a round trip is bitwise, and a state of
  another device type is refused with a ``ValueError``.
* Kill at every rung, within the port, bitwise: a ``FaultInjector`` as
  ``rung_hook`` raises a ``WorkerFailure`` at the top of rung k, an
  ``AnnealSupervisor`` resumes from the newest checkpoint, and the result
  is bitwise the uninterrupted run's, on every engine path: sequential,
  batched fixed (dense and banded, plain and kernel tier), adaptive, and
  the tournament on both schedules.  A checkpointed run is bitwise the
  run without checkpoints.
* Carry across: a reference run killed at a rung continues in the port
  from its checkpoint directory (``repro_torch.core.reference``), each
  instance's remaining shuffles replayed from the checkpoint's keys or,
  on every engine kind, drawn from those keys themselves
  (``ThreefryShuffleSource``), and matches the reference's uninterrupted
  remainder per round: orders equal, losses within rtol 1e-5, with
  ``lambda_sigma=0`` (ROADMAP.md Queue C1).
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core.losses import mean_pairwise_distance as jmpd  # noqa: E402
from repro.runtime.anneal_checkpoint import (  # noqa: E402
    AnnealCheckpointer as JAnnealCheckpointer,
)
from repro.runtime.checkpoint import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from repro.runtime.fault_tolerance import (  # noqa: E402
    FaultInjector as JFaultInjector,
    WorkerFailure as JWorkerFailure,
)
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ReplayShuffleSource,
    TorchShuffleSource,
)
from repro_torch.core.reference import (  # noqa: E402
    carry_reference_checkpoint,
    config_from_reference,
    controller_state_from_reference,
    read_reference_checkpoint,
    state_from_reference,
)
from repro_torch.core.shufflesoftsort import (  # noqa: E402
    NumericalDivergence,
    ShuffleSoftSortConfig,
    restart_tournament,
    shuffle_soft_sort,
    shuffle_soft_sort_batched,
)
from repro_torch.runtime.anneal_checkpoint import (  # noqa: E402
    AnnealCheckpointer,
)
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    AnnealSupervisor,
    DivergencePolicy,
    FaultInjector,
    RetryPolicy,
    WorkerFailure,
)

N, HW, D = 16, (4, 4), 2
CFG = ShuffleSoftSortConfig(rounds=4, inner_steps=2, chunk=16)
ACFG = ShuffleSoftSortConfig(rounds=8, inner_steps=2, chunk=16,
                             schedule="adaptive", patience=1,
                             plateau_rtol=1.0, adapt_every=2)
CPU = dict(device="cpu")


def _x(seed=0, b=None, n=N):
    rng = np.random.default_rng(seed)
    shape = (n, D) if b is None else (b, n, D)
    return rng.standard_normal(shape).astype(np.float32)


def _fast_retry():
    return RetryPolicy(max_retries=3, backoff_base_s=0.0)


# ------------------------------------------------------ CheckpointManager

def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 8, generator=g),
            "opt": (torch.zeros(8, 8), np.int32(3)),
            "blocks": ({"a": np.ones((2, 3), np.float32)},)}


def _leaves(tree):
    from repro_torch.tree import flatten as _flatten
    return [np.asarray(a) if not isinstance(a, torch.Tensor)
            else a.numpy() for a in _flatten(tree)[0]]


def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    st = _state()
    mgr.save(10, st)
    restored, step = mgr.restore(st)
    assert step == 10
    assert isinstance(restored["w"], torch.Tensor)
    assert isinstance(restored["opt"], tuple)
    for a, b in zip(_leaves(st), _leaves(restored)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_checkpoint_keep_k_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state())
    assert mgr.all_steps() == [3, 4]


def test_checkpoint_atomic_no_partial_on_existing(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _state())
    # A tmp dir of an interrupted save must not shadow a published one.
    os.makedirs(tmp_path / "tmp-99", exist_ok=True)
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(_state())
    assert restored is not None


def test_checkpoint_async_save_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=True)
    for s in range(1, 6):
        mgr.save(s, _state())
    mgr.wait()
    assert mgr.all_steps() == [4, 5]
    assert not [n for n in os.listdir(tmp_path) if n.startswith("tmp-")]
    _, step = mgr.restore(_state())
    assert step == 5


def test_checkpoint_stale_tmp_swept_on_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _state())
    os.makedirs(tmp_path / "tmp-2")
    with open(tmp_path / "tmp-2" / "arrays.npz", "w") as f:
        f.write("half-written garbage")
    mgr2 = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    assert not (tmp_path / "tmp-2").exists()
    assert mgr2.latest_step() == 1
    assert mgr2.restore(_state())[0] is not None


def test_checkpoint_restore_num_leaves_mismatch_is_typed(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(1, _state())
    with pytest.raises(ValueError, match="layout changed"):
        mgr.restore(dict(_state(), extra_leaf=np.zeros(2)))


def test_checkpoint_restore_casts_to_like(tmp_path):
    """A like-leaf with a dtype casts (a tensor comes back a tensor of its
    dtype), a plain int leaves the stored array uncast."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    st = {"w": np.arange(4, dtype=np.float32),
          "k": np.array([1, 2], np.uint32),
          "t": np.arange(3, dtype=np.int32)}
    mgr.save(1, st)
    like = {"w": np.zeros(4, np.float64), "k": 0,
            "t": torch.zeros(3, dtype=torch.int64)}
    restored, _ = mgr.restore(like)
    assert restored["w"].dtype == np.float64
    assert restored["k"].dtype == np.uint32
    assert restored["t"].dtype == torch.int64
    np.testing.assert_array_equal(restored["w"], st["w"])
    np.testing.assert_array_equal(restored["k"], st["k"])
    np.testing.assert_array_equal(restored["t"].numpy(), st["t"])


FLAT = {"orders": np.arange(12, dtype=np.int32).reshape(3, 4),
        "keys": np.array([[3, 5], [7, 9]], np.uint32),
        "losses": np.array([[1.5, np.nan]], np.float32),
        "source": np.arange(10, dtype=np.uint8).reshape(2, 5),
        "alive": np.array([[0, 2]], np.int64),
        "mask": np.array([True, False])}


def test_format_parity_reference_writes_port_reads(tmp_path):
    JCheckpointManager(str(tmp_path), async_save=False).save(3, FLAT)
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    got, step = mgr.restore({k: 0 for k in FLAT})
    assert step == 3 and sorted(got) == sorted(FLAT)
    for k, v in FLAT.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v)


def test_format_parity_port_writes_reference_reads(tmp_path):
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(3, FLAT)
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(3, FLAT)
    got, step = JCheckpointManager(str(tmp_path / "p")).restore(
        {k: 0 for k in FLAT})
    assert step == 3
    for k, v in FLAT.items():
        assert np.asarray(got[k]).dtype == v.dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), v)
    # The manifests agree but for the write time.
    man = [CheckpointManager(str(tmp_path / d)).manifest() for d in "pj"]
    for m in man:
        m.pop("time")
    assert man[0] == man[1]


# bfloat16 leaves (ROADMAP.md Queue C13): the reference stores a bfloat16
# array as a 2-byte void ``|V2`` entry; the port writes the same bytes and
# restores them, and the reference's own file, bit for bit.

def _bf16_values():
    rng = np.random.default_rng(7)
    return (rng.normal(size=(5, 3)) * 3).astype(np.float32)


def _npz(d):
    path = os.path.join(d, "step-000000001", "arrays.npz")
    with open(path, "rb") as f:
        return f.read(), np.load(path)["leaf_00000"].dtype


def test_bf16_leaf_file_is_the_references(tmp_path):
    v = _bf16_values()
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(
        1, {"w": jnp.asarray(v, jnp.bfloat16)})
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(
        1, {"w": torch.from_numpy(v).to(torch.bfloat16)})
    (jb, jdt), (pb, pdt) = _npz(tmp_path / "j"), _npz(tmp_path / "p")
    assert jdt.str == pdt.str == "|V2"
    assert pb == jb


def test_bf16_checkpoint_of_the_reference_restores_bitwise(tmp_path):
    v = jnp.asarray(_bf16_values(), jnp.bfloat16)
    JCheckpointManager(str(tmp_path), async_save=False).save(1, {"w": v})
    got, _ = CheckpointManager(str(tmp_path)).restore(
        {"w": torch.zeros(5, 3, dtype=torch.bfloat16)})
    assert got["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["w"].view(torch.int16).numpy(),
                                  np.asarray(v).view(np.int16))


def test_bf16_roundtrip_is_bitwise(tmp_path):
    from repro_torch.optim import adam_init
    w = torch.from_numpy(_bf16_values()).to(torch.bfloat16)
    state = {"params": {"w": w, "b": torch.arange(3.0)},
             "opt": adam_init({"w": w, "b": torch.arange(3.0)},
                              torch.bfloat16)}
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(4, state)
    mgr.wait()
    got, step = mgr.restore(state)
    assert step == 4 and type(got["opt"]).__name__ == "AdamState"
    from repro_torch.tree import leaves
    for a, b in zip(leaves(got), leaves(state)):
        assert a.dtype == b.dtype
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    with pytest.raises(ValueError, match="bfloat16"):
        mgr.restore({"params": {"w": torch.zeros(5, 3), "b": 0},
                     "opt": state["opt"]})


def test_named_tuple_state_renders_as_jax_treedef(tmp_path):
    from repro.optim.adam import adam_init as jadam_init
    from repro_torch.optim import adam_init
    CheckpointManager(str(tmp_path / "p"), async_save=False).save(
        1, {"params": {"w": torch.ones(3)},
            "opt": adam_init({"w": torch.ones(3)})})
    JCheckpointManager(str(tmp_path / "j"), async_save=False).save(
        1, {"params": {"w": jnp.ones(3)}, "opt": jadam_init({"w": jnp.ones(3)})})
    man = [CheckpointManager(str(tmp_path / d)).manifest() for d in "pj"]
    assert man[0]["treedef"] == man[1]["treedef"]
    assert man[0]["num_leaves"] == man[1]["num_leaves"] == 4


def test_reference_cannot_restore_its_own_bf16_leaf(tmp_path):
    """ROADMAP.md known property 9: the reference writes a bfloat16 leaf
    but its restore casts the stored ``|V2`` array with ``np.asarray(a,
    dtype=bfloat16)``, which has no cast from void."""
    mgr = JCheckpointManager(str(tmp_path), async_save=False)
    v = jnp.asarray(_bf16_values(), jnp.bfloat16)
    mgr.save(1, {"w": v})
    with pytest.raises(ValueError, match="No cast function"):
        mgr.restore({"w": v})


# ------------------------------------------------------ AnnealCheckpointer

def test_anneal_checkpointer_roundtrip(tmp_path):
    ck = AnnealCheckpointer(str(tmp_path))
    state = {"orders": np.arange(N, dtype=np.int32),
             "source": np.arange(16, dtype=np.uint8).reshape(1, 16),
             "losses": np.array([1.5, np.nan], np.float32)}
    ck.save(2, state, meta={"engine": "test", "rounds": 4})
    ck.save(3, {k: v + 0 for k, v in state.items()},
            meta={"engine": "test", "rounds": 4})
    assert ck.latest_round() == 3
    got, rnd, meta = ck.restore_latest(expect={"engine": "test"})
    assert rnd == 3 and meta["rounds"] == 4
    for k in state:
        assert got[k].dtype == state[k].dtype, k
        np.testing.assert_array_equal(got[k], state[k])


def test_anneal_checkpointer_empty_dir_returns_none(tmp_path):
    assert AnnealCheckpointer(str(tmp_path)).restore_latest() is None


def test_anneal_checkpointer_fingerprint_mismatch(tmp_path):
    ck = AnnealCheckpointer(str(tmp_path))
    ck.save(1, {"orders": np.arange(N)}, meta={"engine": "batched",
                                               "n": N, "rounds": 4,
                                               "hw": (4, 4)})
    with pytest.raises(ValueError, match="does not match"):
        ck.restore_latest(expect={"rounds": 8})
    with pytest.raises(ValueError, match="does not match"):
        ck.restore_latest(expect={"engine": "sequential"})
    assert ck.restore_latest(expect={"engine": "batched", "n": N,
                                     "hw": (4, 4)})


def test_reference_anneal_checkpoint_reads_in_port(tmp_path):
    state = {"orders": np.arange(N, dtype=np.int32)[None],
             "keys": np.array([[3, 5]], np.uint32),
             "losses": np.array([[1.5], [1.25]], np.float32)}
    JAnnealCheckpointer(str(tmp_path)).save(2, state,
                                            meta={"engine": "batched"})
    got, rnd, meta = read_reference_checkpoint(tmp_path,
                                               {"engine": "batched"})
    assert rnd == 2 and meta["engine"] == "batched"
    for k, v in state.items():
        assert got[k].dtype == v.dtype
        np.testing.assert_array_equal(got[k], v)


def test_resume_against_wrong_problem_is_typed_error(tmp_path):
    shuffle_soft_sort(_x(), HW, CFG, seed=0, checkpoint_dir=str(tmp_path),
                      checkpoint_every=1, **CPU)
    wrong = dataclasses.replace(CFG, rounds=8)
    with pytest.raises(ValueError, match="does not match"):
        shuffle_soft_sort(_x(), HW, wrong, seed=0, resume=True,
                          checkpoint_dir=str(tmp_path), **CPU)
    with pytest.raises(ValueError, match="requires checkpoint_dir"):
        shuffle_soft_sort(_x(), HW, CFG, resume=True, **CPU)


def test_card_checkpoint_does_not_resume_on_a_cpu_source(tmp_path):
    """A checkpoint whose generator states were taken on the card (its
    fingerprint says ``torch:cuda``) is refused by a CPU run, and a card
    state never loads into a CPU generator."""
    xs = _x(1, b=1)
    shuffle_soft_sort_batched(xs, HW, CFG, checkpoint_dir=str(tmp_path),
                              checkpoint_every=2, **CPU)
    ck = AnnealCheckpointer(str(tmp_path))
    state, rnd, meta = ck.restore_latest()
    assert meta["source"] == "torch:cpu"
    card = np.zeros((1, 16), np.uint8)          # a Philox seed and offset
    ck.save(rnd + 1, dict(state, source=card),
            meta=dict(meta, source="torch:cuda"))
    with pytest.raises(ValueError, match="source"):
        shuffle_soft_sort_batched(xs, HW, CFG, checkpoint_dir=str(tmp_path),
                                  resume=True, **CPU)
    with pytest.raises(ValueError, match="uint8 state"):
        TorchShuffleSource([0], N, "cpu").load_state_dict(card)


# ------------------------------------------------------- source state

def test_torch_source_state_roundtrip_is_bitwise():
    src = TorchShuffleSource([5, 6, 7], N, "cpu")
    src.next_round([0, 2])
    st = src.state_dict()
    assert st.dtype == np.uint8 and st.shape[0] == 3
    want = [src.next_round() for _ in range(3)]
    src.load_state_dict(st)
    for w in want:
        assert torch.equal(src.next_round(), w)
    fork = src.fork(st)
    for w in want:
        assert torch.equal(fork.next_round(), w)
    # advanced() is the state the draws leave, and leaves src alone
    adv = src.advanced(st, [1], 2)
    src.load_state_dict(st)
    src.next_round([1])
    src.next_round([1])
    np.testing.assert_array_equal(adv, src.state_dict())


def test_replay_source_state_roundtrip():
    sh = np.stack([np.stack([np.random.default_rng(t * 3 + i).permutation(N)
                             for i in range(3)]) for t in range(4)])
    src = ReplayShuffleSource(sh, "cpu")
    src.next_round([1])
    st = src.state_dict()
    np.testing.assert_array_equal(st, [0, 1, 0])
    np.testing.assert_array_equal(src.advanced(st, [0, 1], 2), [2, 3, 0])
    fork = src.fork()
    assert torch.equal(fork.next_round(), src.next_round())
    with pytest.raises(ValueError):
        src.load_state_dict(np.zeros(2, np.int64))


# ---------------------------------------------- kill at every rung, bitwise

def _count_rungs(run):
    calls = []
    run(rung_hook=calls.append)
    return len(calls)


def _sweep(run, result_fields, tmp_path):
    """An uninterrupted run, then a kill at every rung index: the
    supervised resume is bitwise on every field."""
    ref = result_fields(run())
    n_rungs = _count_rungs(run)
    assert n_rungs >= 2, n_rungs
    for k in range(n_rungs):
        hook = FaultInjector(lambda r: None, fail_calls={k})
        sup = AnnealSupervisor(
            lambda xs, hw, cfg, **kw: run(**kw),
            checkpoint_dir=str(tmp_path / f"kill{k}"), retry=_fast_retry())
        got = result_fields(sup.run(None, HW, CFG, rung_hook=hook))
        assert hook.faults == 1, (k, hook.faults)
        assert sup.stats["restarts"] == 1
        for name, a in ref.items():
            np.testing.assert_array_equal(
                a, got[name], err_msg=f"kill at rung {k}: field {name}")


def test_sequential_kill_at_every_rung(tmp_path):
    x = _x()

    def run(**kw):
        return shuffle_soft_sort(x, HW, CFG, seed=7, checkpoint_every=1,
                                 **CPU, **kw)

    _sweep(run, lambda r: {"order": r[0], "losses": np.asarray(r[2])},
           tmp_path)


@pytest.mark.parametrize("band,use_kernel", [
    (None, False), (None, True), (4, False), (4, True)],
    ids=["dense-plain", "dense-kernel", "banded-plain", "banded-kernel"])
def test_batched_kill_at_every_rung(tmp_path, band, use_kernel):
    xs = _x(1, b=3)
    cfg = dataclasses.replace(CFG, band=band, use_kernel=use_kernel,
                              band_eps=1e3)
    if band is not None:       # banded from round 2 on: both regimes run
        assert teng._band_switch_round(cfg, N) == 0
        cfg = dataclasses.replace(cfg, band_eps=1e-2)
        assert 0 < teng._band_switch_round(cfg, N) < cfg.rounds

    def run(**kw):
        return shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=2, seed=11,
                                         checkpoint_every=1, **CPU, **kw)

    _sweep(run, lambda r: {"all_orders": r.all_orders,
                           "all_losses": r.all_losses,
                           "best_restart": r.best_restart}, tmp_path)


def test_adaptive_kill_at_every_rung(tmp_path):
    xs = _x(2, b=3)

    def run(**kw):
        return shuffle_soft_sort_batched(xs, HW, ACFG, n_restarts=2,
                                         seed=13, **CPU, **kw)

    _sweep(run, lambda r: {"all_orders": r.all_orders,
                           "all_losses": r.all_losses,
                           "rounds_executed": r.rounds_executed}, tmp_path)


@pytest.mark.parametrize("cfg,kw", [(CFG, dict(n_rungs=2)),
                                    (ACFG, dict())],
                         ids=["fixed", "adaptive"])
def test_tournament_kill_at_every_rung(tmp_path, cfg, kw):
    x = _x(3)

    def run(**extra):
        return restart_tournament(x[None], HW, cfg, n_restarts=4, seed=17,
                                  **CPU, **kw, **extra)

    def fields(r):
        out = {"order": r.order, "all_losses": r.all_losses,
               "rounds_run": np.asarray(r.rounds_run),
               "best_restart": r.best_restart}
        for i, surv in enumerate(r.survivors):
            out[f"survivors_{i}"] = surv
        return out

    _sweep(run, fields, tmp_path)


def test_checkpointed_run_is_bitwise_the_unchecked_run(tmp_path):
    xs = _x(4, b=2)
    cfg = dataclasses.replace(CFG, rounds=8)
    ref = shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=2, **CPU)
    for every in (None, 3):
        got = shuffle_soft_sort_batched(
            xs, HW, cfg, n_restarts=2, checkpoint_every=every,
            checkpoint_dir=str(tmp_path / f"e{every}"), **CPU)
        np.testing.assert_array_equal(ref.all_orders, got.all_orders)
        np.testing.assert_array_equal(ref.all_losses, got.all_losses)
    # default checkpoint_every is rounds // 8
    assert CheckpointManager(str(tmp_path / "eNone")).all_steps() == \
        [6, 7, 8]


def test_resume_skips_completed_rounds(tmp_path):
    xs = _x(5, b=2)
    shuffle_soft_sort_batched(xs, HW, CFG, checkpoint_dir=str(tmp_path),
                              checkpoint_every=2, **CPU)
    calls = []
    res = shuffle_soft_sort_batched(xs, HW, CFG, checkpoint_dir=str(tmp_path),
                                    checkpoint_every=2, resume=True,
                                    rung_hook=calls.append, **CPU)
    assert calls == []
    ref = shuffle_soft_sort_batched(xs, HW, CFG, **CPU)
    np.testing.assert_array_equal(ref.all_orders, res.all_orders)


def test_preempted_process_resumes_from_the_directory(tmp_path):
    """A run whose process dies at rung 2 (the exception leaves it, no
    supervisor) and a fresh call with resume=True: bitwise."""
    xs = _x(6, b=2)
    ref = shuffle_soft_sort_batched(xs, HW, CFG, n_restarts=2, **CPU)
    with pytest.raises(WorkerFailure):
        shuffle_soft_sort_batched(
            xs, HW, CFG, n_restarts=2, checkpoint_dir=str(tmp_path),
            checkpoint_every=1, rung_hook=FaultInjector(
                lambda r: None, fail_calls={2}), **CPU)
    assert AnnealCheckpointer(str(tmp_path)).latest_round() == 2
    res = shuffle_soft_sort_batched(xs, HW, CFG, n_restarts=2,
                                    checkpoint_dir=str(tmp_path),
                                    checkpoint_every=1, resume=True, **CPU)
    np.testing.assert_array_equal(ref.all_orders, res.all_orders)
    np.testing.assert_array_equal(ref.all_losses, res.all_losses)


# ------------------------------------------------- divergence sentinels

def test_sentinel_raises_typed_divergence():
    bad = _x()
    bad[0, 0] = np.nan
    with pytest.raises(NumericalDivergence) as ei:
        shuffle_soft_sort(bad, HW, CFG, **CPU)
    assert ei.value.round == 0 and ei.value.dtype == "float32"
    assert np.isfinite(ei.value.tau)


def test_sentinel_fires_on_batched_and_tournament(tmp_path):
    bad = _x(1, b=2)
    bad[1, 3, 1] = np.inf
    with pytest.raises(NumericalDivergence):
        shuffle_soft_sort_batched(bad, HW, CFG, **CPU)
    with pytest.raises(NumericalDivergence):
        shuffle_soft_sort_batched(bad, HW, CFG, checkpoint_every=1,
                                  checkpoint_dir=str(tmp_path / "b"), **CPU)
    with pytest.raises(NumericalDivergence):
        restart_tournament(bad, HW, CFG, n_restarts=2, n_rungs=2, **CPU)
    with pytest.raises(NumericalDivergence):
        restart_tournament(bad, HW, CFG, n_restarts=2, n_rungs=2,
                           checkpoint_dir=str(tmp_path / "t"), **CPU)


def test_sentinel_opt_out():
    bad = _x()
    bad[0, 0] = np.nan
    order, _, losses = shuffle_soft_sort(bad, HW, CFG, check_finite=False,
                                         **CPU)
    assert len(order) == N
    assert not np.isfinite(losses).all()
    res = shuffle_soft_sort_batched(bad[None], HW, CFG, check_finite=False,
                                    **CPU)
    assert not np.isfinite(res.all_losses).all()


def test_supervisor_divergence_mid_run_resumes_from_checkpoint(tmp_path):
    """A divergence at rung 2: the supervisor degrades the config, and the
    retry replays only from the last finite rung."""
    xs = _x(6, b=2)
    cfg = dataclasses.replace(CFG, tau_end=0.01)
    state = {"fired": False}

    def hook(r):
        if r >= 2 and not state["fired"]:
            state["fired"] = True
            raise NumericalDivergence("injected", round=r, tau=0.1,
                                      dtype="float32")

    sup = AnnealSupervisor(checkpoint_dir=str(tmp_path),
                           degrade=DivergencePolicy(tau_floor=0.05),
                           retry=_fast_retry())
    res = sup.run(xs, HW, cfg, rung_hook=hook, checkpoint_every=1, **CPU)
    assert res.all_orders.shape == (2, 1, N)
    assert len(sup.stats["fallbacks"]) == 1
    ref = shuffle_soft_sort_batched(xs, HW, cfg, **CPU)
    np.testing.assert_array_equal(ref.all_losses[:, :, :2],
                                  res.all_losses[:, :, :2])


# ------------------------------------------------ carry a reference run over

LS0 = dict(lambda_sigma=0.0)


def _key_chain_shuffles(keys, rounds, n=N):
    """(R, BS, N): instance i's next shuffles from its own key chain."""
    out, k = [], jnp.asarray(keys)
    for _ in range(rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        out.append(np.stack([np.asarray(jax.random.permutation(sk, n))
                             for sk in subs]))
    return np.stack(out)


def _killed_reference_run(run, tmp_path, kill_at):
    with pytest.raises(JWorkerFailure):
        run(checkpoint_dir=str(tmp_path),
            rung_hook=JFaultInjector(lambda r: None, fail_calls={kill_at}))


def test_reference_checkpoint_continues_in_port_fixed(tmp_path):
    jcfg = jeng.ShuffleSoftSortConfig(rounds=6, inner_steps=2, chunk=16,
                                      **LS0)
    xs = _x(8, b=2)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    want = jeng.shuffle_soft_sort_batched(xs, HW, jcfg, keys=keys)
    _killed_reference_run(lambda **kw: jeng.shuffle_soft_sort_batched(
        xs, HW, jcfg, keys=keys, checkpoint_every=2, **kw), tmp_path, 2)
    state, rnd, meta = read_reference_checkpoint(tmp_path)
    assert rnd == 4 and meta["engine"] == "batched"
    src = ReplayShuffleSource(_key_chain_shuffles(state["keys"], 6 - rnd),
                              "cpu")
    got = shuffle_soft_sort_batched(
        xs, HW, config_from_reference(dataclasses.asdict(jcfg)),
        source=src, state=state_from_reference(state, "cpu"),
        norms=[float(jmpd(jnp.asarray(x))) for x in xs], **CPU)
    np.testing.assert_array_equal(got.all_losses[:, :, :rnd],
                                  want.all_losses[:, :, :rnd])
    np.testing.assert_array_equal(got.all_orders, want.all_orders)
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=1e-5)


def test_reference_checkpoint_continues_in_port_adaptive(tmp_path):
    jcfg = jeng.ShuffleSoftSortConfig(
        rounds=8, inner_steps=2, chunk=16, schedule="adaptive", patience=1,
        plateau_rtol=1.0, adapt_every=2, **LS0)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    xs = _x(9, b=2)
    keys = jax.random.split(jax.random.PRNGKey(4), 4)
    want = jeng.shuffle_soft_sort_batched(xs, HW, jcfg, n_restarts=2,
                                          keys=keys)
    _killed_reference_run(lambda **kw: jeng.shuffle_soft_sort_batched(
        xs, HW, jcfg, n_restarts=2, keys=keys, **kw), tmp_path / "j", 1)
    state, step, _ = read_reference_checkpoint(tmp_path / "j")
    ctrl = teng.make_adaptive_controller(cfg, 4, N)
    ctrl.load_state_dict(controller_state_from_reference(state))
    assert ctrl.live_indices().size > 0
    src = ReplayShuffleSource(_key_chain_shuffles(state["keys"], 8), "cpu")
    assert carry_reference_checkpoint(tmp_path / "j", tmp_path / "p",
                                      src) == step == 1
    got = shuffle_soft_sort_batched(
        xs, HW, cfg, n_restarts=2, source=src, resume=True,
        checkpoint_dir=str(tmp_path / "p"),
        norms=[float(jmpd(jnp.asarray(x))) for x in xs], **CPU)
    np.testing.assert_array_equal(got.rounds_executed, want.rounds_executed)
    np.testing.assert_array_equal(got.all_orders, want.all_orders)
    np.testing.assert_array_equal(np.isnan(got.all_losses),
                                  np.isnan(want.all_losses))
    np.testing.assert_allclose(got.all_losses, want.all_losses, rtol=1e-5)
    # the carried checkpoint is the port's own from then on
    _, last, meta = AnnealCheckpointer(str(tmp_path / "p")).restore_latest()
    assert last > step
    assert meta["source"] == "replay" and meta["engine"] == "adaptive"


def _carry_case(kind, xs, keys):
    """(reference run, port run, the reference's config) of one engine
    kind; each run takes the checkpoint knobs as keywords."""
    jkw = dict(rounds=6, inner_steps=2, chunk=16, **LS0)
    if kind == "adaptive":
        jkw.update(rounds=8, schedule="adaptive", patience=1,
                   plateau_rtol=1.0, adapt_every=2)
    jcfg = jeng.ShuffleSoftSortConfig(**jkw)
    cfg = config_from_reference(dataclasses.asdict(jcfg))
    norms = [float(jmpd(jnp.asarray(x))) for x in xs]
    if kind == "sequential":
        return (lambda **kw: jeng.shuffle_soft_sort(
                    xs[0], HW, jcfg, key=keys[0], checkpoint_every=2, **kw),
                lambda **kw: shuffle_soft_sort(
                    xs[0], HW, cfg, key=np.zeros(2, np.uint32),
                    checkpoint_every=2, norm=norms[0], **CPU, **kw))
    if kind == "tournament":
        return (lambda **kw: jeng.restart_tournament(
                    xs, HW, jcfg, n_restarts=4, keys=keys, n_rungs=3, **kw),
                lambda **kw: restart_tournament(
                    xs, HW, cfg, n_restarts=4, keys=np.zeros((8, 2)),
                    n_rungs=3, norms=norms, **CPU, **kw))
    extra = {} if kind == "adaptive" else dict(checkpoint_every=2)
    return (lambda **kw: jeng.shuffle_soft_sort_batched(
                xs, HW, jcfg, n_restarts=4, keys=keys, **extra, **kw),
            lambda **kw: shuffle_soft_sort_batched(
                xs, HW, cfg, n_restarts=4, keys=np.zeros((8, 2)),
                norms=norms, **extra, **CPU, **kw))


def _live_keys(state):
    """A newest checkpoint's keys of the instances that still draw."""
    keys = np.asarray(state["source"] if "source" in state else
                      state.get("keys", state.get("key"))).reshape(-1, 2)
    if "alive" in state and "source" in state:
        alive = np.asarray(state["alive"])
        s = keys.shape[0] // alive.shape[0]
        keys = keys[(np.arange(alive.shape[0])[:, None] * s
                     + alive).reshape(-1)]
    return keys


@pytest.mark.parametrize("kind", ["sequential", "batched", "adaptive",
                                  "tournament"])
def test_reference_checkpoint_continues_on_its_own_keys(tmp_path, kind):
    """No replay: the carried checkpoint keeps the reference's keys as a
    ``ThreefryShuffleSource`` state, and the port's resumed run goes on
    along the reference's key chains: its last checkpoint's keys are the
    uninterrupted reference run's, bitwise (the shuffles of every
    continued round), orders equal, losses within rtol 1e-5."""
    xs = _x(12, b=1 if kind == "sequential" else 2)
    keys = jax.random.split(jax.random.PRNGKey(6),
                            1 if kind == "sequential" else 8)
    ref, port = _carry_case(kind, xs, keys)
    ref(checkpoint_dir=str(tmp_path / "w"))
    want = ref()
    _killed_reference_run(ref, tmp_path / "j", 1)
    step = carry_reference_checkpoint(tmp_path / "j", tmp_path / "p")
    assert step >= 1
    _, _, meta = read_reference_checkpoint(tmp_path / "p")
    assert meta["source"] == "threefry"
    got = port(checkpoint_dir=str(tmp_path / "p"), resume=True)
    last_ref = read_reference_checkpoint(tmp_path / "w")[0]
    last_port = read_reference_checkpoint(tmp_path / "p")[0]
    np.testing.assert_array_equal(_live_keys(last_port),
                                  _live_keys(last_ref))
    if kind == "sequential":
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5)
        return
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_allclose(got.all_losses, np.asarray(want.all_losses),
                               rtol=1e-5)

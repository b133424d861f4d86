"""The trainer's runtime in the port against the reference, on the CPU:
gradient compression (``repro_torch.runtime.compression``), the
``TrainSupervisor`` and the train CLI (``repro_torch.launch.train``).

- Compression: given the same gradients and residuals, the dequantized
  gradients are bitwise the reference's and the new residuals within one
  ulp of ``g + r`` (XLA rounds ``gf - q * scale`` once, as an FMA, for
  most leaves, but not for all: it depends on its fusion); the stats are
  float32 sums in an order XLA picks, held to 1e-6 relative.  Then the
  reference's ``test_int8_error_feedback_reduces_bias`` and
  ``test_compressed_training_converges``.
- The supervisor: the reference's four cases (``tests/test_runtime.py``)
  on a quadratic, and a train run of the CLI's step with a failure
  injected after a checkpoint, which ends bitwise the uninterrupted run.
- The CLI (``--device cpu``): the loss falls at ``tiny``, ``--fail-at 15
  --ckpt-every 10`` restarts once and reaches 30, ``--compress-grads``
  falls; without ``--device`` and without a card it raises.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.runtime import compression as jcomp  # noqa: E402
from repro_torch.runtime import compression as tcomp  # noqa: E402
from repro_torch.runtime.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.runtime.fault_tolerance import (TrainSupervisor,  # noqa: E402
                                                 WorkerFailure)
from repro_torch.tree import leaves  # noqa: E402


# ------------------------------------------------------------ compression

def _grads(rng):
    a = (lambda *s: rng.normal(size=s).astype(np.float32))
    return {"w": a(257, 9), "nested": ({"v": a(31)}, [a(4, 3), a(1)])}


def test_compression_matches_the_reference():
    """Each step from the same gradients and the reference's residuals:
    the dequantized gradients bitwise; the new residuals within one ulp of
    ``g + r`` (``gf - q * scale`` is rounded once, as the FMA XLA emits
    for most leaves; for some small ones, (1,) and (4, 3) here, XLA's
    fusion rounds it otherwise)."""
    rng = np.random.default_rng(0)
    grads = [_grads(rng) for _ in range(3)]
    js = jcomp.init_compression(jax.tree.map(jnp.asarray, grads[0]))
    step = jax.jit(jcomp.compress_gradients)
    for g in grads:
        ts = tcomp.CompressionState(jax.tree.map(
            lambda r: torch.from_numpy(np.array(r)), js.residual))
        gf = [x + np.asarray(r) for x, r in zip(jax.tree.leaves(g),
                                                jax.tree.leaves(js.residual))]
        jd, js, jst = step(jax.tree.map(jnp.asarray, g), js)
        td, ts, tst = tcomp.compress_gradients(
            jax.tree.map(torch.from_numpy, g), ts)
        for a, b in zip(leaves(td), jax.tree.leaves(jd)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b, x in zip(leaves(ts.residual), jax.tree.leaves(js.residual),
                           gf):
            assert np.all(np.abs(a.numpy() - np.asarray(b))
                          <= np.spacing(np.abs(x)))
        for k in ("quant_mse", "grad_sq"):
            np.testing.assert_allclose(float(tst[k]), float(jst[k]),
                                       rtol=1e-6)
        assert tst["wire_bytes_ratio"] == jst["wire_bytes_ratio"]


def test_quant_leaf_keeps_the_gradient_dtype():
    g = torch.randn(64, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    deq, r, q, scale = tcomp._quant_leaf(g, torch.zeros(64))
    assert deq.dtype == torch.bfloat16 and r.dtype == torch.float32
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127


def test_int8_error_feedback_reduces_bias():
    g0 = torch.from_numpy(np.random.default_rng(0).normal(
        size=256).astype(np.float32))
    state = tcomp.init_compression({"w": g0})
    acc_raw = torch.zeros(256)
    acc_deq = torch.zeros(256)
    for i in range(50):
        g = {"w": g0 * (1.0 + 0.01 * i)}
        deq, state, _ = tcomp.compress_gradients(g, state)
        acc_raw += g["w"]
        acc_deq += deq["w"]
    # error feedback: accumulated compressed grads track accumulated raw
    rel = float(torch.linalg.norm(acc_deq - acc_raw)
                / torch.linalg.norm(acc_raw))
    assert rel < 1e-2, rel


def test_compressed_training_converges():
    target = torch.tensor([0.5, -1.5, 2.5, 0.0])
    w = torch.zeros(4)
    state = tcomp.init_compression({"w": w})
    for _ in range(300):
        g = {"w": 2 * (w - target)}
        deq, state, _ = tcomp.compress_gradients(g, state)
        w = w - 0.05 * deq["w"]
    assert float(torch.sum((w - target) ** 2)) < 1e-4


# ------------------------------------------------------------- supervisor

TARGET = torch.tensor([1.0, -2.0, 3.0])


def _quadratic_step(state, batch):
    w = state["w"]
    w = w - 0.1 * (2 * (w - TARGET))
    return {"w": w}, {"loss": torch.sum((w - TARGET) ** 2)}


def _sq_dist(state):
    return float(torch.sum((state["w"] - TARGET) ** 2))


def test_supervisor_runs_and_checkpoints(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    sup = TrainSupervisor(_quadratic_step, lambda s: None, mgr,
                          checkpoint_every=10)
    state, step_idx = sup.run({"w": torch.zeros(3)}, 0, 50)
    assert step_idx == 50
    assert mgr.latest_step() == 50
    assert _sq_dist(state) < 1e-3
    assert [h["step"] for h in sup.history if "metrics" in h] == list(
        range(1, 51))


def test_supervisor_recovers_from_failures(tmp_path):
    fail_at = {15, 27}
    calls = {"n": 0}

    def flaky_step(state, batch):
        calls["n"] += 1
        if calls["n"] in fail_at:
            raise WorkerFailure(f"injected at call {calls['n']}")
        return _quadratic_step(state, batch)

    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    sup = TrainSupervisor(flaky_step, lambda s: None, mgr,
                          checkpoint_every=5)
    state, step_idx = sup.run({"w": torch.zeros(3)}, 0, 40)
    assert step_idx == 40
    assert sup.restarts == 2
    assert _sq_dist(state) < 1e-3
    assert sum(h.get("event") == "failure" for h in sup.history) == 2


def test_supervisor_resumes_from_existing_checkpoint(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    sup = TrainSupervisor(_quadratic_step, lambda s: None, mgr,
                          checkpoint_every=10)
    sup.run({"w": torch.zeros(3)}, 0, 20)
    # a new supervisor on the same directory resumes at 20
    sup2 = TrainSupervisor(_quadratic_step, lambda s: None, mgr,
                           checkpoint_every=10)
    _, step_idx = sup2.run({"w": torch.zeros(3)}, 0, 30)
    assert step_idx == 30
    assert [h["step"] for h in sup2.history if "metrics" in h] == list(
        range(21, 31))


def test_supervisor_failure_before_first_checkpoint_restores_state(tmp_path):
    """A failure before any checkpoint replays from the initial state,
    not from the partly advanced one."""
    calls = {"n": 0}

    def counting_step(state, batch):
        calls["n"] += 1
        if calls["n"] == 3:                # fail before any checkpoint
            raise WorkerFailure("early failure")
        return {"count": state["count"] + 1}, {"count": state["count"]}

    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    sup = TrainSupervisor(counting_step, lambda s: None, mgr,
                          checkpoint_every=100)
    state, step_idx = sup.run({"count": torch.tensor(0, dtype=torch.int32)},
                              0, 10)
    assert step_idx == 10
    assert sup.restarts == 1
    assert int(state["count"]) == 10


def test_supervisor_exceeding_max_restarts_raises(tmp_path):
    def always(state, batch):
        raise WorkerFailure("down")

    sup = TrainSupervisor(always, lambda s: None,
                          CheckpointManager(str(tmp_path), async_save=False),
                          max_restarts=2)
    with pytest.raises(RuntimeError, match="exceeded 2 restarts"):
        sup.run({"w": torch.zeros(3)}, 0, 5)
    assert sup.restarts == 3


def _lm_run(tmp_path, fail_at, steps=12, ckpt_every=5, compress=False):
    from repro_torch.data import synthetic_batch
    from repro_torch.launch.train import build
    cfg, state, step = build("qwen1.5-0.5b", "tiny", 1e-3, compress, "cpu")
    armed = {"on": fail_at is not None}

    def step_fn(state, batch):
        if armed["on"] and int(batch.pop("step")) == fail_at:
            armed["on"] = False
            raise WorkerFailure("injected")
        batch.pop("step", None)
        return step(state, batch)

    def data_fn(i):
        return dict(synthetic_batch(cfg, 2, 16, i, device="cpu"), step=i)

    sup = TrainSupervisor(step_fn, data_fn,
                          CheckpointManager(str(tmp_path), async_save=True),
                          checkpoint_every=ckpt_every)
    state, n = sup.run(state, 0, steps)
    return state, n, sup


@pytest.mark.parametrize("compress", [False, True])
def test_failure_after_a_checkpoint_ends_bitwise_the_clean_run(tmp_path,
                                                               compress):
    """A failure at step 8 resumes from step 5's checkpoint (the
    parameters, Adam's moments and step, the residuals) and ends bitwise
    where the uninterrupted run ends."""
    clean, n0, _ = _lm_run(tmp_path / "a", None, compress=compress)
    failed, n1, sup = _lm_run(tmp_path / "b", 8, compress=compress)
    assert n0 == n1 == 12 and sup.restarts == 1
    assert [h["step"] for h in sup.history
            if h.get("event") == "failure"] == [8]
    for a, b in zip(leaves(clean), leaves(failed)):
        assert torch.equal(a, b)


# ------------------------------------------------------------------ CLI

def _main(tmp_path, *args):
    from repro_torch.launch.train import main
    return main(["--device", "cpu", "--preset", "tiny", "--ckpt-dir",
                 str(tmp_path), *args])


def test_train_driver_loss_decreases(tmp_path):
    stats = _main(tmp_path, "--steps", "40", "--batch", "4", "--seq", "32",
                  "--lr", "1e-3")
    assert stats["steps"] == 40
    assert stats["last_loss"] < stats["first_loss"]


def test_train_driver_failure_recovery(tmp_path, capsys):
    stats = _main(tmp_path, "--steps", "30", "--batch", "2", "--seq", "16",
                  "--fail-at", "15", "--ckpt-every", "10")
    assert stats["restarts"] == 1
    assert stats["steps"] == 30
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=qwen1.5-0.5b preset=tiny params=139,840"
    assert out[-1].startswith("done: 30 steps in ")
    assert "restarts=1, stragglers=" in out[-1]


def test_train_driver_with_compression(tmp_path):
    stats = _main(tmp_path, "--steps", "30", "--batch", "2", "--seq", "16",
                  "--compress-grads", "--lr", "1e-3")
    assert stats["last_loss"] < stats["first_loss"]


def test_train_driver_needs_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--preset", "tiny", "--steps", "2", "--ckpt-dir",
              str(tmp_path)])


def test_failure_during_an_async_save_resumes_from_it(tmp_path, monkeypatch):
    """A failure while the step-5 checkpoint is still being written waits
    for it and resumes from it (ROADMAP.md known property 10: the
    reference looks for a checkpoint before it waits, and replays from
    the initial state)."""
    import time

    from repro_torch.runtime import checkpoint as tckpt
    real = tckpt._savez

    def slow(path, arrays):
        time.sleep(0.3)
        real(path, arrays)

    monkeypatch.setattr(tckpt, "_savez", slow)
    calls = []

    def step(state, batch):
        calls.append(batch)
        if len(calls) == 7:                 # step 6, the save in flight
            raise WorkerFailure("injected")
        return _quadratic_step(state, batch)

    sup = TrainSupervisor(step, lambda s: s,
                          CheckpointManager(str(tmp_path), async_save=True),
                          checkpoint_every=5)
    state, n = sup.run({"w": torch.zeros(3)}, 0, 10)
    assert n == 10 and sup.restarts == 1
    assert calls == list(range(7)) + list(range(5, 10))

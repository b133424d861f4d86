"""The serving half of the port's guardrails (``SortServer(guardrail=)``
of ``repro_torch.launch.serve``), on the CPU: the serving cases of
``tests/test_guardrails.py`` on the port.

* The chaos grid: every ``FaultInjector`` value corruption (bit-flip,
  sign-flip, stale buffer, NaN splat) at the second dispatch of every
  serving path (plain tier, dense and banded kernel tier, bfloat16 kernel
  tier) under a rate-1 shadow is detected, repaired by a replay from the
  last verified boundary with no config change, and the result is bitwise
  the uninjected run of the same path.
* A dispatch that skips a shuffle draw fails the stream audit
  (``key_chain``); a kernel that is wrong on every call fails the
  shadow's apply check and self-heals to the plain tier; a clean request
  shadowed at rate 1 on the kernel tier has no incident (ROADMAP.md Queue
  C8, repaired) and is bitwise the unguarded one.
* Per-request guardrail override and opt-out, type validation, the
  injector cursor across a warm handoff on disk, and the CLI flags.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.shufflesoftsort import (  # noqa: E402
    ShuffleSoftSortConfig,
    run_round_segment,
)
from repro_torch.launch.serve import SortServer, WarmHandoff  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    CorruptionSpec,
    FaultInjector,
    RetryPolicy,
)
from repro_torch.runtime.guardrails import GuardrailPolicy  # noqa: E402

N, HW, D = 16, (4, 4), 3
FULL_SHADOW = GuardrailPolicy(mode="shadow", shadow_rate=1.0)
FAST_RETRY = RetryPolicy(max_retries=4, backoff_base_s=0.0)


def _cfg(**kw):
    return ShuffleSoftSortConfig(**{**dict(rounds=4, inner_steps=2,
                                           chunk=N), **kw})


def _problem(seed=0):
    return np.random.RandomState(seed).rand(N, D).astype(np.float32)


def _serve_once(cfg, x, key, *, engine=None, guardrail=None,
                submit_guardrail=None, retry=None):
    server = SortServer(HW, d=D, cfg=cfg, max_wait_ms=0.0, sched_rungs=2,
                        engine_fn=engine, guardrail=guardrail,
                        retry=retry or FAST_RETRY, device="cpu")
    try:
        fut = server.submit(x, key=key, guardrail=submit_guardrail)
        out = fut.result(timeout=120)
    finally:
        stats = server.stats
        server.close()
    return out, stats


PATHS = {
    "plain": {},
    "kernel": {"use_kernel": True},
    "banded": {"use_kernel": True, "band": 8},
    "bf16": {"use_kernel": True, "compute_dtype": "bfloat16"},
}
# Value corruptions at dispatch index 1 (the second rung); the targets
# route each mode to a distinct invariant probe.
CORRUPTIONS = {
    "bitflip": CorruptionSpec("bitflip", "orders", 5),    # permutation
    "signflip": CorruptionSpec("signflip", "losses", 1),  # loss_sign
    "stale": CorruptionSpec("stale", "losses"),           # stale_losses
    "nan": CorruptionSpec("nan", "losses", 2),            # finite
}
PROBES = {"bitflip": "permutation", "signflip": "loss_sign",
          "stale": "stale_losses", "nan": "finite"}
_BASELINES: dict[str, tuple] = {}


def _baseline(path, cfg, x, key):
    if path not in _BASELINES:
        _BASELINES[path] = _serve_once(cfg, x, key)[0]
    return _BASELINES[path]


def _assert_same(out, clean):
    for a, b in zip(out, clean):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("corruption", sorted(CORRUPTIONS))
@pytest.mark.parametrize("path", sorted(PATHS))
def test_chaos_grid_detects_repairs_and_restores_bit_identity(
        path, corruption):
    cfg = _cfg(**PATHS[path])
    x, key = _problem(), 11
    clean = _baseline(path, cfg, x, key)
    inj = FaultInjector(run_round_segment,
                        corrupt_calls={1: CORRUPTIONS[corruption]})
    out, stats = _serve_once(cfg, x, key, engine=inj, guardrail=FULL_SHADOW)
    assert inj.corruptions == 1, "corruption was not injected"
    assert stats["integrity_violations"] >= 1, "corruption not detected"
    assert stats["integrity_incidents"][0]["probe"] == PROBES[corruption]
    # transient: the replay is clean, no config change is consumed, and
    # the repaired result is bitwise the uninjected run
    assert stats["self_heals"] == 0
    _assert_same(out, clean)


def test_chaos_stream_skip_caught_by_the_stream_audit():
    """A dispatch that draws one shuffle too many from its source (a
    skipped stream position) fails the stream audit, the port's
    ``key_chain`` probe, and the replay repairs it bitwise."""
    cfg = _cfg()
    x, key = _problem(), 11
    clean = _baseline("plain", cfg, x, key)
    calls = []

    def skipping(*args, **kw):
        out = run_round_segment(*args, **kw)
        calls.append(len(calls))
        if len(calls) == 2:
            kw["source"].next_round()
        return out

    out, stats = _serve_once(cfg, x, key, engine=skipping,
                             guardrail=FULL_SHADOW)
    assert stats["integrity_incidents"][0]["probe"] == "key_chain"
    _assert_same(out, clean)


@pytest.mark.parametrize("path", ["kernel", "banded", "bf16"])
def test_kernel_tier_shadow_is_clean_in_serving(path):
    """Queue C8 on the serving path: three requests of mixed progress on
    the kernel tier, shadowed at rate 1 (a bitwise replay of each dispatch
    and the kernel-vs-plain apply check), have no incident, and their
    results are bitwise the unguarded server's."""
    cfg = _cfg(**PATHS[path])
    xs = [_problem(s) for s in range(3)]
    out = {}
    for guard in (None, FULL_SHADOW):
        server = SortServer(HW, d=D, cfg=cfg, max_batch=4, sched_rungs=4,
                            guardrail=guard, autostart=False, device="cpu")
        futs = [server.submit(xs[0], key=1)]
        server._tick()
        futs += [server.submit(x, key=2 + i) for i, x in enumerate(xs[1:])]
        for _ in range(16):
            server._tick()
        server.close()
        out[guard is None] = [f.result(timeout=0) for f in futs]
        if guard is not None:
            assert server.stats["integrity_violations"] == 0
            assert server.stats["probe_s"] > 0
    for a, b in zip(out[True], out[False]):
        _assert_same(a, b)


def test_persistent_corruption_self_heals_to_the_plain_tier():
    cfg = _cfg(use_kernel=True)
    x, key = _problem(), 11
    # strike 1 (replay) and strike 2 (past heal_after=1) both corrupt;
    # the heal retires the kernel tier, later dispatches are clean
    inj = FaultInjector(
        run_round_segment,
        corrupt_calls={1: CorruptionSpec("signflip", "losses", 0),
                       2: CorruptionSpec("signflip", "losses", 0)})
    out, stats = _serve_once(cfg, x, key, engine=inj, guardrail=FULL_SHADOW)
    assert stats["integrity_violations"] == 2
    assert stats["self_heals"] == 1
    assert (np.sort(np.asarray(out[0])) == np.arange(N)).all()


def test_wrong_kernel_fails_the_apply_check_and_self_heals(monkeypatch):
    """A kernel twin whose y is 1e-3 too large on every call replays
    equal, so only the shadow's apply check sees it: two strikes, then
    the request's kernel tier is retired and it finishes bitwise the plain
    tier's run."""
    from repro_torch.kernels import ops
    fwd = ops.fwd_fused

    def perturbed(*args):
        y, m, l = fwd(*args)
        return y * (1 + 1e-3), m, l

    x, key = _problem(), 11
    clean = _baseline("plain", _cfg(), x, key)
    monkeypatch.setattr(ops, "fwd_fused", perturbed)
    out, stats = _serve_once(_cfg(use_kernel=True), x, key,
                             guardrail=FULL_SHADOW)
    incidents = stats["integrity_incidents"]
    assert [(r["probe"], r["check"], r["quantity"]) for r in incidents] == \
        [("shadow", "apply", "y")] * 2
    assert stats["self_heals"] == 1
    _assert_same(out, clean)


def test_per_request_guardrail_override_and_opt_out():
    cfg = _cfg()
    x, key = _problem(), 11
    clean = _baseline("plain", cfg, x, key)
    spec = CorruptionSpec("signflip", "losses", 1)
    # unguarded server, guarded REQUEST: detection still happens
    inj = FaultInjector(run_round_segment, corrupt_calls={1: spec})
    out, stats = _serve_once(cfg, x, key, engine=inj,
                             submit_guardrail=FULL_SHADOW)
    assert stats["integrity_violations"] == 1
    _assert_same(out, clean)
    # guarded server, request opts OUT: the corruption commits silently
    inj2 = FaultInjector(run_round_segment, corrupt_calls={1: spec})
    out2, stats2 = _serve_once(
        cfg, x, key, engine=inj2, guardrail=FULL_SHADOW,
        submit_guardrail=GuardrailPolicy(mode="off"))
    assert stats2["integrity_violations"] == 0
    assert not np.array_equal(np.asarray(out2[2]), np.asarray(clean[2]))


def test_guardrail_type_validation():
    with pytest.raises(TypeError):
        SortServer(HW, d=D, cfg=_cfg(), guardrail="shadow", autostart=False,
                   device="cpu")
    server = SortServer(HW, d=D, cfg=_cfg(), autostart=False, device="cpu")
    with pytest.raises(TypeError):
        server.submit(_problem(), guardrail="invariants")
    with pytest.raises(TypeError):
        SortServer(HW, d=D, cfg=_cfg(), brownout="on", autostart=False,
                   device="cpu")
    server.close()


def test_injector_state_dict_roundtrip():
    inj = FaultInjector(lambda: (np.zeros(2), np.ones(3)),
                        fail_calls={5}, delay_calls={2: 0.25},
                        corrupt_calls={3: CorruptionSpec("nan", "losses")})
    inj()
    inj()
    state = inj.state_dict()
    json.dumps(state)                       # JSON-able, by contract
    fresh = FaultInjector(lambda: None)
    fresh.load_state_dict(state)
    assert fresh.calls == 2 and fresh.fail_calls == {5}
    assert fresh.delay_calls == {2: 0.25}
    assert fresh.corrupt_calls == {3: CorruptionSpec("nan", "losses")}
    assert fresh.state_dict() == state


def test_warm_handoff_preserves_injection_cursor(tmp_path):
    """A preempted chaos scenario resumes with its injection cursor: the
    corruption scheduled for dispatch 1 fires exactly once, in the
    successor (a new process's, from disk), and the repaired result stays
    bitwise the clean one."""
    cfg = _cfg()
    x, key = _problem(), 11
    clean = _baseline("plain", cfg, x, key)
    spec = CorruptionSpec("signflip", "losses", 0)
    inj1 = FaultInjector(run_round_segment, corrupt_calls={1: spec})
    s1 = SortServer(HW, d=D, cfg=cfg, sched_rungs=2, engine_fn=inj1,
                    guardrail=FULL_SHADOW, retry=FAST_RETRY,
                    checkpoint_dir=str(tmp_path), autostart=False,
                    device="cpu")
    s1.submit(x, key=key)
    s1._tick()                          # dispatch 0 (clean rung 0)
    handoff = s1.close(drain=False)
    assert isinstance(handoff, WarmHandoff)
    assert handoff.injector_state["calls"] == 1
    assert handoff.injector_state["corruptions"] == 0

    inj2 = FaultInjector(run_round_segment, corrupt_calls={1: spec})
    s2 = SortServer(HW, d=D, cfg=cfg, sched_rungs=2, engine_fn=inj2,
                    guardrail=FULL_SHADOW, retry=FAST_RETRY,
                    resume=str(tmp_path), autostart=False, device="cpu")
    assert inj2.calls == 1              # cursor restored
    for _ in range(32):
        with s2._cv:
            if not s2._pending and not s2._active:
                break
        s2._tick()
    out = s2.resumed[0].future.result(timeout=10)
    stats = s2.stats
    s2.close()
    assert inj2.corruptions == 1
    assert stats["integrity_violations"] == 1
    _assert_same(out, clean)


# ----------------------------------------------------------------- CLI

def _cli(extra):
    from repro_torch.launch.serve import main
    base = ["--workload", "sort", "--requests", "2", "--sort-n", "16",
            "--sort-hw", "4", "--sort-d", "2", "--rounds", "4",
            "--max-batch", "2", "--device", "cpu"]
    return main(base + extra)


@pytest.mark.parametrize("extra", [
    ["--guardrail", "shadow", "--shadow-rate", "1.0"],
    ["--guardrail", "shadow", "--shadow-rate", "1.0", "--use-kernel"],
    ["--guardrail", "invariants"]], ids=["shadow", "shadow_kernel",
                                         "invariants"])
def test_cli_guardrail_smoke(extra):
    out = _cli(extra)
    assert out["integrity_violations"] == 0 and out["self_heals"] == 0
    assert out["completed"] == 2


def test_cli_shadow_rate_requires_shadow_mode(capsys):
    with pytest.raises(SystemExit):
        _cli(["--shadow-rate", "0.5"])
    assert "--guardrail shadow" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        _cli(["--guardrail", "invariants", "--shadow-rate", "0.5"])


def test_cli_shadow_rate_range_validated(capsys):
    with pytest.raises(SystemExit):
        _cli(["--guardrail", "shadow", "--shadow-rate", "1.5"])
    assert "must be in" in capsys.readouterr().err


# ------------------------------------------------------ the guardrail bench

def test_guardrail_bench_smoke_check_passes_on_cpu(capsys):
    """``python -m repro_torch.bench.guardrail_bench --device cpu --smoke
    --check``: each detection cell injected, detected with a named probe,
    repaired bitwise; one default overhead cell (smoke: no timing gate)."""
    from repro_torch.bench import guardrail_bench
    doc = guardrail_bench.main(["--device", "cpu", "--smoke", "--check"])
    assert "guardrail gate OK" in capsys.readouterr().out
    assert doc["detection_rate"] == 1.0 and doc["wall_clock"] == "cpu"
    det = [c for c in doc["cells"] if c["kind"] == "detection"]
    assert [(c["path"], c["probe"]) for c in det] == [
        ("plain", "loss_sign"), ("plain", "finite"),
        ("kernel", "loss_sign"), ("kernel", "finite")]


def test_guardrail_bench_gate_flags_misses_and_overhead():
    from repro_torch.bench.guardrail_bench import gate
    det = dict(kind="detection", path="kernel", corruption="nan",
               injected=1, detected=False, repaired=True,
               bit_identical=True, probe=None)
    over = dict(kind="overhead", default=True, shadow_rate=1 / 32,
                overhead_pct=7.5)
    doc = dict(cells=[det, over], detection_rate=0.0, smoke=False)
    assert len(gate(doc)) == 3
    assert len(gate(dict(doc, smoke=True))) == 2

"""The port's integrity guardrails and supervision
(``repro_torch.runtime.guardrails``, ``repro_torch.runtime.fault_tolerance``)
against the reference's, on the same numpy inputs, on the CPU.

* Host pieces, each held to the reference on the same inputs:
  ``shadow_sampled`` over a grid of seeds, starts and rates;
  ``measured_dropped_mass`` (float64, rtol 1e-12); ``CorruptionSpec.apply``
  bytewise; ``RetryPolicy.backoff``; ``DivergencePolicy.apply`` (the same
  rung for each config and failure); ``GuardrailMonitor.check_rung`` (the
  same probe name and round for each corruption); ``AnnealSupervisor``
  over a scripted stub (the same ``stats`` and ``history``).
* The stream audit (the port's ``key_chain`` probe): a clean rung
  verifies, a tampered generator state and a tampered replay ``pos`` fire.
* Engine wiring: a guarded run (the invariants and the shadow at rate 1)
  is bitwise the unguarded run on all five engine paths, on the plain
  tier and on the kernel tier.
* The supervisor's two repairs: a transient sign-flipped loss is repaired
  by one verified replay, bitwise clean; a corruption that persists while
  the kernel tier is on retires it.
* The shadow on the kernel tier (ROADMAP.md Queue C8, repaired): clean on
  the reference's C8 cases and on every engine path; its same-tier replay
  catches each corruption mode on each target, and its apply check a
  kernel that is wrong on every call.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.shufflesoftsort import (  # noqa: E402
    NumericalDivergence as JNumericalDivergence,
    ShuffleSoftSortConfig as JConfig,
)
from repro.runtime import fault_tolerance as jft  # noqa: E402
from repro.runtime import guardrails as jgr  # noqa: E402
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ReplayShuffleSource,
    TorchShuffleSource,
)
from repro_torch.core.shufflesoftsort import (  # noqa: E402
    NumericalDivergence,
    ShuffleSoftSortConfig,
    restart_tournament,
    run_round_segment,
    shuffle_soft_sort,
    shuffle_soft_sort_batched,
)
from repro_torch.runtime import fault_tolerance as tft  # noqa: E402
from repro_torch.runtime import guardrails as tgr  # noqa: E402
from repro_torch.runtime.fault_tolerance import (  # noqa: E402
    AnnealSupervisor,
    DivergencePolicy,
)
from repro_torch.runtime.guardrails import (  # noqa: E402
    GuardrailMonitor,
    GuardrailPolicy,
    IntegrityViolation,
)

N, HW, D = 16, (4, 4), 3
FULL_SHADOW = GuardrailPolicy(mode="shadow", shadow_rate=1.0)
INVARIANTS = GuardrailPolicy(mode="invariants")
CPU = dict(device="cpu")


def _cfg(**kw):
    return ShuffleSoftSortConfig(**{**dict(rounds=4, inner_steps=2,
                                           chunk=N), **kw})


def _problem(seed=0):
    return np.random.RandomState(seed).rand(N, D).astype(np.float32)


# ------------------------------------------------------ host pieces

@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_shadow_sampled_matches_reference(seed):
    for rate in (0.0, 1 / 32, 0.25, 0.5, 0.999, 1.0):
        for start in range(0, 400, 3):
            assert tgr.shadow_sampled(seed, start, rate) == \
                jgr.shadow_sampled(seed, start, rate), (seed, start, rate)


@pytest.mark.parametrize("tau,band,descending", [
    (0.2, 4, False), (0.5, 4, False), (1.5, 2, True), (0.05, 8, False)])
def test_measured_dropped_mass_matches_reference(tau, band, descending,
                                                 monkeypatch):
    rng = np.random.RandomState(3)
    w = (rng.randn(4, N) * 3.0).astype(np.float32)
    for t in (tau, np.array([tau, 2 * tau, tau / 2, tau], np.float32)):
        want = jgr.measured_dropped_mass(w, t, band, descending=descending)
        for block in (512, 5):              # one block, and a short last one
            monkeypatch.setattr(tgr, "_ROW_BLOCK", block)
            got = tgr.measured_dropped_mass(w, t, band,
                                            descending=descending)
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-300)
    got_1 = tgr.measured_dropped_mass(torch.as_tensor(w[1]), tau, band,
                                      descending=descending)
    np.testing.assert_allclose(got_1, jgr.measured_dropped_mass(
        w[1], tau, band, descending=descending), rtol=1e-12)


@pytest.mark.parametrize("mode", ["bitflip", "signflip", "stale", "nan"])
def test_corruption_spec_apply_is_bytewise_the_reference(mode):
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(3, 5)).astype(np.float32),
              rng.normal(size=7).astype(np.float16),
              rng.integers(0, 99, size=(2, 6)).astype(np.int32),
              rng.integers(0, 99, size=6).astype(np.int64),
              rng.integers(0, 2**32 - 1, size=(2, 2), dtype=np.uint32)]
    for arr in arrays:
        for index in (0, 4, -1, 1000):
            for prev in (None, arr + 1, arr[:1]):
                if mode == "nan" and arr.dtype.kind != "f":
                    with pytest.raises(ValueError):
                        tft.CorruptionSpec(mode, "losses", index).apply(
                            arr, prev)
                    continue
                got = tft.CorruptionSpec(mode, "losses", index).apply(
                    arr, prev)
                want = jft.CorruptionSpec(mode, "losses", index).apply(
                    arr, prev)
                assert got.dtype == want.dtype
                assert got.tobytes() == want.tobytes(), (arr.dtype, index)
    with pytest.raises(ValueError):
        tft.CorruptionSpec(mode, "keys")       # no keys in the port's result
    with pytest.raises(ValueError):
        tft.CorruptionSpec(mode, "losses", None)


def test_retry_policy_backoff_matches_reference():
    for kw in ({}, dict(backoff_base_s=0.01, backoff_mult=3.0,
                        backoff_max_s=0.5)):
        t, j = tft.RetryPolicy(**kw), jft.RetryPolicy(**kw)
        assert [t.backoff(a) for a in range(1, 12)] == \
            [j.backoff(a) for a in range(1, 12)]
        with pytest.raises(ValueError):
            t.backoff(0)


_CONFIGS = [dict(), dict(compute_dtype="bfloat16"), dict(tau_end=0.01),
            dict(band=2), dict(band="auto"), dict(use_kernel=True),
            dict(use_kernel=True, band=4, compute_dtype="bfloat16",
                 tau_end=0.01),
            dict(use_kernel=True, band="auto")]
_FAILURES = [("divergence", None), ("integrity", "loss_sign"),
             ("integrity", "band_tail"), ("integrity", "shadow")]


@pytest.mark.parametrize("policy", [
    dict(), dict(oracle_fallback=False), dict(widen_band=False,
                                              tau_floor=0.0),
    dict(promote_f32=False)])
def test_divergence_policy_matches_reference(policy):
    tp, jp = tft.DivergencePolicy(**policy), jft.DivergencePolicy(**policy)
    for fields in _CONFIGS:
        for kind, probe in _FAILURES:
            if kind == "divergence":
                ft, fj = NumericalDivergence("x"), JNumericalDivergence("x")
            else:
                ft = IntegrityViolation("x", probe=probe)
                fj = jgr.IntegrityViolation("x", probe=probe)
            cfg_t, cfg_j = ShuffleSoftSortConfig(**fields), JConfig(**fields)
            # Walk each ladder to its end, rung by rung.
            for _ in range(6):
                got, want = tp.apply(cfg_t, ft), jp.apply(cfg_j, fj)
                assert (got is None) == (want is None), (fields, probe)
                if got is None:
                    break
                cfg_t, cfg_j = got[0], want[0]
                assert dataclasses.asdict(cfg_t) == \
                    dataclasses.asdict(cfg_j), (fields, probe)
                if "kernel" not in got[1]:
                    assert got[1] == want[1]


def _probe_cases():
    """(name, [check_rung kwargs, ...]): the last call must fire."""
    perm = np.tile(np.arange(N), (2, 1))
    dup = perm.copy()
    dup[1, 3] = dup[1, 4]
    seg = np.linspace(1.0, 0.5, 4, dtype=np.float32).reshape(2, 2)
    nan = np.full((2, 2), 0.5, np.float32)
    nan[1, 1] = np.nan
    neg = np.full((2, 3), 0.5, np.float32)
    neg[1, 0] = -0.2
    rng = np.random.RandomState(3)
    w = np.sort(rng.randn(4, N).astype(np.float32) * 3.0, axis=1)[:, ::-1]
    bad_w = w.copy()
    bad_w[0, 0] = np.inf
    orders = np.arange(N)[None]
    flipped = orders.copy()
    flipped[0, :2] = flipped[0, :2][::-1]
    one = np.array([[0.5], [0.4]], np.float32)
    return {
        "finite": [dict(start=6, losses=nan)],
        "loss_sign": [dict(start=4, losses=neg, tau=0.7)],
        "loss_explosion": [dict(start=0, losses=np.ones((2, 1), np.float32)),
                           dict(start=2, losses=np.array([[1.0], [1e5]],
                                                         np.float32))],
        "stale_losses": [dict(start=0, losses=seg),
                         dict(start=2, losses=seg.copy())],
        "permutation": [dict(start=0, orders=perm, n=N),
                        dict(start=0, orders=dup, n=N)],
        "shadow": [dict(start=0, losses=one, orders=orders,
                        oracle_losses=one.copy(),
                        oracle_orders=orders.copy()),
                   dict(start=4, losses=one * 0.9,
                        oracle_losses=one * 1.35)],
        "shadow_orders": [dict(start=0, orders=orders,
                               oracle_orders=flipped)],
        "band_tail": [dict(start=0, ws=w, tau=0.5, band=4),
                      dict(start=4, ws=bad_w, tau=0.5, band=4)],
    }


@pytest.mark.parametrize("case", sorted(_probe_cases()))
def test_check_rung_fires_the_reference_probe(case):
    calls = _probe_cases()[case]
    mons = [m.GuardrailMonitor(m.GuardrailPolicy(mode="shadow",
                                                 shadow_rate=1.0),
                               context="test") for m in (tgr, jgr)]
    fired = []
    for mon, exc in zip(mons, (tgr.IntegrityViolation,
                               jgr.IntegrityViolation)):
        for kw in calls[:-1]:
            mon.check_rung(**kw)
        with pytest.raises(exc) as ei:
            mon.check_rung(**calls[-1])
        fired.append(ei.value)
    t, j = fired
    assert t.probe == j.probe == case.split("_orders")[0]
    assert t.round == j.round and t.context == j.context == "test"
    # The port's shadow names the check that fired (its replay here).
    assert t.incident().pop("check", "replay") == "replay"
    assert sorted(k for k in t.incident() if k != "check") == \
        sorted(j.incident())
    assert [m.rungs_checked for m in mons][0] == mons[1].rungs_checked
    assert mons[0].summary()["incidents"][0]["probe"] == t.probe


def test_policy_and_off_mode():
    with pytest.raises(ValueError):
        GuardrailPolicy(mode="paranoid")
    with pytest.raises(ValueError):
        GuardrailPolicy(mode="shadow", shadow_rate=1.5)
    mon = GuardrailMonitor(GuardrailPolicy(mode="off"))
    assert not mon.active
    mon.check_rung(start=0, orders=np.array([[0, 0, 0, 0]]), n=4)
    assert mon.rungs_checked == 0
    with pytest.raises(TypeError):
        shuffle_soft_sort_batched(_problem()[None], HW, _cfg(),
                                  guardrail="shadow", **CPU)


def _script(events):
    """A run_fn that raises the scripted exceptions, then returns."""
    seen = []

    def run(xs, hw, cfg, **kw):
        seen.append((dataclasses.asdict(cfg), kw.get("resume")))
        if len(seen) <= len(events):
            raise events[len(seen) - 1]
        return {"cfg": dataclasses.asdict(cfg)}
    return run, seen


def test_supervisor_over_a_scripted_stub_matches_reference(tmp_path):
    def events(m, div, iv):
        return [m.WorkerFailure("down"),
                iv("x", probe="loss_sign", round=2, context="batched"),
                iv("x", probe="shadow", round=4, tau=0.3,
                   dtype="float32", context="batched"),
                div("nan", round=5, tau=0.2, dtype="bfloat16"),
                m.WorkerFailure("again"),
                iv("x", probe="band_tail", round=6, context="batched")]

    cfg_fields = dict(rounds=8, use_kernel=True, compute_dtype="bfloat16",
                      band=4)
    out = []
    for m, div, iv, cfg in (
            (tft, NumericalDivergence, IntegrityViolation,
             ShuffleSoftSortConfig(**cfg_fields)),
            (jft, JNumericalDivergence, jgr.IntegrityViolation,
             JConfig(**cfg_fields))):
        run, seen = _script(events(m, div, iv))
        sleeps = []
        sup = m.AnnealSupervisor(
            run, checkpoint_dir=str(tmp_path),
            retry=m.RetryPolicy(max_retries=3, backoff_base_s=0.01),
            degrade=m.DivergencePolicy(integrity_retries=1),
            sleep_fn=sleeps.append)
        res = sup.run(None, HW, cfg)
        out.append((res, seen, sleeps, sup.stats, sup.history))
    (rt, st, slt, stt, ht), (rj, sj, slj, stj, hj) = out
    assert rt == rj and st == sj and slt == slj == [0.01, 0.02]
    fix = lambda s: s.replace("plain PyTorch apply (use_kernel=False)",  # noqa: E731
                              "pure-jnp oracle apply")
    assert [fix(f) for f in stt["fallbacks"]] == stj["fallbacks"]
    assert {k: v for k, v in stt.items() if k != "fallbacks"} == \
        {k: v for k, v in stj.items() if k != "fallbacks"}
    assert [{k: fix(v) if isinstance(v, str) else v for k, v in h.items()}
            for h in ht] == hj


def test_supervisor_refuses_a_mesh(tmp_path):
    """Once refused as unported (ROADMAP.md Queue A11), a supervised run
    on a mesh is now ported: an object that is not a ``SortMesh`` is a
    ``TypeError``, a ``FaultInjector`` takes device chaos, and a slot it
    takes down is evicted, the run finishing on the survivors."""
    from repro_torch.launch.mesh import make_sort_mesh
    xs = np.stack([_problem(i) for i in range(2)])
    sup = AnnealSupervisor(checkpoint_dir=str(tmp_path / "a"))
    with pytest.raises(TypeError, match="SortMesh"):
        sup.run(xs, HW, _cfg(), device="cpu", mesh=object())
    mesh = make_sort_mesh(devices=["cpu"] * 3)
    inj = tft.FaultInjector(teng.shuffle_soft_sort_batched,
                            device_loss={0: mesh.ids[1]})
    sup = AnnealSupervisor(inj, checkpoint_dir=str(tmp_path / "b"),
                           retry=tft.RetryPolicy(backoff_base_s=0.0))
    got = sup.run(xs, HW, _cfg(), n_restarts=2, mesh=mesh)
    want = teng.shuffle_soft_sort_batched(xs, HW, _cfg(), n_restarts=2,
                                          device="cpu")
    assert sup.stats["evictions"] == 1 and inj.device_faults == 1
    assert sup.history[-1] == {"event": "evict", "device": mesh.ids[1],
                               "survivors": 2}
    np.testing.assert_array_equal(got.all_orders, want.all_orders)
    np.testing.assert_array_equal(got.all_losses, want.all_losses)


def test_injector_state_dict_roundtrip_matches_reference():
    kw = dict(fail_calls={5}, delay_calls={2: 0.25},
              corrupt_calls={3: {"mode": "nan", "target": "losses"}})
    out = []
    for m in (tft, jft):
        inj = m.FaultInjector(lambda: (np.zeros(2), np.ones(3)), **kw)
        inj()
        inj()
        st = inj.state_dict()
        fresh = m.FaultInjector(lambda: None)
        fresh.load_state_dict(st)
        assert fresh.state_dict() == st
        out.append(st)
    assert out[0] == out[1]


# ---------------------------------------------------- the stream audit

def test_stream_audit_catches_a_tampered_generator_state():
    src = TorchShuffleSource([3, 4, 5], N, "cpu")
    s_in = src.state_dict()
    for _ in range(2):
        src.next_round([0, 2])
    GuardrailMonitor(INVARIANTS).check_rung(
        start=0, source=src, stream_in=s_in, stream_out=src.state_dict(),
        rows=[0, 2], seg_len=2)
    for rows, seg_len, tamper in (([0, 2], 2, True), ([0, 1, 2], 2, False),
                                  ([0, 2], 3, False)):
        out = src.state_dict()
        if tamper:
            out[2, 100] ^= np.uint8(1)
        with pytest.raises(IntegrityViolation) as ei:
            GuardrailMonitor(INVARIANTS).check_rung(
                start=4, source=src, stream_in=s_in, stream_out=out,
                rows=rows, seg_len=seg_len)
        assert ei.value.probe == "key_chain" and ei.value.round == 4


def test_stream_audit_catches_a_tampered_pos():
    sh = np.stack([np.stack([np.arange(N)] * 2)] * 4)
    src = ReplayShuffleSource(sh, "cpu")
    s_in = src.state_dict()
    src.next_round()
    src.next_round()
    GuardrailMonitor(INVARIANTS).check_rung(
        start=0, source=src, stream_in=s_in, stream_out=src.state_dict(),
        seg_len=2)
    bad = src.state_dict()
    bad[1] += 1                                  # a skipped shuffle
    with pytest.raises(IntegrityViolation) as ei:
        GuardrailMonitor(INVARIANTS).check_rung(
            start=0, source=src, stream_in=s_in, stream_out=bad, seg_len=2)
    assert ei.value.probe == "key_chain"


# ----------------------------------------------------- engine wiring

def _segment(guardrail, with_w, **cfg_kw):
    xs = np.stack([_problem(0), _problem(1)])
    orders = np.tile(np.arange(N), (2, 1))
    res = run_round_segment(xs, orders, np.ones(2, np.float32),
                            np.zeros(2, np.int64), 2,
                            source=TorchShuffleSource([3, 4], N, "cpu"),
                            hw=HW, cfg=_cfg(band=4, band_eps=1e3, **cfg_kw),
                            with_w=with_w, guardrail=guardrail, **CPU)
    return {f"out{i}": np.asarray(a) for i, a in enumerate(res)}


ACFG = dict(rounds=8, schedule="adaptive", patience=1, plateau_rtol=1.0,
            adapt_every=2)
ENGINES = {
    "sequential": lambda g, k={}: dict(zip(("order", "sorted", "losses"),
                                           shuffle_soft_sort(
                                               _problem(), HW, _cfg(**k),
                                               seed=5, guardrail=g, **CPU))),
    "batched": lambda g, k={}: dataclasses.asdict(shuffle_soft_sort_batched(
        np.stack([_problem(0), _problem(1)]), HW,
        _cfg(band=4, band_eps=1e-2, **k), n_restarts=2, seed=5, guardrail=g,
        **CPU)),
    "adaptive": lambda g, k={}: dataclasses.asdict(shuffle_soft_sort_batched(
        np.stack([_problem(0), _problem(1)]), HW,
        _cfg(band=4, band_eps=1e3, **ACFG, **k), n_restarts=2, seed=5,
        guardrail=g, **CPU)),
    "tournament": lambda g, k={}: dataclasses.asdict(restart_tournament(
        _problem()[None], HW, _cfg(**k), n_restarts=4, n_rungs=2, seed=5,
        guardrail=g, **CPU)),
    "tournament_adaptive": lambda g, k={}: dataclasses.asdict(
        restart_tournament(_problem()[None], HW, _cfg(**ACFG, **k),
                           n_restarts=4, seed=5, guardrail=g, **CPU)),
    "segment": lambda g, k={}: _segment(g, with_w=False, **k),
    "segment_with_w": lambda g, k={}: _segment(g, with_w=True, **k),
}


def _guarded_equals_unguarded(engine, cfg_kw, policies):
    """Each policy's guarded run is bitwise the unguarded run, with no
    incident, and the shadow sampled every rung at rate 1."""
    run = ENGINES[engine]
    ref = run(None, cfg_kw)
    for policy in policies:
        mon = GuardrailMonitor(policy, context="test")
        got = run(mon, cfg_kw)
        assert mon.rungs_checked >= 1 and not mon.incidents
        if policy is FULL_SHADOW:
            assert mon.rungs_shadowed == mon.rungs_checked
        for k, v in ref.items():
            pairs = zip(v, got[k]) if isinstance(v, tuple) else [(v, got[k])]
            for a, g in pairs:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(g),
                                              err_msg=f"{engine}: {k}")


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_guarded_run_is_bitwise_the_unguarded_run(engine):
    _guarded_equals_unguarded(engine, {}, (INVARIANTS, FULL_SHADOW))


class _SegmentCorruptor:
    """Wraps the module-level ``_run_segment`` seam: sign-flips one loss of
    the selected calls (or of every call while the kernel tier is on)."""

    def __init__(self, inner, corrupt_calls=(), kernel_only=False):
        self.inner = inner
        self.corrupt_calls = set(corrupt_calls)
        self.kernel_only = kernel_only
        self.calls = 0
        self.corruptions = 0
        self.kernel_calls = []

    def __call__(self, *args, **kwargs):
        i = self.calls
        self.calls += 1
        self.kernel_calls.append(kwargs["cfg"].use_kernel)
        orders, losses = self.inner(*args, **kwargs)
        if i in self.corrupt_calls or (self.kernel_only
                                       and kwargs["cfg"].use_kernel):
            losses = losses.clone()
            losses.view(-1)[0] *= -1.0
            self.corruptions += 1
        return orders, losses


def test_supervisor_repairs_transient_corruption_by_verified_replay(
        tmp_path, monkeypatch):
    xs = _problem(0)[None]
    cfg = _cfg()
    clean = shuffle_soft_sort_batched(xs, HW, cfg, seed=9, **CPU)
    chaos = _SegmentCorruptor(teng._run_segment, corrupt_calls={1})
    monkeypatch.setattr(teng, "_run_segment", chaos)
    sup = AnnealSupervisor(checkpoint_dir=str(tmp_path),
                           degrade=DivergencePolicy(integrity_retries=2))
    out = sup.run(xs, HW, cfg, seed=9, checkpoint_every=1,
                  guardrail=INVARIANTS, **CPU)
    assert chaos.corruptions == 1
    assert sup.stats["verified_replays"] == 1
    assert not sup.stats["fallbacks"]
    assert [r["probe"] for r in sup.stats["integrity_incidents"]] \
        == ["loss_sign"]
    np.testing.assert_array_equal(out.all_orders, clean.all_orders)
    np.testing.assert_array_equal(out.all_losses, clean.all_losses)


def test_supervisor_retires_kernel_tier_on_persistent_corruption(
        tmp_path, monkeypatch):
    xs = _problem(0)[None]
    cfg = _cfg(use_kernel=True)
    chaos = _SegmentCorruptor(teng._run_segment, kernel_only=True)
    monkeypatch.setattr(teng, "_run_segment", chaos)
    sup = AnnealSupervisor(checkpoint_dir=str(tmp_path),
                           degrade=DivergencePolicy(integrity_retries=1))
    out = sup.run(xs, HW, cfg, seed=9, checkpoint_every=1,
                  guardrail=INVARIANTS, **CPU)
    assert sup.stats["verified_replays"] == 1
    assert sup.stats["fallbacks"] == [
        "retired kernel tier -> plain PyTorch apply (use_kernel=False)"]
    # rung 0 twice on the kernel tier (first strike, verified replay),
    # then every rung on the plain tier from rung 0's checkpoint-less start
    assert chaos.kernel_calls == [True, True, False, False, False, False]
    order = out.all_orders.reshape(-1, N)
    assert (np.sort(order, axis=1) == np.arange(N)).all()
    ref = shuffle_soft_sort_batched(xs, HW, _cfg(), seed=9, **CPU)
    np.testing.assert_array_equal(out.all_orders, ref.all_orders)



def _c8_problem(data=0, key_seed=0):
    """Queue C8's cases: two synthetic catalogs (N = 64, d = 50) x 2
    restarts, 16 rounds, the reference's key chains and its loss
    normalizations."""
    from repro.core.losses import mean_pairwise_distance as jmpd
    from repro_torch.examples.image_grid_sorting import synthetic_catalog
    xs = np.stack([synthetic_catalog(64, 50, clusters=24,
                                     seed=2 * data + i)[0]
                   for i in range(2)])
    keys = jax.random.split(jax.random.PRNGKey(key_seed), 4)
    norms = [float(jmpd(jnp.asarray(x))) for x in xs]
    return xs, keys, norms, _key_chain_shuffles(keys, 16, 64)


def _key_chain_shuffles(keys, rounds, n):
    """(R, BS, N): instance i's shuffles from its own key chain, as the
    reference's batched engine draws them."""
    out, k = [], jnp.asarray(keys)
    for _ in range(rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        out.append(np.stack([np.asarray(jax.random.permutation(sk, n))
                             for sk in subs]))
    return np.stack(out)


@pytest.mark.parametrize("data,key_seed,lambda_sigma,ref_rung", [
    (0, 0, 2.0, None), (0, 0, 0.0, None), (1, 5, 0.0, 2)],
    ids=["std_on", "std_off", "both_fire"])
def test_clean_shadow_incidents_against_the_reference(
        data, key_seed, lambda_sigma, ref_rung):
    """ROADMAP.md Queue C8, repaired: on the same inputs and shuffles
    (rungs of 2 of 16 rounds, shadow rate 1), the reference's guarded run
    (its Pallas kernels in interpret mode against its jnp oracle) shadows
    every rung of the first two cases clean and fires at rung 2 of
    ``both_fire``: its cross-tier order compare's own false positive.  The
    port's shadow (a bitwise replay on the kernel tier and the
    kernel-vs-plain apply check) shadows all 8 rungs of all three cases
    clean, where its earlier cross-tier compare fired at rungs 10, 14 and
    2, and the guarded run is bitwise the unguarded one."""
    from repro.core import shufflesoftsort as jeng
    from repro.runtime.guardrails import (GuardrailMonitor as JMonitor,
                                          GuardrailPolicy as JPolicy,
                                          IntegrityViolation as JViolation)
    xs, keys, norms, shuffles = _c8_problem(data, key_seed)
    jmon = JMonitor(JPolicy(mode="shadow", shadow_rate=1.0))
    try:
        jeng.shuffle_soft_sort_batched(
            xs, (8, 8), jeng.ShuffleSoftSortConfig(
                rounds=16, inner_steps=8, use_kernel=True,
                lambda_sigma=lambda_sigma),
            n_restarts=2, keys=keys, checkpoint_every=2, guardrail=jmon)
        fired = None
    except JViolation as e:
        assert e.probe == "shadow"
        fired = e.round
    assert fired == ref_rung
    assert jmon.rungs_shadowed == (8 if ref_rung is None
                                   else ref_rung // 2 + 1)

    def run(guard):
        return shuffle_soft_sort_batched(
            xs, (8, 8), ShuffleSoftSortConfig(
                rounds=16, inner_steps=8, use_kernel=True,
                lambda_sigma=lambda_sigma),
            n_restarts=2, norms=norms,
            source=ReplayShuffleSource(shuffles, "cpu"), checkpoint_every=2,
            **guard, **CPU)

    mon = GuardrailMonitor(FULL_SHADOW)
    guarded = run(dict(guardrail=mon))
    assert mon.incidents == [] and mon.rungs_shadowed == 8
    plain = run(dict(rung_hook=lambda start: None))
    np.testing.assert_array_equal(guarded.all_orders, plain.all_orders)
    np.testing.assert_array_equal(guarded.all_losses, plain.all_losses)


def test_port_tiers_part_where_the_reference_tiers_agree():
    """Queue C8's mechanism, at the first inner step of round 11 (tau
    0.0598) from the orders all four runs share: the reference's two
    tiers give the same y bitwise, the port's differ by up to 2 ulps; the
    std term's per-dimension gap ``std(x) - std(y)`` is then rounding
    noise whose sign the port's two tiers do not share (Queue C1).  Else
    the four tiers are alike: with the std term off, each one's gradient
    of the loss is within 2e-6 (of its largest entry) of a float64 one."""
    from repro.core import losses as jlosses
    from repro.core import shufflesoftsort as jeng
    from repro_torch.core.losses import grid_sorting_loss
    from repro_torch.core.softsort import softsort_matrix
    xs, _, norms, shuffles = _c8_problem()
    rnd, inst = 11, 0
    cfg = ShuffleSoftSortConfig(rounds=16, inner_steps=8)
    xs_t = torch.as_tensor(np.repeat(xs, 2, axis=0))
    orders, _, _ = teng._run_rounds(
        xs_t, torch.arange(64).repeat(4, 1),
        ReplayShuffleSource(shuffles, "cpu"),
        torch.as_tensor(np.repeat(np.float32(norms), 2)), 0, rnd, hw=(8, 8),
        cfg=cfg)
    x_shuf = xs_t[inst][orders[inst]][torch.as_tensor(shuffles[rnd, inst])]
    tau = float(teng._inner_taus(cfg)[rnd, 0])
    norm = float(norms[inst // 2])

    def port_grad(apply_fn, dtype):
        w = torch.arange(64, dtype=dtype)[None].requires_grad_(True)
        y, colsum = apply_fn(w, x_shuf[None].to(dtype),
                             torch.tensor([tau], dtype=dtype))
        loss = grid_sorting_loss(y, colsum, x_shuf[None].to(dtype), (8, 8),
                                 norm=norm, lambda_sigma=0.0)
        return y[0].detach(), torch.autograd.grad(loss.sum(), w)[0][0]

    g64 = port_grad(lambda w, x, t: (softsort_matrix(w, t) @ x,
                                     softsort_matrix(w, t).sum(-2)),
                    torch.float64)[1].numpy()
    ys, gaps, grads = {}, {}, {}
    for use_kernel in (False, True):
        y, g = port_grad(teng._select_apply_fn(dataclasses.replace(
            cfg, use_kernel=use_kernel)), torch.float32)
        ys["port", use_kernel], grads["port", use_kernel] = y.numpy(), g
        gaps["port", use_kernel] = (torch.std(x_shuf, 0, correction=0)
                                    - torch.std(y, 0, correction=0)).numpy()
        jfn = jeng._select_apply_fn(jeng.ShuffleSoftSortConfig(
            rounds=16, inner_steps=8, use_kernel=use_kernel))
        xj = jnp.asarray(x_shuf.numpy())
        yj = jfn(jnp.arange(64, dtype=jnp.float32), xj, jnp.float32(tau))[0]
        ys["ref", use_kernel] = np.asarray(yj)
        gaps["ref", use_kernel] = np.asarray(jnp.std(xj, axis=0)
                                             - jnp.std(yj, axis=0))
        grads["ref", use_kernel] = jax.grad(lambda w: jlosses.grid_sorting_loss(
            *jfn(w, xj, jnp.float32(tau)), xj, (8, 8), norm=norm,
            lambda_sigma=0.0))(
                jnp.arange(64, dtype=jnp.float32))
        assert np.abs(jlosses.std_loss(xj, yj)) < 1e-5
    for g in grads.values():
        np.testing.assert_allclose(np.asarray(g), g64,
                                   atol=2e-6 * np.abs(g64).max(), rtol=0)
    np.testing.assert_array_equal(ys["ref", True], ys["ref", False])
    np.testing.assert_array_equal(gaps["ref", True], gaps["ref", False])
    ulps = np.abs(ys["port", True].view(np.int32)
                  - ys["port", False].view(np.int32))
    assert 0 < ulps.max() <= 2
    assert (np.sign(gaps["port", True]) != np.sign(gaps["port", False])).any()


_REPLAY_CORRUPTIONS = [(mode, target)
                       for mode in ("bitflip", "signflip", "stale", "nan")
                       for target in ("orders", "losses")
                       if (mode, target) != ("nan", "orders")]
_KERNEL_SHADOW_CASES = (
    [("clean", engine) for engine in sorted(ENGINES)]
    + [("replay", f"{mode}-{target}") for mode, target in _REPLAY_CORRUPTIONS]
    + [("apply", "perturbed_y")])


@pytest.mark.parametrize(
    "check,case", _KERNEL_SHADOW_CASES,
    ids=[f"{c}-{k}" for c, k in _KERNEL_SHADOW_CASES])
def test_kernel_tier_shadow_is_clean_and_catches_corruption(
        check, case, tmp_path, monkeypatch):
    """The rate-1 shadow on the kernel tier (the CPU twins here):

    * ``clean``: on each engine path the guarded run is bitwise the
      unguarded one, with no incident;
    * ``replay``: each ``FaultInjector`` value corruption of each target of
      the rung seam's result, at the second rung, is detected and repaired
      by one verified replay under ``AnnealSupervisor``, bitwise the clean
      run; and the replay check alone fires on the corrupted rung against
      its clean replay (the stale orders of the previous rung are a valid
      permutation, so there it is the probe that fires);
    * ``apply``: a kernel twin whose y is 1e-3 too large on every call
      replays equal, so the apply check fires, and the supervisor retires
      the kernel tier: the run finishes bitwise the plain tier's run."""
    if check == "clean":
        _guarded_equals_unguarded(case, dict(use_kernel=True),
                                  (FULL_SHADOW,))
        return
    xs, cfg = _problem(0)[None], _cfg(use_kernel=True)
    if check == "replay":
        mode, target = case.split("-")
        spec = tft.CorruptionSpec(mode, target, 3)
        clean = shuffle_soft_sort_batched(xs, HW, cfg, seed=9, **CPU)
        inj = tft.FaultInjector(teng._run_segment, corrupt_calls={1: spec})
        monkeypatch.setattr(teng, "_run_segment", inj)
        sup = AnnealSupervisor(checkpoint_dir=str(tmp_path),
                               degrade=DivergencePolicy(integrity_retries=2))
        # check_finite=False: the guardrails, not the engine's own finite
        # sentinel, meet the non-finite corruptions.
        out = sup.run(xs, HW, cfg, seed=9, checkpoint_every=1,
                      check_finite=False, guardrail=FULL_SHADOW, **CPU)
        assert inj.corruptions == 1
        assert sup.stats["verified_replays"] == 1
        assert not sup.stats["fallbacks"]
        first = sup.stats["integrity_incidents"][0]
        if (mode, target) == ("stale", "orders"):
            assert (first["probe"], first["check"]) == ("shadow", "replay")
        np.testing.assert_array_equal(out.all_orders, clean.all_orders)
        np.testing.assert_array_equal(out.all_losses, clean.all_losses)
        # The replay check alone, on a corrupted rung of rounds 0-1 (the
        # stale source: the orders it started from, and the losses of the
        # next rung).
        from repro_torch.core import instance_seeds, mean_pairwise_distance
        xs_t = torch.as_tensor(xs)
        norms = mean_pairwise_distance(xs_t[0])[None]
        src = TorchShuffleSource(instance_seeds(9, 1), N, "cpu")
        o_in = torch.arange(N)[None]
        o1, l1, _ = teng._run_rounds(xs_t, o_in, src, norms, 0, 2, hw=HW,
                                     cfg=cfg)
        _, l2, _ = teng._run_rounds(xs_t, o1, src, norms, 2, 4, hw=HW, cfg=cfg)
        assert not torch.equal(o_in, o1)
        got = [o1.numpy(), l1.numpy()]
        pos = tft.CorruptionSpec._TARGETS[target]
        got[pos] = spec.apply(got[pos], [o_in.numpy(), l2.numpy()][pos])
        with pytest.raises(IntegrityViolation) as ei:
            GuardrailMonitor(FULL_SHADOW).check_shadow(
                start=0, orders=got[0], losses=got[1],
                oracle_orders=o1.numpy(), oracle_losses=l1.numpy())
        assert ei.value.detail["check"] == "replay"
        return
    from repro_torch.kernels import ops
    fwd = ops.fwd_fused

    def perturbed(*args):
        y, m, l = fwd(*args)
        return y * (1 + 1e-3), m, l

    monkeypatch.setattr(ops, "fwd_fused", perturbed)
    sup = AnnealSupervisor(checkpoint_dir=str(tmp_path),
                           degrade=DivergencePolicy(integrity_retries=1))
    out = sup.run(xs, HW, cfg, seed=9, checkpoint_every=1,
                  guardrail=FULL_SHADOW, **CPU)
    incidents = sup.stats["integrity_incidents"]
    assert len(incidents) == 2 and all(
        (r["probe"], r["check"], r["quantity"]) == ("shadow", "apply", "y")
        and r["round"] == 0 for r in incidents)
    assert sup.stats["verified_replays"] == 1
    assert sup.stats["fallbacks"] == [
        "retired kernel tier -> plain PyTorch apply (use_kernel=False)"]
    ref = shuffle_soft_sort_batched(xs, HW, _cfg(), seed=9, **CPU)
    np.testing.assert_array_equal(out.all_orders, ref.all_orders)
    np.testing.assert_array_equal(out.all_losses, ref.all_losses)


def test_injector_corrupts_a_tensor_result_in_place_of_its_form():
    """A tensor result comes back a tensor of its dtype and device,
    corrupted bytewise as ``CorruptionSpec.apply`` corrupts its host copy;
    the stale mode reads the previous call's clean result."""
    calls = []

    def engine():
        calls.append(len(calls))
        return (torch.arange(6).reshape(2, 3) + len(calls),
                torch.full((2, 2), 0.5 * len(calls)))

    inj = tft.FaultInjector(engine, corrupt_calls={
        0: tft.CorruptionSpec("bitflip", "orders", 4),
        2: tft.CorruptionSpec("stale", "losses")})
    o, l = inj()
    assert isinstance(o, torch.Tensor) and o.dtype == torch.int64
    want = tft.CorruptionSpec("bitflip", "orders", 4).apply(
        (torch.arange(6).reshape(2, 3) + 1).numpy(), None)
    assert o.numpy().tobytes() == want.tobytes()
    inj()
    _, l3 = inj()
    assert l3.dtype == torch.float32
    np.testing.assert_array_equal(l3.numpy(), np.full((2, 2), 1.0))
    assert inj.corruptions == 2 and inj.calls == 3

"""The port's adaptive schedule (``repro_torch.core.annealing`` and
``schedule="adaptive"`` of ``repro_torch.core.shufflesoftsort``) against
the JAX reference, on the CPU, and its own contracts.

* The controller alone, port against reference, on identical loss and key
  arrays: the state fields and the ``RungDecision``s bitwise equal over
  several rungs, with and without a band; a reference ``state_dict()``
  loads into the port's controller and continues to the same decisions.
* The engine against the reference: B = 2 problems x S = 2 restarts, the
  port replaying each instance's own JAX key chain (a stopped instance
  draws no more), the reference's normalization.  Rounds executed, rung
  decisions and orders equal; losses within rtol 1e-5.  The std term is
  off (``lambda_sigma=0``), as cold rounds with it on are not
  reproducible to float32 (ROADMAP.md Queue C1), and the controller is
  forced to fire (``patience=1, plateau_rtol=1``), so that jumps and
  early stops happen at a known rung.
* Instances that part ways (``PART``): some fire and some do not, one
  switches to banded while the others stay dense, so one dispatch holds
  instances at different schedule positions and a rung runs a dense and
  a banded group.  Against the reference, and batched against each
  instance alone.
* Inside the port: adaptive equals fixed bitwise when the controller
  never fires; a batched adaptive run equals each instance run alone,
  bitwise; the measured band switch flips instances to banded; the
  shuffle sources advance only the instances that draw.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import annealing as jann  # noqa: E402
from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core.losses import mean_pairwise_distance as jmpd  # noqa: E402
from repro_torch.core import annealing as tann  # noqa: E402
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ReplayShuffleSource,
    TorchShuffleSource,
)
from repro_torch.core.reference import config_from_reference  # noqa: E402

N, HW, D = 64, (8, 8), 3
LOSS_RTOL = 1e-5
# Always-plateau controller: every boundary past the first fires a jump.
FIRE = dict(schedule="adaptive", patience=1, plateau_rtol=1.0,
            adapt_every=2)
# Never-fire controller: patience beyond the number of rungs.
NEVER = dict(schedule="adaptive", patience=10**6)
# Instances that part ways (with ``_parting_xs``).  On a rising
# temperature schedule the random problem's loss keeps falling while the
# sorted field's rises, so only the field's instances fire at the second
# boundary; at band 4 one field instance's keys clear band_eps at the
# first boundary while the other instances' do not.  The third rung then
# runs a dense dispatch at positions (4, 4, 6) beside a banded one.
# (Margins: improvements >= 0.086 or <= -0.05 against 0.02; tail bounds
# 0.039 against 0.05 and >= 0.065.)
PART = dict(schedule="adaptive", patience=1, plateau_rtol=0.02,
            adapt_every=2, tau_start=0.2, tau_end=1.0, band=4,
            band_eps=0.05)


def _port_cfg(cfg):
    return config_from_reference(dataclasses.asdict(cfg))


def _x(seed, b=None, n=N):
    rng = np.random.default_rng(seed)
    shape = (n, D) if b is None else (b, n, D)
    return rng.normal(size=shape).astype(np.float32)


def _parting_xs(seed=31):
    """(2, N, D): a random problem and a smooth field laid out on the grid
    in index order (already sorted, so its loss rises with tau)."""
    rng = np.random.default_rng(seed)
    r, c = np.divmod(np.arange(N), HW[1])
    field = np.stack([r / HW[0], c / HW[1], np.sin(r / 2.0)], 1)
    return np.stack([rng.normal(size=(N, D)),
                     field + 1e-2 * rng.normal(size=(N, D))]
                    ).astype(np.float32)


# ------------------------------------------------------- the controller

def _controllers(bs, band, **kw):
    cfg = jeng.ShuffleSoftSortConfig(rounds=16, band=band, band_eps=1e-3,
                                     schedule="adaptive", adapt_every=2,
                                     **kw)
    j = jeng.make_adaptive_controller(cfg, bs, N)
    t = teng.make_adaptive_controller(_port_cfg(cfg), bs, N)
    return j, t


def _rung_inputs(rng, live, seg, step):
    """Losses that plateau for some instances and fall for others, and
    keys whose spread across the band grows rung by rung."""
    k = live.size
    base = rng.uniform(0.5, 1.0, size=(k, 1)).astype(np.float32)
    slope = np.where(np.arange(k) % 2 == 0, 0.3, 1e-5).astype(np.float32)
    losses = (base * (1 - slope[:, None] * step)
              + rng.normal(scale=1e-6, size=(k, seg))).astype(np.float32)
    ws = (np.arange(N, dtype=np.float32) * (1 + 0.5 * step)
          + rng.normal(scale=0.3, size=(k, N))).astype(np.float32)
    return losses, ws


def _rungs(decisions):
    """RungDecisions as plain tuples: the two packages' classes differ."""
    return [dataclasses.astuple(d) for d in decisions]


def _assert_same_state(j, t):
    for f in tann.AdaptiveController._STATE_FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("band", [None, 4])
@pytest.mark.parametrize("kw", [{}, {"patience": 1, "plateau_rtol": 1e-2},
                                {"decay_rungs": 2, "ewma_alpha": 0.3}])
def test_controller_bitwise_equal_to_reference(band, kw):
    """Both controllers observe the same arrays rung after rung: equal
    decisions, equal state, equal live sets and tau rows."""
    j, t = _controllers(6, band, **kw)
    rng = np.random.default_rng(3)
    step = 0
    while j.live_indices().size:
        live = j.live_indices()
        np.testing.assert_array_equal(t.live_indices(), live)
        np.testing.assert_array_equal(t.tau_rows(live), j.tau_rows(live))
        losses, ws = _rung_inputs(rng, live, j.seg_len, step)
        assert _rungs([t.observe(live, losses, ws)]) == _rungs(
            [j.observe(live, losses, ws)])
        _assert_same_state(j, t)
        step += 1
    assert _rungs(t.decisions) == _rungs(j.decisions)
    assert t.rounds_saved() == j.rounds_saved()
    assert any(d.fired for d in j.decisions)
    if band is not None:
        assert any(d.switched for d in j.decisions)


def test_reference_state_dict_loads_and_continues():
    """A reference controller's ``state_dict()`` after two rungs loads
    into a fresh port controller unchanged; both then make the same
    decisions to the end."""
    j, _ = _controllers(5, 4, patience=1, plateau_rtol=1e-2)
    rng = np.random.default_rng(9)
    for step in range(2):
        live = j.live_indices()
        j.observe(live, *_rung_inputs(rng, live, j.seg_len, step))
    _, t = _controllers(5, 4, patience=1, plateau_rtol=1e-2)
    t.load_state_dict(j.state_dict())
    _assert_same_state(j, t)
    step = 2
    while j.live_indices().size:
        live = j.live_indices()
        np.testing.assert_array_equal(t.live_indices(), live)
        losses, ws = _rung_inputs(rng, live, j.seg_len, step)
        dj, dt = j.observe(live, losses, ws), t.observe(live, losses, ws)
        assert _rungs([dt])[0][1:] == _rungs([dj])[0][1:]
        _assert_same_state(j, t)
        step += 1
    with pytest.raises(ValueError, match="shape"):
        _controllers(4, 4)[1].load_state_dict(j.state_dict())


@pytest.mark.parametrize("kw", [{"rounds": 8, "adapt_every": 2},
                                {"rounds": 40}, {"rounds": 64},
                                {"rounds": 7}, {"rounds": 1}])
def test_adaptive_seg_len_matches_reference(kw):
    cfg = jeng.ShuffleSoftSortConfig(**kw)
    assert tann.adaptive_seg_len(_port_cfg(cfg)) == jann.adaptive_seg_len(cfg)
    bad = teng.ShuffleSoftSortConfig(rounds=8, adapt_every=3)
    with pytest.raises(ValueError, match="adapt_every"):
        tann.adaptive_seg_len(bad)


# ------------------------------------------------- the engine vs the JAX one

def _key_chain_shuffles(keys, rounds, n=N):
    """(R, BS, N): instance i's t-th shuffle from its own key chain, as the
    reference's ragged engine draws it (one split per round run)."""
    out, k = [], keys
    for _ in range(rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        out.append(np.stack([np.asarray(jax.random.permutation(sk, n))
                             for sk in subs]))
    return np.stack(out)


def _recording(monkeypatch, module):
    made = []
    make = module.make_adaptive_controller

    def record(*args, **kw):
        made.append(make(*args, **kw))
        return made[-1]

    monkeypatch.setattr(module, "make_adaptive_controller", record)
    return made


def _recording_dispatches(monkeypatch, made):
    """Record each ragged dispatch of the port's adaptive engine as (rung,
    banded flags, schedule positions, tau rows) of its instances."""
    seen = []
    run = teng._run_rounds_ragged

    def record(xs, orders, source, rows, tau_rows, *args, **kw):
        ctrl = made[-1]
        seen.append((len(ctrl.decisions), tuple(ctrl.banded[rows]),
                     tuple(ctrl.pos[rows]), np.asarray(tau_rows)))
        return run(xs, orders, source, rows, tau_rows, *args, **kw)

    monkeypatch.setattr(teng, "_run_rounds_ragged", record)
    return seen


def _batched_port_and_jax(monkeypatch, xs, cfg, s=2):
    """Both engines on the same problems, the port replaying each
    instance's key chain; returns (reference controller, port controller,
    port result, reference result, the port's dispatches)."""
    keys = jax.random.split(jax.random.PRNGKey(17), xs.shape[0] * s)
    j_made = _recording(monkeypatch, jeng)
    t_made = _recording(monkeypatch, teng)
    dispatches = _recording_dispatches(monkeypatch, t_made)
    want = jeng.shuffle_soft_sort_batched(jnp.asarray(xs), HW, cfg,
                                          n_restarts=s, keys=keys)
    norms = np.asarray(jax.vmap(jmpd)(jnp.asarray(xs)))
    got = teng.shuffle_soft_sort_batched(
        xs, HW, _port_cfg(cfg), n_restarts=s, device="cpu", norms=norms,
        source=ReplayShuffleSource(_key_chain_shuffles(keys, cfg.rounds),
                                   "cpu"))
    (jc,), (tc,) = j_made, t_made
    assert _rungs(tc.decisions) == _rungs(jc.decisions)
    np.testing.assert_array_equal(got.rounds_executed, want.rounds_executed)
    np.testing.assert_array_equal(got.all_orders, want.all_orders)
    np.testing.assert_array_equal(np.isnan(got.all_losses),
                                  np.isnan(want.all_losses))
    np.testing.assert_allclose(got.all_losses, want.all_losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got.best_restart, want.best_restart)
    np.testing.assert_array_equal(got.order, want.order)
    return jc, tc, got, want, dispatches


@pytest.mark.parametrize("use_kernel,band", [(False, None), (True, None),
                                             (True, 8)])
def test_batched_adaptive_matches_jax(monkeypatch, use_kernel, band):
    b, s = 2, 2
    xs = _x(31, b)
    cfg = jeng.ShuffleSoftSortConfig(
        rounds=8, inner_steps=3, chunk=N, lambda_sigma=0.0,
        use_kernel=use_kernel, band=band, band_eps=1e3, **FIRE)
    jc, _, got, _, _ = _batched_port_and_jax(monkeypatch, xs, cfg, s)
    assert any(d.fired for d in jc.decisions)
    assert (band is None) == (not any(d.switched for d in jc.decisions))
    assert (got.rounds_executed < cfg.rounds).all()


def _assert_parted(ctrl, dispatches, rounds):
    """The run parted its instances: one dispatch held instances at
    different schedule positions (and so different tau columns), one rung
    ran a dense and a banded group, some instances stopped early and some
    ran to the end."""
    mixed = [t for _, _, pos, t in dispatches if len(set(pos)) > 1]
    assert mixed and any((t != t[:, :1]).any() for t in mixed)
    groups = {}
    for rung, banded, _, _ in dispatches:
        assert len(set(banded)) == 1          # a dispatch is one regime
        groups.setdefault(rung, set()).add(banded[0])
    assert {False, True} in groups.values()
    assert (ctrl.executed < rounds).any() and (ctrl.executed == rounds).any()
    assert ctrl.banded.any() and not ctrl.banded.all()


@pytest.mark.parametrize("use_kernel", [False, True])
def test_parting_instances_match_jax(monkeypatch, use_kernel):
    """Instances at different schedule positions in one dispatch, and a
    rung split into a dense and a banded group scattered back into the
    batch: the reference's decisions, positions, regimes, rounds executed
    and orders; losses and their EWMAs within rtol 1e-5."""
    cfg = jeng.ShuffleSoftSortConfig(rounds=8, inner_steps=3, chunk=N,
                                     lambda_sigma=0.0,
                                     use_kernel=use_kernel, **PART)
    jc, tc, _, _, dispatches = _batched_port_and_jax(
        monkeypatch, _parting_xs(), cfg)
    # The decision state equal; the EWMA state follows the losses.
    for f in tann.AdaptiveController._STATE_FIELDS:
        a, b = getattr(jc, f), getattr(tc, f)
        if f in ("ewma", "best"):
            np.testing.assert_allclose(b, a, rtol=LOSS_RTOL, err_msg=f)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    _assert_parted(tc, dispatches, cfg.rounds)


def test_sequential_adaptive_matches_jax():
    """``shuffle_soft_sort`` with the adaptive schedule: the executed
    rounds' losses only, and the reference's order."""
    x = _x(33)
    cfg = jeng.ShuffleSoftSortConfig(rounds=8, inner_steps=3, chunk=N,
                                     lambda_sigma=0.0, **FIRE)
    key = jax.random.PRNGKey(4)
    o_j, _, l_j = jeng.shuffle_soft_sort(jnp.asarray(x), HW, cfg, key=key)
    shuffles = _key_chain_shuffles(jnp.asarray(key)[None], cfg.rounds)
    o_t, s_t, l_t = teng.shuffle_soft_sort(
        x, HW, _port_cfg(cfg), device="cpu",
        source=ReplayShuffleSource(shuffles, "cpu"),
        norm=float(jmpd(jnp.asarray(x))))
    assert len(l_t) == len(l_j) < cfg.rounds
    np.testing.assert_array_equal(o_t, np.asarray(o_j))
    np.testing.assert_array_equal(s_t, x[o_t])
    np.testing.assert_allclose(l_t, l_j, rtol=LOSS_RTOL)


# ------------------------------------------------------- inside the port

@pytest.mark.parametrize("use_kernel", [False, True])
def test_adaptive_equals_fixed_when_controller_never_fires(use_kernel):
    """A controller that never fires (and no band) runs the fixed
    schedule bitwise: the same orders and loss traces, sequential and
    batched, every round executed."""
    fixed = teng.ShuffleSoftSortConfig(rounds=8, inner_steps=2, chunk=N,
                                       use_kernel=use_kernel)
    adapt = dataclasses.replace(fixed, **NEVER)
    x = _x(3)
    o_f, s_f, l_f = teng.shuffle_soft_sort(x, HW, fixed, seed=42,
                                           device="cpu")
    o_a, s_a, l_a = teng.shuffle_soft_sort(x, HW, adapt, seed=42,
                                           device="cpu")
    np.testing.assert_array_equal(o_a, o_f)
    np.testing.assert_array_equal(s_a, s_f)
    np.testing.assert_array_equal(np.float32(l_a), np.float32(l_f))

    xs = _x(5, 2)
    res_f = teng.shuffle_soft_sort_batched(xs, HW, fixed, n_restarts=2,
                                           seed=7, device="cpu")
    res_a = teng.shuffle_soft_sort_batched(xs, HW, adapt, n_restarts=2,
                                           seed=7, device="cpu")
    assert res_f.rounds_executed is None
    assert (res_a.rounds_executed == 8).all()
    np.testing.assert_array_equal(res_a.all_orders, res_f.all_orders)
    np.testing.assert_array_equal(res_a.all_losses, res_f.all_losses)
    np.testing.assert_array_equal(res_a.best_restart, res_f.best_restart)


@pytest.mark.parametrize("use_kernel,band", [(False, None), (True, None),
                                             (True, 8)])
def test_adaptive_batched_equals_each_instance_alone(use_kernel, band):
    """Instance (b, s) of a batched adaptive run, early stops included,
    is bitwise the sequential run with its seed: order, executed
    rounds, losses, and NaN past its stop."""
    b, s = 2, 2
    xs = _x(8, b)
    cfg = teng.ShuffleSoftSortConfig(rounds=8, inner_steps=2, chunk=32,
                                     use_kernel=use_kernel, band=band,
                                     band_eps=1e3, **FIRE)
    seeds = [11, 12, 13, 14]
    res = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=s,
                                         seeds=seeds, device="cpu")
    assert (res.rounds_executed < cfg.rounds).all()
    _assert_each_instance_alone(xs, cfg, res, seeds, s)


def _assert_each_instance_alone(xs, cfg, res, seeds, s):
    b = xs.shape[0]
    for i, seed in enumerate(seeds):
        order, _, losses = teng.shuffle_soft_sort(xs[i // s], HW, cfg,
                                                  seed=seed, device="cpu")
        r = int(res.rounds_executed[i // s, i % s])
        assert len(losses) == r
        np.testing.assert_array_equal(res.all_orders[i // s, i % s], order)
        np.testing.assert_array_equal(res.all_losses[i // s, i % s, :r],
                                      np.float32(losses))
        assert np.isnan(res.all_losses[i // s, i % s, r:]).all()
    last = res.all_losses[np.arange(b)[:, None], np.arange(s)[None],
                          res.rounds_executed - 1]
    np.testing.assert_array_equal(res.best_restart, np.argmin(last, axis=1))


def test_parting_batched_equals_each_instance_alone(monkeypatch):
    """The parting run of ``test_parting_instances_match_jax`` batched is
    bitwise each instance run alone: the gathers and scatters of the
    groups move no row to another instance.  On the plain tier: the CPU
    twins' batched products are not bitwise batch-invariant (a 1-ulp loss
    here); the card's kernels are."""
    cfg = teng.ShuffleSoftSortConfig(rounds=8, inner_steps=3, chunk=N,
                                     lambda_sigma=0.0, use_kernel=False,
                                     **PART)
    xs, seeds = _parting_xs(), [21, 22, 23, 24]
    made = _recording(monkeypatch, teng)
    dispatches = _recording_dispatches(monkeypatch, made)
    res = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=2,
                                         seeds=seeds, device="cpu")
    _assert_parted(made[0], dispatches, cfg.rounds)
    _assert_each_instance_alone(xs, cfg, res, seeds, 2)


def test_measured_band_switch_flips_instances_to_banded():
    """With a loose band_eps the measured tail bound clears at the first
    boundary: every instance starts dense, goes banded there and stays
    banded, and the run is deterministic."""
    n, hw = 16, (4, 4)
    cfg = teng.ShuffleSoftSortConfig(rounds=8, inner_steps=2, chunk=n,
                                     band=4, band_eps=1e3, patience=10**6,
                                     schedule="adaptive", adapt_every=2)
    xs = np.random.RandomState(17).rand(2, n, 2).astype(np.float32)
    res1 = teng.shuffle_soft_sort_batched(xs, hw, cfg, device="cpu")
    res2 = teng.shuffle_soft_sort_batched(xs, hw, cfg, device="cpu")
    np.testing.assert_array_equal(res1.all_orders, res2.all_orders)
    np.testing.assert_array_equal(res1.all_losses, res2.all_losses)
    (_, _, _, _, source, xs_t, norms_t, orders, _) = teng._prep_instances(
        xs, hw, 1, 0, None, None, None, None, "cpu")
    ctrl = teng.make_adaptive_controller(cfg, 2, n)
    assert ctrl.band is not None and not ctrl.banded.any()
    teng._run_adaptive(xs_t, orders, source, norms_t, hw=hw, cfg=cfg,
                       controller=ctrl)
    assert ctrl.banded.all()
    assert [d.switched for d in ctrl.decisions] == [2, 0, 0, 0]


def test_adaptive_rounds_saved_and_rejections():
    cfg = teng.ShuffleSoftSortConfig(rounds=8, inner_steps=2, chunk=N,
                                     **FIRE)
    res = teng.shuffle_soft_sort_batched(_x(19)[None], HW, cfg, seed=3,
                                         device="cpu")
    executed = int(res.rounds_executed[0, 0])
    assert 0 < executed < cfg.rounds
    assert int((~np.isnan(res.losses[0])).sum()) == executed
    with pytest.raises(ValueError, match="callback"):
        teng.shuffle_soft_sort(_x(0), HW, cfg, device="cpu",
                               callback=lambda *a: None)
    with pytest.raises(ValueError, match="callback"):
        teng.shuffle_soft_sort_batched(_x(0, 1), HW, cfg, device="cpu",
                                       callback=lambda *a: None)
    state = (np.arange(N)[None], np.zeros((1, 2), np.float32))
    with pytest.raises(ValueError, match="state"):
        teng.shuffle_soft_sort_batched(_x(0, 1), HW, cfg, device="cpu",
                                       state=state)
    with pytest.raises(ValueError, match="schedule"):
        teng.shuffle_soft_sort_batched(
            _x(0, 1), HW, dataclasses.replace(cfg, schedule="bogus"),
            device="cpu")


def test_check_finite_reports_non_finite_keys():
    cfg = teng.ShuffleSoftSortConfig(rounds=8)
    ws = np.zeros((2, 4), np.float32)
    teng._check_finite(np.ones((2, 2)), 2, cfg, "adaptive", ws=ws)
    ws[1, 3] = np.nan
    with pytest.raises(teng.NumericalDivergence, match="keys") as err:
        teng._check_finite(np.ones((2, 2)), 2, cfg, "adaptive", ws=ws)
    assert err.value.round == 3


@pytest.mark.parametrize("kind", ["torch", "replay"])
def test_sources_advance_only_the_rows_drawn(kind):
    """Instance i's t-th draw is the same whatever other instances draw
    in between, as each reference instance splits its own key."""
    n = 10

    def source():
        if kind == "torch":
            return TorchShuffleSource([5, 6, 7], n, "cpu")
        rng = np.random.default_rng(0)
        return ReplayShuffleSource(
            np.stack([[rng.permutation(n) for _ in range(3)]
                      for _ in range(3)]), "cpu")

    a = source()
    r1, r2 = a.next_round(), a.next_round()
    b = source()
    assert torch.equal(b.next_round([2]), r1[2:3])
    got = b.next_round()
    assert torch.equal(got[:2], r1[:2]) and torch.equal(got[2], r2[2])
    assert torch.equal(b.next_round([1, 0]), torch.stack([r2[1], r2[0]]))
    if kind == "replay":
        b.next_round([2])
        with pytest.raises(IndexError):
            b.next_round([2])

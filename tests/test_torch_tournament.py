"""The port's restart tournament and round segments
(``restart_tournament``, ``run_round_segment``, ``rung_aligned_switch`` of
``repro_torch.core.shufflesoftsort``) against the JAX reference, on the
CPU, and their own contracts.

* The host bookkeeping (``_rung_boundaries``, ``_tournament_cull``,
  ``rung_aligned_switch``): exactly the reference's results over a grid of
  inputs, ties and more rungs than rounds included.
* The tournament against the reference, fixed and adaptive schedules: the
  port replays each instance's own JAX key chain (a culled instance draws
  no more) and takes the reference's normalization.  Survivors, rounds
  run and full, the NaN pattern of ``all_losses``, winners and orders
  equal; losses within rtol 1e-5.  The std term is off
  (``lambda_sigma=0``): cold rounds with it on are not reproducible to
  float32 (ROADMAP.md Queue C1).  At every cull the reference's margin
  between the last kept and the first culled loss must exceed that
  tolerance, so a near-tie fails here instead of flaking.
* ``run_round_segment`` against the reference's, with mixed progress and
  keys advanced to each instance's round.
* Inside the port, on the plain tier (the CPU twins of the kernels are
  not bitwise batch-invariant, ROADMAP.md Queue C6): no cull or one rung
  is bitwise the batched engine; a restart that survives every cull is
  bitwise its batched run; the bookkeeping; chained segments over any
  partition are bitwise one uninterrupted run; the regime checks raise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core.losses import mean_pairwise_distance as jmpd  # noqa: E402
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core.prng import (  # noqa: E402
    ReplayShuffleSource,
    TorchShuffleSource,
    instance_seeds,
)
from repro_torch.core.reference import config_from_reference  # noqa: E402

N, HW, D = 16, (4, 4), 3
LOSS_RTOL = 1e-5
# Always-plateau controller: every boundary past the first fires a jump.
FIRE = dict(schedule="adaptive", patience=1, plateau_rtol=1.0,
            adapt_every=2)


def _port_cfg(cfg):
    return config_from_reference(dataclasses.asdict(cfg))


def _xs(seed, b, n=N):
    return np.random.default_rng(seed).normal(size=(b, n, D)).astype(
        np.float32)


def _key_chain_shuffles(keys, rounds, n=N):
    """(R, BS, N): instance i's t-th shuffle from its own key chain (one
    split per round run), as every reference engine draws it."""
    out, k = [], keys
    for _ in range(rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        out.append(np.stack([np.asarray(jax.random.permutation(sk, n))
                             for sk in subs]))
    return np.stack(out)


# ------------------------------------------------------ host bookkeeping

@pytest.mark.parametrize("rounds", [1, 2, 3, 5, 6, 7, 10, 32, 80])
def test_rung_boundaries_match_reference(rounds):
    for n_rungs in range(1, 12):       # more rungs than rounds included
        assert teng._rung_boundaries(rounds, n_rungs) == \
            jeng._rung_boundaries(rounds, n_rungs), (rounds, n_rungs)
    with pytest.raises(ValueError):
        teng._rung_boundaries(rounds, 0)


@pytest.mark.parametrize("seed", range(4))
def test_tournament_cull_matches_reference(seed):
    rng = np.random.default_rng(seed)
    for b, s_k in ((1, 1), (2, 4), (3, 8), (4, 5)):
        # Coarse values: many ties, which the stable sort breaks by slot.
        losses = np.round(rng.uniform(size=(b, s_k)), 1).astype(np.float32)
        for keep in range(1, s_k + 1):
            got = teng._tournament_cull(losses, keep)
            np.testing.assert_array_equal(
                got, jeng._tournament_cull(losses, keep))
            assert got.dtype == np.int64
    with pytest.raises(ValueError):
        teng._tournament_cull(np.zeros((2, 3), np.float32), 4)


@pytest.mark.parametrize("band,band_eps,rounds", [
    (None, 1e-6, 32), (4, 1e-6, 32), (8, 1e-3, 40), (24, 1e-6, 16),
    ("auto", 1e-6, 32), ("auto", 1e-6, 7), (4, 1e3, 10)])
def test_rung_aligned_switch_matches_reference(band, band_eps, rounds):
    cfg = jeng.ShuffleSoftSortConfig(rounds=rounds, band=band,
                                     band_eps=band_eps)
    for n in (16, 64, 256, 4096):
        for seg_len in (1, 2, 3, 5, 8, rounds):
            assert teng.rung_aligned_switch(_port_cfg(cfg), n, seg_len) == \
                jeng.rung_aligned_switch(cfg, n, seg_len), (n, seg_len)


# ------------------------------------------------- tournament vs the JAX one

def _assert_cull_margins(want, rounds_at_edges, tol=LOSS_RTOL):
    """At each interior edge, the reference's last kept and first culled
    rung-end losses differ by more than ``tol`` relative."""
    b, s = want.all_losses.shape[:2]
    alive = np.tile(np.arange(s), (b, 1))
    for k, sv in enumerate(want.survivors[:-1]):
        keep = sv.shape[1]
        for p in range(b):
            last = np.array([_last_before(want.all_losses[p, r],
                                          rounds_at_edges[k])
                             for r in alive[p]])
            ranked = np.sort(last)
            if keep < ranked.size:
                margin = ranked[keep] - ranked[keep - 1]
                assert margin > tol * abs(ranked[keep]), (k, p, ranked)
        alive = sv


def _last_before(trace, end):
    """The last non-NaN loss of ``trace[:end]``."""
    head = trace[:end]
    return head[~np.isnan(head)][-1]


def _tournaments(xs, cfg, s, **kw):
    """Both packages' tournaments on the same problems, the port replaying
    each instance's key chain and taking the reference's norms."""
    keys = jax.random.split(jax.random.PRNGKey(23), xs.shape[0] * s)
    want = jeng.restart_tournament(jnp.asarray(xs), HW, cfg, n_restarts=s,
                                   keys=keys, **kw)
    norms = np.asarray(jax.vmap(jmpd)(jnp.asarray(xs)))
    got = teng.restart_tournament(
        xs, HW, _port_cfg(cfg), n_restarts=s, device="cpu", norms=norms,
        source=ReplayShuffleSource(_key_chain_shuffles(keys, cfg.rounds),
                                   "cpu"), **kw)
    return got, want


def _assert_same_tournament(got, want):
    assert len(got.survivors) == len(want.survivors)
    for a, b in zip(got.survivors, want.survivors):
        np.testing.assert_array_equal(a, b)
    assert got.rounds_run == want.rounds_run
    assert got.rounds_full == want.rounds_full
    np.testing.assert_array_equal(np.isnan(got.all_losses),
                                  np.isnan(want.all_losses))
    np.testing.assert_allclose(got.all_losses, want.all_losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got.best_restart, want.best_restart)
    np.testing.assert_array_equal(got.order, want.order)
    np.testing.assert_allclose(got.final_loss, want.final_loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_array_equal(got.sorted, np.asarray(want.sorted))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fixed_tournament_matches_jax(use_kernel):
    cfg = jeng.ShuffleSoftSortConfig(rounds=6, inner_steps=3, chunk=N,
                                     lambda_sigma=0.0, use_kernel=use_kernel)
    got, want = _tournaments(_xs(41, 2), cfg, 4, cull_fraction=0.5,
                             n_rungs=3)
    assert [sv.shape[1] for sv in want.survivors] == [2, 1, 1]
    _assert_cull_margins(want, jeng._rung_boundaries(cfg.rounds, 3))
    _assert_same_tournament(got, want)


def test_adaptive_tournament_matches_jax():
    """``FIRE``: rungs of 2 rounds, culls at controller steps 1 and 3 (of
    4); the instances jump and stop early.  The executed rounds equal
    too."""
    cfg = jeng.ShuffleSoftSortConfig(rounds=8, inner_steps=3, chunk=N,
                                     lambda_sigma=0.0, **FIRE)
    got, want = _tournaments(_xs(43, 2), cfg, 4, cull_fraction=0.5,
                             n_rungs=3)
    executed = (~np.isnan(got.all_losses)).sum(axis=2)
    assert (executed < cfg.rounds).all()
    assert got.rounds_run == int(executed.sum()) < got.rounds_full
    seg = cfg.adapt_every
    edges = [e * seg for e in jeng._rung_boundaries(cfg.rounds // seg, 3)]
    _assert_cull_margins(want, edges)
    _assert_same_tournament(got, want)


@pytest.mark.parametrize("band,band_eps", [(None, 1e-6), (8, 1e3)])
def test_run_round_segment_matches_jax(band, band_eps):
    """Four instances at rounds (0, 0, 2, 2), two chained segments of 2:
    the port's source replays each key chain from the instance's round;
    the reference gets the key advanced to it.  Dense, and banded (the
    regime inferred from the rung-aligned switch at round 0)."""
    n, hw, rounds, seg = 64, (8, 8), 8, 2
    cfg = jeng.ShuffleSoftSortConfig(rounds=rounds, inner_steps=3, chunk=n,
                                     lambda_sigma=0.0, band=band,
                                     band_eps=band_eps)
    assert jeng.rung_aligned_switch(cfg, n, seg) == (
        rounds if band is None else 0)
    xs = _xs(45, 4, n)
    progress = np.array([0, 0, 2, 2])
    keys = jax.random.split(jax.random.PRNGKey(29), 4)
    shuffles = _key_chain_shuffles(keys, rounds, n)
    for i, p in enumerate(progress):             # advance the key chains
        for _ in range(p):
            keys = keys.at[i].set(jax.random.split(keys[i])[0])
    rng = np.random.default_rng(5)
    orders = np.stack([rng.permutation(n) for _ in range(4)]).astype(
        np.int32)
    norms = np.asarray(jax.vmap(jmpd)(jnp.asarray(xs)))
    source = ReplayShuffleSource(shuffles, "cpu")
    source.pos[:] = progress
    o_j, k_j, o_t = jnp.asarray(orders), keys, torch.tensor(orders)
    for step in range(2):
        o_j, k_j, l_j = jeng.run_round_segment(
            jnp.asarray(xs), o_j, k_j, jnp.asarray(norms),
            progress + step * seg, seg, hw=hw, cfg=cfg)
        o_t, l_t = teng.run_round_segment(
            xs, o_t, norms, progress + step * seg, seg, source=source,
            hw=hw, cfg=_port_cfg(cfg), device="cpu")
        np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j),
                                   rtol=LOSS_RTOL)
    np.testing.assert_array_equal(source.pos, progress + 2 * seg)


# ------------------------------------------------------- inside the port

def _plain(**kw):
    return teng.ShuffleSoftSortConfig(inner_steps=2, chunk=N, **kw)


SCHEDULES = {"fixed": dict(rounds=6), "adaptive": dict(rounds=8, **FIRE)}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_no_cull_or_one_rung_is_the_batched_run(schedule):
    cfg = _plain(**SCHEDULES[schedule])
    xs = _xs(51, 2)
    ref = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=3, seed=4,
                                         device="cpu")
    for kw in ({"cull_fraction": 0.0, "n_rungs": 3}, {"n_rungs": 1}):
        res = teng.restart_tournament(xs, HW, cfg, n_restarts=3, seed=4,
                                      device="cpu", **kw)
        np.testing.assert_array_equal(res.order, ref.order)
        np.testing.assert_array_equal(res.sorted, ref.sorted)
        np.testing.assert_array_equal(res.best_restart, ref.best_restart)
        np.testing.assert_array_equal(res.all_losses, ref.all_losses)
        assert all((sv == np.arange(3)).all() for sv in res.survivors)
        if schedule == "fixed":
            assert res.rounds_run == res.rounds_full
        else:
            assert res.rounds_run == int(ref.rounds_executed.sum())


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_survivors_are_bitwise_their_batched_runs(schedule):
    """Every restart alive at the end, the winner included, has the loss
    trace of the same (b, s) instance of the batched engine, and the
    winner its order: culling never perturbs a survivor."""
    cfg = _plain(**SCHEDULES[schedule])
    b, s = 3, 4
    xs = _xs(53, b)
    res = teng.restart_tournament(xs, HW, cfg, n_restarts=s, seed=9,
                                  device="cpu", cull_fraction=0.5,
                                  n_rungs=3)
    ref = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=s, seed=9,
                                         device="cpu")
    assert res.rounds_run < res.rounds_full
    for p in range(b):
        for r in res.survivors[-1][p]:
            np.testing.assert_array_equal(res.all_losses[p, r],
                                          ref.all_losses[p, r])
        w = res.best_restart[p]
        assert w in res.survivors[-1][p]
        np.testing.assert_array_equal(res.order[p], ref.all_orders[p, w])
        assert res.final_loss[p] == ref.all_losses[p, w][
            ~np.isnan(ref.all_losses[p, w])][-1]


def test_tournament_bookkeeping():
    b, s = 2, 8
    cfg = _plain(rounds=6)
    starts = []
    res = teng.restart_tournament(_xs(55, b), HW, cfg, n_restarts=s,
                                  seed=8, device="cpu", cull_fraction=0.5,
                                  n_rungs=3, rung_hook=starts.append)
    assert starts == [0, 2, 4]
    assert [sv.shape for sv in res.survivors] == [(b, 4), (b, 2), (b, 2)]
    alive = np.tile(np.arange(s), (b, 1))
    for k, sv in enumerate(res.survivors):      # nested, NaN once culled
        for p in range(b):
            assert set(sv[p]) <= set(alive[p])
            for r in set(alive[p]) - set(sv[p]):
                trace = res.all_losses[p, r]
                assert np.isfinite(trace[:2 * (k + 1)]).all()
                assert np.isnan(trace[2 * (k + 1):]).all()
        alive = sv
    for p in range(b):
        assert np.isfinite(res.all_losses[p, res.survivors[-1][p]]).all()
    assert res.rounds_run == b * (8 * 2 + 4 * 2 + 2 * 2)
    assert res.rounds_full == b * s * cfg.rounds
    with pytest.raises(ValueError, match="cull_fraction"):
        teng.restart_tournament(_xs(55, 1), HW, cfg, device="cpu",
                                cull_fraction=1.0)


def test_adaptive_tournament_bookkeeping():
    """Culls land on controller steps; the engine's instance-rounds are
    the rounds every instance executed; the rung hook sees each rung's
    executed rounds."""
    b, s = 2, 4
    cfg = _plain(rounds=8, **FIRE)
    starts = []
    res = teng.restart_tournament(_xs(57, b), HW, cfg, n_restarts=s,
                                  seed=2, device="cpu", cull_fraction=0.5,
                                  n_rungs=3, rung_hook=starts.append)
    assert starts == sorted(set(starts)) and starts[0] == 0
    assert all(t % cfg.adapt_every == 0 for t in starts)
    assert [sv.shape[1] for sv in res.survivors] == [2, 1, 1]
    executed = (~np.isnan(res.all_losses)).sum(axis=2)
    assert res.rounds_run == int(executed.sum())
    # A restart culled at an edge ran no round past it.
    edge_rounds = [2 * e for e in teng._rung_boundaries(4, 3)]
    alive = np.tile(np.arange(s), (b, 1))
    for end, sv in zip(edge_rounds, res.survivors):
        for p in range(b):
            for r in set(alive[p]) - set(sv[p]):
                assert executed[p, r] <= end
                assert np.isnan(res.all_losses[p, r, executed[p, r]:]).all()
        alive = sv


def test_run_adaptive_counts_rounds_and_calls_its_hooks():
    cfg = _plain(rounds=8, **FIRE)
    (_, _, _, _, source, xs_t, norms_t, orders, _) = teng._prep_instances(
        _xs(59, 2), HW, 2, 3, None, None, None, None, "cpu")
    ctrl = teng.make_adaptive_controller(cfg, 4, N)
    rungs, bounds = [], []
    _, losses, device_rounds = teng._run_adaptive(
        xs_t, orders, source, norms_t, hw=HW, cfg=cfg, controller=ctrl,
        rung_hook=rungs.append,
        boundary_hook=lambda step, c, l: bounds.append(
            (step, int(np.isfinite(l).sum()))))
    assert device_rounds == int(ctrl.executed.sum()) == int(
        np.isfinite(losses).sum())
    assert rungs == [2 * k for k in range(len(bounds))]
    assert [st for st, _ in bounds] == list(range(1, len(bounds) + 1))
    assert bounds[-1][1] == device_rounds


@pytest.mark.parametrize("kw,item", [
    ({"mesh_hook": lambda start, mesh: None}, "A11"),
    ({"resume": True}, "A10"), ({"checkpoint_dir": "ckpt"}, "A10"),
    ({"mesh": object()}, "A11"), ({"guardrail": object()}, "A12")])
def test_tournament_refuses_unported_features(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        teng.restart_tournament(_xs(0, 1), HW, _plain(rounds=2),
                                device="cpu", **kw)


@pytest.mark.parametrize("bs", [1, 3, 8, 11, 16])
def test_loss_blocks_equal_one_batch_on_the_cpu(bs):
    """The engine's loss in padded blocks of 8 instances (``_loss_fn``
    with ``pad_rows``) gives every instance the loss and the gradients of
    one batch: the pad rows reach neither the losses nor the gradients.
    (On the card the blocks are what makes them batch-invariant,
    ``chip_smoke.py`` ``loss_block_check``.)"""
    from repro_torch.core.losses import grid_sorting_loss

    rng = np.random.default_rng(bs)
    y, x = (torch.tensor(rng.normal(size=(bs, N, D)), dtype=torch.float32)
            for _ in range(2))
    c = torch.tensor(1 + 0.1 * rng.normal(size=(bs, N)), dtype=torch.float32)
    norm = torch.tensor(1 + rng.uniform(size=bs), dtype=torch.float32)
    cfg = teng.ShuffleSoftSortConfig()
    runs = []
    for blocked in (False, True):
        yv, cv = y.clone().requires_grad_(True), c.clone().requires_grad_(True)
        if blocked:
            loss = teng._loss_fn(None, x, torch.arange(N).expand(bs, N), None,
                                 HW, norm, cfg, lambda w, xs, t: (yv, cv),
                                 pad_rows=True)
        else:
            loss = grid_sorting_loss(yv, cv, x, HW, norm)
        runs.append((loss, *torch.autograd.grad(loss.sum(), (yv, cv))))
    for one, blocks in zip(*runs):
        assert torch.equal(blocks, one)


@pytest.mark.parametrize("split", [[6], [1] * 6, [2, 4], [5, 1], [1, 3, 2],
                                   [3, 3]])
def test_chained_segments_equal_one_run(split):
    """Any partition of the schedule into segments, each instance drawing
    from its own stream: bitwise one uninterrupted ``_run_rounds``."""
    cfg = _plain(rounds=6)
    xs, seeds = _xs(61, 2), instance_seeds(61, 2)
    norms, orders = torch.ones(2), torch.arange(N).repeat(2, 1)
    want_o, want_l = teng._run_rounds(
        torch.tensor(xs), orders, TorchShuffleSource(seeds, N, "cpu"), norms,
        0, hw=HW, cfg=cfg)
    source = TorchShuffleSource(seeds, N, "cpu")
    o, parts, pos = orders, [], 0
    for seg in split:
        o, l = teng.run_round_segment(xs, o, norms, [pos] * 2, seg,
                                      source=source, hw=HW, cfg=cfg,
                                      device="cpu")
        parts.append(l)
        pos += seg
    assert torch.equal(o, want_o)
    assert torch.equal(torch.cat(parts), want_l)


def test_mixed_progress_rows_equal_each_instance_alone():
    """A segment over instances at rounds 0 and 2 (rows 1 and 3 of a
    four-instance source) gives each row what the instance gives alone,
    and ``with_w`` returns the trained keys."""
    cfg = _plain(rounds=6)
    xs = _xs(63, 2)
    seeds = instance_seeds(63, 4)
    orders = torch.stack([torch.randperm(N, generator=torch.Generator(
    ).manual_seed(i)) for i in range(2)])
    progress, rows = np.array([0, 2]), np.array([1, 3])

    def source():
        src = TorchShuffleSource(seeds, N, "cpu")
        src.next_round([3])
        src.next_round([3])                 # instance 3 is at round 2
        return src

    o, l, w = teng.run_round_segment(xs, orders, torch.ones(2), progress, 2,
                                     source=source(), rows=rows, hw=HW,
                                     cfg=cfg, device="cpu", with_w=True)
    assert w.shape == (2, N)
    for i in range(2):
        o_i, l_i = teng.run_round_segment(
            xs[i:i + 1], orders[i:i + 1], torch.ones(1), progress[i:i + 1],
            2, source=source(), rows=rows[i:i + 1], hw=HW, cfg=cfg,
            device="cpu")
        assert torch.equal(o_i[0], o[i]) and torch.equal(l_i[:, 0], l[:, i])


def test_segment_regime_checks_raise():
    n, hw = 64, (8, 8)
    cfg = teng.ShuffleSoftSortConfig(rounds=8, inner_steps=1, chunk=n,
                                     band=8, band_eps=0.01)
    switch = teng.rung_aligned_switch(cfg, n, 2)
    assert switch == 4 and teng._band_switch_round(cfg, n) == 3
    xs = _xs(65, 2, n)
    orders = torch.arange(n).repeat(2, 1)

    def seg(progress, length=2, config=cfg, **kw):
        return teng.run_round_segment(
            xs, orders, torch.ones(2), progress, length,
            source=TorchShuffleSource([1, 2], n, "cpu"), hw=hw, cfg=config,
            device="cpu", **kw)

    with pytest.raises(ValueError, match="mix apply regimes"):
        seg([0, switch])                    # one dense, one banded
    with pytest.raises(ValueError, match="mix apply regimes"):
        seg([switch - 2, switch - 2], 4)    # straddles the switch
    with pytest.raises(ValueError, match="escapes"):
        seg([6, 6], 4)
    with pytest.raises(ValueError, match="regime"):
        seg([0, 0], regime="sparse")
    with pytest.raises(ValueError, match="resolvable"):
        seg([0, 0], config=dataclasses.replace(cfg, band=None),
            regime="banded")
    with pytest.raises(NotImplementedError, match="A11"):
        seg([0, 0], mesh=object())
    with pytest.raises(NotImplementedError, match="A12"):
        seg([0, 0], guardrail=object())
    # Explicit regimes bypass the model's check (the caller groups).
    for regime in ("dense", "banded"):
        o, l = seg([0, switch], regime=regime)
        assert l.shape == (2, 2)

"""The port's ShuffleSoftSort engine (``repro_torch.core.shufflesoftsort``)
against the JAX reference, on the CPU, with ``use_kernel=True`` on both
sides (the port's kernel wrappers run their plain twins here, the
reference its Pallas kernels in interpret mode).

The port draws its shuffles from a replay source filled from the
reference's own key chain, and takes the reference's loss normalization
through ``norm=``/``norms=``, so both engines see identical inputs.

What is compared, and why:

* ``_tau_schedule``: exactly equal;
* committed orders: exactly equal, and per-round losses within rtol 1e-5
  (float32 sums reduced in different orders), in every round whose first
  inner temperature ``ramp * tau_r`` still resolves an off-diagonal
  SoftSort weight ``exp(-1 / tau)`` above float32 epsilon, and in every
  round of a run with the std term off (``lambda_sigma=0``);
* colder rounds with the std term on: valid permutations, and losses
  within the 2e-2 envelope the reference accepts between two correct
  implementations.  There the soft-sorted layout differs from the input
  by less than one float32 ulp, so the argument of ``|sigma_X -
  sigma_Y|`` in the std term (eq. 4) is rounding noise: the sign of that
  term's key gradient is not determined by the inputs, in the reference
  as in the port, and Adam's first step normalizes the resulting ~1e-8
  gradient to a full step of either sign.  Which adjacent items swap then
  depends on the summation order of each framework.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core.losses import mean_pairwise_distance as jmpd  # noqa: E402
from repro_torch.core import shufflesoftsort as teng  # noqa: E402
from repro_torch.core.prng import ReplayShuffleSource  # noqa: E402
from repro_torch.core.reference import (  # noqa: E402
    config_from_reference,
    state_from_reference,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N, HW, D = 64, (8, 8), 3
LOSS_RTOL = 1e-5
COLD_LOSS_RTOL = 2e-2


def _jcfg(**kw):
    return jeng.ShuffleSoftSortConfig(use_kernel=True, rounds=6,
                                      inner_steps=4, **kw)


def _port_cfg(cfg):
    return config_from_reference(dataclasses.asdict(cfg))


def _warm_rounds(cfg) -> np.ndarray:
    """Rounds whose first inner temperature resolves exp(-1/tau) above
    float32 epsilon (see the module docstring)."""
    tau0 = jeng._tau_schedule(cfg) * np.float32(cfg.inner_tau_ramp)
    if cfg.lambda_sigma == 0:
        return np.ones(cfg.rounds, bool)
    return np.exp(-1.0 / tau0.astype(np.float64)) > np.finfo(np.float32).eps


def _assert_rounds_match(cfg, got, want, first_round=0):
    """got/want: per-round lists of (orders, losses) arrays."""
    warm = _warm_rounds(cfg)
    assert len(got) == len(want)
    for k, ((og, lg), (ow, lw)) in enumerate(zip(got, want)):
        r = first_round + k
        if warm[r]:
            np.testing.assert_array_equal(og, ow, err_msg=f"round {r}")
            np.testing.assert_allclose(lg, lw, rtol=LOSS_RTOL,
                                       err_msg=f"round {r}")
        else:
            for row in np.asarray(og).reshape(-1, N):
                assert np.array_equal(np.sort(row), np.arange(N)), r
            np.testing.assert_allclose(lg, lw, rtol=COLD_LOSS_RTOL,
                                       err_msg=f"round {r}")
    assert warm[first_round:first_round + len(got)].any()


def _x(seed, b=None):
    rng = np.random.default_rng(seed)
    shape = (N, D) if b is None else (b, N, D)
    return rng.normal(size=shape).astype(np.float32)


def _sequential_shuffles(key, rounds):
    """The reference's key chain: key, sub = split(key); permutation(sub)."""
    out = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sub, N)))
    return np.stack(out)[:, None]                         # (R, 1, N)


def _jax_sequential(x, cfg, key):
    rec = []
    jeng.shuffle_soft_sort(jnp.asarray(x), HW, cfg, key=key,
                           callback=lambda r, o, l: rec.append(
                               (np.asarray(o).copy(), np.float32(l))))
    return rec


@pytest.fixture(scope="module", params=[2.0, 0.0], ids=["std", "no_std"])
def sequential_reference(request):
    """The reference's sequential run, with the paper's lambda_sigma=2 and
    with the std term off."""
    x, key = _x(1), jax.random.PRNGKey(5)
    cfg = _jcfg(lambda_sigma=request.param)
    return x, key, cfg, _jax_sequential(x, cfg, key)


def test_tau_schedule_bitwise_equal():
    for kw in ({}, {"rounds": 37, "tau_start": 2.0, "tau_end": 0.05},
               {"rounds": 1}):
        jc = jeng.ShuffleSoftSortConfig(**kw)
        got = teng._tau_schedule(_port_cfg(jc))
        want = jeng._tau_schedule(jc)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_one_outer_round_matches_jax():
    """Same incoming order and shuffle: same committed order, loss within
    rtol 1e-5 (round 0, the warm end of the schedule)."""
    x = _x(2)
    cfg = _jcfg()
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(3)
    order = rng.permutation(N).astype(np.int32)
    norm = jmpd(jnp.asarray(x))
    tau_r = jnp.float32(jeng._tau_schedule(cfg)[0])
    o_j, l_j = jeng._outer_round_impl(
        jnp.asarray(x), jnp.asarray(order), key, tau_r, norm, hw=HW, cfg=cfg,
        apply_fn=jeng._select_apply_fn(cfg))

    tcfg = _port_cfg(cfg)
    shuf = torch.tensor(np.asarray(jax.random.permutation(key, N)))[None]
    tau_inner = torch.tensor(teng._inner_taus(tcfg)[0])
    t = torch.arange(1, tcfg.inner_steps + 1, dtype=torch.float32)
    o_t, l_t = teng._outer_round(
        torch.tensor(x)[None], torch.tensor(order, dtype=torch.int64)[None],
        shuf, tau_inner, torch.tensor([float(norm)]), 1 - tcfg.b1 ** t,
        1 - tcfg.b2 ** t, hw=HW, cfg=tcfg,
        apply_fn=teng._select_apply_fn(tcfg))
    np.testing.assert_array_equal(o_t[0].numpy(), np.asarray(o_j))
    np.testing.assert_allclose(float(l_t[0]), float(l_j), rtol=LOSS_RTOL)


def _port_sequential(x, cfg, shuffles, norm, **kw):
    rec = []
    teng.shuffle_soft_sort(x, HW, _port_cfg(cfg), device="cpu",
                           source=ReplayShuffleSource(shuffles, "cpu"),
                           norm=norm,
                           callback=lambda r, o, l: rec.append((o, l)), **kw)
    return rec


def test_sequential_slice_matches_jax(sequential_reference):
    """The whole slice, sequential: 6 rounds x 4 inner steps through the
    kernel tier."""
    x, key, cfg, want = sequential_reference
    got = _port_sequential(x, cfg, _sequential_shuffles(key, cfg.rounds),
                           float(jmpd(jnp.asarray(x))))
    _assert_rounds_match(cfg, got, want)


@pytest.mark.parametrize("lambda_sigma", [2.0, 0.0], ids=["std", "no_std"])
def test_batched_slice_matches_jax(lambda_sigma):
    """B=2 problems x S=2 restarts with explicit keys: the per-round split
    of every instance key feeds the replay source."""
    b, s = 2, 2
    xs = _x(7, b)
    cfg = _jcfg(lambda_sigma=lambda_sigma)
    keys = jax.random.split(jax.random.PRNGKey(21), b * s)
    want = []
    jeng.shuffle_soft_sort_batched(
        jnp.asarray(xs), HW, cfg, n_restarts=s, keys=keys,
        callback=lambda r, o, l: want.append((np.asarray(o).copy(),
                                              np.asarray(l).copy())))
    shuffles, k = [], keys
    for _ in range(cfg.rounds):
        pair = jax.vmap(jax.random.split)(k)
        k, subs = pair[:, 0], pair[:, 1]
        shuffles.append(np.stack([np.asarray(jax.random.permutation(sk, N))
                                  for sk in subs]))
    norms = np.asarray(jax.vmap(jmpd)(jnp.asarray(xs)))
    got = []
    res = teng.shuffle_soft_sort_batched(
        xs, HW, _port_cfg(cfg), n_restarts=s, device="cpu",
        source=ReplayShuffleSource(np.stack(shuffles), "cpu"), norms=norms,
        callback=lambda r, o, l: got.append((o, l)))
    _assert_rounds_match(cfg, got, want)
    assert res.all_orders.shape == (b, s, N)
    assert res.all_losses.shape == (b, s, cfg.rounds)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_port_batched_equals_sequential(use_kernel):
    """Inside the port: instance i of a batched run equals a sequential run
    with seed ``seeds[i]`` — equal orders and bitwise-equal losses."""
    b, s = 2, 2
    xs = _x(8, b)
    cfg = teng.ShuffleSoftSortConfig(use_kernel=use_kernel, rounds=5,
                                     inner_steps=3, chunk=32)
    seeds = [11, 12, 13, 14]
    res = teng.shuffle_soft_sort_batched(xs, HW, cfg, n_restarts=s,
                                         seeds=seeds, device="cpu")
    for i, seed in enumerate(seeds):
        order, sorted_x, losses = teng.shuffle_soft_sort(
            xs[i // s], HW, cfg, seed=seed, device="cpu")
        np.testing.assert_array_equal(res.all_orders[i // s, i % s], order)
        np.testing.assert_array_equal(
            res.all_losses[i // s, i % s], np.asarray(losses, np.float32))
        np.testing.assert_array_equal(sorted_x, xs[i // s][order])
    best = np.argmin(res.all_losses[:, :, -1], axis=1)
    np.testing.assert_array_equal(res.best_restart, best)


def test_bfloat16_kernel_tier_anneals():
    """compute_dtype="bfloat16" runs the bf16 twins end to end: valid
    permutations, finite losses that fall, and the float32 run's
    interface."""
    cfg = teng.ShuffleSoftSortConfig(use_kernel=True, rounds=6,
                                     inner_steps=4,
                                     compute_dtype="bfloat16")
    res = teng.shuffle_soft_sort_batched(_x(9, 2), HW, cfg, n_restarts=2,
                                         device="cpu")
    for row in res.all_orders.reshape(-1, N):
        assert np.array_equal(np.sort(row), np.arange(N))
    assert np.isfinite(res.all_losses).all()
    assert (res.all_losses[..., -1] < res.all_losses[..., 0]).all()


def test_state_carried_across_from_jax(sequential_reference, tmp_path):
    """A JAX run checkpointed and stopped after round 3, continued by the
    port for rounds 3-5, matches the uninterrupted 6-round JAX run."""
    from repro.runtime.anneal_checkpoint import AnnealCheckpointer

    x, key, cfg, want = sequential_reference

    def stop(r):
        if r == 3:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        jeng.shuffle_soft_sort(jnp.asarray(x), HW, cfg, key=key,
                               checkpoint_dir=str(tmp_path),
                               checkpoint_every=3, rung_hook=stop)
    state, start, _ = AnnealCheckpointer(str(tmp_path)).restore_latest()
    assert start == 3
    tcfg = config_from_reference(dataclasses.asdict(cfg))
    orders, prior = state_from_reference(state, "cpu")
    source = ReplayShuffleSource(_sequential_shuffles(key, cfg.rounds)[3:],
                                 "cpu")
    got = []
    _, _, losses = teng.shuffle_soft_sort(
        x, HW, tcfg, device="cpu", source=source,
        norm=float(jmpd(jnp.asarray(x))), state=(orders, prior),
        callback=lambda r, o, l: got.append((o, l)))
    _assert_rounds_match(cfg, got, want[3:], first_round=3)
    np.testing.assert_array_equal(np.asarray(losses[:3], np.float32),
                                  np.asarray([l for _, l in want[:3]]))


def test_state_from_reference_batched_layout():
    orders = np.stack([np.random.default_rng(i).permutation(N)
                       for i in range(4)]).astype(np.int32)
    losses = np.arange(12, dtype=np.float32).reshape(3, 4)   # (R0, BS)
    o, l = state_from_reference({"orders": orders, "losses": losses}, "cpu")
    assert o.dtype == torch.int64 and o.shape == (4, N)
    np.testing.assert_array_equal(l.numpy(), losses.T)
    with pytest.raises(ValueError):
        config_from_reference({"rounds": 3, "no_such_field": 1})


def test_entry_points_never_fall_back_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = teng.ShuffleSoftSortConfig(rounds=1, inner_steps=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        teng.shuffle_soft_sort(_x(0), HW, cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        teng.shuffle_soft_sort_batched(_x(0, 2), HW, cfg)


@pytest.mark.parametrize("kw,feature", [
    ({"cfg": {"schedule": "adaptive"}}, "adaptive"),
    ({"mesh": object()}, "mesh"),
    ({"checkpoint_dir": "ckpt"}, "checkpoint_dir"),
    ({"guardrail": object()}, "guardrail"),
])
def test_unported_features_raise(kw, feature):
    cfg = teng.ShuffleSoftSortConfig(rounds=1, inner_steps=1,
                                     **kw.pop("cfg", {}))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        teng.shuffle_soft_sort_batched(_x(0, 1), HW, cfg, device="cpu", **kw)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imported_modules(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)

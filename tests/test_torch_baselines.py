"""The port's Table III baselines (``repro_torch.core.baselines``,
``soft_sort_baseline``) and its table and CSV benches
(``repro_torch.bench.paper_table``, ``repro_torch.bench.run``) against
the JAX reference, on the CPU, with the same keys and N <= 64.

Tolerances:

* ``sinkhorn``: rtol 1e-5 (float32 log-sum-exps in other orders).
* One Gumbel-Sinkhorn loss and gradient with the same noise: 1e-4 x max
  (the Gumbel draw's ``-log(-log(u))`` is not XLA's to the ulp).
* Kissing's and the SoftSort baseline's losses after a few steps: rtol
  1e-4 (Kissing's factors start from ``normal``, within 4 ulp of
  ``jax.random.normal``).  The baseline's orders equal the reference's
  with ``lambda_sigma=0`` (ROADMAP.md Queue C1).
* Binarizations: Hungarian and argmax orders, and their validity,
  exactly the reference's on the same logits and factors.
* The table's colours: bitwise ``jax.random.uniform(PRNGKey(42), ...)``.
"""
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import losses as jl  # noqa: E402
from repro.core import shufflesoftsort as jeng  # noqa: E402
from repro.core.baselines import gumbel_sinkhorn as jgs  # noqa: E402
from repro.core.baselines import kissing as jki  # noqa: E402
from repro.core.softsort import is_valid_permutation as jvalid  # noqa: E402
from repro_torch.bench import paper_table  # noqa: E402
from repro_torch.bench import run as bench_run  # noqa: E402
from repro_torch.core import soft_sort_baseline, threefry  # noqa: E402
from repro_torch.core.baselines import gumbel_sinkhorn as tgs  # noqa: E402
from repro_torch.core.baselines import kissing as tki  # noqa: E402
from repro_torch.core.reference import config_from_reference  # noqa: E402

CPU = "cpu"
N, HW = 16, (4, 4)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is several times faster than
    many contending ones (the suite runs in parallel workers)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _colours(seed, n=N):
    return np.random.default_rng(seed).random((n, 3), dtype=np.float32)


@pytest.mark.parametrize("n,iters", [(16, 20), (36, 5)])
def test_sinkhorn_matches_jax(n, iters):
    la = np.random.default_rng(n).normal(size=(n, n)).astype(np.float32) * 3
    np.testing.assert_allclose(
        tgs.sinkhorn(torch.tensor(la), iters).numpy(),
        np.asarray(jgs.sinkhorn(jnp.asarray(la), iters)), rtol=1e-5,
        atol=1e-7)


def test_gumbel_sinkhorn_step_matches_jax():
    """One loss-and-gradient step from the reference's noise draw (5
    Sinkhorn iterations: JAX compiles the gradient of each)."""
    cfg = tgs.GumbelSinkhornConfig(sinkhorn_iters=5)
    x = _colours(0)
    logits = np.random.default_rng(1).normal(size=(N, N)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    _, sub = jax.random.split(key)
    norm = float(jl.mean_pairwise_distance(jnp.asarray(x)))
    tau, scale = np.float32(1.3), np.float32(0.15)

    def jloss(lg):
        u = jax.random.uniform(sub, (N, N), minval=1e-9, maxval=1.0)
        g = -jnp.log(-jnp.log(u + 1e-9))
        p = jgs.sinkhorn((lg + scale * g) / tau, cfg.sinkhorn_iters)
        y = p @ jnp.asarray(x)
        return (jl.neighbor_loss_grid(y.reshape(4, 4, -1), norm)
                + cfg.lambda_sigma * jl.std_loss(jnp.asarray(x), y))

    want_l, want_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    _, tsub = threefry.split(threefry.prng_key(3), device=CPU)
    g = tgs.gumbel_noise(threefry.uniform(tsub, (N, N), 1e-9, 1.0))
    lv = torch.tensor(logits, requires_grad=True)
    loss = tgs.loss_fn(lv, torch.tensor(x), torch.tensor(norm),
                       torch.tensor(tau), torch.tensor(scale), g, HW, cfg)
    (grad,) = torch.autograd.grad(loss, lv)
    np.testing.assert_allclose(float(loss.detach()), float(want_l), rtol=1e-4)
    want_g = np.asarray(want_g)
    assert np.abs(grad.numpy() - want_g).max() <= 1e-4 * np.abs(want_g).max()


def test_gumbel_sinkhorn_sort_short_run_matches_jax():
    cfg = tgs.GumbelSinkhornConfig(steps=4)
    x = _colours(2)
    got = tgs.gumbel_sinkhorn_sort(x, HW, cfg, device=CPU)
    want = jgs.gumbel_sinkhorn_sort(jnp.asarray(x), HW,
                                    jgs.GumbelSinkhornConfig(steps=4))
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    assert sorted(got[0]) == list(range(N))


@pytest.mark.parametrize("seed", [0, 1])
def test_kissing_loss_after_few_steps_matches_jax(seed):
    x = _colours(seed + 10)
    key = jax.random.PRNGKey(seed)
    got = tki.kissing_sort(x, HW, tki.KissingConfig(rank=8, steps=5),
                           key=np.asarray(key), device=CPU)
    want = jki.kissing_sort(jnp.asarray(x), HW,
                            jki.KissingConfig(rank=8, steps=5), key=key)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    assert got[3] == bool(want[3])


def test_kissing_factors_start_from_the_reference_draw():
    key = jax.random.PRNGKey(7)
    v0, w0 = tki.init_factors(np.asarray(key), N, 8, CPU)
    k1, k2 = jax.random.split(key)
    for got, k in ((v0, k1), (w0, k2)):
        want = np.asarray(jax.random.normal(k, (N, 8))) * 0.1
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)


def test_binarisations_match_reference():
    """Hungarian always gives a permutation; the argmax of a soft
    permutation may repeat rows, and the validity follows."""
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(N, N)).astype(np.float32)
    rows, cols = __import__("scipy.optimize", fromlist=["x"]) \
        .linear_sum_assignment(-logits)
    np.testing.assert_array_equal(tgs.hungarian_order(logits),
                                  cols[np.argsort(rows)])
    assert jvalid(tgs.hungarian_order(logits))
    eye = np.eye(N, 4, dtype=np.float32) + 0.01 * rng.normal(
        size=(N, 4)).astype(np.float32)
    cases = [(rng.normal(size=(N, 4)), rng.normal(size=(N, 4))),
             (np.eye(N, dtype=np.float32), np.eye(N, dtype=np.float32)),
             (eye, eye)]
    seen = set()
    for v, w in cases:
        v, w = np.asarray(v, np.float32), np.asarray(w, np.float32)
        got = tki.argmax_order(torch.tensor(v), torch.tensor(w), 60.0)
        p = jax.nn.softmax(60.0 * jki._normalize_rows(jnp.asarray(v))
                           @ jki._normalize_rows(jnp.asarray(w)).T, axis=-1)
        want = np.asarray(jnp.argmax(p, axis=-1))
        np.testing.assert_array_equal(got, want)
        assert tki.is_valid_permutation(got) == jvalid(want)
        seen.add(jvalid(want))
    assert seen == {True, False}


def _ss_cfgs(**kw):
    jcfg = jeng.ShuffleSoftSortConfig(rounds=3, inner_steps=4, chunk=16,
                                      **kw)
    return jcfg, config_from_reference(dataclasses.asdict(jcfg))


@pytest.mark.parametrize("lambda_sigma", [0.0, 2.0])
def test_soft_sort_baseline_matches_jax(lambda_sigma):
    jcfg, cfg = _ss_cfgs(lambda_sigma=lambda_sigma)
    x = _colours(3)
    got = soft_sort_baseline(x, HW, cfg, device=CPU)
    want = jeng.soft_sort_baseline(jnp.asarray(x), HW, jcfg)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4)
    if lambda_sigma == 0.0:
        np.testing.assert_array_equal(got[0], want[0])


def test_soft_sort_baseline_kernel_tier_matches_plain_tier():
    """``use_kernel=True`` on CPU tensors runs the dense kernels' twins."""
    _, cfg = _ss_cfgs(lambda_sigma=0.0)
    x = _colours(4)
    plain = soft_sort_baseline(x, HW, cfg, device=CPU)
    kern = soft_sort_baseline(x, HW, dataclasses.replace(cfg,
                                                         use_kernel=True),
                              device=CPU)
    np.testing.assert_array_equal(kern[0], plain[0])
    np.testing.assert_allclose(kern[2], plain[2], rtol=1e-5)


def test_paper_table_at_n64_passes_its_check():
    x = paper_table.colours(64, 42, CPU).numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(42), (64, 3)))
    np.testing.assert_array_equal(x.view(np.int32), want.view(np.int32))
    rows = paper_table.run(64, "fast", device=CPU, tier="plain")
    assert [r["method"] for r in rows] == list(paper_table.METHODS)
    assert [r["params"] for r in rows] == [64 * 64, 2 * 64 * 8, 64, 64]
    assert paper_table.check(rows, 64) == []
    out = io.StringIO()
    paper_table.print_table(rows, file=out)
    assert "shufflesoftsort" in out.getvalue()


def test_paper_table_check_reports_each_failure():
    rows = [dict(method=m, params=p, dpq16=q, valid=v) for m, p, q, v in (
        ("gumbel-sinkhorn", 64 * 64, 0.5, False), ("kissing", 1, 0.1, False),
        ("softsort", 64, 0.4, True), ("shufflesoftsort", 64, 0.3, True))]
    bad = paper_table.check(rows, 64)
    assert len(bad) == 3, bad
    assert any("gumbel-sinkhorn: not a valid" in b for b in bad)
    assert any("kissing: params" in b for b in bad)
    assert any("DPQ16" in b for b in bad)


def test_bench_run_prints_the_csv(monkeypatch, capsys):
    rows = [dict(method=m, params=1, runtime_s=0.5, dpq16=0.5, valid=True)
            for m in paper_table.METHODS]
    monkeypatch.setattr(paper_table, "run", lambda **kw: rows)
    assert bench_run.main(["--device", "cpu", "--smoke", "--n", "64"]) == 0
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in lines[1:5]] == [
        f"paper_table.{m}" for m in paper_table.METHODS]
    kernel = [ln for ln in lines if ln.startswith("kernel.")]
    assert kernel and all(len(ln.split(",")) == 3 for ln in kernel)
    assert any(".fused," in ln for ln in kernel)
    assert "dryrun_single.json" in err

"""Parity of the port's loss terms and metrics (``repro_torch.core.losses``,
``repro_torch.core.metrics``) with the JAX reference on the CPU.

Tolerances:

* loss terms: rtol 1e-5 — float32 means and square roots of O(N d) terms,
  reduced in different orders by XLA and by PyTorch (``jnp.std`` and
  ``torch.std`` use different algorithms for the same population std);
* ``dpq`` and ``mean_neighbor_distance``: exactly equal — both packages run
  the same numpy code in float64.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import losses as jl  # noqa: E402
from repro.core import metrics as jm  # noqa: E402
from repro_torch.core import losses as tl  # noqa: E402
from repro_torch.core import metrics as tm  # noqa: E402

RTOL = 1e-5


def _data(seed, n=64, d=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x + 0.1 * rng.normal(size=(n, d))).astype(np.float32)
    colsum = (1.0 + 0.05 * rng.normal(size=(n,))).astype(np.float32)
    return x, y, colsum


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_terms_match_jax(seed):
    x, y, colsum = _data(seed)
    grid = y.reshape(8, 8, -1)
    np.testing.assert_allclose(
        float(tl.neighbor_loss_grid(torch.tensor(grid), 1.7)),
        float(jl.neighbor_loss_grid(jnp.asarray(grid), 1.7)), rtol=RTOL)
    np.testing.assert_allclose(
        float(tl.stochastic_constraint_loss(torch.tensor(colsum))),
        float(jl.stochastic_constraint_loss(jnp.asarray(colsum))), rtol=RTOL)
    np.testing.assert_allclose(
        float(tl.std_loss(torch.tensor(x), torch.tensor(y))),
        float(jl.std_loss(jnp.asarray(x), jnp.asarray(y))), rtol=RTOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_grid_sorting_loss_matches_jax(seed):
    x, y, colsum = _data(seed)
    lj = jl.grid_sorting_loss(jnp.asarray(y), jnp.asarray(colsum),
                              jnp.asarray(x), (8, 8), 2.3,
                              lambda_s=1.0, lambda_sigma=2.0)
    lt = tl.grid_sorting_loss(torch.tensor(y), torch.tensor(colsum),
                              torch.tensor(x), (8, 8), 2.3,
                              lambda_s=1.0, lambda_sigma=2.0)
    np.testing.assert_allclose(float(lt), float(lj), rtol=RTOL)


def test_grid_sorting_loss_batched_equals_per_instance():
    """The engine evaluates a (BS, ...) batch; each row must be the
    single-instance value exactly."""
    data = [_data(s) for s in range(3)]
    xs = torch.tensor(np.stack([d[0] for d in data]))
    ys = torch.tensor(np.stack([d[1] for d in data]))
    cs = torch.tensor(np.stack([d[2] for d in data]))
    norms = torch.tensor([1.5, 2.0, 2.5])
    batched = tl.grid_sorting_loss(ys, cs, xs, (8, 8), norms)
    for i in range(3):
        one = tl.grid_sorting_loss(ys[i], cs[i], xs[i], (8, 8), norms[i])
        assert float(batched[i]) == float(one)


@pytest.mark.parametrize("n,chunk", [(64, 256), (300, 128), (1000, 256)])
def test_mean_pairwise_distance_exact_path_matches_jax(n, chunk):
    """Exact (streamed) path, including a ragged tail chunk."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 6)).astype(np.float32)
    np.testing.assert_allclose(
        float(tl.mean_pairwise_distance(torch.tensor(x), chunk=chunk)),
        float(jl.mean_pairwise_distance(jnp.asarray(x), chunk=chunk)),
        rtol=RTOL)


def test_mean_pairwise_distance_sampled_path_is_seeded():
    """Above 2048^2 pairs the port samples with a ``key=``: the same key
    gives the same value, another key another one, and the default key
    draws the reference's pairs (``prng_key(0)``)."""
    import jax

    from repro_torch.core import threefry
    rng = np.random.default_rng(9)
    x_np = rng.normal(size=(2100, 3)).astype(np.float32)
    x = torch.tensor(x_np)
    key = threefry.prng_key(3)
    a = tl.mean_pairwise_distance(x, key=key)
    b = tl.mean_pairwise_distance(x, key=key)
    assert float(a) == float(b)
    assert float(a) != float(tl.mean_pairwise_distance(
        x, key=threefry.prng_key(4)))
    exact = tl.mean_pairwise_distance(x[:2048])
    assert abs(float(a) - float(exact)) / float(exact) < 0.05
    # The default key's pairs are the reference's: JAX's mean over them.
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    i = np.asarray(jax.random.randint(k1, (2048,), 0, 2100))
    j = np.asarray(jax.random.randint(k2, (2048,), 0, 2100))
    want = np.mean(np.sqrt(np.sum(np.square(x_np[i] - x_np[j]), axis=-1)
                           + 1e-12))
    np.testing.assert_allclose(float(tl.mean_pairwise_distance(x)), want,
                               rtol=1e-6)


@pytest.mark.parametrize("n,d", [(4096, 3), (4096, 50), (65536, 14)])
def test_mean_pairwise_distance_sampled_path_matches_jax(n, d):
    """Queue C10: above 2048^2 pairs the port's normaliser is the
    reference's (the same 2048 sampled pairs), within float32 reduction
    order."""
    x = np.random.default_rng(n + d).random((n, d), dtype=np.float32)
    np.testing.assert_allclose(
        float(tl.mean_pairwise_distance(torch.tensor(x))),
        float(jl.mean_pairwise_distance(jnp.asarray(x))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_exactly_equal(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    assert tm.dpq(x, (8, 8)) == jm.dpq(x, (8, 8))
    assert tm.dpq(x, (8, 8), p=4) == jm.dpq(x, (8, 8), p=4)
    assert (tm.mean_neighbor_distance(x, (8, 8))
            == jm.mean_neighbor_distance(x, (8, 8)))

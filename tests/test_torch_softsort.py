"""Parity of the port's SoftSort (``repro_torch.core.softsort``,
``repro_torch.kernels.ref``) with the JAX reference (``repro.core.softsort``,
``repro.kernels.ref``) on the CPU.

Inputs are drawn from a seeded numpy generator and handed to both.
Tolerances are the reference suite's own:

* forward ``y`` and ``colsum``: atol 2e-5 — both sides are float32 sums of
  O(N) terms of size <= 1 taken in different orders;
* ``dw``, ``dx``, ``dtau``: atol 1e-4 x max-abs of the reference, as
  ``tests/test_kernel_bwd.py`` holds the kernel gradients — gradients
  carry the 1/tau factor and span several orders of magnitude;
* permutations: exactly equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import softsort as jss  # noqa: E402
from repro.kernels.ref import softsort_apply_ref as jref  # noqa: E402
from repro_torch.core import softsort as tss  # noqa: E402
from repro_torch.kernels.ref import softsort_apply_ref as tref  # noqa: E402

FWD_ATOL = 2e-5
GRAD_RTOL = 1e-4


def _untied_keys(rng, shape, scale=3.0):
    """Keys with no bitwise-tied pair: at a tie |.| has no derivative and
    two correct implementations may pick different subgradients."""
    while True:
        w = (rng.normal(size=shape) * scale).astype(np.float32)
        if all(len(np.unique(row)) == row.size
               for row in w.reshape(-1, shape[-1])):
            return w


def _assert_grads_close(got, want):
    for g, r in zip(got, want):
        r = np.asarray(r)
        scale = float(np.max(np.abs(r))) + 1e-9
        np.testing.assert_allclose(np.asarray(g), r, atol=GRAD_RTOL * scale)


@pytest.mark.parametrize("n", [16, 100, 257])
@pytest.mark.parametrize("descending", [False, True])
def test_softsort_matrix_matches_jax(n, descending):
    rng = np.random.default_rng(n)
    w = _untied_keys(rng, (n,))
    pj = jss.softsort_matrix(jnp.asarray(w), 0.7, descending=descending)
    pt = tss.softsort_matrix(torch.tensor(w), 0.7, descending=descending)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=FWD_ATOL)


@pytest.mark.parametrize("n", [16, 100, 257])
@pytest.mark.parametrize("descending", [False, True])
@pytest.mark.parametrize("batch", [None, 3])
def test_chunked_apply_matches_jax(n, descending, batch):
    """chunk=64: N=100 and N=257 leave a ragged, padded tail block; N=16
    takes the one-block dense branch."""
    rng = np.random.default_rng(1000 + n)
    lead = () if batch is None else (batch,)
    w = _untied_keys(rng, lead + (n,))
    x = rng.normal(size=lead + (n, 5)).astype(np.float32)
    yj, cj = jss.softsort_apply_chunked(jnp.asarray(w), jnp.asarray(x), 0.5,
                                        chunk=64, descending=descending)
    yt, ct = tss.softsort_apply_chunked(torch.tensor(w), torch.tensor(x), 0.5,
                                        chunk=64, descending=descending)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=FWD_ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=FWD_ATOL)


@pytest.mark.parametrize("n", [16, 100, 257])
def test_ref_oracle_matches_jax(n):
    rng = np.random.default_rng(2000 + n)
    w = _untied_keys(rng, (n,))
    x = rng.normal(size=(n, 3)).astype(np.float32)
    yj, cj = jref(jnp.asarray(w), jnp.asarray(x), 0.6)
    yt, ct = tref(torch.tensor(w), torch.tensor(x), 0.6)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=FWD_ATOL)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=FWD_ATOL)


def _grads_jax(fn, w, x, a, b, tau):
    def loss(w, x, tau):
        y, c = fn(w, x, tau)
        return jnp.sum(y * a) + jnp.sum(jnp.square(c) * b)
    return jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(x), jnp.float32(tau))


def _grads_torch(fn, w, x, a, b, tau):
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    tt = torch.tensor(tau, dtype=torch.float32, requires_grad=True)
    y, c = fn(wt, xt, tt)
    loss = torch.sum(y * torch.tensor(a)) + torch.sum(
        torch.square(c) * torch.tensor(b))
    return torch.autograd.grad(loss, (wt, xt, tt))


@pytest.mark.parametrize("n", [16, 100, 257])
@pytest.mark.parametrize("descending", [False, True])
def test_chunked_gradients_match_jax(n, descending):
    """dw, dx and dtau of the streamed apply against ``jax.grad``."""
    rng = np.random.default_rng(3000 + n)
    w = _untied_keys(rng, (n,))
    x = rng.normal(size=(n, 4)).astype(np.float32)
    a = rng.normal(size=(n, 4)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)

    def jfn(w, x, tau):
        return jss.softsort_apply_chunked(w, x, tau, chunk=64,
                                          descending=descending)

    def tfn(w, x, tau):
        return tss.softsort_apply_chunked(w, x, tau, chunk=64,
                                          descending=descending)

    _assert_grads_close(_grads_torch(tfn, w, x, a, b, 0.6),
                        _grads_jax(jfn, w, x, a, b, 0.6))


def test_batched_chunked_gradients_match_jax():
    rng = np.random.default_rng(31)
    w = _untied_keys(rng, (3, 100))
    x = rng.normal(size=(3, 100, 2)).astype(np.float32)
    a = rng.normal(size=(3, 100, 2)).astype(np.float32)
    b = rng.normal(size=(3, 100)).astype(np.float32)

    def jfn(w, x, tau):
        return jss.softsort_apply_chunked(w, x, tau, chunk=64)

    def tfn(w, x, tau):
        return tss.softsort_apply_chunked(w, x, tau, chunk=64)

    _assert_grads_close(_grads_torch(tfn, w, x, a, b, 0.8),
                        _grads_jax(jfn, w, x, a, b, 0.8))


@pytest.mark.parametrize("n", [16, 100, 257])
def test_ref_gradients_match_jax(n):
    rng = np.random.default_rng(4000 + n)
    w = _untied_keys(rng, (n,))
    x = rng.normal(size=(n, 3)).astype(np.float32)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(n,)).astype(np.float32)
    _assert_grads_close(_grads_torch(tref, w, x, a, b, 0.5),
                        _grads_jax(jref, w, x, a, b, 0.5))


def test_hard_permutation_matches_jax_including_ties():
    """Stable argsort on both sides: tied keys keep their input order."""
    rng = np.random.default_rng(5)
    w = rng.integers(0, 20, size=64).astype(np.float32)   # many ties
    np.testing.assert_array_equal(
        tss.hard_permutation(torch.tensor(w)).numpy(),
        np.asarray(jss.hard_permutation(jnp.asarray(w))))


def test_fix_permutation_matches_jax():
    rng = np.random.default_rng(6)
    for _ in range(20):
        idx = rng.integers(0, 40, size=40)
        fixed_t = tss.fix_permutation(torch.tensor(idx))
        np.testing.assert_array_equal(fixed_t, jss.fix_permutation(idx))
        assert tss.is_valid_permutation(fixed_t)
        assert tss.is_valid_permutation(idx) == jss.is_valid_permutation(idx)
    assert tss.is_valid_permutation(torch.randperm(50))

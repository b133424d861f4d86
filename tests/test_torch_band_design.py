"""What the design of the banded kernels 5 and 8 rests on, checked on the
CPU against the plain twin and the JAX reference:

* the banded row maximum is exactly zero for tau > 0 and any sorted keys,
  ties included: rows and columns are the same sorted keys, the diagonal
  pair is always in the band and scores -0, and no pair scores above it.
  Kernel 5 takes m_i = -0.0 from this instead of a running maximum.  It is
  checked on ``fwd_band_plain``'s m and on the JAX
  ``softsort_apply_fwd_banded_pallas`` in interpret mode;
* ``band_payload_tile``, the payload tile the wrapper passes to kernels 5
  and 8: the smallest of 16, 32 and 64 that holds d, tiles of 64 above.

Exact comparisons: the invariant is an identity, not a rounding bound.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.softsort_apply import (  # noqa: E402
    softsort_apply_fwd_banded_pallas,
)

K = importlib.import_module("repro_torch.kernels.softsort_apply")

# (B, N, d, K, tau, ties): tied keys are rounded to a coarse grid.
MAX_CASES = [(2, 300, 7, 40, 0.6, False), (1, 129, 14, 16, 0.05, True),
             (3, 200, 3, 199, 2.0, True), (1, 257, 33, 100, 1e-3, False)]


def _keys(bsz, n, ties, seed):
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(bsz, n)) * 3.0).astype(np.float32)
    if ties:
        w = np.round(w * 2.0) / 2.0
    return w


@pytest.mark.parametrize("bsz,n,d,k,tau,ties", MAX_CASES)
def test_band_row_max_is_exactly_zero_in_the_twin(bsz, n, d, k, tau, ties):
    """fwd_band_plain's m is -0.0 in every row: what kernel 5 writes."""
    seed = n + d + k
    w = _keys(bsz, n, ties, seed)
    if ties:
        assert any(len(np.unique(r)) < n for r in w)
    ws = torch.tensor(np.sort(w, axis=-1, kind="stable"))
    xs = torch.tensor(np.random.default_rng(seed + 1).normal(
        size=(bsz, n, d)).astype(np.float32))
    _, m, _ = K.fwd_band_plain(ws, xs, torch.tensor([tau]), k)
    m = m.numpy()
    np.testing.assert_array_equal(m, np.zeros_like(m))
    assert np.signbit(m).all()


@pytest.mark.parametrize("bsz,n,d,k,tau,ties", MAX_CASES)
def test_band_row_max_is_exactly_zero_in_the_jax_kernel(bsz, n, d, k, tau,
                                                         ties):
    """The banded Pallas forward (interpret mode) on the operands its
    wrapper builds: its running maximum ends at exactly 0 in every real
    row."""
    seed = n + d + k
    w = _keys(bsz, n, ties, seed)
    x = np.random.default_rng(seed + 1).normal(
        size=(bsz, n, d)).astype(np.float32)
    blk, np_, dsub = jops._band_geometry(n, d, 128)
    _, wr, wc, xt = jops._band_operands(jnp.asarray(w), jnp.asarray(x), n,
                                        np_, dsub, cd=jnp.float32)
    _, _, m, _ = softsort_apply_fwd_banded_pallas(
        wr, wc, xt, jnp.full((1, 1), tau, jnp.float32), n=n, k=k, blk=blk,
        interpret=True)
    m = np.asarray(m[:, 0, :n])
    np.testing.assert_array_equal(m, np.zeros_like(m))


@pytest.mark.parametrize("d,tile", [(1, (16, 1)), (14, (16, 1)),
                                    (16, (16, 1)), (17, (32, 1)),
                                    (32, (32, 1)), (33, (64, 1)),
                                    (64, (64, 1)), (65, (64, 2))])
def test_band_payload_tile(d, tile):
    assert K.band_payload_tile(d) == tile

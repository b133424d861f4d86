"""``repro_torch.runtime.guardrails.expected_key_chain`` (the rest of
ROADMAP.md Queue A12) against the reference's
``repro.runtime.guardrails.expected_key_chain``, on the CPU, in both
counter layouts, and as the one definition of
``ThreefryShuffleSource.advanced``'s chain."""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.runtime import guardrails as jguard  # noqa: E402
from repro_torch.core import threefry  # noqa: E402
from repro_torch.core.prng import ThreefryShuffleSource  # noqa: E402
from repro_torch.runtime.guardrails import expected_key_chain  # noqa: E402


def _keys(count, seed=3):
    return np.asarray(jax.random.split(jax.random.PRNGKey(seed), count))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seg_len", [0, 1, 4])
def test_expected_key_chain_is_the_references(partitionable, seg_len):
    with jax.threefry_partitionable(partitionable):
        keys = _keys(5)
        want = jguard.expected_key_chain(keys, seg_len)
    got = expected_key_chain(keys, seg_len, partitionable=partitionable)
    assert got.dtype == np.uint32 and got.shape == (5, 2)
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("partitionable", [True, False])
def test_threefry_source_advances_along_the_chain(partitionable):
    """``advanced`` moves only the rows named, by the chain of
    ``expected_key_chain``, and matches the source's own draws."""
    keys = threefry.key_data(threefry.split(threefry.prng_key(9), 4,
                                            partitionable=partitionable,
                                            device="cpu"))
    src = ThreefryShuffleSource(keys, 16, "cpu", partitionable)
    rows = [0, 2]
    got = src.advanced(keys, rows, 3)
    want = keys.copy()
    want[rows] = expected_key_chain(keys[rows], 3, partitionable)
    np.testing.assert_array_equal(got, want)
    for _ in range(3):
        src.next_round(rows)
    np.testing.assert_array_equal(src.state_dict(), got)

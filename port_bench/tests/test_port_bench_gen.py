"""The yardstick's frozen copies: the input generators are deterministic
per seed, and the reference's threefry draws the normaliser's pairs as
the program does."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench.gen import catalog, splats
from port_bench.kinds import common
from port_bench.reference import anneal, threefry


@pytest.mark.parametrize("make,kw,d", [(catalog.make, {"clusters": 24}, 50),
                                       (splats.make, {"noise": 0.01}, 59)])
def test_generators_are_deterministic_per_seed(make, kw, d):
    def draw(seed):
        return make(2, 64, d, torch.Generator().manual_seed(seed), **kw)
    a, b, c = draw(2 ** 31 + 11), draw(2 ** 31 + 11), draw(2 ** 31 + 12)
    assert a.shape == (2, 64, d) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])


def test_run_seeds_take_large_seeds():
    s = common.seed_of(2 ** 33 + 5, 1, 7)
    assert s == common.seed_of(2 ** 33 + 5, 1, 7) != common.seed_of(5, 1, 7)
    assert 0 <= s < 2 ** 63


@pytest.mark.parametrize("n", [8192, 65536])
def test_normaliser_pairs_are_the_programs(n):
    from repro_torch.core import threefry as prog
    k1, k2 = threefry.split(threefry.prng_key(0))
    pk = prog.split(prog.prng_key(0), device="cpu")
    assert np.array_equal(np.stack([k1, k2]), prog.key_data(pk))
    for mine, key in ((k1, pk[0]), (k2, pk[1])):
        want = prog.randint(key, (2048,), 0, n).numpy()
        assert np.array_equal(threefry.randint(mine, 2048, 0, n), want)


def test_reference_normaliser_matches_the_programs():
    from repro_torch.core.losses import mean_pairwise_distance
    g = torch.Generator().manual_seed(3)
    for n in (64, 4096):
        x = catalog.make(1, n, 5, g, clusters=4)[0]
        assert float(anneal.normaliser(x)) == pytest.approx(
            float(mean_pairwise_distance(x)), rel=1e-5)

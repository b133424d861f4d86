"""``port_bench.counts`` against hand arithmetic."""
from __future__ import annotations

import pytest

from port_bench import counts


def test_dense_step_by_hand():
    # 2 instances of N = 4, d = 3: 16 pairs each.
    w = counts.step_work(2, 4, 3, None)
    assert w["contraction_flops"] == 2 * 16 * 4 * 3
    assert w["elementwise_flops"] == 2 * 16 * 22
    # forward: w 4, x 12, tau 1, y 12, colsum 4; backward: dy 12, dc 4,
    # w 4, dw 4 = 57 words an instance.
    assert w["bytes"] == 4 * 2 * 57


def test_banded_pairs_by_hand():
    # N = 6, K = 2: rank r pairs with ranks within 2: 3 4 5 5 4 3 = 24.
    assert counts.pairs(6, 2) == 24
    assert counts.pairs(6, 5) == 36 == counts.pairs(6, None)
    w = counts.step_work(1, 6, 2, 2)
    assert w["contraction_flops"] == 24 * 4 * 2


def test_least_time_is_the_largest_bound():
    w = counts.step_work(8, 8192, 50, None)
    assert counts.least_seconds(w) == pytest.approx(
        8 * 8192 ** 2 * 200 / (495e12 / 3))
    rounds = [None] * 3
    assert counts.run_least_seconds(8, 8192, 50, rounds, 8) == \
        pytest.approx(24 * counts.least_seconds(w))

"""The arithmetic of the metrics on fixed inputs."""


import numpy as np
import pytest

from harness import stats


@pytest.mark.parametrize("pct", [0, 5, 50, 90, 95, 99, 100])
def test_percentile_matches_numpy_linear(pct):
    xs = [3.0, 1.0, 4.0, 1.5, 9.0, 2.6, 5.3, 5.8, 9.7, 9.3, 2.3]
    assert stats.percentile(xs, pct) == pytest.approx(np.percentile(xs, pct), rel=1e-12)


def test_percentile_hand_worked():
    # 20 values 1..20: rank 0.95 * 19 = 18.05, between 19 and 20
    assert stats.percentile(range(1, 21), 95) == pytest.approx(19.05)


def test_mean_square_and_ms_to_accuracy():
    errs = [1e-3, -2e-3, 3e-3, 0.0]
    mse = stats.mean_square(errs)
    assert mse == pytest.approx(14e-6 / 4)
    # 10 s over 4000 queries = 2.5 ms a query; MSE 3.5e-6 needs 3.5 queries
    # to reach (1e-3)^2
    assert stats.ms_to_accuracy(10.0, 4000, mse, 1e-3) == pytest.approx(2.5 * 3.5)


def test_rate_over_the_window():
    # 2^20 particles x 16 steps x 500 queries in 10 s
    assert stats.rate((1 << 20) * 16, 500, 10.0) == pytest.approx(838860800.0)


def test_union_and_gaps_clip_to_the_window():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.8), (9.0, 12.0), (-3.0, -1.0)]
    # window [1, 10]: busy [1,3], [5,6], [9,10] = 2 + 1 + 1
    assert stats.union_length(iv, 1.0, 10.0) == pytest.approx(4.0)
    assert stats.gaps(iv, 1.0, 10.0) == [(3.0, 5.0), (6.0, 9.0)]
    assert stats.union_length([], 0.0, 1.0) == 0.0
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]
    # idle share of that window: 1 - 4 / 9
    assert 1 - stats.union_length(iv, 1.0, 10.0) / 9.0 == pytest.approx(5 / 9)

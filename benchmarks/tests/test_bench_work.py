"""The yardstick: the frozen bounds and the work count of ``sweep_mfu``."""

import pytest

from harness import yardstick as y


def _bound_ms(n_bytes, ops):
    return max(n_bytes / y.HBM_BYTES_PER_S, ops / y.F32_OPS_PER_S) * 1e3


def test_frozen_chunk_bounds_match_the_kernel_table():
    # PERF.md's table: K2 0.4239 ms (2^26, 15 steps, one check), K7 0.1032
    # ms (2^24, 8 steps), K4 and K6 bytes-bound at 0.0050 and 0.0801 ms
    assert y.chain_chunk_bound(1 << 26, 3, 15, 1)["bound_ms"] == pytest.approx(0.4239, abs=1e-4)
    assert y.normal_chunk_bound(1 << 24, 8)["bound_ms"] == pytest.approx(0.1032, abs=1e-4)
    assert y.chain_chunk_bound(1 << 20, 3, 1)["bound_by"] == "bytes"
    assert y.chain_chunk_bound(1 << 20, 3, 1)["bound_ms"] == pytest.approx(0.0050, abs=1e-4)
    assert y.normal_chunk_bound(1 << 24, 1)["bound_ms"] == pytest.approx(0.0801, abs=1e-4)


@pytest.mark.parametrize("resamples", [0, 1, 4])
def test_chain_sweep_closed_form(resamples):
    n, K, T = 1 << 20, 3, 16
    work = [y.chain_step_work(K, t == 0) for t in range(T)]
    ops = n * ((4 * K + 1) + (T - 1) * (3 * K - 2)) + y.PHILOX_OPS * n * T / 4
    want = _bound_ms(16 * n * (1 + resamples), ops)
    assert y.sweep_bound(n, work, resamples)["bound_ms"] == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("resamples", [0, 2, 8])
def test_normal_sweep_closed_form(resamples):
    n, T = 1 << 24, 16
    work = [y.normal_step_work() for _ in range(T)]
    ops = n * T * (6 + (y.PHILOX_OPS + y.BOX_MULLER_OPS) / 2)
    want = _bound_ms(16 * n * (1 + resamples), ops)
    assert y.sweep_bound(n, work, resamples)["bound_ms"] == pytest.approx(want, rel=1e-12)


def test_sweep_charges_no_launch():
    # the same query cut into 1 launch or 15: the sweep's bound is the
    # same, and below the sum of the launches' bounds, which charge the
    # population's bytes to every launch
    n, K = 1 << 20, 3
    work = [y.chain_step_work(K, t == 0) for t in range(16)]
    sweep = y.sweep_bound(n, work, 0)["bound_ms"]
    per_step = sum(y.chain_chunk_bound(n, K, 1)["bound_ms"] for _ in range(15))
    one = y.chain_chunk_bound(n, K, 15)["bound_ms"]
    assert sweep < per_step
    assert sweep >= one
    # one more resample adds one read and one write of the population
    # (this query is bound by its bytes)
    more = y.sweep_bound(n, work, 5)["bound_ms"] - y.sweep_bound(n, work, 4)["bound_ms"]
    assert more == pytest.approx(16 * n / y.HBM_BYTES_PER_S * 1e3, rel=1e-9)

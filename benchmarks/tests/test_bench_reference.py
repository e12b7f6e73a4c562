"""The frozen references against hand-worked cases: the forward
recursion against the sum over every path of the chain, the Kalman filter
against the joint Gaussian of the observations."""

import itertools
import json
import math

import numpy as np
import pytest
import torch

from harness.manifest import BENCH_DIR, load_module

hmm3 = load_module(BENCH_DIR / "reference" / "hmm3.py", "ref_hmm3")
lg1d = load_module(BENCH_DIR / "reference" / "lg1d.py", "ref_lg1d")
HMM = json.loads((BENCH_DIR / "configs" / "hmm3.json").read_text())
LG = json.loads((BENCH_DIR / "configs" / "lg1d.json").read_text())


def _normal(y, m, v):
    return math.exp(-0.5 * (y - m) ** 2 / v) / math.sqrt(2 * math.pi * v)


def test_forward_recursion_one_step_by_hand():
    y = 0.3
    want = math.log(sum(p * _normal(y, m, 1.0) for p, m in zip(HMM["initial"], HMM["means"])))
    log_z, filt = hmm3.exact(np.array([[y]]), HMM)
    assert log_z[0] == pytest.approx(want, rel=1e-14)
    post = [p * _normal(y, m, 1.0) for p, m in zip(HMM["initial"], HMM["means"])]
    assert filt[0] == pytest.approx(np.array(post) / sum(post), rel=1e-14)


def test_forward_recursion_against_every_path():
    ys = np.array([[0.5, -1.2, 2.0, 0.1, -0.4]])
    A, init, means = np.array(HMM["transition"]), HMM["initial"], HMM["means"]
    total, last = 0.0, np.zeros(3)
    for path in itertools.product(range(3), repeat=ys.shape[1]):
        p = init[path[0]] * _normal(ys[0, 0], means[path[0]], 1.0)
        for t in range(1, len(path)):
            p *= A[path[t - 1], path[t]] * _normal(ys[0, t], means[path[t]], 1.0)
        total += p
        last[path[-1]] += p
    log_z, filt = hmm3.exact(ys, HMM)
    assert log_z[0] == pytest.approx(math.log(total), rel=1e-12)
    assert filt[0] == pytest.approx(last / total, rel=1e-10)


def test_kalman_one_step_by_hand():
    y = 1.7
    log_z, filt = lg1d.exact(np.array([[y]]), LG)
    assert log_z[0] == pytest.approx(math.log(_normal(y, 0.0, 2.0)), rel=1e-14)
    assert filt[0] == pytest.approx([y / 2, 0.5], rel=1e-14)


def test_kalman_against_the_joint_gaussian():
    ys = np.array([[0.4, 1.1, -0.3, 2.2, 1.0, 0.7]])
    T = ys.shape[1]
    # y_t = x_t + e_t, x_t = x_0 + w_1 + ... + w_t: Cov(y_i, y_j) =
    # p0 + q min(i, j) + r [i = j]
    i, j = np.meshgrid(range(T), range(T), indexing="ij")
    cov = 1.0 + np.minimum(i, j) + np.eye(T)
    sign, logdet = np.linalg.slogdet(cov)
    y = ys[0]
    want = -0.5 * (y @ np.linalg.solve(cov, y) + logdet + T * math.log(2 * math.pi))
    log_z, filt = lg1d.exact(ys, LG)
    assert log_z[0] == pytest.approx(want, rel=1e-12)
    # filtering mean and variance of x_{T-1}: condition the joint Gaussian
    cxy = 1.0 + np.minimum(T - 1, np.arange(T))
    mean = cxy @ np.linalg.solve(cov, y)
    var = 1.0 + (T - 1) - cxy @ np.linalg.solve(cov, cxy)
    assert filt[0] == pytest.approx([mean, var], rel=1e-10)


@pytest.mark.parametrize("ref,cfg", [(hmm3, HMM), (lg1d, LG)], ids=["hmm3", "lg1d"])
def test_the_torch_recursion_is_the_reference_in_float64(ref, cfg):
    ys = ref.simulate(np.random.default_rng(5), 64, cfg)
    lz, f = ref.exact(ys, cfg)
    lz64, f64 = ref.recursion(ys, cfg, torch.float64)
    assert lz64 == pytest.approx(lz, rel=1e-12)
    assert f64 == pytest.approx(f, rel=1e-9, abs=1e-12)
    lzb, _ = ref.recursion(ys, cfg, torch.bfloat16)
    assert np.max(np.abs(lzb - lz)) > 1e-2


@pytest.mark.parametrize("ref,cfg", [(hmm3, HMM), (lg1d, LG)], ids=["hmm3", "lg1d"])
def test_simulation_follows_the_seed(ref, cfg):
    a = ref.simulate(np.random.default_rng(11), 32, cfg)
    b = ref.simulate(np.random.default_rng(11), 32, cfg)
    c = ref.simulate(np.random.default_rng(12), 32, cfg)
    assert a.dtype == np.float32 and a.shape == (32, cfg["series_length"])
    assert np.array_equal(a, b) and not np.array_equal(a, c)


def test_summaries_of_a_population():
    s = torch.tensor([0, 1, 2, 2, 1], dtype=torch.int32)
    lw = torch.log(torch.tensor([1.0, 2.0, 3.0, 1.0, 1.0]))
    assert hmm3.summarize(s, lw, HMM).numpy() == pytest.approx([1 / 8, 3 / 8, 4 / 8])
    assert hmm3.filter_error(np.array([0.2, 0.3, 0.5]), np.array([0.1, 0.3, 0.6])) == pytest.approx(0.02)
    x = torch.tensor([1.0, 3.0])
    lw = torch.log(torch.tensor([1.0, 3.0]))
    assert lg1d.summarize(x, lw, LG).numpy() == pytest.approx([2.5, 0.75])
    assert lg1d.filter_error(np.array([2.5, 0.75]), np.array([2.0, 0.5])) == pytest.approx(0.25 / 0.5 + 0.25)

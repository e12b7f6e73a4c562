"""The d-dimensional linear-Gaussian model of the iterated auxiliary
particle filter (``models/linear_gaussian.py`` ``linear_gaussian_nd_ssm``)
on the port's vector path, at small sizes on the CPU (the kernels' plain
versions): K11 with vector observations against a plain torch step on
pinned draws, its one-step launch with the resample control, pass 2 over
rows of d floats, ``build_smc_run`` against the Kalman filter; and the
benchmark's plain reference (``benchmarks/reference/iapf_lg10.py``)
against the joint Gaussian of the stacked series."""

import importlib.util
import json
import math
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cpprob_tpu_torch import build_smc_run
from cpprob_tpu_torch.inference import resampling as rs
from cpprob_tpu_torch.models.linear_gaussian import (
    iapf_transition,
    kalman_filter_nd,
    linear_gaussian_nd_ssm,
    nd_step_elem,
    simulate_observations_nd,
)
from cpprob_tpu_torch.ops import stream_resample as sr
from cpprob_tpu_torch.ops.population import stats_from_partials
from cpprob_tpu_torch.ops.user_chunk import (
    UserKernel,
    user_chunk_plain,
    user_step_ctrl_plain,
)

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmarks"
HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
D = 10
SEEDS = 8
FLOOR = 0.05


def _bench_module(rel: str, name: str):
    """A file of the benchmark, imported as the harness imports it (its
    ``harness`` package on the path)."""
    if str(BENCH) not in sys.path:
        sys.path.insert(0, str(BENCH))
    spec = importlib.util.spec_from_file_location(name, BENCH / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _bench_module("reference/iapf_lg10.py", "bench_reference_iapf_lg10")
CFG = json.loads((BENCH / "configs" / "iapf_lg10.json").read_text())


def _stable(d, seed, radius=0.9):
    """A random (d, d) transition scaled to spectral radius ``radius``."""
    a = np.random.default_rng(seed).standard_normal((d, d))
    return a * radius / np.max(np.abs(np.linalg.eigvals(a)))


def _torch_step(A, x, w, y, eps):
    """The model's step in plain torch: x' = x A^T + eps, w += log N(y; x', I)."""
    nx = x @ torch.as_tensor(A.T, dtype=torch.float32) + eps
    dy = y - nx
    return nx, w - 0.5 * torch.sum(dy * dy, 1) - D * HALF_LOG_2PI


@pytest.mark.parametrize("n_valid", [3, 2])
def test_vector_observations_match_a_plain_torch_step(n_valid):
    """K11's plain version with d = 10 state and 10 observation planes on
    pinned draws: each step a plain torch step (a 10 x 10 product, the
    emission over the 10 observations), within float32 rounding (the
    step_elem sums in another order than ``@``); steps past ``n_valid``
    leave the particles."""
    A = iapf_transition(D)
    g = torch.Generator().manual_seed(1)
    n = 1000
    x = torch.randn(n, D, generator=g)
    w = torch.randn(n, generator=g)
    ys = torch.randn(3, D, generator=g)
    draws = torch.randn(3, D, n, generator=g)
    s, lw, rec = user_chunk_plain(nd_step_elem(A), D, 0, x, w, ys,
                                  torch.tensor(n_valid, dtype=torch.int32), draws=draws)
    want_x, want_w = x, w
    for t in range(n_valid):
        want_x, want_w = _torch_step(A, want_x, want_w, ys[t], draws[t].T)
    assert s.shape == (n, D) and rec.shape == (1, 3)
    torch.testing.assert_close(s, want_x, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(lw, want_w, rtol=1e-5, atol=1e-4)


def test_one_step_with_the_resample_control():
    """The one-step launch's plain version: where the flag is set the
    weights start from 0 (no old weight read), the ESS is the combine of
    its records and the next flag ESS < threshold; a chunk of two steps is
    its two one-step launches."""
    A = iapf_transition(D)
    k = UserKernel(nd_step_elem(A), D, D)
    g = torch.Generator().manual_seed(2)
    n = 5000
    x, w = torch.randn(n, D, generator=g), torch.randn(n, generator=g)
    ys = torch.randn(3, D, generator=g)
    on, off = (torch.tensor(v, dtype=torch.int32) for v in (1, 0))
    x1, w1, ess, nxt = k.step_ctrl(9, x, w, ys[1], 1, on, 0.5 * n)
    x0, w0, _ = user_chunk_plain(k.step_elem, D, 9, x, torch.zeros(n), ys[1:2], t0=1)
    assert torch.equal(x1, x0) and torch.equal(w1, w0)
    assert float(ess) == float(stats_from_partials(
        user_chunk_plain(k.step_elem, D, 9, x, torch.zeros(n), ys[1:2], t0=1)[2], n)[0])
    assert int(nxt) == int(float(ess) < 0.5 * n) and nxt.dtype == torch.int32
    x2, w2, _, _ = user_step_ctrl_plain(k.step_elem, D, 9, x1, w1, ys[2], 2, off, 0.5 * n)
    xc, wc, _ = user_chunk_plain(k.step_elem, D, 9, x, torch.zeros(n), ys[1:3], t0=1)
    assert torch.equal(x2, xc) and torch.equal(w2, wc)


def test_the_rendered_source_of_vector_observations():
    """The generated source reads the step's observation row (kDy planes)
    and hands each plane to the step_elem; a scalar observation stays the
    one ``y``; a step_elem of the wrong arity raises."""
    A = iapf_transition(D)
    src = UserKernel(nd_step_elem(A), D, D).source()
    assert "constexpr int kD = 10;" in src and "constexpr int kDy = 10;" in src
    assert ", y_row[0], y_row[1], " in src and "y_row[9], eps[0]" in src
    assert "0.41999998688697815f" in src          # alpha, a float32 literal
    with pytest.raises(ValueError, match="positional"):
        UserKernel(nd_step_elem(A), D, 1)
    small = UserKernel(nd_step_elem(iapf_transition(2)), 2, 2)
    assert "step_elem(x[0], x[1], y_row[0], y_row[1], eps[0], eps[1]" in small.source()


def test_physics_count_is_the_rendered_steps():
    """The benchmark's frozen count of a particle-step's physics is the
    rounded operations of the step the port renders, and the kernel's
    weight update."""
    system = _bench_module("configs/iapf_lg10.py", "bench_config_iapf_lg10")
    src = UserKernel(nd_step_elem(iapf_transition(D)), D, D).source()
    body = src[src.index("void step_elem("):src.index("void step(")]
    ops = len(re.findall(r"__f(?:add|sub|mul|div)_rn\(", body))
    assert system.physics_ops(CFG) == ops + 1 == 232


@pytest.mark.parametrize("trial", range(4))
def test_pass2_over_rows_is_a_gather_of_the_owners(trial):
    """Pass 2 over (n, d) rows gives each slot its owner's row, as
    ``index_select`` of the owners of the start slots does, and each
    column the scalar pass 2's values; with the flag off, the rows as they
    were."""
    g = torch.Generator().manual_seed(trial)
    n, d = 3 * sr.OUT_TILE + 11, 1 + 3 * trial
    lw = 3.0 * torch.randn(n, generator=g)
    states = torch.randn(n, d, generator=g)
    u0 = torch.rand((), dtype=torch.float64, generator=g)
    st = sr.resample_pass1(u0, lw, sr.logsumexp_stats(lw))
    flag = torch.randint(0, 2, (), generator=g, dtype=torch.int32)
    owner = torch.searchsorted(st, torch.arange(n, dtype=torch.int32), right=True) - 1
    out = sr.resample_pass2(st, states, flag)
    want = states.index_select(0, owner.clamp(min=0)) if int(flag) else states
    assert torch.equal(out, want)
    for c in range(d):
        assert torch.equal(out[:, c], sr.resample_pass2(st, states[:, c].contiguous(), flag))
    with pytest.raises(ValueError):
        sr.resample_pass2(st, states, flag, impl="merge")


def test_vector_states_take_the_streaming_epoch():
    """Float32 (n, d) rows stream; other dtypes keep the sorted-key epoch."""
    assert rs.streams(torch.zeros(64, D)) and rs.streams(torch.zeros(64))
    assert not rs.streams(torch.zeros(64, D, dtype=torch.float64))
    assert not rs.streams(torch.zeros(64, 2, 2))


@pytest.mark.parametrize("seed", [3, 7])
def test_build_smc_run_matches_kalman_at_d10(seed):
    """``build_smc_run`` on a d = 10 model with a random stable transition
    (seeded) at 2^12 particles, per step (the one-step launch with the
    resample control, the path of the benchmark's cell): the mean log
    Z-hat over 8 seeds within 4 SE + 0.05 of the Kalman filter's log Z.
    (In chunks the weights of 10 observations a step degenerate between
    boundaries, and at this size the log of the estimate is biased low
    far beyond its SE.)"""
    A = _stable(D, seed)
    model = linear_gaussian_nd_ssm(A)
    ys = simulate_observations_nd(A, 6, seed)
    exact = kalman_filter_nd(ys, A)[2]
    run = build_smc_run(model, 1 << 12, chunk=1)
    results = [run(s, torch.as_tensor(ys)) for s in range(SEEDS)]
    vals = np.array([float(r.log_evidence) for r in results])
    se = vals.std(ddof=1) / math.sqrt(SEEDS)
    assert abs(vals.mean() - exact) < 4 * se + FLOOR, (vals.mean(), se, exact)
    assert all(r.final_states.shape == (1 << 12, D) for r in results)
    assert all(bool(r.resampled.any()) for r in results)


def _joint(A, T):
    """Covariance of the stacked Y_0..Y_{T-1} and of X_{T-1} with them."""
    d = A.shape[0]
    sig = [np.eye(d)]
    for _ in range(1, T):
        sig.append(A @ sig[-1] @ A.T + np.eye(d))
    cov = np.zeros((T * d, T * d))
    for s in range(T):
        for t in range(s, T):
            c = np.linalg.matrix_power(A, t - s) @ sig[s]      # Cov(X_t, X_s)
            cov[t * d:(t + 1) * d, s * d:(s + 1) * d] = c
            cov[s * d:(s + 1) * d, t * d:(t + 1) * d] = c.T
        cov[s * d:(s + 1) * d, s * d:(s + 1) * d] += np.eye(d)
    cxy = np.hstack([np.linalg.matrix_power(A, T - 1 - s) @ sig[s] for s in range(T)])
    return cov, cxy, sig[-1]


@pytest.mark.parametrize("T", [1, 2, 4])
def test_reference_kalman_against_the_joint_gaussian(T):
    """The benchmark reference's float64 Kalman filter, and the port's
    oracle, against the joint Gaussian density of the stacked series (an
    independent check): log Z and the filter of X_{T-1} by conditioning."""
    A = REF.transition(CFG)
    ys = REF.simulate(np.random.default_rng(T), 3, dict(CFG, series_length=T))
    log_z, filt = REF.exact(ys, CFG)
    cov, cxy, sig = _joint(A, T)
    for i in range(3):
        y = ys[i].astype(np.float64).reshape(-1)
        _, logdet = np.linalg.slogdet(cov)
        want = -0.5 * (y @ np.linalg.solve(cov, y) + logdet + y.size * math.log(2 * math.pi))
        assert log_z[i] == pytest.approx(want, rel=1e-11)
        mean = cxy @ np.linalg.solve(cov, y)
        var = sig - cxy @ np.linalg.solve(cov, cxy.T)
        np.testing.assert_allclose(filt[i], np.concatenate([mean, var.ravel()]),
                                   rtol=1e-9, atol=1e-11)
        ms, ps, ll = kalman_filter_nd(ys[i], A)
        assert ll == pytest.approx(log_z[i], rel=1e-12)
        np.testing.assert_allclose(np.concatenate([ms[-1], ps[-1].ravel()]), filt[i],
                                   rtol=1e-9, atol=1e-12)


def test_reference_recursion_is_the_filter_in_its_dtype():
    """The reference's elementwise recursion is the Kalman filter in
    float64 and falls far from it in bfloat16 (the control)."""
    ys = REF.simulate(np.random.default_rng(5), 8, dict(CFG, series_length=12))
    lz, f = REF.exact(ys, CFG)
    lz64, f64 = REF.recursion(ys, CFG, torch.float64)
    np.testing.assert_allclose(lz64, lz, rtol=1e-12)
    np.testing.assert_allclose(f64, f, rtol=1e-9, atol=1e-12)
    lzb, fb = REF.recursion(ys, CFG, torch.bfloat16)
    assert np.max(np.abs(lzb - lz)) > 1e-1
    assert REF.filter_error(fb[0], f[0]) > 0


def test_reference_summary_and_filter_error():
    """The weighted mean and marginal variances of a population, and their
    distance from a filter in units of its covariance."""
    x = torch.tensor([[1.0, 0.0], [3.0, 2.0]])
    lw = torch.log(torch.tensor([1.0, 3.0]))
    assert REF.summarize(x, lw, CFG).numpy() == pytest.approx([2.5, 1.5, 0.75, 0.75])
    f = np.array([2.0, 1.0, 0.5, 0.0, 0.0, 0.25])
    got = REF.filter_error(np.array([2.5, 1.5, 0.75, 0.75]), f)
    assert got == pytest.approx(0.25 / 0.5 + 0.25 / 0.25 + 0.25 + 4.0)
    assert REF.filter_error(f, f) == 0.0


@pytest.mark.cuda
def test_the_cell_on_the_card():
    """On the card: K11's one-step launch at d = 10 and pass 2 over rows
    against their plain versions, and the cell's query (2^24, T = 100)
    captured, replayed bit-equal to the eager query, its log Z-hat against
    Kalman (``chip_smoke.check_iapf_cell``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    ms, launches = chip_smoke.check_iapf_cell()
    assert ms > 0 and launches["user_chunk.vector_step_ctrl"] == 99

"""The port's kernel-from-spec discrete family
(``cpprob_tpu_torch.ops.fused_ssm.make_fused_discrete_ssm``: K9 init, K8
chunk for any K <= 32) against the JAX package's generated kernels.

On the CPU the wrappers run their plain PyTorch versions.  The Pallas
kernels run in interpret mode, which pins the transition draws to u = 0 and
the island offset to u0 = 0.5; the plain versions get the same pinned
draws.  ``block_r=32`` makes the reference's island (32 x 128 particles)
the port's ``ISLAND_SIZE``.  Records are compared as (ess, cat_w, lme).
Statistical checks use the 4·SE + 0.02 rule against the exact forward
recursion and the JAX package's own (XLA-path) estimate.
"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.inference.smc import build_smc_run as ref_build_smc_run
from cpprob_tpu.ops import pallas_ssm as ref_ssm
from cpprob_tpu_torch import build_smc_run, smc
from cpprob_tpu_torch.interop import population_from_numpy, spec_from_numpy
from cpprob_tpu_torch.ops import fused_hmm
from cpprob_tpu_torch.ops.fused_hmm import (
    ISLAND_SIZE,
    hmm_chunk_plain,
    hmm_init_plain,
    stats_from_partials,
)
from cpprob_tpu_torch.ops.fused_ssm import (
    discrete_hmm_log_evidence,
    discrete_hmm_smoothed_marginals,
    make_fused_discrete_ssm,
)

torch.set_num_threads(2)

TRANS5 = np.array([
    [0.50, 0.20, 0.10, 0.10, 0.10],
    [0.05, 0.60, 0.20, 0.10, 0.05],
    [0.10, 0.10, 0.40, 0.30, 0.10],
    [0.20, 0.05, 0.05, 0.50, 0.20],
    [0.10, 0.10, 0.10, 0.10, 0.60],
])
MEANS5 = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
STDS5 = np.array([0.5, 1.0, 0.7, 1.2, 0.9])
INIT5 = np.array([0.3, 0.1, 0.2, 0.2, 0.2])
BLOCK_R = 32                       # reference island = 4096 = ISLAND_SIZE
N = 2 * ISLAND_SIZE
N_SMC = 1 << 14
SEEDS = 8
FLOOR = 0.02


def _chain(K):
    """The 5-state chain of ``examples/kernel_bench.py``, or the K-state
    recipe of ``tests/test_tpu_hw.py:52-59`` (Dirichlet rows from
    ``default_rng(K)``, evenly spaced means and stds, uniform start)."""
    if K == 5:
        return TRANS5, MEANS5, STDS5, INIT5
    rng = np.random.default_rng(K)
    trans = rng.dirichlet(np.ones(K), size=K)
    return (trans, np.linspace(-3.0, 3.0, K), np.linspace(0.5, 1.6, K),
            np.full(K, 1.0 / K))


def _simulate(trans, means, stds, init, T, seed):
    rng = np.random.default_rng(seed)
    z = rng.choice(len(init), p=init)
    ys = []
    for _ in range(T):
        ys.append(means[z] + stds[z] * rng.standard_normal())
        z = rng.choice(len(init), p=trans[z])
    return np.array(ys, np.float32)


def _mean_se(vals):
    vals = np.asarray(vals, np.float64)
    return vals.mean(), vals.std(ddof=1) / math.sqrt(len(vals))


def _assert_stats(rec, n, ess, cat_w, lme):
    ess_p, cat_p, lme_p = (x.numpy() for x in stats_from_partials(rec, n))
    np.testing.assert_allclose(ess_p, np.asarray(ess), rtol=1e-5)
    np.testing.assert_allclose(lme_p, np.asarray(lme), rtol=1e-5)
    np.testing.assert_allclose(cat_p, np.asarray(cat_w), atol=1e-6)


class TestBuilderValidation:
    def test_rejects_nonsquare(self):
        with pytest.raises(ValueError, match="square"):
            make_fused_discrete_ssm(np.ones((3, 4)) / 4, np.zeros(3))

    def test_rejects_bad_rows(self):
        t = TRANS5.copy()
        t[0, 0] += 0.5
        with pytest.raises(ValueError, match="sum to 1"):
            make_fused_discrete_ssm(t, MEANS5)

    def test_rejects_nonpositive_std(self):
        with pytest.raises(ValueError, match="positive"):
            make_fused_discrete_ssm(TRANS5, MEANS5, np.zeros(5))

    def test_rejects_more_than_32_states(self):
        big = np.full((33, 33), 1.0 / 33)
        with pytest.raises(ValueError, match="K <= 32"):
            make_fused_discrete_ssm(big, np.zeros(33))
        with pytest.raises(ValueError, match="K <= 32"):
            ref_ssm.make_fused_discrete_ssm(big, np.zeros(33))

    def test_defaults_and_surface(self):
        m = make_fused_discrete_ssm(TRANS5, MEANS5)
        assert m.state_categories == 5
        for hook in ("fused_init_batch", "fused_chunk_exchange_t_batch",
                     "fused_step_exchange_batch", "fused_step_ess_batch",
                     "fused_step_batch", "init_sample_batch",
                     "step_sample_batch", "obs_logpdf_batch", "obs_sample"):
            assert getattr(m, hook) is not None, hook
        gen = torch.Generator().manual_seed(0)
        s = m.init_sample_batch(gen, 1 << 15)
        assert s.dtype == torch.int32
        np.testing.assert_allclose(np.bincount(s.numpy(), minlength=5) / (1 << 15),
                                   np.full(5, 0.2), atol=0.01)
        s2 = m.step_sample_batch(gen, torch.full((1 << 15,), 3, dtype=torch.int32), 1)
        np.testing.assert_allclose(np.bincount(s2.numpy(), minlength=5) / (1 << 15),
                                   TRANS5[3], atol=0.01)
        lp = m.obs_logpdf_batch(torch.arange(5, dtype=torch.int32), 0.3, 0).numpy()
        np.testing.assert_allclose(lp, -0.5 * (0.3 - MEANS5) ** 2
                                   - 0.5 * np.log(2 * np.pi), atol=1e-6)


# (flag, n_valid, island_every, island_thresh)
CASES = [(0, 8, 0, 0.5), (1, 8, 0, 0.5), (0, 5, 0, 0.5), (1, 8, 4, 2.0),
         (0, 8, 4, 0.0)]


@pytest.mark.parametrize("case", CASES,
                         ids=["plain", "flag", "short", "island", "island_off"])
@pytest.mark.parametrize("K", [2, 5, 12])
def test_chunk_matches_pallas_interpret(K, case):
    flag, n_valid, island_every, island_thresh = case
    trans, means, stds, init = _chain(K)
    rng = np.random.RandomState(10 * K + flag + n_valid)
    states = rng.randint(0, K, N).astype(np.int32)
    log_w = (2.0 * rng.normal(size=N)).astype(np.float32)
    ys = rng.normal(size=8).astype(np.float32)
    ticks = np.sort(rng.randint(0, N + 1, K - 1)).astype(np.int32)
    key = ref_ssm._intern_spec(np.asarray(trans, np.float64), means, stds, init)
    s_j, w_j, ess, cat_w, lme = ref_ssm._discrete_chunk(
        jnp.int32(0), jnp.asarray(states), jnp.asarray(log_w), jnp.asarray(ys),
        jnp.int32(n_valid), jnp.int32(flag), jnp.asarray(ticks), spec_key=key,
        n_steps=8, block_r=BLOCK_R, interpret=True, island_every=island_every,
        island_thresh=island_thresh)

    s_t, w_t = population_from_numpy(states, log_w, device="cpu")
    ctrl = torch.tensor([flag, *ticks, n_valid], dtype=torch.int32)
    n_checks = 1 if island_every else 0        # t = 3 only (t = 7 is the last)
    draws = (torch.zeros(8, N), torch.full((n_checks, N // ISLAND_SIZE), 0.5))
    s, w, rec = hmm_chunk_plain(
        0, s_t, w_t, torch.as_tensor(ys), ctrl, spec_from_numpy(trans, means, stds, init),
        island_every=island_every, island_thresh=island_thresh, draws=draws)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=2e-5, atol=2e-5)
    _assert_stats(rec, N, ess, cat_w, lme)
    fires = island_every and island_thresh > 1.0
    assert rec.shape == (N // ISLAND_SIZE, K + 4)
    np.testing.assert_array_equal(rec[:, -1].numpy(), float(fires))


@pytest.mark.parametrize("K", [2, 5, 12])
def test_init_matches_pallas_interpret(K):
    trans, means, stds, init = _chain(K)
    ref = ref_ssm.make_fused_discrete_ssm(trans, means, stds, init,
                                          block_r=BLOCK_R, interpret=True)
    s_j, w_j, ess, cat_w, lme = ref.fused_init_batch(jax.random.key(0), N,
                                                     jnp.float32(0.37))
    s, w, rec = hmm_init_plain(0, torch.tensor(np.float32(0.37)), N,
                               spec_from_numpy(trans, means, stds, init),
                               draws=torch.zeros(N))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=2e-5, atol=2e-5)
    _assert_stats(rec, N, ess, cat_w, lme)


def test_k32_plain_matches_numpy_replay():
    """K = 32 (the kernels' limit, served by the shared-memory design) on
    random pinned draws, steps and a forced island check, against numpy."""
    K, n, steps = 32, ISLAND_SIZE, 6
    trans, means, stds, init = _chain(K)
    spec = spec_from_numpy(trans, means, stds, init)
    rng = np.random.RandomState(32)
    states = rng.randint(0, K, n).astype(np.int32)
    ys = rng.normal(size=steps).astype(np.float32)
    u = rng.randint(0, 1 << 24, size=(steps, n)).astype(np.float32) / (1 << 24)
    s_t, w_t = population_from_numpy(states, np.zeros(n), device="cpu")
    ctrl = torch.tensor([0] * K + [steps], dtype=torch.int32)
    s, w, rec = hmm_chunk_plain(
        0, s_t, w_t, torch.as_tensor(ys), ctrl, spec, island_every=3,
        island_thresh=2.0, draws=(torch.as_tensor(u), torch.full((1, 1), 0.5)))
    cdf = np.cumsum(trans, axis=1)[:, :-1].astype(np.float32)
    s_ref, w_ref = states.astype(np.int64), np.zeros(n)
    for t in range(steps):
        s_ref = (u[t][:, None] >= cdf[s_ref]).sum(1)
        z = (ys[t] - means[s_ref]) / stds[s_ref]
        w_ref = w_ref - 0.5 * z * z - np.log(stds[s_ref]) - 0.5 * np.log(2 * np.pi)
        if t == 2:      # the forced check: sorted by category, weights reset
            e = np.exp(w_ref - w_ref.max())
            cum = np.cumsum(np.bincount(s_ref, weights=e, minlength=K))[:-1]
            tk = np.clip(np.ceil(n * cum / e.sum() - 0.5), 0, n)
            lme = w_ref.max() + np.log(e.sum()) - np.log(n)
            s_ref = (np.arange(n)[:, None] >= tk[None, :]).sum(1)
            w_ref = np.full(n, lme)
    # the check's ticks come from sums in another order and precision: up
    # to K-1 slots may hold a neighbouring category
    same = s.numpy() == s_ref
    assert (~same).sum() <= K - 1
    np.testing.assert_allclose(w.numpy()[same], w_ref[same], rtol=1e-4, atol=1e-4)
    assert float(rec[0, -1]) == 1.0
    ess, cat_w, _ = stats_from_partials(rec, n)
    np.testing.assert_allclose(cat_w.numpy().sum(), 1.0, rtol=1e-6)
    s0, w0, rec0 = hmm_init_plain(0, torch.tensor(ys[0]), n, spec,
                                  draws=torch.as_tensor(u[0]))
    icdf = np.cumsum(init)[:-1].astype(np.float32)
    np.testing.assert_array_equal(s0.numpy(), (u[0][:, None] >= icdf).sum(1))


def test_oracles_match_reference():
    for K, seed in ((5, 0), (12, 12), (32, 32)):
        trans, means, stds, init = _chain(K)
        ys = _simulate(trans, means, stds, init, 12, seed)
        assert abs(discrete_hmm_log_evidence(trans, means, stds, init, ys)
                   - ref_ssm.discrete_hmm_log_evidence(trans, means, stds, init,
                                                       ys)) < 1e-12
        np.testing.assert_allclose(
            discrete_hmm_smoothed_marginals(trans, means, stds, init, ys),
            ref_ssm.discrete_hmm_smoothed_marginals(trans, means, stds, init, ys),
            atol=1e-12)


def test_one_state_chain_is_exact():
    """K = 1: the reference serves it; so does the port (the run-time-K
    kernel design, and the plain versions): every particle carries the same
    weight, so the estimate is the exact evidence."""
    ys = _simulate(TRANS5, MEANS5, STDS5, INIT5, 16, 0)
    m = make_fused_discrete_ssm([[1.0]], [0.3], [1.2])
    exact = discrete_hmm_log_evidence([[1.0]], [0.3], [1.2], [1.0], ys)
    for chunk in (8, 1):
        res = build_smc_run(m, ISLAND_SIZE, chunk=chunk)(0, torch.as_tensor(ys))
        assert abs(float(res.log_evidence) - exact) < 1e-4


@functools.lru_cache(maxsize=1)
def _kernel_bench_observations():
    return _simulate(TRANS5, MEANS5, STDS5, INIT5, 16, 0)


@functools.lru_cache(maxsize=1)
def _ref_xla_logz():
    """The JAX package's estimate on the same chain and observations: its
    builder with the Pallas hooks stripped (the XLA path)."""
    ssm = dataclasses.replace(
        ref_ssm.make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5),
        fused_step_ess_batch=None, fused_step_exchange_batch=None,
        fused_chunk_exchange_batch=None, fused_init_batch=None)
    run = jax.jit(ref_build_smc_run(ssm, N_SMC))
    ys = jnp.asarray(_kernel_bench_observations())
    return _mean_se([float(run(jax.random.key(300 + i), ys).log_evidence)
                     for i in range(SEEDS)])


@pytest.mark.parametrize("path", ["chunk8", "island8_chunk16"])
def test_spec_paths_match_exact_and_reference(path):
    """Path 1 (chunk 8: K9, then K8 at 8 and 7 steps) and path 2 (one
    16-slot launch with the interior island check), at 2^14."""
    ys = _kernel_bench_observations()
    island_counts = []
    if path == "chunk8":
        m, chunk = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5), 8
    else:
        m = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5, island_every=8,
                                    island_counts=island_counts)
        chunk = 16
    run = build_smc_run(m, N_SMC, chunk=chunk)
    results = [run(i, torch.as_tensor(ys)) for i in range(SEEDS)]
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    exact = discrete_hmm_log_evidence(TRANS5, MEANS5, STDS5, INIT5, ys)
    assert abs(mean - exact) < 4 * se + FLOOR, (mean, se, exact)
    mean_ref, se_ref = _ref_xla_logz()
    assert abs(mean - mean_ref) < 4 * math.hypot(se, se_ref) + FLOOR
    for r in results:
        assert r.final_states.dtype == torch.int32
        assert r.resampled.shape == (1 + -(-15 // chunk),)
    if island_counts:
        assert len(island_counts) == SEEDS
        assert float(torch.stack(island_counts).mean()) > 0


@pytest.mark.parametrize("route", ["exchange_chunk1", "smc_history"])
def test_spec_per_step_routes_match_exact(route):
    """The spec model's per-step hooks: chunk 1 (one-step exchange launches,
    K4's route) and smc() with history (the K5 route)."""
    ys = torch.as_tensor(_kernel_bench_observations())
    m = make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5)
    before = dict(fused_hmm.LAUNCHES)
    if route == "exchange_chunk1":
        run = build_smc_run(m, N_SMC)
        results = [run(i, ys) for i in range(SEEDS)]
    else:
        results = [smc(m, ys, N_SMC, i) for i in range(SEEDS)]
        assert results[0].states.shape == (16, N_SMC)
    assert fused_hmm.LAUNCHES == before          # no kernel on the CPU
    mean, se = _mean_se([float(r.log_evidence) for r in results])
    exact = discrete_hmm_log_evidence(TRANS5, MEANS5, STDS5, INIT5,
                                      _kernel_bench_observations())
    assert abs(mean - exact) < 4 * se + FLOOR, (mean, se, exact)


@pytest.mark.cuda
def test_spec_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    errs = chip_smoke.check_spec_kernels(1 << 16)
    assert errs["spec_init"] < 1e-4 and errs["spec_chunk"] < 1e-3

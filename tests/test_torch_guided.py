"""Guided SMC in the port (``cpprob_tpu_torch.inference.smc_csis`` and the
guided paths of ``build_smc_run`` / ``smc``) against the JAX package.

The trainer's per-site loss and the fallback proposal are held against the
reference's formulas on the same nets and inputs (converted with
``interop.mlp_params_from_numpy``).  The statistical checks run the
guided paths through the kernels' plain versions at 2^14 particles over 8
seeds, against the exact evidence (Kalman, the forward recursion) within
4·SE + 0.02, and against the JAX package's own guided estimate (its
unfused guided SMC on the same net) within 4·hypot(SE, SE_ref) + 0.02.
The nets are trained here by the port's trainer (hidden 8, T = 12).
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.inference import nn as ref_nn
from cpprob_tpu.inference.smc import build_smc_run as ref_build_smc_run
from cpprob_tpu.inference.smc_csis import guide_ssm as ref_guide_ssm
from cpprob_tpu.models.linear_gaussian import linear_gaussian_ssm as ref_lg
from cpprob_tpu.ops.pallas_ssm import make_fused_discrete_ssm as ref_discrete
from cpprob_tpu_torch import build_smc_run, smc
from cpprob_tpu_torch.inference.smc_csis import (
    guide_ssm,
    proposal_site_nll,
    train_ssm_proposal,
)
from cpprob_tpu_torch.interop import mlp_params_from_numpy
from cpprob_tpu_torch.models.linear_gaussian import (
    kalman_filter_1d,
    linear_gaussian_ssm,
)
from cpprob_tpu_torch.ops.fused_ssm import (
    attach_fused_guided_discrete_kernels,
    attach_fused_guided_scalar_kernels,
    discrete_hmm_log_evidence,
    make_fused_discrete_ssm,
)

torch.set_num_threads(2)

T = 12
K = 5
N = 1 << 14
SEEDS = 8
FLOOR = 0.02
half_log_2pi = 0.9189385332046727
TRANS5 = np.array([[0.50, 0.20, 0.10, 0.10, 0.10],
                   [0.05, 0.60, 0.20, 0.10, 0.05],
                   [0.10, 0.10, 0.40, 0.30, 0.10],
                   [0.20, 0.05, 0.05, 0.50, 0.20],
                   [0.10, 0.10, 0.10, 0.10, 0.60]])
MEANS5 = np.array([-2.0, -1.0, 0.0, 1.0, 2.0])
STDS5 = np.array([0.5, 1.0, 0.7, 1.2, 0.9])
INIT5 = np.array([0.3, 0.1, 0.2, 0.2, 0.2])


def trans_lp(x, nx, t):
    d = nx - x
    return -0.5 * d * d - half_log_2pi


def obs_lp(nx, y, t):
    d = y - nx
    return -0.5 * d * d - half_log_2pi


def _mean_se(vals):
    vals = np.asarray(vals, np.float64)
    return vals.mean(), vals.std(ddof=1) / math.sqrt(len(vals))


def _chain_obs(T_, seed):
    """tests/test_tpu_hw.py:31-39's observations of the 5-state chain."""
    rng = np.random.default_rng(seed)
    z = rng.choice(K, p=INIT5)
    ys = []
    for _ in range(T_):
        ys.append(MEANS5[z] + STDS5[z] * rng.standard_normal())
        z = rng.choice(K, p=TRANS5[z])
    return np.array(ys, np.float32)


@functools.lru_cache(maxsize=1)
def _nets():
    """(LG net, chain net), trained on the CPU by the port's trainer: the
    LG net at seed 10, whose initial net leaves no site's scale at its
    floor (see chip_smoke.py), both at lr 1e-2 to converge in 150 steps."""
    lg, _ = train_ssm_proposal(linear_gaussian_ssm, 10, T, kind="normal",
                               steps=150, batch_size=128, hidden=8,
                               learning_rate=1e-2, device="cpu")
    chain, _ = train_ssm_proposal(
        make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5), 6, T,
        kind="discrete", n_states=K, steps=150, batch_size=128, hidden=8,
        learning_rate=1e-2, device="cpu")
    return lg, chain


def _np(params):
    return [{k: v.numpy() for k, v in layer.items()} for layer in params]


def _lg_obs(seed=3, scale=1.3):
    return np.random.RandomState(seed).normal(0, scale, T).astype(np.float32)


# --------------------------------------------------------------------------
# the trainer and the fallback proposal


def _ref_site_nll(params, kind, z_prev, z_new, y, t):
    """smc_csis.py:108-117, written with cpprob_tpu.inference.nn."""
    tf = jnp.asarray(t, jnp.float32) / T
    if kind == "discrete":
        x = jnp.concatenate([jax.nn.one_hot(z_prev, K),
                             jnp.asarray(y, jnp.float32)[None], tf[None]])
        return -jax.nn.log_softmax(ref_nn.mlp_apply(params, x))[z_new]
    x = jnp.stack([jnp.asarray(z_prev, jnp.float32),
                   jnp.asarray(y, jnp.float32), tf])
    raw = ref_nn.mlp_apply(params, x)
    std = ref_nn.softplus(raw[1])
    d = (jnp.asarray(z_new, jnp.float32) - raw[0]) / std
    return 0.5 * d * d + jnp.log(std) + 0.9189385332046727


def _rollouts(kind, B=32, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "discrete":
        z = rng.integers(0, K, (B, T))
        y = MEANS5[z] + STDS5[z] * rng.standard_normal((B, T))
    else:
        z = np.cumsum(rng.standard_normal((B, T)), 1)
        y = z + rng.standard_normal((B, T))
    ts = np.broadcast_to(np.arange(1, T), (B, T - 1)).copy()
    return z[:, :-1], z[:, 1:], y[:, 1:].astype(np.float32), ts


@pytest.mark.parametrize("kind", ["normal", "discrete"])
def test_site_nll_matches_reference(kind):
    sizes = [3, 8, 8, 2] if kind == "normal" else [K + 2, 8, 8, K]
    params = ref_nn.mlp_init(jax.random.key(4), sizes)
    params = [{"w": np.asarray(p["w"]), "b": 0.1 + np.asarray(p["b"])} for p in params]
    zp, zn, y, ts = _rollouts(kind)
    want = jax.vmap(jax.vmap(lambda a, b, c, d: _ref_site_nll(
        params, kind, a, b, c, d)))(zp, zn, y, ts)
    dt = torch.int64 if kind == "discrete" else torch.float32
    got = proposal_site_nll(mlp_params_from_numpy(params, device="cpu"),
                            torch.as_tensor(zp, dtype=dt),
                            torch.as_tensor(zn, dtype=dt), torch.as_tensor(y),
                            torch.as_tensor(ts), T, kind=kind, n_states=K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["normal", "discrete"])
def test_training_loss_falls(kind):
    model = (linear_gaussian_ssm if kind == "normal"
             else make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5))
    params, losses = train_ssm_proposal(model, 10, T, kind=kind, n_states=K,
                                        steps=80, batch_size=128, hidden=8,
                                        device="cpu")
    assert losses.shape == (80,) and torch.isfinite(losses).all()
    assert float(losses[-10:].mean()) < float(losses[:10].mean())
    assert all(not p.requires_grad for layer in params for p in layer.values())
    assert params[0]["w"].shape == ((3 if kind == "normal" else K + 2), 8)


def test_trainer_rejects_models_without_the_hooks():
    import dataclasses

    with pytest.raises(ValueError, match="obs_sample"):
        train_ssm_proposal(dataclasses.replace(linear_gaussian_ssm, obs_sample=None),
                           0, T, kind="normal", steps=1, device="cpu")
    with pytest.raises(ValueError, match="kind"):
        train_ssm_proposal(linear_gaussian_ssm, 0, T, kind="beta", steps=1,
                           device="cpu")


@pytest.mark.parametrize("kind", ["normal", "discrete"])
def test_guide_ssm_proposal_logpdf_matches_reference(kind):
    lg, chain = _nets()
    params = lg if kind == "normal" else chain
    rng = np.random.default_rng(5)
    if kind == "normal":
        z_prev = rng.standard_normal(256).astype(np.float32)
        z_new = (z_prev + rng.standard_normal(256)).astype(np.float32)
        ref = ref_guide_ssm(ref_lg, _np(params), T, kind="normal")
        port = guide_ssm(linear_gaussian_ssm, params, T, kind="normal")
    else:
        z_prev = rng.integers(0, K, 256).astype(np.int32)
        z_new = rng.integers(0, K, 256).astype(np.int32)
        ref = ref_guide_ssm(ref_discrete(TRANS5, MEANS5, STDS5, INIT5), _np(params),
                            T, kind="discrete", n_states=K)
        port = guide_ssm(make_fused_discrete_ssm(TRANS5, MEANS5, STDS5, INIT5),
                         params, T, kind="discrete", n_states=K)
    want = jax.vmap(lambda a, b: ref.proposal_logpdf(a, b, 4, 0.3))(z_new, z_prev)
    got = port.proposal_logpdf(torch.as_tensor(z_new), torch.as_tensor(z_prev),
                               4, torch.tensor(0.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert port.step_sample_batch is None and port.fused_step_batch is None
    # the sampler draws the population from q
    gen = torch.Generator()
    gen.manual_seed(0)
    draws = port.proposal_sample(gen, torch.as_tensor(z_prev), 4, torch.tensor(0.3))
    assert draws.shape == (256,) and draws.dtype == torch.as_tensor(z_prev).dtype


# --------------------------------------------------------------------------
# the guided paths against the exact evidence and the JAX package


@functools.lru_cache(maxsize=None)
def _ref_guided_logz(kind):
    lg, chain = _nets()
    if kind == "normal":
        model = ref_guide_ssm(ref_lg, _np(lg), T, kind="normal")
        ys = jnp.asarray(_lg_obs())
    else:
        model = ref_guide_ssm(ref_discrete(TRANS5, MEANS5, STDS5, INIT5),
                              _np(chain), T, kind="discrete", n_states=K)
        ys = jnp.asarray(_chain_obs(T, 3))
    run = jax.jit(ref_build_smc_run(model, N))
    return _mean_se([float(run(jax.random.key(400 + i), ys).log_evidence)
                     for i in range(SEEDS)])


def _check(zs, exact, kind):
    mean, se = _mean_se(zs)
    assert abs(mean - exact) < 4 * se + FLOOR, (mean, se, exact)
    mean_ref, se_ref = _ref_guided_logz(kind)
    assert abs(mean - mean_ref) < 4 * math.hypot(se, se_ref) + FLOOR, (
        mean, mean_ref)


@pytest.mark.parametrize("chunk", [4, 1])
def test_guided_lg_matches_kalman_and_reference(chunk):
    """Chunk 4: K12's plain version between streaming epochs; chunk 1: the
    engine's unfused guided step with the streaming epoch."""
    lg, _ = _nets()
    model = attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, lg, T, trans_logpdf_elem=trans_lp,
        obs_logpdf_elem=obs_lp)
    ys = _lg_obs()
    run = build_smc_run(model, N, chunk=chunk)
    _check([float(run(i, torch.as_tensor(ys)).log_evidence) for i in range(SEEDS)],
           kalman_filter_1d(ys)[2], "normal")


@pytest.mark.parametrize("route", ["chunk4", "chunk1", "island4_chunk12"])
def test_guided_chain_matches_exact_and_reference(route):
    """Chunk 4: K9, then K13's plain version at 4 and 3 steps; chunk 1: its
    one-step launches; the whole sweep with interior island checks."""
    _, chain = _nets()
    island_counts = []
    every, chunk = ((4, 12) if route == "island4_chunk12"
                    else (0, int(route[-1])))
    model = attach_fused_guided_discrete_kernels(
        TRANS5, MEANS5, STDS5, INIT5, params=chain, T=T, island_every=every,
        island_counts=island_counts)
    ys = _chain_obs(T, 3)
    run = build_smc_run(model, N, chunk=chunk)
    results = [run(i, torch.as_tensor(ys)) for i in range(SEEDS)]
    _check([float(r.log_evidence) for r in results],
           discrete_hmm_log_evidence(TRANS5, MEANS5, STDS5, INIT5, ys), "discrete")
    assert results[0].final_states.dtype == torch.int32
    if every:
        assert float(torch.stack(island_counts).mean()) > 0


@pytest.mark.parametrize("kind", ["normal", "discrete"])
def test_guided_smc_with_history(kind):
    """smc() keeps the history and takes the engine's unfused guided step
    (the fused models' fallback hooks serve the same net)."""
    lg, chain = _nets()
    if kind == "normal":
        model = attach_fused_guided_scalar_kernels(
            linear_gaussian_ssm, lg, T, trans_logpdf_elem=trans_lp,
            obs_logpdf_elem=obs_lp)
        ys, exact = _lg_obs(), kalman_filter_1d(_lg_obs())[2]
    else:
        model = attach_fused_guided_discrete_kernels(
            TRANS5, MEANS5, STDS5, INIT5, params=chain, T=T)
        ys = _chain_obs(T, 3)
        exact = discrete_hmm_log_evidence(TRANS5, MEANS5, STDS5, INIT5, ys)
    results = [smc(model, torch.as_tensor(ys), N, i) for i in range(SEEDS)]
    _check([float(r.log_evidence) for r in results], exact, kind)
    assert results[0].states.shape == (T, N)
    assert results[0].ancestors.shape == (T, N)


def test_initial_proposal_enters_the_weights():
    """An initial proposal (population-batched hooks) is RN-corrected: a
    deliberately wide N(0, 2^2) start keeps the LG evidence exact."""
    sd = 2.0

    def init_proposal_sample(key, y0, n):
        return sd * torch.randn(n, generator=key, device=key.device)

    def init_proposal_logpdf(s, y0):
        z = s / sd
        return -0.5 * z * z - math.log(sd) - half_log_2pi

    import dataclasses

    model = dataclasses.replace(linear_gaussian_ssm,
                                init_proposal_sample=init_proposal_sample,
                                init_proposal_logpdf=init_proposal_logpdf)
    ys = _lg_obs()
    run = build_smc_run(model, N)
    mean, se = _mean_se([float(run(i, torch.as_tensor(ys)).log_evidence)
                         for i in range(SEEDS)])
    exact = kalman_filter_1d(ys)[2]
    assert abs(mean - exact) < 4 * se + FLOOR, (mean, se, exact)


def test_guided_needs_fewer_resamples():
    """tests/test_guided_smc.py:45-57: on outlying observations the guided
    filter resamples no more often than the bootstrap filter."""
    lg, _ = _nets()
    ys = torch.as_tensor(np.random.RandomState(11).normal(0, 2.0, T).astype(np.float32))
    guided = guide_ssm(linear_gaussian_ssm, lg, T, kind="normal")
    res_g = smc(guided, ys, 4096, 0, ess_threshold=0.5)
    res_b = smc(linear_gaussian_ssm, ys, 4096, 0, ess_threshold=0.5)
    assert int(res_g.resampled.sum()) <= int(res_b.resampled.sum())

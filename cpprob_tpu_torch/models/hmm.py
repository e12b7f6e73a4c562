"""3-state HMM with Gaussian emissions, state-space form — counterpart of
``cpprob_tpu/models/hmm.py`` (reference ``include/models/models.hpp:114-141``:
means (-1, 0, 1), fixed transition matrix, uniform initial state).

Only the :class:`~cpprob_tpu_torch.inference.smc.StateSpaceModel` form is
here; the trace forms ``hmm`` / ``hmm_scan`` need the trace substrate.
The model's ``key`` arguments are ``torch.Generator`` objects on the
device the population lives on.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..inference.smc import StateSpaceModel

__all__ = [
    "HMM_MEANS", "HMM_TRANS", "hmm_ssm", "hmm_exact_posterior",
    "hmm_log_evidence", "simulate_observations",
]

HMM_MEANS = np.array([-1.0, 0.0, 1.0], np.float32)
HMM_TRANS = np.array(
    [
        [0.10, 0.50, 0.40],
        [0.20, 0.20, 0.60],
        [0.15, 0.15, 0.70],
    ],
    np.float32,
)
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device):
    """(means (3,), log transition matrix (3, 3), transition CDF (3, 2)) on
    ``device`` — made once per device so a step copies nothing from the
    host."""
    cdf = np.cumsum(HMM_TRANS.astype(np.float64), axis=1)[:, :-1]
    return (
        torch.as_tensor(HMM_MEANS, device=device),
        torch.as_tensor(np.log(HMM_TRANS), device=device),
        torch.as_tensor(cdf.astype(np.float32), device=device),
    )


def _hmm_init(key):
    return torch.randint(0, 3, (), generator=key, device=key.device)


def _hmm_init_logpdf(state):
    return torch.full((), -math.log(3.0))


def _hmm_step_sample(key, state, t):
    return _hmm_step_batch(key, state.reshape(1), t).reshape(())


def _hmm_step_logpdf(new_state, state, t):
    return _tables(new_state.device)[1][state, new_state]


def _hmm_obs_logpdf(state, y, t):
    return _hmm_obs_batch(state, y, t)


def _hmm_init_batch(key, n):
    return torch.randint(0, 3, (n,), generator=key, device=key.device,
                         dtype=torch.int32)


def _hmm_step_batch(key, states, t):
    # inverse CDF against each particle's transition row
    cdf = _tables(states.device)[2]
    u = torch.rand(states.shape, generator=key, device=states.device)
    return (u[..., None] >= cdf[states.long()]).sum(-1).to(states.dtype)


def _hmm_obs_batch(states, y, t):
    d = y - _tables(states.device)[0][states.long()]
    return -0.5 * d * d - _HALF_LOG_2PI   # N(mean, 1) logpdf


def _hmm_obs_sample(key, state, t):
    mean = _tables(state.device)[0][state.long()]
    return mean + torch.randn(mean.shape, generator=key, device=state.device)


hmm_ssm = StateSpaceModel(
    init_sample=_hmm_init,
    init_logpdf=_hmm_init_logpdf,
    step_sample=_hmm_step_sample,
    step_logpdf=_hmm_step_logpdf,
    obs_logpdf=_hmm_obs_logpdf,
    init_sample_batch=_hmm_init_batch,
    step_sample_batch=_hmm_step_batch,
    obs_logpdf_batch=_hmm_obs_batch,
    obs_sample=_hmm_obs_sample,
    # 3-state discrete space: enables the exchange (category-count)
    # systematic resampler
    state_categories=3,
)


def hmm_exact_posterior(observations):
    """Exact smoothed marginals p(z_t | y_{1:T}) (T, 3) via forward-backward,
    host numpy in float64 — the correctness oracle."""
    obs = np.asarray(observations, np.float64)
    T = obs.shape[0]
    means = np.asarray(HMM_MEANS, np.float64)
    trans = np.asarray(HMM_TRANS, np.float64)
    emis = np.exp(-0.5 * (obs[:, None] - means[None, :]) ** 2) / np.sqrt(
        2.0 * np.pi
    )

    alphas = np.zeros((T, 3))
    a = (1.0 / 3.0) * emis[0]
    alphas[0] = a / a.sum()
    for t in range(1, T):
        a = (alphas[t - 1] @ trans) * emis[t]
        alphas[t] = a / a.sum()

    betas = np.zeros((T, 3))
    betas[T - 1] = 1.0
    for t in range(T - 2, -1, -1):
        b = trans @ (emis[t + 1] * betas[t + 1])
        betas[t] = b / b.max()

    post = alphas * betas
    return post / post.sum(axis=1, keepdims=True)


def hmm_log_evidence(observations, trans=HMM_TRANS, means=HMM_MEANS,
                     stds=None, init_probs=None) -> float:
    """Exact log p(y_{1:T}) of a K-state Gaussian-emission HMM by the
    forward recursion (host numpy, float64).  Defaults: this module's HMM
    with unit emission std and a uniform initial state."""
    trans = np.asarray(trans, np.float64)
    means = np.asarray(means, np.float64)
    k = trans.shape[0]
    stds = np.ones(k) if stds is None else np.asarray(stds, np.float64)
    p = (np.full(k, 1.0 / k) if init_probs is None
         else np.asarray(init_probs, np.float64))
    log_z = 0.0
    alpha = p
    for t, y in enumerate(np.asarray(observations, np.float64)):
        emis = np.exp(-0.5 * ((y - means) / stds) ** 2) / (
            stds * np.sqrt(2 * np.pi)
        )
        a = (p if t == 0 else alpha @ trans) * emis
        log_z += np.log(a.sum())
        alpha = a / a.sum()
    return float(log_z)


def simulate_observations(T: int = 16, seed: int = 0) -> np.ndarray:
    """(T,) float32 observations simulated from the HMM with
    ``np.random.RandomState(seed)`` — the draw order of the repository's
    headline benchmark, so ``simulate_observations(16, 0)`` are its
    observations."""
    rng = np.random.RandomState(seed)
    z = rng.randint(0, 3)
    obs = []
    for t in range(T):
        if t > 0:
            z = rng.choice(3, p=HMM_TRANS[z])
        obs.append(rng.normal(HMM_MEANS[z], 1.0))
    return np.asarray(obs, np.float32)

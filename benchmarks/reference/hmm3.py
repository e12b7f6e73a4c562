"""Plain reference of ``hmm3``: a K-state hidden Markov chain with
Gaussian emissions (the configuration's file gives K, the means, the
emission std, the transition table and the initial distribution).

- :func:`simulate`: a pool of observation series drawn from the model;
- :func:`exact`: the forward recursion in float64: log p(y_{0:T-1}) and
  the filtering distribution p(z_{T-1} | y_{0:T-1}) of each series;
- :func:`recursion`: the same recursion in any torch dtype (the control
  computes it in bfloat16);
- :func:`summarize`, :func:`filter_error`: the weighted distribution of a
  final population over the states, and its squared distance from the
  exact filtering distribution.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _tables(cfg):
    return (np.asarray(cfg["means"], np.float64),
            float(cfg["emission_std"]),
            np.asarray(cfg["transition"], np.float64),
            np.asarray(cfg["initial"], np.float64))


def simulate(rng: np.random.Generator, pool: int, cfg) -> np.ndarray:
    """(pool, T) float32 observation series, each drawn from the model:
    z_0 from the initial distribution, z_t from row z_{t-1} of the
    transition table, y_t ~ N(means[z_t], std^2)."""
    means, std, trans, init = _tables(cfg)
    T = int(cfg["series_length"])
    cdf0 = np.cumsum(init)[:-1]
    cdf = np.cumsum(trans, axis=1)[:, :-1]
    z = (rng.random(pool)[:, None] >= cdf0[None, :]).sum(1)
    ys = np.empty((pool, T))
    for t in range(T):
        if t:
            z = (rng.random(pool)[:, None] >= cdf[z]).sum(1)
        ys[:, t] = means[z] + std * rng.standard_normal(pool)
    return ys.astype(np.float32)


def exact(ys: np.ndarray, cfg):
    """Forward recursion in float64 over every series of ``ys`` (P, T):
    (log-evidence (P,), filtering distribution at the last step (P, K))."""
    means, std, trans, init = _tables(cfg)
    y = np.asarray(ys, np.float64)
    log_norm = -math.log(std) - 0.5 * math.log(2.0 * math.pi)
    log_z = np.zeros(y.shape[0])
    alpha = np.broadcast_to(init, (y.shape[0], init.shape[0]))
    for t in range(y.shape[1]):
        emis = np.exp(-0.5 * ((y[:, t, None] - means) / std) ** 2 + log_norm)
        a = (alpha if t == 0 else alpha @ trans) * emis
        s = a.sum(1)
        log_z += np.log(s)
        alpha = a / s[:, None]
    return log_z, alpha


def recursion(ys: np.ndarray, cfg, dtype, device="cpu"):
    """:func:`exact`'s recursion with every operation in ``dtype`` on
    ``device``; returns float64 numpy arrays as :func:`exact` does."""
    means, std, trans, init = _tables(cfg)
    c = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device).to(dtype)
    y, mu, A = c(ys), c(means), c(trans)
    inv_std = c(1.0 / std)
    log_norm = c(-math.log(std) - 0.5 * math.log(2.0 * math.pi))
    alpha = c(init).expand(y.shape[0], -1)
    log_z = torch.zeros(y.shape[0], dtype=dtype, device=device)
    for t in range(y.shape[1]):
        d = (y[:, t, None] - mu) * inv_std
        emis = torch.exp(-0.5 * d * d + log_norm)
        a = (alpha if t == 0 else alpha @ A) * emis
        s = a.sum(1)
        log_z = log_z + torch.log(s)
        alpha = a / s[:, None]
    return (log_z.double().cpu().numpy(), alpha.double().cpu().numpy())


def summarize(final_states: torch.Tensor, final_log_weights: torch.Tensor, cfg):
    """The weighted share of each state in a final population (K,), in
    float64, on the population's device (a small device tensor)."""
    lw = final_log_weights.double()
    w = torch.exp(lw - lw.max())
    K = len(cfg["means"])
    counts = torch.bincount(final_states.long(), weights=w, minlength=K)
    return counts[:K] / w.sum()


def filter_error(summary: np.ndarray, exact_filter: np.ndarray) -> float:
    """Squared distance of a population's state shares from the exact
    filtering distribution: sum over the states of the squared gaps."""
    d = np.asarray(summary, np.float64) - np.asarray(exact_filter, np.float64)
    return float(np.sum(d * d))

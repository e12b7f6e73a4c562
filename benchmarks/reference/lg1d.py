"""Plain reference of ``lg1d``: the 1-D linear-Gaussian state-space
model x_0 ~ N(m0, p0), x_t ~ N(x_{t-1}, q), y_t ~ N(x_t, r) (the
configuration's file gives m0, p0, q and r).

- :func:`simulate`: a pool of observation series drawn from the model;
- :func:`exact`: the Kalman filter in float64: log p(y_{0:T-1}) and the
  filtering distribution N(m, P) of x_{T-1} of each series;
- :func:`recursion`: the same filter in any torch dtype (the control
  computes it in bfloat16);
- :func:`summarize`, :func:`filter_error`: the weighted mean and variance
  of a final population, and their squared distance from the exact ones
  in units of P.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _params(cfg):
    return (float(cfg["prior_mean"]), float(cfg["prior_var"]),
            float(cfg["transition_var"]), float(cfg["observation_var"]))


def simulate(rng: np.random.Generator, pool: int, cfg) -> np.ndarray:
    """(pool, T) float32 observation series drawn from the model."""
    m0, p0, q, r = _params(cfg)
    T = int(cfg["series_length"])
    x = m0 + math.sqrt(p0) * rng.standard_normal(pool)
    ys = np.empty((pool, T))
    for t in range(T):
        if t:
            x = x + math.sqrt(q) * rng.standard_normal(pool)
        ys[:, t] = x + math.sqrt(r) * rng.standard_normal(pool)
    return ys.astype(np.float32)


def _kalman(y, m0, p0, q, r, ops):
    """The filter over the columns of ``y`` with the arithmetic of
    ``ops`` (numpy or torch): (log-evidence, filtered mean, filtered
    variance) of the last step."""
    m_pred, p_pred = m0, p0
    log_z = 0.0
    for t in range(y.shape[1]):
        s = p_pred + r
        k = p_pred / s
        d = y[:, t] - m_pred
        log_z = log_z - 0.5 * d * d / s - 0.5 * (ops.log(s) + math.log(2.0 * math.pi))
        m = m_pred + k * d
        p = (1.0 - k) * p_pred
        m_pred, p_pred = m, p + q
    return log_z, m, p


def exact(ys: np.ndarray, cfg):
    """Kalman filter in float64 over every series of ``ys`` (P, T):
    (log-evidence (P,), filtering mean and variance at the last step
    (P, 2))."""
    m0, p0, q, r = _params(cfg)
    y = np.asarray(ys, np.float64)
    n = y.shape[0]
    log_z, m, p = _kalman(y, np.full(n, m0), np.full(n, p0), q, r, np)
    return log_z, np.stack([m, p], 1)


def recursion(ys: np.ndarray, cfg, dtype, device="cpu"):
    """:func:`exact`'s filter with every operation in ``dtype`` on
    ``device``; returns float64 numpy arrays as :func:`exact` does."""
    m0, p0, q, r = _params(cfg)
    y = torch.as_tensor(np.asarray(ys, np.float64), device=device).to(dtype)
    n = y.shape[0]
    c = lambda v: torch.full((n,), v, dtype=dtype, device=device)
    log_z, m, p = _kalman(y, c(m0), c(p0), c(q), c(r), torch)
    return (log_z.double().cpu().numpy(),
            torch.stack([m, p], 1).double().cpu().numpy())


def summarize(final_states: torch.Tensor, final_log_weights: torch.Tensor, cfg):
    """The weighted mean and variance of a final population (2,), in
    float64, on the population's device (a small device tensor)."""
    lw = final_log_weights.double()
    w = torch.exp(lw - lw.max())
    w = w / w.sum()
    x = final_states.double()
    mean = torch.sum(w * x)
    return torch.stack([mean, torch.sum(w * (x - mean) ** 2)])


def filter_error(summary: np.ndarray, exact_filter: np.ndarray) -> float:
    """((mean - m)^2 / P + ((var - P) / P)^2): the gaps of a population's
    weighted mean and variance from the exact filtering distribution, in
    units of its variance P."""
    mean, var = (float(v) for v in summary)
    m, p = (float(v) for v in exact_filter)
    return (mean - m) ** 2 / p + ((var - p) / p) ** 2

"""Linear-Gaussian state-space model — counterpart of
``cpprob_tpu/models/linear_gaussian.py`` (reference
``include/models/models.hpp:67-80``, ``linear_gaussian_1d``):
x_0 ~ N(0, 1), x_t ~ N(x_{t-1}, 1), y_t ~ N(x_t, 1).

Both the trace form :func:`linear_gaussian_1d` (for SIS) and the
:class:`~cpprob_tpu_torch.inference.smc.StateSpaceModel` form, whose
``key`` arguments are ``torch.Generator`` objects on the device the
population lives on.  ``kalman_filter_1d`` is the exact
oracle, in numpy float64 (the port never imports JAX).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core import as_tensor, observe, predict, sample
from ..distributions import Normal
from ..inference.smc import StateSpaceModel
from ..ops.population import takes_device_key

__all__ = ["linear_gaussian_1d", "linear_gaussian_ssm", "kalman_filter_1d",
           "obs_logpdf_elem", "simulate_observations", "trans_logpdf_elem"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _normal_logpdf(x, mean):
    d = x - mean
    return -0.5 * d * d - _HALF_LOG_2PI


def trans_logpdf_elem(x, nx, t):
    """log N(nx; x, 1), the transition, as an elementwise density under the
    contract of ``ops/render.py`` (the guided chunk kernels' signature
    ``(x, nx, t)``: ``attach_fused_guided_scalar_kernels``)."""
    d = nx - x
    return -0.5 * d * d - _HALF_LOG_2PI


def obs_logpdf_elem(nx, y, t):
    """log N(y; nx, 1), the emission, as an elementwise density (signature
    ``(nx, y, t)``), the partner of :func:`trans_logpdf_elem`."""
    d = y - nx
    return -0.5 * d * d - _HALF_LOG_2PI


def _randn(key, shape):
    return torch.randn(shape, generator=key, device=key.device)


def linear_gaussian_1d(observations):
    """x_t ~ N(x_{t-1}, 1), y_t ~ N(x_t, 1), x_0 = 0 (``models.hpp:67-80``)."""
    observations = as_tensor(observations)
    state = as_tensor(0.0)
    for t in range(observations.shape[0]):
        state = sample(Normal(state, 1.0), addr=f"x[{t}]")
        observe(Normal(state, 1.0), observations[t], addr=f"y[{t}]")
        predict(state, "State")
    return state


linear_gaussian_ssm = StateSpaceModel(
    init_sample=lambda key: _randn(key, ()),
    init_logpdf=lambda s: _normal_logpdf(s, 0.0),
    step_sample=lambda key, s, t: s + _randn(key, s.shape),
    step_logpdf=lambda ns, s, t: _normal_logpdf(ns, s),
    obs_logpdf=lambda s, y, t: _normal_logpdf(y, s),
    # the start from the prior draws from the sweep's generator alone, so a
    # card may capture it (inference.smc.build_smc_run)
    init_sample_batch=takes_device_key(lambda key, n: _randn(key, (n,))),
    step_sample_batch=lambda key, s, t: s + _randn(key, s.shape),
    obs_logpdf_batch=takes_device_key(lambda s, y, t: _normal_logpdf(y, s)),
    obs_sample=lambda key, s, t: s + _randn(key, s.shape),
    # scalar continuous state: the streaming (or sorted-fill) value
    # resampler, no per-particle gather, when no history is stored
    scalar_state=True,
)


def kalman_filter_1d(observations, q=1.0, r=1.0):
    """Exact filtered means and variances (T,) and the log-evidence of the
    model above, host numpy in float64.  Prior x_0 ~ N(0, q); transitions
    add q; observations have variance r."""
    m_pred, p_pred, ll = 0.0, float(q), 0.0
    ms, ps = [], []
    for y in np.asarray(observations, np.float64):
        s = p_pred + r
        k = p_pred / s
        ll += -0.5 * (y - m_pred) ** 2 / s - 0.5 * math.log(2.0 * math.pi * s)
        m = m_pred + k * (y - m_pred)
        p = (1.0 - k) * p_pred
        ms.append(m)
        ps.append(p)
        m_pred, p_pred = m, p + q
    return np.asarray(ms), np.asarray(ps), float(ll)


def simulate_observations(T: int = 16, seed: int = 0) -> np.ndarray:
    """(T,) float32 observations drawn from the model itself with
    ``np.random.RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    x, obs = 0.0, []
    for t in range(T):
        x = rng.normal(0.0 if t == 0 else x, 1.0)
        obs.append(rng.normal(x, 1.0))
    return np.asarray(obs, np.float32)

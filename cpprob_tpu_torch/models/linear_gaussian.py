"""Linear-Gaussian state-space model — counterpart of
``cpprob_tpu/models/linear_gaussian.py`` (reference
``include/models/models.hpp:67-80``, ``linear_gaussian_1d``):
x_0 ~ N(0, 1), x_t ~ N(x_{t-1}, 1), y_t ~ N(x_t, 1).

Both the trace form :func:`linear_gaussian_1d` (for SIS) and the
:class:`~cpprob_tpu_torch.inference.smc.StateSpaceModel` form, whose
``key`` arguments are ``torch.Generator`` objects on the device the
population lives on.  ``kalman_filter_1d`` is the exact
oracle, in numpy float64 (the port never imports JAX).

The d-dimensional model of the iterated auxiliary particle filter's
linear-Gaussian example (Guarniero, Johansen & Lee, JASA 2017,
arXiv:1511.06286): X_0 ~ N(0, I_d), X_t = A X_{t-1} + V_t, Y_t = X_t + W_t,
V_t, W_t ~ N(0, I_d), with A_ij = alpha^(|i-j|+1) there
(:func:`iapf_transition`).  :func:`linear_gaussian_nd_ssm` builds it for
any A on the user-physics kernel over d planes (K11 with d observation
planes: ``ops/fused_ssm.py`` ``attach_fused_vector_kernels``);
:func:`kalman_filter_nd` is its float64 oracle.
"""

from __future__ import annotations

import hashlib
import linecache
import math

import numpy as np
import torch

from ..core import as_tensor, observe, predict, sample
from ..distributions import Normal
from ..inference.smc import StateSpaceModel
from ..ops.population import takes_device_key

__all__ = ["linear_gaussian_1d", "linear_gaussian_ssm", "kalman_filter_1d",
           "obs_logpdf_elem", "simulate_observations", "trans_logpdf_elem",
           "iapf_transition", "linear_gaussian_nd_ssm", "nd_step_elem",
           "kalman_filter_nd", "simulate_observations_nd"]

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


# --------------------------------------------------------------------------
# the d-dimensional model (the iterated APF's linear-Gaussian example)


def iapf_transition(d: int, alpha: float = 0.42) -> np.ndarray:
    """The (d, d) float64 transition A_ij = alpha^(|i-j|+1) of the iterated
    APF's linear-Gaussian example (Guarniero, Johansen & Lee 2017)."""
    i = np.arange(d)
    return float(alpha) ** (np.abs(i[:, None] - i[None, :]) + 1.0)


def nd_step_elem(A):
    """The physics of the d-dimensional model as a ``step_elem`` over d
    state and d observation planes (``ops/render.py``'s contract; the
    arguments ``x_0..x_{d-1}, y_0..y_{d-1}, e_0..e_{d-1}``): n_i = sum_j
    A_ij x_j + e_i, summed in j's order, and the emission log N(y; n, I_d).
    Its source is generated for A, whose entries it captures as numbers
    (``a_i_j``), and registered with :mod:`linecache`, so that
    :class:`~cpprob_tpu_torch.ops.user_chunk.UserKernel` reads it as it
    reads a written ``def``."""
    A = np.asarray(A, np.float64)
    d = A.shape[0]
    if A.shape != (d, d) or d < 1:
        raise ValueError(f"A must be square, got {A.shape}")
    xs = [f"x_{j}" for j in range(d)]
    args = xs + [f"y_{k}" for k in range(d)] + [f"e_{i}" for i in range(d)]
    lines = [f"def step_elem({', '.join(args)}):"]
    for i in range(d):
        terms = " + ".join(f"a_{i}_{j} * x_{j}" for j in range(d))
        lines.append(f"    n_{i} = {terms} + e_{i}")
    for k in range(d):
        lines.append(f"    d_{k} = y_{k} - n_{k}")
    lines.append("    s = " + " + ".join(f"d_{k} * d_{k}" for k in range(d)))
    outs = ", ".join(f"n_{i}" for i in range(d))
    lines.append(f"    return {outs}, -0.5 * s - log_norm")
    src = "\n".join(lines) + "\n"
    consts = {f"a_{i}_{j}": float(A[i, j]) for i in range(d) for j in range(d)}
    consts["log_norm"] = d * _HALF_LOG_2PI
    digest = hashlib.sha256(repr((src, sorted(consts.items()))).encode()).hexdigest()
    name = f"<linear_gaussian_nd step_elem {digest[:16]}>"
    linecache.cache[name] = (len(src), None, src.splitlines(True), name)
    namespace = dict(consts)
    exec(compile(src, name, "exec"), namespace)
    return namespace["step_elem"]


def linear_gaussian_nd_ssm(A):
    """The d-dimensional linear-Gaussian model X_0 ~ N(0, I_d), X_t = A
    X_{t-1} + V_t, Y_t = X_t + W_t (V_t, W_t ~ N(0, I_d)) for a (d, d) ``A``,
    with (n, d) float32 states, (T, d) observations and the user-physics
    kernel over d planes installed (``attach_fused_vector_kernels``: the
    chunk hook and the one-step launch with the resample control, so
    ``build_smc_run(model, n, chunk=1)`` takes the per-step path keyed and a
    card captures its query).  The start is the prior's, from the sweep's
    generator (its hooks ``takes_device_key``).  A runs in float32 on the
    card, as each entry's float32 literal in the kernel."""
    from ..ops.fused_ssm import attach_fused_vector_kernels

    A = np.asarray(A, np.float64)
    d = A.shape[0]
    step_elem = nd_step_elem(A)
    a_t = A.T.astype(np.float32)
    cache: dict = {}

    def at(device):
        device = torch.device(device)
        if device not in cache:
            cache[device] = torch.as_tensor(a_t, device=device)
        return cache[device]

    def normal_logpdf(x, mean):
        dx = x - mean
        return -0.5 * torch.sum(dx * dx, -1) - d * _HALF_LOG_2PI

    def step_sample(key, s, t):
        return s @ at(s.device) + _randn(key, s.shape)

    base = StateSpaceModel(
        init_sample=lambda key: _randn(key, (d,)),
        init_logpdf=lambda s: normal_logpdf(s, 0.0),
        step_sample=step_sample,
        step_logpdf=lambda ns, s, t: normal_logpdf(ns, s @ at(s.device)),
        obs_logpdf=lambda s, y, t: normal_logpdf(y, s),
        init_sample_batch=takes_device_key(lambda key, n: _randn(key, (n, d))),
        step_sample_batch=step_sample,
        obs_logpdf_batch=takes_device_key(lambda s, y, t: normal_logpdf(y, s)),
        obs_sample=lambda key, s, t: s + _randn(key, s.shape),
    )
    return attach_fused_vector_kernels(base, step_elem, d, d)


def kalman_filter_nd(observations, A):
    """Exact filtered means (T, d), covariances (T, d, d) and the
    log-evidence of :func:`linear_gaussian_nd_ssm`'s model on
    ``observations`` (T, d), host numpy in float64 (Cholesky solves)."""
    A = np.asarray(A, np.float64)
    ys = np.asarray(observations, np.float64)
    d = A.shape[0]
    eye = np.eye(d)
    m_pred, p_pred, ll = np.zeros(d), eye.copy(), 0.0
    ms, ps = [], []
    for y in ys:
        chol = np.linalg.cholesky(p_pred + eye)
        z = np.linalg.solve(chol, y - m_pred)
        w = np.linalg.solve(chol, p_pred)
        ll += (-0.5 * z @ z - np.log(np.diag(chol)).sum()
               - 0.5 * d * math.log(2.0 * math.pi))
        m, p = m_pred + w.T @ z, p_pred - w.T @ w
        ms.append(m)
        ps.append(p)
        m_pred, p_pred = A @ m, A @ p @ A.T + eye
    return np.asarray(ms), np.asarray(ps), float(ll)


def simulate_observations_nd(A, T: int = 16, seed: int = 0) -> np.ndarray:
    """(T, d) float32 observations drawn from :func:`linear_gaussian_nd_ssm`'s
    model with ``np.random.default_rng(seed)``."""
    A = np.asarray(A, np.float64)
    rng = np.random.default_rng(seed)
    x, obs = rng.standard_normal(A.shape[0]), []
    for t in range(T):
        if t:
            x = A @ x + rng.standard_normal(A.shape[0])
        obs.append(x + rng.standard_normal(A.shape[0]))
    return np.asarray(obs, np.float32)

"""Plain reference of ``iapf_lg10``: the d-dimensional linear-Gaussian
state-space model of the iterated auxiliary particle filter's example
(Guarniero, Johansen & Lee, JASA 2017, arXiv:1511.06286):

    X_0 ~ N(0, I_d),  X_t = A X_{t-1} + V_t,  Y_t = X_t + W_t,
    V_t, W_t ~ N(0, I_d),  A_ij = alpha^(|i-j|+1)

(the configuration's file gives d, the observation dimension and alpha;
B = C = D = I_d there).  NumPy and plain PyTorch only:

- :func:`simulate`: a pool of observation series (pool, T, d) drawn from
  the model;
- :func:`exact`: the Kalman filter in float64, batched over the pool with
  Cholesky solves: log p(y_{0:T-1}) and the filtering distribution N(m, P)
  of X_{T-1} of each series, given as the rows (m, P flattened) of a
  (pool, d + d^2) array;
- :func:`recursion`: the same filter with every operation in a given
  torch dtype (the control computes it in bfloat16), the Cholesky factor
  and its solves written with elementary operations (``torch.linalg`` has
  no bfloat16 Cholesky);
- :func:`summarize`, :func:`filter_error`: the weighted mean and the
  marginal variances of a final population, and their squared distance
  from the exact filter in units of the exact covariance.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# float32 products on the card in full float32, never TF32
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def transition(cfg) -> np.ndarray:
    """A (d, d) in float64: A_ij = alpha^(|i-j|+1)."""
    d = int(cfg["state_dim"])
    i = np.arange(d)
    return float(cfg["alpha"]) ** (np.abs(i[:, None] - i[None, :]) + 1.0)


def simulate(rng: np.random.Generator, pool: int, cfg) -> np.ndarray:
    """(pool, T, d) float32 observation series drawn from the model."""
    A = transition(cfg)
    d, T = A.shape[0], int(cfg["series_length"])
    x = rng.standard_normal((pool, d))
    ys = np.empty((pool, T, d))
    for t in range(T):
        if t:
            x = x @ A.T + rng.standard_normal((pool, d))
        ys[:, t] = x + rng.standard_normal((pool, d))
    return ys.astype(np.float32)


def exact(ys: np.ndarray, cfg):
    """The Kalman filter in float64 over every series of ``ys`` (P, T, d):
    (log-evidence (P,), the filtering mean and covariance of the last step
    as rows (m, P flattened) (P, d + d^2))."""
    A = transition(cfg)
    y = np.asarray(ys, np.float64)
    n, T, d = y.shape
    eye = np.eye(d)
    m_pred, p_pred = np.zeros((n, d)), np.broadcast_to(eye, (n, d, d)).copy()
    log_z = np.zeros(n)
    for t in range(T):
        chol = np.linalg.cholesky(p_pred + eye)
        z = np.linalg.solve(chol, (y[:, t] - m_pred)[..., None])[..., 0]
        w = np.linalg.solve(chol, p_pred)
        log_z += (-0.5 * np.sum(z * z, -1)
                  - np.sum(np.log(np.diagonal(chol, axis1=1, axis2=2)), -1)
                  - 0.5 * d * math.log(2.0 * math.pi))
        m = m_pred + np.einsum("nji,nj->ni", w, z)
        p = p_pred - np.einsum("nki,nkj->nij", w, w)
        m_pred, p_pred = m @ A.T, A @ p @ A.T + eye
    return log_z, np.concatenate([m, p.reshape(n, d * d)], 1)


def _cholesky(s: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a batch of (d, d) matrices, in their dtype,
    by the column recurrence."""
    d = s.shape[-1]
    cols = []
    for j in range(d):
        c = s[..., :, j]
        for k in range(j):
            c = c - cols[k] * cols[k][..., j:j + 1]
        c = c / torch.sqrt(c[..., j:j + 1])
        mask = (torch.arange(d, device=s.device) >= j).to(s.dtype)
        cols.append(c * mask)
    return torch.stack(cols, -1)


def _forward_solve(chol: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """L^-1 b for lower-triangular ``chol`` (n, d, d) and ``b`` (n, d, k),
    row by row, in their dtype."""
    rows = []
    for i in range(chol.shape[-1]):
        r = b[..., i, :]
        for k in range(i):
            r = r - chol[..., i, k:k + 1] * rows[k]
        rows.append(r / chol[..., i, i:i + 1])
    return torch.stack(rows, -2)


def recursion(ys: np.ndarray, cfg, dtype, device="cpu"):
    """:func:`exact`'s filter with every operation in ``dtype`` on
    ``device``; returns float64 numpy arrays as :func:`exact` does."""
    A = torch.as_tensor(transition(cfg), device=device).to(dtype)
    y = torch.as_tensor(np.asarray(ys, np.float64), device=device).to(dtype)
    n, T, d = y.shape
    eye = torch.eye(d, device=device, dtype=dtype)
    m_pred = torch.zeros((n, d), device=device, dtype=dtype)
    p_pred = eye.expand(n, d, d).clone()
    log_z = torch.zeros(n, device=device, dtype=dtype)
    half_log_2pi = torch.tensor(0.5 * math.log(2.0 * math.pi), device=device, dtype=dtype)
    for t in range(T):
        chol = _cholesky(p_pred + eye)
        z = _forward_solve(chol, (y[:, t] - m_pred)[..., None])[..., 0]
        w = _forward_solve(chol, p_pred)
        log_diag = torch.log(torch.diagonal(chol, dim1=1, dim2=2))
        log_z = log_z - 0.5 * torch.sum(z * z, -1) - torch.sum(log_diag, -1) - d * half_log_2pi
        m = m_pred + torch.einsum("nji,nj->ni", w, z)
        p = p_pred - torch.einsum("nki,nkj->nij", w, w)
        m_pred, p_pred = m @ A.T, A @ p @ A.T + eye
    filt = torch.cat([m, p.reshape(n, d * d)], 1)
    return log_z.double().cpu().numpy(), filt.double().cpu().numpy()


def summarize(final_states: torch.Tensor, final_log_weights: torch.Tensor, cfg):
    """The weighted mean and the marginal variances of a final population
    (n, d), as one (2d,) float64 tensor on the population's device."""
    lw = final_log_weights.double()
    w = torch.exp(lw - lw.max())
    w = w / w.sum()
    x = final_states.double()
    mean = w @ x
    return torch.cat([mean, w @ (x - mean) ** 2])


def filter_error(summary: np.ndarray, exact_filter: np.ndarray) -> float:
    """(mean - m)^T P^-1 (mean - m) + sum_i ((var_i - P_ii) / P_ii)^2: the
    gaps of a population's weighted mean and marginal variances from the
    exact filter N(m, P), in units of P.  ``summary`` is :func:`summarize`'s
    (mean, marginal variances), or a filter as :func:`exact` gives it (its
    covariance's diagonal the variances)."""
    f = np.asarray(exact_filter, np.float64)
    d = (math.isqrt(4 * f.size + 1) - 1) // 2      # f.size = d + d^2
    m, p = f[:d], f[d:].reshape(d, d)
    s = np.asarray(summary, np.float64)
    mean = s[:d]
    var = s[d:2 * d] if s.size == 2 * d else np.diag(s[d:].reshape(d, d))
    gap = mean - m
    pd = np.diag(p)
    return float(gap @ np.linalg.solve(p, gap) + np.sum(((var - pd) / pd) ** 2))

"""MCMC convergence diagnostics: split-R̂ and chain effective sample size
(Vehtari et al. 2021) — counterpart of ``cpprob_tpu/postprocess/diagnostics.py``.
"""

from __future__ import annotations

import torch

__all__ = ["split_rhat", "effective_sample_size", "summarize_chains"]


def _split(x):
    # (C, N, ...) -> (2C, N//2, ...)
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half : 2 * half]], 0)


def split_rhat(samples) -> torch.Tensor:
    """samples: (n_chains, n_samples, ...) -> R̂ per trailing dim."""
    x = _split(torch.as_tensor(samples).float())
    n = x.shape[1]
    chain_mean = torch.mean(x, 1)                       # (m, ...)
    chain_var = torch.var(x, 1, correction=1)           # (m, ...)
    w = torch.mean(chain_var, 0)
    b = n * torch.var(chain_mean, 0, correction=1)
    var_plus = (n - 1) / n * w + b / n
    return torch.sqrt(var_plus / torch.clamp(w, min=1e-12))


def effective_sample_size(samples, max_lag: int = 100) -> torch.Tensor:
    """Bulk ESS via autocorrelation (Geyer initial positive sequence,
    truncated at ``max_lag``).  samples: (n_chains, n_samples, ...)."""
    x = torch.as_tensor(samples).float()
    m, n = x.shape[0], x.shape[1]
    xc = x - torch.mean(x, 1, keepdim=True)
    var = torch.mean(torch.var(x, 1, correction=1), 0)

    max_lag = min(max_lag, n - 1)

    def rho_at(lag):
        prod = xc[:, : n - lag] * xc[:, lag:]
        return torch.mean(prod, (0, 1)) / torch.clamp(var, min=1e-12)

    rhos = torch.stack([rho_at(lag) for lag in range(1, max_lag + 1)])  # (L, ...)
    # Geyer: sum pairs while positive
    pairs = rhos[0::2][: max_lag // 2] + rhos[1::2][: max_lag // 2]
    positive = torch.cumprod((pairs > 0).to(rhos.dtype), 0)
    tau = 1.0 + 2.0 * torch.sum(pairs * positive, 0)
    return m * n / torch.clamp(tau, min=1.0 / (m * n))


def summarize_chains(samples) -> dict:
    """Mean, std, split-R̂, ESS for (n_chains, n_samples, ...) draws."""
    samples = torch.as_tensor(samples)
    return {
        "mean": torch.mean(samples, (0, 1)),
        "std": torch.std(samples, (0, 1), correction=0),
        "rhat": split_rhat(samples),
        "ess": effective_sample_size(samples),
    }

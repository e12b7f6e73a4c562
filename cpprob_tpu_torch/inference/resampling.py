"""Particle resampling — counterpart of ``cpprob_tpu/inference/resampling.py``
(discrete part, ``:37-215``).  Every function is O(N) tensor code with no
host synchronisation; ``key`` arguments are ``torch.Generator`` objects on
the population's device.

Slot arithmetic (``ceil(n * cdf - u0)``) runs in float64: in float32 it is
exact only up to n ~ 2^24, below the main path's 2^26 particles.
"""

from __future__ import annotations

import torch

__all__ = [
    "systematic_resample",
    "systematic_ancestors_from_cdf",
    "ess",
    "get_resampler",
    "category_weights",
    "category_counts_systematic",
    "states_from_counts",
    "exchange_resample_discrete",
]


def ess(log_weights: torch.Tensor) -> torch.Tensor:
    """Kish effective sample size 1/sum(w_i^2) of normalized weights."""
    lw = log_weights - torch.logsumexp(log_weights, 0)
    return torch.exp(-torch.logsumexp(2.0 * lw, 0))


def _normalized_cumsum(log_weights: torch.Tensor) -> torch.Tensor:
    w = torch.softmax(log_weights.double(), 0)
    c = torch.cumsum(w, 0)
    return c / c[-1]


def _uniform(key: torch.Generator, device) -> torch.Tensor:
    return torch.rand((), generator=key, device=device, dtype=torch.float64)


def systematic_ancestors_from_cdf(cdf: torch.Tensor, u0, n_out: int) -> torch.Tensor:
    """Ancestors for the systematic comb (u0 + j)/n_out against an inclusive
    normalized CDF, by scatter-max + cummax: particle i owns output slots
    [ceil(n*c_{i-1} - u0), ceil(n*c_i - u0)), so its index is scattered at
    its first slot and a running max fills the rest."""
    n = cdf.shape[0]
    cdf = cdf.double()
    prev = torch.cat([cdf.new_zeros(1), cdf[:-1]])
    starts = torch.clamp(torch.ceil(n_out * prev - u0), 0, n_out).long()
    idx = torch.arange(n, device=cdf.device)
    # one spare slot takes the starts that fall off the end
    slots = torch.zeros(n_out + 1, dtype=torch.int64, device=cdf.device)
    slots.scatter_reduce_(0, starts, idx, reduce="amax")
    return torch.cummax(slots[:n_out], 0).values.to(torch.int32)


def systematic_resample(key: torch.Generator, log_weights: torch.Tensor,
                        n_out: int | None = None) -> torch.Tensor:
    """Systematic resampling: one uniform, a comb of evenly spaced
    positions.  Returns int32 ancestor indices of shape (n_out,)."""
    n_out = log_weights.shape[0] if n_out is None else n_out
    u0 = _uniform(key, log_weights.device)
    return systematic_ancestors_from_cdf(
        _normalized_cumsum(log_weights), u0, n_out
    )


def category_weights(log_weights: torch.Tensor, states: torch.Tensor,
                     n_categories: int) -> torch.Tensor:
    """Normalized total weight per category: W_k = sum_i w_i [s_i = k]."""
    w = torch.softmax(log_weights, 0)
    onehot = (
        states[:, None] == torch.arange(n_categories, device=states.device,
                                        dtype=states.dtype)[None, :]
    ).to(w.dtype)
    return w @ onehot


def _category_ticks(u0, cat_weights: torch.Tensor, n_out: int) -> torch.Tensor:
    """Cumulative systematic category boundaries (K,) int64, the last = n."""
    b = torch.cumsum(cat_weights.double(), 0)
    b = b / b[-1]
    ticks = torch.clamp(torch.ceil(n_out * b - u0), 0, n_out)
    # the last boundary is n_out; set by a device fill (assigning a Python
    # number to an element copies it from the host and synchronises)
    ticks = torch.cat([ticks[:-1], torch.full_like(ticks[-1:], n_out)])
    return torch.cummax(ticks, 0).values.long()   # monotone under rounding


def category_counts_systematic(u0, cat_weights: torch.Tensor,
                               n_out: int) -> torch.Tensor:
    """Exact systematic offspring counts per category under the
    sorted-by-state particle ordering.  Returns int32 (K,) counts summing
    to ``n_out``."""
    ticks = _category_ticks(u0, cat_weights, n_out)
    prev = torch.cat([ticks.new_zeros(1), ticks[:-1]])
    return (ticks - prev).to(torch.int32)


def states_from_counts(counts: torch.Tensor, n_out: int,
                       dtype=torch.int32) -> torch.Tensor:
    """Materialize the sorted resampled population: counts[0] copies of 0,
    counts[1] copies of 1, ..."""
    ticks = torch.cumsum(counts.long(), 0)
    j = torch.arange(n_out, device=counts.device)
    return (j[:, None] >= ticks[None, :]).sum(1).to(dtype)


def exchange_resample_discrete(key: torch.Generator, log_weights: torch.Tensor,
                               states: torch.Tensor, n_categories: int,
                               n_out: int | None = None) -> torch.Tensor:
    """Systematic resampling of a discrete-state population under the
    sorted-by-state exchangeable ordering; returns the new (sorted) states
    directly — no ancestors, no gather."""
    n_out = log_weights.shape[0] if n_out is None else n_out
    u0 = _uniform(key, log_weights.device)
    cat_w = category_weights(log_weights, states, n_categories)
    counts = category_counts_systematic(u0, cat_w, n_out)
    return states_from_counts(counts, n_out, dtype=states.dtype)


_RESAMPLERS = {"systematic": systematic_resample}


def get_resampler(name: str):
    try:
        return _RESAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown resampler {name!r}; choose from {sorted(_RESAMPLERS)}"
        ) from None

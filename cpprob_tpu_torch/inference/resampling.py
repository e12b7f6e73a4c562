"""Particle resampling — counterpart of ``cpprob_tpu/inference/resampling.py``.
Every function is
tensor code with no host synchronisation; ``key`` arguments are
``torch.Generator`` objects on the population's device.

Slot arithmetic (``ceil(n * cdf - u0)``) runs in float64: in float32 it is
exact only up to n ~ 2^24, below the main path's 2^26 particles.
"""

from __future__ import annotations

import math

import torch

from ..ops import stream_resample as sr
from ..util.profiling import span

__all__ = [
    "systematic_resample",
    "stratified_resample",
    "multinomial_resample",
    "residual_resample",
    "systematic_ancestors_from_cdf",
    "ess",
    "get_resampler",
    "category_weights",
    "category_counts_systematic",
    "states_from_counts",
    "exchange_resample_discrete",
    "sorted_systematic_resample_values",
    "sorted_systematic_resample_values_nd",
    "morton_key",
    "continuous_resample_values",
    "continuous_resample_values_lme",
    "log_mean_exp_of_stats",
    "streams",
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


def _ancestors_from_positions(cdf: torch.Tensor,
                              positions: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF lookup of sorted or unsorted positions in [0, 1)."""
    idx = torch.searchsorted(cdf, positions, right=True)
    return torch.clamp(idx, 0, cdf.shape[0] - 1).to(torch.int32)


def _categorical(key: torch.Generator, weights: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """``n_out`` iid draws from the (unnormalized, non-negative) float64
    ``weights`` by inverse CDF."""
    c = torch.cumsum(weights, 0)
    u = torch.rand(n_out, generator=key, device=weights.device,
                   dtype=torch.float64)
    return _ancestors_from_positions(c / c[-1], u)


def stratified_resample(key: torch.Generator, log_weights: torch.Tensor,
                        n_out: int | None = None) -> torch.Tensor:
    """Stratified resampling: one uniform per stratum."""
    n_out = log_weights.shape[0] if n_out is None else n_out
    u = torch.rand(n_out, generator=key, device=log_weights.device,
                   dtype=torch.float64)
    positions = (u + torch.arange(n_out, device=u.device)) / n_out
    return _ancestors_from_positions(_normalized_cumsum(log_weights), positions)


def multinomial_resample(key: torch.Generator, log_weights: torch.Tensor,
                         n_out: int | None = None) -> torch.Tensor:
    """Multinomial resampling: ``n_out`` iid categorical draws."""
    n_out = log_weights.shape[0] if n_out is None else n_out
    return _categorical(key, torch.softmax(log_weights.double(), 0), n_out)


def residual_resample(key: torch.Generator, log_weights: torch.Tensor,
                      n_out: int | None = None) -> torch.Tensor:
    """Residual resampling, static-shape formulation: the first
    ``sum(floor(n_out w_i))`` slots hold the deterministic copies (slot j
    takes the particle where the cumulative copy count crosses j), the rest
    are drawn multinomially from the residual weights."""
    n = log_weights.shape[0]
    n_out = n if n_out is None else n_out
    w = torch.softmax(log_weights.double(), 0)
    counts = torch.floor(n_out * w)
    slots = torch.arange(n_out, device=w.device)
    det_idx = torch.clamp(
        torch.searchsorted(torch.cumsum(counts, 0), slots.double(), right=True),
        0, n - 1).to(torch.int32)
    resid_idx = _categorical(key, torch.clamp(n_out * w - counts, min=1e-38),
                             n_out)
    return torch.where(slots < counts.sum(), det_idx, resid_idx)


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


def sorted_systematic_resample_values(key: torch.Generator,
                                      log_weights: torch.Tensor,
                                      states: torch.Tensor,
                                      n_out: int | None = None) -> torch.Tensor:
    """Systematic resampling of a scalar continuous population under the
    sorted-by-value exchangeable ordering; returns the new (sorted) values,
    no genealogy.  Each value is scattered at its first output slot
    ``ceil(n * cdf_{i-1} - u0)`` (float64 slot arithmetic) by a max, and a
    running max fills the rest — right because the values ascend."""
    n_out = log_weights.shape[0] if n_out is None else n_out
    sorted_s, order = torch.sort(states)
    cdf = _normalized_cumsum(log_weights[order])
    u0 = _uniform(key, log_weights.device)
    prev = torch.cat([cdf.new_zeros(1), cdf[:-1]])
    starts = torch.clamp(torch.ceil(n_out * prev - u0), 0, n_out).long()
    # one spare slot takes the starts that fall off the end
    fill = torch.full((n_out + 1,), -torch.inf, dtype=sorted_s.dtype,
                      device=sorted_s.device)
    fill.scatter_reduce_(0, starts, sorted_s, reduce="amax")
    return torch.cummax(fill[:n_out], 0).values


def sorted_systematic_resample_values_nd(key: torch.Generator,
                                         log_weights: torch.Tensor,
                                         states: torch.Tensor,
                                         sort_key=None) -> torch.Tensor:
    """Systematic resampling of a vector continuous (n, D) population under
    a sorted-by-key exchangeable ordering; returns the new population, no
    genealogy.  The key is the first coordinate by default, or
    ``sort_key(states)`` (e.g. :func:`morton_key`).  Ancestors of the sorted
    population come from the monotone scatter-max + cummax of
    :func:`systematic_ancestors_from_cdf` (float64 slot arithmetic) and are
    applied with one gather."""
    n = log_weights.shape[0]
    keys_v = states[:, 0] if sort_key is None else sort_key(states)
    order = torch.argsort(keys_v, stable=True)
    cdf = _normalized_cumsum(log_weights[order])
    anc = systematic_ancestors_from_cdf(cdf, _uniform(key, log_weights.device), n)
    return states[order[anc.long()]]


def morton_key(states: torch.Tensor, bits: int = 10) -> torch.Tensor:
    """Z-order (Morton) sort key (n,) int64 for (n, D) states, D <= 3: each
    coordinate rank-normalised to ``bits``-bit integers (stable ranks) and
    the bits interleaved.  Equal, element for element, to the reference's
    uint32 key."""
    n, d = states.shape
    if d > 3:
        raise ValueError(f"morton_key supports D <= 3, got {d}")
    ranks = torch.argsort(torch.argsort(states, dim=0, stable=True), dim=0,
                          stable=True)
    q = ranks * ((1 << bits) - 1) // max(n - 1, 1)
    keyv = torch.zeros(n, dtype=torch.int64, device=states.device)
    for j in range(d):
        spread = torch.zeros(n, dtype=torch.int64, device=states.device)
        for b in range(bits):
            spread = spread | (((q[:, j] >> b) & 1) << (b * d))
        keyv = keyv | (spread << j)
    return keyv & 0xFFFFFFFF


def continuous_resample_values(key: torch.Generator, log_weights: torch.Tensor,
                               states: torch.Tensor, *, flag=None):
    """Systematic resample of a scalar or vector continuous population,
    returning the new values directly (no genealogy).  (n, D) states take
    the sorted-key vector epoch; float32 (n,) states the streaming epoch
    (:mod:`cpprob_tpu_torch.ops.stream_resample`: its kernels on CUDA
    tensors, their plain versions on CPU tensors); other scalar states the
    sorted fill.  ``flag``: an int32 device scalar; where it is 0 the
    population comes back unchanged."""
    return continuous_resample_values_lme(key, log_weights, states,
                                          flag=flag)[0]


def streams(states: torch.Tensor) -> bool:
    """Whether ``states`` take the streaming epoch: float32 (n,) values of
    a population size it takes."""
    return (states.dim() == 1 and states.dtype == torch.float32
            and sr.streaming_available(states.shape[0]))


def log_mean_exp_of_stats(stats: torch.Tensor, n: int) -> torch.Tensor:
    """The log-mean-exp of ``n`` weights from their
    :func:`~cpprob_tpu_torch.ops.stream_resample.logsumexp_stats` (float64)."""
    return stats[0] + torch.log(stats[1]) - math.log(n)


def continuous_resample_values_lme(key: torch.Generator,
                                   log_weights: torch.Tensor,
                                   states: torch.Tensor, *, flag=None):
    """Like :func:`continuous_resample_values`, and also the log-mean-exp
    of the weights (the evidence increment, float64).  On the streaming
    path one :func:`~cpprob_tpu_torch.ops.stream_resample.logsumexp_stats`
    sweep serves both pass 1 and the increment.  Both branches lie in the
    span ``resample.epoch`` of a recording profiler."""
    n = log_weights.shape[0]
    with span("resample.epoch"):
        if streams(states):
            stats = sr.logsumexp_stats(log_weights, flag)
            new_states = sr.streaming_systematic_resample_values(
                key, log_weights, states, stats=stats, flag=flag)
            return new_states, log_mean_exp_of_stats(stats, n)
        lme = torch.logsumexp(log_weights.double(), 0) - math.log(n)
        if states.dim() == 2:
            new_states = sorted_systematic_resample_values_nd(key, log_weights, states)
        else:
            new_states = sorted_systematic_resample_values(key, log_weights, states)
        if flag is not None:
            new_states = torch.where(flag.reshape(()) != 0, new_states, states)
        return new_states, lme


_RESAMPLERS = {
    "systematic": systematic_resample,
    "stratified": stratified_resample,
    "multinomial": multinomial_resample,
    "residual": residual_resample,
}


def get_resampler(name: str):
    try:
        return _RESAMPLERS[name]
    except KeyError:
        raise ValueError(
            f"unknown resampler {name!r}; choose from {sorted(_RESAMPLERS)}"
        ) from None

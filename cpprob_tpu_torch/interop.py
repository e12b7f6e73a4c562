"""Carry state across from the JAX package as numpy arrays.

Tests hand both packages the same inputs through these functions: HMM
tables become the fused kernels' :class:`~cpprob_tpu_torch.ops.fused_hmm.HMMSpec`,
and a population or a chunk-glue carry taken from ``cpprob_tpu`` (converted
with ``np.asarray``) becomes the port's tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.fused_hmm import HMMSpec

__all__ = ["spec_from_numpy", "population_from_numpy", "carry_from_numpy"]


def spec_from_numpy(trans, means, stds, init_probs) -> HMMSpec:
    """K-state Gaussian-emission HMM (transition matrix (K, K), emission
    means and stds (K,), initial-state probabilities (K,)) as the kernels'
    float32 tables; cumulative sums are taken in float64."""
    trans = np.asarray(trans, np.float64)
    stds = np.asarray(stds, np.float64)
    k = trans.shape[0]
    if trans.shape != (k, k):
        raise ValueError(f"trans must be square, got {trans.shape}")
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return HMMSpec(
        trans_cdf=f32(np.cumsum(trans, axis=1)[:, :-1]),
        means=f32(np.asarray(means, np.float64).reshape(k)),
        half_inv_var=f32(0.5 / stds ** 2),
        log_norm=f32(-np.log(stds) - 0.5 * math.log(2.0 * math.pi)),
        init_cdf=f32(np.cumsum(np.asarray(init_probs, np.float64))[:-1]),
    )


def population_from_numpy(states, log_w, device="cpu"):
    """(states (N,), log_w float32 (N,)) tensors on ``device``: integer
    (discrete) states become int32, floating (continuous) states float32."""
    states = np.asarray(states)
    dtype = np.float32 if np.issubdtype(states.dtype, np.floating) else np.int32
    return (
        torch.as_tensor(states.astype(dtype), device=device),
        torch.as_tensor(np.asarray(log_w, np.float32), device=device),
    )


def carry_from_numpy(seed: int, states, log_w, log_z, ess, cat_w, lme,
                     device="cpu"):
    """The chunked exchange glue's carry ``(key, states, log_w, log_z, ess,
    cat_w, lme)``; the key is ``(seed, generator)``, the generator on
    ``device`` seeded with ``seed`` (it draws the boundary offsets u0)."""
    states, log_w = population_from_numpy(states, log_w, device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return ((int(seed), gen), states, log_w, f64(log_z), f64(ess), f64(cat_w),
            f64(lme))

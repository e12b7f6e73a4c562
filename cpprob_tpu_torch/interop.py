"""Carry state across from the JAX package as numpy arrays.

Tests hand both packages the same inputs through these functions: HMM
tables become the fused kernels' :class:`~cpprob_tpu_torch.ops.fused_hmm.HMMSpec`,
a population or a chunk-glue carry taken from ``cpprob_tpu`` (converted
with ``np.asarray``) becomes the port's tensors, and a proposal net of
``cpprob_tpu.inference.nn`` or a CSIS parameter tree becomes the port's
(same layout), and an ``SVIResult``'s parameters or an ``smc2`` θ
population the port's result types.
Tensors go to the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ops.fused_hmm import MAX_K, HMMSpec
from .util.pytree import tree_map

__all__ = ["spec_from_numpy", "population_from_numpy", "carry_from_numpy",
           "mlp_params_from_numpy", "csis_params_from_numpy", "svi_result_from_numpy",
           "theta_from_numpy"]


def _f32(a, device):
    return torch.as_tensor(np.array(a, np.float32), device=device)


def spec_from_numpy(trans, means, stds, init_probs) -> HMMSpec:
    """K-state Gaussian-emission HMM (transition matrix (K, K), emission
    means and stds (K,), initial-state probabilities (K,)) as the kernels'
    float32 tables; cumulative sums are taken in float64.  Raises
    ``ValueError`` as the reference's builder does
    (``cpprob_tpu/ops/pallas_ssm.py:493-513``): a matrix that is not square,
    rows that do not sum to 1, K above :data:`~.ops.fused_hmm.MAX_K`, stds
    that are not positive."""
    trans = np.asarray(trans, np.float64)
    k = trans.shape[0]
    if trans.ndim != 2 or trans.shape != (k, k):
        raise ValueError(f"transition matrix must be square, got {trans.shape}")
    if not np.allclose(trans.sum(axis=1), 1.0, atol=1e-6):
        raise ValueError("transition rows must sum to 1")
    if k > MAX_K:
        raise ValueError(f"K={k}: the fused kernels take K <= {MAX_K} states")
    stds = np.asarray(stds, np.float64).reshape(k)
    if np.any(stds <= 0):
        raise ValueError("emission stds must be positive")
    f32 = lambda a: np.ascontiguousarray(a, np.float32)
    return HMMSpec(
        trans_cdf=f32(np.cumsum(trans, axis=1)[:, :-1]),
        means=f32(np.asarray(means, np.float64).reshape(k)),
        half_inv_var=f32(0.5 / stds ** 2),
        log_norm=f32(-np.log(stds) - 0.5 * math.log(2.0 * math.pi)),
        init_cdf=f32(np.cumsum(np.asarray(init_probs, np.float64).reshape(k))[:-1]),
    )


def population_from_numpy(states, log_w, device="cuda"):
    """(states (N,) or (N, D), log_w float32 (N,)) tensors on ``device``:
    integer (discrete) states become int32, floating (continuous) states
    float32, (N, D) vector states stay (N, D), contiguous."""
    states = np.asarray(states)
    dtype = np.float32 if np.issubdtype(states.dtype, np.floating) else np.int32
    return (
        torch.as_tensor(states.astype(dtype), device=device),
        torch.as_tensor(np.asarray(log_w, np.float32), device=device),
    )


def carry_from_numpy(seed: int, states, log_w, log_z, ess, cat_w, lme,
                     device="cuda"):
    """The chunked exchange glue's carry ``(key, states, log_w, log_z, ess,
    cat_w, lme)``; the key is ``(seed, generator)``, the generator on
    ``device`` seeded with ``seed`` (it draws the boundary offsets u0)."""
    states, log_w = population_from_numpy(states, log_w, device)
    f64 = lambda a: torch.as_tensor(np.asarray(a, np.float64), device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return ((int(seed), gen), states, log_w, f64(log_z), f64(ess), f64(cat_w),
            f64(lme))


def mlp_params_from_numpy(params, device="cuda"):
    """An MLP's layers ``[{"w": (in, out), "b": (out,)}, ...]`` (each leaf
    anything ``np.asarray`` takes, e.g. a JAX array) as the port's float32
    tensors on ``device``, in the layout of
    :func:`cpprob_tpu_torch.inference.nn.mlp_init`."""
    return [{k: torch.as_tensor(np.array(layer[k], np.float32), device=device)
             for k in ("w", "b")} for layer in params]


def csis_params_from_numpy(params, device="cuda"):
    """The JAX package's CSIS parameter tree (dicts and lists of leaves
    anything ``np.asarray`` takes: ``obs_net``, ``lstm``, ``value_emb``,
    ``heads``) as the port's: the same tree of float32 tensors on
    ``device``, which :class:`cpprob_tpu_torch.inference.csis.CSIS` takes as
    its ``params``.  The weights carry across as they are (the LSTM's gate
    layout and +1 forget bias are the reference's)."""
    return tree_map(lambda a: _f32(a, device), params)


def svi_result_from_numpy(loc, log_scale, flat, scale_tril=None, device="cuda"):
    """An ``SVIResult`` of the port on the JAX package's variational
    parameters (``loc``, ``log_scale`` and, for the full-rank guide,
    ``scale_tril``: anything ``np.asarray`` takes) and the port's
    ``FlatModel`` of the same model; no losses."""
    from .inference.svi import SVIResult

    return SVIResult(_f32(loc, device), _f32(log_scale, device),
                     torch.zeros((0,), device=device), flat,
                     None if scale_tril is None else _f32(scale_tril, device))


def theta_from_numpy(tree, device="cuda"):
    """A θ pytree (dicts and lists of leaves anything ``np.asarray`` takes,
    e.g. an ``smc2`` population's ``thetas``) as float32 tensors on
    ``device``, in the same tree."""
    return tree_map(lambda a: _f32(a, device), tree)

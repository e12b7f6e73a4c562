"""Kernel-from-spec fused SMC models — counterpart of
``cpprob_tpu/ops/pallas_ssm.py`` (its discrete, scalar, vector and guided
families).

- :func:`make_fused_discrete_ssm`: any K-state HMM with Gaussian emissions
  (1 <= K <= 32) as a complete :class:`StateSpaceModel`: batched torch
  hooks plus the fused kernels of :mod:`.fused_hmm` (K9 init, K8 chunk with
  exchange resampling and optional island checks, and the per-step hooks
  as one-step launches of K8).  The reference's polynomial table lookups
  and 16-bit uniforms are TPU workarounds; the port's kernels read exact
  tables and draw 24-bit Philox uniforms (``block_r`` and ``interpret``
  are TPU parameters and are not carried over).
- :func:`attach_fused_scalar_kernels` / :func:`attach_fused_vector_kernels`:
  a continuous-state model's physics as an elementwise ``step_elem``,
  rendered to CUDA C++ in the chunk kernel of :mod:`.user_chunk` (K10,
  K11); :mod:`.render` sets out the contract ``step_elem`` keeps.
- :func:`attach_fused_guided_scalar_kernels`: a scalar model with a
  ``kind="normal"`` proposal net (trained by
  :func:`~cpprob_tpu_torch.inference.smc_csis.train_ssm_proposal`) fused
  into a guided chunk kernel: by default (``mxu=True``) K12's tensor-core
  twin (:class:`.guided_tc.GuidedTensorCoreKernel`, CUDA), else K12 on the
  FMA pipe (:class:`.guided_scalar.GuidedScalarKernel`, CUDA).
- :func:`attach_fused_guided_discrete_kernels`: a K-state HMM (2 <= K <= 8)
  with a ``kind="discrete"`` proposal net fused into the CUDA chunk kernel
  K13 (:func:`.fused_hmm.guided_chunk`), which builds the proposal's K x K
  tables once per step and moves the particles as K8 does.
- Both guided builders also serve the same net through the engine's
  unfused guided step (``proposal_sample`` / ``proposal_logpdf``, with the
  one q of the port: ``softplus(raw) + 1e-6``) and set
  ``fused_hooks_guided``, so the fused paths stay open to the guided
  kernels and to them only.
- :func:`discrete_hmm_log_evidence`, :func:`discrete_hmm_smoothed_marginals`:
  the exact numpy oracles (the port never imports JAX).

``key`` arguments of the batched hooks are ``torch.Generator`` objects on
the population's device; the fused hooks take the sweep's integer seed.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..inference.smc import StateSpaceModel, _with_kernels
from ..inference.smc_csis import proposal_hooks
from .fused_hmm import GUIDED_MAX_K, fused_hmm_hooks, guided_hooks
from .guided_scalar import GuidedScalarKernel, check_scalar_net
from .guided_tc import GuidedTensorCoreKernel
from .population import _ess_chunk_hook
from .user_chunk import UserKernel

__all__ = [
    "make_fused_discrete_ssm",
    "attach_fused_scalar_kernels",
    "attach_fused_vector_kernels",
    "attach_fused_guided_scalar_kernels",
    "attach_fused_guided_discrete_kernels",
    "discrete_hmm_log_evidence",
    "discrete_hmm_smoothed_marginals",
]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def make_fused_discrete_ssm(trans, means, stds=None, init_probs=None, *,
                            island_every: int = 0, island_thresh: float = 0.5,
                            island_counts: list | None = None):
    """A :class:`StateSpaceModel` for the K-state HMM ``z_t ~ trans[z_{t-1}]``,
    ``y_t ~ N(means[z_t], stds[z_t])`` (stds default to 1, the initial
    distribution to uniform), with the fused kernels installed:

    >>> ssm = make_fused_discrete_ssm(trans5, means5, stds5)
    >>> run = build_smc_run(ssm, 1 << 24, chunk=8)

    Raises ``ValueError`` on a matrix that is not square, rows that do not
    sum to 1, K > 32 or stds that are not positive.  ``island_every`` > 0
    adds the interior island checks of the chunk kernel, so whole-sweep
    fusion (``chunk=T``) keeps the adaptive trigger live;
    ``island_counts`` collects each chunk launch's interior resamples per
    island (see :func:`~.fused_hmm.fused_hmm_hooks`)."""
    from ..interop import spec_from_numpy

    trans = np.asarray(trans, np.float64)
    K = trans.shape[0]
    stds = np.ones(K) if stds is None else np.asarray(stds, np.float64)
    init_probs = (np.full(K, 1.0 / K) if init_probs is None
                  else np.asarray(init_probs, np.float64))
    spec = spec_from_numpy(trans, means, stds, init_probs)
    means = np.asarray(means, np.float64).reshape(K)
    stds = stds.reshape(K)
    host = {
        "means": means.astype(np.float32),
        "stds": stds.astype(np.float32),
        "log_init": np.log(np.maximum(init_probs.reshape(K), 1e-38)).astype(np.float32),
        "log_trans": np.log(np.maximum(trans, 1e-38)).astype(np.float32),
    }
    cache: dict = {}

    def tab(device):
        device = torch.device(device)
        if device not in cache:
            t = {k: torch.as_tensor(v, device=device) for k, v in host.items()}
            t.update({k: v for k, v in spec.tables(device).items()
                      if k in ("trans_cdf", "init_cdf")})
            cache[device] = t
        return cache[device]

    def draw(key, cdf, shape):
        # inverse CDF of each row of ``cdf`` (..., K-1)
        u = torch.rand(shape, generator=key, device=key.device)
        return (u[..., None] >= cdf).sum(-1).to(torch.int32)

    def obs_logpdf(s, y, t):
        tb = tab(s.device)
        s = s.long()
        z = (y - tb["means"][s]) / tb["stds"][s]
        return -0.5 * z * z - torch.log(tb["stds"][s]) - _HALF_LOG_2PI

    def init_sample_batch(key, n):
        return draw(key, tab(key.device)["init_cdf"], (n,))

    def step_sample_batch(key, states, t):
        return draw(key, tab(states.device)["trans_cdf"][states.long()],
                    states.shape).to(states.dtype)

    def obs_sample(key, s, t):
        tb = tab(s.device)
        eps = torch.randn(s.shape, generator=key, device=key.device)
        return tb["means"][s.long()] + tb["stds"][s.long()] * eps

    return StateSpaceModel(
        init_sample=lambda key: init_sample_batch(key, 1).reshape(()),
        init_logpdf=lambda s: tab(s.device)["log_init"][s.long()],
        step_sample=lambda key, s, t: step_sample_batch(key, s.reshape(1), t).reshape(()),
        # engine convention: step_logpdf(new_state, state, t)
        step_logpdf=lambda ns, s, t: tab(s.device)["log_trans"][s.long(), ns.long()],
        obs_logpdf=obs_logpdf,
        init_sample_batch=init_sample_batch,
        step_sample_batch=step_sample_batch,
        obs_logpdf_batch=obs_logpdf,
        obs_sample=obs_sample,
        state_categories=K,
        **fused_hmm_hooks(spec, island_every, island_thresh, island_counts),
    )


def attach_fused_scalar_kernels(base_model, step_elem):
    """``base_model`` (scalar continuous states) with the user-physics chunk
    kernel (K10) installed as the time-aware chunk hook
    ``fused_chunk_t_batch`` and, launched for one step, as
    ``fused_step_batch``.  ``step_elem(x, y, eps) -> (x', log_emission)``
    keeps the contract of :mod:`.render`; a function outside it raises
    ``ValueError`` here.  The linear-Gaussian model is the instance

    >>> def lg_step_elem(x, y, eps):
    ...     nx = x + eps
    ...     d = y - nx
    ...     return nx, -0.5 * d * d - half_log_2pi
    >>> lg = attach_fused_scalar_kernels(linear_gaussian_ssm, lg_step_elem)
    """
    kernel = UserKernel(step_elem, 1)

    def fused_step(key, states, log_w, y, t):
        x, w, _ = kernel.chunk(key, states, log_w, y.reshape(1), t0=int(t),
                               step=True)
        return x, w

    return _with_kernels(base_model, fused_chunk_t_batch=_ess_chunk_hook(kernel.chunk),
                         fused_step_batch=fused_step)


def attach_fused_vector_kernels(base_model, step_elem, state_dim: int):
    """``base_model`` with (n, D) states, ``D = state_dim``, with the
    user-physics chunk kernel over D planes (K11) installed as
    ``fused_chunk_t_batch`` and ``vector_state_dim`` set.
    ``step_elem(x_0, .., x_{D-1}, y, eps_0, .., eps_{D-1}) -> (x'_0, ..,
    x'_{D-1}, log_emission)`` keeps the contract of :mod:`.render`.
    Chunk-boundary resampling takes the sorted-key vector epoch
    (:func:`~cpprob_tpu_torch.inference.resampling.sorted_systematic_resample_values_nd`)."""
    D = int(state_dim)
    kernel = UserKernel(step_elem, D)
    return _with_kernels(base_model, fused_chunk_t_batch=_ess_chunk_hook(kernel.chunk),
                         vector_state_dim=D)


def attach_fused_guided_scalar_kernels(base_model, params, T: int, *,
                                       trans_logpdf_elem, obs_logpdf_elem,
                                       mxu: bool = True):
    """``base_model`` (scalar continuous states) guided by ``params``, a
    ``kind="normal"`` proposal net (features ``[z_prev, y, t/T]``, outputs
    ``(mean, raw)``), with a guided chunk kernel installed as the
    time-aware chunk hook ``fused_chunk_t_batch``:

    >>> lg = attach_fused_guided_scalar_kernels(
    ...     linear_gaussian_ssm, params, 16,
    ...     trans_logpdf_elem=trans_lp, obs_logpdf_elem=obs_lp)
    >>> run = build_smc_run(lg, 1 << 24, chunk=8)

    ``mxu=True`` (the default, as the reference's) installs the tensor-core
    twin (:class:`.guided_tc.GuidedTensorCoreKernel`: the net's hidden
    layers on ``mma.sync`` in 3xTF32, CUDA built at the first launch) for a
    net with at least one hidden layer, in its narrow layout for hidden
    widths up to 32 and in its wide one up to
    :func:`.guided_tc.guided_tc_max_width` (64, the width
    ``train_ssm_proposal`` gives by default); ``mxu=False``, or a linear ``[3,
    2]`` head, installs K12 with the net on the FMA pipe
    (:class:`.guided_scalar.GuidedScalarKernel`: the weights baked into a
    CUDA source built at the first launch).  Both compute the plain
    version's function, K12 to within a float64 double rounding of its
    multiply-adds, the twin to within float32-level rounding of the net;
    on CPU tensors both run it.  The hook carries its kernel object as
    ``fused_chunk_t_batch.kernel``; with the twin it takes the sweep's seed
    as a device key too (``takes_device_key``), with K12 as an integer
    only.

    ``trans_logpdf_elem(x, nx, t)`` and ``obs_logpdf_elem(nx, y, t)`` are the
    model's densities as elementwise functions under the contract of
    :mod:`.render`.  A net of another shape or a density outside the
    contract raises ``ValueError`` here, as does, with ``mxu=True``, a
    hidden layer wider than :func:`.guided_tc.guided_tc_max_width` (64; the
    message names ``mxu=False``, which takes any width).  The same net serves the
    engine's unfused guided step (``proposal_sample`` / ``proposal_logpdf``:
    chunk 1 and runs with history), so the guide is never dropped; the
    in-kernel weights carry the exact RN correction, so the evidence
    estimator is that of the unguided kernel."""
    if mxu and len(check_scalar_net(params)[0]) >= 2:
        kernel = GuidedTensorCoreKernel(params, trans_logpdf_elem,
                                        obs_logpdf_elem, T)
    else:
        kernel = GuidedScalarKernel(params, trans_logpdf_elem, obs_logpdf_elem, T)

    fused_chunk = _ess_chunk_hook(kernel.chunk, device_key=isinstance(
        kernel, GuidedTensorCoreKernel))
    fused_chunk.kernel = kernel

    sample, logpdf = proposal_hooks(params, T, kind="normal")
    return _with_kernels(base_model, proposal_sample=sample, proposal_logpdf=logpdf,
                         fused_chunk_t_batch=fused_chunk, fused_hooks_guided=True)


def attach_fused_guided_discrete_kernels(trans, means, stds=None,
                                         init_probs=None, *, params, T: int,
                                         island_every: int = 0,
                                         island_thresh: float = 0.5,
                                         island_counts: list | None = None):
    """A guided K-state HMM (``z_t ~ trans[z_{t-1}]``, ``y_t ~
    N(means[z_t], stds[z_t])``, 1 <= K <= 8) whose categorical proposal, a
    net trained with ``kind="discrete"`` (features ``[onehot(z_prev), y,
    t/T]``, K logits), runs inside the fused chunk kernel K13:

    >>> g5 = attach_fused_guided_discrete_kernels(
    ...     trans5, means5, stds5, init5, params=params, T=16)
    >>> run = build_smc_run(g5, 1 << 24, chunk=8)

    Hooks: the time-aware chunk hook ``fused_chunk_exchange_t_batch`` and
    the per-step hooks ``fused_step_exchange_batch`` /
    ``fused_step_ess_batch``, one-step launches of K13 (exchange
    resampling stays in the kernel as in K8); the unguided fused init (K9)
    draws the prior population, as in the reference; ``proposal_sample`` /
    ``proposal_logpdf`` serve the same net through the engine's unfused
    guided step.  ``island_every`` / ``island_thresh`` / ``island_counts``:
    the interior island checks, as in :func:`make_fused_discrete_ssm`.
    At K = 1 the proposal is q = 1 and the chunk hook launches the
    unguided chunk kernel (:func:`~.fused_hmm.guided_chunk`).  Raises
    ``ValueError`` for K outside 1..8, a net of another shape, or one beyond
    the kernel's limits (``GUIDED_MAX_LAYERS`` layers; layers as wide as
    :func:`~.fused_hmm.guided_max_width` allows)."""
    trans = np.asarray(trans, np.float64)
    K = trans.shape[0]
    if not 1 <= K <= GUIDED_MAX_K:
        raise ValueError(f"guided discrete kernels support 1 <= K <= "
                         f"{GUIDED_MAX_K}, got {K}")
    from ..interop import spec_from_numpy

    stds = np.ones(K) if stds is None else np.asarray(stds, np.float64)
    init_probs = (np.full(K, 1.0 / K) if init_probs is None
                  else np.asarray(init_probs, np.float64))
    base = make_fused_discrete_ssm(trans, means, stds, init_probs)
    hooks = guided_hooks(spec_from_numpy(trans, means, stds, init_probs),
                         np.log(np.maximum(trans, 1e-38)), params, T,
                         island_every, island_thresh, island_counts)
    sample, logpdf = proposal_hooks(params, T, kind="discrete", n_states=K)
    return dataclasses.replace(
        base,
        proposal_sample=sample,
        proposal_logpdf=logpdf,
        fused_step_batch=None,
        fused_hooks_guided=True,
        **hooks,
    )


# --------------------------------------------------------------------------
# oracles (copied from cpprob_tpu/ops/pallas_ssm.py:1755-1799)


def discrete_hmm_log_evidence(trans, means, stds, init_probs, observations):
    """Exact log p(y_{1:T}) for a K-state Gaussian-emission HMM via the
    forward recursion (float64, host numpy)."""
    trans = np.asarray(trans, np.float64)
    means = np.asarray(means, np.float64)
    stds = np.asarray(stds, np.float64)
    p = np.asarray(init_probs, np.float64)
    obs = np.asarray(observations, np.float64)
    log_z = 0.0
    for t, y in enumerate(obs):
        emis = np.exp(-0.5 * ((y - means) / stds) ** 2) / (
            stds * np.sqrt(2 * np.pi)
        )
        a = (p if t == 0 else alpha @ trans) * emis
        log_z += np.log(a.sum())
        alpha = a / a.sum()
    return float(log_z)


def discrete_hmm_smoothed_marginals(trans, means, stds, init_probs,
                                    observations):
    """Exact smoothed marginals p(z_t | y_{1:T}) (T, K) via forward-backward
    (float64, host numpy)."""
    trans = np.asarray(trans, np.float64)
    means = np.asarray(means, np.float64)
    stds = np.asarray(stds, np.float64)
    p0 = np.asarray(init_probs, np.float64)
    obs = np.asarray(observations, np.float64)
    T, K = obs.shape[0], trans.shape[0]
    emis = np.exp(-0.5 * ((obs[:, None] - means[None, :]) / stds) ** 2) / (
        stds * np.sqrt(2 * np.pi)
    )
    alphas = np.zeros((T, K))
    a = p0 * emis[0]
    alphas[0] = a / a.sum()
    for t in range(1, T):
        a = (alphas[t - 1] @ trans) * emis[t]
        alphas[t] = a / a.sum()
    betas = np.ones((T, K))
    for t in range(T - 2, -1, -1):
        b = trans @ (emis[t + 1] * betas[t + 1])
        betas[t] = b / b.sum()
    post = alphas * betas
    return post / post.sum(axis=1, keepdims=True)

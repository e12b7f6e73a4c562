"""Mesh-sharded SMC — counterpart of ``cpprob_tpu/parallel/smc.py``.

Every rank runs this function with the same arguments on its own device;
each holds ``N / k`` particles, and the global ESS, evidence and
resampling ride the collectives of :mod:`._collectives`.  The reference's
``lax.scan`` over time is a Python loop, and its ``lax.cond`` around the
resample becomes, by scheme:

- ``collective`` and ``balanced`` move O(N/k) or O(bound) rows only in an
  epoch that fires, so the branch is taken on the host: one counted read
  of the globally reduced flag at each step or chunk boundary
  (``distributions.base.HOST_READS["smc_sharded"]``), and for
  ``balanced`` one more for its fit check in an epoch that fires.  Every
  rank reads the same flag, so every rank issues the same collectives.
- ``exchange`` and ``island`` cost scalar collectives and local work: they
  run at every boundary and are selected by the device flag, as the
  single-device glue does, and read nothing.

Draws.  Rank r's initial draws and per-step moves come from generators on
its device seeded from (seed, tag, r); a chunk kernel's seed is derived
from (seed, tag, r) and the kernel keeps taking the absolute ``t0``, so the
time stays in the Philox counter as on one device (the reference's
``fold_in(fold_in(fold_in(key, 2_000_000), t0), my)``); a chunk hook
without time takes ``chunk_seed`` of that seed and ``t0``.  The resample
uniform ``u0`` comes from a generator seeded alike on every rank and stays
on the device.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from ..distributions.base import host_any
from ..inference.smc import (
    StateSpaceModel,
    _chunk_observations,
    chunk_hook,
    _obs_logpdf,
    _per_particle,
)
from ..util.pytree import tree_flatten, tree_unflatten
from ..util.seeds import derive_seed
from ._collectives import all_gather, axis_index, axis_size
from .mesh import particle_mesh
from .resampling import (
    _weighted_mean,
    balanced_systematic_resample,
    global_ess,
    global_log_mean_exp,
    local_systematic_ancestors,
    ring_systematic_resample,
)

__all__ = ["ShardedSMCResult", "smc_sharded"]

_INIT_TAG = 0
_U0_TAG = 1_000_007
_MOVE_TAG = 2_000_000
_SCHEMES = ("collective", "balanced", "island", "exchange")


class ShardedSMCResult(NamedTuple):
    final_states: torch.Tensor       # (N / k, ...) this rank's shard
    final_log_weights: torch.Tensor  # (N / k,) this rank's shard
    log_evidence: torch.Tensor       # scalar, float64 (replicated)
    ess_history: torch.Tensor        # (steps,) global ESS before each step or chunk
    resampled: torch.Tensor          # (steps,) bool (replicated)
    tracked: Optional[torch.Tensor]  # (T - 1, ...) weighted means of track_fn, or None


def _select(flag: torch.Tensor, new, old):
    """``torch.where(flag, new, old)`` over a tree of (n, ...) tensors."""
    leaves_new, treedef = tree_flatten(new)
    leaves_old = tree_flatten(old)[0]
    return tree_unflatten(treedef, [
        torch.where(flag.reshape((1,) * a.dim()), a, b)
        for a, b in zip(leaves_new, leaves_old)])


def _gather_rows(states, idx: torch.Tensor):
    leaves, treedef = tree_flatten(states)
    return tree_unflatten(treedef, [x[idx] for x in leaves])


def smc_sharded(
    model: StateSpaceModel,
    observations: torch.Tensor,
    n_particles: int,
    key: int,
    *,
    mesh=None,
    ess_threshold: float = 0.5,
    scheme: str = "collective",
    track_fn: Optional[Callable] = None,
    balance_bound: Optional[int] = None,
    chunk: int = 1,
) -> ShardedSMCResult:
    """SMC with the particle axis sharded over ``mesh`` (default:
    ``particle_mesh()`` on the observations' device type).  Every rank
    calls it with the same arguments; ``observations`` (T,) lie on this
    rank's device, ``key`` is an integer seed.

    ``scheme``: ``"collective"`` (exact global systematic resampling, the
    ring of :func:`~.resampling.ring_systematic_resample`),
    ``"balanced"`` (exact, O(``balance_bound``) rows a rank, the ring as
    fallback), ``"island"`` (shard-local resampling, island weights
    carried in the particle weights), ``"exchange"`` (discrete states,
    ``model.state_categories``: a ``psum`` of K category weights, and
    each rank fills its slice of the sorted global population).

    ``chunk`` > 1 (a model with a ``fused_chunk_t_batch`` or
    ``fused_chunk_batch`` kernel hook, ``track_fn=None``): each rank runs
    ``chunk`` timesteps a kernel launch, and the global ESS check and the
    resample move to chunk boundaries.  ``scheme="exchange"`` with ``chunk`` > 1 raises: the
    reference quietly runs island resampling there (fault F11)."""
    if mesh is None:
        mesh = particle_mesh(device=observations.device.type)
    k = axis_size(mesh)
    if n_particles % k != 0:
        raise ValueError(f"n_particles must divide by mesh size {k}")
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown scheme {scheme!r}")
    if scheme == "exchange" and model.state_categories is None:
        raise ValueError("scheme='exchange' needs a discrete state space "
                         "(model.state_categories)")
    if observations.device.type != mesh.device_type:
        raise ValueError(f"observations on {observations.device}, mesh ranks on "
                         f"{mesh.device_type}")
    if chunk > 1:
        if model.fused_chunk_batch is None and model.fused_chunk_t_batch is None:
            raise ValueError("chunk > 1 needs a fused_chunk_batch/fused_chunk_t_batch "
                             "kernel on the model")
        if track_fn is not None:
            raise ValueError("chunk > 1 does not support track_fn")
        if scheme == "exchange":
            raise ValueError("scheme='exchange' runs per step (chunk=1): the chunk "
                             "kernels resample continuous states at chunk boundaries")
    return _Sweep(model, observations, n_particles, int(key), mesh, ess_threshold,
                  scheme, balance_bound).run(chunk, track_fn)


class _Sweep:
    """One sharded sweep's state: the rank's generators, the resample
    epoch of its scheme, and the two loops (per step, chunked)."""

    def __init__(self, model, observations, n_particles, seed, mesh, ess_threshold,
                 scheme, balance_bound):
        self.model, self.obs, self.n = model, observations, n_particles
        self.mesh, self.scheme, self.bound = mesh, scheme, balance_bound
        self.threshold = ess_threshold * n_particles
        self.my, self.k = axis_index(mesh), axis_size(mesh)
        self.n_local = n_particles // self.k
        self.device = observations.device

        def gen(*words):
            g = torch.Generator(device=self.device)
            g.manual_seed(derive_seed(seed, *words))
            return g

        self.g_init = gen(_INIT_TAG, self.my)
        self.g_move = gen(_MOVE_TAG, self.my)
        self.g_u0 = gen(_U0_TAG)                        # the same on every rank
        self.hook_seed = derive_seed(seed, _MOVE_TAG, self.my)

    def _init(self):
        model, n = self.model, self.n_local
        if model.init_sample_batch is not None:
            states = model.init_sample_batch(self.g_init, n)
        else:
            dummy = torch.empty(n, device=self.device)
            states = _per_particle(lambda g, _: model.init_sample(g), self.g_init, dummy)
        return states, _obs_logpdf(model, states, self.obs[0], 0)

    def _resample(self, states, log_w, log_z):
        """The boundary: the global ESS, the decision, and the epoch of the
        scheme.  Returns (states, log_w, log_z, ess, flag)."""
        mesh = self.mesh
        ess = global_ess(log_w, mesh)
        flag = ess < self.threshold
        u0 = torch.rand((), generator=self.g_u0, device=self.device, dtype=torch.float64)
        if self.scheme in ("collective", "balanced"):
            # the ESS is the same on every rank, bit for bit, so is the flag
            if host_any(flag, "smc_sharded"):
                if self.scheme == "collective":
                    states = ring_systematic_resample(u0, log_w, states, mesh)
                else:
                    states = balanced_systematic_resample(u0, log_w, states, mesh,
                                                          bound=self.bound)
                log_z = log_z + global_log_mean_exp(log_w, mesh)
                log_w = torch.zeros_like(log_w)
            return states, log_w, log_z, ess, flag
        if self.scheme == "exchange":
            K = self.model.state_categories
            m = torch.max(log_w).double()
            onehot = (states[:, None] == torch.arange(K, dtype=states.dtype,
                                                      device=self.device)[None, :])
            # one all-gather of each shard's (maximum, K category sums)
            g = all_gather(torch.cat([m.reshape(1),
                                      torch.exp(log_w.double() - m) @ onehot.double()]),
                           mesh)                                 # (k, K + 1)
            gm = torch.max(g[:, 0])
            cat_w = torch.sum(g[:, 1:] * torch.exp(g[:, :1] - gm), 0)   # (K,) global
            total = torch.sum(cat_w)
            ticks = torch.clamp(torch.ceil(self.n * (torch.cumsum(cat_w, 0) / total) - u0),
                                0, self.n)
            ticks = torch.cat([ticks[:-1], torch.full_like(ticks[-1:], self.n)])
            ticks = torch.cummax(ticks, 0).values.long()
            j = self.my * self.n_local + torch.arange(self.n_local, device=self.device)
            new_states = (j[:, None] >= ticks[None, :-1]).sum(1).to(states.dtype)
            lme = gm + torch.log(total) - math.log(self.n)
            return (torch.where(flag, new_states, states),
                    torch.where(flag, torch.zeros_like(log_w), log_w),
                    torch.where(flag, log_z + lme, log_z), ess, flag)
        # island: the shard resamples alone and carries its mean weight
        anc = local_systematic_ancestors(u0, log_w, mesh)
        m = torch.max(log_w).double()
        island_lw = (m + torch.log(torch.mean(torch.exp(log_w.double() - m)))).to(log_w.dtype)
        return (_select(flag, _gather_rows(states, anc.long()), states),
                torch.where(flag, island_lw.expand_as(log_w), log_w), log_z, ess, flag)

    def run(self, chunk: int, track_fn) -> ShardedSMCResult:
        model = self.model
        states, log_w = self._init()
        log_z = torch.zeros((), dtype=torch.float64, device=self.device)
        ess_h, res_h, tracked_h = [], [], []
        if chunk > 1:
            kernel = chunk_hook(model, exchange=False)
            ys_chunks, valid = _chunk_observations(self.obs, chunk)
            for c in range(ys_chunks.shape[0]):
                states, log_w, log_z, ess, flag = self._resample(states, log_w, log_z)
                states, log_w, _ = kernel(
                    self.hook_seed, states, log_w, ys_chunks[c], valid[c], 1 + chunk * c)
                ess_h.append(ess)
                res_h.append(flag)
        else:
            for t in range(1, self.obs.shape[0]):
                states, log_w, log_z, ess, flag = self._resample(states, log_w, log_z)
                if model.step_sample_batch is not None:
                    states = model.step_sample_batch(self.g_move, states, t)
                else:
                    states = _per_particle(lambda g, s: model.step_sample(g, s, t),
                                           self.g_move, states)
                log_w = log_w + _obs_logpdf(model, states, self.obs[t], t)
                if track_fn is not None:
                    vals = torch.func.vmap(track_fn)(states)
                    tracked_h.append(_weighted_mean(vals, log_w, self.mesh)[0])
                ess_h.append(ess)
                res_h.append(flag)
        log_z = log_z + global_log_mean_exp(log_w, self.mesh)
        stack = lambda xs, dtype: (torch.stack(xs) if xs
                                   else torch.zeros((0,), dtype=dtype, device=self.device))
        return ShardedSMCResult(
            states, log_w, log_z, stack(ess_h, torch.float64), stack(res_h, torch.bool),
            torch.stack(tracked_h) if track_fn is not None and tracked_h else None)

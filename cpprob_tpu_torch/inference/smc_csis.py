"""Guided SMC: learned per-step proposals for state-space models —
counterpart of ``cpprob_tpu/inference/smc_csis.py``.

A small MLP q(z_t | z_{t-1}, y_t) is trained by maximum likelihood on
prior rollouts of the model (z and y both simulated, amortised over y as
inference compilation is) and plugs into
:func:`cpprob_tpu_torch.inference.smc.smc` through the population-batched
``proposal_sample`` / ``proposal_logpdf`` hooks; the Radon-Nikodym
correction keeps the evidence estimator exact whatever the net's quality.
Two heads: ``kind="discrete"`` (categorical over ``n_states``, features
``[onehot(z_prev), y, t/T]``) and ``kind="normal"`` (mean and raw scale,
features ``[z_prev, y, t/T]``, scale ``softplus(raw) + 1e-6``, the one q of
the port: :func:`cpprob_tpu_torch.inference.nn.softplus`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import nn
from .smc import StateSpaceModel

__all__ = ["train_ssm_proposal", "guide_ssm", "proposal_site_nll",
           "proposal_features", "proposal_hooks"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _check_kind(kind: str, n_states: int):
    if kind == "discrete":
        if n_states < 1:
            raise ValueError("kind='discrete' needs n_states >= 1")
        return n_states + 2, n_states
    if kind == "normal":
        return 3, 2
    raise ValueError(f"unknown proposal kind {kind!r}")


def _plane(v, like: torch.Tensor) -> torch.Tensor:
    """``v`` (a tensor that broadcasts to ``like``, or a number) as a float32
    tensor of ``like``'s shape on its device."""
    if isinstance(v, torch.Tensor):
        return torch.broadcast_to(v.to(torch.float32), like.shape)
    return torch.full(like.shape, float(v), dtype=torch.float32,
                      device=like.device)


def proposal_features(kind: str, n_states: int, z_prev: torch.Tensor, y, t,
                      T: int) -> torch.Tensor:
    """The net's input ``[embed(z_prev), y, t/T]`` for a population
    ``z_prev`` (...,): (..., n_states + 2) one-hot features for
    ``kind="discrete"``, (..., 3) for ``"normal"``.  ``y`` and ``t``
    broadcast against ``z_prev`` (a number is filled on the device, never
    copied from the host); t/T is taken in float32."""
    if isinstance(t, torch.Tensor):
        tf = t.to(torch.float32) / T
    else:
        tf = float(np.float32(t) / np.float32(T))
    cols = [_plane(y, z_prev), _plane(tf, z_prev)]
    if kind == "discrete":
        # a compare against the state ids: unlike one_hot, it never checks
        # the states' range on the host
        ids = torch.arange(n_states, device=z_prev.device)
        onehot = (z_prev.long()[..., None] == ids).to(torch.float32)
        return torch.cat([onehot, torch.stack(cols, -1)], -1)
    return torch.stack([z_prev.to(torch.float32), *cols], -1)


def proposal_site_nll(params, z_prev, z_new, y, t, T: int, *, kind: str,
                      n_states: int = 0) -> torch.Tensor:
    """-log q(z_new | z_prev, y, t) at each site (the arguments broadcast
    to the sites' shape): the per-site loss of ``smc_csis.py:108-117``."""
    raw = nn.mlp_apply(params, proposal_features(kind, n_states, z_prev, y,
                                                 t, T))
    if kind == "discrete":
        logp = torch.log_softmax(raw, -1)
        return -torch.gather(logp, -1, z_new.long()[..., None])[..., 0]
    std = nn.softplus(raw[..., 1])
    d = (z_new.to(torch.float32) - raw[..., 0]) / std
    return 0.5 * d * d + torch.log(std) + _HALF_LOG_2PI


def train_ssm_proposal(model: StateSpaceModel, seed: int, T: int, *,
                       kind: str, n_states: int = 0, steps: int = 300,
                       batch_size: int = 256, learning_rate: float = 1e-3,
                       hidden: int = 64, device="cuda"):
    """Train q(z_t | z_{t-1}, y_t), a ``[in, hidden, hidden, out]`` MLP, to
    match p(z_t | z_{t-1}, y_t) ∝ p(z_t | z_{t-1}) p(y_t | z_t) by maximum
    likelihood on ``batch_size`` prior rollouts of length ``T`` per step
    (drawn with the model's ``init_sample_batch``, ``step_sample_batch``
    and ``obs_sample`` from a generator on ``device`` seeded with
    ``seed``), with ``torch.optim.Adam(lr=learning_rate)`` on ``device``.
    The initial net is drawn from a CPU generator seeded with ``seed``, so
    it is the same on every device.

    Returns ``(params, losses)``: the trained layers (detached tensors) and
    the (steps,) loss per step, the mean over the batch of the summed
    per-site NLL (:func:`proposal_site_nll`)."""
    in_dim, out_dim = _check_kind(kind, n_states)
    if model.obs_sample is None:
        raise ValueError("train_ssm_proposal needs model.obs_sample(key, states, t)")
    if model.init_sample_batch is None or model.step_sample_batch is None:
        raise ValueError("train_ssm_proposal needs the batched hooks "
                         "init_sample_batch and step_sample_batch")
    device = torch.device(device)
    net_gen = torch.Generator()
    net_gen.manual_seed(int(seed))
    params = nn.mlp_init([in_dim, hidden, hidden, out_dim], net_gen, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    leaves = [v.requires_grad_() for layer in params for v in layer.values()]
    opt = torch.optim.Adam(leaves, lr=learning_rate)
    ts = torch.arange(1, T, device=device)

    def rollouts():
        z = model.init_sample_batch(gen, batch_size)
        prev, new, ys = [], [], []
        for t in range(1, T):
            z_new = model.step_sample_batch(gen, z, t)
            prev.append(z)
            new.append(z_new)
            ys.append(model.obs_sample(gen, z_new, t))
            z = z_new
        return torch.stack(prev, 1), torch.stack(new, 1), torch.stack(ys, 1)

    losses = []
    for _ in range(steps):
        with torch.no_grad():
            z_prev, z_new, ys = rollouts()          # (B, T-1) each
        nll = proposal_site_nll(params, z_prev, z_new, ys, ts, T, kind=kind,
                                n_states=n_states)
        loss = nll.sum(1).mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    trained = [{k: v.detach() for k, v in layer.items()} for layer in params]
    return trained, torch.stack(losses)


def proposal_hooks(params, T: int, *, kind: str, n_states: int = 0):
    """The population-batched hooks ``(proposal_sample(key, z_prev, t, y),
    proposal_logpdf(z_new, z_prev, t, y))`` of a trained net; ``key`` is a
    ``torch.Generator`` on the population's device."""
    _check_kind(kind, n_states)

    def raw(z_prev, t, y):
        return nn.mlp_apply(params, proposal_features(kind, n_states, z_prev,
                                                      y, t, T))

    def proposal_sample(key, z_prev, t, y):
        r = raw(z_prev, t, y)
        if kind == "discrete":
            # inverse CDF of the categorical on one uniform per particle
            cdf = torch.cumsum(torch.softmax(r, -1), -1)[..., :-1]
            u = torch.rand(z_prev.shape, generator=key, device=z_prev.device)
            return (u[..., None] >= cdf).sum(-1).to(z_prev.dtype)
        eps = torch.randn(z_prev.shape, generator=key, device=z_prev.device)
        return r[..., 0] + nn.softplus(r[..., 1]) * eps

    def proposal_logpdf(z_new, z_prev, t, y):
        return -proposal_site_nll(params, z_prev, z_new, y, t, T, kind=kind,
                                  n_states=n_states)

    return proposal_sample, proposal_logpdf


def guide_ssm(model: StateSpaceModel, params, T: int, *, kind: str,
              n_states: int = 0) -> StateSpaceModel:
    """A copy of ``model`` with the trained proposal installed: SMC then
    runs in guided mode with exact RN weights.  As in the reference the
    batched move and fused step hooks are dropped; ``obs_logpdf_batch``
    stays, since the port's guided step scores the whole population with
    it (the reference falls back to a vmap of ``obs_logpdf``, the same
    density)."""
    sample, logpdf = proposal_hooks(params, T, kind=kind, n_states=n_states)
    return dataclasses.replace(
        model,
        proposal_sample=sample,
        proposal_logpdf=logpdf,
        step_sample_batch=None,
        fused_step_batch=None,
    )

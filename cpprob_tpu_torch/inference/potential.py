"""Potential-function construction — counterpart of
``cpprob_tpu/inference/potential.py``: model -> differentiable log-joint
over a flat unconstrained latent vector, the bridge from the trace
representation to the gradient-based engines (HMC/NUTS/SVI).

- Discovery (which sites are latent, their shapes and supports) runs the
  model once under a **CPU** generator whatever the engine's device, as
  CSIS's does: the structure is static, and reading it back from the card
  would sync.
- ``log_joint``, ``potential``, ``predict`` and ``initial_position`` run
  the model under a :class:`~cpprob_tpu_torch.core.handlers.Seed` whose
  generator is on the engine's ``device``, so the device rule puts every
  number of the model there (outside a ``Seed`` a distribution built from
  numbers goes to ``"cuda"``, whatever the caller asked for).
- Everything is written for one position; the engines run a population
  of positions under ``torch.func.vmap``, and its gradient under
  ``torch.func.grad``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from ..core import handlers
from ..distributions.base import map_params, to_device
from .sis import _generator, _nested
from .transforms import Transform, biject_for

__all__ = ["LatentSpec", "FlatModel", "flatten_model"]


@dataclasses.dataclass(frozen=True)
class LatentSpec:
    addr: str
    shape: Tuple[int, ...]
    size: int
    transform: Transform


@dataclasses.dataclass(frozen=True)
class FlatModel:
    """Differentiable view of a model's continuous latents.

    - ``dim``: total unconstrained dimension
    - ``log_joint(z)``: log p(x(z), obs) + log|dx/dz| for flat z (shape (dim,))
    - ``potential(z)`` = −log_joint(z)
    - ``constrain(z)``: flat z -> dict addr -> value on the support
    - ``predict(z, generator)``: run the model with latents fixed, collect predicts
    - ``initial_position(generator)``: unconstrained position of a prior draw
    - ``device``: where the model's numbers go while it runs
    """

    latents: Tuple[LatentSpec, ...]
    dim: int
    log_joint: Callable[[torch.Tensor], torch.Tensor]
    potential: Callable[[torch.Tensor], torch.Tensor]
    constrain: Callable[[torch.Tensor], Dict[str, torch.Tensor]]
    predict: Callable[[torch.Tensor, torch.Generator], Dict[str, torch.Tensor]]
    initial_position: Callable[[torch.Generator], torch.Tensor]
    device: torch.device


def engine_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a card that is not there raises
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the engine runs on a CUDA card by default and none is "
                           "available; pass device='cpu' to run on the CPU")
    return device


def unflatten(latents, z) -> Dict[str, torch.Tensor]:
    """Flat z -> dict addr -> unconstrained block of its shape."""
    out = {}
    i = 0
    for l in latents:
        out[l.addr] = z[i: i + l.size].reshape(l.shape)
        i += l.size
    return out


def constrain_with_jacobian(latents, z):
    """(dict addr -> value on the support, sum of log|dx/dz|) at flat z."""
    zs = unflatten(latents, z)
    values = {}
    jac = torch.zeros((), device=z.device)
    for l in latents:
        values[l.addr] = l.transform.forward(zs[l.addr])
        jac = jac + torch.sum(l.transform.log_det(zs[l.addr]))
    return values, jac


def flatten_model(model: Callable, args: Tuple, device="cuda") -> FlatModel:
    """Discover continuous latent sites (one prior run under a CPU
    generator), build the flat unconstrained log-joint on ``device``.
    Discrete or unsupported sample sites are rejected — marginalize them in
    the model (e.g. HMM forward algorithm) or use SIS/SMC instead."""
    device = engine_device(device)
    tr = handlers.TraceHandler()
    with _nested([handlers.Seed(_generator(0, "cpu")), tr]):
        model(*args)

    latents: List[LatentSpec] = []
    for name, site in tr.trace.items():
        if site["type"] != "sample" or site["is_observed"]:
            continue
        dist = site["dist"]
        if biject_for(dist) is None:
            raise ValueError(
                f"sample site {name!r} has discrete/unsupported support for "
                "gradient-based inference; marginalize it or use SIS/SMC"
            )
        # the transform's bounds on the engine's device
        t = biject_for(map_params(dist, lambda p: to_device(p, device)))
        shape = tuple(torch.as_tensor(site["value"]).shape)
        size = int(np.prod(shape)) if shape else 1
        latents.append(LatentSpec(name, shape, size, t))
    latents = tuple(latents)
    dim = sum(l.size for l in latents)
    # never drawn from: the sites are substituted, and observes do not draw;
    # it makes ``device`` the model's default device
    gen = torch.Generator(device=device)

    def constrain(z):
        zs = unflatten(latents, z)
        return {l.addr: l.transform.forward(zs[l.addr]) for l in latents}

    def log_joint(z):
        values, jac = constrain_with_jacobian(latents, z)
        lj = handlers.LogJoint()
        with _nested([handlers.Substitute(values), handlers.Seed(gen), lj]):
            model(*args)
        return lj.log_weight + jac

    def potential(z):
        return -log_joint(z)

    def predict(z, generator):
        values = constrain(z)
        pc = handlers.PredictCollector()
        with _nested([handlers.Substitute(values), handlers.Seed(generator), pc]):
            model(*args)
        return pc.stacked()

    def initial_position(generator):
        """Unconstrained position from a prior draw."""
        tr2 = handlers.TraceHandler()
        with _nested([handlers.Seed(generator), tr2]):
            model(*args)
        parts = []
        for l in latents:
            x = torch.as_tensor(tr2.trace[l.addr]["value"]).to(torch.float32)
            parts.append(torch.reshape(l.transform.inverse(x), (-1,)))
        return torch.cat(parts) if parts else torch.zeros((0,), device=generator.device)

    return FlatModel(latents, dim, log_joint, potential, constrain, predict,
                     initial_position, device)


def initial_positions(flat: FlatModel, generator: torch.Generator, n: int) -> torch.Tensor:
    """(n, dim) positions of n prior draws, each chain its own."""
    dummy = torch.empty(n, device=generator.device)
    return torch.func.vmap(lambda _: flat.initial_position(generator),
                           randomness="different")(dummy)


def batched_grad(fn: Callable) -> Callable:
    """``z (n, dim) -> (grad (n, dim), value (n,))`` of a scalar function of
    one position, over a population under ``torch.func.vmap``."""
    return torch.func.vmap(torch.func.grad_and_value(fn))

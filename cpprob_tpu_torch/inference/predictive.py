"""Prior- and posterior-predictive sampling — counterpart of
``cpprob_tpu/inference/predictive.py``.

Given posterior draws (from any engine), replay the model with the
latents substituted and **simulate** the observe sites to get predictive
replications.  Draws run under ``torch.func.vmap(...,
randomness="different")`` from one ``torch.Generator`` (``key``: a seed or
a generator); ``jit`` keeps its name and compiles nothing.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..core import handlers
from .potential import engine_device
from .sis import _generator, _nested

__all__ = ["posterior_predictive", "prior_predictive"]


def _observes(trace):
    return {name: site["value"] for name, site in trace.items()
            if site["type"] in ("observe", "metaobserve")}


def posterior_predictive(
    model: Callable,
    args: Tuple,
    samples: Dict[str, torch.Tensor],
    key,
    *,
    jit: bool = True,
):
    """Simulate observations under posterior latent draws.

    ``samples``: dict addr -> (n, ...) posterior values (e.g.
    ``HMCResult.samples`` reshaped to a flat draw axis, or
    ``SVIResult.sample(...)``); the replications run on their device.
    Returns ``(replicated_observes, predicts)``, each a dict of (n, ...)
    tensors.
    """
    gen = _generator(key, next(iter(samples.values())).device)

    def run(values):
        tr = handlers.TraceHandler()
        pc = handlers.PredictCollector()
        with _nested([handlers.Substitute(values), handlers.Seed(gen),
                      handlers.SimulateObserves(), tr, pc]):
            model(*args)
        return _observes(tr.trace), pc.stacked()

    return torch.func.vmap(run, randomness="different")(samples)


def prior_predictive(
    model: Callable,
    args: Tuple,
    n: int,
    key,
    *,
    jit: bool = True,
    device="cuda",
):
    """Simulate (latents, observations) from the prior — compile mode over
    ``n`` draws on ``device`` — returned as dicts of (n, ...) tensors."""
    gen = _generator(key, engine_device(device))

    def one(_):
        tr = handlers.TraceHandler()
        with _nested([handlers.Seed(gen), handlers.SimulateObserves(), tr]):
            model(*args)
        latents = {name: site["value"] for name, site in tr.trace.items()
                   if site["type"] == "sample" and not site["is_observed"]}
        return latents, _observes(tr.trace)

    return torch.func.vmap(one, randomness="different")(torch.empty(n, device=gen.device))

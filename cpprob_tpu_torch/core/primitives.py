"""The primitive statements — counterpart of ``cpprob_tpu/core/primitives.py``
(the reference's ``cpprob::sample`` / ``observe`` / ``predict`` /
``metaobserve``, ``include/cpprob/cpprob.hpp:28-114``, the
``rejection_sampling`` guard, ``cpprob.hpp:116-125``, and the bounded
rejection combinators).

Models are plain Python functions calling these primitives, written for
one particle; handled executions run under ``torch.func.vmap`` (see
:mod:`cpprob_tpu_torch.core.handlers`).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Optional

import torch

from ..distributions.base import host_any
from . import handlers
from .handlers import apply_stack, as_tensor, new_message

__all__ = [
    "sample",
    "observe",
    "predict",
    "factor",
    "metaobserve",
    "rejection_sampling",
    "rejection_sample",
    "guarded_rejection",
]


def sample(dist, *, addr: Optional[str] = None, control: bool = True, obs=None,
           postselect=None):
    """Draw a random value from ``dist`` at address ``addr``.

    ``control=False`` marks the site as not-to-be-guided (``cpprob.hpp:28-35``).
    ``obs`` conditions the site on a value.  ``postselect=(done, kept)``
    freezes the site at ``kept`` once the bool tensor ``done`` is set — used
    by :func:`guarded_rejection` to emulate rejection-loop exit.
    """
    if not handlers.current_stack():
        raise RuntimeError(
            "cpprob_tpu_torch.sample called outside any handler; wrap the model "
            "call in handlers.Seed(generator) or use an inference engine"
        )
    msg = new_message(
        "sample", addr, dist=dist, value=obs, control=control,
        is_observed=obs is not None, postselect=postselect,
    )
    return apply_stack(msg)["value"]


def observe(dist, value, *, addr: Optional[str] = None):
    """Condition on ``value`` under likelihood ``dist``: accumulates
    ``log_prob(value)`` into the execution's log-weight
    (``cpprob.hpp:79-90``).  In compile mode (``SimulateObserves``) the
    value is ignored and the observation simulated instead."""
    if not handlers.current_stack():
        return value
    msg = new_message("observe", addr, dist=dist, value=value, is_observed=True)
    return apply_stack(msg)["value"]


def predict(value, addr: Optional[str] = None):
    """Emit a posterior quantity of interest (``cpprob.hpp:92-106``)."""
    if not handlers.current_stack():
        return value
    msg = new_message("predict", addr, value=value)
    return apply_stack(msg)["value"]


def factor(log_factor, addr: Optional[str] = None):
    """Add an arbitrary term to the execution log-weight."""
    if not handlers.current_stack():
        return
    msg = new_message("factor", addr, value=as_tensor(log_factor))
    apply_stack(msg)


def metaobserve(dist, value, *, addr: Optional[str] = None):
    """Observe of a metaprior-drawn model argument (``cpprob.hpp:108-114``):
    simulated like an observe in compile mode, but contributes **nothing**
    to the inference log-weight."""
    if not handlers.current_stack():
        return value
    msg = new_message("metaobserve", addr, dist=dist, value=value, is_observed=True)
    return apply_stack(msg)["value"]


@contextlib.contextmanager
def rejection_sampling():
    """RAII-style guard: sample sites inside contribute only their *last*
    occurrence per address to the log-weight (``cpprob.hpp:116-125``,
    ``state.cpp:124-142,225-238``)."""
    with handlers.RejectionGuard():
        yield


def rejection_sample(
    generator: torch.Generator,
    propose: Callable[[torch.Generator], Any],
    accept: Callable[[Any, torch.Generator], torch.Tensor],
    max_iters: int = 10_000,
):
    """Bounded rejection sampler, the counterpart of the reference's
    ``lax.while_loop``: ``propose(generator) -> x`` draws a candidate,
    ``accept(x, generator) -> bool`` decides.  Returns ``(x, n_iters)``:
    the first accepted draw and the proposals it took (at most
    ``max_iters``; with none accepted, the last draw), per particle.  Runs
    outside the handler stack (its draws create no sites).

    Under ``torch.func.vmap`` every round proposes for the whole population
    and keeps the draws of the particles already accepted, so each particle
    sees the law of a loop of its own.  A round ends with one host read,
    whether any particle is still waiting (:func:`host_any`, counted in
    ``HOST_READS["rejection_sample"]``): the only synchronisation a model
    run makes, one a round."""
    x = propose(generator)
    done = torch.as_tensor(accept(x, generator))
    iters = torch.ones_like(done, dtype=torch.int32)
    rounds = 1
    while rounds < max_iters and host_any(~done, "rejection_sample"):
        x_new = propose(generator)
        ok = torch.as_tensor(accept(x_new, generator))
        x = torch.where(done, x, x_new)
        iters = torch.where(done, iters, iters + 1)
        done = done | ok
        rounds += 1
    return x, iters


def guarded_rejection(
    dist,
    accept: Callable[[Any], torch.Tensor],
    *,
    addr: str,
    max_iters: int = 16,
):
    """Rejection loop written with *addressed* guard sites (``models.hpp:82-112``
    + guard dedup ``state.cpp:124-142``).

    Each attempt samples at the SAME address ``addr`` inside a
    :func:`rejection_sampling` guard; once ``accept(x)`` fires, later
    attempts re-emit the accepted value (``postselect``), so the **last
    occurrence per address is the accepted draw**: ``TraceHandler`` keeps
    only it, and ``LogWeight`` only its Radon–Nikodym term.  ``accept`` must
    be deterministic given ``x``.  Returns ``(value, accepted_mask)``; with
    probability ``(1-p)^max_iters`` no draw is accepted and the final raw
    draw is returned with ``accepted_mask`` False.  A Python loop of
    ``max_iters`` attempts with no host read.
    """
    done = as_tensor(False)
    kept = None
    with rejection_sampling():
        for _ in range(max_iters):
            if kept is None:
                x = sample(dist, addr=addr)
                kept = x
            else:
                x = sample(dist, addr=addr, postselect=(done, kept))
            ok = torch.as_tensor(accept(x))
            kept = torch.where(done, kept, torch.where(ok, x, kept))
            done = torch.logical_or(done, ok)
    return torch.where(done, kept, x), done

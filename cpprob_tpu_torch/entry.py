"""The port's twin of ``__graft_entry__.entry()``: one guided-CSIS
importance-sampling sweep on the HMM (T = 8, 128 particles under
``torch.func.vmap``, the LSTM proposal network inside the particle
program), from the network of seed 0.

    fn, args = entry()
    log_w, states = fn(*args)      # (128,), (128, 8)
"""

from __future__ import annotations

import torch

from .inference.csis import CSIS
from .inference.sis import _generator, _vmapped, make_particle_fn
from .models import hmm

__all__ = ["entry"]

T = 8
N_PARTICLES = 128


def entry(device="cuda"):
    """``(fn, example_args)``: ``fn(seed) -> (log_w (128,), State (128,
    8))`` on ``device`` (default ``"cuda"``; with no card it raises)."""
    obs = torch.zeros((T,), device=device)
    engine = CSIS(hmm, (obs,), device=device)
    params = engine.init(0)
    factory = engine.proposal_factory(params, (obs,))
    particle = make_particle_fn(hmm, (obs,), proposal_messenger=factory)

    def fn(seed):
        with torch.no_grad():
            log_w, predicts = _vmapped(particle, _generator(seed, device), N_PARTICLES)
        return log_w, predicts["State"]

    return fn, (1,)

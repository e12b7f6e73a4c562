"""Derived seeds: the counterpart of the reference's chained ``fold_in``."""

from __future__ import annotations

import numpy as np


def derive_seed(*words: int) -> int:
    """A 63-bit seed that is a fixed function of ``words`` (the sweep's
    seed, a tag, a rank, ...): the counterpart of the reference's chained
    ``fold_in``.  Distinct words give unrelated seeds, so two ranks or two
    chunks never share a generator's or a kernel's Philox stream."""
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))

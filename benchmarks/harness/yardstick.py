"""The yardstick: published peaks of one NVIDIA H100 SXM and the work
counts of the port's kernels and sweeps.

The peaks and the counts ``bound``, ``chain_chunk_bound`` and
``normal_chunk_bound`` are a frozen copy of the
port's ``cpprob_tpu_torch/util/roofline.py`` as it stood when the
benchmark was defined, so that a change to the program cannot move the
yardstick it is measured with.  ``sweep_bound`` counts the work one query
needs, whatever implements it: the draws and the weight update of every
particle-step, the population written once and read once, and one read and
one write of it for each resample the query performed.
"""

from __future__ import annotations

# H100 SXM datasheet peaks (dense), at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TC_BF16_MACS_PER_S = 989e12 / 2
TC_TF32_MACS_PER_S = 495e12 / 2
# operations of one Philox4x32-10 call, of one Box-Muller pair, of one
# exp + log1p pair
PHILOX_OPS = 83
BOX_MULLER_OPS = 8
EXP_LOG_OPS = 4


def bound(n_bytes=0, f32_ops=0, *, f64_ops=0, tc_macs=0, philox_calls=0,
          normal_pairs=0, exp_log_pairs=0, tf32_macs=0):
    """The least time the card could take for this work, in ms, against
    the published peaks: the larger of the bytes over the HBM rate and the
    operations over the rate of their type.  Returns ``{"bound_ms",
    "bound_by"}``."""
    ops = (f32_ops + f64_ops + PHILOX_OPS * philox_calls
           + BOX_MULLER_OPS * normal_pairs + EXP_LOG_OPS * exp_log_pairs)
    ms_b = n_bytes / HBM_BYTES_PER_S * 1e3
    ms_o = max(ops / F32_OPS_PER_S, tc_macs / TC_BF16_MACS_PER_S,
               tf32_macs / TC_TF32_MACS_PER_S) * 1e3
    return {"bound_ms": max(ms_b, ms_o),
            "bound_by": "bytes" if ms_b >= ms_o else "operations"}


def chain_chunk_bound(n, K, steps, checks=0):
    """A K-state chunk launch: 16 B a particle (state and weight in and
    out); per particle-step a quarter of a Philox call, the inverse-CDF
    walk (2(K-1)) and the weight update (K); per particle and island check
    an exp and K + 3 sums."""
    return bound(16 * n + 4 * steps, n * steps * (3 * K - 2) + n * checks * (K + 4),
                 philox_calls=n * steps / 4)


def normal_chunk_bound(n, steps, D=1, physics_ops=6):
    """A chunk launch with Box-Muller draws: 8 (D + 1) B a particle; per
    particle-step and plane half a Box-Muller pair (and its Philox call),
    and the physics."""
    pairs = n * steps * D / 2
    return bound(8 * (D + 1) * n, n * steps * physics_ops,
                 philox_calls=pairs, normal_pairs=pairs)


def chain_step_work(K, first):
    """Work of one particle-step of a K-state chain, as the port's
    ``chain_init_bound`` (``first``: the inverse-CDF walk, the emission
    pick and the record's sums) and ``chain_chunk_bound`` count it: (f32
    operations, Philox calls, Box-Muller pairs)."""
    return (4 * K + 1 if first else 3 * K - 2), 0.25, 0.0


def normal_step_work(D=1, physics_ops=6):
    """Work of one particle-step of a model moved by Box-Muller draws, as
    ``normal_chunk_bound`` counts it."""
    return physics_ops, D / 2, D / 2


def sweep_bound(n, step_work, resamples, particle_bytes=8):
    """The bound of one query: ``n`` particles, ``step_work`` the (f32
    operations, Philox calls, Box-Muller pairs) of each particle-step of
    the series, in order; the population (``particle_bytes`` a particle,
    state and weight) written once and read once, and read and written once
    more for each of the ``resamples`` the query performed.  Launches,
    statistics records and the host's work are not charged: a query needs
    none of them."""
    ops = sum(w[0] for w in step_work)
    philox = sum(w[1] for w in step_work)
    pairs = sum(w[2] for w in step_work)
    return bound(2 * particle_bytes * n * (1 + resamples), n * ops,
                 philox_calls=n * philox, normal_pairs=n * pairs)

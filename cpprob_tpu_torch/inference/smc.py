"""Sequential Monte Carlo with ESS-triggered systematic resampling —
counterpart of ``cpprob_tpu/inference/smc.py``.

The reference's ``lax.scan`` over time is a Python loop here, and its
``lax.cond`` is a device-side ``torch.where``: a sweep queues its work
without ever waiting on the host.  Models enter through the same
:class:`StateSpaceModel` protocol, with population-batched hooks on
tensors.  ``key`` arguments of the model's sampling hooks are
``torch.Generator`` objects on the population's device; the fused kernel
hooks take the sweep's integer seed instead.

Ported so far: the HMM main path (the chunked exchange path with fused
init and chunk kernels), the continuous-state path (the chunked path with
a fused chunk kernel and the streaming resample epoch at chunk
boundaries, and the per-step path with a fused step kernel), and the
unfused paths with and without history that :func:`smc` and
:func:`build_smc_run` take otherwise.  Other combinations raise
``NotImplementedError``, naming the slice that brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch

from .resampling import _category_ticks
from .resampling import ess as _ess
from .resampling import (
    category_counts_systematic,
    category_weights,
    continuous_resample_values_lme,
    get_resampler,
    states_from_counts,
)

__all__ = ["StateSpaceModel", "SMCResult", "smc", "make_smc_step",
           "make_smc_step_exchange_fused_chunked", "make_smc_step_chunked",
           "build_smc_run"]


@dataclasses.dataclass(frozen=True)
class StateSpaceModel:
    """Sequential model protocol for SMC; field names and hook signatures
    as in ``cpprob_tpu.inference.smc.StateSpaceModel`` (see there for each
    hook's contract)."""

    init_sample: Callable
    init_logpdf: Callable
    step_sample: Callable
    step_logpdf: Callable
    obs_logpdf: Callable
    proposal_sample: Optional[Callable] = None
    proposal_logpdf: Optional[Callable] = None
    init_proposal_sample: Optional[Callable] = None
    init_proposal_logpdf: Optional[Callable] = None
    init_sample_batch: Optional[Callable] = None      # (key, n) -> (n, ...)
    step_sample_batch: Optional[Callable] = None      # (key, states, t) -> (n, ...)
    obs_logpdf_batch: Optional[Callable] = None       # (states, y, t) -> (n,)
    fused_step_batch: Optional[Callable] = None
    fused_step_ess_batch: Optional[Callable] = None
    fused_step_exchange_batch: Optional[Callable] = None
    # (key, states, log_w, ys, n_valid, flag, ticks) ->
    #     (s', w', ess', cat_w'(K,), lme'); kept for the protocol, not
    #     driven yet: the port's chunk kernels take the time-aware hook
    fused_chunk_exchange_batch: Optional[Callable] = None
    # same plus a trailing t0 (absolute time of the chunk's first update)
    fused_chunk_exchange_t_batch: Optional[Callable] = None
    # (key, states, log_w, ys, n_valid) -> (s', w', ess'); kept for the
    # protocol, not driven: the port's chunk kernels take the time-aware hook
    fused_chunk_batch: Optional[Callable] = None
    # same plus a trailing t0 (absolute time of the chunk's first update)
    fused_chunk_t_batch: Optional[Callable] = None
    # (key, n, y0) -> (states, log_w, ess, cat_w(K,), lme)
    fused_init_batch: Optional[Callable] = None
    obs_sample: Optional[Callable] = None
    state_categories: Optional[int] = None
    scalar_state: bool = False
    vector_state_dim: Optional[int] = None
    fused_hooks_guided: bool = False


class SMCResult(NamedTuple):
    """Filtering history + evidence estimate."""

    states: Optional[torch.Tensor]          # (T, N, ...) after propagation at each t
    log_weights: Optional[torch.Tensor]     # (T, N) unnormalized log-weights
    ancestors: Optional[torch.Tensor]       # (T, N) ancestors used at each t
    resampled: torch.Tensor                 # (T,) bool
    log_evidence: torch.Tensor              # scalar log Z estimate (float64)
    final_states: torch.Tensor              # (N, ...)
    final_log_weights: torch.Tensor         # (N,)

    def filtered_mean(self, fn=lambda s: s):
        """E[fn(z_t) | y_{1:t}] per timestep from the stored history."""
        vals = fn(self.states).to(self.log_weights.dtype)   # (T, N, ...)
        w = torch.softmax(self.log_weights, dim=1)
        w = w.reshape(w.shape + (1,) * (vals.dim() - 2))
        return torch.sum(w * vals, dim=1)


def _log_mean_exp(lw: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lw, 0) - math.log(lw.shape[0])


def _unported(what: str, slice_: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with {slice_}")


def make_smc_step(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
    resampler: Callable,
    store_history: bool = True,
    exchange: bool = False,
    sorted_fill: bool = False,
):
    """Build the loop body: (key, states, log_w, log_Z, ess), (y_t, t) ->
    (carry, ys), with ``key = (seed, generator)``.  Resampling first, on
    the carried ESS of the incoming weights, then propagation and
    reweighting.  Both resample outcomes are computed and one is selected
    on the device, so the step never waits on the host.
    ``exchange=True`` resamples a discrete population by category counts;
    ``sorted_fill=True`` a scalar continuous one by value
    (:func:`.resampling.continuous_resample_values_lme`, whose streaming
    epoch skips its work on the device when the step does not resample).
    A model's ``fused_step_batch`` kernel hook, which takes the sweep's
    integer seed and the absolute time, replaces the move and reweight."""
    if model.proposal_sample is not None:
        raise _unported("guided SMC", "slice 3 (guided SMC)")
    if model.fused_step_ess_batch is not None:
        raise _unported("the per-step fused kernel with statistics (K5)",
                        "slice 2 (the SMC kernel family)")
    if model.fused_step_batch is None and (
            model.step_sample_batch is None or model.obs_logpdf_batch is None):
        raise _unported("per-particle model hooks (vmap)",
                        "slice 4 (trace substrate)")

    def step(carry, y_t_and_t):
        y_t, t = y_t_and_t
        key, states, log_w, log_z, ess = carry
        seed, gen = key
        do_resample = ess < ess_threshold * n_particles
        ident = torch.arange(n_particles, dtype=torch.int32, device=states.device)

        if sorted_fill:
            res_states, lme = continuous_resample_values_lme(
                gen, log_w, states, flag=do_resample.to(torch.int32))
            res_anc = ident
        elif exchange:
            u0 = torch.rand((), generator=gen, device=states.device,
                            dtype=torch.float64)
            cat_w = category_weights(log_w, states, model.state_categories)
            counts = category_counts_systematic(u0, cat_w, n_particles)
            res_states = states_from_counts(counts, n_particles, dtype=states.dtype)
            res_anc, lme = ident, _log_mean_exp(log_w)
        else:
            res_anc = resampler(gen, log_w)
            res_states = states[res_anc.long()]
            lme = _log_mean_exp(log_w)
        states_r = torch.where(do_resample, res_states, states)
        log_w_r = torch.where(do_resample, torch.zeros_like(log_w), log_w)
        log_z_r = torch.where(do_resample, log_z + lme, log_z)
        anc = torch.where(do_resample, res_anc, ident)

        if model.fused_step_batch is not None:
            new_states, new_log_w = model.fused_step_batch(
                seed, states_r, log_w_r, y_t, t)
        else:
            new_states = model.step_sample_batch(gen, states_r, t)
            new_log_w = log_w_r + model.obs_logpdf_batch(new_states, y_t, t)
        new_ess = _ess(new_log_w)
        if store_history:
            ys = (new_states, new_log_w, anc, do_resample)
        else:
            ys = (do_resample,)
        return (key, new_states, new_log_w, log_z_r, new_ess), ys

    return step


def make_smc_step_exchange_fused_chunked(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
):
    """Loop body over observation chunks: one fused kernel launch per
    chunk, resampling decided at chunk boundaries from the previous
    launch's statistics.

    Carry: ``(key, states, log_w, log_z, ess, cat_w, lme)`` with ``key =
    (seed, generator)``; xs: ``(ys (C,), n_valid, t0)``.  The flag, the
    ticks and the evidence increment stay on the device.  The ticks are
    computed in float64 (exact at any population size a card holds).
    ``u0`` pins the boundary offset (tests); by default it is drawn from
    the carry's generator.  The model's chunk kernel is its time-aware
    ``fused_chunk_exchange_t_batch`` hook."""
    if model.fused_chunk_exchange_t_batch is None:
        raise _unported("a chunk kernel without absolute time "
                        "(fused_chunk_exchange_batch)",
                        "slice 2 (the SMC kernel family)")

    def step(carry, xs, u0=None):
        ys, n_valid, t0 = xs
        key, states, log_w, log_z, ess, cat_w, lme = carry
        seed, gen = key
        do_resample = ess < ess_threshold * n_particles
        if u0 is None:
            u0 = torch.rand((), generator=gen, device=states.device,
                            dtype=torch.float64)
        ticks = _category_ticks(u0, cat_w, n_particles)[:-1].to(torch.int32)
        log_z_r = log_z + torch.where(do_resample, lme, torch.zeros_like(lme))
        flag = do_resample.to(torch.int32)
        out = model.fused_chunk_exchange_t_batch(
            seed, states, log_w, ys, n_valid, flag, ticks, t0)
        new_states, new_log_w, new_ess, new_cat_w, new_lme = out
        return (
            (key, new_states, new_log_w, log_z_r, new_ess, new_cat_w, new_lme),
            (do_resample,),
        )

    return step


def make_smc_step_chunked(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
):
    """Loop body over observation chunks for scalar continuous states: a
    systematic resample epoch at the chunk boundary, then one fused kernel
    launch for the chunk's moves and reweights.

    Carry: ``(key, states, log_w, log_z, ess)`` with ``key = (seed,
    generator)``; xs: ``(ys (C,), n_valid, t0)``.  The resample decision
    stays on the device: it reaches the epoch's kernels as an int32 flag
    (with the flag off they do no work and return the population as it
    was), and the weights and the evidence are selected with
    ``torch.where``.  The model's chunk kernel is its time-aware
    ``fused_chunk_t_batch`` hook."""
    if model.fused_chunk_t_batch is None:
        raise _unported("a chunk kernel without absolute time "
                        "(fused_chunk_batch)", "slice 2 (the SMC kernel family)")

    def step(carry, xs):
        ys, n_valid, t0 = xs
        key, states, log_w, log_z, ess = carry
        seed, gen = key
        do_resample = ess < ess_threshold * n_particles
        states_r, lme = continuous_resample_values_lme(
            gen, log_w, states, flag=do_resample.to(torch.int32))
        log_w_r = torch.where(do_resample, torch.zeros_like(log_w), log_w)
        log_z_r = log_z + torch.where(do_resample, lme, torch.zeros_like(lme))
        new_states, new_log_w, new_ess = model.fused_chunk_t_batch(
            seed, states_r, log_w_r, ys, n_valid, t0)
        return (key, new_states, new_log_w, log_z_r, new_ess), (do_resample,)

    return step


def _chunk_observations(observations: torch.Tensor, chunk: int):
    """Pad the (T-1,) tail observations into (n_chunks, chunk) + valid
    counts (int32 device tensor), with no host copy."""
    ys = observations[1:]
    t_rest = ys.shape[0]
    n_chunks = -(-t_rest // chunk)
    ys = torch.nn.functional.pad(ys, (0, n_chunks * chunk - t_rest))
    starts = torch.arange(n_chunks, device=observations.device) * chunk
    valid = torch.clamp(t_rest - starts, 0, chunk).to(torch.int32)
    return ys.reshape(n_chunks, chunk), valid


def build_smc_run(
    model: StateSpaceModel,
    n_particles: int,
    *,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
    store_history: bool = False,
    chunk: int = 1,
):
    """Build ``run(key, observations) -> SMCResult`` once and reuse it.
    ``key`` is an integer seed; ``observations`` a (T,) float32 tensor on
    the device the sweep runs on.

    ``chunk`` > 1 (a model with a time-aware fused chunk kernel, no
    history, systematic resampling): that many timesteps per kernel
    launch, the ESS trigger evaluated at chunk boundaries (blocked adaptive
    resampling, an unbiased evidence estimator).  A discrete-state model
    resamples by exchange (``fused_chunk_exchange_t_batch``), a scalar
    continuous one by the streaming epoch (``fused_chunk_t_batch``)."""
    resampler = get_resampler(resampling)
    if model.proposal_sample is not None or model.fused_hooks_guided:
        raise _unported("guided SMC", "slice 3 (guided SMC)")
    if model.init_proposal_sample is not None:
        raise _unported("initial proposals", "slice 3 (guided SMC)")
    # the exchange and value-resampling fast paths are systematic schemes
    exchange_ok = (model.state_categories is not None and not store_history
                   and resampling == "systematic")
    sorted_ok = (
        (model.scalar_state or model.vector_state_dim is not None)
        and model.state_categories is None
        and not store_history
        and resampling == "systematic"
    )
    if sorted_ok and model.vector_state_dim is not None:
        raise _unported("vector-state continuous resampling",
                        "the vector kernel family (K11)")
    chunk_exchange = (
        chunk > 1
        and exchange_ok
        and (model.fused_chunk_exchange_batch is not None
             or model.fused_chunk_exchange_t_batch is not None)
    )
    chunk_sorted = (
        chunk > 1
        and sorted_ok
        and (model.fused_chunk_batch is not None
             or model.fused_chunk_t_batch is not None)
    )
    if chunk > 1 and not (chunk_exchange or chunk_sorted):
        raise ValueError(
            "chunk > 1 needs a fused_chunk_* kernel on the model and "
            "store_history=False with systematic resampling")
    if (not chunk_exchange and exchange_ok
            and model.fused_step_exchange_batch is not None):
        raise _unported("the per-step fused exchange kernel",
                        "slice 2 (the SMC kernel family)")
    if chunk_exchange:
        step = make_smc_step_exchange_fused_chunked(
            model, n_particles, ess_threshold)
    elif chunk_sorted:
        step = make_smc_step_chunked(model, n_particles, ess_threshold)
    else:
        step = make_smc_step(
            model, n_particles, ess_threshold, resampler, store_history,
            exchange=exchange_ok, sorted_fill=sorted_ok,
        )

    def run(key: int, observations: torch.Tensor) -> SMCResult:
        seed = int(key)
        device = observations.device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        n = n_particles
        if chunk_exchange and model.fused_init_batch is not None:
            states0, log_w0, ess0, cat_w0, lme0 = model.fused_init_batch(
                seed, n, observations[0])
        else:
            if model.init_sample_batch is None:
                raise _unported("per-particle model hooks (vmap)",
                                "slice 4 (trace substrate)")
            states0 = model.init_sample_batch(gen, n)
            log_w0 = model.obs_logpdf_batch(states0, observations[0], 0)
        log_z = torch.zeros((), dtype=torch.float64, device=device)
        no_resample = torch.zeros(1, dtype=torch.bool, device=device)

        if chunk_exchange or chunk_sorted:
            if chunk_sorted:
                carry = ((seed, gen), states0, log_w0, log_z, _ess(log_w0))
            else:
                if model.fused_init_batch is None:
                    ess0 = _ess(log_w0)
                    cat_w0 = category_weights(log_w0, states0,
                                              model.state_categories)
                    lme0 = _log_mean_exp(log_w0)
                carry = ((seed, gen), states0, log_w0, log_z, ess0, cat_w0, lme0)
            ys_chunks, valid = _chunk_observations(observations, chunk)
            flags = [no_resample]
            for c in range(ys_chunks.shape[0]):
                carry, (flag,) = step(
                    carry, (ys_chunks[c], valid[c], 1 + chunk * c))
                flags.append(flag.reshape(1))
            states_f, log_w_f, log_z = carry[1:4]
            # the exchange kernels carry the final log-mean-exp in their stats
            lme_f = carry[6] if chunk_exchange else _log_mean_exp(log_w_f)
            return SMCResult(None, None, None, torch.cat(flags),
                             log_z + lme_f, states_f, log_w_f)

        carry = ((seed, gen), states0, log_w0, log_z, _ess(log_w0))
        hist = []
        for t in range(1, observations.shape[0]):
            carry, ys = step(carry, (observations[t], t))
            hist.append(ys)
        _, states_f, log_w_f, log_z, _ = carry
        log_z = log_z + _log_mean_exp(log_w_f)
        resampled = torch.cat(
            [no_resample] + [h[-1].reshape(1) for h in hist])
        if store_history:
            ident = torch.arange(n, dtype=torch.int32, device=device)
            states = torch.stack([states0] + [h[0] for h in hist])
            log_ws = torch.stack([log_w0] + [h[1] for h in hist])
            anc = torch.stack([ident] + [h[2] for h in hist])
            return SMCResult(states, log_ws, anc, resampled, log_z,
                             states_f, log_w_f)
        return SMCResult(None, None, None, resampled, log_z, states_f, log_w_f)

    return run


def smc(
    model: StateSpaceModel,
    observations: torch.Tensor,
    n_particles: int,
    key: int,
    *,
    ess_threshold: float = 0.5,
    resampling: str = "systematic",
) -> SMCResult:
    """Run SMC over ``observations`` of shape (T,), keeping the history.

    Evidence: log Z = sum over resampling epochs of log-mean-exp of the
    accumulated weights (the standard unbiased SMC estimator)."""
    run = build_smc_run(
        model, n_particles, ess_threshold=ess_threshold, resampling=resampling,
        store_history=True,
    )
    return run(key, observations)

"""Sequential Monte Carlo with ESS-triggered systematic resampling —
counterpart of ``cpprob_tpu/inference/smc.py``.

The reference's ``lax.scan`` over time is a Python loop here, and its
``lax.cond`` is a device-side ``torch.where``: a sweep queues its work
without ever waiting on the host.  Models enter through the same
:class:`StateSpaceModel` protocol, with population-batched hooks on
tensors.  ``key`` arguments of the model's sampling hooks are
``torch.Generator`` objects on the population's device; the fused kernel
hooks take the sweep's integer seed instead, or, a hook that declares it
(``device_key``), the seed as a device key (``ops.philox.device_key``).

:func:`build_smc_run` takes one of five paths, chosen once per model and
options (``_sweep_path``): a fused chunk kernel with exchange or with
value resampling, a fused one-step launch with exchange or with the
resample flag, or the generic step (unfused, with history, or guided
through the model's proposal hooks and an initial proposal); a guided
model takes the fused paths through its guided kernels only.  The port's
proposal hooks are population-batched: ``proposal_sample(key, states, t,
y)``, ``proposal_logpdf(new, states, t, y)``, ``init_proposal_sample(key,
y0, n)``, ``init_proposal_logpdf(states, y0)``.  A model without the
batched hooks runs its per-particle hooks ``init_sample(key)``,
``step_sample(key, s, t)`` and ``obs_logpdf(s, y, t)`` under
``torch.func.vmap(..., randomness="different")`` over the population,
every particle drawing from the sweep's one generator (the reference's
``jax.vmap`` over split keys).

On a card, the query of a fast path whose seeded hooks all take a device
key is captured once as a CUDA graph and replayed (:func:`build_smc_run`):
the same kernels in the same order, with no host between them.
"""

from __future__ import annotations

import dataclasses
import math
import operator
from typing import Callable, NamedTuple, Optional

import torch

from ..ops import stream_resample as sr
from ..ops.philox import write_key
from ..ops.population import owned_scratch
from ..util.profiling import add_counts, counter_group, recorded_counts, span
from ..util.seeds import derive_seed
from .resampling import _category_ticks
from .resampling import ess as _ess
from .resampling import (
    category_counts_systematic,
    category_weights,
    continuous_resample_values_lme,
    get_resampler,
    log_mean_exp_of_stats,
    states_from_counts,
    streams,
)

__all__ = ["StateSpaceModel", "SMCResult", "smc", "make_smc_step",
           "make_smc_step_exchange_fused", "make_smc_step_ctrl_fused",
           "make_smc_step_exchange_fused_chunked", "make_smc_step_chunked",
           "build_smc_run", "final_log_mean_exp"]


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
    # population-batched: (key, states, t, y) -> (n, ...) and
    # (new_states, states, t, y) -> (n,)
    proposal_sample: Optional[Callable] = None
    proposal_logpdf: Optional[Callable] = None
    # (key, y0, n) -> (n, ...) and (states, y0) -> (n,)
    init_proposal_sample: Optional[Callable] = None
    init_proposal_logpdf: Optional[Callable] = None
    init_sample_batch: Optional[Callable] = None      # (key, n) -> (n, ...)
    step_sample_batch: Optional[Callable] = None      # (key, states, t) -> (n, ...)
    obs_logpdf_batch: Optional[Callable] = None       # (states, y, t) -> (n,)
    # (key, states, log_w, y, t) -> (s', w'), t the absolute step
    fused_step_batch: Optional[Callable] = None
    # same -> (s', w', ess')
    fused_step_ess_batch: Optional[Callable] = None
    # (key, states, log_w, y, t, flag, threshold) -> (s', w', flag'): the
    # one-step launch with the step's resample control, int32 flags on the
    # device; where ``flag`` is set the weights start from 0, and ``flag'``
    # is ESS(w') < threshold (a float64 ``ess_threshold * n``)
    fused_step_ctrl_batch: Optional[Callable] = None
    # (key, states, log_w, y, t, flag, ticks) -> (s', w', ess', cat_w', lme')
    fused_step_exchange_batch: Optional[Callable] = None
    # (key, states, log_w, ys, n_valid, flag, ticks) ->
    #     (s', w', ess', cat_w'(K,), lme'), ``key`` a seed a chunk
    #     (``chunk_seed``); the time-aware hook below takes precedence
    fused_chunk_exchange_batch: Optional[Callable] = None
    # same plus a trailing t0 (absolute time of the chunk's first update)
    fused_chunk_exchange_t_batch: Optional[Callable] = None
    # (key, states, log_w, ys, n_valid) -> (s', w', ess'), ``key`` a seed a
    # chunk (``chunk_seed``); the time-aware hook below takes precedence
    fused_chunk_batch: Optional[Callable] = None
    # same plus a trailing t0 (absolute time of the chunk's first update)
    fused_chunk_t_batch: Optional[Callable] = None
    # (key, n, y0) -> (states, log_w, ess, cat_w(K,), lme)
    fused_init_batch: Optional[Callable] = None
    # (key, n, y0, threshold) -> (states, log_w, ess, flag): the start of a
    # scalar sweep with its ESS (float64) and first resample flag (int32,
    # ess < threshold, a float64 ``ess_threshold * n``) on the device
    fused_init_ctrl_batch: Optional[Callable] = None
    obs_sample: Optional[Callable] = None
    state_categories: Optional[int] = None
    scalar_state: bool = False
    vector_state_dim: Optional[int] = None
    fused_hooks_guided: bool = False


# the hooks a kernel builder installs (``ops/``), each named here once
_KERNEL_HOOKS = ("fused_step_batch", "fused_step_ess_batch", "fused_step_ctrl_batch",
                 "fused_step_exchange_batch", "fused_chunk_exchange_batch",
                 "fused_chunk_exchange_t_batch", "fused_chunk_batch",
                 "fused_chunk_t_batch", "fused_init_batch", "fused_init_ctrl_batch")


def _with_kernels(model: StateSpaceModel, **fields) -> StateSpaceModel:
    """``model`` with ``fields`` set and every other kernel hook cleared."""
    return dataclasses.replace(model, **{**dict.fromkeys(_KERNEL_HOOKS), **fields})


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
        """E[fn(z_t) | y_{1:t}] per timestep from the stored history;
        ``fn`` maps one particle's state, as in the reference (it is
        vmapped over time and particles)."""
        vals = torch.func.vmap(torch.func.vmap(fn))(self.states)   # (T, N, ...)
        vals = vals.to(self.log_weights.dtype)
        w = torch.softmax(self.log_weights, dim=1)
        w = w.reshape(w.shape + (1,) * (vals.dim() - 2))
        return torch.sum(w * vals, dim=1)


def _log_mean_exp(lw: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(lw, 0) - math.log(lw.shape[0])


def final_log_mean_exp(log_w: torch.Tensor, states: torch.Tensor,
                       streaming: bool) -> torch.Tensor:
    """The evidence's last term, the log-mean-exp of the final weights:
    where the sweep is on the streaming path (``streaming``, float32 (n,)
    states that the streaming epoch takes) one
    :func:`~cpprob_tpu_torch.ops.stream_resample.logsumexp_stats` sweep in
    float64, else :func:`_log_mean_exp`."""
    if streaming and streams(states):
        return log_mean_exp_of_stats(sr.logsumexp_stats(log_w), log_w.shape[0])
    return _log_mean_exp(log_w)


def _per_particle(fn, gen: torch.Generator, states: torch.Tensor):
    """``fn(gen, one particle's state)`` over the population under
    ``torch.func.vmap``, each particle drawing its own values from ``gen``."""
    return torch.func.vmap(lambda s: fn(gen, s), randomness="different")(states)


def _obs_logpdf(model, states, y, t):
    """Every particle's emission log-density: the model's batched hook, or
    its per-particle hook under vmap."""
    if model.obs_logpdf_batch is not None:
        return model.obs_logpdf_batch(states, y, t)
    return torch.func.vmap(lambda s: model.obs_logpdf(s, y, t))(states)


_CHUNK_TAG = 5_000_011


def chunk_seed(seed: int, t0: int) -> int:
    """The seed of the chunk that starts at absolute step ``t0`` of the
    sweep seeded ``seed``, for a chunk hook that takes no time: a fixed
    function of the pair (``util.seeds.derive_seed``), so every chunk
    draws an unrelated Philox stream (the counterpart of the reference's
    ``k_prop``, split from the carried key at each chunk)."""
    return derive_seed(seed, _CHUNK_TAG, t0)


def chunk_hook(model: StateSpaceModel, exchange: bool) -> Callable:
    """The model's chunk kernel as a time-aware call ``(seed, states,
    log_w, ys, n_valid, [flag, ticks,] t0)``: its ``_t_`` hook as it is
    (it keeps precedence, as in the reference), else its hook without
    absolute time called with :func:`chunk_seed` ``(seed, t0)``."""
    t_hook, hook = ((model.fused_chunk_exchange_t_batch, model.fused_chunk_exchange_batch)
                    if exchange else (model.fused_chunk_t_batch, model.fused_chunk_batch))
    if t_hook is not None:
        return t_hook
    if hook is None:
        raise ValueError("the model has no fused chunk kernel hook")

    def call(seed, *args):
        *rest, t0 = args
        return hook(chunk_seed(seed, t0), *rest)

    return call


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
    ``sorted_fill=True`` a continuous one by value
    (:func:`.resampling.continuous_resample_values_lme`: the streaming
    epoch for scalar states, which skips its work on the device when the
    step does not resample; the sorted-key epoch for (n, D) states).
    A model's ``fused_step_ess_batch`` kernel hook (preferred: it returns
    the ESS from the kernel's records) or ``fused_step_batch`` hook, which
    take the sweep's integer seed and the absolute time, replaces the move
    and reweight.  A guided model (``proposal_sample`` set) always moves
    by its proposal and weights by ``step_logpdf - proposal_logpdf +
    obs_logpdf_batch`` (the exact RN correction), fused hooks or not."""
    guided = model.proposal_sample is not None
    fused = not guided and (model.fused_step_ess_batch is not None
                            or model.fused_step_batch is not None)

    def step(carry, y_t_and_t):
        with span("smc.step"):
            y_t, t = y_t_and_t
            key, states, log_w, log_z, ess = carry
            seed, gen = key
            do_resample = ess < ess_threshold * n_particles

            res_anc = None      # the value resamplers keep no ancestors
            if sorted_fill:
                res_states, lme = continuous_resample_values_lme(
                    gen, log_w, states, flag=do_resample.to(torch.int32))
            elif exchange:
                u0 = torch.rand((), generator=gen, device=states.device,
                                dtype=torch.float64)
                cat_w = category_weights(log_w, states, model.state_categories)
                counts = category_counts_systematic(u0, cat_w, n_particles)
                res_states = states_from_counts(counts, n_particles, dtype=states.dtype)
                lme = _log_mean_exp(log_w)
            else:
                res_anc = resampler(gen, log_w)
                res_states = states[res_anc.long()]
                lme = _log_mean_exp(log_w)
            states_r = torch.where(do_resample, res_states, states)
            log_w_r = torch.where(do_resample, torch.zeros_like(log_w), log_w)
            log_z_r = torch.where(do_resample, log_z + lme, log_z)

            if fused and model.fused_step_ess_batch is not None:
                new_states, new_log_w, new_ess = model.fused_step_ess_batch(
                    seed, states_r, log_w_r, y_t, t)
            else:
                if fused:
                    new_states, new_log_w = model.fused_step_batch(
                        seed, states_r, log_w_r, y_t, t)
                elif guided:
                    new_states = model.proposal_sample(gen, states_r, t, y_t)
                    rn = (model.step_logpdf(new_states, states_r, t)
                          - model.proposal_logpdf(new_states, states_r, t, y_t))
                    new_log_w = log_w_r + rn + _obs_logpdf(model, new_states, y_t, t)
                else:
                    if model.step_sample_batch is not None:
                        new_states = model.step_sample_batch(gen, states_r, t)
                    else:
                        new_states = _per_particle(
                            lambda g, s: model.step_sample(g, s, t), gen, states_r)
                    new_log_w = log_w_r + _obs_logpdf(model, new_states, y_t, t)
                new_ess = _ess(new_log_w)
            ys = (do_resample,)
            if store_history:
                ident = torch.arange(n_particles, dtype=torch.int32, device=states.device)
                anc = (ident if res_anc is None
                       else torch.where(do_resample, res_anc, ident))
                ys = (new_states, new_log_w, anc, do_resample)
            return (key, new_states, new_log_w, log_z_r, new_ess), ys

    return step


def _exchange_body(launch: Callable, n_particles: int, ess_threshold: float,
                   span_name: str):
    """The exchange paths' loop body around ``launch(seed, states, log_w,
    xs, flag, ticks) -> (s', w', ess', cat_w', lme')``."""

    def step(carry, xs, u0=None):
        with span(span_name):
            key, states, log_w, log_z, ess, cat_w, lme = carry
            seed, gen = key
            do_resample = ess < ess_threshold * n_particles
            if u0 is None:
                u0 = torch.rand((), generator=gen, device=states.device,
                                dtype=torch.float64)
            ticks = _category_ticks(u0, cat_w, n_particles)[:-1].to(torch.int32)
            log_z_r = log_z + torch.where(do_resample, lme, torch.zeros_like(lme))
            new_states, new_log_w, *stats = launch(
                seed, states, log_w, xs, do_resample.to(torch.int32), ticks)
            return (key, new_states, new_log_w, log_z_r, *stats), (do_resample,)

    return step


def make_smc_step_exchange_fused(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
):
    """Loop body of the per-step fused discrete path: one kernel launch per
    step (the model's ``fused_step_exchange_batch``), resampling folded
    into the launch as a flag and K-1 category ticks.

    Carry: ``(key, states, log_w, log_z, ess, cat_w, lme)``, the statistics
    of the current weights from the previous launch's records, with ``key
    = (seed, generator)``; xs: ``(y_t, t)``.  The flag and the ticks
    (float64 slot arithmetic) stay on the device.  ``u0`` pins the offset
    (tests); by default it is drawn from the carry's generator."""

    def launch(seed, states, log_w, xs, flag, ticks):       # xs: (y_t, t)
        return model.fused_step_exchange_batch(seed, states, log_w, *xs, flag, ticks)

    return _exchange_body(launch, n_particles, ess_threshold, "smc.step")


def make_smc_step_ctrl_fused(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
):
    """Loop body of the per-step fused path for scalar continuous states:
    the flagged streaming epoch, the evidence increment, then one launch of
    the model's ``fused_step_ctrl_batch``, which resets the weights where
    the flag is set and leaves the next step's flag.

    Carry: ``(key, states, log_w, log_z, flag)``, ``flag`` the int32
    resample flag of the incoming weights, from the previous launch, with
    ``key = (seed, generator)``; xs: ``(y_t, t)``.  No operation of the
    step runs over the population outside the epoch and the launch."""
    threshold = ess_threshold * n_particles

    def step(carry, y_t_and_t):
        with span("smc.step"):
            y_t, t = y_t_and_t
            key, states, log_w, log_z, flag = carry
            seed, gen = key
            states_r, lme = continuous_resample_values_lme(
                gen, log_w, states, flag=flag)
            log_z_r = log_z + torch.where(flag.bool(), lme, 0.0)
            new_states, new_log_w, new_flag = model.fused_step_ctrl_batch(
                seed, states_r, log_w, y_t, t, flag, threshold)
            return (key, new_states, new_log_w, log_z_r, new_flag), (flag,)

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
    ``fused_chunk_exchange_t_batch`` hook, or its
    ``fused_chunk_exchange_batch`` called with a seed a chunk
    (:func:`chunk_hook`)."""
    kernel = chunk_hook(model, exchange=True)

    def launch(seed, states, log_w, xs, flag, ticks):       # xs: (ys, n_valid, t0)
        return kernel(seed, states, log_w, *xs[:2], flag, ticks, xs[2])

    return _exchange_body(launch, n_particles, ess_threshold, "smc.chunk")


def make_smc_step_chunked(
    model: StateSpaceModel,
    n_particles: int,
    ess_threshold: float,
):
    """Loop body over observation chunks for continuous states, scalar or
    (n, D): a systematic resample epoch at the chunk boundary, then one
    fused kernel launch for the chunk's moves and reweights.

    Carry: ``(key, states, log_w, log_z, ess)`` with ``key = (seed,
    generator)``; xs: ``(ys (C,), n_valid, t0)``.  The resample decision
    stays on the device: it reaches the epoch's kernels as an int32 flag
    (with the flag off they do no work and return the population as it
    was), and the weights and the evidence are selected with
    ``torch.where``.  The model's chunk kernel is its time-aware
    ``fused_chunk_t_batch`` hook, or its ``fused_chunk_batch`` called with a
    seed a chunk (:func:`chunk_hook`)."""
    kernel = chunk_hook(model, exchange=False)

    def step(carry, xs):
        with span("smc.chunk"):
            ys, n_valid, t0 = xs
            key, states, log_w, log_z, ess = carry
            seed, gen = key
            do_resample = ess < ess_threshold * n_particles
            states_r, lme = continuous_resample_values_lme(
                gen, log_w, states, flag=do_resample.to(torch.int32))
            log_w_r = torch.where(do_resample, torch.zeros_like(log_w), log_w)
            log_z_r = log_z + torch.where(do_resample, lme, torch.zeros_like(lme))
            new_states, new_log_w, new_ess = kernel(
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


class _Path(NamedTuple):
    """One way through :func:`build_smc_run`'s sweep (:func:`_sweep_path`)."""

    name: str
    start: Callable    # (seed, gen, y0) -> (states, log_w, *the carry's statistics)
    inputs: Callable   # observations -> the body's inputs, a list
    body: Callable     # a ``make_smc_step*`` loop body
    close: Callable    # (carry, the body's outputs, states0, log_w0) -> SMCResult
    keyed: bool = False   # a fast path whose hooks all take a device key


def _takes_device_key(*hooks) -> bool:
    """Whether each of ``hooks`` that is set declares, by the attribute
    ``device_key`` (``ops.population.takes_device_key``), that it draws
    only from the seed as a device key or from the sweep's generator, and
    does nothing on the host that a replay would have to repeat."""
    return all(getattr(h, "device_key", False) for h in hooks if h is not None)


def _prior_hooks(model: StateSpaceModel) -> tuple:
    """The hooks that a start from the prior (:func:`_prior_draw`, then the
    first weight) calls."""
    if model.init_proposal_sample is not None:
        draw = (model.init_proposal_sample, model.init_logpdf,
                model.init_proposal_logpdf)
    else:
        draw = (model.init_sample_batch or model.init_sample,)
    return (*draw, model.obs_logpdf_batch or model.obs_logpdf)


def _prior_draw(model: StateSpaceModel, n: int) -> Callable:
    """The draw of a start without a fused one, ``(gen, y0) -> (states,
    log-density ratio)``: the initial proposal, the batched prior or the
    per-particle prior."""
    if model.init_proposal_sample is not None:
        def draw(gen, y0):
            states = model.init_proposal_sample(gen, y0, n)
            return states, (model.init_logpdf(states)
                            - model.init_proposal_logpdf(states, y0))
    elif model.init_sample_batch is not None:
        def draw(gen, y0):
            return model.init_sample_batch(gen, n), 0.0
    else:
        def draw(gen, y0):
            dummy = torch.empty(n, device=y0.device)
            return _per_particle(lambda g, _: model.init_sample(g), gen, dummy), 0.0
    return draw


def _close(last: Callable, as_bool: Callable = lambda flags: flags,
           history: bool = False) -> Callable:
    """A path's close: the evidence's last term ``last(carry)``, the
    resample flags (none at t = 0) as ``as_bool`` gives them and, with
    ``history``, the population, weights and ancestors of every step."""
    def close(carry, outs, states0, log_w0):
        states, log_w, log_z = carry[1:4]
        flags = torch.cat([torch.zeros(1, dtype=torch.bool, device=log_w.device)]
                          + [ys[-1].reshape(1) for ys in outs])
        hist = (None, None, None)
        if history:
            ident = torch.arange(log_w.shape[0], dtype=torch.int32, device=log_w.device)
            hist = [torch.stack([first] + [ys[i] for ys in outs])
                    for i, first in enumerate((states0, log_w0, ident))]
        return SMCResult(*hist, as_bool(flags), log_z + last(carry), states, log_w)

    return close


def _sweep_path(model: StateSpaceModel, n_particles: int, ess_threshold: float,
                resampling: str, store_history: bool, chunk: int) -> _Path:
    """The path of :func:`build_smc_run`'s sweeps, the only code that reads
    which hooks ``model`` carries and the options to choose one:

    - ``chunk_exchange``: ``chunk`` > 1, discrete states, a chunk kernel
      with exchange resampling; started by ``fused_init_batch`` where the
      model has it; closed by the last launch's log-mean-exp.
    - ``chunk_value``: ``chunk`` > 1, scalar or vector continuous states, a
      chunk kernel; started by ``fused_init_ctrl_batch`` where the model has
      it; closed by :func:`final_log_mean_exp` on the streaming path.
    - ``step_exchange``: ``fused_step_exchange_batch`` once a step, started
      from the prior (``init_sample_batch``, as the reference).
    - ``step_ctrl``: ``chunk`` = 1, continuous states,
      ``fused_step_ctrl_batch`` once a step, the int32 resample flag in the
      carry; started by ``fused_init_ctrl_batch`` where the model has it.
    - ``step``: otherwise, :func:`make_smc_step`, with history if asked.

    All but ``step`` need systematic resampling, no history and, for a
    guided model, its guided kernels (``fused_hooks_guided``).  All but
    ``step`` are ``keyed`` where every hook they call takes a device key
    (:func:`_takes_device_key`): the start (the fused one, or the prior's
    hooks, :func:`_prior_hooks`) and the kernel of the loop body; a chunk
    hook without absolute time, called with :func:`chunk_seed`, does not.
    Raises ``ValueError`` for an unknown ``resampling``, and for ``chunk``
    > 1 without a chunk kernel on those terms."""
    resampler = get_resampler(resampling)
    n, threshold = n_particles, ess_threshold * n_particles
    fast = ((model.proposal_sample is None or model.fused_hooks_guided)
            and not store_history and resampling == "systematic")
    exchange = fast and model.state_categories is not None
    by_value = (fast and model.state_categories is None
                and (model.scalar_state or model.vector_state_dim is not None))
    draw = _prior_draw(model, n)

    def keyed(start_hook, *body_hooks):  # start_hook None: the prior's start
        start_hooks = _prior_hooks(model) if start_hook is None else (start_hook,)
        return _takes_device_key(*start_hooks, *body_hooks)

    def prior_then(stats):             # the start from the draw, then its statistics
        def start(seed, gen, y0):
            states, rn = draw(gen, y0)
            log_w = rn + _obs_logpdf(model, states, y0, 0)
            return (states, log_w, *stats(states, log_w))
        return start

    def init_ctrl(*keep):              # of (states, log_w, ess, flag)
        pick = operator.itemgetter(*keep)
        return lambda seed, gen, y0: pick(
            model.fused_init_ctrl_batch(seed, n, y0, threshold))

    def lme(streaming):
        return lambda carry: final_log_mean_exp(carry[2], carry[1], streaming)

    with_ess = prior_then(lambda states, log_w: (_ess(log_w),))
    with_exchange = prior_then(lambda states, log_w: (
        _ess(log_w), category_weights(log_w, states, model.state_categories),
        _log_mean_exp(log_w)))
    ctrl_start = model.fused_init_ctrl_batch is not None

    def steps(observations):
        return [(observations[t], t) for t in range(1, observations.shape[0])]

    if chunk > 1:
        def chunks(observations):
            ys, valid = _chunk_observations(observations, chunk)
            return [(ys[c], valid[c], 1 + chunk * c) for c in range(ys.shape[0])]

        if exchange and (model.fused_chunk_exchange_batch is not None
                         or model.fused_chunk_exchange_t_batch is not None):
            start = (with_exchange if model.fused_init_batch is None
                     else lambda seed, gen, y0: model.fused_init_batch(seed, n, y0))
            return _Path("chunk_exchange", start, chunks,
                         make_smc_step_exchange_fused_chunked(model, n, ess_threshold),
                         _close(lambda carry: carry[6]),
                         keyed(model.fused_init_batch, chunk_hook(model, exchange=True)))
        if by_value and (model.fused_chunk_batch is not None
                         or model.fused_chunk_t_batch is not None):
            return _Path("chunk_value", init_ctrl(0, 1, 2) if ctrl_start else with_ess,
                         chunks, make_smc_step_chunked(model, n, ess_threshold),
                         _close(lme(True)),
                         keyed(model.fused_init_ctrl_batch,
                               chunk_hook(model, exchange=False)))
        raise ValueError(
            "chunk > 1 needs a fused_chunk_* kernel on the model and "
            "store_history=False with systematic resampling")
    if exchange and model.fused_step_exchange_batch is not None:
        return _Path("step_exchange", with_exchange, steps,
                     make_smc_step_exchange_fused(model, n, ess_threshold),
                     _close(lme(False)),
                     keyed(None, model.fused_step_exchange_batch))
    if chunk == 1 and by_value and model.fused_step_ctrl_batch is not None:
        with_flag = prior_then(lambda states, log_w: (
            (_ess(log_w) < threshold).to(torch.int32),))
        return _Path("step_ctrl", init_ctrl(0, 1, 3) if ctrl_start else with_flag,
                     steps, make_smc_step_ctrl_fused(model, n, ess_threshold),
                     _close(lme(True), lambda flags: flags != 0),
                     keyed(model.fused_init_ctrl_batch, model.fused_step_ctrl_batch))
    return _Path("step", with_ess, steps,
                 make_smc_step(model, n, ess_threshold, resampler, store_history,
                               exchange=exchange, sorted_fill=by_value),
                 _close(lme(by_value), history=store_history))


# queries of a ``keyed`` path on a card (:func:`build_smc_run`): "capture"
# the graphs captured, "replay" the queries a graph ran (the capturing one
# included), "eager" those that ran without one
SWEEP_GRAPH = counter_group("sweep_graph", ("capture", "replay", "eager"))


class _SweepGraph:
    """One query of a sweep captured as a CUDA graph, with the static
    buffers it reads (the observations, the device key), the outputs it
    writes, the per-stream scratch its kernels captured (its own, shared
    with no eager run and no other graph) and the counts its capture
    added, which each replay adds again; ``shape`` is what it was captured
    for, the observations' (shape, dtype, device)."""

    def __init__(self, sweep: Callable, gen: torch.Generator,
                 observations: torch.Tensor, shape: tuple):
        dev = observations.device
        self.shape = shape
        self.obs = torch.empty_like(observations)
        self.key = torch.zeros(2, dtype=torch.int32, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(gen)
        with recorded_counts() as self.counts, owned_scratch() as self.scratch:
            with torch.cuda.graph(self.graph):
                self.out = sweep(self.key, gen, self.obs)
        SWEEP_GRAPH["capture"] += 1

    def __call__(self, seed: int, gen: torch.Generator,
                 observations: torch.Tensor) -> SMCResult:
        with span("launch.sweep_graph"):
            self.obs.copy_(observations)
            write_key(self.key, seed)
            gen.manual_seed(seed)    # the replay reads its seed and offset 0
            self.graph.replay()
        SWEEP_GRAPH["replay"] += 1
        add_counts(self.counts)
        out = self.out
        return out._replace(resampled=out.resampled.clone(),
                            log_evidence=out.log_evidence.clone())


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

    ``chunk`` > 1 (a model with a fused chunk kernel, time-aware or not,
    :func:`chunk_hook`; no history, systematic resampling): that many
    timesteps per kernel launch, the ESS trigger evaluated at chunk
    boundaries (blocked adaptive
    resampling, an unbiased evidence estimator).  A discrete-state model
    resamples by exchange (``fused_chunk_exchange_[t_]batch``), a continuous
    one by value (``fused_chunk_[t_]batch``; the streaming epoch for scalar
    states, the sorted-key epoch for vector states).  ``chunk`` = 1 with a
    discrete model's ``fused_step_exchange_batch`` (no history, systematic
    resampling) launches it once per step, its population started from
    ``init_sample_batch`` as the reference does; with a scalar model's
    ``fused_step_ctrl_batch`` (the same conditions) the one-step launch
    carries the resample flag (:func:`make_smc_step_ctrl_fused`).  On
    those two scalar paths a model's ``fused_init_ctrl_batch`` starts the
    population with its ESS and first flag; on the streaming path the
    evidence closes with :func:`final_log_mean_exp`.

    ``run`` draws from one generator a device, seeded with ``key`` at each
    call, so a call draws what a fresh generator would.

    A captured query.  On a CUDA device, where the path is ``keyed`` (one of
    the four fast paths, every hook it calls declaring that it takes the
    seed as a device key or draws from the sweep's generator,
    :func:`_sweep_path`), a query is captured as a CUDA graph.  A ``run``
    holds one graph, for one length, dtype and device of the observations.
    A call of another shape runs eagerly; the second of two calls in a row
    of one shape captures the query, replacing the graph held before, and
    replays it; every later call of that shape writes the observations and
    the key into the graph's buffers, seeds the generator and replays.  So
    the first call of a shape, which builds and loads the kernels, never
    captures, and a run whose length changes at every call never captures.
    No call captures while ``torch.cuda.set_sync_debug_mode`` checks syncs
    (the capture syncs the device) or while the stream is being captured:
    those run eagerly.  A replay draws what the eager query draws, bit for
    bit.  Of its result, ``log_evidence`` and ``resampled`` are fresh
    tensors, while ``final_states`` and ``final_log_weights`` are the
    graph's own buffers, valid until the next call of the same ``run``:
    read or copy them before it.  The graph's private memory pool holds
    every buffer of the captured query, about as much memory as the eager
    query's peak, for as long as the run holds the graph.
    ``SWEEP_GRAPH`` counts the captures, the replayed queries and the eager
    ones of a keyed path on a card; each replay adds to the launch counters
    what its query launched.

    While a profiler records, a call lies in the span ``smc.run``, its
    start in ``smc.init`` and each loop body in ``smc.chunk`` or
    ``smc.step`` (:func:`~cpprob_tpu_torch.util.profiling.span`); a
    replayed call shows ``smc.run`` and ``launch.sweep_graph`` alone, the
    spans of the captured code having run once, at its capture."""
    path = _sweep_path(model, n_particles, ess_threshold, resampling,
                       store_history, chunk)
    gens: dict = {}
    graph: Optional[_SweepGraph] = None   # the run's one graph
    last = None                           # the shape of the call before

    def sweep(seed, gen: torch.Generator, observations: torch.Tensor) -> SMCResult:
        with span("smc.init"):
            states0, log_w0, *stats = path.start(seed, gen, observations[0])
        log_z = torch.zeros((), dtype=torch.float64, device=observations.device)
        carry = ((seed, gen), states0, log_w0, log_z, *stats)
        outs = []
        for xs in path.inputs(observations):
            carry, ys = path.body(carry, xs)
            outs.append(ys)
        return path.close(carry, outs, states0, log_w0)

    def run(key: int, observations: torch.Tensor) -> SMCResult:
        nonlocal graph, last
        with span("smc.run"):
            seed = int(key)
            dev = observations.device
            if dev not in gens:
                gens[dev] = torch.Generator(device=dev)
            gen = gens[dev].manual_seed(seed)
            if not (path.keyed and dev.type == "cuda"):
                return sweep(seed, gen, observations)
            shape = (observations.shape, observations.dtype, dev)
            before, last = last, shape
            if graph is None or graph.shape != shape:
                if (shape != before or torch.cuda.get_sync_debug_mode()
                        or torch.cuda.is_current_stream_capturing()):
                    SWEEP_GRAPH["eager"] += 1
                    return sweep(seed, gen, observations)
                graph = None          # its pool freed before the next capture
                graph = _SweepGraph(sweep, gen, observations, shape)
            return graph(seed, gen, observations)

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

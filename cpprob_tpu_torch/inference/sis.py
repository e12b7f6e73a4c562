"""Sequential importance sampling (SIS), vectorized — counterpart of
``cpprob_tpu/inference/sis.py``.

The reference runs one trace at a time (``cpprob.hpp:194-201``); here the
particles are ``torch.func.vmap(particle, randomness="different")`` over a
dummy ``(n,)`` tensor on the device, every site drawing from one explicit
``torch.Generator`` (:mod:`cpprob_tpu_torch.core.handlers` says why).
``key`` is an integer seed, as in the port's ``smc``, or a
``torch.Generator``; the generator's device is where the particles run.

A call queues its work without waiting on the host.  The syncs are: a
rejection loop's one flag a round (:func:`~cpprob_tpu_torch.core.primitives.rejection_sample`,
``Truncated`` over a base without ``icdf``); the Python numbers a caller
asks of a result (``float(res.log_evidence)``); and the checkpoint's save.
``jit`` is kept for the reference's surface and compiles nothing.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..core import handlers
from ..util.numerics import CompSum, comp_add, comp_scale, comp_value

__all__ = [
    "make_particle_fn",
    "make_prior_fn",
    "sis",
    "sis_streaming",
    "sis_streaming_checkpointed",
    "ImportanceResult",
    "StreamingResult",
]

Key = Union[int, torch.Generator]


def make_particle_fn(
    model: Callable,
    args: Tuple = (),
    kwargs: Optional[dict] = None,
    proposal_messenger: Optional[Callable[[], Any]] = None,
):
    """Build ``particle(generator) -> (log_weight, predicts)``: one weighted
    model execution, to be vmapped over particles.

    ``proposal_messenger``: zero-arg factory returning a messenger that guides
    sample sites (CSIS); ``None`` = prior proposal (plain SIS).
    """
    kwargs = kwargs or {}

    def particle(generator):
        lw = handlers.LogWeight()
        pc = handlers.PredictCollector()
        ctx = [handlers.Seed(generator), lw, pc]
        if proposal_messenger is not None:
            ctx.append(proposal_messenger())
        with _nested(ctx):
            model(*args, **kwargs)
        return lw.log_weight, pc.stacked()

    return particle


def make_prior_fn(model: Callable, args: Tuple = (), kwargs: Optional[dict] = None):
    """Build ``prior(generator) -> trace dict`` running the model in compile
    mode: observes are *simulated* (``cpprob.hpp:83-85``) and every site
    recorded."""
    kwargs = kwargs or {}

    def prior(generator):
        tr = handlers.TraceHandler()
        with _nested([handlers.Seed(generator), handlers.SimulateObserves(), tr]):
            model(*args, **kwargs)
        return {
            name: {"value": site["value"], "type": site["type"]}
            for name, site in tr.trace.items()
        }

    return prior


class _nested:
    def __init__(self, ctxs):
        self.ctxs = ctxs

    def __enter__(self):
        for c in self.ctxs:
            c.__enter__()

    def __exit__(self, *exc):
        for c in reversed(self.ctxs):
            c.__exit__(*exc)
        return False


def _generator(key: Key, device) -> torch.Generator:
    """``key`` itself if it is a generator, else a generator on ``device``
    seeded with it (on a machine without a card, ``device="cuda"`` raises
    here: nothing falls back to the CPU)."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _chunk_seed(key: int, chunk: int) -> int:
    """The seed of chunk ``chunk``'s generator: a fixed function of (key,
    chunk index), so any chunk can be run alone."""
    return int(np.random.SeedSequence([int(key), int(chunk)]).generate_state(1, np.uint64)[0]
               >> np.uint64(1))


def _vmapped(particle, gen: torch.Generator, n: int):
    """``n`` particles of ``particle`` drawing from ``gen``."""
    dummy = torch.empty(n, device=gen.device)
    return torch.func.vmap(lambda _: particle(gen), randomness="different")(dummy)


@dataclasses.dataclass(frozen=True)
class ImportanceResult:
    """Particles + log-weights — the in-memory counterpart of the reference's
    dumped posterior files (``state.cpp:250-267``)."""

    log_weights: torch.Tensor              # (n,)
    predicts: Dict[str, torch.Tensor]      # name -> (n, ...) stacked predict values

    @property
    def num_particles(self) -> int:
        return self.log_weights.shape[0]

    @property
    def normalized_weights(self) -> torch.Tensor:
        return torch.softmax(self.log_weights, 0)

    @property
    def log_evidence(self) -> torch.Tensor:
        """log(1/N sum w_i) — the marginal-likelihood estimate."""
        n = self.log_weights.shape[0]
        return torch.logsumexp(self.log_weights, 0) - math.log(float(n))

    @property
    def ess(self) -> torch.Tensor:
        """Kish effective sample size 1 / sum(w_i^2)."""
        lw = self.log_weights - torch.logsumexp(self.log_weights, 0)
        return torch.exp(-torch.logsumexp(2.0 * lw, 0))

    def empirical(self, name: str):
        from ..postprocess import EmpiricalDistribution

        return EmpiricalDistribution(self.predicts[name], self.log_weights)

    def mean(self, name: str) -> torch.Tensor:
        return self.empirical(name).mean

    def variance(self, name: str) -> torch.Tensor:
        return self.empirical(name).variance


@dataclasses.dataclass(frozen=True)
class StreamingResult:
    """Constant-memory SIS summary: log-evidence, ESS, and weighted
    mean/variance per predict — no per-particle storage."""

    log_evidence: torch.Tensor
    ess: torch.Tensor
    means: Dict[str, torch.Tensor]
    variances: Dict[str, torch.Tensor]
    n_particles: int

    def mean(self, name):
        return self.means[name]

    def variance(self, name):
        return self.variances[name]


def _make_chunk_stats(particle: Callable, batch_size: int):
    """Per-chunk streaming statistics of ``batch_size`` particles drawing
    from a generator: (max-shift, sum w, sum w^2, weighted value sums /
    square sums per predict, in float32)."""

    def chunk_stats(gen):
        log_w, predicts = _vmapped(particle, gen, batch_size)
        m = torch.max(log_w)
        w = torch.exp(log_w - m)
        s0 = torch.sum(w)
        s0_sq = torch.sum(w * w)
        sums = {}
        sqs = {}
        for name, vals in predicts.items():
            vals = vals.to(torch.float32)
            wshape = w.reshape((batch_size,) + (1,) * (vals.dim() - 1))
            sums[name] = torch.sum(wshape * vals, 0)
            sqs[name] = torch.sum(wshape * vals * vals, 0)
        return m, s0, s0_sq, sums, sqs

    return chunk_stats


def _lift_chunk(chunk):
    """Promote a plain per-chunk stat tuple into a compensated carry
    (every running sum becomes a :class:`CompSum`)."""
    m, s0, s0_sq, sums, sqs = chunk
    lift = lambda x: CompSum(x, torch.zeros_like(x))
    return (
        m, lift(s0), lift(s0_sq),
        {k: lift(v) for k, v in sums.items()},
        {k: lift(v) for k, v in sqs.items()},
    )


def _neutral_like(chunk):
    """The merge's neutral carry (m = -inf, zero compensated sums), shaped
    like ``chunk``."""
    m, s0, s0_sq, sums, sqs = chunk
    z = lambda x: CompSum(torch.zeros_like(x), torch.zeros_like(x))
    return (torch.full_like(m, -math.inf), z(s0), z(s0_sq),
            {k: z(v) for k, v in sums.items()}, {k: z(v) for k, v in sqs.items()})


def _merge_stats(carry, chunk):
    """Online max-shift logsumexp merge of a compensated carry with a fresh
    plain chunk — associative up to rounding, and Neumaier-compensated so
    the sequential float32 error stays O(eps) independent of chunk count."""
    m, s0, s0_sq, sums, sqs = carry
    mc, c0, c0_sq, csums, csqs = chunk
    new_m = torch.maximum(m, mc)
    a = torch.exp(m - new_m)
    b = torch.exp(mc - new_m)
    s0 = comp_add(comp_scale(s0, a), c0 * b)
    s0_sq = comp_add(comp_scale(s0_sq, a * a), c0_sq * b * b)
    sums = {k: comp_add(comp_scale(sums[k], a), csums[k] * b) for k in sums}
    sqs = {k: comp_add(comp_scale(sqs[k], a), csqs[k] * b) for k in sqs}
    return new_m, s0, s0_sq, sums, sqs


def _finalize_stats(carry, n_particles):
    m, s0, s0_sq, sums, sqs = carry
    s0v = comp_value(s0)
    s0_sqv = comp_value(s0_sq)
    log_z = m + torch.log(s0v) - math.log(float(n_particles))
    ess = (s0v * s0v) / torch.clamp(s0_sqv, min=1e-38)
    means = {k: comp_value(sums[k]) / s0v for k in sums}
    variances = {k: comp_value(sqs[k]) / s0v - means[k] ** 2 for k in sums}
    return log_z, ess, means, variances


def _run_chunks(chunk_stats, key: Key, device, chunks, carry):
    """Merge the chunks ``chunks`` into ``carry`` (None: the neutral carry).
    An integer ``key`` seeds chunk c's generator with ``_chunk_seed(key,
    c)``; a generator ``key`` draws every chunk from itself."""
    for c in chunks:
        gen = key if isinstance(key, torch.Generator) else _generator(_chunk_seed(key, c), device)
        stats = chunk_stats(gen)
        carry = _merge_stats(_neutral_like(stats) if carry is None else carry, stats)
    return carry


def sis_streaming(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: Key,
    batch_size: int,
    *,
    device="cuda",
    proposal_messenger: Optional[Callable[[], Any]] = None,
    jit: bool = True,
) -> StreamingResult:
    """SIS with **streaming** weighted-moment accumulation: particles run in
    chunks of ``batch_size`` and only running sums survive — memory is
    O(batch_size), so particle counts are bounded by time, not device
    memory.  Chunk c draws from a generator seeded by a fixed function of
    (``key``, c), as :func:`sis_streaming_checkpointed` does, so the two
    agree bit for bit.  ``jit`` compiles nothing."""
    if n_particles % batch_size != 0:
        raise ValueError("n_particles must be divisible by batch_size")
    n_chunks = n_particles // batch_size
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)
    chunk_stats = _make_chunk_stats(particle, batch_size)
    carry = _run_chunks(chunk_stats, key, device, range(n_chunks), None)
    log_z, ess, means, variances = _finalize_stats(carry, n_particles)
    return StreamingResult(log_z, ess, means, variances, n_particles)


def load_checkpoint(dump_path: str, n_particles: int, batch_size: int, device):
    """``(carry, chunks_done)`` from a dump written by
    :func:`sis_streaming_checkpointed` (the JAX package's or the port's:
    the same npz keys, ``sis.py:334-346`` of the reference).  A dump
    written for another ``n_particles`` or ``batch_size`` raises; a dump
    without ``#c`` keys resumes with zero compensation terms."""
    with np.load(dump_path) as ck:
        if int(ck["batch_size"]) != batch_size or int(ck["n_particles"]) != n_particles:
            raise ValueError(
                f"checkpoint {dump_path!r} was written for "
                f"n_particles={int(ck['n_particles'])}, "
                f"batch_size={int(ck['batch_size'])}"
            )
        t = lambda a: torch.from_numpy(np.array(a)).to(device)
        lc = lambda stem: CompSum(
            t(ck[stem]), t(ck[stem + "#c"]) if stem + "#c" in ck.files
            else torch.zeros_like(t(ck[stem])))
        names = [f[4:] for f in ck.files if f.startswith("sum:") and not f.endswith("#c")]
        carry = (t(ck["m"]), lc("s0"), lc("s0_sq"),
                 {k: lc(f"sum:{k}") for k in names},
                 {k: lc(f"sq:{k}") for k in names})
        return carry, int(ck["chunks_done"])


def _save_checkpoint(dump_path, carry, done, batch_size, n_particles):
    """Write the carry atomically (a host copy of every sum: a sync)."""
    m, s0, s0_sq, sums, sqs = carry
    h = lambda x: x.detach().cpu().numpy()
    payload = {
        "m": h(m), "s0": h(s0.value), "s0#c": h(s0.comp),
        "s0_sq": h(s0_sq.value), "s0_sq#c": h(s0_sq.comp),
        "chunks_done": done, "batch_size": batch_size,
        "n_particles": n_particles,
    }
    for k, v in sums.items():
        payload[f"sum:{k}"], payload[f"sum:{k}#c"] = h(v.value), h(v.comp)
    for k, v in sqs.items():
        payload[f"sq:{k}"], payload[f"sq:{k}#c"] = h(v.value), h(v.comp)
    tmp = dump_path + ".tmp.npz"
    np.savez(tmp, **payload)
    os.replace(tmp, dump_path)


def sis_streaming_checkpointed(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: int,
    batch_size: int,
    dump_path: str,
    *,
    dump_every: int = 16,
    device="cuda",
    proposal_messenger: Optional[Callable[[], Any]] = None,
    resume: bool = True,
) -> StreamingResult:
    """Streaming SIS with **on-disk partial dumps**: after every
    ``dump_every`` chunks the running sufficient statistics are atomically
    written to ``dump_path`` (npz, the reference's keys), so an interrupted
    run keeps its partial results and ``resume=True`` continues where it
    stopped (``state.cpp:262-267`` gives the same guarantee one trace at a
    time).

    ``key`` is an integer seed: chunk c draws from a generator seeded by a
    fixed function of (``key``, c), so a resumed run is bit-identical to an
    uninterrupted one.
    """
    if n_particles % batch_size != 0:
        raise ValueError("n_particles must be divisible by batch_size")
    if isinstance(key, torch.Generator):
        raise TypeError("sis_streaming_checkpointed takes an integer seed: a "
                        "resumed run draws each chunk from its own generator")
    n_chunks = n_particles // batch_size
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)
    chunk_stats = _make_chunk_stats(particle, batch_size)
    carry, done = None, 0
    if resume and os.path.exists(dump_path):
        carry, done = load_checkpoint(dump_path, n_particles, batch_size, device)
    while done < n_chunks:
        g = min(dump_every, n_chunks - done)
        carry = _run_chunks(chunk_stats, key, device, range(done, done + g), carry)
        done += g
        _save_checkpoint(dump_path, carry, done, batch_size, n_particles)
    log_z, ess, means, variances = _finalize_stats(carry, n_particles)
    return StreamingResult(log_z, ess, means, variances, n_particles)


def sis(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key: Key,
    *,
    device="cuda",
    proposal_messenger: Optional[Callable[[], Any]] = None,
    batch_size: Optional[int] = None,
    jit: bool = True,
) -> ImportanceResult:
    """Vectorized SIS: counterpart of
    ``cpprob::inference(StateType::sis, f, observes, n)`` (``cpprob.hpp:173-203``).

    ``key``: an integer seed (a generator on ``device`` is seeded with it)
    or a ``torch.Generator`` (its device is used).  ``batch_size`` bounds
    peak memory: particles run in ``n // batch_size`` vmapped batches in a
    Python loop (the reference's ``lax.map``), drawing from the one
    generator in turn.  ``jit`` compiles nothing.
    """
    particle = make_particle_fn(model, args, proposal_messenger=proposal_messenger)
    gen = _generator(key, device)
    if batch_size is None or batch_size >= n_particles:
        log_w, predicts = _vmapped(particle, gen, n_particles)
    else:
        if n_particles % batch_size != 0:
            raise ValueError("n_particles must be divisible by batch_size")
        parts = [_vmapped(particle, gen, batch_size)
                 for _ in range(n_particles // batch_size)]
        log_w = torch.cat([p[0] for p in parts])
        predicts = {k: torch.cat([p[1][k] for p in parts]) for k in parts[0][1]}
    return ImportanceResult(log_w, predicts)

"""Dynamic-structure CSIS: trace bucketing by address sequence —
counterpart of ``cpprob_tpu/inference/csis_dynamic.py``.

The reference groups training traces into *subbatches* by a hash of their
address sequence, so models with data-dependent structure (rejection loops,
random trace lengths) train one shared network with per-address modules
(``infcomp/data_structures.py:32-41``, ``nn.py:93-128``).  This module is
the counterpart for models whose structure varies at Python level:

- Python control flow on a sampled value (``while int(x) == 1``) cannot run
  under ``torch.func.vmap``, so **trace generation** runs eagerly, one trace
  at a time, as the reference's C++ simulator loop does;
- traces accumulate in **buckets keyed by their address-sequence
  signature**, and a full bucket makes one optimizer step on that
  structure;
- parameters are **keyed by address** and shared across buckets, like the
  reference's per-address module table;
- **guided inference** uses an address-keyed messenger (the head looked up
  by the message's address, not by position) running eagerly per
  particle, with the prior fallback for unseen addresses
  (``cpprob.hpp:52-56``).

The eager paths (:func:`sis_host`, :meth:`DynamicCSIS.compile`,
:meth:`DynamicCSIS.infer`) wait on the card by design: the model reads
sampled values back (``int(...)``).  The probe of the structure runs on a
CPU generator, as :func:`~cpprob_tpu_torch.inference.csis.discover_structure`
does.  Models whose dynamism is bounded should be written in static-max +
mask form and use the vectorized :class:`~cpprob_tpu_torch.inference.csis.CSIS`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import handlers
from ..distributions.base import to_device, to_host
from . import nn
from .csis import (
    ModelStructure,
    SiteSpec,
    _cpu_generator,
    _detached,
    _embed_value,
    _f32,
    _seed_of,
    _site_spec_from_dist,
    _trainable,
    csis_loss,
    embed_observation,
    init_csis_params,
    make_proposal_dist,
)
from .sis import ImportanceResult, _generator, _nested, _vmapped

__all__ = ["DynamicCSIS", "DynamicProposalMessenger", "sis_host"]


def _trace_signature(sites: Tuple[SiteSpec, ...]) -> Tuple:
    return tuple((s.addr, s.kind, s.meta, s.value_dim, s.discrete_k, s.n_out) for s in sites)


class DynamicProposalMessenger(handlers.Messenger):
    """Address-keyed guided proposals: the head for each sample site is
    looked up by the site's address (the reference's per-address dispatch,
    ``nn.py:191-207``); unknown addresses fall back to the prior with zero
    Radon-Nikodym correction (``cpprob.hpp:52-56``).  There is no expected
    site order: any address sequence the model takes is guided at exactly
    the sites the network knows."""

    def __init__(self, params, spec_table: Dict[str, SiteSpec], obs_emb: torch.Tensor):
        self.params = params
        self.spec_table = spec_table
        self.obs_emb = obs_emb
        self.obs_gate = nn.lstm_obs_gate(params["lstm"], obs_emb)
        E = params["lstm"][0]["wh"].shape[0]
        self.state = nn.lstm_zero_state(params["lstm"])
        self.prev_emb = torch.zeros((E,), device=obs_emb.device)
        self._rejection_cache: Dict[str, Any] = {}

    def process_message(self, msg):
        if msg["type"] != "sample" or not msg["control"] or msg["is_observed"]:
            return
        if msg["value"] is not None or msg["proposal_dist"] is not None:
            return
        if msg["rejection"] and msg["name"] in self._rejection_cache:
            msg["proposal_dist"] = self._rejection_cache[msg["name"]]
            return
        spec = self.spec_table.get(msg["name"])
        if spec is None or spec.pkey not in self.params["heads"]:
            return  # prior fallback
        h, self.state = nn.lstm_step_split(self.params["lstm"], self.prev_emb,
                                           self.obs_gate, self.state)
        proposal = make_proposal_dist(spec, nn.mlp_apply(self.params["heads"][spec.pkey], h))
        msg["proposal_dist"] = proposal
        if msg["rejection"]:
            self._rejection_cache[msg["name"]] = proposal
        msg["_csis_spec"] = spec

    def postprocess_message(self, msg):
        spec = msg.pop("_csis_spec", None)
        if spec is not None:
            self.prev_emb = _embed_value(self.params, spec, msg["value"])


def sis_host(
    model: Callable,
    args: Tuple,
    n_particles: int,
    key,
    proposal_messenger: Optional[Callable[[], Any]] = None,
    *,
    device="cuda",
) -> ImportanceResult:
    """Serial SIS, one particle at a time, for models vmap cannot run
    (Python control flow on sampled values) — the reference's execution
    model (``cpprob.hpp:194-201``).  Every particle draws from one generator
    (``key``: a seed, a generator on ``device``, or a generator) in turn,
    and its log-weight is read back: a sync a particle, by design.
    Predicts whose shapes vary across particles, or that some particles
    lack, are left out."""
    gen = _generator(key, device)
    log_ws: List[float] = []
    predicts: Dict[str, List] = {}
    with torch.no_grad():
        for _ in range(n_particles):
            lw = handlers.LogWeight()
            pc = handlers.PredictCollector()
            ctxs = [handlers.Seed(gen), lw, pc]
            if proposal_messenger is not None:
                ctxs.append(proposal_messenger())
            with _nested(ctxs):
                model(*args)
            log_ws.append(float(lw.log_weight))
            for name, vals in pc.stacked().items():
                predicts.setdefault(name, []).append(to_host(vals))
    out: Dict[str, torch.Tensor] = {}
    for name, rows in predicts.items():
        if len(rows) != n_particles:
            continue  # predict absent in some traces (dynamic structure)
        if len({r.shape for r in rows}) == 1:
            out[name] = to_device(np.stack(rows), gen.device)
    return ImportanceResult(to_device(np.asarray(log_ws, np.float32), gen.device), out)


class DynamicCSIS:
    """Inference compilation for dynamic-structure models via trace
    bucketing.

    >>> engine = DynamicCSIS(model, args_template)
    >>> params, stats = engine.compile(0, n_traces=20_000)
    >>> res = engine.infer(params, observed_args, 1_000, 1)
    """

    _DISCRETE_KINDS = ("uniform_int", "categorical", "bernoulli", "poisson")

    def __init__(
        self,
        model: Callable,
        args_template: Tuple,
        embedding_dim: int = nn.EMBEDDING_DIM,
        obs_embedding: str = "fc",
        bucket_batch: int = 64,
        probe: int = 128,
        probe_key=None,
        device="cuda",
    ):
        """``probe`` eager traces under a CPU generator (seeded with
        ``probe_key``, default 0) make the spec table: the union of the
        sites over the structures they realize, keyed by address.  The
        network trains and the particles run on ``device``."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DynamicCSIS(device='cuda') needs a CUDA card; pass "
                               "device='cpu' to run on the CPU")
        self.model = model
        self.args_template = args_template
        self.embedding_dim = embedding_dim
        self.obs_embedding = obs_embedding
        self.bucket_batch = bucket_batch
        self.spec_table: Dict[str, SiteSpec] = {}
        self.obs_dim = 0
        self._probe(_cpu_generator(0 if probe_key is None else _seed_of(probe_key)), probe)

    # -- trace generation (eager; the reference's simulator loop) ----------

    def _trace_once(self, generator: torch.Generator):
        tr = handlers.TraceHandler()
        with torch.no_grad(), _nested([handlers.Seed(generator), handlers.SimulateObserves(),
                                       tr]):
            self.model(*self.args_template)
        sites: List[SiteSpec] = []
        values: Dict[str, np.ndarray] = {}
        obs_parts: List[np.ndarray] = []
        for name, site in tr.trace.items():
            if site["type"] == "sample" and site["control"] and not site["is_observed"]:
                spec = _site_spec_from_dist(name, site["dist"])
                if spec is not None:
                    sites.append(spec)
                    values[name] = to_host(site["value"])
            elif site["type"] in ("observe", "metaobserve"):
                obs_parts.append(np.ravel(to_host(site["value"]).astype(np.float32)))
        obs = np.concatenate(obs_parts) if obs_parts else np.zeros((1,), np.float32)
        return tuple(sites), values, obs

    def _probe(self, generator, n):
        obs_dims = set()
        for _ in range(n):
            sites, _, obs = self._trace_once(generator)
            obs_dims.add(obs.shape[0])
            for s in sites:
                prev = self.spec_table.get(s.addr)
                if prev is not None and _trace_signature((prev,)) != _trace_signature((s,)):
                    raise ValueError(
                        f"address {s.addr!r} maps to different families "
                        "across traces; cannot share a head"
                    )
                self.spec_table[s.addr] = s
        if len(obs_dims) != 1:
            raise ValueError(
                "observation size varies across traces "
                f"({sorted(obs_dims)}); pad observes to a fixed shape"
            )
        self.obs_dim = obs_dims.pop()

    def _union_structure(self) -> ModelStructure:
        return ModelStructure(tuple(self.spec_table.values()), (), self.obs_dim)

    def init(self, seed=0):
        """The initial network, from a CPU generator seeded with ``seed``,
        on the engine's device."""
        return init_csis_params(_cpu_generator(_seed_of(seed)), self._union_structure(),
                                self.embedding_dim, self.obs_embedding, device=self.device)

    def _optimizer(self, params, learning_rate):
        params, leaves = _trainable(params)
        return params, torch.optim.Adam(leaves, lr=learning_rate)

    def _step(self, params, opt, sites, values, obs) -> torch.Tensor:
        """One Adam step on a bucket.  A site the probe did not see (or saw
        with another family) has no head: the loss leaves it out, as
        guided inference falls back to the prior there without an LSTM
        step.  (The JAX package's loss raises ``KeyError`` on such a
        site.)"""
        known = tuple(s for s in sites if self.spec_table.get(s.addr) == s)
        structure = ModelStructure(known, (), self.obs_dim)
        loss = csis_loss(params, structure, values, obs, self.obs_embedding)
        opt.zero_grad(set_to_none=False)
        loss.backward()
        opt.step()
        return loss.detach()

    # -- bucketed training (the reference's subbatching) -------------------

    def compile(
        self,
        key=0,
        n_traces: int = 10_000,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
        saver=None,
    ):
        """Generate ``n_traces`` prior traces eagerly (from a generator on
        the device seeded by ``key``; a sync a trace), bucket them by
        address-sequence signature, and make one Adam step per full bucket
        (parameters shared across buckets by address).  Leftover partial
        buckets train once at their size.  Returns ``(params, stats)`` with
        the per-bucket counts and the losses.  ``saver`` is called per
        trained bucket; Ctrl-C returns the partial parameters
        (``train.py:47-53``)."""
        if params is None:
            params = self.init(_seed_of(key))
        params, opt = self._optimizer(params, learning_rate)
        gen = _generator(key, self.device)
        buckets: Dict[Tuple, List] = {}
        counts: Dict[Tuple, int] = {}
        losses: List[float] = []

        def train_bucket(rows):
            sites = rows[0][0]
            values = {s.addr: to_device(np.stack([r[1][s.addr] for r in rows]), self.device)
                      for s in sites}
            obs = to_device(np.stack([r[2] for r in rows]), self.device)
            loss = float(self._step(params, opt, sites, values, obs))
            losses.append(loss)
            if log_fn is not None:
                log_fn(loss, len(rows))
            if saver is not None:
                saver.maybe_save(_detached(params), len(rows))

        try:
            for _ in range(n_traces):
                sites, values, obs = self._trace_once(gen)
                sig = _trace_signature(sites)
                buckets.setdefault(sig, []).append((sites, values, obs))
                counts[sig] = counts.get(sig, 0) + 1
                if len(buckets[sig]) >= self.bucket_batch:
                    train_bucket(buckets.pop(sig))
            for rows in list(buckets.values()):
                train_bucket(rows)
        except KeyboardInterrupt:
            pass  # Ctrl-C-safe partial return
        stats = {
            "bucket_counts": {str(k[:2]): v for k, v in counts.items()},
            "n_buckets": len(counts),
            "losses": losses,
        }
        return _detached(params), stats

    # -- vectorized bucket training (re-simulation on the device) ----------

    def _pin_set(self, sites: Tuple[SiteSpec, ...], values) -> Dict[str, Any]:
        """Values of the discrete (structure-driving) sites of one skeleton
        trace — Python control flow almost always branches on discrete
        draws (loop counts, branch flags, sizes)."""
        return {s.addr: np.asarray(values[s.addr]) for s in sites
                if s.discrete_k > 0 or s.kind in self._DISCRETE_KINDS}

    def _make_vectorized_gen(self, sites: Tuple[SiteSpec, ...], pins):
        """``gen(generator, n)``: n fresh traces under ``torch.func.vmap``
        sharing a skeleton's control path — the discrete sites substituted
        with the skeleton's values (unbatched, so the model's Python flow
        on them stays concrete), everything else drawn anew from the
        conditional prior.  The composition is exact prior sampling; the
        pinned sites repeat across the batch.  Raises when the model reads
        back an unpinned site (the caller then falls back to the eager
        path)."""
        free_addrs = [s.addr for s in sites if s.addr not in pins]
        model, args, device = self.model, self.args_template, self.device
        pinned = {a: to_device(v, device) for a, v in pins.items()}

        def one(generator):
            tr = handlers.TraceHandler()
            with _nested([handlers.Seed(generator), handlers.SimulateObserves(),
                          handlers.Substitute(pinned), tr]):
                model(*args)
            vals = {a: tr.trace[a]["value"] for a in free_addrs}
            obs_parts = [torch.ravel(_f32(site["value"], device))
                         for site in tr.trace.values()
                         if site["type"] in ("observe", "metaobserve")]
            obs = torch.cat(obs_parts) if obs_parts else torch.zeros((1,), device=device)
            return vals, obs

        def gen(generator, n):
            with torch.no_grad():
                return _vmapped(one, generator, n)

        return gen

    def compile_vectorized(
        self,
        key=0,
        n_traces: int = 10_000,
        batch_size: int = 64,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
    ):
        """Bucketed training with the batches generated on the device: one
        eager trace a batch finds the structure (the skeleton), then
        ``batch_size`` fresh traces sharing its control path are drawn
        under vmap (discrete sites pinned) and one Adam step trains on
        them.  Eager model runs drop from O(n_traces) to O(n_traces /
        batch_size).

        Falls back to the eager :meth:`compile` when the model's control
        flow depends on a continuous (unpinned) site — detected when the
        first batch is drawn, never silently wrong.  Returns ``(params,
        stats)`` like :meth:`compile`, with ``stats['vectorized']``."""
        if params is None:
            params = self.init(_seed_of(key))
        params, opt = self._optimizer(params, learning_rate)
        gen = _generator(key, self.device)
        gen_cache: Dict[Tuple, Callable] = {}
        counts: Dict[Tuple, int] = {}
        losses: List[float] = []
        for b in range(max(1, n_traces // batch_size)):
            sites, values, _obs = self._trace_once(gen)
            sig = _trace_signature(sites)
            pins = self._pin_set(sites, values)
            gen_key = (sig, tuple(sorted((a, v.tobytes()) for a, v in pins.items())))
            make = gen_cache.get(gen_key)
            fresh = make is None
            if fresh:
                make = self._make_vectorized_gen(sites, pins)
            try:
                vals, obs = make(gen, batch_size)
            except (RuntimeError, TypeError, ValueError):
                if b == 0:
                    # the model is not vectorizable: the eager path
                    out, stats = self.compile(key, n_traces=n_traces,
                                              learning_rate=learning_rate,
                                              params=_detached(params), log_fn=log_fn)
                    stats["vectorized"] = False
                    return out, stats
                continue  # skip this structure, keep the fast path
            if fresh:
                gen_cache[gen_key] = make
            for a, v in pins.items():
                vals[a] = torch.broadcast_to(to_device(v, self.device),
                                             (batch_size,) + np.shape(v))
            counts[sig] = counts.get(sig, 0) + batch_size
            loss = float(self._step(params, opt, sites, vals, obs))
            losses.append(loss)
            if log_fn is not None:
                log_fn(loss, batch_size)
        stats = {
            "bucket_counts": {str(k[:2]): v for k, v in counts.items()},
            "n_buckets": len(counts),
            "losses": losses,
            "vectorized": True,
        }
        return _detached(params), stats

    # -- guided inference ---------------------------------------------------

    def obs_vector(self, args: Tuple) -> torch.Tensor:
        """The observed values flattened, on the device (one eager run)."""
        tr = handlers.TraceHandler()
        with torch.no_grad(), _nested([handlers.Seed(_generator(0, self.device)), tr]):
            self.model(*args)
        parts = [torch.ravel(_f32(site["value"], self.device)) for site in tr.trace.values()
                 if site["type"] in ("observe", "metaobserve")]
        return torch.cat(parts) if parts else torch.zeros((1,), device=self.device)

    def proposal_factory(self, params, args: Tuple):
        with torch.no_grad():
            obs_emb = embed_observation(params, self.obs_vector(args), self.obs_embedding)
        spec_table = dict(self.spec_table)

        def factory():
            return DynamicProposalMessenger(params, spec_table, obs_emb)

        return factory

    def infer(self, params, args: Tuple, n_particles: int, key) -> ImportanceResult:
        """Guided importance sampling, serial particles on the device (the
        only execution model for Python-dynamic structure, and the
        reference's own, ``cpprob.hpp:194-201``): a sync a particle."""
        return sis_host(self.model, args, n_particles, key,
                        proposal_messenger=self.proposal_factory(params, args),
                        device=self.device)

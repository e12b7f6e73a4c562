"""CSIS — inference compilation (Le, Baydin & Wood 2017) — counterpart of
``cpprob_tpu/inference/csis.py``.

The reference splits CSIS across two processes, a C++ simulator and a
PyTorch LSTM talking FlatBuffers over ZeroMQ with one RPC per sample
statement (``state.hpp:236-280``, ``socket.hpp:57-79``).  Here, as in the
JAX package, the whole pipeline is in one process and on the device:

- *compile* (training): prior traces are generated by
  ``torch.func.vmap`` of the model under ``SimulateObserves`` — a batch of
  traces per step — and the loss is plain autograd over the parameter
  leaves, with ``torch.optim.Adam``;
- the proposal network (observation embedding, per-address value
  embeddings, a 2-layer LSTM, per-address proposal heads, mirroring
  ``infcomp/nn/nn.py``) is a plain tree of tensors (:mod:`.nn`);
- *inference*: a messenger installs the network inside the particle
  program, so each sample site's proposal is a batched product over all
  particles under vmap;
- unseen or mismatched addresses fall back to the prior, as the
  reference's ``Distribution::NONE`` path (``cpprob.hpp:52-56``).

The port's conventions:

- Structure discovery (:func:`discover_structure`) runs the model once
  under a **CPU** generator whatever the engine's device: the address
  sequence and the prior families are static properties of the model, and
  reading a support parameter back (``float(dist.low)``) would wait on the
  card.
- ``key`` is an integer seed or a ``torch.Generator`` where the reference
  takes a key.  The initial network is drawn from a CPU generator seeded
  with the seed and then moved to the device, so a CPU test and the card
  start from the same net; the trace batches are drawn from a generator on
  the engine's device.
- Integer sites are int64 (the reference's int32); masks are float32.
- ``infer`` is eager: one code path, and a model may branch on its Python
  arguments.  ``infer_many`` runs the same path once per seed and stacks
  the results, so a model that ``infer`` takes, ``infer_many`` takes too
  (the reference's ``infer_many`` lacks ``infer``'s eager fallback).
- With no ``log_fn`` or ``saver``, ``infer``, ``infer_many`` and the steps
  of ``compile`` and ``compile_offline`` queue their work without waiting
  on the host; the exceptions are a rejection round's one flag
  (:func:`~cpprob_tpu_torch.distributions.base.host_any`) and a loader's
  pinned, non-blocking host-to-device copy.
- ``mesh=`` (a :func:`~cpprob_tpu_torch.parallel.particle_mesh`, every
  rank calling with the same arguments): ``compile`` is data-parallel (each
  rank draws its share of the batch from a generator seeded from (seed,
  rank), and the gradients are averaged by one all-reduce a step, so the
  parameters stay the same on every rank); ``infer`` runs
  :func:`~cpprob_tpu_torch.parallel.sis_sharded`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import handlers
from ..distributions import (
    Bernoulli,
    Beta,
    Categorical,
    DefensiveMixture,
    Exponential,
    Gamma,
    Laplace,
    MinMaxDiscrete,
    Mixture,
    MultivariateNormalDiag,
    Normal,
    Poisson,
    SplineFlow1D,
    Truncated,
    Uniform,
    UniformInt,
)
from ..distributions.base import _leaves, to_device, to_host
from ..util.pytree import tree_leaves, tree_map
from . import nn
from .sis import ImportanceResult, _generator, _nested, _vmapped, sis

__all__ = ["CSIS", "SiteSpec", "ModelStructure", "discover_structure", "tie_structure"]

_N_MIX = 8  # reference: truncated mixture of 8 normals (prior_distributions.py:59-65)
_COMPILE_TAG = 4_000_000   # the data-parallel trace generators' seeds: (seed, tag, rank)

@dataclasses.dataclass(frozen=True)
class SiteSpec:
    """Static description of one controlled sample site."""

    addr: str
    kind: str                 # proposal family
    meta: Tuple[float, ...]   # static support parameters (low/high/K/...)
    value_dim: int            # flattened event size (1 for scalars)
    discrete_k: int           # >0: embedding-table size for bounded ints
    n_out: int                # head output width
    # parameter-table key; None = the address itself.  Tied sites (same base
    # address `name[t]`, same family) share one key -> one value-embedding +
    # head, so the parameters are O(#groups), not O(T).
    param_key: Optional[str] = None

    @property
    def pkey(self) -> str:
        return self.param_key if self.param_key is not None else self.addr


@dataclasses.dataclass(frozen=True)
class ModelStructure:
    sites: Tuple[SiteSpec, ...]
    observe_addrs: Tuple[str, ...]
    obs_dim: int
    # (start, length) segments over `sites`; length > 1 marks a run of
    # consecutive tied sites sharing one head
    segments: Tuple[Tuple[int, int], ...] = ()
    # per-observe-site value shapes (same order as observe_addrs) — lets the
    # structured obs embedding split the flat obs vector back into sites
    observe_shapes: Tuple[Tuple[int, ...], ...] = ()

    def iter_segments(self):
        if self.segments:
            return self.segments
        return tuple((i, 1) for i in range(len(self.sites)))


_ADDR_INDEX_RE = re.compile(r"^(.*)\[(\d+)\]$")


def tie_structure(structure: ModelStructure) -> ModelStructure:
    """Tie repeated sites: consecutive addresses ``base[i]`` with identical
    (kind, meta, value_dim, discrete_k, n_out) share one parameter key
    ``base[*]`` and form a segment.  Weight tying keeps the per-step
    proposal identity through the LSTM state and the step values while the
    parameters stay O(#groups) (the reference's per-address module zoo,
    ``nn.py:209-234``, is linear in the trace length)."""
    sites = list(structure.sites)
    new_sites: List[SiteSpec] = []
    segments: List[Tuple[int, int]] = []
    i = 0
    while i < len(sites):
        m = _ADDR_INDEX_RE.match(sites[i].addr)
        run = 1
        if m is not None:
            base = m.group(1)
            tmpl = sites[i]
            j = i + 1
            while j < len(sites):
                mj = _ADDR_INDEX_RE.match(sites[j].addr)
                if (
                    mj is None
                    or mj.group(1) != base
                    or (sites[j].kind, sites[j].meta, sites[j].value_dim,
                        sites[j].discrete_k, sites[j].n_out)
                    != (tmpl.kind, tmpl.meta, tmpl.value_dim,
                        tmpl.discrete_k, tmpl.n_out)
                ):
                    break
                j += 1
            run = j - i
        if run > 1:
            pkey = f"{base}[*]"
            new_sites.extend(dataclasses.replace(sites[k], param_key=pkey)
                             for k in range(i, i + run))
        else:
            new_sites.append(sites[i])
        segments.append((i, run))
        i += run
    return dataclasses.replace(structure, sites=tuple(new_sites), segments=tuple(segments))


def _site_spec_from_dist(addr: str, dist) -> Optional[SiteSpec]:
    """Map a prior distribution instance to its proposal head spec — the
    static counterpart of the reference's ``proposal<D>`` trait type map
    (``utils_*.hpp``).  It reads support parameters back to the host:
    discovery runs on the CPU, so this never waits on a card."""
    if isinstance(dist, Normal):
        return SiteSpec(addr, "normal", (), 1, 0, 2)
    if isinstance(dist, Uniform):
        low = float(to_host(dist.low))
        high = float(to_host(dist.high))
        return SiteSpec(addr, "uniform", (low, high), 1, 0, 3 * _N_MIX)
    if isinstance(dist, UniformInt):
        low = int(to_host(dist.low))
        high = int(to_host(dist.high))
        k = high - low + 1
        return SiteSpec(addr, "uniform_int", (low, k), 1, k, k)
    if isinstance(dist, MinMaxDiscrete):
        low = int(to_host(dist.low))
        k = int(dist.probs.shape[-1])
        return SiteSpec(addr, "uniform_int", (low, k), 1, k, k)
    if isinstance(dist, Categorical):
        k = int(dist.probs.shape[-1])
        return SiteSpec(addr, "categorical", (k,), 1, k, k)
    if isinstance(dist, Poisson):
        return SiteSpec(addr, "poisson", (), 1, 0, 1)
    if isinstance(dist, Bernoulli):
        return SiteSpec(addr, "bernoulli", (), 1, 2, 1)
    if isinstance(dist, Beta):
        return SiteSpec(addr, "beta", (), 1, 0, 2)
    if isinstance(dist, Gamma):
        return SiteSpec(addr, "gamma", (), 1, 0, 2)
    if isinstance(dist, Laplace):
        return SiteSpec(addr, "laplace", (), 1, 0, 2)
    if isinstance(dist, Exponential):
        return SiteSpec(addr, "exponential", (), 1, 0, 1)
    if isinstance(dist, MultivariateNormalDiag):
        d = int(dist.loc.shape[-1])
        return SiteSpec(addr, "mvn_diag", (d,), d, 0, 2 * d)
    # Beyond the reference's 4-type parse set (infcomp/traits.py:28-34):
    # bounded-support priors (Truncated) reuse the truncated-mixture-of-
    # normals head; Mixture priors get a mixture-density head sized to the
    # prior's component count.  Needs static scalar bounds/weights.
    if isinstance(dist, Truncated):
        try:
            low = float(to_host(dist.low))
            high = float(to_host(dist.high))
        except (TypeError, ValueError):
            return None  # non-scalar bounds -> prior fallback
        if np.isfinite(low) and np.isfinite(high) and np.ndim(to_host(dist.low)) == 0:
            return SiteSpec(addr, "uniform", (low, high), 1, 0, 3 * _N_MIX)
        return None
    if isinstance(dist, Mixture):
        k = max(int(dist.weights.shape[-1]), 4)
        leaves = _leaves(dist.components)
        if leaves and all(l.ndim == 1 for l in leaves):  # scalar components
            return SiteSpec(addr, "mdn", (k,), 1, 0, 3 * k)
        return None
    # Dirac/ABC priors: no NN proposal -> prior fallback
    # (``Distribution::NONE``, cpprob.hpp:52-56).
    return None


def make_proposal_dist(spec: SiteSpec, raw: torch.Tensor):
    """Raw head outputs -> proposal distribution, with the constraint
    projections of ``infcomp/distributions/projections.py`` (softplus for
    positive, softmax for simplex, interval sigmoid for bounded means)."""
    kind = spec.kind
    if kind == "normal":
        return Normal(raw[..., 0], nn.softplus(raw[..., 1]))
    if kind == "mdn":
        # mixture-density head for multimodal posteriors
        k = int(spec.meta[0])
        logits = raw[..., :k]
        means = raw[..., k : 2 * k]
        stds = nn.softplus(raw[..., 2 * k :]) + 1e-3
        comps = Normal(torch.movedim(means, -1, 0), torch.movedim(stds, -1, 0))
        return Mixture(comps, torch.softmax(logits, -1))
    if kind == "nsf":
        # neural-spline-flow head (Durkan et al. 2019)
        k = int(spec.meta[0])
        return SplineFlow1D(raw[..., :k], raw[..., k : 2 * k], raw[..., 2 * k : 3 * k - 1],
                            raw[..., 3 * k - 1], nn.softplus(raw[..., 3 * k]) + 1e-3)
    if kind == "uniform":
        low, high = spec.meta
        logits = raw[..., :_N_MIX]
        means = low + torch.sigmoid(raw[..., _N_MIX : 2 * _N_MIX]) * (high - low)
        stds = nn.softplus(raw[..., 2 * _N_MIX :]) * (high - low) * 0.1 + 1e-4
        # low/high carried as (_N_MIX,) leaves: every leaf has the
        # component axis
        comps = Truncated(
            Normal(torch.movedim(means, -1, 0), torch.movedim(stds, -1, 0)),
            torch.full((_N_MIX,), float(low), device=raw.device),
            torch.full((_N_MIX,), float(high), device=raw.device),
        )
        return Mixture(comps, torch.softmax(logits, -1))
    if kind == "uniform_int":
        return MinMaxDiscrete(int(spec.meta[0]), torch.softmax(raw, -1))
    if kind == "categorical":
        return Categorical(torch.softmax(raw, -1))
    if kind == "poisson":
        return Poisson(nn.softplus(raw[..., 0]))
    if kind == "bernoulli":
        return Bernoulli(torch.sigmoid(raw[..., 0]))
    if kind == "beta":
        return Beta(nn.softplus(raw[..., 0]) + 1.0, nn.softplus(raw[..., 1]) + 1.0)
    if kind == "gamma":
        return Gamma(nn.softplus(raw[..., 0]) + 0.5, nn.softplus(raw[..., 1]))
    if kind == "laplace":
        return Laplace(raw[..., 0], nn.softplus(raw[..., 1]))
    if kind == "exponential":
        return Exponential(nn.softplus(raw[..., 0]))
    if kind == "mvn_diag":
        d = int(spec.meta[0])
        return MultivariateNormalDiag(raw[..., :d], nn.softplus(raw[..., d:]))
    raise ValueError(f"no proposal family for kind {kind!r}")


def _cpu_generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(int(seed))
    return g


def discover_structure(model: Callable, args: Tuple) -> ModelStructure:
    """One compile-mode execution, unbatched and under a CPU generator
    (seed 0), to read the static address sequence, the prior families and
    the observation layout."""
    tr = handlers.TraceHandler()
    with _nested([handlers.Seed(_cpu_generator(0)), handlers.SimulateObserves(), tr]):
        model(*args)
    sites: List[SiteSpec] = []
    observe_addrs: List[str] = []
    observe_shapes: List[Tuple[int, ...]] = []
    obs_dim = 0
    for name, site in tr.trace.items():
        if site["type"] == "sample" and site["control"] and not site["is_observed"]:
            spec = _site_spec_from_dist(name, site["dist"])
            if spec is not None:
                sites.append(spec)
        elif site["type"] in ("observe", "metaobserve"):
            observe_addrs.append(name)
            shp = tuple(np.shape(to_host(site["value"])))
            observe_shapes.append(shp)
            obs_dim += int(np.prod(shp) or 1)
    return ModelStructure(tuple(sites), tuple(observe_addrs), obs_dim,
                          observe_shapes=tuple(observe_shapes))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def init_csis_params(
    generator: torch.Generator,
    structure: ModelStructure,
    embedding_dim: int = nn.EMBEDDING_DIM,
    obs_embedding: str = "fc",
    obs_shape: Optional[Tuple[int, ...]] = None,
    device=None,
) -> Dict[str, Any]:
    """The parameter tree, drawn from ``generator`` and placed on
    ``device`` (default: the generator's): the observation embedding (fc |
    lstm | cnn3d | site-lstm — the reference's ``--obs_embedding`` options
    and ``ObserveEmbeddingCNN3D4C``), the stacked LSTM, and one
    (value-embedding, head) pair per parameter key — the static table in
    place of the reference's module zoo (``nn.py:209-234``)."""
    E = embedding_dim
    dev = generator.device if device is None else torch.device(device)
    if obs_embedding == "fc":
        # 4-layer FC observation embedding (observation.py:16-36)
        obs_net = nn.mlp_init([max(structure.obs_dim, 1), E, E, E], generator, dev)
    elif obs_embedding == "lstm":
        obs_net = nn.lstm_init(1, E, generator, layers=1, device=dev)
    elif obs_embedding == "cnn3d":
        if obs_shape is None or len(obs_shape) != 3:
            raise ValueError("obs_embedding='cnn3d' needs a 3-D obs_shape")
        obs_net = nn.conv3d_init(generator, out_dim=E, device=dev)
    elif obs_embedding == "site-lstm":
        # one embedder per observe site (CNN3D for volumes, MLP otherwise),
        # then an LSTM over the site sequence (observation.py:39-93)
        if not structure.observe_shapes:
            raise ValueError(
                "obs_embedding='site-lstm' needs observe sites with recorded "
                "shapes (structure.observe_shapes)"
            )
        site_emb = {}
        for addr, shp in zip(structure.observe_addrs, structure.observe_shapes):
            if len(shp) == 3:
                site_emb[addr] = {"conv3d": nn.conv3d_init(generator, out_dim=E, device=dev)}
            else:
                size = int(np.prod(shp)) if shp else 1
                site_emb[addr] = {"mlp": nn.mlp_init([size, E, E], generator, dev)}
        obs_net = {"sites": site_emb,
                   "seq_lstm": nn.lstm_init(E, E, generator, layers=1, device=dev)}
    else:
        raise ValueError(f"unknown obs_embedding {obs_embedding!r}")
    params: Dict[str, Any] = {
        "obs_net": obs_net,
        "lstm": nn.lstm_init(2 * E, E, generator, layers=2, device=dev),
        "value_emb": {},
        "heads": {},
    }
    for spec in structure.sites:
        pk = spec.pkey
        if pk in params["heads"]:
            continue
        if spec.discrete_k > 0:
            params["value_emb"][pk] = nn.embedding_init(spec.discrete_k, E, generator, dev)
        else:
            params["value_emb"][pk] = nn.mlp_init([spec.value_dim, E, E], generator, dev)
        params["heads"][pk] = nn.mlp_init([E, E, spec.n_out], generator, dev)
    return params


def embed_observation(
    params, obs, obs_embedding: str = "fc",
    obs_shape: Optional[Tuple[int, ...]] = None,
    structure: Optional[ModelStructure] = None,
):
    """obs: (..., obs_dim) flat observation vector(s) -> (..., E)."""
    if obs_embedding == "fc":
        return nn.mlp_apply(params["obs_net"], obs)
    if obs_embedding == "lstm":
        # the flat vector as a length-obs_dim sequence of scalars
        xs = torch.movedim(obs[..., None], -2, 0)  # (T, ..., 1)
        return nn.lstm_embed_sequence(params["obs_net"], xs)
    if obs_embedding == "cnn3d":
        vol = obs.reshape(tuple(obs.shape[:-1]) + tuple(obs_shape))
        return nn.conv3d_apply(params["obs_net"], vol)
    if obs_embedding == "site-lstm":
        if structure is None or not structure.observe_shapes:
            raise ValueError("site-lstm embedding needs the model structure")
        embs = []
        off = 0
        for addr, shp in zip(structure.observe_addrs, structure.observe_shapes):
            size = int(np.prod(shp)) if shp else 1
            chunk = obs[..., off : off + size]
            off += size
            p = params["obs_net"]["sites"][addr]
            if "conv3d" in p:
                embs.append(nn.conv3d_apply(
                    p["conv3d"], chunk.reshape(tuple(chunk.shape[:-1]) + tuple(shp))))
            else:
                embs.append(nn.mlp_apply(p["mlp"], chunk))
        xs = torch.stack(embs, 0)  # (S, ..., E): sequence over sites
        return nn.lstm_embed_sequence(params["obs_net"]["seq_lstm"], xs)
    raise ValueError(f"unknown obs_embedding {obs_embedding!r}")


def _embed_value(params, spec: SiteSpec, value):
    """The value embedding of a site's value (a batched index under vmap
    too): a table row for bounded integers (clipped to the table), an MLP
    of the float value otherwise."""
    table_or_mlp = params["value_emb"][spec.pkey]
    dev = tree_leaves(table_or_mlp)[0].device
    if spec.discrete_k > 0:
        low = int(spec.meta[0]) if spec.kind == "uniform_int" else 0
        idx = torch.clamp(to_device(value, dev).long() - low, 0, spec.discrete_k - 1)
        return nn.embedding_lookup(table_or_mlp, idx)
    v = to_device(value, dev).to(torch.float32)
    if spec.value_dim == 1:
        v = v[..., None]
    return nn.mlp_apply(table_or_mlp, v)


# ---------------------------------------------------------------------------
# Training (the reference's `compile` mode)
# ---------------------------------------------------------------------------


def _f32(v, device) -> torch.Tensor:
    return v.to(torch.float32) if isinstance(v, torch.Tensor) else to_device(
        v, device, torch.float32)


def make_trace_batch_fn(model: Callable, args: Tuple, structure: ModelStructure):
    """Build ``gen(generator, n) -> (site_values dict, obs matrix)``: n
    prior traces with simulated observations, drawn under
    ``torch.func.vmap`` from ``generator`` on its device, without autograd
    (replaces the ZMQ RequestTraces/ReplyTraces handshake).  ``site_values``
    holds each site's (n, ...) values and ``"__masks__"``, each site's (n,)
    float32 activity mask: variable-structure models are written as
    static-max + Mask, and masked-out sites must not enter the loss."""

    def one(generator):
        tr = handlers.TraceHandler()
        with _nested([handlers.Seed(generator), handlers.SimulateObserves(), tr]):
            model(*args)
        dev = generator.device
        values = {spec.addr: tr.trace[spec.addr]["value"] for spec in structure.sites}
        values["__masks__"] = {
            spec.addr: (_f32(tr.trace[spec.addr]["mask"], dev)
                        if tr.trace[spec.addr]["mask"] is not None
                        else torch.ones((), device=dev))
            for spec in structure.sites
        }
        obs = (torch.cat([torch.ravel(_f32(tr.trace[a]["value"], dev))
                          for a in structure.observe_addrs])
               if structure.observe_addrs else torch.zeros((1,), device=dev))
        return values, obs

    def gen(generator: torch.Generator, n: int):
        with torch.no_grad():
            return _vmapped(one, generator, n)

    return gen


def csis_loss(
    params, structure: ModelStructure, values, obs,
    obs_embedding: str = "fc", obs_shape=None, dro_rho=None, mesh=None,
):
    """Mean over traces of Σ_sites −log q(x | proposal) (``nn.py:150-170``),
    batched over the traces (plain autograd, no vmap).  A tied segment is
    the same loop over its sites with the shared head.  ``dro_rho``:
    chi-square-ball distributionally-robust reweighting of the per-trace
    losses (cf. ``infcomp/nn/regularize.py``).

    ``mesh`` (with ``dro_rho``): the traces are this rank's shard of the
    batch.  The detached per-trace losses are all-gathered, so every rank
    forms the same weights over the whole batch, and the rank's objective
    is k · Σ_local w_i ℓ_i: the step's average of the k ranks' gradients is
    then the single process's robust gradient (Danskin's estimator)."""
    E = params["lstm"][0]["wh"].shape[0]
    n = obs.shape[0]
    masks = values.get("__masks__", {})
    obs_emb = embed_observation(params, obs, obs_embedding, obs_shape, structure)  # (n, E)
    # the obs half of the layer-0 input gates, once per trace
    obs_gate = nn.lstm_obs_gate(params["lstm"], obs_emb)
    state = nn.lstm_zero_state(params["lstm"], (n,))
    prev_emb = torch.zeros((n, E), device=obs_emb.device)
    total = torch.zeros((n,), device=obs_emb.device)
    for start, length in structure.iter_segments():
        spec = structure.sites[start]
        for k in range(start, start + length):
            addr = structure.sites[k].addr
            h, state = nn.lstm_step_split(params["lstm"], prev_emb, obs_gate, state)
            raw = nn.mlp_apply(params["heads"][spec.pkey], h)     # (n, n_out)
            v = values[addr]
            nll = -make_proposal_dist(spec, raw).log_prob(v)
            m = masks.get(addr)
            if m is not None:
                nll = nll * m
            total = total + nll
            prev_emb = _embed_value(params, spec, v)
    if dro_rho is not None:
        from .regularize import chi_square_weights, dro_loss

        if mesh is None:
            return dro_loss(total, dro_rho)
        from ..parallel._collectives import all_gather, axis_index, axis_size

        k, my = axis_size(mesh), axis_index(mesh)
        w = chi_square_weights(all_gather(total.detach(), mesh).reshape(-1), dro_rho)
        return k * torch.sum(w[my * n:(my + 1) * n] * total)
    return torch.mean(total)


# ---------------------------------------------------------------------------
# Guided inference messenger (the reference's csis mode)
# ---------------------------------------------------------------------------


class CSISProposalMessenger(handlers.Messenger):
    """Installs NN proposals at controlled sample sites inside the particle
    program.  Under ``torch.func.vmap`` its Python state (the site pointer)
    is the population's, its LSTM ``(h, c)`` and previous value embedding
    are batched per particle, and the parameters and ``obs_gate`` are
    unbatched constants.

    Prior fallback: a site whose address does not match the next expected
    address (or has no trained head) samples from the prior with zero
    Radon–Nikodym correction — the reference's ``Distribution::NONE``
    (``cpprob.hpp:52-56``, ``server.py:25-27``).  During a
    ``rejection_sampling`` block the proposal for an address is computed
    once and cached (``state.hpp:239-262``); every round of the port's
    vmapped ``rejection_sample`` draws from the cached proposal, and
    ``postprocess_message`` refreshes the previous value embedding with the
    accepted draw."""

    def __init__(self, params, structure: ModelStructure, obs_emb: torch.Tensor,
                 first_step=None, defensive=None):
        self.params = params
        # defensive-mixture weight on the prior (Hesterberg 1995); None =
        # the pure learned proposal
        self.defensive = defensive
        self.structure = structure
        # obs_emb is embedded once per inference call, outside the particle
        # program (cf. the reference's cached obs embedding, nn.py:179-189)
        self.obs_emb = obs_emb
        # the constant half of the layer-0 input gates (nn.lstm_obs_gate)
        self.obs_gate = nn.lstm_obs_gate(params["lstm"], obs_emb)
        E = params["lstm"][0]["wh"].shape[0]
        self.state = nn.lstm_zero_state(params["lstm"])
        self.prev_emb = torch.zeros((E,), device=obs_emb.device)
        # the first site's LSTM input ([zeros, obs_emb]) is the same for
        # every particle: (h, state) computed once outside the program
        self._first_step = first_step
        self.ptr = 0
        self._rejection_cache: Dict[str, Any] = {}
        self._rejection_spec: Dict[str, SiteSpec] = {}

    def process_message(self, msg):
        if msg["type"] != "sample" or not msg["control"] or msg["is_observed"]:
            return
        if msg["value"] is not None or msg["proposal_dist"] is not None:
            return
        if msg["rejection"] and msg["name"] in self._rejection_cache:
            msg["proposal_dist"] = self._rejection_cache[msg["name"]]
            return
        if self.ptr >= len(self.structure.sites):
            return
        spec = self.structure.sites[self.ptr]
        if msg["name"] is not None and msg["name"] != spec.addr:
            return  # unknown address -> prior fallback
        if self.ptr == 0 and self._first_step is not None:
            h, self.state = self._first_step
        else:
            h, self.state = nn.lstm_step_split(self.params["lstm"], self.prev_emb,
                                               self.obs_gate, self.state)
        proposal = make_proposal_dist(spec, nn.mlp_apply(self.params["heads"][spec.pkey], h))
        if self.defensive is not None:
            proposal = DefensiveMixture(proposal, msg["dist"], self.defensive)
        msg["proposal_dist"] = proposal
        if msg["rejection"]:
            self._rejection_cache[msg["name"]] = proposal
            self._rejection_spec[msg["name"]] = spec
        msg["_csis_spec"] = spec

    def scan_adapter(self, n_iters: int):
        """Hook of :func:`cpprob_tpu_torch.core.scanner.scan_sites`: when the
        next ``m * n_iters`` sites are tied with iteration period ``m``
        (``tie_addresses=True``), the loop's fast path threads (LSTM state,
        previous value embedding) through its iterations — the inference
        twin of the training loss's tied segments.  None (the unrolled
        fallback) when the upcoming sites do not tile into a tied
        pattern."""
        sites = self.structure.sites
        total = len(sites) - self.ptr
        for m in range(1, 9):
            if m * n_iters > total:
                break
            tmpl = sites[self.ptr : self.ptr + m]
            if not all(s.param_key is not None for s in tmpl):
                continue
            if all(sites[self.ptr + t * m + j].pkey == tmpl[j].pkey
                   for t in range(n_iters) for j in range(m)):
                return _CSISScanAdapter(self, tuple(tmpl), m * n_iters)
        return None

    def postprocess_message(self, msg):
        spec = msg.pop("_csis_spec", None)
        if spec is not None:
            self.prev_emb = _embed_value(self.params, spec, msg["value"])
            self.ptr += 1
        elif msg.get("rejection") and msg["name"] in self._rejection_spec:
            # a repeated guard attempt (cached proposal): refresh the
            # previous value embedding so that after the guard the LSTM
            # conditions on the accepted draw, as the training trace's
            # keep-last record does
            self.prev_emb = _embed_value(self.params, self._rejection_spec[msg["name"]],
                                         msg["value"])


class _CSISScanStep(handlers.Messenger):
    """The messenger of one iteration of the ``scan_sites`` fast path: the
    LSTM step and head of :class:`CSISProposalMessenger`, with (LSTM state,
    previous value embedding) carried by the loop and the site specs fixed
    to the tied iteration template."""

    def __init__(self, params, specs, obs_gate, lstm_state, prev_emb):
        self.params = params
        self.specs = specs
        self.obs_gate = obs_gate
        self.state = lstm_state
        self.prev_emb = prev_emb
        self.j = 0

    def process_message(self, msg):
        if msg["type"] != "sample" or not msg["control"] or msg["is_observed"]:
            return
        if msg["value"] is not None or msg["proposal_dist"] is not None:
            return
        if self.j >= len(self.specs):
            return
        spec = self.specs[self.j]
        if msg["name"] is not None and msg["name"] not in (spec.addr, spec.pkey):
            return  # unknown address -> prior fallback
        h, self.state = nn.lstm_step_split(self.params["lstm"], self.prev_emb,
                                           self.obs_gate, self.state)
        msg["proposal_dist"] = make_proposal_dist(
            spec, nn.mlp_apply(self.params["heads"][spec.pkey], h))
        msg["_csis_spec"] = spec

    def postprocess_message(self, msg):
        spec = msg.pop("_csis_spec", None)
        if spec is not None:
            self.prev_emb = _embed_value(self.params, spec, msg["value"])
            self.j += 1


class _CSISScanAdapter:
    """scan_sites adapter: threads the proposal messenger's state through
    the loop and advances the outer messenger past the consumed sites."""

    def __init__(self, msgr: CSISProposalMessenger, specs, n_consumed: int):
        self.msgr = msgr
        self.specs = specs
        self.n_consumed = n_consumed
        self.init = (msgr.state, msgr.prev_emb)

    def make(self, state):
        return _CSISScanStep(self.msgr.params, self.specs, self.msgr.obs_gate,
                             state[0], state[1])

    def extract(self, m: _CSISScanStep):
        return (m.state, m.prev_emb)

    def commit(self, final_state):
        self.msgr.state, self.msgr.prev_emb = final_state
        self.msgr.ptr += self.n_consumed


# ---------------------------------------------------------------------------
# High-level engine
# ---------------------------------------------------------------------------


def _seed_of(key) -> int:
    return key.initial_seed() if isinstance(key, torch.Generator) else int(key)


def _trainable(params):
    """A copy of ``params`` whose leaves are fresh leaf tensors with
    ``requires_grad`` and zero gradients (so that, as with optax, a leaf a
    batch does not reach is still stepped by its moments), and the leaf
    list in JAX's flatten order."""
    def leaf(t):
        t = t.detach().clone().requires_grad_()
        t.grad = torch.zeros_like(t)
        return t

    params = tree_map(leaf, params)
    return params, tree_leaves(params)


def _detached(params):
    return tree_map(lambda t: t.detach(), params)


class CSIS:
    """Compile + infer, counterpart of ``cpprob::compile``
    (``cpprob.hpp:127-171``) and ``cpprob::inference(StateType::csis, ...)``
    (``cpprob.hpp:173-203``).

    >>> engine = CSIS(model, args_template)
    >>> params, losses = engine.compile(0, steps=500)
    >>> result = engine.infer(params, observed_args, 10_000, 1)
    """

    def __init__(
        self,
        model: Callable,
        args_template: Tuple,
        embedding_dim: int = nn.EMBEDDING_DIM,
        obs_embedding: str = "fc",
        obs_shape: Optional[Tuple[int, ...]] = None,
        mdn_components: int = 0,
        flow_bins: int = 0,
        tie_addresses: bool = False,
        device="cuda",
    ):
        """``mdn_components`` > 0 upgrades Normal-prior sites to
        mixture-density heads with that many components (a posterior over a
        site that is multimodal); ``flow_bins`` > 0 instead upgrades them to
        rational-quadratic-spline flow heads with that many bins
        (:class:`~cpprob_tpu_torch.distributions.SplineFlow1D`).  Mutually
        exclusive.

        ``tie_addresses=True`` shares one (value-embedding, head) pair
        across consecutive loop-indexed sites ``name[t]`` of one family:
        the parameters become O(#site groups) instead of O(trace length).

        ``device`` is where the network trains and the particles run
        (default ``"cuda"``: with no card it raises rather than run on the
        CPU); structure discovery runs on the CPU."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("CSIS(device='cuda') needs a CUDA card; pass device='cpu' "
                               "to run on the CPU")
        self.model = model
        self.args_template = args_template
        self.structure = discover_structure(model, args_template)
        if mdn_components > 0 and flow_bins > 0:
            raise ValueError("choose one of mdn_components / flow_bins")
        if mdn_components > 0:
            self.structure = dataclasses.replace(self.structure, sites=tuple(
                dataclasses.replace(s, kind="mdn", meta=(mdn_components,),
                                    n_out=3 * mdn_components)
                if s.kind == "normal" else s for s in self.structure.sites))
        if flow_bins > 0:
            self.structure = dataclasses.replace(self.structure, sites=tuple(
                dataclasses.replace(s, kind="nsf", meta=(flow_bins,),
                                    n_out=3 * flow_bins + 1)
                if s.kind == "normal" else s for s in self.structure.sites))
        if tie_addresses:
            self.structure = tie_structure(self.structure)
        self.embedding_dim = embedding_dim
        self.obs_embedding = obs_embedding
        self.obs_shape = obs_shape
        self._gen = make_trace_batch_fn(model, args_template, self.structure)

    def init(self, seed=0):
        """The initial network: drawn from a CPU generator seeded with
        ``seed`` (an integer, or a generator's initial seed), then moved to
        the engine's device."""
        return init_csis_params(_cpu_generator(_seed_of(seed)), self.structure,
                                self.embedding_dim, self.obs_embedding, self.obs_shape,
                                device=self.device)

    def _train(self, params, learning_rate, batches, log_fn, saver, unroll, dro_rho=None,
               mesh=None):
        """The Adam loop over ``batches`` (an iterator of (values, obs));
        Ctrl-C returns what has been trained.  With ``mesh``, each rank's
        batch is its shard: the gradients and the loss are averaged over
        the ranks by one all-reduce before Adam steps, and ``saver`` runs
        on rank 0 only."""
        params, leaves = _trainable(params)
        if mesh is not None:
            from ..parallel._collectives import axis_index, axis_size, psum

            k = axis_size(mesh)
            if axis_index(mesh) != 0:
                saver = None
        opt = torch.optim.Adam(leaves, lr=learning_rate)
        structure = self.structure
        losses: List[torch.Tensor] = []
        pending: List[Tuple[torch.Tensor, int]] = []
        try:
            for values, obs in batches:
                loss = csis_loss(params, structure, values, obs, self.obs_embedding,
                                 self.obs_shape, dro_rho, mesh)
                opt.zero_grad(set_to_none=False)
                loss.backward()
                if mesh is not None:
                    flat = psum(torch.cat([p.grad.reshape(-1) for p in leaves]
                                          + [loss.detach().reshape(1)]), mesh) / k
                    grads = torch.split(flat[:-1], [p.numel() for p in leaves])
                    for p, g in zip(leaves, grads):
                        p.grad.copy_(g.reshape(p.shape))
                    loss = flat[-1]
                opt.step()
                losses.append(loss.detach())
                pending.append((losses[-1], obs.shape[0]))
                if len(pending) >= unroll:
                    self._report(pending, params, log_fn, saver)
                    pending = []
            self._report(pending, params, log_fn, saver)
        except KeyboardInterrupt:
            pass  # Ctrl-C-safe: hand back the partially trained network
        params = _detached(params)
        if not losses:
            return params, torch.zeros((0,), device=self.device)
        return params, torch.stack(losses)

    @staticmethod
    def _report(pending, params, log_fn, saver):
        if not pending:
            return
        if log_fn is not None:
            for loss, n in pending:
                log_fn(float(loss), n)
        if saver is not None:
            saver.maybe_save(_detached(params), sum(n for _, n in pending))

    def compile(
        self,
        key=0,
        steps: int = 400,
        batch_size: int = 64,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
        dro_rho=None,
        unroll: int = 1,
        mesh=None,
        saver=None,
    ):
        """Online training from freshly simulated prior traces (minibatch 64,
        Adam — the reference defaults, ``main.py:28``, ``nn.py:166-169``):
        ``torch.optim.Adam(lr=learning_rate)`` over the leaves in JAX's
        flatten order, the batches drawn from a generator on the engine's
        device (``key``: a seed, or a generator), the initial net from
        :meth:`init` with the seed.  ``dro_rho`` enables chi-square-ball
        robust reweighting.

        ``unroll`` is the number of steps between ``log_fn`` and ``saver``
        calls (the reference scans that many steps a dispatch; the port has
        no dispatch to amortize).  ``log_fn(loss, n_traces)`` is called for
        every step (a host read of the loss); ``saver`` is a
        :class:`~cpprob_tpu_torch.util.checkpoint.periodic_saver`, called
        with the fresh parameters and the traces consumed
        (``--save_after_n_traces``, ``infcomp/util.py:29-37``).  With
        neither, a step queues its work without waiting on the host.
        Ctrl-C returns the partially trained parameters
        (``infcomp/train.py:47-53``).

        ``mesh``: data-parallel training over a particle mesh (every rank
        calls ``compile`` with the same arguments): ``batch_size`` must
        divide by the mesh size k, rank r draws ``batch_size / k`` traces a
        step from a generator seeded from (seed, r), and the gradients are
        averaged over the ranks before each Adam step, so the parameters
        and the losses are the same on every rank.  With ``dro_rho`` the
        robust weights are formed over the whole batch on every rank
        (:func:`csis_loss`), so a step equals the single process's.

        Returns ``(params, losses)``: detached parameters and the (steps,)
        losses, on the device."""
        if params is None:
            params = self.init(_seed_of(key))
        if mesh is None:
            gen, per_rank = _generator(key, self.device), batch_size
        else:
            from ..parallel._collectives import axis_index, axis_size
            from ..util.seeds import derive_seed

            k = axis_size(mesh)
            if batch_size % k != 0:
                raise ValueError(f"batch_size={batch_size} must divide by mesh size {k}")
            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh ranks on {mesh.device_type}, engine on "
                                 f"{self.device}")
            gen = _generator(derive_seed(_seed_of(key), _COMPILE_TAG, axis_index(mesh)),
                             self.device)
            per_rank = batch_size // k

        def batches():
            for _ in range(steps):
                yield self._gen(gen, per_rank)

        return self._train(params, learning_rate, batches(), log_fn, saver, max(unroll, 1),
                           dro_rho, mesh)

    def dump_traces(self, directory: str, key, n_traces: int, shard_size: int = 4096):
        """Offline compile mode: dump prior-trace shards to disk
        (``compile(..., dump_folder=...)``, ``cpprob.hpp:133-139``)."""
        from ..io.tracefile import dump_traces as _dump

        return _dump(self, directory, key, n_traces, shard_size)

    def compile_offline(
        self,
        loader,
        key=0,
        steps: int = 400,
        learning_rate: float = 1e-3,
        params=None,
        log_fn=None,
        saver=None,
    ):
        """Train from dumped trace shards through a
        :class:`~cpprob_tpu_torch.io.tracefile.TraceLoader` (the native
        mmap + prefetch loader) — the ``RequesterFile`` offline path
        (``client.py:60-91``).  ``key`` seeds the initial net; ``saver``,
        ``log_fn`` and Ctrl-C as in :meth:`compile`.  The loader's batches
        reach the device by a pinned, non-blocking copy."""
        if params is None:
            params = self.init(_seed_of(key))
        # the loaded integer-valued sites back to int64 for the table lookups
        int_sites = {s.addr for s in self.structure.sites if s.discrete_k > 0}

        def batches():
            for _ in range(steps):
                values, obs = loader.next_batch()
                values = {k: to_device(v, self.device) for k, v in values.items()}
                masks = {k[len("__mask__"):]: v for k, v in values.items()
                         if k.startswith("__mask__")}
                values = {k: (v.long() if k in int_sites else v)
                          for k, v in values.items() if not k.startswith("__mask__")}
                if masks:
                    values["__masks__"] = masks
                yield values, to_device(obs, self.device)

        return self._train(params, learning_rate, batches(), log_fn, saver, 1)

    def obs_vector(self, args: Tuple) -> torch.Tensor:
        """The observed values (in observe-site order) flattened into the
        network's observation vector on the engine's device — the
        counterpart of ``StateInfer::send_start_inference``'s flattening
        (``state.hpp:188-207``).  The model runs once, as one particle under
        vmap, so it reads nothing back."""
        if not self.structure.observe_addrs:
            return torch.zeros((1,), device=self.device)
        addrs = self.structure.observe_addrs

        def one(generator):
            tr = handlers.TraceHandler()
            with _nested([handlers.Seed(generator), tr]):
                self.model(*args)
            return torch.cat([torch.ravel(_f32(tr.trace[a]["value"], generator.device))
                              for a in addrs])

        with torch.no_grad():
            return _vmapped(one, _generator(0, self.device), 1)[0]

    def proposal_factory(self, params, args: Tuple, defensive=None):
        """A zero-argument factory of :class:`CSISProposalMessenger` for
        ``sis(..., proposal_messenger=)``: the observation embedding and the
        first LSTM step (the same for every particle) are computed here,
        once."""
        with torch.no_grad():
            obs_emb = embed_observation(params, self.obs_vector(args), self.obs_embedding,
                                        self.obs_shape, self.structure)
            E = params["lstm"][0]["wh"].shape[0]
            x0 = torch.cat([torch.zeros((E,), device=obs_emb.device), obs_emb], -1)
            first_step = nn.lstm_step(params["lstm"], x0, nn.lstm_zero_state(params["lstm"]))
        structure = self.structure

        def factory():
            return CSISProposalMessenger(params, structure, obs_emb, first_step,
                                         defensive=defensive)

        return factory

    def infer(
        self,
        params,
        args: Tuple,
        n_particles: int,
        key,
        mesh=None,
        defensive=None,
        **sis_kwargs,
    ) -> ImportanceResult:
        """Guided importance sampling on the engine's device (``key``: a
        seed or a generator).

        ``defensive``: mixture weight on the PRIOR at every guided site
        (defensive importance sampling, Hesterberg 1995): weights bounded by
        1/defensive where the proposal under-covers, at a (1-defensive)
        efficiency cost where it is right.

        One eager code path: the model may branch on its Python arguments.
        It queues its work without waiting on the host (the rejection
        rounds' flags aside).  ``mesh``: the particles are sharded over a
        particle mesh by :func:`~cpprob_tpu_torch.parallel.sis_sharded` (the
        network replicated on every rank; the result's statistics reduced
        over the mesh); it takes no other ``sis`` option and raises
        ``TypeError`` when given one (the reference drops them)."""
        if mesh is not None:
            if sis_kwargs:
                raise TypeError(f"infer(mesh=) takes no sis options, got "
                                f"{sorted(sis_kwargs)}")
            from ..parallel.sis import sis_sharded

            if mesh.device_type != self.device.type:
                raise ValueError(f"mesh ranks on {mesh.device_type}, engine on "
                                 f"{self.device}")
            factory = self.proposal_factory(params, args, defensive=defensive)
            with torch.no_grad():
                return sis_sharded(self.model, args, n_particles, key, mesh=mesh,
                                   proposal_messenger=factory)
        factory = self.proposal_factory(params, args, defensive=defensive)
        with torch.no_grad():
            return sis(self.model, args, n_particles, key, device=self.device,
                       proposal_messenger=factory, **sis_kwargs)

    def infer_many(
        self,
        params,
        args: Tuple,
        n_particles: int,
        keys,
        defensive=None,
    ) -> ImportanceResult:
        """``len(keys)`` independent guided queries (``keys``: seeds or
        generators): the path of :meth:`infer` once per key, sharing one
        proposal factory, stacked on a leading ``(len(keys),)`` axis.  Each
        query equals :meth:`infer` with its key."""
        factory = self.proposal_factory(params, args, defensive=defensive)
        with torch.no_grad():
            results = [sis(self.model, args, n_particles, k, device=self.device,
                           proposal_messenger=factory) for k in keys]
        return ImportanceResult(
            torch.stack([r.log_weights for r in results]),
            {name: torch.stack([r.predicts[name] for r in results])
             for name in results[0].predicts},
        )

"""Fused SMC kernels for a K-state HMM (1 <= K <= 32) — counterpart of
``cpprob_tpu/ops/pallas_hmm.py`` and of the discrete part of
``cpprob_tpu/ops/pallas_ssm.py``.

Two kernels, CUDA C++ in ``csrc/fused_hmm.cu`` (a register design
instantiated for K = 2..8, a shared-memory design with K at run time for
K = 1 and 9..32):

- ``hmm_init`` (<- ``pallas_hmm_fused_init``, ``_discrete_init``): initial
  states from the initial-state CDF, the t=0 emission weight, one
  statistics record per CTA.
- ``hmm_chunk`` (<- ``pallas_hmm_fused_chunk``, ``_discrete_chunk``): a
  flagged chunk-start exchange resample, ``n_steps`` transition + reweight
  updates with the particles held in registers, and, with
  ``island_every > 0``, an ESS check of every island (one CTA of
  ``ISLAND_SIZE`` particles) every that many steps, which
  exchange-resamples a collapsed island in place.  Launched for one step
  it is also the per-step kernels (<- ``pallas_hmm_fused_step_exchange``,
  ``pallas_hmm_fused_step(_ess)``): see :func:`fused_hmm_hooks`.

- ``guided_chunk`` (K13, <- ``_make_guided_discrete_chunk_kernel(_mxu)``
  behind ``attach_fused_guided_discrete_kernels``): the chunk kernel of a
  guided K-state HMM (1 <= K <= 8), whose categorical proposal net becomes
  K x K tables built once per step of the launch by a tables kernel ahead
  of the chunk kernel (see the note in ``csrc/fused_hmm.cu``); the same
  frame as ``hmm_chunk`` (exchange synthesis, n_valid, islands, records).  With one state the proposal is
  q = 1 and the RN correction 0, so K = 1 launches the unguided chunk
  kernel's run-time-K instance, which computes that chain.  Its hooks:
  :func:`guided_hooks`.

Each has a plain PyTorch version of the same function (``hmm_init_plain``,
``hmm_chunk_plain``, ``guided_chunk_plain``).  The public wrappers take the
plain version for CPU tensors only; on CUDA tensors they launch the kernel or raise.  The plain
versions draw from the same Philox stream as the kernels (``seed``), or
take pinned draws (``draws=``) for parity tests.

Records are ``(n_records, K + 4)`` float32: (max w, sum e, sum e^2, sum e
per state, interior resamples), e = exp(w - max w);
:func:`~.population.stats_from_partials` (imported here too) combines
them into (ess, cat_w, lme), and takes the linear-Gaussian kernel's
3-column records too (one combiner).

``seed``, in every plain version and in :func:`hmm_init` and
:func:`hmm_chunk`, is an integer or a device key (:func:`.philox.device_key`,
two int32 words on the population's device).  The kernels read the key's
words on the card (``csrc/philox.cuh`` ``LaunchKey``; an integer is written
there first, :func:`.philox.launch_key`), so that a captured CUDA graph of
a launch given a device key draws from the key written before each replay;
a plain version reads them on the host.  K13 (:func:`guided_chunk`) takes
an integer, by value.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from ..util.profiling import counter_group, span
from .philox import launch_key, philox_uniform, philox_uniforms4, split_seed
from .population import (check_tensor, current_stream, launch_population,
                         mlp_layers, raise_on, stats_from_partials,
                         takes_device_key)

__all__ = [
    "HMMSpec", "ISLAND_SIZE", "LAUNCHES", "hmm_init", "hmm_init_plain",
    "hmm_chunk", "hmm_chunk_plain", "stats_from_partials",
    "make_fused_hmm_ssm", "fused_hmm_hooks", "MAX_K", "GUIDED_MAX_K",
    "GuidedTables", "guided_tables_plain", "guided_chunk_plain",
    "guided_chunk", "guided_hooks", "GUIDED_MAX_LAYERS", "GUIDED_ACT_BYTES",
    "guided_max_width", "guided_tables", "init_uniforms", "INIT_STREAM", "ISLAND_STREAM",
    "TRANSITION_STREAM",
]

ISLAND_SIZE = 4096       # 256 threads x 16 particles: one CTA of the chunk kernel
# the third Philox counter word of each draw (csrc/fused_hmm.cu): the initial
# states of four particles (particle >> 2, 0, 0, 0), word particle & 3 for
# the particle, an island's offset (island, t, 1, 0), and the transition
# uniforms of four absolute steps (particle, t >> 2, 2, 0), word t & 3 for
# step t
INIT_STREAM, ISLAND_STREAM, TRANSITION_STREAM = 0, 1, 2
_THREADS = 256
MAX_K = 32               # states the kernels take (csrc/fused_hmm.cu kMaxK)
GUIDED_MAX_K = 8         # states the guided kernel takes
GUIDED_MAX_LAYERS = 32   # csrc/fused_hmm.cu kGuidedMaxLayers
# shared memory for the net's activations in the tables kernel, two buffers
# of K x (widest layer) float32 (csrc/fused_hmm.cu kGuidedActBytes): what one
# CTA may hold (227 KB) less 3 KB
GUIDED_ACT_BYTES = 232448 - 3072

# kernel launches by wrapper, counted where each kernel is launched; a
# one-step launch of the chunk kernel (the per-step hooks) counts under
# "step_exchange", "step_ess" or "step" instead of "chunk", and those of
# the guided kernel under "guided_step_exchange" or "guided_step_ess"; every
# guided launch is preceded by one of the tables kernel ("guided_tables")
LAUNCHES = counter_group("fused_hmm", (
    "init", "chunk", "step_exchange", "step_ess", "step", "guided_chunk",
    "guided_step_exchange", "guided_step_ess", "guided_tables"))


@dataclasses.dataclass(frozen=True, eq=False)
class HMMSpec:
    """A K-state HMM with Gaussian emissions as the kernels' tables
    (float32 numpy arrays); build one with
    :func:`cpprob_tpu_torch.interop.spec_from_numpy`."""

    trans_cdf: np.ndarray      # (K, K-1) cumulative transition rows
    means: np.ndarray          # (K,)
    half_inv_var: np.ndarray   # (K,) 0.5 / sigma^2
    log_norm: np.ndarray       # (K,) -log sigma - 0.5 log(2 pi)
    init_cdf: np.ndarray       # (K-1,) cumulative initial-state probabilities
    _device_tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def K(self) -> int:
        return self.means.shape[0]

    def packed(self) -> np.ndarray:
        """The tables in the kernels' layout (see csrc/fused_hmm.cu)."""
        return np.concatenate([
            self.trans_cdf.ravel(), self.means, self.half_inv_var,
            self.log_norm, self.init_cdf,
        ]).astype(np.float32)

    def tables(self, device) -> dict:
        """Torch copies of the tables on ``device``, made once per device so
        that no launch copies from the host."""
        device = torch.device(device)
        if device not in self._device_tables:
            t = lambda a: torch.as_tensor(a, device=device)
            self._device_tables[device] = {
                "packed": t(self.packed()),
                "trans_cdf": t(self.trans_cdf),
                "means": t(self.means),
                "half_inv_var": t(self.half_inv_var),
                "log_norm": t(self.log_norm),
                "init_cdf": t(self.init_cdf),
            }
        return self._device_tables[device]


@dataclasses.dataclass(frozen=True, eq=False)
class GuidedTables:
    """What the guided kernel reads besides the model's :class:`HMMSpec`:
    the transition log-probabilities and a ``kind="discrete"`` proposal
    net (layers ``[K + 2, H.., K]``, float32 numpy) with its horizon ``T``
    (the feature t/T).  Build one with :meth:`from_params`."""

    log_trans: np.ndarray      # (K, K)
    Ws: tuple                  # (in, out) per layer
    bs: tuple                  # (out,) per layer
    T: int
    _device_tables: dict = dataclasses.field(default_factory=dict, repr=False)

    @classmethod
    def from_params(cls, log_trans, params, T: int) -> "GuidedTables":
        """Check the net (``ValueError``: inputs other than ``[onehot(K),
        y, t/T]``, outputs other than K logits, layers that do not chain or
        exceed the kernel's limits) and take float32 copies."""
        log_trans = np.ascontiguousarray(log_trans, np.float32)
        K = log_trans.shape[0]
        Ws, bs = mlp_layers(params)
        if Ws[0].shape[0] != K + 2 or Ws[-1].shape[1] != K:
            raise ValueError(
                f"expected an smc_csis 'discrete' proposal net: inputs "
                f"[onehot({K}), y, t/T], outputs {K} logits")
        if len(Ws) > GUIDED_MAX_LAYERS:
            raise ValueError(f"the guided kernel takes at most "
                             f"{GUIDED_MAX_LAYERS} layers, got {len(Ws)}")
        widest = max(W.shape[1] for W in Ws)
        if widest > guided_max_width(K):
            raise ValueError(
                f"the guided tables kernel keeps the net's activations in "
                f"{GUIDED_ACT_BYTES} B of shared memory, which holds layers of "
                f"at most {guided_max_width(K)} units at K = {K}; got {widest}")
        return cls(log_trans, tuple(Ws), tuple(bs), int(T))

    @property
    def dims(self) -> list:
        return [self.Ws[0].shape[0]] + [W.shape[1] for W in self.Ws]

    def tables(self, device) -> dict:
        """Torch copies on ``device``, made once per device: ``net`` (the
        kernel's packed layers: W row-major then b, layer after layer),
        ``log_trans``, and the layers as lists ``Ws``, ``bs``."""
        device = torch.device(device)
        if device not in self._device_tables:
            t = lambda a: torch.as_tensor(a, device=device)
            packed = np.concatenate([a.ravel() for W, b in zip(self.Ws, self.bs)
                                     for a in (W, b)])
            self._device_tables[device] = {
                "net": t(packed), "log_trans": t(self.log_trans),
                "Ws": [t(W) for W in self.Ws], "bs": [t(b) for b in self.bs],
            }
        return self._device_tables[device]


def guided_max_width(K: int) -> int:
    """The widest layer the guided kernels take at K states: two buffers of
    K x width float32 activations in ``GUIDED_ACT_BYTES``."""
    return GUIDED_ACT_BYTES // (2 * K * 4)


# --------------------------------------------------------------------------
# plain versions


def _emission(tab: dict, y: torch.Tensor) -> torch.Tensor:
    """(K,) emission log-densities at ``y``, rounded as the kernels do."""
    d = y - tab["means"]
    return tab["log_norm"] - tab["half_inv_var"] * d * d


def _records(w2: torch.Tensor, s2: torch.Tensor, K: int,
             count: torch.Tensor) -> torch.Tensor:
    """Per-row records of (rows, L) weights and states."""
    m = w2.amax(1)
    e = torch.exp(w2 - m[:, None])
    cols = [m, e.sum(1), (e * e).sum(1)]
    cols += _category_sums(e, s2, K).unbind(1)
    cols.append(count.to(torch.float32))
    return torch.stack(cols, 1)


def _category_sums(e: torch.Tensor, s2: torch.Tensor, n_cat: int) -> torch.Tensor:
    """(rows, n_cat) sums of the (rows, L) ``e`` per state k < n_cat."""
    if n_cat == 0:
        return e.new_zeros((e.shape[0], 0))
    return torch.stack([(e * (s2 == k)).sum(1) for k in range(n_cat)], 1)


def init_uniforms(seed: int, n: int, device) -> torch.Tensor:
    """(n,) float32 initial uniforms as the init kernels draw them: that of
    particle g is word g & 3 of Philox at counter (g >> 2, 0, INIT_STREAM,
    0), four particles a call."""
    quads = torch.arange(-(-n // 4), device=device)
    return philox_uniforms4(seed, quads, 0, INIT_STREAM).t().reshape(-1)[:n]


def hmm_init_plain(seed: int, y0: torch.Tensor, n: int, spec: HMMSpec, *,
                   draws: torch.Tensor | None = None):
    """Plain version of the init kernel.  ``draws``: (n,) float32
    uniforms in place of Philox (:func:`init_uniforms`).  Returns (states
    int32 (n,), log_w float32 (n,), records (1, K+4))."""
    dev = y0.device
    tab = spec.tables(dev)
    u = draws if draws is not None else init_uniforms(seed, n, dev)
    s = (u[:, None] >= tab["init_cdf"][None, :]).sum(1)
    w = _emission(tab, y0)[s]
    rec = _records(w[None], s[None], spec.K, torch.zeros(1, device=dev))
    return s.to(torch.int32), w, rec


def hmm_chunk_plain(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                    ys: torch.Tensor, ctrl: torch.Tensor, spec: HMMSpec, *,
                    t0: int = 1, island_every: int = 0,
                    island_thresh: float = 0.5,
                    island_size: int = ISLAND_SIZE, draws=None):
    """Plain version of the chunk kernel.  ``ctrl``: int32 [flag, ticks
    (K-1), n_valid]; ``t0``: absolute time of the chunk's first step (the
    Philox counters: the uniform of step t is word ``t & 3`` of particle
    g's counter ``(g, t >> 2, TRANSITION_STREAM, 0)``, so the draws do not
    depend on the chunking).  ``draws``: ``(u, u0)`` with ``u`` (n_steps, n) the
    transition uniforms and ``u0`` (n_checks, n_islands) the island offsets,
    in place of Philox.  Returns (states int32, log_w float32, records
    (n / island_size, K+4))."""
    tab = spec.tables(states.device)

    def move(t, s, u):
        ns = (u[:, None] >= tab["trans_cdf"][s]).sum(1)
        return ns, _emission(tab, ys[t])[ns]

    return _chunk_plain(seed, states, log_w, ys.shape[0], ctrl, spec.K, move,
                        t0=t0, island_every=island_every,
                        island_thresh=island_thresh, island_size=island_size,
                        draws=draws)


def _chunk_plain(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                 n_steps: int, ctrl: torch.Tensor, K: int, move, *, t0: int,
                 island_every: int, island_thresh: float, island_size: int,
                 draws):
    """The chunk kernels' frame (exchange synthesis, n_valid masking,
    island checks, records) around ``move(t, states, u) -> (next states,
    weight increment)``, the step of the chain."""
    n = states.shape[0]
    n_isl = n // island_size
    dev = states.device
    flag, ticks, n_valid = ctrl[0] > 0, ctrl[1:K].long(), ctrl[K]
    g = torch.arange(n, device=dev)
    s = torch.where(flag, (g[:, None] >= ticks[None, :]).sum(1), states.long())
    w = torch.where(flag, torch.zeros_like(log_w), log_w)
    count = torch.zeros(n_isl, device=dev)
    n_blk = float(island_size)
    j_local = torch.arange(island_size, device=dev)
    n_check = 0
    group = None
    for t in range(n_steps):
        valid = t < n_valid
        ta = t0 + t
        if draws is None and (group is None or ta & 3 == 0):
            # the four uniforms of the group of absolute steps holding ta
            group = philox_uniforms4(seed, g, ta >> 2, TRANSITION_STREAM)
        u = draws[0][t] if draws is not None else group[ta & 3]
        ns, dw = move(t, s, u)
        nw = w + dw
        s = torch.where(valid, ns, s)
        w = torch.where(valid, nw, w)
        if island_every > 0 and (t + 1) % island_every == 0 and t < n_steps - 1:
            w2, s2 = w.view(n_isl, island_size), s.view(n_isl, island_size)
            m = w2.amax(1)
            e = torch.exp(w2 - m[:, None])
            se, se2 = e.sum(1), (e * e).sum(1)
            collapse = (se * se < island_thresh * n_blk * se2) & (t + 1 < n_valid)
            u0 = draws[1][n_check] if draws is not None else philox_uniform(
                seed, torch.arange(n_isl, device=dev), t0 + t, ISLAND_STREAM)
            n_check += 1
            cum = torch.cumsum(_category_sums(e, s2, K - 1), 1)
            tk = torch.clamp(torch.ceil(n_blk * (cum / se[:, None]) - u0[:, None]),
                             0.0, n_blk)
            rs = (j_local[None, :, None] >= tk[:, None, :]).sum(-1)
            lme_b = m + torch.log(se) - math.log(n_blk)
            s = torch.where(collapse[:, None], rs, s2).reshape(n)
            w = torch.where(collapse[:, None], lme_b[:, None], w2).reshape(n)
            count = count + collapse
    rec = _records(w.view(n_isl, island_size), s.view(n_isl, island_size),
                   K, count)
    return s.to(torch.int32), w, rec


def guided_tables_plain(tab: dict, gtab: dict, y: torch.Tensor,
                        tf: torch.Tensor):
    """The guided kernel's tables at one step, in its order of operations:
    ``(cum (K, K), ssum (K,), rn (K, K))`` with ``cum[a, k]`` the running
    sums of exp(l_ak - m_a) over k, ``ssum = cum[:, K-1]`` and ``rn[a, b] =
    log_trans[a, b] + (log g(y | b) - (l_ab - m_a - log ssum_a))``.
    ``tab``/``gtab``: the device tables of the spec and of the
    :class:`GuidedTables`; ``y``, ``tf``: float32 scalars."""
    Ws, bs = gtab["Ws"], gtab["bs"]
    K = gtab["log_trans"].shape[0]
    W0 = Ws[0]
    # layer 0: the one-hot input selects row a of W0
    act = W0[:K] + (W0[K] * y + W0[K + 1] * tf + bs[0])[None, :]
    for W, b in zip(Ws[1:], bs[1:]):
        act = torch.relu(act)
        acc = b[None, :] + act[:, 0, None] * W[0][None, :]
        for i in range(1, W.shape[0]):
            acc = acc + act[:, i, None] * W[i][None, :]
        act = acc
    m = act.amax(1, keepdim=True)
    e = torch.exp(act - m)
    sums = [e[:, 0]]
    for k in range(1, K):
        sums.append(sums[-1] + e[:, k])
    cum = torch.stack(sums, 1)
    ssum = cum[:, K - 1]
    lq = (act - m) - torch.log(ssum)[:, None]
    rn = gtab["log_trans"] + (_emission(tab, y)[None, :] - lq)
    return cum, ssum, rn


def guided_chunk_plain(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                       ys: torch.Tensor, ctrl: torch.Tensor, spec: HMMSpec,
                       gt: GuidedTables, *, t0: int = 1, island_every: int = 0,
                       island_thresh: float = 0.5,
                       island_size: int = ISLAND_SIZE, draws=None):
    """Plain version of the guided chunk kernel (K13): arguments and
    results as :func:`hmm_chunk_plain`, with the proposal net and the
    transition log-probabilities in ``gt``.  Per step the tables of
    :func:`guided_tables_plain`; a particle in state a with uniform u moves
    to b = #{k < K-1 : cum[a, k] <= u ssum[a]} and adds rn[a, b]."""
    dev = states.device
    tab, gtab = spec.tables(dev), gt.tables(dev)
    K = spec.K
    steps = {}

    def move(t, s, u):
        if t not in steps:
            tf = torch.tensor(float(t0 + t), dtype=torch.float32,
                              device=dev) / float(gt.T)
            steps[t] = guided_tables_plain(tab, gtab, ys[t], tf)
        cum, ssum, rn = steps[t]
        target = u * ssum[s]
        ns = (cum[s, :K - 1] <= target[:, None]).sum(1)
        return ns, rn[s, ns]

    return _chunk_plain(seed, states, log_w, ys.shape[0], ctrl, K, move,
                        t0=t0, island_every=island_every,
                        island_thresh=island_thresh, island_size=island_size,
                        draws=draws)


# --------------------------------------------------------------------------
# kernels


def _lib():
    from ._build import load_library

    lib = load_library("fused_hmm")
    if lib.hmm_chunk_launch.argtypes is None:
        p, i, u32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.hmm_island_size.argtypes = []
        lib.hmm_island_size.restype = i
        lib.hmm_max_k.argtypes = []
        lib.hmm_max_k.restype = i
        lib.hmm_init_launch.argtypes = [
            i, p, p, p, p, p, p, ctypes.c_longlong, i, p]
        lib.hmm_init_launch.restype = i
        lib.hmm_chunk_launch.argtypes = [
            i, p, p, i, p, p, u32, i, f, p, p, p, p, p,
            ctypes.c_longlong, p]
        lib.hmm_chunk_launch.restype = i
        lib.guided_max_layers.argtypes = []
        lib.guided_max_layers.restype = i
        lib.guided_act_bytes.argtypes = []
        lib.guided_act_bytes.restype = i
        _guided_argtypes(lib)
        if (lib.hmm_island_size() != ISLAND_SIZE or lib.hmm_max_k() != MAX_K
                or lib.guided_max_layers() != GUIDED_MAX_LAYERS
                or lib.guided_act_bytes() != GUIDED_ACT_BYTES):
            raise RuntimeError("csrc/fused_hmm.cu island size or limits differ "
                               f"from ISLAND_SIZE={ISLAND_SIZE}, MAX_K={MAX_K}, "
                               f"guided {GUIDED_MAX_LAYERS} layers in "
                               f"{GUIDED_ACT_BYTES} B")
    return lib


def _guided_argtypes(lib):
    """The ctypes signatures of the guided launches of ``lib`` (the port's
    ``fused_hmm`` library or a variant of its source)."""
    p, i, u32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    dims = ctypes.POINTER(ctypes.c_int)
    lib.guided_tables_launch.argtypes = [i, p, p, p, i, dims, f, p, i, p, u32,
                                         p, p]
    lib.guided_tables_launch.restype = i
    lib.guided_chunk_launch.argtypes = [i, p, i, p, u32, u32, u32, i, f, p, p, p,
                                        p, p, ctypes.c_longlong, p]
    lib.guided_chunk_launch.restype = i


def _check_k(spec: HMMSpec):
    if not 1 <= spec.K <= MAX_K:
        raise ValueError(f"the fused HMM kernels take 1 <= K <= {MAX_K} states, "
                         f"got {spec.K}")


def _init_grid(device, n: int) -> int:
    """CTAs of an init launch: a thread a quad of particles, at most 8 CTAs
    an SM in a grid-stride loop."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // (4 * _THREADS)), 8 * sms))


def hmm_init(seed: int, y0: torch.Tensor, n: int, spec: HMMSpec):
    """Fused init on the device of ``y0`` (0-d float32): the kernel on a
    CUDA tensor, the plain version on a CPU tensor.  Returns (states,
    log_w, records)."""
    dev = y0.device
    if dev.type == "cpu":
        return hmm_init_plain(seed, y0, n, spec)
    if dev.type != "cuda":
        raise ValueError(f"hmm_init runs on cpu or cuda tensors, not {dev}")
    _check_k(spec)
    if not 0 < n < 2 ** 32:
        raise ValueError(f"n must be in (0, 2^32), got {n}")
    tab = spec.tables(dev)["packed"]
    grid = _init_grid(dev, n)

    def launch(states, log_w, rec):
        return _lib().hmm_init_launch(
            spec.K, tab.data_ptr(), y0.data_ptr(), launch_key(seed, dev),
            states.data_ptr(), log_w.data_ptr(), rec.data_ptr(), n, grid,
            current_stream(dev))

    return launch_population(
        "hmm_init_kernel", launch, span_name="launch.hmm_init_kernel", device=dev,
        inputs=[(y0, "y0", torch.float32)],
        outputs=[(n, torch.int32), (n, torch.float32)],
        records=(grid, spec.K + 4), counts=LAUNCHES, count_key="init")


def hmm_chunk(seed: int, states: torch.Tensor, log_w: torch.Tensor,
              ys: torch.Tensor, ctrl: torch.Tensor, spec: HMMSpec, *,
              t0: int = 1, island_every: int = 0, island_thresh: float = 0.5,
              count_key: str = "chunk"):
    """Fused chunk on the device of ``states``, with islands of
    ``ISLAND_SIZE`` particles: the kernel on CUDA tensors, the plain
    version on CPU tensors (arguments as :func:`hmm_chunk_plain`).
    ``count_key``: the entry of :data:`LAUNCHES` the launch counts under.
    Returns (states, log_w, records)."""
    dev = states.device
    n, K = states.shape[0], spec.K
    if states.dim() != 1 or n % ISLAND_SIZE != 0:
        raise ValueError(f"states must be (n,) with n a multiple of "
                         f"ISLAND_SIZE={ISLAND_SIZE}, got {tuple(states.shape)}")
    if ctrl.shape != (K + 1,):
        raise ValueError(f"ctrl must be [flag, {K - 1} ticks, n_valid]")
    if dev.type == "cpu":
        return hmm_chunk_plain(
            seed, states, log_w, ys, ctrl, spec, t0=t0,
            island_every=island_every, island_thresh=island_thresh)
    if dev.type != "cuda":
        raise ValueError(f"hmm_chunk runs on cpu or cuda tensors, not {dev}")
    _check_k(spec)
    if log_w.shape != states.shape:
        raise ValueError("log_w must have the shape of states")
    if n >= 2 ** 31 or t0 < 0 or t0 + ys.shape[0] >= 2 ** 32:
        raise ValueError("n must be < 2^31 and t0 + n_steps < 2^32")
    tab = spec.tables(dev)["packed"]
    def launch(out_s, out_w, rec):
        return _lib().hmm_chunk_launch(
            K, tab.data_ptr(), ys.data_ptr(), ys.shape[0], ctrl.data_ptr(),
            launch_key(seed, dev), t0, island_every, island_thresh,
            states.data_ptr(), log_w.data_ptr(), out_s.data_ptr(),
            out_w.data_ptr(), rec.data_ptr(), n, current_stream(dev))

    return launch_population(
        "hmm_chunk_kernel", launch, span_name="launch.hmm_chunk_kernel", device=dev,
        inputs=[(states, "states", torch.int32), (log_w, "log_w", torch.float32),
                (ys, "ys", torch.float32), (ctrl, "ctrl", torch.int32)],
        outputs=[(n, torch.int32), (n, torch.float32)],
        records=(n // ISLAND_SIZE, K + 4), counts=LAUNCHES, count_key=count_key)


def _net_args(spec: HMMSpec, gt: GuidedTables, dev) -> tuple:
    """The leading arguments of the tables launch: K, the model's and the
    net's device tables, and the net's layer sizes and horizon."""
    dims = gt.dims
    gtab = gt.tables(dev)
    return (spec.K, spec.tables(dev)["packed"].data_ptr(),
            gtab["log_trans"].data_ptr(), gtab["net"].data_ptr(), len(dims) - 1,
            (ctypes.c_int * len(dims))(*dims), float(gt.T))


def guided_tables(ys: torch.Tensor, ctrl: torch.Tensor, spec: HMMSpec,
                  gt: GuidedTables, *, t0: int = 1) -> torch.Tensor:
    """The guided kernel's tables of each step of a launch whose first step
    is absolute step ``t0`` (observations ``ys``), as (n_steps, 2K^2 + K)
    float32 rows ``cum (K x K) | ssum (K) | rn (K x K)``: the tables kernel
    on CUDA tensors (one CTA a step; rows at and past n_valid = ``ctrl[K]``
    are left unwritten), the stacked :func:`guided_tables_plain` on CPU
    tensors."""
    dev, K, n_steps = ys.device, spec.K, ys.shape[0]
    if dev.type == "cpu":
        tab, gtab = spec.tables(dev), gt.tables(dev)
        rows = []
        for t in range(n_steps):
            tf = torch.tensor(float(t0 + t), dtype=torch.float32) / float(gt.T)
            cum, ssum, rn = guided_tables_plain(tab, gtab, ys[t], tf)
            rows.append(torch.cat([cum.reshape(-1), ssum, rn.reshape(-1)]))
        return torch.stack(rows)
    if dev.type != "cuda":
        raise ValueError(f"guided_tables runs on cpu or cuda tensors, not {dev}")
    if not 2 <= K <= GUIDED_MAX_K:
        raise ValueError(f"the guided tables kernel takes 2 <= K <= {GUIDED_MAX_K}")
    with span("launch.guided_tables_kernel"):
        for t, name, dtype in ((ys, "ys", torch.float32), (ctrl, "ctrl", torch.int32)):
            check_tensor(t, name, dtype, dev)
        tabs = torch.empty((n_steps, 2 * K * K + K), device=dev)
        raise_on(_lib().guided_tables_launch(
            *_net_args(spec, gt, dev), ys.data_ptr(), n_steps, ctrl.data_ptr(), t0,
            tabs.data_ptr(), current_stream(dev)), "guided_tables_kernel")
    LAUNCHES["guided_tables"] += 1
    return tabs


def guided_chunk(seed: int, states: torch.Tensor, log_w: torch.Tensor,
                 ys: torch.Tensor, ctrl: torch.Tensor, spec: HMMSpec,
                 gt: GuidedTables, *, t0: int = 1, island_every: int = 0,
                 island_thresh: float = 0.5, count_key: str = "guided_chunk"):
    """Guided chunk (K13) on the device of ``states``: on CUDA tensors the
    tables kernel (:func:`guided_tables`) and the chunk kernel, which reads
    them; :func:`guided_chunk_plain` on CPU tensors (arguments as there;
    islands of ``ISLAND_SIZE``).  At K = 1 (q = 1, no RN correction) the
    launch is the unguided chunk kernel's, the same chain.  ``count_key``:
    the entry of :data:`LAUNCHES` the launch counts under.  Returns
    (states, log_w, records)."""
    dev = states.device
    n, K = states.shape[0], spec.K
    if states.dim() != 1 or n % ISLAND_SIZE != 0:
        raise ValueError(f"states must be (n,) with n a multiple of "
                         f"ISLAND_SIZE={ISLAND_SIZE}, got {tuple(states.shape)}")
    if ctrl.shape != (K + 1,):
        raise ValueError(f"ctrl must be [flag, {K - 1} ticks, n_valid]")
    if gt.log_trans.shape != (K, K):
        raise ValueError("the guided tables are for another number of states")
    if dev.type == "cpu":
        return guided_chunk_plain(
            seed, states, log_w, ys, ctrl, spec, gt, t0=t0,
            island_every=island_every, island_thresh=island_thresh)
    if dev.type != "cuda":
        raise ValueError(f"guided_chunk runs on cpu or cuda tensors, not {dev}")
    if not 1 <= K <= GUIDED_MAX_K:
        raise ValueError(f"the guided kernel takes 1 <= K <= {GUIDED_MAX_K}")
    if log_w.shape != states.shape:
        raise ValueError("log_w must have the shape of states")
    if n >= 2 ** 31 or t0 < 0 or t0 + ys.shape[0] >= 2 ** 24:
        raise ValueError("n must be < 2^31 and t0 + n_steps < 2^24 (t/T is "
                         "formed in float32)")
    if K == 1:
        return hmm_chunk(seed, states, log_w, ys, ctrl, spec, t0=t0,
                         island_every=island_every, island_thresh=island_thresh,
                         count_key=count_key)
    k0, k1 = split_seed(seed)
    # the launch's tables (one CTA a step), then the chunk kernel reading them
    tabs = guided_tables(ys, ctrl, spec, gt, t0=t0)

    def launch(out_s, out_w, rec):
        return _lib().guided_chunk_launch(
            K, tabs.data_ptr(), ys.shape[0], ctrl.data_ptr(), k0, k1, t0,
            island_every, island_thresh, states.data_ptr(), log_w.data_ptr(),
            out_s.data_ptr(), out_w.data_ptr(), rec.data_ptr(), n,
            current_stream(dev))

    return launch_population(
        "guided_chunk_kernel", launch, span_name="launch.guided_chunk_kernel",
        device=dev,
        inputs=[(states, "states", torch.int32), (log_w, "log_w", torch.float32),
                (ys, "ys", torch.float32), (ctrl, "ctrl", torch.int32)],
        outputs=[(n, torch.int32), (n, torch.float32)],
        records=(n // ISLAND_SIZE, K + 4), counts=LAUNCHES, count_key=count_key)


def fused_hmm_hooks(spec: HMMSpec, island_every: int = 0,
                    island_thresh: float = 0.5,
                    island_counts: list | None = None) -> dict:
    """The fused hooks of a model whose tables are ``spec``, all launches
    of :func:`hmm_init` and :func:`hmm_chunk`; ``key`` in each hook is the
    sweep's integer seed or its device key (``ops.philox.device_key``):
    but for ``fused_step_batch`` the hooks are marked
    ``takes_device_key``, unless ``island_counts`` is given (each launch
    appends to it on the host, which a replay would not).

    - ``fused_init_batch`` (K1/K9) and the time-aware chunk hook
      ``fused_chunk_exchange_t_batch`` (K2/K3/K8): the Philox counters run
      on absolute time, so the sweep's launches never reuse a draw;
    - the per-step hooks, one-step launches of the chunk kernel at
      ``t0 = t``, the absolute step: ``fused_step_exchange_batch`` (K4,
      ctrl ``[flag, ticks, 1]``, returning ``(s, w, ess, cat_w, lme)``),
      ``fused_step_ess_batch`` (K5, flag 0, returning ``(s, w, ess)``) and
      ``fused_step_batch`` (returning ``(s, w)``).

    ``island_every`` > 0: every that many interior steps of a chunk each
    island of ``ISLAND_SIZE`` particles checks its ESS and
    exchange-resamples itself on collapse below ``island_thresh``.
    ``island_counts``: a list to which each chunk launch appends its
    interior resamples per island (a float32 device tensor; no host sync).
    No step waits on the host: the constant control words are made once per
    device, by device fills."""
    def fused_init(key, n, y0):
        s, w, rec = hmm_init(key, y0, n, spec)
        return (s, w, *stats_from_partials(rec, n))

    def chunk(key, states, log_w, ys, ctrl, **kw):
        return hmm_chunk(key, states, log_w, ys, ctrl, spec, **kw)

    keyed = island_counts is None
    hooks, ctrl_tail = _exchange_hooks(
        spec.K, chunk, ("chunk", "step_exchange", "step_ess"), island_every,
        island_thresh, island_counts, device_key=keyed)

    def fused_step(key, states, log_w, y, t):
        s, w, _ = chunk(key, states, log_w, y.reshape(1).to(torch.float32),
                        ctrl_tail(states.device)[0], t0=int(t), count_key="step")
        return s, w

    return dict(fused_init_batch=takes_device_key(fused_init) if keyed else fused_init,
                fused_step_batch=fused_step, **hooks)


def guided_hooks(spec: HMMSpec, log_trans, params, T: int,
                 island_every: int = 0, island_thresh: float = 0.5,
                 island_counts: list | None = None) -> dict:
    """The fused hooks of a guided K-state HMM, all launches of
    :func:`guided_chunk` (the net ``params`` with horizon ``T`` and the
    transition log-probabilities ``log_trans`` checked by
    :meth:`GuidedTables.from_params`): the time-aware chunk hook
    ``fused_chunk_exchange_t_batch`` and the one-step launches
    ``fused_step_exchange_batch`` and ``fused_step_ess_batch``, with the
    signatures and island arguments of :func:`fused_hmm_hooks`."""
    gt = GuidedTables.from_params(log_trans, params, T)

    def chunk(key, states, log_w, ys, ctrl, **kw):
        return guided_chunk(key, states, log_w, ys, ctrl, spec, gt, **kw)

    return _exchange_hooks(
        spec.K, chunk, ("guided_chunk", "guided_step_exchange", "guided_step_ess"),
        island_every, island_thresh, island_counts)[0]


def _exchange_hooks(K: int, chunk, keys, island_every: int,
                    island_thresh: float, island_counts,
                    device_key: bool = False) -> tuple:
    """``(hooks, ctrl_tail)``: the chunk hook (with the island checks) and
    the two one-step exchange hooks (without) around ``chunk(key, states,
    log_w, ys, ctrl, t0=, count_key=, island_every=, island_thresh=)``,
    counted under ``keys`` (chunk, step with exchange, step with ESS), each
    marked ``takes_device_key`` where ``device_key``, and
    ``ctrl_tail(device)``, the constant control words (made once per device,
    by device fills, so no step waits on the host)."""
    consts: dict = {}

    def ctrl_tail(device):
        # (zero ticks (K-1), n_valid 1) and n_valid 1 alone, int32, on device
        if device not in consts:
            one = torch.ones(1, dtype=torch.int32, device=device)
            consts[device] = (torch.cat([torch.zeros(K, dtype=torch.int32,
                                                     device=device), one]), one)
        return consts[device]

    def fused_chunk(key, states, log_w, ys, n_valid, flag, ticks, t0):
        ctrl = torch.cat([flag.reshape(1), ticks.reshape(-1),
                          n_valid.reshape(1)]).to(torch.int32)
        s, w, rec = chunk(key, states, log_w, ys, ctrl, t0=t0, count_key=keys[0],
                          island_every=island_every, island_thresh=island_thresh)
        if island_counts is not None:
            island_counts.append(rec[:, -1])
        return (s, w, *stats_from_partials(rec, states.shape[0]))

    def step(key, states, log_w, y, t, ctrl, count_key):
        return chunk(key, states, log_w, y.reshape(1).to(torch.float32), ctrl,
                     t0=int(t), count_key=count_key)

    def fused_step_exchange(key, states, log_w, y, t, flag, ticks):
        ctrl = torch.cat([flag.reshape(1), ticks.reshape(-1),
                          ctrl_tail(states.device)[1]]).to(torch.int32)
        s, w, rec = step(key, states, log_w, y, t, ctrl, keys[1])
        return (s, w, *stats_from_partials(rec, states.shape[0]))

    def fused_step_ess(key, states, log_w, y, t):
        s, w, rec = step(key, states, log_w, y, t, ctrl_tail(states.device)[0],
                         keys[2])
        return s, w, stats_from_partials(rec, states.shape[0])[0]

    hooks = dict(
        fused_chunk_exchange_t_batch=fused_chunk,
        fused_step_exchange_batch=fused_step_exchange,
        fused_step_ess_batch=fused_step_ess,
    )
    if device_key:
        hooks = {name: takes_device_key(hook) for name, hook in hooks.items()}
    return hooks, ctrl_tail


def make_fused_hmm_ssm(island_every: int = 0, island_thresh: float = 0.5,
                       spec: HMMSpec | None = None,
                       island_counts: list | None = None):
    """``hmm_ssm`` with the fused kernels installed as its hooks (see
    :func:`fused_hmm_hooks` for the hooks and the island arguments), the
    counterpart of ``make_pallas_hmm_ssm``."""
    from ..interop import spec_from_numpy
    from ..models.hmm import HMM_MEANS, HMM_TRANS, hmm_ssm

    if spec is None:
        spec = spec_from_numpy(HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3))
    return dataclasses.replace(
        hmm_ssm, **fused_hmm_hooks(spec, island_every, island_thresh,
                                   island_counts))

"""Fused SMC kernels for the HMM — counterpart of ``cpprob_tpu/ops/pallas_hmm.py``.

Two kernels, CUDA C++ in ``csrc/fused_hmm.cu``:

- ``hmm_init`` (<- ``pallas_hmm_fused_init``): initial states from the
  initial-state CDF, the t=0 emission weight, one statistics record per CTA.
- ``hmm_chunk`` (<- ``pallas_hmm_fused_chunk``): a flagged chunk-start
  exchange resample, ``n_steps`` transition + reweight updates with the
  particles held in registers, and, with ``island_every > 0``, an ESS check
  of every island (one CTA of ``ISLAND_SIZE`` particles) every that many
  steps, which exchange-resamples a collapsed island in place.

Each has a plain PyTorch version of the same function (``hmm_init_plain``,
``hmm_chunk_plain``).  The public wrappers take the plain version for CPU
tensors only; on CUDA tensors they launch the kernel or raise.  The plain
versions draw from the same Philox stream as the kernels (``seed``), or
take pinned draws (``draws=``) for parity tests.

Records are ``(n_records, K + 4)`` float32: (max w, sum e, sum e^2, sum e
per state, interior resamples), e = exp(w - max w);
:func:`stats_from_partials` combines them into (ess, cat_w, lme), and
takes the linear-Gaussian kernel's 3-column records too (one combiner).
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

import numpy as np
import torch

from .philox import philox_uniform, split_seed

__all__ = [
    "HMMSpec", "ISLAND_SIZE", "LAUNCHES", "hmm_init", "hmm_init_plain",
    "hmm_chunk", "hmm_chunk_plain", "stats_from_partials",
    "make_fused_hmm_ssm",
]

ISLAND_SIZE = 4096       # 256 threads x 16 particles: one CTA of the chunk kernel
_THREADS = 256
_MAX_K = 8
_KERNEL_K = (3,)         # instantiated in csrc/fused_hmm.cu

# kernel launches by wrapper, counted where each kernel is launched
LAUNCHES = {"init": 0, "chunk": 0}


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
    cols += [(e * (s2 == k)).sum(1) for k in range(K)]
    cols.append(count.to(torch.float32))
    return torch.stack(cols, 1)


def hmm_init_plain(seed: int, y0: torch.Tensor, n: int, spec: HMMSpec, *,
                   draws: torch.Tensor | None = None):
    """Plain version of the init kernel.  ``draws``: (n,) float32
    uniforms in place of Philox counter (index, 0, 0).  Returns (states
    int32 (n,), log_w float32 (n,), records (1, K+4))."""
    dev = y0.device
    tab = spec.tables(dev)
    u = draws if draws is not None else philox_uniform(
        seed, torch.arange(n, device=dev), 0, 0)
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
    Philox counter).  ``draws``: ``(u, u0)`` with ``u`` (n_steps, n) the
    transition uniforms and ``u0`` (n_checks, n_islands) the island offsets,
    in place of Philox.  Returns (states int32, log_w float32, records
    (n / island_size, K+4))."""
    n, K, n_steps = states.shape[0], spec.K, ys.shape[0]
    n_isl = n // island_size
    dev = states.device
    tab = spec.tables(dev)
    flag, ticks, n_valid = ctrl[0] > 0, ctrl[1:K].long(), ctrl[K]
    g = torch.arange(n, device=dev)
    s = torch.where(flag, (g[:, None] >= ticks[None, :]).sum(1), states.long())
    w = torch.where(flag, torch.zeros_like(log_w), log_w)
    count = torch.zeros(n_isl, device=dev)
    n_blk = float(island_size)
    j_local = torch.arange(island_size, device=dev)
    n_check = 0
    for t in range(n_steps):
        valid = t < n_valid
        u = draws[0][t] if draws is not None else philox_uniform(
            seed, g, t0 + t, 0)
        ns = (u[:, None] >= tab["trans_cdf"][s]).sum(1)
        nw = w + _emission(tab, ys[t])[ns]
        s = torch.where(valid, ns, s)
        w = torch.where(valid, nw, w)
        if island_every > 0 and (t + 1) % island_every == 0 and t < n_steps - 1:
            w2, s2 = w.view(n_isl, island_size), s.view(n_isl, island_size)
            m = w2.amax(1)
            e = torch.exp(w2 - m[:, None])
            se, se2 = e.sum(1), (e * e).sum(1)
            collapse = (se * se < island_thresh * n_blk * se2) & (t + 1 < n_valid)
            u0 = draws[1][n_check] if draws is not None else philox_uniform(
                seed, torch.arange(n_isl, device=dev), t0 + t, 1)
            n_check += 1
            cum = torch.cumsum(torch.stack(
                [(e * (s2 == k)).sum(1) for k in range(K - 1)], 1), 1)
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


# --------------------------------------------------------------------------
# kernels


def _lib():
    from ._build import load_library

    lib = load_library("fused_hmm")
    if lib.hmm_chunk_launch.argtypes is None:
        p, i, u32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
        lib.hmm_island_size.argtypes = []
        lib.hmm_island_size.restype = i
        lib.hmm_init_launch.argtypes = [
            i, p, p, u32, u32, p, p, p, ctypes.c_longlong, i, p]
        lib.hmm_init_launch.restype = i
        lib.hmm_chunk_launch.argtypes = [
            i, p, p, i, p, u32, u32, u32, i, f, p, p, p, p, p,
            ctypes.c_longlong, p]
        lib.hmm_chunk_launch.restype = i
        if lib.hmm_island_size() != ISLAND_SIZE:
            raise RuntimeError("csrc/fused_hmm.cu island size differs from "
                               f"ISLAND_SIZE={ISLAND_SIZE}")
    return lib


def _check(t: torch.Tensor, name: str, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_k(spec: HMMSpec):
    if spec.K > _MAX_K:
        raise ValueError(f"the fused HMM kernels take K <= {_MAX_K} states, got {spec.K}")
    if spec.K not in _KERNEL_K:
        raise NotImplementedError(
            f"the CUDA kernels are instantiated for K in {_KERNEL_K}; other "
            "K come with the K-state spec kernels (slice 2)")


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _init_grid(device, n: int) -> int:
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(-(-n // _THREADS), 8 * sms))


def hmm_init(seed: int, y0: torch.Tensor, n: int, spec: HMMSpec):
    """Fused init on the device of ``y0`` (0-d float32): the kernel on a
    CUDA tensor, the plain version on a CPU tensor.  Returns (states,
    log_w, records)."""
    dev = y0.device
    if dev.type == "cpu":
        return hmm_init_plain(seed, y0, n, spec)
    if dev.type != "cuda":
        raise ValueError(f"hmm_init runs on cpu or cuda tensors, not {dev}")
    _check(y0, "y0", torch.float32, dev)
    _check_k(spec)
    if not 0 < n < 2 ** 32:
        raise ValueError(f"n must be in (0, 2^32), got {n}")
    lib = _lib()
    tab = spec.tables(dev)["packed"]
    grid = _init_grid(dev, n)
    states = torch.empty(n, dtype=torch.int32, device=dev)
    log_w = torch.empty(n, dtype=torch.float32, device=dev)
    rec = torch.empty((grid, spec.K + 4), dtype=torch.float32, device=dev)
    k0, k1 = split_seed(seed)
    err = lib.hmm_init_launch(
        spec.K, tab.data_ptr(), y0.data_ptr(), k0, k1, states.data_ptr(),
        log_w.data_ptr(), rec.data_ptr(), n, grid, _stream(dev))
    _raise_on(err, "hmm_init_kernel")
    LAUNCHES["init"] += 1
    return states, log_w, rec


def hmm_chunk(seed: int, states: torch.Tensor, log_w: torch.Tensor,
              ys: torch.Tensor, ctrl: torch.Tensor, spec: HMMSpec, *,
              t0: int = 1, island_every: int = 0, island_thresh: float = 0.5):
    """Fused chunk on the device of ``states``, with islands of
    ``ISLAND_SIZE`` particles: the kernel on CUDA tensors, the plain
    version on CPU tensors (arguments as :func:`hmm_chunk_plain`).
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
    _check(states, "states", torch.int32, dev)
    _check(log_w, "log_w", torch.float32, dev)
    _check(ys, "ys", torch.float32, dev)
    _check(ctrl, "ctrl", torch.int32, dev)
    _check_k(spec)
    if log_w.shape != states.shape:
        raise ValueError("log_w must have the shape of states")
    if n >= 2 ** 31 or t0 < 0 or t0 + ys.shape[0] >= 2 ** 32:
        raise ValueError("n must be < 2^31 and t0 + n_steps < 2^32")
    lib = _lib()
    tab = spec.tables(dev)["packed"]
    out_s = torch.empty_like(states)
    out_w = torch.empty_like(log_w)
    rec = torch.empty((n // ISLAND_SIZE, K + 4), dtype=torch.float32, device=dev)
    k0, k1 = split_seed(seed)
    err = lib.hmm_chunk_launch(
        K, tab.data_ptr(), ys.data_ptr(), ys.shape[0], ctrl.data_ptr(), k0, k1,
        t0, island_every, island_thresh, states.data_ptr(), log_w.data_ptr(),
        out_s.data_ptr(), out_w.data_ptr(), rec.data_ptr(), n, _stream(dev))
    _raise_on(err, "hmm_chunk_kernel")
    LAUNCHES["chunk"] += 1
    return out_s, out_w, rec


def stats_from_partials(records: torch.Tensor, n: int):
    """Combine records into (ess, normalized category weights (K,),
    log-mean-exp of the weights), in float64.  Records of width 3 (max,
    sum e, sum e^2), as the linear-Gaussian kernel writes, carry no
    category columns and give an empty ``cat_w``."""
    r = records.double()
    n_cat = max(r.shape[1] - 4, 0)
    m_b, s1_b, s2_b, c_bk = r[:, 0], r[:, 1], r[:, 2], r[:, 3:3 + n_cat]
    m = m_b.max()
    scale = torch.exp(m_b - m)
    s1 = torch.sum(s1_b * scale)
    s2 = torch.sum(s2_b * scale * scale)
    ess = s1 * s1 / torch.clamp(s2, min=1e-300)
    cat_w = torch.sum(c_bk * scale[:, None], 0) / torch.clamp(s1, min=1e-300)
    lme = m + torch.log(torch.clamp(s1, min=1e-300)) - math.log(n)
    return ess, cat_w, lme


def make_fused_hmm_ssm(island_every: int = 0, island_thresh: float = 0.5,
                       spec: HMMSpec | None = None,
                       island_counts: list | None = None):
    """``hmm_ssm`` with the fused kernels installed as ``fused_init_batch``
    and ``fused_chunk_exchange_t_batch`` (the time-aware chunk hook: the
    kernels' Philox counters run on absolute time, so the sweep's chunks
    never reuse a draw).  ``key`` in both hooks is the sweep's integer seed.

    ``island_every`` > 0: every that many interior steps each island of
    ``ISLAND_SIZE`` particles checks its ESS and exchange-resamples itself
    on collapse below ``island_thresh``.  ``island_counts``: a list to which
    each chunk launch appends its interior resamples per island (a float32
    device tensor; no host sync)."""
    from ..interop import spec_from_numpy
    from ..models.hmm import HMM_MEANS, HMM_TRANS, hmm_ssm

    if spec is None:
        spec = spec_from_numpy(HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3))

    def fused_init(key, n, y0):
        s, w, rec = hmm_init(key, y0, n, spec)
        return (s, w, *stats_from_partials(rec, n))

    def fused_chunk(key, states, log_w, ys, n_valid, flag, ticks, t0):
        ctrl = torch.cat([flag.reshape(1), ticks.reshape(-1),
                          n_valid.reshape(1)]).to(torch.int32)
        s, w, rec = hmm_chunk(
            key, states, log_w, ys, ctrl, spec, t0=t0,
            island_every=island_every, island_thresh=island_thresh)
        if island_counts is not None:
            island_counts.append(rec[:, -1])
        return (s, w, *stats_from_partials(rec, states.shape[0]))

    return dataclasses.replace(
        hmm_ssm,
        fused_init_batch=fused_init,
        fused_chunk_exchange_t_batch=fused_chunk,
    )

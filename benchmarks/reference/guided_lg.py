"""Plain reference of ``guided_lg``: the 1-D linear-Gaussian state-space
model of ``lg1d`` (x_0 ~ N(m0, p0), x_t ~ N(x_{t-1}, q), y_t ~ N(x_t, r);
the configuration's file gives m0, p0, q and r) whose SMC moves a proposal
net of inference compilation guides.  The guide changes only the proposal,
so the exact answers are ``lg1d``'s Kalman filter:

- :func:`simulate`, :func:`exact`, :func:`recursion`, :func:`summarize`,
  :func:`filter_error`: as ``reference/lg1d.py`` has them.

And one guided move, in float64 (so that no product runs in TF32), from
first principles:

- :func:`net_layers`: the net's layers from its file's parsed JSON
  (``sizes``, and per layer ``w`` (in, out) and ``b`` (out,));
- :func:`net_forward`: ``[z_prev, y, t/T] -> (mean, raw)``, ReLU between
  layers;
- :func:`philox4x32_10`, :func:`normal_pair`, :func:`step_eps`: the
  Philox4x32-10 generator (Salmon et al., SC'11) and the Box-Muller pair of
  counter (particle, pair, 0, 0): u1 from word 0 and u2 from word 1 (their
  top 24 bits over 2^24, u1 at least 1e-12), (r cos, r sin) with r =
  sqrt(-2 log u1) and angle 2 pi u2; absolute step t of a particle draws
  the pair of counter (particle, t // 2), its cos half at even t and its
  sin half at odd t;
- :func:`guided_step`: ``(x, y, t, eps) -> (x', dlog w)``, the move ``x'
  = mean + (softplus(raw) + 1e-6) eps`` and the weight ``log p(x' | x) +
  log g(y | x') - log q(x')``;
- :func:`guided_chunk`: the steps of one chunk-kernel launch for every
  particle of a population, in blocks.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK32 = 0xFFFFFFFF
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _params(cfg):
    return (float(cfg["prior_mean"]), float(cfg["prior_var"]),
            float(cfg["transition_var"]), float(cfg["observation_var"]))


def simulate(rng: np.random.Generator, pool: int, cfg) -> np.ndarray:
    """(pool, T) float32 observation series drawn from the model."""
    m0, p0, q, r = _params(cfg)
    T = int(cfg["series_length"])
    x = m0 + math.sqrt(p0) * rng.standard_normal(pool)
    ys = np.empty((pool, T))
    for t in range(T):
        if t:
            x = x + math.sqrt(q) * rng.standard_normal(pool)
        ys[:, t] = x + math.sqrt(r) * rng.standard_normal(pool)
    return ys.astype(np.float32)


def _kalman(y, m0, p0, q, r, ops):
    """The filter over the columns of ``y`` with the arithmetic of
    ``ops`` (numpy or torch): (log-evidence, filtered mean, filtered
    variance) of the last step."""
    m_pred, p_pred = m0, p0
    log_z = 0.0
    for t in range(y.shape[1]):
        s = p_pred + r
        k = p_pred / s
        d = y[:, t] - m_pred
        log_z = log_z - 0.5 * d * d / s - 0.5 * (ops.log(s) + math.log(2.0 * math.pi))
        m = m_pred + k * d
        p = (1.0 - k) * p_pred
        m_pred, p_pred = m, p + q
    return log_z, m, p


def exact(ys: np.ndarray, cfg):
    """Kalman filter in float64 over every series of ``ys`` (P, T):
    (log-evidence (P,), filtering mean and variance at the last step
    (P, 2))."""
    m0, p0, q, r = _params(cfg)
    y = np.asarray(ys, np.float64)
    n = y.shape[0]
    log_z, m, p = _kalman(y, np.full(n, m0), np.full(n, p0), q, r, np)
    return log_z, np.stack([m, p], 1)


def recursion(ys: np.ndarray, cfg, dtype, device="cpu"):
    """:func:`exact`'s filter with every operation in ``dtype`` on
    ``device``; returns float64 numpy arrays as :func:`exact` does."""
    m0, p0, q, r = _params(cfg)
    y = torch.as_tensor(np.asarray(ys, np.float64), device=device).to(dtype)
    n = y.shape[0]
    c = lambda v: torch.full((n,), v, dtype=dtype, device=device)
    log_z, m, p = _kalman(y, c(m0), c(p0), c(q), c(r), torch)
    return (log_z.double().cpu().numpy(),
            torch.stack([m, p], 1).double().cpu().numpy())


def summarize(final_states: torch.Tensor, final_log_weights: torch.Tensor, cfg):
    """The weighted mean and variance of a final population (2,), in
    float64, on the population's device (a small device tensor)."""
    lw = final_log_weights.double()
    w = torch.exp(lw - lw.max())
    w = w / w.sum()
    x = final_states.double()
    mean = torch.sum(w * x)
    return torch.stack([mean, torch.sum(w * (x - mean) ** 2)])


def filter_error(summary: np.ndarray, exact_filter: np.ndarray) -> float:
    """((mean - m)^2 / P + ((var - P) / P)^2): the gaps of a population's
    weighted mean and variance from the exact filtering distribution, in
    units of its variance P."""
    mean, var = (float(v) for v in summary)
    m, p = (float(v) for v in exact_filter)
    return (mean - m) ** 2 / p + ((var - p) / p) ** 2


# --------------------------------------------------------------------------
# the guided move


def net_layers(data, device="cpu"):
    """The net of its file's parsed JSON ``data`` as float64 ``[(W (in,
    out), b (out,)), ...]`` on ``device``."""
    return [(torch.tensor(layer["w"], dtype=torch.float64, device=device),
             torch.tensor(layer["b"], dtype=torch.float64, device=device))
            for layer in data["layers"]]


def net_forward(layers, x: torch.Tensor, y, tf, round_operands=None):
    """(mean, raw) of the net at states ``x`` (n,) for observation ``y``
    and time feature ``tf`` = t / T, in float64.  ``round_operands``: a
    function applied to both operands of every hidden->hidden product
    (a lower precision of the products; the first and the output layer are
    left as they are)."""
    x = x.double()
    feats = torch.stack([x, torch.full_like(x, float(y)), torch.full_like(x, float(tf))], -1)
    act = feats
    last = len(layers) - 1
    for i, (W, b) in enumerate(layers):
        if round_operands is not None and 0 < i < last:
            act = round_operands(act) @ round_operands(W)
        else:
            act = act @ W
        act = act + b
        if i < last:
            act = torch.relu(act)
    return act[:, 0], act[:, 1]


def _mul32(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of the product of uint32 values ``a`` (int64
    tensor) and the constant ``m``: ``m`` split into 16-bit halves so that
    no partial product leaves the signed 64-bit range."""
    m_hi, m_lo = m >> 16, m & 0xFFFF
    upper = a * m_hi                       # < 2^48, weight 2^16
    low = a * m_lo + ((upper & 0xFFFF) << 16)   # < 2^49
    return (upper >> 16) + (low >> 32), low & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of counter words ``c0..c3`` (int64 tensors of uint32
    values, broadcast together) under key ``(k0, k1)``: the four output
    words as int64 tensors."""
    device = next((v.device for v in (c0, c1, c2, c3) if isinstance(v, torch.Tensor)),
                  torch.device("cpu"))
    c = [torch.as_tensor(v, dtype=torch.int64, device=device) for v in (c0, c1, c2, c3)]
    c = list(torch.broadcast_tensors(*c))
    k0, k1 = int(k0) & _MASK32, int(k1) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mul32(c[0], 0xD2511F53)
        hi1, lo1 = _mul32(c[2], 0xCD9E8D57)
        c = [(hi1 ^ c[1] ^ k0) & _MASK32, lo1, (hi0 ^ c[3] ^ k1) & _MASK32, lo0]
        k0 = (k0 + 0x9E3779B9) & _MASK32
        k1 = (k1 + 0xBB67AE85) & _MASK32
    return c


def normal_pair(seed: int, particle: torch.Tensor, pair: int):
    """The Box-Muller pair (cos half, sin half) of counter (particle, pair,
    0, 0) under the 64-bit ``seed`` (key words: its low and high 32 bits),
    in float64."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    w0, w1, _, _ = philox4x32_10(particle, pair, 0, 0, seed & _MASK32, seed >> 32)
    u1 = torch.clamp((w0 >> 8).double() / 2.0 ** 24, min=1e-12)
    u2 = (w1 >> 8).double() / 2.0 ** 24
    r = torch.sqrt(-2.0 * torch.log(u1))
    angle = 2.0 * math.pi * u2
    return r * torch.cos(angle), r * torch.sin(angle)


def step_eps(seed: int, particle: torch.Tensor, t: int) -> torch.Tensor:
    """The standard normal draw of absolute step ``t`` of each of
    ``particle`` (indices into the population)."""
    cos_half, sin_half = normal_pair(seed, particle, t // 2)
    return cos_half if t % 2 == 0 else sin_half


def guided_step(layers, cfg, x: torch.Tensor, y, t: int, eps: torch.Tensor,
                round_operands=None):
    """One guided move of every particle ``x`` at absolute step ``t`` with
    draws ``eps``: ``(x', dlog w)`` in float64."""
    _, _, q, r = _params(cfg)
    T = int(cfg["series_length"])
    x = x.double()
    mean, raw = net_forward(layers, x, y, float(t) / T, round_operands)
    std = torch.clamp(raw, min=0.0) + torch.log1p(torch.exp(-raw.abs())) + 1e-6
    eps = eps.double()
    nx = mean + std * eps
    log_q = -0.5 * eps * eps - torch.log(std) - _HALF_LOG_2PI
    d_trans, d_obs = nx - x, float(y) - nx
    trans = -0.5 * d_trans * d_trans / q - 0.5 * math.log(q) - _HALF_LOG_2PI
    obs = -0.5 * d_obs * d_obs / r - 0.5 * math.log(r) - _HALF_LOG_2PI
    return nx, trans + obs - log_q


def guided_chunk(layers, cfg, seed: int, x: torch.Tensor, log_w: torch.Tensor,
                 ys, t0: int, n_valid: int, block: int = 1 << 20, round_operands=None):
    """The first ``n_valid`` steps of a chunk-kernel launch, from absolute
    step ``t0`` with observations ``ys`` (one a step), for the population
    ``(x, log_w)`` (particle i is index i): ``(x', log_w')`` in float64,
    computed ``block`` particles at a time on the population's device."""
    n = x.shape[0]
    out_x = torch.empty(n, dtype=torch.float64, device=x.device)
    out_w = torch.empty(n, dtype=torch.float64, device=x.device)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        idx = torch.arange(lo, hi, dtype=torch.int64, device=x.device)
        xb, wb = x[lo:hi].double(), log_w[lo:hi].double()
        for s in range(n_valid):
            t = t0 + s
            xb, dw = guided_step(layers, cfg, xb, float(ys[s]), t, step_eps(seed, idx, t),
                                 round_operands)
            wb = wb + dw
        out_x[lo:hi], out_w[lo:hi] = xb, wb
    return out_x, out_w

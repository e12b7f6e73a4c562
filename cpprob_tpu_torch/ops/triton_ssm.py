"""K12, the guided scalar chunk kernel (Triton) — counterpart of the
elementwise twin ``_make_guided_scalar_chunk_kernel`` (``cpprob_tpu/ops/
pallas_ssm.py:887-945``; its MXU twin is ``ops/guided_tc.py``).

A proposal net trained by
:func:`cpprob_tpu_torch.inference.smc_csis.train_ssm_proposal` with
``kind="normal"`` (layers ``[3, H.., 2]``, inputs ``[z_prev, y, t/T]``,
outputs ``(mean, raw)``) runs inside the kernel: per particle-step the
Box-Muller eps of absolute step t (Philox4x32-10 counter (particle, t // 2,
0, 0), its cos half at even t and its sin half at odd t: the draws of K7
and K10), the net, the move ``z' = mean + std * eps`` with ``std =
softplus(raw) + 1e-6`` (the q the trainer fits and the fallback hooks
serve), and the weight ``log_w += trans_logpdf_elem(z, z', t) +
obs_logpdf_elem(z', y, t) - log q(z' | z, y)``.  The two densities keep the
elementwise contract of :mod:`.render` with the signatures

    trans_logpdf_elem(x, nx, t) -> log p(nx | x)
    obs_logpdf_elem(nx, y, t) -> log g(y | nx)

where ``t`` is the absolute step as a float32 scalar (exact below 2^24);
a violation raises ``ValueError`` when the kernel is built.  Only z_prev is
per particle, so the first layer is ``x * w_x + c_j`` with ``c_j = w_y * y
+ w_t * t/T + b_j`` formed once per step; the other layers are unrolled
multiplies and adds in the order of the reference's elementwise twin, the
last hidden layer streamed into the two outputs so that only one hidden
layer is live in registers.  The weights are baked into the generated
source as float32 constants, as the reference's ``_make_mlp_elem`` bakes
them: they become immediate operands of the multiplies, costing no loads
and no registers, at the price of one Triton compile per trained net, at
its first launch.  Triton's ``tl.philox`` is Philox4x32-10 with the seed's
low and high words as the key, the generator of ``ops/philox.py``
(:func:`philox_words` holds it there on the card); the transcendentals are
libdevice's precise ones, square root and division round to nearest
(``tl.sqrt_rn``, ``tl.div_rn``), and the kernel is compiled with
``enable_fp_fusion=False``, so it rounds as the plain version
(:func:`guided_scalar_chunk_plain`) does.

What bounds K12 on an H100: for hidden width H about 3H + 2H² + 5H float
operations per particle-step (~640 at H = 16; the kernel keeps multiplies
and adds apart), plus half a Philox call, the draw's and q's
transcendentals and the densities, against 16 B per particle per chunk:
float32 issue, not memory.  This kernel runs with
``attach_fused_guided_scalar_kernels(..., mxu=False)``; the default
(``mxu=True``) puts the hidden layers on the tensor cores
(``ops/guided_tc.py``).

The generated kernel source goes to ``ops/_build/`` (one file per guided
model), and Triton's cache to ``ops/_build/triton_cache``.
"""

from __future__ import annotations

import hashlib
import importlib.util
import math
import os
import sys
from pathlib import Path

import numpy as np
import torch

from .fused_lg import normal_steps
from .population import launch_population, mlp_layers
from .render import analyse_elem
from .user_chunk import block_records

__all__ = ["GUIDED_BLOCK", "LAUNCHES", "GuidedScalarKernel",
           "guided_scalar_chunk_plain", "check_scalar_net", "philox_words"]

_NUM_WARPS = 8
# K12: 512 particles per program over 8 warps, 2 per thread: a hidden layer
# of 16 units then fits in 78 registers; at 4 per thread the kernel took
# 161, so that one CTA fitted an SM
GUIDED_BLOCK = 512
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_BUILD_DIR = Path(__file__).resolve().parent / "_build"

# kernel launches, counted where the kernel is launched
LAUNCHES = {"guided": 0}


# --------------------------------------------------------------------------
# plain version


def check_scalar_net(params):
    """The layers of a ``kind="normal"`` proposal net as float32 numpy
    ``(Ws, bs)``.  Raises ``ValueError`` unless it maps ``[z_prev, y,
    t/T]`` to ``(mean, raw)`` through layers that chain."""
    Ws, bs = mlp_layers(params)
    if Ws[0].shape[0] != 3 or Ws[-1].shape[1] != 2:
        raise ValueError(
            "expected an smc_csis 'normal' proposal net: inputs [z_prev, y, "
            f"t/T], outputs [mean, raw_std]; got {Ws[0].shape[0]} -> "
            f"{Ws[-1].shape[1]}")
    return Ws, bs


def _net_plain(net, x: torch.Tensor, y: torch.Tensor, tf: torch.Tensor):
    """(mean, raw) of the net at states ``x``, in the kernel's order of
    operations: first layer ``x * w_x + (w_y * y + w_t * tf + b)``, then
    each unit ``a_0 * w_0 + b + a_1 * w_1 + ...``, ReLU between layers."""
    Ws, bs = net

    def first(j):
        return x * Ws[0][0, j] + (Ws[0][1, j] * y + Ws[0][2, j] * tf + bs[0][j])

    def unit(acts, W, b, j):
        a = acts[0] * W[0, j] + b[j]
        for i in range(1, len(acts)):
            a = a + acts[i] * W[i, j]
        return a

    if len(Ws) == 1:
        return first(0), first(1)
    acts = [torch.relu(first(j)) for j in range(Ws[0].shape[1])]
    for W, b in zip(Ws[1:-1], bs[1:-1]):
        acts = [torch.relu(unit(acts, W, b, j)) for j in range(W.shape[1])]
    return unit(acts, Ws[-1], bs[-1], 0), unit(acts, Ws[-1], bs[-1], 1)


def guided_scalar_chunk_plain(params, trans_logpdf_elem, obs_logpdf_elem,
                              T: int, seed: int, states: torch.Tensor,
                              log_w: torch.Tensor, ys: torch.Tensor,
                              n_valid=None, *, t0: int = 1, draws=None):
    """Plain version of the guided chunk kernel (K12).  ``params``: a
    ``kind="normal"`` net; ``states`` (n,) float32; ``n_valid``: int32
    scalar tensor (``None``: every step valid); ``t0``: absolute time of
    the first step.  ``draws``: eps (n_steps, n) or broadcastable, in place
    of Philox.  Returns (states, log_w, records (ceil(n / GUIDED_BLOCK),
    3))."""
    n, n_steps = states.shape[0], ys.shape[0]
    dev = states.device
    Ws, bs = check_scalar_net(params)
    net = ([torch.as_tensor(W, device=dev) for W in Ws],
           [torch.as_tensor(b, device=dev) for b in bs])
    nv = (torch.tensor(n_steps) if n_valid is None
          else torch.as_tensor(n_valid).reshape(())).to(dev)
    x, w = states, log_w
    philox = normal_steps(seed, torch.arange(n, device=dev), t0,
                          n_steps) if draws is None else None
    for t in range(n_steps):
        eps = (next(philox)[0] if draws is None
               else torch.broadcast_to(draws[t], (n,)))
        y = ys[t]
        tt = torch.tensor(float(t0 + t), dtype=torch.float32, device=dev)
        mean, raw = _net_plain(net, x, y, tt / float(T))
        std = (torch.clamp(raw, min=0.0) + torch.log1p(torch.exp(-raw.abs()))
               + 1e-6)
        nx = mean + std * eps
        log_q = -0.5 * eps * eps - torch.log(std) - _HALF_LOG_2PI
        dlw = trans_logpdf_elem(x, nx, tt) + obs_logpdf_elem(nx, y, tt) - log_q
        valid = t < nv
        x = torch.where(valid, nx, x)
        w = torch.where(valid, w + dlw, w)
    return x, w, block_records(w, GUIDED_BLOCK)


# --------------------------------------------------------------------------
# the kernel: generated source, built at the first launch


_HEADER = '''\
# Generated by cpprob_tpu_torch/ops/triton_ssm.py for {origin}.
import triton
import triton.language as tl
{libdevice_import}

{constants}

@triton.jit
def _elem_exp(x):
    return libdevice.exp(x)


@triton.jit
def _elem_log(x):
    return libdevice.log(x)


@triton.jit
def _elem_sqrt(x):
    return tl.sqrt_rn(x)


@triton.jit
def _div_rn(a, b):
    return tl.div_rn(a, b)


@triton.jit
def _elem_sin(x):
    return libdevice.sin(x)


@triton.jit
def _elem_cos(x):
    return libdevice.cos(x)


@triton.jit
def _elem_tanh(x):
    return libdevice.tanh(x)


@triton.jit
def _elem_where(c, a, b):
    return tl.where(c, a, b)


@triton.jit
def _elem_minimum(a, b):
    return tl.minimum(a, b)


@triton.jit
def _elem_maximum(a, b):
    return tl.maximum(a, b)


@triton.jit
def _normal_pair(seed, g, pair, plane: tl.constexpr):
    # Box-Muller on Philox4x32-10 counter (g, pair, plane, 0), words 0 and 1
    b0, b1, _b2, _b3 = tl.philox(seed, g, pair, plane, 0)
    u1 = tl.maximum((b0 >> 8).to(tl.float32) * (1.0 / 16777216.0), 1e-12)
    u2 = (b1 >> 8).to(tl.float32) * (1.0 / 16777216.0)
    r = tl.sqrt_rn(-2.0 * libdevice.log(u1))
    ang = 6.283185307179586 * u2
    return r * libdevice.cos(ang), r * libdevice.sin(ang)


'''

_PHILOX_TEMPLATE = _HEADER + '''
@triton.jit
def philox_words_kernel(out_ptr, seed, c1, c2, n, BLOCK: tl.constexpr):
    offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    b0, b1, b2, b3 = tl.philox(seed, offs.to(tl.uint32), c1, c2, 0)
    tl.store(out_ptr + offs * 4, b0.to(tl.int32, bitcast=True), mask=mask)
    tl.store(out_ptr + offs * 4 + 1, b1.to(tl.int32, bitcast=True), mask=mask)
    tl.store(out_ptr + offs * 4 + 2, b2.to(tl.int32, bitcast=True), mask=mask)
    tl.store(out_ptr + offs * 4 + 3, b3.to(tl.int32, bitcast=True), mask=mask)
'''


_GUIDED_TEMPLATE = _HEADER + '''
@triton.jit
{trans_elem}


@triton.jit
{obs_elem}


@triton.jit(do_not_specialize=["seed", "t0", "n", "n_steps"])
def guided_chunk_kernel(x_ptr, w_ptr, ys_ptr, nv_ptr, xo_ptr, wo_ptr, rec_ptr,
                        n, n_steps, seed, t0, BLOCK: tl.constexpr):
    pid = tl.program_id(0)
    offs = pid * BLOCK + tl.arange(0, BLOCK)
    mask = offs < n
    g = offs.to(tl.uint32)
    x = tl.load(x_ptr + offs, mask=mask, other=0.0)
    sn = tl.zeros([BLOCK], tl.float32)
    w = tl.load(w_ptr + offs, mask=mask, other=-float("inf"))
    n_valid = tl.minimum(tl.load(nv_ptr), n_steps)
    for t in range(0, n_valid):
        ta = t0 + t
        y = tl.load(ys_ptr + t)
        even = (ta % 2) == 0
        if even | (t == 0):
            e, sn = _normal_pair(seed, g, (ta // 2).to(tl.uint32), 0)
            e = tl.where(even, e, sn)
        else:
            e = sn
        tt = ta.to(tl.float32)
        tf = tl.div_rn(tt, {T_float})
{mlp}
        std = tl.maximum(raw, 0.0) + libdevice.log1p(libdevice.exp(-tl.abs(raw))) + 1e-06
        nx = mean + std * e
        log_q = -0.5 * e * e - libdevice.log(std) - {half_log_2pi}
        dlw = trans_logpdf_elem(x, nx, tt) + obs_logpdf_elem(nx, y, tt) - log_q
        x = nx
        w = w + dlw
    w = tl.where(mask, w, -float("inf"))
    tl.store(xo_ptr + offs, x, mask=mask)
    tl.store(wo_ptr + offs, w, mask=mask)
    m = tl.max(w, axis=0)
    ex = tl.where(mask, libdevice.exp(w - m), 0.0)
    tl.store(rec_ptr + pid * 3, m)
    tl.store(rec_ptr + pid * 3 + 1, tl.sum(ex, axis=0))
    tl.store(rec_ptr + pid * 3 + 2, tl.sum(ex * ex, axis=0))
'''


def _libdevice_import() -> str:
    """The import of Triton's libdevice functions (their module moved
    between Triton releases)."""
    try:
        importlib.import_module("triton.language.extra.libdevice")
        return "from triton.language.extra import libdevice"
    except ImportError:
        return "from triton.language.extra.cuda import libdevice"


def _f32(v) -> str:
    """A float32 value as a literal that converts back to it exactly."""
    return f"({float(np.float32(v))!r})"


def render_mlp(Ws, bs, ind: str = " " * 8) -> str:
    """Kernel lines computing ``mean`` and ``raw`` of a ``[3, H.., 2]`` net
    from ``x`` (the particle's state) and the step scalars ``y``, ``tf``,
    with the weights as float32 constants, in the order of operations of
    :func:`_net_plain`.  The last hidden layer streams into the outputs."""
    L = len(Ws)
    lines = [f"{ind}c{j} = {_f32(Ws[0][1, j])} * y + {_f32(Ws[0][2, j])} * tf"
             f" + {_f32(bs[0][j])}" for j in range(Ws[0].shape[1])]
    first = [f"x * {_f32(Ws[0][0, j])} + c{j}" for j in range(Ws[0].shape[1])]
    if L == 1:
        return "\n".join(lines + [f"{ind}mean = {first[0]}",
                                   f"{ind}raw = {first[1]}"])

    def unit(prev, W, b, j):
        terms = [f"{prev[0]} * {_f32(W[0, j])} + {_f32(b[j])}"]
        terms += [f"{a} * {_f32(W[i, j])}" for i, a in enumerate(prev) if i]
        return " + ".join(terms)

    def stream(name, expr, j):
        # unit j of the last hidden layer, added into both outputs at once
        out = [f"{ind}{name} = tl.maximum({expr}, 0.0)"]
        for k, o in enumerate(("mean", "raw")):
            term = f"{name} * {_f32(Ws[-1][j, k])}"
            out.append(f"{ind}{o} = {term} + {_f32(bs[-1][k])}" if j == 0
                       else f"{ind}{o} = {o} + {term}")
        return out

    prev = []
    for j, expr in enumerate(first):
        if L == 2:
            lines += stream(f"h0_{j}", expr, j)
        else:
            lines.append(f"{ind}h0_{j} = tl.maximum({expr}, 0.0)")
            prev.append(f"h0_{j}")
    for li in range(1, L - 1):
        cur = []
        for j in range(Ws[li].shape[1]):
            expr = unit(prev, Ws[li], bs[li], j)
            if li == L - 2:
                lines += stream(f"h{li}_{j}", expr, j)
            else:
                lines.append(f"{ind}h{li}_{j} = tl.maximum({expr}, 0.0)")
                cur.append(f"h{li}_{j}")
        prev = cur
    return "\n".join(lines)


def render_guided_source(net, trans: tuple, obs: tuple, T: int) -> str:
    """The generated module's source for the guided kernel of a checked
    net ``(Ws, bs)`` and two analysed densities ``(source, consts)``."""
    consts = [f"_kt_{k} = tl.constexpr({v!r})" for k, v in sorted(trans[1].items())]
    consts += [f"_ko_{k} = tl.constexpr({v!r})" for k, v in sorted(obs[1].items())]
    return _GUIDED_TEMPLATE.format(
        origin="a guided model's proposal net and densities",
        libdevice_import=_libdevice_import(),
        constants="\n".join(consts),
        trans_elem=trans[0], obs_elem=obs[0],
        T_float=repr(float(T)), half_log_2pi=repr(_HALF_LOG_2PI),
        mlp=render_mlp(*net))


def _load_generated(source: str):
    """Write ``source`` to ``ops/_build/`` under a name carrying its hash
    and import it (Triton reads a kernel's source from its file)."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(_BUILD_DIR / "triton_cache"))
    digest = hashlib.sha256(source.encode()).hexdigest()[:16]
    name = f"cpprob_user_kernel_{digest}"
    if name in sys.modules:
        return sys.modules[name]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _BUILD_DIR / f"{name}.py"
    if not path.exists() or path.read_text() != source:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class GuidedScalarKernel:
    """K12, the guided chunk kernel of one proposal net and two densities
    (module docstring).  Building it checks the net's shape and the
    densities against their contract (``ValueError``); the Triton kernel
    itself is generated and compiled at the first CUDA launch."""

    def __init__(self, params, trans_logpdf_elem, obs_logpdf_elem, T: int):
        self.params, self.T = params, int(T)
        self.trans, self.obs = trans_logpdf_elem, obs_logpdf_elem
        self._net = check_scalar_net(params)
        self._trans = analyse_elem(trans_logpdf_elem, 3, "trans_logpdf_elem",
                                   "x, nx, t", prefix="_kt_")
        self._obs = analyse_elem(obs_logpdf_elem, 3, "obs_logpdf_elem",
                                 "nx, y, t", prefix="_ko_")
        self._module = None
        self._all_steps: dict = {}
        # (registers, spills) per thread of the compiled kernel, once launched
        self.registers = None

    def layer_sizes(self) -> list:
        return [self._net[0][0].shape[0]] + [W.shape[1] for W in self._net[0]]

    def source(self) -> str:
        """The generated kernel module's source."""
        return render_guided_source(self._net, self._trans, self._obs, self.T)

    def chunk(self, seed: int, states: torch.Tensor, log_w: torch.Tensor,
              ys: torch.Tensor, n_valid=None, *, t0: int = 1, draws=None):
        """The chunk on the device of ``states`` (n,) float32: the kernel on
        CUDA tensors, :func:`guided_scalar_chunk_plain` on CPU tensors
        (``draws``: eps in place of Philox, CPU only).  Returns (states,
        log_w, records)."""
        dev = states.device
        if states.dim() != 1 or log_w.shape != states.shape:
            raise ValueError("states and log_w must be (n,) alike")
        if dev.type == "cpu":
            return guided_scalar_chunk_plain(
                self.params, self.trans, self.obs, self.T, seed, states, log_w,
                ys, n_valid, t0=t0, draws=draws)
        if draws is not None:
            raise ValueError("draws= is for the plain version on CPU tensors")
        n, n_steps = states.shape[0], ys.shape[0]
        if not 0 < n < 2 ** 31 or t0 < 0 or t0 + n_steps >= 2 ** 24:
            raise ValueError("need 0 < n < 2^31 and t0 + n_steps < 2^24 "
                             "(t is passed to the densities as float32)")
        if n_valid is None:
            if dev not in self._all_steps:
                self._all_steps[dev] = torch.full((1,), 2 ** 30, dtype=torch.int32,
                                                  device=dev)
            n_valid = self._all_steps[dev]
        elif n_valid.numel() != 1:
            raise ValueError("n_valid must be one int32 element")
        if self._module is None:
            self._module = _load_generated(self.source())
        seed64 = int(seed) & 0xFFFFFFFFFFFFFFFF
        grid = -(-n // GUIDED_BLOCK)

        def launch(x_out, w_out, rec):
            compiled = self._module.guided_chunk_kernel[(grid,)](
                states, log_w, ys, n_valid, x_out, w_out, rec, n, n_steps,
                seed64, t0, BLOCK=GUIDED_BLOCK, num_warps=_NUM_WARPS,
                enable_fp_fusion=False)
            self.registers = (getattr(compiled, "n_regs", None),
                              getattr(compiled, "n_spills", None))

        return launch_population(
            "guided_chunk_kernel", launch, device=dev,
            inputs=[(states, "states", torch.float32),
                    (log_w, "log_w", torch.float32),
                    (ys, "ys", torch.float32),
                    (n_valid, "n_valid", torch.int32)],
            outputs=[((n,), torch.float32), ((n,), torch.float32)],
            records=(grid, 3), counts=LAUNCHES, count_key="guided")


def philox_words(seed: int, n: int, c1: int, c2: int, device) -> torch.Tensor:
    """(n, 4) Philox4x32-10 words of ``tl.philox`` at counters (i, c1, c2,
    0), i < n, as int64 values in [0, 2^32): held against
    :func:`~.philox.philox4x32` on the card."""
    mod = _load_generated(_PHILOX_TEMPLATE.format(
        origin="the Philox words check", libdevice_import=_libdevice_import(),
        constants=""))
    out = torch.empty((n, 4), dtype=torch.int32, device=device)
    mod.philox_words_kernel[(-(-n // 1024),)](
        out, int(seed) & 0xFFFFFFFFFFFFFFFF, c1, c2, n, BLOCK=1024)
    return out.long() & 0xFFFFFFFF

"""K12, the guided scalar chunk kernel on the FMA pipe — counterpart of the
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
a violation raises ``ValueError`` when the kernel object is built.

:class:`GuidedScalarKernel` generates one CUDA source per net and pair of
densities (:func:`render_source`): the net as unrolled multiply-adds with
its weights baked in as float32 literals (:func:`render_net`, as the
reference's ``_make_mlp_elem`` bakes them), the densities rendered to C++
by :mod:`.render`, and ``csrc/guided_scalar.cuh``, the kernel, where its
design is set out.  It is built with ``nvcc`` at the first launch
(``_build.load_generated_library``, into ``ops/_build/``).  Only z_prev is
per particle, so the first layer is ``fma(x, w_x, c_j)`` with ``c_j = w_y *
y + w_t * t/T + b_j`` formed once per step; each later unit is a chain of
fused multiply-adds from its bias, ReLU between layers, the last hidden
layer streamed into the two outputs.  Each multiply-add rounds once; the
plain version (:func:`guided_scalar_chunk_plain`, :func:`_net_plain`)
takes the same order and emulates that rounding in float64, so the two
agree to within a float64 double rounding (an ulp, rarely).

This kernel runs with ``attach_fused_guided_scalar_kernels(..., mxu=False)``,
for a linear ``[3, 2]`` head, and for hidden layers wider than the
tensor-core twin takes; the default (``mxu=True``) puts the hidden layers
on the tensor cores (``ops/guided_tc.py``).  On CPU tensors the wrapper
runs the plain version; on CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..util.profiling import counter_group
from .fused_lg import normal_steps
from .philox import split_seed
from .population import current_stream, launch_population, mlp_layers
from .render import _f32_literal, analyse_elem, render_function
from .user_chunk import block_records

__all__ = ["GUIDED_BLOCK", "LAUNCHES", "PER_THREAD", "GuidedScalarKernel",
           "check_scalar_net", "guided_scalar_chunk_plain", "per_thread",
           "render_density", "render_net", "render_source"]

# particles per record of the plain version
GUIDED_BLOCK = 512
# particles a thread of the kernel (csrc/guided_scalar.cuh kPerThread) for
# hidden layers up to 16 units; see per_thread()
PER_THREAD = 4
_THREADS = 256            # csrc/guided_scalar.cuh kThreads
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

# kernel launches, counted where the kernel is launched
LAUNCHES = counter_group("guided_scalar", ("guided",))

_HINT = ("a guided density keeps the elementwise contract of "
         "cpprob_tpu_torch/ops/render.py")


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


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add rounds it: the product is exact in float64, the sum rounds
    to float64 and then to float32 (which differs from one rounding only
    when the float64 sum falls on a float32 tie)."""
    return torch.addcmul(c.double(), a.double(), b.double()).float()


def _net_plain(net, x: torch.Tensor, y: torch.Tensor, tf: torch.Tensor):
    """(mean, raw) of the net at states ``x`` (n,), in the kernel's order of
    operations: ``c = w_y * y + w_t * tf + b`` in float32, the first layer
    ``fma(x, w_x, c)``, each later unit a chain of fused multiply-adds from
    its bias over the previous layer's units in order, ReLU between
    layers."""
    Ws, bs = net
    c = Ws[0][1] * y + Ws[0][2] * tf + bs[0]
    act = _fma(x[:, None], Ws[0][0][None, :], c[None, :])
    for W, b in zip(Ws[1:], bs[1:]):
        act = torch.relu(act)
        acc = b[None, :].expand(act.shape[0], -1)
        for i in range(W.shape[0]):
            acc = _fma(act[:, i:i + 1], W[i][None, :], acc)
        act = acc
    return act[:, 0], act[:, 1]


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


def render_density(fn, name: str, args: str, prefix: str) -> str:
    """The C++ ``__device__`` function ``float name(float, float, float)``
    of an elementwise density under the contract of :mod:`.render`
    (``args`` describes its arguments).  Raises ``ValueError`` on anything
    outside it, when either twin of K12 is built."""
    src, consts = analyse_elem(fn, 3, name, args, prefix=prefix)
    return render_function(src, consts, prefix, hint=_HINT)


def per_thread(sizes) -> int:
    """Particles a thread of the kernel for a net of ``sizes``:
    :data:`PER_THREAD` while the particles' live layers fit side by side
    (hidden layers up to 16 units), fewer above, so that a thread holds at
    most 64 activations (a ``[3,64,64,2]`` net, one particle a thread,
    took 212 registers and no local memory on an H100)."""
    widest = max(sizes[1:-1], default=0)
    return max(1, min(PER_THREAD, 64 // max(widest, 1)))


def render_net(Ws, bs, weight=_f32_literal) -> str:
    """The C++ functions ``first_consts`` and ``net`` of a checked ``[3,
    H.., 2]`` net (the contract of ``csrc/guided_scalar.cuh``), every
    weight and bias an operand ``weight(value)`` (default a float32 literal
    that converts back exactly), in the order of :func:`_net_plain`."""
    L = len(Ws)
    first = Ws[0].shape[1]
    lines = ["__device__ __forceinline__ void first_consts(float y, float tf, "
             "float (&c)[kFirst]) {"]
    lines += [f"  c[{j}] = __fadd_rn(__fadd_rn(__fmul_rn({weight(Ws[0][1, j])}, y), "
              f"__fmul_rn({weight(Ws[0][2, j])}, tf)), {weight(bs[0][j])});"
              for j in range(first)]
    lines += ["}", "",
              "__device__ __forceinline__ void net(float x, const float (&c)[kFirst], "
              "float& mean, float& raw) {"]
    if L == 1:
        lines += [f"  mean = __fmaf_rn(x, {weight(Ws[0][0, 0])}, c[0]);",
                  f"  raw = __fmaf_rn(x, {weight(Ws[0][0, 1])}, c[1]);", "}"]
        return "\n".join(lines) + "\n"

    def stream(name, j):
        # unit j of the last hidden layer, added into both outputs at once
        out = []
        for k, o in enumerate(("mean", "raw")):
            acc = weight(bs[-1][k]) if j == 0 else o
            out.append(f"  {o} = __fmaf_rn({name}, {weight(Ws[-1][j, k])}, {acc});")
        return out

    prev = []
    for j in range(first):
        name = f"h0_{j}"
        lines.append(f"  const float {name} = fmaxf(__fmaf_rn(x, {weight(Ws[0][0, j])}, "
                     f"c[{j}]), 0.0f);")
        if L == 2:
            lines += stream(name, j)
        prev.append(name)
    for li in range(1, L - 1):
        cur = []
        for j in range(Ws[li].shape[1]):
            name = f"h{li}_{j}"
            lines.append(f"  float {name}a = {weight(bs[li][j])};")
            lines += [f"  {name}a = __fmaf_rn({a}, {weight(Ws[li][i, j])}, {name}a);"
                      for i, a in enumerate(prev)]
            lines.append(f"  const float {name} = fmaxf({name}a, 0.0f);")
            if li == L - 2:
                lines += stream(name, j)
            cur.append(name)
        prev = cur
    lines.append("}")
    return "\n".join(lines) + "\n"


_SOURCE = """\
// Generated by cpprob_tpu_torch/ops/guided_scalar.py: K12 on the FMA pipe
// for a {sizes} proposal net (its weights baked in) and two densities.
#include <math.h>

namespace guided_scalar_model {{

constexpr int kPerThread = {per_thread};
constexpr int kFirst = {first};

{net}
{trans}
{obs}
}}  // namespace guided_scalar_model

#include "guided_scalar.cuh"
"""


def render_source(net, trans_cpp: str, obs_cpp: str) -> str:
    """The generated CUDA source of a checked net ``(Ws, bs)`` and two
    densities rendered to C++."""
    Ws, bs = net
    sizes = [Ws[0].shape[0]] + [W.shape[1] for W in Ws]
    return _SOURCE.format(sizes=sizes, per_thread=per_thread(sizes),
                          first=Ws[0].shape[1], net=render_net(Ws, bs),
                          trans=trans_cpp, obs=obs_cpp)


class GuidedScalarKernel:
    """K12, the guided chunk kernel of one proposal net and two densities
    (module docstring).  Building it checks the net's shape and renders the
    densities (``ValueError`` otherwise); the CUDA source is generated and
    built at the first launch."""

    def __init__(self, params, trans_logpdf_elem, obs_logpdf_elem, T: int):
        self.params, self.T = params, int(T)
        self.trans, self.obs = trans_logpdf_elem, obs_logpdf_elem
        self._net = check_scalar_net(params)
        self._trans_cpp = render_density(trans_logpdf_elem, "trans_logpdf_elem",
                                         "x, nx, t", "_kt_")
        self._obs_cpp = render_density(obs_logpdf_elem, "obs_logpdf_elem",
                                       "nx, y, t", "_ko_")
        self._all_steps: dict = {}
        self._lib = None
        self.library = None   # "guided_scalar-<hash>", once built
        # (registers, spills) per thread of the built kernel, from ptxas
        self.registers = None

    def layer_sizes(self) -> list:
        return [self._net[0][0].shape[0]] + [W.shape[1] for W in self._net[0]]

    def block(self) -> int:
        """Particles per CTA of the kernel, one record each."""
        return _THREADS * per_thread(self.layer_sizes())

    def source(self) -> str:
        """The generated CUDA source."""
        return render_source(self._net, self._trans_cpp, self._obs_cpp)

    def _library(self):
        if self._lib is None:
            from ..util.sass import parse_registers, parse_spills
            from ._build import _LIBS, BUILD_LOGS, load_generated_library

            lib = load_generated_library("guided_scalar", self.source())
            p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            lib.guided_scalar_block.argtypes = []
            lib.guided_scalar_block.restype = i
            lib.guided_scalar_launch.argtypes = [p, i, p, u32, u32, u32, ctypes.c_float,
                                                 p, p, p, p, p, ctypes.c_longlong, p]
            lib.guided_scalar_launch.restype = i
            if lib.guided_scalar_block() != self.block():
                raise RuntimeError("the generated guided_scalar source's block "
                                   "differs from guided_scalar.py's")
            self.library = next(k for k, v in _LIBS.items() if v is lib)
            log = BUILD_LOGS.get(self.library, "")
            regs = [v for f, v in parse_registers(log).items() if "guided_scalar_kernel" in f]
            spills = [v for f, v in parse_spills(log).items() if "guided_scalar_kernel" in f]
            self.registers = (regs[0] if regs else None, spills[0] if spills else None)
            self._lib = lib
        return self._lib

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
        lib = self._library()
        k0, k1 = split_seed(seed)
        grid = -(-n // self.block())

        def launch(x_out, w_out, rec):
            return lib.guided_scalar_launch(
                ys.data_ptr(), n_steps, n_valid.data_ptr(), k0, k1, t0,
                float(self.T), states.data_ptr(), log_w.data_ptr(),
                x_out.data_ptr(), w_out.data_ptr(), rec.data_ptr(), n,
                current_stream(dev))

        return launch_population(
            "guided_scalar_kernel", launch, span_name="launch.guided_scalar_kernel",
            device=dev,
            inputs=[(states, "states", torch.float32),
                    (log_w, "log_w", torch.float32),
                    (ys, "ys", torch.float32),
                    (n_valid, "n_valid", torch.int32)],
            outputs=[((n,), torch.float32), ((n,), torch.float32)],
            records=(grid, 3), counts=LAUNCHES, count_key="guided")


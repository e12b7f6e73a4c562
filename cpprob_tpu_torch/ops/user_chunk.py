"""The user-physics chunk kernels (K10 for D = 1, K11 for D > 1) —
counterparts of ``_make_scalar_chunk_kernel`` and
``_make_vector_chunk_kernel`` (``cpprob_tpu/ops/pallas_ssm.py:588-630,
702-772``).

Per particle the kernel runs ``n_steps`` of the user's physics with
``n_valid`` masking and writes one (max, sum e, sum e^2) record per CTA
(e = exp(w - max w), the layout :func:`~.population.stats_from_partials`
combines).  The physics is a ``step_elem``

    step_elem(x_0, ..., x_{D-1}, y, eps_0, ..., eps_{D-1})
        -> (x'_0, ..., x'_{D-1}, log_emission)

over elementwise float32 values: ``x_d`` the state planes, ``y`` the
step's observation (a scalar), ``eps_d`` independent standard normals.  It
keeps the elementwise contract of :mod:`.render`; a function outside it
raises ``ValueError`` naming the construct when the model is built
(:class:`UserKernel`).  The plain version (:func:`user_chunk_plain`) calls
the function on torch tensors.

:class:`UserKernel` renders the function to CUDA C++ (:mod:`.render`),
writes one source per (physics, D) that defines it and includes
``csrc/user_chunk.cuh`` (the kernel, where its design is set out: K7's
loop with the physics in place of the random walk), and builds it with
``nvcc`` at the first launch (``_build.load_generated_library``, into
``ops/_build/``).  On CPU tensors the wrapper runs the plain version; on
CUDA tensors it launches the kernel or raises.

**Draws.**  The Box-Muller pair of absolute step t for plane d sits on
Philox4x32-10 counter (particle, t // 2, d, 0) under the sweep's seed: its
cos half at even t, its sin half at odd t (a launch starting at odd t
recomputes the pair).  So draws do not depend on how a sweep is chunked,
and at D = 1 they are the linear-Gaussian kernel's (``csrc/fused_lg.cu``):
K10 with the linear-Gaussian physics is K7 draw for draw.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..util.profiling import counter_group
from .fused_lg import normal_steps
from .philox import split_seed
from .population import current_stream, launch_population
from .render import analyse_step_elem, render_function

__all__ = ["BLOCK", "KERNEL_BLOCK", "LAUNCHES", "UserKernel", "block_records",
           "render_source", "user_chunk_plain"]

BLOCK = 4096             # particles per record of the plain version
KERNEL_BLOCK = 1024      # particles per CTA and record of the kernel
                         # (csrc/user_chunk.cuh: 256 threads x 4)

# kernel launches, counted where the kernel is launched: "scalar" (K10,
# D = 1), "scalar_step" (its one-step launch), "vector" (K11, D > 1)
LAUNCHES = counter_group("user_chunk", ("scalar", "scalar_step", "vector"))

_HINT = ("a step_elem keeps the elementwise contract of "
         "cpprob_tpu_torch/ops/render.py")


# --------------------------------------------------------------------------
# plain version


def block_records(w: torch.Tensor, block: int) -> torch.Tensor:
    """(ceil(n / block), 3) records (max, sum e, sum e^2) of ``w`` over
    blocks of ``block`` particles."""
    pad = -w.shape[0] % block
    w2 = torch.nn.functional.pad(w, (0, pad), value=-math.inf).view(-1, block)
    m = w2.amax(1)
    e = torch.exp(w2 - m[:, None])
    return torch.stack([m, e.sum(1), (e * e).sum(1)], 1)


def user_chunk_plain(step_elem, D: int, seed: int, states: torch.Tensor,
                     log_w: torch.Tensor, ys: torch.Tensor, n_valid=None, *,
                     t0: int = 1, draws=None):
    """Plain version of the chunk kernel.  ``states`` (n,) for D = 1, else
    (n, D); ``n_valid``: int32 scalar tensor (``None``: every step valid);
    ``t0``: absolute time of the first step.  ``draws``: eps of shape
    (n_steps, D, n) or broadcastable, in place of Philox.  Returns (states,
    log_w, records (ceil(n / BLOCK), 3))."""
    n, n_steps = states.shape[0], ys.shape[0]
    dev = states.device
    xs = [states] if D == 1 else list(states.unbind(1))
    w = log_w
    nv = (torch.tensor(n_steps) if n_valid is None
          else torch.as_tensor(n_valid).reshape(())).to(dev)
    philox = normal_steps(seed, torch.arange(n, device=dev), t0, n_steps,
                          D) if draws is None else None
    for t in range(n_steps):
        eps = (next(philox) if draws is None
               else [torch.broadcast_to(draws[t][d], (n,)) for d in range(D)])
        out = step_elem(*xs, ys[t], *eps)
        valid = t < nv
        xs = [torch.where(valid, nx, x) for nx, x in zip(out[:D], xs)]
        w = torch.where(valid, w + out[D], w)
    new = xs[0] if D == 1 else torch.stack(xs, 1)
    return new, w, block_records(w, BLOCK)


# --------------------------------------------------------------------------
# the kernel: generated source, built at the first launch


_SOURCE = """\
// Generated by cpprob_tpu_torch/ops/user_chunk.py: the user-physics chunk
// kernel of a step_elem over {D} plane(s).
#include <math.h>

namespace user_model {{

constexpr int kD = {D};

{step_elem}
__device__ __forceinline__ void step(const float (&x)[kD], float y,
                                     const float (&eps)[kD], float (&nx)[kD],
                                     float& log_emission) {{
  step_elem({args});
}}

}}  // namespace user_model

#include "user_chunk.cuh"
"""


def render_source(step_cpp: str, D: int) -> str:
    """The generated CUDA source of a ``step_elem`` of D planes rendered to
    C++ (``step_cpp``)."""
    planes = range(D)
    args = ", ".join([f"x[{d}]" for d in planes] + ["y"] + [f"eps[{d}]" for d in planes]
                     + [f"nx[{d}]" for d in planes] + ["log_emission"])
    return _SOURCE.format(D=D, step_elem=step_cpp, args=args)


class UserKernel:
    """The chunk kernel of one ``step_elem`` over ``D`` planes.  Building it
    checks the physics against the contract and renders it to C++
    (``ValueError`` otherwise); the CUDA source is built at the first
    launch."""

    def __init__(self, step_elem, D: int):
        if D < 1:
            raise ValueError(f"state dimension must be >= 1, got {D}")
        self.step_elem, self.D = step_elem, int(D)
        src, consts = analyse_step_elem(step_elem, self.D)
        self._step_cpp = render_function(src, consts, "_k_", outs=self.D + 1,
                                         hint=_HINT)
        self._all_steps: dict = {}
        self._lib = None
        self.library = None   # "user_chunk-<hash>", once built
        self.block = KERNEL_BLOCK   # particles per CTA of the built kernel

    def source(self) -> str:
        """The generated CUDA source."""
        return render_source(self._step_cpp, self.D)

    def _library(self):
        if self._lib is None:
            from ._build import _LIBS, load_generated_library

            lib = load_generated_library("user_chunk", self.source())
            p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            lib.user_chunk_planes.argtypes = []
            lib.user_chunk_planes.restype = i
            lib.user_chunk_block.argtypes = []
            lib.user_chunk_block.restype = i
            lib.user_chunk_launch.argtypes = [p, i, p, u32, u32, u32, p, p, p, p,
                                              p, ctypes.c_longlong, p]
            lib.user_chunk_launch.restype = i
            self.block = lib.user_chunk_block()
            if lib.user_chunk_planes() != self.D:
                raise RuntimeError("the generated user_chunk source's planes "
                                   "differ from the kernel object's")
            self.library = next(k for k, v in _LIBS.items() if v is lib)
            self._lib = lib
        return self._lib

    def chunk(self, seed: int, states: torch.Tensor, log_w: torch.Tensor,
              ys: torch.Tensor, n_valid=None, *, t0: int = 1,
              step: bool = False):
        """The chunk on the device of ``states``: the kernel on CUDA tensors,
        :func:`user_chunk_plain` on CPU tensors.  ``step``: a one-step
        launch (counted apart).  Returns (states, log_w, records: one per
        CTA of the kernel, per ``BLOCK`` particles of the plain version)."""
        D, dev = self.D, states.device
        want = (states.shape[0],) if D == 1 else (states.shape[0], D)
        if tuple(states.shape) != want or log_w.shape != states.shape[:1]:
            raise ValueError(f"states must be {'(n,)' if D == 1 else f'(n, {D})'} "
                             "and log_w (n,)")
        if dev.type == "cpu":
            return user_chunk_plain(self.step_elem, D, seed, states, log_w,
                                    ys, n_valid, t0=t0)
        n, n_steps = states.shape[0], ys.shape[0]
        if not 0 < n < 2 ** 31 or t0 < 0 or t0 + n_steps >= 2 ** 32:
            raise ValueError("need 0 < n < 2^31 and t0 + n_steps < 2^32")
        if n_valid is None:
            if dev not in self._all_steps:
                self._all_steps[dev] = torch.full((1,), 2 ** 30, dtype=torch.int32,
                                                  device=dev)
            n_valid = self._all_steps[dev]
        elif n_valid.numel() != 1:
            raise ValueError("n_valid must be one int32 element")
        lib = self._library()
        k0, k1 = split_seed(seed)
        grid = -(-n // self.block)
        key = "vector" if D > 1 else ("scalar_step" if step else "scalar")

        def launch(x_out, w_out, rec):
            return lib.user_chunk_launch(
                ys.data_ptr(), n_steps, n_valid.data_ptr(), k0, k1, t0,
                states.data_ptr(), log_w.data_ptr(), x_out.data_ptr(),
                w_out.data_ptr(), rec.data_ptr(), n, current_stream(dev))

        return launch_population(
            f"user_chunk_kernel (D={D})", launch, span_name="launch.user_chunk_kernel",
            device=dev,
            inputs=[(states, "states", torch.float32),
                    (log_w, "log_w", torch.float32),
                    (ys, "ys", torch.float32),
                    (n_valid, "n_valid", torch.int32)],
            outputs=[(want, torch.float32), ((n,), torch.float32)],
            records=(grid, 3), counts=LAUNCHES, count_key=key)

"""The user-physics chunk kernels (K10 for D = 1, K11 for D > 1) —
counterparts of ``_make_scalar_chunk_kernel`` and
``_make_vector_chunk_kernel`` (``cpprob_tpu/ops/pallas_ssm.py:588-630,
702-772``).

Per particle the kernel runs ``n_steps`` of the user's physics with
``n_valid`` masking and writes one (max, sum e, sum e^2) record per CTA
(e = exp(w - max w), the layout :func:`~.population.stats_from_partials`
combines).  The physics is a ``step_elem``

    step_elem(x_0, ..., x_{D-1}, y_0, ..., y_{Dy-1}, eps_0, ..., eps_{D-1})
        -> (x'_0, ..., x'_{D-1}, log_emission)

over elementwise float32 values: ``x_d`` the state planes, ``y_k`` the
step's observation (one scalar ``y`` where Dy = 1), ``eps_d`` independent
standard normals.  It keeps the elementwise contract of :mod:`.render`; a
function outside it raises ``ValueError`` naming the construct when the
model is built (:class:`UserKernel`).  The plain version
(:func:`user_chunk_plain`) calls the function on torch tensors.

:class:`UserKernel` renders the function to CUDA C++ (:mod:`.render`),
writes one source per (physics, D, Dy) that defines it and includes
``csrc/user_chunk.cuh`` (the kernel, where its design is set out: K7's
loop with the physics in place of the random walk), and builds it with
``nvcc`` at the first launch (``_build.load_generated_library``, into
``ops/_build/``).  On CPU tensors the wrapper runs the plain version; on
CUDA tensors it launches the kernel or raises.  Two launches:
:meth:`UserKernel.chunk` (steps from t0 with ``n_valid`` masking) and
:meth:`UserKernel.step_ctrl`, one step with the step's resample control,
as K6 carries it (``ops/fused_lg.py`` ``lg_step_ctrl``): the flag in, and
the ESS and the next step's flag out, combined by the launch's last CTA.

**Draws.**  At D = 1 the Box-Muller pair of absolute step t sits on
Philox4x32-10 counter (particle, t // 2, 0, 0) under the sweep's seed: its
cos half at even t, its sin half at odd t (a launch starting at odd t
recomputes the pair); these are the linear-Gaussian kernel's draws
(``csrc/fused_lg.cu``): K10 with the linear-Gaussian physics is K7 draw for
draw.  Above D = 1 step t draws planes 4q..4q+3 from counter (particle, t,
q, 0): words 0-1 the pair of planes 4q and 4q+1, words 2-3 that of 4q+2
and 4q+3 (:func:`vector_normals`), so a one-step launch uses every draw it
makes.  Either way the draws do not depend on how a sweep is chunked.
``seed`` is an
integer or a device key (:func:`.philox.device_key`); the kernel reads the
key's two words on the card (:func:`.philox.launch_key`), so a captured
CUDA graph of a launch draws from the key written before each replay.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..util.profiling import counter_group
from .fused_lg import _ticket, box_muller, normal_steps
from .philox import launch_key, philox4x32, split_seed
from .population import current_stream, launch_population, stats_from_partials
from .render import analyse_step_elem, render_function

__all__ = ["BLOCK", "KERNEL_BLOCK", "LAUNCHES", "UserKernel", "block_records",
           "render_source", "user_chunk_plain", "user_step_ctrl_plain",
           "vector_normals"]

BLOCK = 4096             # particles per record of the plain version
KERNEL_BLOCK = 1024      # particles per CTA and record of the kernel up to
                         # D = 2 (csrc/user_chunk.cuh: 256 threads x 4; 512
                         # above, read from the built library)

# kernel launches, counted where the kernel is launched: "scalar" (K10,
# D = 1), "scalar_step" (its one-step launch), "vector" (K11, D > 1),
# "vector_step_ctrl" (K11's one-step launch with the step's resample control)
LAUNCHES = counter_group("user_chunk", ("scalar", "scalar_step", "vector",
                                        "vector_step_ctrl"))

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


def vector_normals(seed: int, g: torch.Tensor, t: int, planes: int) -> list:
    """The eps planes of absolute step ``t`` of a model of ``planes`` > 1
    state planes, as K11 draws them: planes 4q..4q+3 from Philox counter
    (g, t, q, 0), words 0-1 the Box-Muller pair of planes 4q and 4q+1 (cos,
    sin), words 2-3 that of 4q+2 and 4q+3."""
    k0, k1 = split_seed(seed)
    out = []
    for q in range(-(-planes // 4)):
        b = philox4x32(g, t, q, 0, k0, k1)
        out.extend(box_muller(b[0], b[1]))
        if 4 * q + 2 < planes:
            out.extend(box_muller(b[2], b[3]))
    return out[:planes]


def _draws(seed: int, g: torch.Tensor, t0: int, n_steps: int, D: int):
    """The eps planes of each step of a launch from absolute step ``t0``:
    a list of ``D`` tensors a step."""
    if D == 1:
        return normal_steps(seed, g, t0, n_steps)
    return (vector_normals(seed, g, t, D) for t in range(t0, t0 + n_steps))


def _observation_planes(y_t: torch.Tensor) -> list:
    """One step's observation as the ``y`` arguments of a ``step_elem``:
    the scalar itself, or the planes of a (Dy,) vector."""
    return [y_t] if y_t.dim() == 0 else list(y_t.unbind(0))


def user_chunk_plain(step_elem, D: int, seed: int, states: torch.Tensor,
                     log_w: torch.Tensor, ys: torch.Tensor, n_valid=None, *,
                     t0: int = 1, draws=None):
    """Plain version of the chunk kernel.  ``states`` (n,) for D = 1, else
    (n, D); ``ys`` (n_steps,) scalar observations or (n_steps, Dy);
    ``n_valid``: int32 scalar tensor (``None``: every step valid); ``t0``:
    absolute time of the first step.  ``draws``: eps of shape (n_steps, D,
    n) or broadcastable, in place of Philox.  Returns (states, log_w,
    records (ceil(n / BLOCK), 3))."""
    n, n_steps = states.shape[0], ys.shape[0]
    dev = states.device
    xs = [states] if D == 1 else list(states.unbind(1))
    w = log_w
    nv = (torch.tensor(n_steps) if n_valid is None
          else torch.as_tensor(n_valid).reshape(())).to(dev)
    philox = (_draws(seed, torch.arange(n, device=dev), t0, n_steps, D)
              if draws is None else None)
    for t in range(n_steps):
        eps = (next(philox) if draws is None
               else [torch.broadcast_to(draws[t][d], (n,)) for d in range(D)])
        out = step_elem(*xs, *_observation_planes(ys[t]), *eps)
        valid = t < nv
        xs = [torch.where(valid, nx, x) for nx, x in zip(out[:D], xs)]
        w = torch.where(valid, w + out[D], w)
    new = xs[0] if D == 1 else torch.stack(xs, 1)
    return new, w, block_records(w, BLOCK)


def user_step_ctrl_plain(step_elem, D: int, seed: int, states: torch.Tensor,
                         log_w: torch.Tensor, y: torch.Tensor, t: int,
                         flag: torch.Tensor, threshold: float):
    """Plain version of the one-step launch with the step's resample
    control at absolute time ``t`` (``y`` the step's observation, a scalar
    or (Dy,)): where ``flag`` (int32 scalar) is set the weights start from
    0; the ESS from ``stats_from_partials`` on the records.  Returns
    (states, log_w, ess (float64), next flag (int32): ess < threshold)."""
    w = torch.where(flag.reshape(()) != 0, torch.zeros_like(log_w), log_w)
    x, w, rec = user_chunk_plain(step_elem, D, seed, states, w, y[None], t0=t)
    ess = stats_from_partials(rec, states.shape[0])[0]
    return x, w, ess, (ess < threshold).to(torch.int32)


# --------------------------------------------------------------------------
# the kernel: generated source, built at the first launch


_SOURCE = """\
// Generated by cpprob_tpu_torch/ops/user_chunk.py: the user-physics chunk
// kernel of a step_elem over {D} plane(s) and {Dy} observation plane(s).
#include <math.h>

namespace user_model {{

constexpr int kD = {D};
constexpr int kDy = {Dy};

{step_elem}
__device__ __forceinline__ void step(const float (&x)[kD],
                                     const float (&y_row)[kDy],
                                     const float (&eps)[kD], float (&nx)[kD],
                                     float& log_emission) {{
{prologue}  step_elem({args});
}}

}}  // namespace user_model

#include "user_chunk.cuh"
"""


def render_source(step_cpp: str, D: int, Dy: int = 1) -> str:
    """The generated CUDA source of a ``step_elem`` of D state planes and
    Dy observation planes rendered to C++ (``step_cpp``)."""
    ys = ["y"] if Dy == 1 else [f"y_row[{k}]" for k in range(Dy)]
    prologue = "  const float y = y_row[0];\n" if Dy == 1 else ""
    args = ", ".join([f"x[{d}]" for d in range(D)] + ys + [f"eps[{d}]" for d in range(D)]
                     + [f"nx[{d}]" for d in range(D)] + ["log_emission"])
    return _SOURCE.format(D=D, Dy=Dy, step_elem=step_cpp, prologue=prologue, args=args)


class UserKernel:
    """The chunk kernel of one ``step_elem`` over ``D`` state planes and
    ``Dy`` observation planes.  Building it checks the physics against the
    contract and renders it to C++ (``ValueError`` otherwise); the CUDA
    source is built at the first launch."""

    def __init__(self, step_elem, D: int, Dy: int = 1):
        if D < 1 or Dy < 1:
            raise ValueError(f"state and observation dimensions must be >= 1, "
                             f"got {D} and {Dy}")
        self.step_elem, self.D, self.Dy = step_elem, int(D), int(Dy)
        src, consts = analyse_step_elem(step_elem, self.D, self.Dy)
        self._step_cpp = render_function(src, consts, "_k_", outs=self.D + 1,
                                         hint=_HINT)
        self._all_steps: dict = {}
        self._lib = None
        self.library = None   # "user_chunk-<hash>", once built
        self.block = KERNEL_BLOCK   # particles per CTA of the built kernel

    def source(self) -> str:
        """The generated CUDA source."""
        return render_source(self._step_cpp, self.D, self.Dy)

    def _library(self):
        if self._lib is None:
            from ._build import _LIBS, load_generated_library

            lib = load_generated_library("user_chunk", self.source())
            p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            for name in ("user_chunk_planes", "user_chunk_obs_planes", "user_chunk_block"):
                getattr(lib, name).argtypes = []
                getattr(lib, name).restype = i
            lib.user_chunk_launch.argtypes = [p, i, p, p, u32, p, p, p, p, p,
                                              ctypes.c_longlong, p, p, p, p, p,
                                              ctypes.c_double]
            lib.user_chunk_launch.restype = i
            self.block = lib.user_chunk_block()
            if (lib.user_chunk_planes(), lib.user_chunk_obs_planes()) != (self.D, self.Dy):
                raise RuntimeError("the generated user_chunk source's planes "
                                   "differ from the kernel object's")
            self.library = next(k for k, v in _LIBS.items() if v is lib)
            self._lib = lib
        return self._lib

    def _check(self, states, log_w, ys):
        """The states' shape, ``(n,)`` or ``(n, D)``; raises on states,
        weights or observations (``ys``: a step a row) of other shapes."""
        want = (states.shape[0],) if self.D == 1 else (states.shape[0], self.D)
        if tuple(states.shape) != want or log_w.shape != states.shape[:1]:
            raise ValueError(f"states must be {'(n,)' if self.D == 1 else f'(n, {self.D})'} "
                             "and log_w (n,)")
        if tuple(ys.shape[1:]) != (() if self.Dy == 1 else (self.Dy,)):
            raise ValueError(f"observations must be a step a row of {self.Dy}, "
                             f"got {tuple(ys.shape)}")
        return want

    def _launch(self, seed, states, log_w, ys, n_valid, t0, count_key, flag=None,
                threshold=0.0):
        """The kernel on CUDA tensors: the chunk launch (``n_valid`` an int32
        device scalar), or with ``flag`` the one-step launch with the step's
        resample control, whose ESS (float64) and next flag (int32) follow
        the states and weights among the outputs."""
        want, dev = self._check(states, log_w, ys), states.device
        n, n_steps = states.shape[0], ys.shape[0]
        if not 0 < n < 2 ** 31 or t0 < 0 or t0 + n_steps >= 2 ** 32:
            raise ValueError("need 0 < n < 2^31 and t0 + n_steps < 2^32")
        lib = self._library()
        inputs = [(states, "states", torch.float32), (log_w, "log_w", torch.float32),
                  (ys, "ys", torch.float32)]
        outputs = [(want, torch.float32), ((n,), torch.float32)]
        if flag is None:
            inputs.append((n_valid, "n_valid", torch.int32))
        else:
            if flag.numel() != 1:
                raise ValueError("flag must be one int32 element")
            inputs.append((flag, "flag", torch.int32))
            outputs += [((), torch.float64), ((), torch.int32)]

        def launch(x_out, w_out, *rest):
            *ctrl_out, rec = rest
            stream = current_stream(dev)
            if flag is None:
                ctrl = (None, None, None, None, 0.0)
            else:
                ess, nxt = ctrl_out
                ctrl = (flag.data_ptr(), _ticket(dev, stream.value).data_ptr(),
                        ess.data_ptr(), nxt.data_ptr(), threshold)
            return lib.user_chunk_launch(
                ys.data_ptr(), n_steps, None if n_valid is None else n_valid.data_ptr(),
                launch_key(seed, dev), t0, states.data_ptr(), log_w.data_ptr(),
                x_out.data_ptr(), w_out.data_ptr(), rec.data_ptr(), n, stream, *ctrl)

        return launch_population(
            f"user_chunk_kernel (D={self.D})", launch,
            span_name="launch.user_chunk_kernel", device=dev, inputs=inputs,
            outputs=outputs, records=(-(-n // self.block), 3), counts=LAUNCHES,
            count_key=count_key)

    def chunk(self, seed: int, states: torch.Tensor, log_w: torch.Tensor,
              ys: torch.Tensor, n_valid=None, *, t0: int = 1,
              step: bool = False):
        """The chunk on the device of ``states``: the kernel on CUDA tensors,
        :func:`user_chunk_plain` on CPU tensors.  ``step``: a one-step
        launch (counted apart).  Returns (states, log_w, records: one per
        CTA of the kernel, per ``BLOCK`` particles of the plain version)."""
        self._check(states, log_w, ys)
        dev = states.device
        if dev.type == "cpu":
            return user_chunk_plain(self.step_elem, self.D, seed, states, log_w,
                                    ys, n_valid, t0=t0)
        if n_valid is None:
            if dev not in self._all_steps:
                self._all_steps[dev] = torch.full((1,), 2 ** 30, dtype=torch.int32,
                                                  device=dev)
            n_valid = self._all_steps[dev]
        elif n_valid.numel() != 1:
            raise ValueError("n_valid must be one int32 element")
        key = "vector" if self.D > 1 else ("scalar_step" if step else "scalar")
        return self._launch(seed, states, log_w, ys, n_valid, t0, key)

    def step_ctrl(self, seed: int, states: torch.Tensor, log_w: torch.Tensor,
                  y: torch.Tensor, t: int, flag: torch.Tensor, threshold: float):
        """One step at absolute time ``t`` (``y`` the step's observation, a
        scalar or (Dy,)) with the step's resample control: where ``flag``
        (int32 scalar on the population's device) is set, every particle
        starts from weight 0; ``threshold`` is the ESS below which the next
        step resamples (float64, ``ess_threshold * n``).  The kernel on CUDA
        tensors (its last CTA combines the records in float64), the plain
        version on CPU tensors.  Returns (states, log_w, ess (float64
        scalar), next flag (int32 scalar))."""
        if states.device.type == "cpu":
            return user_step_ctrl_plain(self.step_elem, self.D, seed, states, log_w,
                                        y, t, flag, threshold)
        x, w, ess, nxt, _ = self._launch(
            seed, states, log_w, y[None], None, t,
            "vector_step_ctrl" if self.D > 1 else "scalar_step", flag=flag,
            threshold=float(threshold))
        return x, w, ess, nxt

"""K12's tensor-core twin: the guided scalar chunk kernel with the proposal
net's hidden layers on the tensor cores — counterpart of
``_make_guided_scalar_chunk_kernel_mxu`` (``cpprob_tpu/ops/pallas_ssm.py:948``),
the formulation the reference's ``attach_fused_guided_scalar_kernels``
runs by default (``mxu=True``).

It computes the function of the FMA K12
(:func:`~.guided_scalar.guided_scalar_chunk_plain`, the float32 net of
``_net_plain``): per particle-step the Box-Muller eps of absolute step t,
the net's ``(mean, raw)``, the move and the exact Radon-Nikodym weight.
Only the net's products and sums differ: 3xTF32 ``mma.sync`` and another
order of summation, float32-level rounding.  One ``(mean, std)`` both
samples and scores each move, so the weight stays exact whatever that
rounding, as the reference's MXU twin argues for its bf16 operands.

The kernel body is fixed (``csrc/guided_tc.cuh``, where its design is
set out); :class:`GuidedTensorCoreKernel` generates one CUDA source per
pair of densities and set of layer sizes, which defines the sizes and the
densities as ``__device__`` functions and includes the header, and builds
it with ``nvcc`` at the first launch (``_build.load_generated_library``).
The weights reach the kernel as one packed float32 buffer
(:func:`pack_weights`): per later layer its biases and its B fragments in
each lane's order, rows permuted within each block of 8 so that a layer's
C fragment is the next layer's A fragment, split into TF32 hi and lo
parts.  :func:`tc_net_plain` replays that arithmetic from the packed
buffer in plain torch, so the packing is held to ``_net_plain`` on the
CPU.

The densities keep the contract of :mod:`.render` and are rendered to
C++ by it (:func:`~.guided_scalar.render_density`, shared with K12:
round-to-nearest intrinsics, CUDA's precise transcendentals, so each
operation rounds as torch's float32 one does).  Anything else raises
``ValueError`` when the kernel object is built.

Limits: at least one hidden layer (a linear ``[3, 2]`` head takes K12, as
the reference's ``pallas_ssm.py:1135`` does); hidden widths up to
:func:`guided_tc_max_width`, 64, the trainer's default width (each padded
to a multiple of 8 with zero weights, which is exact); any depth, unrolled
at build time.  A net whose hidden layers are all at most
:data:`NARROW_WIDTH` wide takes the narrow layout (:data:`GROUPS`
particles a thread); a wider one the wide layout (the first layer formed
block by block inside the first hidden->hidden product, :func:`groups`
particles a thread), counted under ``guided_tc.wide``.  Both compute
the same function from the same packed buffer.  On CPU tensors the wrapper
runs :func:`~.guided_scalar.guided_scalar_chunk_plain`.

``seed``, in :meth:`GuidedTensorCoreKernel.chunk`, is an integer or a device
key (:func:`.philox.device_key`, two int32 words on the population's
device).  The kernel reads the key's words on the card (``csrc/philox.cuh``
``LaunchKey``; an integer is written there first, :func:`.philox.launch_key`),
so that a captured CUDA graph of a launch given a device key draws from the
key written before each replay; the plain version reads them on the host.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..util.profiling import counter_group
from .guided_scalar import check_scalar_net, guided_scalar_chunk_plain, render_density
from .philox import launch_key
from .population import launch_population

__all__ = ["GROUPS", "LAUNCHES", "NARROW_WIDTH", "GuidedTensorCoreKernel",
           "groups", "guided_tc_max_width", "is_wide", "pack_weights", "padded_sizes",
           "render_density", "render_source", "tc_net_plain", "tf32_round"]

TC_THREADS = 256          # csrc/guided_tc.cuh kThreads
GROUPS = 2                # csrc/guided_tc.cuh kGroups: particles a thread
NARROW_WIDTH = 32         # the widest hidden layer of the narrow layout
MAX_WIDTH = 64

# kernel launches, counted where the kernel is launched: the narrow layout
# under "guided_tc", the wide one under "wide"
LAUNCHES = counter_group("guided_tc", ("guided_tc", "wide"))

_PERM = (0, 2, 4, 6, 1, 3, 5, 7)   # A fragment k position -> C column


def guided_tc_max_width() -> int:
    """The widest hidden layer the kernel takes: a thread holds, for each
    of its particles, one layer's activations and the next layer's
    accumulators in registers (C fragments of two 16-row tiles), so the
    register file, not the depth, sets the limit.  Up to
    :data:`NARROW_WIDTH` a thread takes two particles (up to 254 registers
    at width 32); above it the first layer is never held whole (the wide
    layout, :func:`groups` particles a thread), up to 64, the width
    ``train_ssm_proposal`` gives by default (``chip_smoke.py`` holds both
    layouts free of local memory on the card)."""
    return MAX_WIDTH


def is_wide(sizes) -> bool:
    """Whether a net of ``sizes`` takes the wide layout: a hidden layer
    wider than :data:`NARROW_WIDTH` (after padding to a multiple of 8)."""
    return max(padded_sizes(sizes)[1:-1], default=0) > NARROW_WIDTH


def groups(sizes) -> int:
    """Particles a thread for a net of ``sizes`` (``csrc/guided_tc.cuh``
    ``kGroups``): :data:`GROUPS` in the narrow layout; in the wide one two
    where a single hidden->hidden layer takes the fused first layer
    (``[3, H, H', 2]``), one otherwise."""
    if not is_wide(sizes):
        return GROUPS
    return 2 if len(sizes) == 4 else 1


def _pad8(h: int) -> int:
    return -(-h // 8) * 8


def padded_sizes(sizes) -> list:
    """The layer sizes the kernel runs: each hidden width rounded up to a
    multiple of 8."""
    return [sizes[0], *(_pad8(h) for h in sizes[1:-1]), sizes[-1]]


# --------------------------------------------------------------------------
# TF32 and the packed weights


def tf32_round(a) -> np.ndarray:
    """float32 values rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds; infinities and NaNs
    unchanged."""
    a = np.ascontiguousarray(a, np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    r = (((u + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF).astype(np.uint32).view(np.float32)
    return np.where(np.isfinite(a), r, a).astype(np.float32)


def _tf32_round_t(v: torch.Tensor) -> torch.Tensor:
    """:func:`tf32_round` on a float32 tensor."""
    i = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = (((i + 0x1000) & 0xFFFFE000) & 0xFFFFFFFF)
    r = torch.where(r >= 2 ** 31, r - 2 ** 32, r).to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(v), r, v)


def _tf32_trunc_t(v: torch.Tensor) -> torch.Tensor:
    """The TF32 value the tensor cores read from a float32 register: its
    low 13 bits dropped."""
    return (v.view(torch.int32) & -0x2000).view(torch.float32)


def _split(a: np.ndarray):
    hi = tf32_round(a)
    return hi, tf32_round(a.astype(np.float32) - hi)


def pack_weights(Ws, bs) -> np.ndarray:
    """The packed float32 buffer of a checked ``[3, H.., 2]`` net, in the
    layout of ``csrc/guided_tc.cuh`` ``layer_floats``: the first layer as
    ``(w_x, w_y, w_t, b)`` per (padded) unit; then per hidden->hidden layer
    its biases and its B fragments, block (kb, nb), lane (g, t): ``(hi b0,
    hi b1, lo b0, lo b1)`` with b0 = W[8 kb + 2t, 8 nb + g] and b1 = W[8 kb
    + 2t + 1, 8 nb + g], hi and lo the TF32 split; the output layer as
    ``(b_mean, b_raw, 0, 0)`` and, per block kb and t, rows 8 kb + 2t and 8
    kb + 2t + 1, ``(w_mean, w_raw)`` each."""
    sizes = [Ws[0].shape[0]] + [W.shape[1] for W in Ws]
    ps = padded_sizes(sizes)
    L = len(Ws)
    first = np.zeros((ps[1], 4), np.float32)
    first[:sizes[1], 0] = Ws[0][0]
    first[:sizes[1], 1] = Ws[0][1]
    first[:sizes[1], 2] = Ws[0][2]
    first[:sizes[1], 3] = bs[0]
    out = [first.ravel()]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for li in range(1, L):
        K = ps[li]
        if li == L - 1:
            W = np.zeros((K, 2), np.float32)
            W[:sizes[li]] = Ws[li]
            out += [np.array([bs[li][0], bs[li][1], 0, 0], np.float32), W.ravel()]
            continue
        N = ps[li + 1]
        W = np.zeros((K, N), np.float32)
        b = np.zeros(N, np.float32)
        W[:sizes[li], :sizes[li + 1]] = Ws[li]
        b[:sizes[li + 1]] = bs[li]
        hi, lo = _split(W)
        frag = np.zeros((K // 8, N // 8, 32, 4), np.float32)
        for kb in range(K // 8):
            for nb in range(N // 8):
                r0, r1, col = 8 * kb + 2 * t, 8 * kb + 2 * t + 1, 8 * nb + g
                frag[kb, nb, :, 0] = hi[r0, col]
                frag[kb, nb, :, 1] = hi[r1, col]
                frag[kb, nb, :, 2] = lo[r0, col]
                frag[kb, nb, :, 3] = lo[r1, col]
        out += [b, frag.ravel()]
    return np.concatenate(out).astype(np.float32)


def _layer_offsets(ps):
    """Offsets of weight layers 1.. in the packed buffer (``offset`` of the
    header) and its length."""
    L = len(ps) - 1
    offs, off = [], 4 * ps[1]
    for li in range(1, L):
        offs.append(off)
        off += 4 + 2 * ps[li] if li == L - 1 else ps[li + 1] * (1 + 2 * ps[li])
    return offs, off


def tc_net_plain(packed: torch.Tensor, sizes, x: torch.Tensor, y, tf, *,
                 one_tf32: bool = False):
    """(mean, raw) of the net at states ``x`` (n,), replayed from the packed
    buffer as the kernel computes them in either layout (the wide one forms
    the same first-layer values where the product takes them): the first
    layer as a fused multiply-add ``x w_x + c``, each later layer's B
    operands rebuilt from the lanes' fragments, the activations taken in
    the A fragments' k order (C column ``_PERM[p]`` at k position p) and
    split into hi (rounded to
    TF32) and lo (the rest, which the tensor cores truncate to TF32), each
    product as lo·hi + hi·lo + hi·hi added to the bias in that order, ReLU
    between layers, and the output layer a float32 product.  The tensor
    cores sum each product's eight terms in their own order, and the kernel
    the output layer's; here torch does.  ``one_tf32``: each product hi·hi
    alone, 1xTF32 (``util/guided_tc_parts.py``'s ``one_tf32`` control)."""
    ps = padded_sizes(list(sizes))
    offs, total = _layer_offsets(ps)
    if packed.numel() != total:
        raise ValueError(f"packed buffer of {packed.numel()} floats, the layout "
                         f"of {ps} has {total}")
    L = len(ps) - 1
    first = packed[:4 * ps[1]].view(ps[1], 4)
    c = first[:, 1] * y + first[:, 2] * tf + first[:, 3]
    # the fused multiply-add x w_x + c, rounded once
    act = torch.relu((x[:, None].double() * first[:, 0].double() + c.double()).float())
    lane = torch.arange(32)
    g, t = lane >> 2, lane & 3
    perm = torch.tensor(_PERM)
    for li in range(1, L):
        K = ps[li]
        o = offs[li - 1]
        if li == L - 1:
            # the FMA pipe: rows (8 kb + 2t, 8 kb + 2t + 1) in each lane's
            # float4, summed in float32 (the kernel fuses and sums in its
            # own order)
            W = packed[o + 4:o + 4 + 2 * K].view(K, 2)
            out = act @ W + packed[o:o + 2]
            return out[:, 0], out[:, 1]
        N = ps[li + 1]
        bias = packed[o:o + N]
        frag = packed[o + N:o + N + 2 * K * N].view(K // 8, N // 8, 32, 4)
        # B in the A fragments' k order: b0 of lane (g, t) at (k = t, n = g),
        # b1 at (k = t + 4, n = g) of each 8 x 8 block
        B = torch.zeros(2, K // 8, 8, N // 8, 8)
        for kb in range(K // 8):
            for nb in range(N // 8):
                for h, (i0, i1) in enumerate(((0, 1), (2, 3))):
                    B[h, kb, t, nb, g] = frag[kb, nb, :, i0]
                    B[h, kb, t + 4, nb, g] = frag[kb, nb, :, i1]
        B = B.reshape(2, K // 8, 8, N)
        a = act.view(-1, K // 8, 8)[:, :, perm]                  # A fragments' k order
        a_hi = _tf32_round_t(a)
        a_lo = _tf32_trunc_t(a - a_hi)
        acc = bias.expand(a.shape[0], N).clone()
        for kb in range(K // 8):
            if not one_tf32:
                acc = acc + a_lo[:, kb] @ B[0, kb]
                acc = acc + a_hi[:, kb] @ B[1, kb]
            acc = acc + a_hi[:, kb] @ B[0, kb]
        act = torch.relu(acc)


# --------------------------------------------------------------------------
# the generated source


_SOURCE = """\
// Generated by cpprob_tpu_torch/ops/guided_tc.py: the guided tensor-core
// chunk kernel of a {sizes} proposal net (run as {padded}) and two densities.
#include <math.h>

namespace guided_tc_model {{

constexpr int kLayers = {layers};
constexpr int kWidths[kLayers + 1] = {{{widths}}};

{trans}
{obs}
}}  // namespace guided_tc_model

#include "guided_tc.cuh"
"""


def render_source(sizes, trans_cpp: str, obs_cpp: str) -> str:
    """The generated CUDA source of one net shape and density pair."""
    ps = padded_sizes(sizes)
    return _SOURCE.format(sizes=list(sizes), padded=ps, layers=len(ps) - 1,
                          widths=", ".join(str(v) for v in ps),
                          trans=trans_cpp, obs=obs_cpp)


# --------------------------------------------------------------------------
# the kernel


class GuidedTensorCoreKernel:
    """K12's tensor-core twin for one proposal net and two densities
    (module docstring).  Building it checks the net (at least one hidden
    layer, widths up to :func:`guided_tc_max_width`) and renders the
    densities (``ValueError`` otherwise); the CUDA source is built at the
    first launch.  ``wide``: whether the net takes the wide layout."""

    def __init__(self, params, trans_logpdf_elem, obs_logpdf_elem, T: int):
        self.params, self.T = params, int(T)
        self.trans, self.obs = trans_logpdf_elem, obs_logpdf_elem
        Ws, bs = check_scalar_net(params)
        self.sizes = [Ws[0].shape[0]] + [W.shape[1] for W in Ws]
        if len(Ws) < 2:
            raise ValueError("the tensor-core kernel needs at least one hidden "
                             "layer; a linear [3, 2] head runs with mxu=False")
        if max(self.sizes[1:-1]) > MAX_WIDTH:
            raise ValueError(
                f"hidden widths {self.sizes[1:-1]} exceed the tensor-core "
                f"kernel's limit of {guided_tc_max_width()} "
                "(guided_tc_max_width()); build the model with mxu=False")
        self.wide = is_wide(self.sizes)
        self._packed = pack_weights(Ws, bs)
        self._trans_cpp = render_density(trans_logpdf_elem, "trans_logpdf_elem",
                                         "x, nx, t", "_kt_")
        self._obs_cpp = render_density(obs_logpdf_elem, "obs_logpdf_elem",
                                       "nx, y, t", "_ko_")
        self._weights: dict = {}
        self._all_steps: dict = {}
        self._lib = None
        self.library = None   # "guided_tc-<hash>", once built

    def layer_sizes(self) -> list:
        return list(self.sizes)

    def source(self) -> str:
        """The generated CUDA source."""
        return render_source(self.sizes, self._trans_cpp, self._obs_cpp)

    def packed(self, device="cpu") -> torch.Tensor:
        """The packed weight buffer on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._weights:
            self._weights[device] = torch.as_tensor(self._packed, device=device)
        return self._weights[device]

    def block(self) -> int:
        """Particles per CTA, one record each."""
        return TC_THREADS * groups(self.sizes)

    def _library(self):
        if self._lib is None:
            from ._build import _LIBS, load_generated_library

            lib = load_generated_library("guided_tc", self.source())
            p, i, u32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32
            lib.guided_tc_block.argtypes = []
            lib.guided_tc_block.restype = i
            lib.guided_tc_weights.argtypes = []
            lib.guided_tc_weights.restype = i
            lib.guided_tc_launch.argtypes = [p, i, p, p, u32, ctypes.c_float,
                                             p, p, p, p, p, p, ctypes.c_longlong, p]
            lib.guided_tc_launch.restype = i
            if (lib.guided_tc_block(), lib.guided_tc_weights()) != (
                    self.block(), self._packed.shape[0]):
                raise RuntimeError("the generated guided_tc source's block or "
                                   "weight layout differs from guided_tc.py's")
            self.library = next(k for k, v in _LIBS.items() if v is lib)
            self._lib = lib
        return self._lib

    def chunk(self, seed: int, states: torch.Tensor, log_w: torch.Tensor,
              ys: torch.Tensor, n_valid=None, *, t0: int = 1, draws=None):
        """The chunk on the device of ``states`` (n,) float32: the kernel on
        CUDA tensors, :func:`~.guided_scalar.guided_scalar_chunk_plain` on CPU
        tensors (``draws``: eps in place of Philox, CPU only).  Returns
        (states, log_w, records)."""
        from .population import current_stream

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
        wts = self.packed(dev)
        grid = -(-n // self.block())

        def launch(x_out, w_out, rec):
            return lib.guided_tc_launch(
                ys.data_ptr(), n_steps, n_valid.data_ptr(),
                launch_key(seed, dev), t0, float(self.T), wts.data_ptr(),
                states.data_ptr(), log_w.data_ptr(), x_out.data_ptr(),
                w_out.data_ptr(), rec.data_ptr(), n, current_stream(dev))

        return launch_population(
            "guided_tc_kernel", launch, span_name="launch.guided_tc_kernel", device=dev,
            inputs=[(states, "states", torch.float32),
                    (log_w, "log_w", torch.float32),
                    (ys, "ys", torch.float32),
                    (n_valid, "n_valid", torch.int32)],
            outputs=[((n,), torch.float32), ((n,), torch.float32)],
            records=(grid, 3), counts=LAUNCHES,
            count_key="wide" if self.wide else "guided_tc")

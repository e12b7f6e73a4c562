"""The card's calibration kernels (K17-K21) — counterparts of the five
Pallas micro-kernels of ``examples/roofline.py``.

CUDA C++ in ``csrc/calibrate.cu``; each wrapper has a plain PyTorch twin
(``*_plain``), which it runs on CPU tensors only (on CUDA tensors it
launches the kernel or raises):

- :func:`calibrate_fp32` (K17, <- ``calibrate_vpu``): eight chains from
  ``x (1 + 1e-6 i)``, each ``steps`` fused multiply-adds ``v <- v *
  1.0000001 + 1e-7``; out = the chains' sum.  2 · 8 · steps FLOP per element.
- :func:`calibrate_tensor_cores` (K18, <- ``calibrate_mxu``): chains ``c <-
  (bf16(c) @ bf16(b)) * 1e-3``, ``reps`` products each, float32 sums; out =
  the chains' sum.  The reference keeps 8 chains of (512, 512) in VMEM; here
  each warpgroup runs ``TC_CHAINS`` chains on 64 rows of ``a`` (rows, 64),
  each product four ``wgmma`` m64n64k16 with the chain in registers and
  ``b`` (64, 64) in shared memory.
- :func:`calibrate_hbm` (K19, <- ``calibrate_hbm``): ``x + 1``.
- :func:`calibrate_normals` (K20a, <- ``calibrate_prng``): ``acc = x``, then
  ``pairs`` Box-Muller pairs (the construction of ``fused_lg``'s kernels:
  one Philox call per pair, counter (element, pair, stream)) added to it;
  out = ``acc * 1e-9``.  :func:`calibrate_philox` (K20b): the same with one
  uniform per Philox call (counter (element, call, stream)), as the chain
  kernels draw.
- :func:`calibrate_transcendental` (K21, <- ``calibrate_transcendental``):
  ``chain`` steps of ``a <- log1p(exp(-|a|)) + 0.3``.

The default sizes are the reference's (``roofline.py:60-202``); the
roofline (``util/roofline.py``) times the kernels and turns them into rates.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..util.profiling import counter_group
from .fused_lg import _normal_pair
from .philox import philox_uniform, split_seed
from .population import check_tensor
from .population import current_stream as _stream
from .population import raise_on as _raise_on

__all__ = [
    "FP32_N", "FP32_STEPS", "HBM_SIZES", "LAUNCHES", "PRNG_DRAWS", "PRNG_N",
    "TC_CHAINS", "TC_DIM", "TC_REPS", "TC_ROWS", "TRANS_CHAIN", "TRANS_N",
    "calibrate_fp32", "calibrate_fp32_plain", "calibrate_hbm",
    "calibrate_hbm_plain", "calibrate_normals", "calibrate_normals_plain",
    "calibrate_philox", "calibrate_philox_plain", "calibrate_tensor_cores",
    "calibrate_tensor_cores_plain", "calibrate_transcendental",
    "calibrate_transcendental_plain", "tensor_core_operands",
]

FP32_N = (1 << 15) * 128          # calibrate_vpu: rows 2^15 x 128 lanes
FP32_STEPS = 2048 // 8            # chain 2048 over eight chains
TC_DIM = 64                       # csrc/calibrate.cu kTcDim
TC_CHAINS = 2                     # chains per warpgroup (kTcChains)
TC_ROWS_PER_CTA = 64              # one warpgroup, wgmma's 64 rows
TC_ROWS = 1 << 15                 # 512 CTAs: about four per SM
TC_REPS = 512                     # 2^37 multiply-adds in all
HBM_SIZES = ((1 << 17) * 128, (1 << 19) * 128)   # 128 MB and 512 MB moved
PRNG_N = (1 << 14) * 128          # calibrate_prng: rows 2^14 x 128
PRNG_DRAWS = 512                  # normals per element: 256 pairs
TRANS_N = (1 << 14) * 128
TRANS_CHAIN = 1024

# kernel launches by wrapper, counted where each wrapper launches its kernel
LAUNCHES = counter_group("calibrate", (
    "fp32", "tensor_cores", "hbm", "normals", "philox", "transcendental"))

_FMA_MUL = float(np.float32(1.0000001))
_FMA_ADD = float(np.float32(1e-7))


def _chain_scales(k: int):
    """float32 ``1 + 1e-6 i`` for i < k, as the reference's weakly typed
    product rounds them."""
    return [float(np.float32(1.0 + 1e-6 * i)) for i in range(k)]


# --------------------------------------------------------------------------
# plain versions


def calibrate_fp32_plain(x: torch.Tensor, steps: int = FP32_STEPS) -> torch.Tensor:
    """K17's function.  Each fused multiply-add is taken in float64 and
    rounded once to float32: the float64 sum is exact while the chains stay
    in [2^-30, 64) in magnitude (the product of two float32 values has 48
    bits, the addend's last bit is 2^-47), so there it rounds as
    ``__fmaf_rn`` does."""
    v = torch.stack([x * s for s in _chain_scales(8)])
    for _ in range(steps):
        v = (v.double() * _FMA_MUL + _FMA_ADD).float()
    acc = v[0]
    for i in range(1, 8):
        acc = acc + v[i]
    return acc


def tensor_core_operands(rows: int, seed: int = 0):
    """K18's operands as float32 numpy arrays: ``a`` (rows, 64) standard
    normal and ``b`` = 1000 Q, Q a random orthogonal (64, 64) matrix, so the
    chain's ``* 1e-3`` keeps each row's norm (the reference starts at 0.01
    and underflows within a few products)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, TC_DIM)).astype(np.float32)
    q, r = np.linalg.qr(rng.standard_normal((TC_DIM, TC_DIM)))
    b = (1000.0 * q * np.sign(np.diag(r))).astype(np.float32)
    return a, b


def calibrate_tensor_cores_plain(a: torch.Tensor, b: torch.Tensor,
                                 reps: int = TC_REPS,
                                 chains: int = TC_CHAINS) -> torch.Tensor:
    """K18's function: operands rounded to bf16 before every product, the
    products and the chains' sum in float32."""
    bb = b.to(torch.bfloat16).float()
    acc = None
    for s in _chain_scales(chains):
        c = a * s
        for _ in range(reps):
            c = (c.to(torch.bfloat16).float() @ bb) * 1e-3
        acc = c if acc is None else acc + c
    return acc


def calibrate_hbm_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def calibrate_normals_plain(seed: int, x: torch.Tensor, pairs: int,
                            stream: int = 0) -> torch.Tensor:
    """K20a's function: ``acc = x``; ``acc += r cos``, ``acc += r sin`` for
    each pair (``fused_lg._normal_pair`` on counter (element, pair,
    stream)); ``acc * 1e-9``."""
    g = torch.arange(x.shape[0], device=x.device)
    acc = x
    for p in range(pairs):
        rc, rs = _normal_pair(seed, g, p, stream)
        acc = acc + rc + rs
    return acc * 1e-9


def calibrate_philox_plain(seed: int, x: torch.Tensor, calls: int,
                           stream: int = 0) -> torch.Tensor:
    """K20b's function: ``acc = x``; ``acc +=`` the uniform of Philox at
    counter (element, call, stream) for each call; ``acc * 1e-9``."""
    g = torch.arange(x.shape[0], device=x.device)
    acc = x
    for c in range(calls):
        acc = acc + philox_uniform(seed, g, c, stream)
    return acc * 1e-9


def calibrate_transcendental_plain(x: torch.Tensor,
                                   chain: int = TRANS_CHAIN) -> torch.Tensor:
    a = x
    for _ in range(chain):
        a = torch.log1p(torch.exp(-a.abs())) + 0.3
    return a


# --------------------------------------------------------------------------
# kernels


def _lib():
    from ._build import load_library

    lib = load_library("calibrate")
    if lib.fp32_chain_launch.argtypes is None:
        p, i, ll, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_uint32
        for name in ("tc_rows_per_cta", "tc_dim", "tc_chains"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        lib.fp32_chain_launch.argtypes = [p, ll, i, p, p]
        lib.tensor_core_launch.argtypes = [p, p, ll, i, p, p]
        lib.add_one_launch.argtypes = [p, ll, p, p]
        lib.normal_rate_launch.argtypes = [p, ll, i, u, u, u, p, p]
        lib.philox_rate_launch.argtypes = [p, ll, i, u, u, u, p, p]
        lib.transcendental_launch.argtypes = [p, ll, i, p, p]
        for name in ("fp32_chain_launch", "tensor_core_launch", "add_one_launch",
                     "normal_rate_launch", "philox_rate_launch",
                     "transcendental_launch"):
            getattr(lib, name).restype = i
        if (lib.tc_rows_per_cta(), lib.tc_dim(), lib.tc_chains()) != (
                TC_ROWS_PER_CTA, TC_DIM, TC_CHAINS):
            raise RuntimeError("csrc/calibrate.cu's K18 tile differs from "
                               "ops/calibrate.py's")
    return lib


def _launch(what: str, key: str, x: torch.Tensor, launch):
    """Checks ``x`` (a contiguous float32 vector on a CUDA device), allocates
    the output, launches ``launch(out, stream)``, raises on a refused launch
    and counts it."""
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {x.device}")
    check_tensor(x, "x", torch.float32, x.device)
    if x.dim() != 1 or x.shape[0] == 0:
        raise ValueError(f"{what} takes a non-empty vector, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    _raise_on(launch(_lib(), out, _stream(x.device)), what)
    LAUNCHES[key] += 1
    return out


def _positive(name: str, v: int):
    if int(v) < 1:
        raise ValueError(f"{name} must be at least 1, got {v}")
    return int(v)


def calibrate_fp32(x: torch.Tensor, steps: int = FP32_STEPS) -> torch.Tensor:
    """K17 on a CUDA tensor, the plain version on a CPU tensor."""
    steps = _positive("steps", steps)
    if x.device.type == "cpu":
        return calibrate_fp32_plain(x, steps)
    return _launch("fp32_chain_kernel", "fp32", x, lambda lib, out, s: (
        lib.fp32_chain_launch(x.data_ptr(), x.shape[0], steps, out.data_ptr(), s)))


def calibrate_tensor_cores(a: torch.Tensor, b: torch.Tensor,
                           reps: int = TC_REPS) -> torch.Tensor:
    """K18 on CUDA tensors (``a`` (rows, 64) with rows a multiple of 64,
    ``b`` (64, 64), float32), the plain version on CPU tensors."""
    reps = _positive("reps", reps)
    if a.device.type == "cpu":
        return calibrate_tensor_cores_plain(a, b, reps)
    dev = a.device
    if dev.type != "cuda":
        raise ValueError(f"tensor_core_kernel runs on cpu or cuda tensors, not {dev}")
    check_tensor(a, "a", torch.float32, dev)
    check_tensor(b, "b", torch.float32, dev)
    rows = a.shape[0]
    if (a.dim() != 2 or a.shape[1] != TC_DIM or rows == 0
            or rows % TC_ROWS_PER_CTA or b.shape != (TC_DIM, TC_DIM)):
        raise ValueError(f"a must be (rows, {TC_DIM}) with rows a multiple of "
                         f"{TC_ROWS_PER_CTA}, b ({TC_DIM}, {TC_DIM}); got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    out = torch.empty_like(a)
    _raise_on(_lib().tensor_core_launch(a.data_ptr(), b.data_ptr(), rows, reps,
                                        out.data_ptr(), _stream(dev)),
              "tensor_core_kernel")
    LAUNCHES["tensor_cores"] += 1
    return out


def calibrate_hbm(x: torch.Tensor) -> torch.Tensor:
    """K19 on a CUDA tensor (length a multiple of 4), the plain version on
    a CPU tensor."""
    if x.device.type == "cpu":
        return calibrate_hbm_plain(x)
    n = x.shape[0]
    if n % 4:
        raise ValueError(f"add_one_kernel takes a length that is a multiple of 4, got {n}")
    return _launch("add_one_kernel", "hbm", x, lambda lib, out, s: (
        lib.add_one_launch(x.data_ptr(), n, out.data_ptr(), s)))


def calibrate_normals(seed: int, x: torch.Tensor, pairs: int = PRNG_DRAWS // 2,
                      stream: int = 0) -> torch.Tensor:
    """K20a on a CUDA tensor (at most 2^32 elements), the plain version on
    a CPU tensor."""
    pairs = _positive("pairs", pairs)
    if x.device.type == "cpu":
        return calibrate_normals_plain(seed, x, pairs, stream)
    k0, k1 = split_seed(seed)
    return _launch("normal_rate_kernel", "normals", x, lambda lib, out, s: (
        lib.normal_rate_launch(x.data_ptr(), x.shape[0], pairs, stream, k0, k1,
                               out.data_ptr(), s)))


def calibrate_philox(seed: int, x: torch.Tensor, calls: int = PRNG_DRAWS,
                     stream: int = 0) -> torch.Tensor:
    """K20b on a CUDA tensor, the plain version on a CPU tensor."""
    calls = _positive("calls", calls)
    if x.device.type == "cpu":
        return calibrate_philox_plain(seed, x, calls, stream)
    k0, k1 = split_seed(seed)
    return _launch("philox_rate_kernel", "philox", x, lambda lib, out, s: (
        lib.philox_rate_launch(x.data_ptr(), x.shape[0], calls, stream, k0, k1,
                               out.data_ptr(), s)))


def calibrate_transcendental(x: torch.Tensor,
                             chain: int = TRANS_CHAIN) -> torch.Tensor:
    """K21 on a CUDA tensor, the plain version on a CPU tensor."""
    chain = _positive("chain", chain)
    if x.device.type == "cpu":
        return calibrate_transcendental_plain(x, chain)
    return _launch("transcendental_kernel", "transcendental", x,
                   lambda lib, out, s: lib.transcendental_launch(
                       x.data_ptr(), x.shape[0], chain, out.data_ptr(), s))

"""Where the guided tensor-core twin's time goes: variants of
``csrc/guided_tc.cuh``, each with one part of ``guided_tc_kernel`` changed,
timed on the card beside the Triton K12.

    python -m cpprob_tpu_torch.util.guided_tc_parts [--n 16777216]

Each variant is the header with one substitution, pasted into the source
that ``ops/guided_tc.py`` generates for a ``[3,16,16,2]`` net (random,
seeded) and the linear-Gaussian densities, built at its first launch and
run on the same population for 8 steps: ``full`` (the kernel as it is),
``cvt_split`` (hi and lo by ``cvt.rna.tf32.f32``), ``trunc_split`` (hi by
masking the low 13 bits: one integer operation fewer, 2^-20 in place of
2^-21 a product), ``double_mma`` (every ``mma.sync`` issued twice: the
tensor cores' share of the time shows as the difference), ``no_draws``
(eps a constant: no Philox call, no Box-Muller pair), ``no_tail_math``
(softplus and log std without their exp, log1p and log) and ``one_tf32``
(1xTF32: both lo terms dropped, each product hi times hi alone, ~2^-11 a
product; ``chip_smoke.py`` holds it to fail the check that the twin
passes).  Only ``full``, ``cvt_split`` and ``trunc_split`` compute the
twin's function; the others' times alone mean something.  Prints one JSON line: the card, the times in
ms (CUDA events, 10 launches after a warm-up; the list in turns, forward
and then backward) and the Triton K12's on the same inputs.  It needs the
card.
"""

from __future__ import annotations

import argparse
import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = ["VARIANTS", "main", "variant_kernel", "variant_sources"]

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)

_SPLIT = "  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;\n"
_LO = "  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));\n"
_MMA = '  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
_B_LO = "        const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);\n"
_DRAW = "      if (even || s == 0) {\n"
_SOFTPLUS = "          __fadd_rn(fmaxf(raw, 0.f), log1pf(expf(-fabsf(raw)))), 1e-6f);\n"
_LOG_SD = "          __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, eps), eps), logf(sd)), kHalfLog2Pi);\n"

# each variant: the substitutions it makes in the header
VARIANTS = {
    "full": [],
    "cvt_split": [(_SPLIT, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(v));\n'),
                  (_LO, '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : '
                        '"f"(__fsub_rn(v, __uint_as_float(hi))));\n')],
    "trunc_split": [(_SPLIT, "  hi = __float_as_uint(v) & 0xffffe000u;\n")],
    "double_mma": [(_MMA, '  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n'
                          '      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, '
                          '{%10, %11, %12, %13};\\n"\n'
                          '      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])\n'
                          '      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), '
                          '"r"(b0), "r"(b1),\n'
                          '        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));\n'
                          '  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "\n')],
    "no_draws": [(_DRAW, "      if (false) {\n")],
    "no_tail_math": [(_SOFTPLUS, "          __fadd_rn(fmaxf(raw, 0.f), fabsf(raw)), 1e-6f);\n"),
                     (_LOG_SD, "          __fsub_rn(__fmul_rn(__fmul_rn(-0.5f, eps), eps), sd), "
                               "kHalfLog2Pi);\n")],
    "one_tf32": [(_LO, "  lo = 0u;\n"), (_B_LO, "        const uint32_t bl0 = 0u, bl1 = 0u;\n")],
}


def variant_sources(src: str) -> dict:
    """The variants' headers from the kernel's (raises if a substitution no
    longer finds its line)."""
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: the line {old.strip()!r} is gone")
            text = text.replace(old, new)
        out[name] = text
    return out


def variant_kernel(name: str, params, trans_logpdf_elem, obs_logpdf_elem, T: int):
    """A :class:`~..ops.guided_tc.GuidedTensorCoreKernel` whose generated
    source holds variant ``name`` of the header in its place."""
    from ..ops import guided_tc

    header = (Path(guided_tc.__file__).resolve().parent / "csrc" / "guided_tc.cuh").read_text()
    text = variant_sources(header)[name]
    k = guided_tc.GuidedTensorCoreKernel(params, trans_logpdf_elem, obs_logpdf_elem, T)
    src = k.source().replace('#include "guided_tc.cuh"', text)
    k.source = lambda: src
    return k


def trans_lp(x, nx, t):
    d = nx - x
    return -0.5 * d * d - HALF_LOG_2PI


def obs_lp(nx, y, t):
    d = y - nx
    return -0.5 * d * d - HALF_LOG_2PI


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("guided_tc_parts times the card: no CUDA device")
    from ..interop import mlp_params_from_numpy
    from ..ops.triton_ssm import GuidedScalarKernel
    from .profiling import gpu_name_and_power
    from .roofline import time_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    sizes = [3, 16, 16, 2]
    layers = [{"w": (0.25 * rng.standard_normal((a, b))).astype(np.float32),
               "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    params = mlp_params_from_numpy(layers, device=dev)
    kernels = {name: variant_kernel(name, params, trans_lp, obs_lp, 16) for name in VARIANTS}
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k._library(), kernels.values()))
    kernels["triton K12"] = GuidedScalarKernel(params, trans_lp, obs_lp, 16)
    n = args.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x0 = torch.randn(n, generator=gen, device=dev)
    w0 = torch.zeros(n, device=dev)
    ys = torch.randn(8, generator=gen, device=dev)
    times = {}
    for order in (list(kernels), list(kernels)[::-1]):
        for name in order:
            k = kernels[name]
            times.setdefault(name, []).append(
                time_ms(lambda: k.chunk(3, x0, w0, ys, t0=1), 10))
    out = {"card": gpu_name_and_power(), "n": n, "steps": 8, "sizes": sizes,
           "ms": times}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

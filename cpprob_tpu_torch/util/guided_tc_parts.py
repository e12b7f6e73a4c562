"""Where the time of K12's two twins goes: variants of
``csrc/guided_tc.cuh`` (the tensor-core twin), each with one part of
``guided_tc_kernel`` changed, and the designs of ``csrc/guided_scalar.cuh``
(K12 on the FMA pipe), timed on the card side by side.

    python -m cpprob_tpu_torch.util.guided_tc_parts [--n 16777216]

Each tensor-core variant is the header with one substitution, pasted into
the source that ``ops/guided_tc.py`` generates for a ``[3,16,16,2]`` net
(random, seeded) and the linear-Gaussian densities
(``models/linear_gaussian.py``), built at its first
launch and run on the same population for 8 steps: ``full`` (the kernel
as it is), ``cvt_split`` (hi and lo by ``cvt.rna.tf32.f32``),
``trunc_split`` (hi by masking the low 13 bits: one integer operation
fewer, 2^-20 in place of 2^-21 a product), ``double_mma`` (every
``mma.sync`` issued twice: the tensor cores' share of the time shows as
the difference), ``no_draws`` (eps a constant: no Philox call, no
Box-Muller pair), ``no_tail_math`` (softplus and log std without their
exp, log1p and log) and ``one_tf32`` (1xTF32: both lo terms dropped, each
product hi times hi alone, ~2^-11 a product; ``chip_smoke.py`` holds it to
fail the check that the twin passes).  Only ``full``, ``cvt_split`` and
``trunc_split`` compute the twin's function; the others' times alone mean
something.

K12's designs, on the same net and inputs (``K12_DESIGNS``): ``K12`` (the
kernel as it is: the weights baked in as float32 literals, four particles
a thread), ``K12 1 a thread`` and ``K12 2 a thread`` (``kPerThread``
substituted in the generated source), and ``K12 weights as parameters``
at four and at two particles a thread (the net's weights a by-value
kernel-parameter struct read from the constant bank, so one build serves
every net of a shape: the generated net reads ``kw.v[i]`` where the kept
design has a literal).  Each must give the kept kernel's states and
weights bit for bit.  The kept design and the parameter designs are built
one after the other and timed (the rest together); each design's
registers, spills, stack frame, instructions, ``FFMA`` count and largest
loop (``util/sass.py``) are printed.

Prints one JSON line: the card, the times in ms (CUDA events, 10 launches
after a warm-up; the list in turns, forward and then backward), the builds
and the machine code.  It needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from ..models.linear_gaussian import obs_logpdf_elem, trans_logpdf_elem

__all__ = ["K12_DESIGNS", "VARIANTS", "k12_design", "main", "variant_kernel",
           "variant_sources"]

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


K12_DESIGNS = ("K12", "K12 1 a thread", "K12 2 a thread", "K12 weights as parameters",
               "K12 weights as parameters, 2 a thread")

# the substitutions that make K12's header take its weights as a kernel
# parameter
_PARAM_SUBS = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <string.h>\n"),
    ("                     long long n) {\n",
     "                     long long n, const Weights kw) {\n"),
    ("first_consts(y, __fdiv_rn(tt, T), c);", "first_consts(kw, y, __fdiv_rn(tt, T), c);"),
    ("net(x[p], c, mean[p], raw[p]);", "net(kw, x[p], c, mean[p], raw[p]);"),
    ("float* rec, long long n, void* stream) {\n",
     "float* rec, long long n, void* stream,\n"
     "                         const float* host_w) {\n"
     "  guided_scalar_model::Weights kw;\n  memcpy(&kw, host_w, sizeof kw);\n"),
    ("x_in, w_in, x_out, w_out, rec, n);", "x_in, w_in, x_out, w_out, rec, n, kw);"),
]


class _ParamLaunch:
    """A K12 library whose launch takes the host weights as its last
    argument (the parameter design)."""

    def __init__(self, lib, weights):
        self._lib, self._w = lib, weights

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def guided_scalar_launch(self, *args):
        return self._lib.guided_scalar_launch(
            *args, self._w.ctypes.data_as(ctypes.c_void_p))


def k12_design(name: str, params, trans_logpdf_elem, obs_logpdf_elem, T: int):
    """A :class:`~..ops.guided_scalar.GuidedScalarKernel` of design ``name``
    (``K12_DESIGNS``) whose generated source carries that design."""
    from ..ops import guided_scalar as gs

    if name not in K12_DESIGNS:
        raise ValueError(f"unknown K12 design {name!r}")
    k = gs.GuidedScalarKernel(params, trans_logpdf_elem, obs_logpdf_elem, T)
    src = k.source()
    if name.endswith("a thread"):
        p = int(name.split()[-3])
        line = f"constexpr int kPerThread = {gs.per_thread(k.layer_sizes())};"
        if line not in src:
            raise ValueError(f"design {name}: the line {line!r} is gone")
        src = src.replace(line, f"constexpr int kPerThread = {p};")
        k.block = lambda: 256 * p
    if "weights as parameters" in name:
        values = []

        def weight(v):
            values.append(np.float32(v))
            return f"kw.v[{len(values) - 1}]"

        net = gs.render_net(*k._net, weight=weight)
        net = net.replace("void first_consts(float y", "void first_consts(const Weights& kw, float y")
        net = net.replace("void net(float x", "void net(const Weights& kw, float x")
        header = (Path(gs.__file__).resolve().parent / "csrc" / "guided_scalar.cuh").read_text()
        for old, new in _PARAM_SUBS:
            if old not in header:
                raise ValueError(f"design {name}: the line {old.strip()!r} is gone")
            header = header.replace(old, new)
        baked = gs.render_net(*k._net)
        src = src.replace(baked, f"struct Weights {{ float v[{len(values)}]; }};\n\n{net}")
        src = src.replace('#include "guided_scalar.cuh"', header)
        weights = np.array(values, np.float32)
        plain_library = k._library

        def library():
            if not isinstance(k._lib, _ParamLaunch):
                lib = plain_library()
                lib.guided_scalar_launch.argtypes = [
                    *lib.guided_scalar_launch.argtypes, ctypes.c_void_p]
                k._lib = _ParamLaunch(lib, weights)
            return k._lib

        k._library = library
    k.source = lambda: src
    return k


def _machine_code(k) -> dict:
    from .sass import kernel_report

    (f, r), = kernel_report(k.library, "guided_scalar_kernel").items()
    ops = r["opcodes"]
    return {"registers": r["registers"], "spills": r["spills"], "stack": r["stack"],
            "local": ops.get("LDL", 0) + ops.get("STL", 0),
            "instructions": r["instructions"], "FFMA": ops.get("FFMA", 0),
            "loops": r["loops"][:2]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("guided_tc_parts times the card: no CUDA device")
    from ..interop import mlp_params_from_numpy
    from .profiling import gpu_name_and_power
    from .roofline import time_ms

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    sizes = [3, 16, 16, 2]
    layers = [{"w": (0.25 * rng.standard_normal((a, b))).astype(np.float32),
               "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
              for a, b in zip(sizes[:-1], sizes[1:])]
    params = mlp_params_from_numpy(layers, device=dev)
    dens = (trans_logpdf_elem, obs_logpdf_elem)
    k12 = {name: k12_design(name, params, *dens, 16) for name in K12_DESIGNS}
    builds = {}
    for name in ("K12", "K12 weights as parameters", "K12 weights as parameters, 2 a thread"):
        start = time.perf_counter()
        k12[name]._library()
        builds[name] = time.perf_counter() - start
    kernels = {name: variant_kernel(name, params, *dens, 16) for name in VARIANTS}
    rest = [k for name, k in k12.items() if name not in builds] + list(kernels.values())
    with ThreadPoolExecutor(len(rest)) as pool:
        list(pool.map(lambda k: k._library(), rest))
    kernels.update(k12)
    n = args.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x0 = torch.randn(n, generator=gen, device=dev)
    w0 = torch.zeros(n, device=dev)
    ys = torch.randn(8, generator=gen, device=dev)
    want = k12["K12"].chunk(3, x0, w0, ys, t0=1)
    same = {}
    for name, k in k12.items():
        got = k.chunk(3, x0, w0, ys, t0=1)
        same[name] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    if not all(same.values()):
        raise AssertionError(f"a K12 design computes another function: {same}")
    times = {}
    for order in (list(kernels), list(kernels)[::-1]):
        for name in order:
            k = kernels[name]
            times.setdefault(name, []).append(
                time_ms(lambda: k.chunk(3, x0, w0, ys, t0=1), 10))
    out = {"card": gpu_name_and_power(), "n": n, "steps": 8, "sizes": sizes,
           "ms": times, "k12_build_s": builds, "k12_bit_equal": same,
           "k12_machine_code": {name: _machine_code(k) for name, k in k12.items()}}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

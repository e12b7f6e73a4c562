"""Where K14's time goes: variants of ``csrc/stream_resample.cu``'s
``lse_stats_kernel``, each with one part changed, and the two-launch
design it replaced, timed in turns on the card.

    python -m cpprob_tpu_torch.util.lse_parts [--n 16777216]

Each variant is the kernel source with one substitution, built with the
flags of ``ops/_build.py`` (one nvcc each, all started together) into a
temporary directory and launched through its own ``lse_stats_launch`` on
the same weights: ``kept`` (the kernel as it is: four 16-byte loads a
thread a batch, the batch's max first, its own float64 exp
``exp_nonpos``, the combine by the last CTA), ``loads_only`` (no exp and
no sum: the loads and the max), ``f32_exp`` (``__expf`` in float32 in
place of the float64 exp), ``libm_exp`` (the CUDA math library's float64
``exp`` in place of ``exp_nonpos``, the weights' terms only),
``no_combine`` (the last CTA returns before it folds the records),
``vec2`` and ``vec8`` (two or eight 16-byte loads a thread a batch), and
``two_launch`` (the design it replaced: one 4-byte load a thread per
grid-stride step, the sum rescaled whenever the max rises, at most 8 CTAs
an SM, and a second one-CTA launch for the combine).  ``kept``,
``libm_exp``, ``vec2``, ``vec8`` and ``two_launch`` must give the plain
version's max exactly and its wtot within rtol 1e-12; the others compute
wrong stats, and only their times mean something.  For comparison: the
kept kernel through its wrapper (``logsumexp_stats``: its checks,
scratch and output allocation on the host), ``torch.logsumexp`` and
``torch.amax`` (one read of the weights) on the same weights.  Prints one
JSON line (also written to ``chiprun_out/lse_parts.json``): the card,
each variant's registers and spill bytes, and the times in ms (CUDA
events, 20 launches after a warm-up, in turns, forward then backward).
It needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["TWO_LAUNCH_SOURCE", "VARIANTS", "main", "variant_sources"]

_SUM = ("  for (int k = 0; k < kN; ++k) s = __dadd_rn(s, exp_nonpos((double)x[k] - md, "
        "tab));")
_COMBINE = "  if (!last_s) return;"
_VEC = "constexpr int kLseVec = 4;"

# each variant: the substitutions it makes in the source
VARIANTS = {
    "kept": [],
    "loads_only": [(_SUM, "  (void)md;")],
    "f32_exp": [(_SUM, "  for (int k = 0; k < kN; ++k) "
                       "s = __dadd_rn(s, (double)__expf(x[k] - m));")],
    "libm_exp": [(_SUM, "  for (int k = 0; k < kN; ++k) "
                        "s = __dadd_rn(s, exp((double)x[k] - md));")],
    "no_combine": [(_COMBINE, "  return;")],
    "vec2": [(_VEC, "constexpr int kLseVec = 2;")],
    "vec8": [(_VEC, "constexpr int kLseVec = 8;")],
}
# the variants that compute the stats
EXACT = ("kept", "libm_exp", "vec2", "vec8", "two_launch")

# The design lse_stats_kernel replaced, whole, behind the same C interface
# (its ticket and cap unused).
TWO_LAUNCH_SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
#include "block_reduce.cuh"

namespace {
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
stats_kernel(const float* __restrict__ lw, long long n,
             const int* __restrict__ flag, float* __restrict__ rec_m,
             double* __restrict__ rec_s) {
  __shared__ float redf[kThreads / 32];
  __shared__ float bcastf[1];
  __shared__ double redd[kThreads / 32];
  __shared__ double bcastd[1];
  if (flag != nullptr && *flag == 0) return;
  float m = -INFINITY;
  double s = 0.0;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long g = (long long)blockIdx.x * kThreads + threadIdx.x; g < n;
       g += stride) {
    const float x = lw[g];
    if (x > m) {
      s = (m == -INFINITY)
              ? 1.0
              : __dadd_rn(__dmul_rn(s, exp((double)m - (double)x)), 1.0);
      m = x;
    } else if (x != -INFINITY) {
      s += exp((double)x - (double)m);
    }
  }
  const float mb = block_max<kThreads>(m, redf, bcastf);
  double v[1] = {(m == -INFINITY) ? 0.0 : s * exp((double)m - (double)mb)};
  block_sum<kThreads, 1>(v, redd, bcastd);
  if (threadIdx.x == 0) {
    rec_m[blockIdx.x] = mb;
    rec_s[blockIdx.x] = v[0];
  }
}

__global__ void __launch_bounds__(kThreads)
combine_kernel(const float* __restrict__ rec_m,
               const double* __restrict__ rec_s, int n_rec,
               const int* __restrict__ flag, double* __restrict__ stats) {
  __shared__ float redf[kThreads / 32];
  __shared__ float bcastf[1];
  __shared__ double redd[kThreads / 32];
  __shared__ double bcastd[1];
  if (flag != nullptr && *flag == 0) return;
  float m = -INFINITY;
  for (int i = threadIdx.x; i < n_rec; i += kThreads) m = fmaxf(m, rec_m[i]);
  const float mb = block_max<kThreads>(m, redf, bcastf);
  double v[1] = {0.0};
  for (int i = threadIdx.x; i < n_rec; i += kThreads)
    if (rec_m[i] != -INFINITY)
      v[0] = __dadd_rn(v[0],
                       __dmul_rn(rec_s[i], exp((double)rec_m[i] - (double)mb)));
  block_sum<kThreads, 1>(v, redd, bcastd);
  if (threadIdx.x == 0) {
    stats[0] = (double)mb;
    stats[1] = v[0];
  }
}
}  // namespace

extern "C" int lse_stats_launch(const float* lw, long long n, const int* flag,
                                float* rec_m, double* rec_s, int* ticket,
                                int cap, double* stats, void* stream) {
  (void)ticket;
  cudaStream_t s = (cudaStream_t)stream;
  long long grid = (n + kThreads - 1) / kThreads;
  if (grid > cap) grid = cap;
  stats_kernel<<<(int)grid, kThreads, 0, s>>>(lw, n, flag, rec_m, rec_s);
  int err = (int)cudaGetLastError();
  if (err) return err;
  combine_kernel<<<1, kThreads, 0, s>>>(rec_m, rec_s, (int)grid, flag, stats);
  return (int)cudaGetLastError();
}
"""


def variant_sources(src: str) -> dict:
    """The variants' sources from the kernel's (raises if a substitution
    no longer finds its line), and ``two_launch``."""
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: the line {old.strip()!r} is gone")
            text = text.replace(old, new)
        out[name] = text
    out["two_launch"] = TWO_LAUNCH_SOURCE
    return out


def _build(tmp: Path, name: str, src: str):
    from ..ops._build import NVCC_FLAGS, _nvcc
    from .sass import parse_registers, parse_spills

    cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lse_stats_launch.argtypes = [p, ctypes.c_longlong, p, p, p, p, i, p, p]
    lib.lse_stats_launch.restype = i
    log = proc.stdout + proc.stderr
    spills = parse_spills(log)
    regs = {f.split("_cu_")[-1]: [r, spills.get(f)]
            for f, r in parse_registers(log).items()
            if "stats_kernel" in f or "combine_kernel" in f}
    return lib, regs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("lse_parts times the card: no CUDA device")
    from ..ops import stream_resample as sr
    from .profiling import gpu_name_and_power
    from .roofline import time_ms

    csrc = Path(sr.__file__).resolve().parent / "csrc"
    dev = torch.device("cuda")
    n = args.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    lw = 2 * torch.randn(n, generator=gen, device=dev)
    want = sr.logsumexp_stats_plain(lw)
    cap = 8 * torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, tmp)
        srcs = variant_sources((csrc / "stream_resample.cu").read_text())
        with ThreadPoolExecutor(len(srcs)) as pool:
            built = dict(zip(srcs, pool.map(lambda kv: _build(tmp, *kv), srcs.items())))
        launches = {}
        for name, (lib, _) in built.items():
            rec_m = torch.zeros(cap, dtype=torch.float32, device=dev)
            rec_s = torch.zeros(cap, dtype=torch.float64, device=dev)
            ticket = torch.zeros(1, dtype=torch.int32, device=dev)
            stats = torch.zeros(2, dtype=torch.float64, device=dev)

            def launch(lib=lib, name=name, rec_m=rec_m, rec_s=rec_s, ticket=ticket,
                       stats=stats):
                err = lib.lse_stats_launch(lw.data_ptr(), n, None, rec_m.data_ptr(),
                                           rec_s.data_ptr(), ticket.data_ptr(), cap,
                                           stats.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"variant {name}: launch error {err}")
                return stats

            launches[name] = launch
            if name in EXACT:
                got = launch().clone()
                torch.cuda.synchronize()
                if float(got[0]) != float(want[0]) or not torch.allclose(
                        got[1], want[1], rtol=1e-12, atol=0):
                    raise AssertionError(f"variant {name}: {got.tolist()} against "
                                         f"the plain version's {want.tolist()}")
        launches["logsumexp_stats"] = lambda: sr.logsumexp_stats(lw)
        launches["torch.logsumexp"] = lambda: torch.logsumexp(lw, 0)
        launches["torch.amax"] = lambda: torch.amax(lw)
        times = {name: [] for name in launches}
        order = list(launches)
        for names in (order, order[::-1]):
            for name in names:
                times[name].append(time_ms(launches[name], 20))
    out = {"card": gpu_name_and_power(), "n": n, "ms": times,
           "registers": {name: regs for name, (_, regs) in built.items()}}
    line = json.dumps(out)
    os.makedirs("chiprun_out", exist_ok=True)
    Path("chiprun_out/lse_parts.json").write_text(line + "\n")
    print(line)
    return out


if __name__ == "__main__":
    main()

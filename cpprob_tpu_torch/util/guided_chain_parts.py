"""The guided chain kernel's designs (K13) timed beside each other and
beside K8 on the card: ``csrc/fused_hmm.cu`` built with other values of
its design constants, and, optionally, other versions of the source.

    python -m cpprob_tpu_torch.util.guided_chain_parts [--other NAME=DIR ...]

Variants, each the source with one constant substituted: ``tables_kernel``
(the source as it is: ``guided_tables_kernel`` builds each step's tables
once, one CTA a step, into a global buffer, and the chunk kernel, launched
after it with programmatic dependent launch, copies a tile's into shared
memory with one barrier), ``no_pdl`` (the same two kernels launched one
after the other, no overlap), ``in_cta`` (no tables kernel: every CTA of
the chunk kernel builds the tables of each tile itself, layer by layer
over (step, state, unit) together, n_layers + 1 barriers a tile, the
weights read through the cache), and for each ``--other NAME=DIR`` the
``fused_hmm.cu``
of that ``csrc`` directory (say the parent commit's, unpacked with ``git
archive``: there every CTA built each step's tables, one step after the
other; its K8 launch must take the key as this source's does, from two
device words).  Each variant is built (one nvcc each, all started together) and
launched through its own library on the same inputs: K13 at K = 5 with a
random ``[7,16,16,5]`` net (2^24 particles x 8 steps; 2^24 x 16 steps with
an island check after step 8; one step at 2^20, the flag on), and K8
(``hmm_chunk_kernel<5>``, the same particle loop without the tables) at
the first shapes.  Every variant must give the kept one's states, weights
and records bit for bit.  Prints one JSON line (also written to
``chiprun_out/guided_chain_parts.json``): the card; each variant's times
in ms (CUDA events, 10 launches after a warm-up; the variants in turns,
forward and then backward); the host's enqueue time of one chunk in µs
(host clock over 50 launches that do not wait for the card); the tables
kernel alone; and each instance's registers and local memory.  It needs
the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = ["VARIANTS", "in_cta_subs", "main"]

_PDL = "constexpr bool kGuidedPdl = true;"

# each variant: the substitutions it makes in the source (``in_cta``: see
# in_cta_subs)
VARIANTS = {
    "tables_kernel": [],
    "no_pdl": [(_PDL, "constexpr bool kGuidedPdl = false;")],
    "in_cta": None,
}

# design (b): the chunk kernel takes the net and builds each tile's tables
# itself (guided_build over the tile's steps: n_layers + 1 barriers), with
# the one-kernel launch signature of the source before the tables kernel
_SIGNATURE = """guided_chunk_kernel(const float* tabs, int n_steps,
                    const int* __restrict__ ctrl, uint32_t k0, uint32_t k1,"""
_SIGNATURE_B = """guided_chunk_kernel(const float* __restrict__ tab,
                    const float* __restrict__ ltab, const float* net,
                    NetDims nd, float T, const float* __restrict__ ys,
                    int n_steps,
                    const int* __restrict__ ctrl, uint32_t k0, uint32_t k1,"""
_WAIT = """  asm volatile("griddepcontrol.wait;" ::: "memory");
"""
_STAGE = """    for (int i = threadIdx.x; i < len * kTab; i += kThreads)
      tables[i] = __ldcg(tabs + (long long)t * kTab + i);
    __syncthreads();
"""
_BUILD = """    guided_build<K>(net, nd, tab, ltab, ys + t, len, t0 + (uint32_t)t, T,
                    tables + min(n_steps, kTile) * kTab, tables);
"""
_LAUNCH_B = """int guided_chunk_launch(int K, const float* tab, const float* ltab,
                        const float* net, int n_layers, const int* dims,
                        float T, const float* ys, int n_steps, const int* ctrl,
                        uint32_t k0, uint32_t k1, uint32_t t0,
                        int island_every, float thresh, const int* s_in,
                        const float* w_in, int* s_out, float* w_out,
                        float* rec, long long n, void* stream) {
  NetDims nd;
  if (n % kIsland != 0 || n_steps < 1 || !guided_net_dims(K, n_layers, dims, &nd))
    return (int)cudaErrorInvalidValue;
  // a tile's tables and the activations of its steps
  const size_t smem = (size_t)(n_steps < kTile ? n_steps : kTile) *
                      (2 * K * K + K + 2 * K * nd.stride) * sizeof(float);
  if (smem > (size_t)kGuidedActBytes) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n / kIsland);
  switch (K) {
#define GUIDED_CHUNK_CASE(KK)                                                \\
  case KK:                                                                   \\
    cudaFuncSetAttribute(guided_chunk_kernel<KK>,                            \\
                         cudaFuncAttributeMaxDynamicSharedMemorySize,        \\
                         kGuidedActBytes);                                   \\
    guided_chunk_kernel<KK><<<grid, kThreads, smem, (cudaStream_t)stream>>>( \\
        tab, ltab, net, nd, T, ys, n_steps, ctrl, k0, k1, t0, island_every,  \\
        thresh, s_in, w_in, s_out, w_out, rec);                              \\
    break;
    GUIDED_CHUNK_CASE(2) GUIDED_CHUNK_CASE(3) GUIDED_CHUNK_CASE(4)
    GUIDED_CHUNK_CASE(5) GUIDED_CHUNK_CASE(6) GUIDED_CHUNK_CASE(7)
    GUIDED_CHUNK_CASE(8)
#undef GUIDED_CHUNK_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

"""


def in_cta_subs(text: str) -> list:
    """The substitutions that turn ``fused_hmm.cu`` (``text``) into design
    (b): the kernel's signature, its wait and copy of the tables into the
    build, and the whole ``guided_chunk_launch`` into a plain launch of the
    one kernel."""
    start = text.index("int guided_chunk_launch(")
    end = text.index("#define HMM_SMALL_K")
    return [(_SIGNATURE, _SIGNATURE_B), (_WAIT, ""), (_STAGE, _BUILD),
            (text[start:end], _LAUNCH_B)]


# each timed launch: (name, n, steps, n_valid, flag, t0, island_every)
_CASES = [
    ("K13", 1 << 24, 8, 8, 0, 1, 0),
    ("K13_16_island", 1 << 24, 16, 15, 0, 1, 8),
    ("K13_step", 1 << 20, 1, 1, 1, 5, 0),
]


def _library(name: str, source: str):
    from ..ops import _build, fused_hmm

    lib = _build.load_generated_library(name, source)
    p, i, u32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.hmm_chunk_launch.argtypes = [i, p, p, i, p, p, u32, i, f, p, p, p, p,
                                     p, ctypes.c_longlong, p]
    if not name.endswith("in_cta") and hasattr(lib, "guided_tables_launch"):
        fused_hmm._guided_argtypes(lib)
    else:   # one kernel, the tables built in every CTA
        lib.guided_chunk_launch.argtypes = [
            i, p, p, p, i, ctypes.POINTER(ctypes.c_int), f, p, i, p, u32, u32,
            u32, i, f, p, p, p, p, p, ctypes.c_longlong, p]
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: a csrc directory whose fused_hmm.cu is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("guided_chain_parts times the card: no CUDA device")
    from ..inference.nn import mlp_init
    from ..interop import spec_from_numpy
    from ..ops import fused_hmm
    from ..ops.philox import device_key, split_seed
    from ..ops.population import current_stream
    from .chain_parts import _chain, _local_memory, variant_source
    from .profiling import gpu_name_and_power
    from .roofline import time_ms

    kept = (Path(fused_hmm.__file__).resolve().parent / "csrc" / "fused_hmm.cu").read_text()
    sources = {name: variant_source(in_cta_subs(kept) if subs is None else subs)
               for name, subs in VARIANTS.items()}
    for other in args.other:
        name, _, path = other.partition("=")
        sources[name] = variant_source([], Path(path))
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda kv: _library(f"guided_{kv[0]}", kv[1]), sources.items())))

    dev = torch.device("cuda")
    stream = current_stream(dev)
    seed = 20261017
    k0, k1 = split_seed(seed)
    key = device_key(seed, dev)
    K = 5
    gen = torch.Generator()
    gen.manual_seed(5)
    gt = fused_hmm.GuidedTables.from_params(
        np.log(_chain(K)[0]), mlp_init([K + 2, 16, 16, K], gen), 16)
    g = gt.tables(dev)
    spec = spec_from_numpy(*_chain(K))
    tab = spec.tables(dev)["packed"]
    dims = (ctypes.c_int * len(gt.dims))(*gt.dims)
    net = (K, tab.data_ptr(), g["log_trans"].data_ptr(), g["net"].data_ptr(),
           len(gt.dims) - 1, dims, float(gt.T))
    calls = {}
    for name, n, steps, nv, flag, t0, every in _CASES:
        rng = np.random.default_rng(K)
        ys = torch.as_tensor(rng.standard_normal(steps).astype(np.float32) * 2,
                             device=dev)
        s0, w0, _ = fused_hmm.hmm_init(seed, ys[0], n, spec)
        ctrl = torch.tensor([flag, *[n * (k + 1) // K for k in range(K - 1)], nv],
                            dtype=torch.int32, device=dev)
        tabs = torch.empty((steps, 2 * K * K + K), device=dev)
        outs = (torch.empty_like(s0), torch.empty_like(w0),
                torch.empty(n // fused_hmm.ISLAND_SIZE, K + 4, device=dev))
        pop = [t.data_ptr() for t in (s0, w0, *outs)]

        def call(v, name=name, n=n, ys=ys, ctrl=ctrl, t0=t0, every=every,
                 tabs=tabs, pop=pop, keep=(s0, w0), tables_only=False):
            lib = libs[v]
            steps = (ys.data_ptr(), ys.shape[0])
            if v == "in_cta" or not hasattr(lib, "guided_tables_launch"):
                err = lib.guided_chunk_launch(*net, *steps, ctrl.data_ptr(), k0, k1,
                                              t0, every, 0.5, *pop, n, stream)
            else:
                err = lib.guided_tables_launch(*net, *steps, ctrl.data_ptr(), t0,
                                               tabs.data_ptr(), stream)
                if not err and not tables_only:
                    err = lib.guided_chunk_launch(
                        K, tabs.data_ptr(), ys.shape[0], ctrl.data_ptr(), k0, k1, t0,
                        every, 0.5, *pop, n, stream)
            if err:
                raise RuntimeError(f"{name} ({v}): launch failed, CUDA error {err}")

        def call_k8(v, n=n, ys=ys, ctrl=ctrl, t0=t0, every=every, pop=pop):
            err = libs[v].hmm_chunk_launch(K, tab.data_ptr(), ys.data_ptr(),
                                           ys.shape[0], ctrl.data_ptr(), key.data_ptr(),
                                           t0, every, 0.5, *pop, n, stream)
            if err:
                raise RuntimeError(f"K8: launch failed, CUDA error {err}")

        calls[name] = (call, call_k8, outs)

    # every variant computes the kept one's function, bit for bit
    for case, (call, _, outs) in calls.items():
        call("tables_kernel")
        want = [o.clone() for o in outs]
        for v in libs:
            call(v)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                raise AssertionError(f"{case}: variant {v} differs from the kept source")
    times = {v: {} for v in libs}
    times["K8"] = {}
    times["tables_alone"] = {}
    enqueue_us = {v: {} for v in libs}
    for order in (list(libs), list(libs)[::-1]):
        for v in order:
            for case, (call, call_k8, _) in calls.items():
                times[v].setdefault(case, []).append(time_ms(lambda: call(v), 10))
                torch.cuda.synchronize()
                t_host = time.perf_counter()
                for _ in range(50):
                    call(v)
                enqueue_us[v].setdefault(case, []).append(
                    (time.perf_counter() - t_host) / 50 * 1e6)
                torch.cuda.synchronize()
        for case, (call, call_k8, _) in calls.items():
            if not case.startswith("K13_step"):
                times["K8"].setdefault(case, []).append(
                    time_ms(lambda: call_k8("tables_kernel"), 10))
            times["tables_alone"].setdefault(case, []).append(
                time_ms(lambda: call("tables_kernel", tables_only=True), 10))
    local = {}
    for v, lib in libs.items():
        stem = Path(lib._name).stem[3:]
        local[v] = {f: r for kernel in ("guided_chunk_kernel", "guided_tables_kernel")
                    for f, r in _local_memory(stem, kernel).items() if "ILi5E" in f}
    out = {"card": gpu_name_and_power(), "ms": times, "enqueue_us": enqueue_us,
           "local_memory": local}
    line = json.dumps(out)
    print(line)
    path = Path(os.getcwd()) / "chiprun_out" / "guided_chain_parts.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()

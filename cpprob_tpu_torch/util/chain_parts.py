"""The chain kernels' designs timed beside each other on the card:
``csrc/fused_hmm.cu`` built with other values of its design constants,
and, optionally, other versions of the source.

    python -m cpprob_tpu_torch.util.chain_parts [--other NAME=DIR ...]

Variants, each the source with one constant substituted: ``kept`` (the
source as it is: tiles of at most ``kTile`` = 32 steps, ``kPerThread`` = 16
particles a thread, ``kUnroll`` = 2 of them interleaved in the run-time-K
kernel, 1,024 threads an SM asked of the chunk kernels that fit 64
registers and 768 of the others), ``tile4``, ``tile8`` and ``tile16`` (at
most one, two or four groups of four steps a tile: more barriers, the same
draws), ``unroll1`` and ``unroll4`` (one or four particles a thread in
flight in the run-time-K kernel), ``pt8`` (8 particles a thread: CTAs of
512 threads, the same island of 4,096 particles), ``mb1``, ``mb3`` and
``mb4`` (1, 3 or 4 CTAs an SM asked of every chunk kernel: at most 255, 80
or 64 registers), and for each ``--other NAME=DIR`` the ``fused_hmm.cu``
of that ``csrc`` directory (say the parent commit's, unpacked with ``git
archive``: its times only, its draws may differ; its launches must take
the key as this source's do, from two device words).  Each variant is built
(one nvcc each, all started together) and launched through its own
library on the same inputs at the paths' shapes: K2 (the HMM, 2^26
particles, 16 slots with 15 valid, an island check after step 8), K3 (the
same without the check), K8 (K = 5, 2^24, 8 steps), the run-time-K kernel
at K = 12 and 32 (2^20, 4 steps), K4 and K5 (one step at 2^20, the flag
on and off: host-bound, a launch enqueued takes about as long as it runs)
and K13 (K = 5 with a random ``[7,16,16,5]`` net, 2^24 x 8 steps, and one
step at 2^20).  Every variant of the kept source must give the kept one's
states, weights and records bit for bit (with another CTA width, to
float32 rounding).  Prints one JSON line (also written to
``chiprun_out/chain_parts.json``): the card, each variant's times in ms
(CUDA events, 10 launches after a warm-up; the variants in turns, forward
and then backward) and each chain kernel's registers and local memory
(stack frame, spill bytes, ``LDL``/``STL``) per variant.  It needs the
card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

__all__ = ["VARIANTS", "main", "variant_source"]

_TILE = "constexpr int kTile = 32;"
_PER_THREAD = "constexpr int kPerThread = 16;"
_UNROLL = "constexpr int kUnroll = 2;"
_MIN_BLOCKS = "  return (fits_64 ? 1024 : 768) / kThreads;"

# each variant: the substitutions it makes in the source
VARIANTS = {
    "kept": [],
    "tile4": [(_TILE, "constexpr int kTile = 4;")],
    "tile8": [(_TILE, "constexpr int kTile = 8;")],
    "tile16": [(_TILE, "constexpr int kTile = 16;")],
    "unroll1": [(_UNROLL, "constexpr int kUnroll = 1;")],
    "unroll4": [(_UNROLL, "constexpr int kUnroll = 4;")],
    "pt8": [(_PER_THREAD, "constexpr int kPerThread = 8;")],
    "mb1": [(_MIN_BLOCKS, "  return 1;")],
    "mb3": [(_MIN_BLOCKS, "  return 3;")],
    "mb4": [(_MIN_BLOCKS, "  return 4;")],
}
_CSRC = Path(__file__).resolve().parents[1] / "ops" / "csrc"


def variant_source(subs, csrc: Path = _CSRC) -> str:
    """``csrc/fused_hmm.cu`` with the substitutions ``subs`` made (raises if
    one no longer finds its line) and its headers included from ``csrc``
    by absolute path."""
    text = (csrc / "fused_hmm.cu").read_text()
    for old, new in subs:
        if old not in text:
            raise ValueError(f"the line {old.strip()!r} is gone from fused_hmm.cu")
        text = text.replace(old, new)
    return text.replace('#include "', f'#include "{csrc.resolve()}/')


def _library(name: str, source: str):
    from ..ops import _build, fused_hmm

    lib = _build.load_generated_library(name, source)
    p, i, u32, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
    lib.hmm_chunk_launch.argtypes = [i, p, p, i, p, p, u32, i, f, p, p, p, p,
                                     p, ctypes.c_longlong, p]
    lib.guided_chunk_launch.argtypes = [
        i, p, p, p, i, ctypes.POINTER(ctypes.c_int), f, p, i, p, u32, u32, u32,
        i, f, p, p, p, p, p, ctypes.c_longlong, p]
    if lib.hmm_island_size() != fused_hmm.ISLAND_SIZE:
        raise RuntimeError(f"{name}: another island size")
    return lib


def _chain(K):
    """The HMM at K = 3, else the K-state recipe of tests/test_tpu_hw.py:
    52-59 (Dirichlet rows from default_rng(K), evenly spaced means and
    stds, a uniform start)."""
    from ..models import HMM_MEANS, HMM_TRANS

    if K == 3:
        return np.asarray(HMM_TRANS), np.asarray(HMM_MEANS), np.ones(3), np.full(3, 1 / 3)
    rng = np.random.default_rng(K)
    return (rng.dirichlet(np.ones(K), size=K), np.linspace(-3.0, 3.0, K),
            np.linspace(0.5, 1.6, K), np.full(K, 1.0 / K))


# each timed launch: (name, K, n, steps, n_valid, flag, t0, island_every,
# guided)
_CASES = [
    ("K2", 3, 1 << 26, 16, 15, 0, 1, 8, False),
    ("K3", 3, 1 << 26, 16, 15, 0, 1, 0, False),
    ("K8", 5, 1 << 24, 8, 8, 0, 1, 0, False),
    ("K12_k", 12, 1 << 20, 4, 4, 0, 1, 0, False),
    ("K32_k", 32, 1 << 20, 4, 4, 0, 1, 0, False),
    ("K4", 3, 1 << 20, 1, 1, 1, 5, 0, False),
    ("K5", 3, 1 << 20, 1, 1, 0, 5, 0, False),
    ("K13", 5, 1 << 24, 8, 8, 0, 1, 0, True),
    ("K13_step", 5, 1 << 20, 1, 1, 1, 5, 0, True),
]


def _local_memory(lib_name: str, kernel: str) -> dict:
    from .sass import kernel_report

    out = {}
    for f, r in kernel_report(lib_name, kernel).items():
        ops = r["opcodes"]
        out[f] = {"registers": r["registers"], "stack": r["stack"],
                  "spills": r["spills"],
                  "ldl_stl": ops.get("LDL", 0) + ops.get("STL", 0)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="NAME=DIR: a csrc directory whose fused_hmm.cu is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("chain_parts times the card: no CUDA device")
    from ..inference.nn import mlp_init
    from ..interop import spec_from_numpy
    from ..ops import fused_hmm
    from ..ops.philox import device_key, split_seed
    from ..ops.population import current_stream
    from .profiling import gpu_name_and_power
    from .roofline import time_ms

    sources = {name: variant_source(subs) for name, subs in VARIANTS.items()}
    for other in args.other:
        name, _, path = other.partition("=")
        sources[name] = variant_source([], Path(path))
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(
            lambda kv: _library(f"chain_{kv[0]}", kv[1]), sources.items())))

    dev = torch.device("cuda")
    stream = current_stream(dev)
    seed = 20261017
    k0, k1 = split_seed(seed)
    key = device_key(seed, dev)
    gen = torch.Generator()
    gen.manual_seed(5)
    gt = fused_hmm.GuidedTables.from_params(
        np.log(_chain(5)[0]), mlp_init([7, 16, 16, 5], gen), 16)
    calls = {}
    for name, K, n, steps, nv, flag, t0, every, guided in _CASES:
        spec = spec_from_numpy(*_chain(K))
        rng = np.random.default_rng(K)
        ys = torch.as_tensor(rng.standard_normal(steps).astype(np.float32) * 2,
                             device=dev)
        s0, w0, _ = fused_hmm.hmm_init(seed, ys[0], n, spec)
        ctrl = torch.tensor([flag, *[n * (k + 1) // K for k in range(K - 1)], nv],
                            dtype=torch.int32, device=dev)
        tab = spec.tables(dev)["packed"]
        g = gt.tables(dev)
        dims = (ctypes.c_int * len(gt.dims))(*gt.dims)
        outs = (torch.empty_like(s0), torch.empty_like(w0),
                torch.empty(n // fused_hmm.ISLAND_SIZE, K + 4, device=dev))
        ptrs = [t.data_ptr() for t in (s0, w0, *outs)]

        def call(lib, name=name, K=K, n=n, ys=ys, ctrl=ctrl, t0=t0, every=every,
                 guided=guided, tab=tab, g=g, dims=dims, ptrs=ptrs,
                 keep=(s0, w0)):
            if guided:
                err = lib.guided_chunk_launch(
                    K, tab.data_ptr(), g["log_trans"].data_ptr(), g["net"].data_ptr(),
                    len(gt.dims) - 1, dims, float(gt.T), ys.data_ptr(), ys.shape[0],
                    ctrl.data_ptr(), k0, k1, t0, every, 0.5, *ptrs, n, stream)
            else:
                err = lib.hmm_chunk_launch(
                    K, tab.data_ptr(), ys.data_ptr(), ys.shape[0], ctrl.data_ptr(),
                    key.data_ptr(), t0, every, 0.5, *ptrs, n, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed, CUDA error {err}")

        calls[name] = (call, outs, K)

    # every variant of the kept source computes the kept one's function: the
    # tile lengths bit for bit; other CTA widths sum the records and the
    # island checks' sums in another order, so a fired island may place up
    # to K-1 slots differently, its weights (the island's log-mean weight)
    # and the records agree to float32 rounding
    for case, (call, outs, K) in calls.items():
        call(libs["kept"])
        want = [o.clone() for o in outs]
        for v in VARIANTS:
            call(libs[v])
            torch.cuda.synchronize()
            if v != "pt8":
                ok = all(torch.equal(a, b) for a, b in zip(outs, want))
            else:
                bad = (outs[0] != want[0]) | ~torch.isclose(outs[1], want[1],
                                                            rtol=1e-5, atol=0)
                per = bad.view(-1, fused_hmm.ISLAND_SIZE).sum(1)
                ok = (bool((per <= (K - 1) * want[2][:, -1]).all())
                      and torch.allclose(outs[2], want[2], rtol=1e-4, atol=1e-6))
            if not ok:
                raise AssertionError(f"{case}: variant {v} differs from the kept source")
    times = {v: {} for v in libs}
    for order in (list(libs), list(libs)[::-1]):
        for v in order:
            for case, (call, _, _) in calls.items():
                times[v].setdefault(case, []).append(
                    time_ms(lambda: call(libs[v]), 10))
    local = {}
    for v, lib in libs.items():
        stem = Path(lib._name).stem[3:]
        local[v] = {**_local_memory(stem, "hmm_chunk_kernel"),
                    **_local_memory(stem, "guided_chunk_kernel")}
    out = {"card": gpu_name_and_power(), "ms": times, "local_memory": local}
    line = json.dumps(out)
    print(line)
    path = Path(os.getcwd()) / "chiprun_out" / "chain_parts.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()

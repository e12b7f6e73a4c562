"""Where pass 1's time goes: variants of ``csrc/stream_resample.cu``, each
with one part of ``pass1_scan_kernel`` taken out, timed on the card.

    python -m cpprob_tpu_torch.util.pass1_parts [--n 16777216]

Each variant is the kernel source with one substitution, built with the
flags of ``ops/_build.py`` into a temporary directory and launched through
its own ``pass1_launch`` on the same weights: ``full`` (the kernel as it
is), ``no_look_back`` (every tile's exclusive prefix taken as 0), ``no_loads``
(the weights made up in registers), ``no_stores`` (the slots never
written), ``f32_exp`` (``__expf`` in float32 in place of the float64 exp),
``no_loads_no_stores``, and the tile sizes ``per_thread_8`` and
``per_thread_32`` (particles a thread; the kernel takes 16).  All but
``full`` and the tile sizes compute wrong slots; only their times mean
something.  Prints one JSON line: the card, the times in
ms (CUDA events, 20 launches after a warm-up) and, for comparison, float64
``torch.cumsum`` on the same weights.  It needs the card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["VARIANTS", "main", "variant_sources"]

_LOOK_BACK = "        excl = look_back(held, status, agg, incl, found, buf, &res);"
_LOAD = "      const float4 v = __ldg(p + i * kP1Threads + tid);"
_STORE = ("          out[i * kP1Threads + tid] = make_int4(stage_i[pad(l)], "
          "stage_i[pad(l + 1)],")
_EXP = "      e[4 * q + i] = exp((double)stage[pad(tid * kPer + 4 * q + i)] - m);"
_PER = "constexpr int kPer = 16;"

# each variant: the substitutions it makes in the source
VARIANTS = {
    "full": [],
    "no_look_back": [(_LOOK_BACK, "        excl = 0.0;")],
    "no_loads": [(_LOAD, "      const float4 v = make_float4((float)(tid & 7), (float)i, "
                         "(float)(tile & 3), 0.5f);")],
    "no_stores": [(_STORE, "          if (u0 > 2.0) out[i * kP1Threads + tid] = "
                           "make_int4(stage_i[pad(l)], stage_i[pad(l + 1)],")],
    "f32_exp": [(_EXP, "      e[4 * q + i] = (double)__expf((float)((double)"
                       "stage[pad(tid * kPer + 4 * q + i)] - m));")],
}
VARIANTS["no_loads_no_stores"] = VARIANTS["no_loads"] + VARIANTS["no_stores"]
VARIANTS["per_thread_8"] = [(_PER, "constexpr int kPer = 8;")]
VARIANTS["per_thread_32"] = [(_PER, "constexpr int kPer = 32;")]


def variant_sources(src: str) -> dict:
    """The variants' sources from the kernel's (raises if a substitution
    no longer finds its line)."""
    out = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise ValueError(f"variant {name}: the line {old.strip()!r} is gone")
            text = text.replace(old, new)
        out[name] = text
    return out


def _build(tmp: Path, name: str, src: str):
    from ..ops._build import NVCC_FLAGS, _nvcc

    cu, so = tmp / f"{name}.cu", tmp / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on variant {name}:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pass1_launch.argtypes = [p, ctypes.c_longlong, p, p, p, p, p, p, p, p]
    lib.pass1_launch.restype = i
    lib.pass1_per_thread.restype = i
    return lib


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1 << 24)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("pass1_parts times the card: no CUDA device")
    from ..ops import stream_resample as sr
    from .profiling import gpu_name_and_power
    from .roofline import time_ms

    csrc = Path(sr.__file__).resolve().parent / "csrc"
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        for h in csrc.glob("*.cuh"):
            shutil.copy(h, tmp)
        srcs = variant_sources((csrc / "stream_resample.cu").read_text())
        with ThreadPoolExecutor(len(srcs)) as pool:
            libs = dict(zip(srcs, pool.map(lambda kv: _build(tmp, *kv), srcs.items())))
        dev = torch.device("cuda")
        n = args.n
        gen = torch.Generator(device=dev)
        gen.manual_seed(1)
        lw = 2 * torch.randn(n, generator=gen, device=dev)
        stats = sr.logsumexp_stats(lw)
        u0 = torch.full((), 0.37, dtype=torch.float64, device=dev)
        st = torch.empty(n, dtype=torch.int32, device=dev)
        times = {}
        for name, lib in libs.items():
            n_tiles = -(-n // (sr._P1_THREADS * lib.pass1_per_thread()))
            ctr = torch.zeros(2, dtype=torch.int32, device=dev)
            status = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
            vals = torch.empty(2 * n_tiles, dtype=torch.float64, device=dev)
            stream = torch.cuda.current_stream(dev).cuda_stream

            def launch():
                err = lib.pass1_launch(lw.data_ptr(), n, stats.data_ptr(), u0.data_ptr(),
                                       None, ctr.data_ptr(), status.data_ptr(),
                                       vals.data_ptr(), st.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"variant {name}: launch error {err}")

            times[name] = time_ms(launch, 20)
        e64 = torch.exp(lw.double() - stats[0])
        times["torch.cumsum float64"] = time_ms(lambda: torch.cumsum(e64, 0), 20)
    out = {"card": gpu_name_and_power(), "n": n, "ms": times}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()

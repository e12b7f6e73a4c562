"""The user-physics chunk kernels (K10, K11) timed beside K7 on the card, at
16, 8 and 4 particles a thread, and beside an earlier version of
``ops/triton_ssm.py`` whose ``UserKernel`` ran them in Triton.

    python -m cpprob_tpu_torch.util.user_parts [--triton PATH/triton_ssm.py]

Cases: K10, the linear-Gaussian physics as a ``step_elem`` (2^24 particles
x 8 steps, the path-5 chunk), beside K7 (``fused_lg.lg_chunk``, the same
draws and physics written by hand); K11, the 2-D linear-Gaussian model
(D = 2, 2^20 x 4 steps, the path-6 chunk).  Each runs through
``ops/user_chunk.py`` with ``csrc/user_chunk.cuh``'s ``kUserPerThread``
at 4 (the header as it is: CTAs of 1,024 particles), 8 or 16 (the header
with that one line substituted, pasted into the generated source), and,
with ``--triton``, through that file's Triton ``UserKernel`` (loaded from
the file inside this package, so it runs on this checkout's plain
modules; say the parent commit's, unpacked with ``git archive``).  Every
variant must give the header's states and weights bit for bit, K7 and the
Triton kernel within 1e-5.  Prints one JSON line (also written to
``chiprun_out/user_parts.json``): the card; the times in ms (CUDA events,
10 launches after a warm-up; the list in turns, forward and then
backward); and the machine code of each kernel: registers, spills, stack
frame, instructions, ``LDL``/``STL``, transcendental-unit instructions
(``MUFU``) and the instructions of its largest loops (``util/sass.py``;
the step loop); each kernel's SASS goes to ``chiprun_out/user_parts_sass/``.
It needs the card.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["lg2d_step_elem", "lg_step_elem", "main", "variant_kernel"]

HALF_LOG_2PI = 0.9189385332046727


def lg_step_elem(x, y, eps):
    nx = x + eps
    d = y - nx
    return nx, -0.5 * d * d - HALF_LOG_2PI


def lg2d_step_elem(x0, x1, y, e0, e1):
    n0 = 0.9 * x0 + 0.1 * x1 + e0
    n1 = 0.8 * x1 + e1
    d = y - (n0 + n1)
    return n0, n1, -0.5 * d * d - HALF_LOG_2PI


def _load_triton(path: Path):
    """The module at ``path`` loaded as ``cpprob_tpu_torch.ops._triton_user``
    (its relative imports resolve to this checkout's modules)."""
    name = "cpprob_tpu_torch.ops._triton_user"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_PER = "constexpr int kUserPerThread = kD <= 2 ? 4 : 2;"


def variant_kernel(fn, D: int, per: int):
    """A :class:`~..ops.user_chunk.UserKernel` whose generated source holds
    ``csrc/user_chunk.cuh`` with ``per`` particles a thread in its place."""
    from ..ops import user_chunk

    k = user_chunk.UserKernel(fn, D)
    header = (Path(user_chunk.__file__).resolve().parent / "csrc" / "user_chunk.cuh").read_text()
    if _PER not in header:
        raise ValueError(f"the line {_PER!r} is gone from user_chunk.cuh")
    text = header.replace(_PER, f"constexpr int kUserPerThread = {per};")
    src = k.source().replace('#include "user_chunk.cuh"', text)
    k.source = lambda: src
    return k


def _summary(r: dict) -> dict:
    ops = r["opcodes"]
    out = {k: r.get(k) for k in ("registers", "spills", "stack", "instructions")}
    out.update(ldl_stl=ops.get("LDL", 0) + ops.get("STL", 0),
               mufu=ops.get("MUFU", 0), loops=r["loops"][:3])
    return out


def _triton_sass(mod, k, args, out: Path) -> dict:
    """Compile the Triton kernel of ``k`` for ``args`` and read its cubin
    (its SASS to ``out``)."""
    from .sass import cubin_report

    compiled = k.module().user_chunk_kernel[(1,)](
        *args, BLOCK=mod.BLOCK, num_warps=mod._NUM_WARPS, enable_fp_fusion=False)
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "k.cubin"
        cubin.write_bytes(compiled.asm["cubin"])
        (f, r), = cubin_report(cubin, "user_chunk_kernel", out).items()
    r = {**r, "registers": getattr(compiled, "n_regs", None),
         "spills": getattr(compiled, "n_spills", None), "stack": None}
    return _summary(r)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--triton", type=Path, default=None,
                    help="a triton_ssm.py whose UserKernel is timed beside")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("user_parts times the card: no CUDA device")
    from ..ops import fused_lg, user_chunk
    from .profiling import gpu_name_and_power
    from .roofline import time_ms
    from .sass import kernel_report

    dev = torch.device("cuda")
    seed = 20261017
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    cases = {
        "K10": (lg_step_elem, 1, torch.randn(1 << 24, generator=gen, device=dev),
                torch.randn(8, generator=gen, device=dev)),
        "K11": (lg2d_step_elem, 2, torch.randn(1 << 20, 2, generator=gen, device=dev),
                torch.randn(4, generator=gen, device=dev)),
    }
    kernels = {f"{case} cuda {per}": (user_chunk.UserKernel(fn, D) if per == 4
                                       else variant_kernel(fn, D, per))
               for case, (fn, D, _, _) in cases.items() for per in (4, 8, 16)}
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(lambda k: k._library(), kernels.values()))
    triton = _load_triton(args.triton) if args.triton else None
    runs = {}
    for case, (fn, D, x0, ys) in cases.items():
        w0 = torch.zeros(x0.shape[0], device=dev)
        nv = torch.full((1,), ys.shape[0], dtype=torch.int32, device=dev)
        for per in (4, 8, 16):
            k = kernels[f"{case} cuda {per}"]
            runs[f"{case} cuda {per}"] = (lambda k=k, x0=x0, w0=w0, ys=ys, nv=nv:
                                          k.chunk(seed, x0, w0, ys, nv, t0=1))
        if triton is not None:
            tk = triton.UserKernel(fn, D)
            runs[f"{case} triton"] = (lambda tk=tk, x0=x0, w0=w0, ys=ys, nv=nv:
                                      tk.chunk(seed, x0, w0, ys, nv, t0=1))
        if case == "K10":
            runs["K7"] = lambda x0=x0, w0=w0, ys=ys, nv=nv: fused_lg.lg_chunk(
                seed, x0, w0, ys, nv, t0=1)

    # every count of particles a thread, K7 and the Triton kernel against the
    # header's
    errs = {}
    for case in cases:
        want = runs[f"{case} cuda 4"]()
        for name, run in runs.items():
            if not (name.startswith(case) or (case == "K10" and name == "K7")):
                continue
            got = run()
            torch.cuda.synchronize()
            if " cuda " in name:
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{name} differs from {case} cuda 4")
            else:
                torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
                torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-5)
            errs[name] = float((got[1] - want[1]).abs().max())

    times = {}
    for order in (list(runs), list(runs)[::-1]):
        for name in order:
            times.setdefault(name, []).append(time_ms(runs[name], 10))

    sass = {}
    dump = Path(os.getcwd()) / "chiprun_out" / "user_parts_sass"
    dump.mkdir(parents=True, exist_ok=True)
    for name, k in kernels.items():
        (f, r), = kernel_report(k.library, "user_chunk_kernel",
                                dump / f"{name.replace(' ', '_')}.sass").items()
        sass[name] = _summary(r)
    (f, r), = kernel_report("fused_lg", fused_lg.K7_SYMBOL, dump / "K7.sass").items()
    sass["K7"] = _summary(r)
    if triton is not None:
        for case, (fn, D, x0, ys) in cases.items():
            tk = triton.UserKernel(fn, D)
            n = x0.shape[0]
            a = [x0, torch.zeros(n, device=dev), ys,
                 torch.full((1,), ys.shape[0], dtype=torch.int32, device=dev),
                 torch.empty_like(x0), torch.empty(n, device=dev),
                 torch.empty(3, device=dev), n, ys.shape[0], seed, 1]
            sass[f"{case} triton"] = _triton_sass(triton, tk, a,
                                                  dump / f"{case}_triton.sass")
    out = {"card": gpu_name_and_power(), "ms": times, "max_abs_dlog_w": errs,
           "sass": sass}
    line = json.dumps(out)
    print(line)
    path = Path(os.getcwd()) / "chiprun_out" / "user_parts.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(line + "\n")
    return out


if __name__ == "__main__":
    main()

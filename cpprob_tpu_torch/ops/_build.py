"""Build ``csrc/<name>.cu`` with ``nvcc`` into a shared library with a plain
C interface and load it with ``ctypes``.

The library goes to ``ops/_build/`` under a name that carries a hash of the
sources, so an edited kernel is rebuilt and a stale one never loaded.  A
build happens at the first launch, never at import: the CPU-only test
environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "BUILD_LOGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_LIBS: dict = {}
# compiler output of each build made by this process (ptxas register and
# spill report), by library name
BUILD_LOGS: dict = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def load_library(name: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu`` (and the
    ``csrc/*.cuh`` headers), building it first if needed."""
    if name in _LIBS:
        return _LIBS[name]
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256()
    for path in [src, *sorted(_CSRC.glob("*.cuh"))]:
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    lib_path = _BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}"
                )
            BUILD_LOGS[name] = proc.stdout + proc.stderr
            os.replace(tmp, lib_path)   # atomic: no half-written library
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib

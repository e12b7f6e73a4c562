"""Build ``csrc/<name>.cu`` with ``nvcc`` into a shared library with a plain
C interface and load it with ``ctypes``; and the same for a generated
source (:func:`load_generated_library`), which includes the ``csrc``
headers.

The library goes to ``ops/_build/`` under a name that carries a hash of the
sources and the flags, so an edited kernel is rebuilt and a stale one never
loaded.  A build happens at the first launch, never at import: the CPU-only
test environment has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load_library", "load_generated_library", "library_path", "BUILD_LOGS"]

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


def _digest(src_bytes: bytes, flags: list) -> str:
    digest = hashlib.sha256(src_bytes)
    for path in sorted(_CSRC.glob("*.cuh")):
        digest.update(path.read_bytes())
    digest.update(" ".join(flags).encode())
    return digest.hexdigest()[:16]


def _build(name: str, src: Path, lib_path: Path, flags: list):
    """Compile ``src`` into ``lib_path`` unless it is there already; the
    compiler's output goes to ``BUILD_LOGS[name]`` and beside the library
    (``<library>.log``), where a process that finds the library built reads
    it."""
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        if name not in BUILD_LOGS and log_path.exists():
            BUILD_LOGS[name] = log_path.read_text()
        return
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name}:\n{proc.stdout}{proc.stderr}")
        BUILD_LOGS[name] = proc.stdout + proc.stderr
        log_path.write_text(BUILD_LOGS[name])
        os.replace(tmp, lib_path)   # atomic: no half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library(name: str) -> ctypes.CDLL:
    """Return the loaded library built from ``csrc/<name>.cu`` (and the
    ``csrc/*.cuh`` headers), building it first if needed."""
    if name in _LIBS:
        return _LIBS[name]
    src = _CSRC / f"{name}.cu"
    lib_path = _BUILD_DIR / f"lib{name}-{_digest(src.read_bytes(), NVCC_FLAGS)}.so"
    _build(name, src, lib_path, NVCC_FLAGS)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib


def load_generated_library(name: str, source: str) -> ctypes.CDLL:
    """Return the library built from a generated CUDA ``source`` (which may
    include the ``csrc`` headers), written to ``ops/_build/<name>-<hash>.cu``
    and built there at the first call; ``BUILD_LOGS["<name>-<hash>"]`` keeps
    the compiler's output."""
    flags = [*NVCC_FLAGS, "-I", str(_CSRC)]
    stem = f"{name}-{_digest(source.encode(), flags)}"
    if stem in _LIBS:
        return _LIBS[stem]
    src = _BUILD_DIR / f"{stem}.cu"
    lib_path = _BUILD_DIR / f"lib{stem}.so"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = src.with_suffix(f".{os.getpid()}.tmp")
        tmp.write_text(source)
        os.replace(tmp, src)
    _build(stem, src, lib_path, flags)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[stem] = lib
    return lib


def library_path(name: str) -> Path:
    """The file of the loaded library built from ``csrc/<name>.cu``, or of
    the generated library ``name`` ("<name>-<hash>") this process built."""
    lib = _LIBS.get(name) or load_library(name)
    return Path(lib._name)

"""Offline trace shards for inference-compilation training — counterpart of
``cpprob_tpu/io/tracefile.py`` (the reference's offline pipeline: the C++
engine dumps UUID-named trace batches, ``socket.cpp:79-98``, the trainer
samples random files, ``RequesterFile``, ``client.py:60-91``).

- :func:`write_trace_shard` writes the JAX package's shard format byte for
  byte (``_MAGIC = 0x43505454``, version 1), so a shard written by either
  package reads in the other.
- :class:`TraceLoader` assembles random minibatches with the C++
  mmap + prefetch-thread loader of ``native/src/tracefile.cpp``.  The port
  builds ``native/src/*.cpp`` itself at first use, with the Makefile's
  flags, into ``cpprob_tpu_torch/ops/_build/`` (a name carrying a hash of
  the sources), and loads it by path with ctypes; it never writes into
  ``native/``.  A failed build raises in :class:`TraceLoader` unless
  ``force_python=True`` asks for the numpy loader: nothing switches to it
  silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import tempfile
import uuid
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..distributions.base import to_host

__all__ = ["write_trace_shard", "TraceLoader", "native_available", "dump_traces"]

_MAGIC = 0x43505454
_NATIVE_SRC = Path(__file__).resolve().parents[2] / "native" / "src"
_SOURCES = ("tracefile.cpp", "posterior_parse.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "_build"
# native/Makefile's CXXFLAGS and link line
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lib = None
_lib_error: Optional[str] = None
_lib_tried = False


def _native_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for name in _SOURCES:
        digest.update((_NATIVE_SRC / name).read_bytes())
    return _BUILD_DIR / f"libcpprob_native-{digest.hexdigest()[:16]}.so"


def _build_native() -> Path:
    """Compile the native sources with ``g++`` (or ``$CXX``) into
    ``ops/_build/`` unless the library is there already."""
    lib_path = _native_path()
    if lib_path.exists():
        return lib_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp,
             *[str(_NATIVE_SRC / n) for n in _SOURCES]],
            capture_output=True, text=True, timeout=300,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on native/src:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: no half-written library
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib_path


def _declare(lib):
    c = ctypes
    sigs = {
        "cpprob_loader_open": (c.c_void_p, [c.POINTER(c.c_char_p), c.c_int, c.c_uint32,
                                            c.c_int, c.c_uint64]),
        "cpprob_loader_row_len": (c.c_uint64, [c.c_void_p]),
        "cpprob_loader_obs_dim": (c.c_uint32, [c.c_void_p]),
        "cpprob_loader_total_traces": (c.c_uint64, [c.c_void_p]),
        "cpprob_loader_n_sites": (c.c_int, [c.c_void_p]),
        "cpprob_loader_site_name": (c.c_int, [c.c_void_p, c.c_int, c.c_char_p, c.c_int]),
        "cpprob_loader_site_size": (c.c_uint32, [c.c_void_p, c.c_int]),
        "cpprob_loader_next_batch": (c.c_int, [c.c_void_p, c.c_void_p]),
        "cpprob_loader_close": (None, [c.c_void_p]),
        "cpprob_posterior_parse": (c.c_void_p, [c.c_char_p]),
        "cpprob_posterior_n_particles": (c.c_int64, [c.c_void_p]),
        "cpprob_posterior_n_entries": (c.c_int64, [c.c_void_p]),
        "cpprob_posterior_log_weights": (c.POINTER(c.c_double), [c.c_void_p]),
        "cpprob_posterior_offsets": (c.POINTER(c.c_int64), [c.c_void_p]),
        "cpprob_posterior_ids": (c.POINTER(c.c_int32), [c.c_void_p]),
        "cpprob_posterior_values": (c.POINTER(c.c_double), [c.c_void_p]),
        "cpprob_posterior_free": (None, [c.c_void_p]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def _load_native():
    """The native library, built at the first call; None if the build or
    the load failed (the reason in ``_lib_error``)."""
    global _lib, _lib_error, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(str(_build_native()))
        _declare(lib)
        _lib = lib
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:  # reported by TraceLoader
        _lib, _lib_error = None, f"{type(e).__name__}: {e}"
    return _lib


def native_available() -> bool:
    return _load_native() is not None


def write_trace_shard(
    directory: str,
    site_values: Dict[str, np.ndarray],   # addr -> (n, ...) float
    obs: np.ndarray,                      # (n, obs_dim)
    name: Optional[str] = None,
) -> str:
    """Write one shard; returns its path (UUID-named like socket.cpp:84).
    Tensors are copied to the host."""
    os.makedirs(directory, exist_ok=True)
    name = name or uuid.uuid4().hex
    path = os.path.join(directory, f"{name}.cptt")
    obs = np.asarray(to_host(obs), np.float32)
    n = obs.shape[0]
    names = list(site_values.keys())
    cols = []
    sizes = []
    for addr in names:
        v = np.asarray(to_host(site_values[addr]), np.float32).reshape(n, -1)
        sizes.append(v.shape[1])
        cols.append(v)
    data = np.concatenate([obs] + cols, axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(struct.pack("<IIIIQ", _MAGIC, 1, len(names), obs.shape[1], n))
        for addr in names:
            b = addr.encode()
            f.write(struct.pack("<I", len(b)))
            f.write(b)
        f.write(struct.pack(f"<{len(sizes)}I", *sizes))
        f.write(data.tobytes())
    return path


def dump_traces(engine, directory: str, key, n_traces: int, shard_size: int = 4096):
    """Generate prior traces with a CSIS engine and dump shards — the offline
    half of ``compile(..., dump_folder=...)`` (``cpprob.hpp:133-139``).
    ``key``: an integer seed (a generator on the engine's device) or a
    ``torch.Generator``; the shards are drawn from it in turn.  Each shard
    is copied to the host: a sync a shard."""
    from ..inference.sis import _generator

    gen = _generator(key, engine.device)
    paths = []
    remaining = n_traces
    while remaining > 0:
        n = min(shard_size, remaining)
        values, obs = engine._gen(gen, n)
        masks = values.pop("__masks__", {})
        for addr, m in masks.items():
            values[f"__mask__{addr}"] = np.broadcast_to(to_host(m), (n,))
        paths.append(write_trace_shard(directory, values, obs))
        remaining -= n
    return paths


class TraceLoader:
    """Random-minibatch loader over shards: the native loader, or with
    ``force_python=True`` the numpy one.  :meth:`next_batch` returns the
    batch as tensors on ``device`` (default ``"cuda"``; with no card it
    raises rather than load to the CPU): the loader writes each batch into
    pinned host memory, copied without blocking (the JAX package's
    ``next_batch`` returns host arrays)."""

    def __init__(
        self,
        paths: Sequence[str],
        batch_size: int,
        n_threads: int = 2,
        seed: int = 0,
        force_python: bool = False,
        device="cuda",
    ):
        self.paths = list(paths)
        if not self.paths:
            raise ValueError("no shard paths given")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("TraceLoader(device='cuda') needs a CUDA card; pass "
                               "device='cpu' to load batches to the CPU")
        self.batch_size = batch_size
        self._handle = None
        if force_python:
            self._py_load()
            self.native = False
        else:
            lib = _load_native()
            if lib is None:
                raise RuntimeError(f"the native trace loader did not build ({_lib_error}); "
                                   "pass force_python=True for the numpy loader")
            arr = (ctypes.c_char_p * len(self.paths))(*[p.encode() for p in self.paths])
            handle = lib.cpprob_loader_open(arr, len(self.paths), batch_size, n_threads, seed)
            if not handle:
                raise ValueError(f"the native loader refused the shards {self.paths[:3]}...")
            self._handle = ctypes.c_void_p(handle)
            self._lib = lib
            self.row_len = int(lib.cpprob_loader_row_len(self._handle))
            self.obs_dim = int(lib.cpprob_loader_obs_dim(self._handle))
            self.total_traces = int(lib.cpprob_loader_total_traces(self._handle))
            self.site_names = []
            self.site_sizes = []
            buf = ctypes.create_string_buffer(4096)
            for i in range(lib.cpprob_loader_n_sites(self._handle)):
                lib.cpprob_loader_site_name(self._handle, i, buf, 4096)
                self.site_names.append(buf.value.decode())
                self.site_sizes.append(int(lib.cpprob_loader_site_size(self._handle, i)))
            self.native = True
        self._rng = np.random.RandomState(seed)

    # -- numpy loader ----------------------------------------------------
    def _py_load(self):
        self._py_shards = []
        for i, p in enumerate(self.paths):
            with open(p, "rb") as f:
                magic, version, n_sites, obs_dim, n = struct.unpack("<IIIIQ", f.read(24))
                if magic != _MAGIC or version != 1:
                    raise ValueError(f"bad shard {p}")
                names = []
                for _ in range(n_sites):
                    (ln,) = struct.unpack("<I", f.read(4))
                    names.append(f.read(ln).decode())
                sizes = list(struct.unpack(f"<{n_sites}I", f.read(4 * n_sites)))
                row_len = obs_dim + sum(sizes)
                data = np.frombuffer(f.read(row_len * n * 4), np.float32).reshape(n, row_len)
            if i == 0:
                self.site_names, self.site_sizes = names, sizes
                self.obs_dim, self.row_len = obs_dim, row_len
            elif names != self.site_names or sizes != self.site_sizes:
                raise ValueError(f"incompatible shard {p}")
            self._py_shards.append(data)
        self.total_traces = sum(s.shape[0] for s in self._py_shards)

    def _fill(self, out: np.ndarray) -> np.ndarray:
        if self._handle is not None:
            rc = self._lib.cpprob_loader_next_batch(self._handle, out.ctypes.data)
            if rc != 0:
                raise RuntimeError("native loader stopped")
            return out
        shard_idx = self._rng.randint(len(self._py_shards), size=self.batch_size)
        for i, si in enumerate(shard_idx):
            s = self._py_shards[si]
            out[i] = s[self._rng.randint(s.shape[0])]
        return out

    def next_batch_raw(self) -> np.ndarray:
        """(batch, row_len) matrix: [obs | site values...]."""
        return self._fill(np.empty((self.batch_size, self.row_len), np.float32))

    def _split(self, raw):
        obs = raw[:, : self.obs_dim]
        values = {}
        off = self.obs_dim
        for addr, size in zip(self.site_names, self.site_sizes):
            v = raw[:, off : off + size]
            values[addr] = v[:, 0] if size == 1 else v
            off += size
        return values, obs

    def next_batch(self) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """(site_values dict, obs matrix) on ``device`` — the shape
        ``csis_loss`` consumes."""
        pin = self.device.type == "cuda"
        buf = torch.empty((self.batch_size, self.row_len), dtype=torch.float32,
                          pin_memory=pin)
        self._fill(buf.numpy())
        return self._split(buf.to(self.device, non_blocking=pin))

    def close(self):
        if self._handle is not None:
            self._lib.cpprob_loader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass

"""Checkpoint/resume for trained parameters — counterpart of
``cpprob_tpu/util/checkpoint.py`` (the reference's NN checkpointing,
``infcomp/nn/nn.py:57-64``, periodic saves ``util.py:29-37``, ``--resume``
picks the latest file ``main.py:38,56-57``).

:func:`save_pytree` writes the JAX package's layout: an ``.npz`` of
``leaf_<i>`` in JAX's flatten order (dict keys sorted,
:mod:`cpprob_tpu_torch.util.pytree`) and a ``__treedef__`` string.  A
checkpoint written by either package loads in the other.
"""

from __future__ import annotations

import glob
import json
import os
import time
from typing import Any, Optional

import numpy as np
import torch

from .ndarray import to_host
from .pytree import tree_flatten, tree_unflatten, treedef_str

__all__ = [
    "save_pytree",
    "load_pytree",
    "latest_checkpoint",
    "periodic_saver",
    "save_pytree_orbax",
    "load_pytree_orbax",
]


def _like_device(leaf):
    return leaf.device if isinstance(leaf, torch.Tensor) else torch.device("cpu")


def save_pytree(path: str, tree: Any) -> str:
    """Save a tree of tensors (or arrays); returns the written path
    (``<path>.npz``).  Copies every leaf to the host: a sync."""
    leaves, treedef = tree_flatten(tree)
    arrays = {f"leaf_{i}": to_host(l) for i, l in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(treedef_str(treedef).encode(), dtype=np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **arrays)
    return path if path.endswith(".npz") else path + ".npz"


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like`` (shape-checked); each leaf
    becomes a tensor, with the file's dtype, on the device of ``like``'s
    leaf."""
    leaves, treedef = tree_flatten(like)
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        loaded = [data[f"leaf_{i}"] for i in range(len(leaves))]
    for i, (a, b) in enumerate(zip(loaded, leaves)):
        if tuple(np.shape(a)) != tuple(np.shape(b)):
            raise ValueError(
                f"leaf {i}: checkpoint shape {np.shape(a)} != expected {tuple(np.shape(b))}"
            )
    return tree_unflatten(treedef, [torch.from_numpy(np.array(a)).to(_like_device(b))
                                    for a, b in zip(loaded, leaves)])


def latest_checkpoint(directory: str, prefix: str = "ckpt") -> Optional[str]:
    """Most recent ``<prefix>-*.npz`` in ``directory`` (the --resume rule)."""
    paths = glob.glob(os.path.join(directory, f"{prefix}-*.npz"))
    return max(paths, key=os.path.getmtime) if paths else None


def _encode(treedef):
    if treedef is None or treedef == "*":
        return treedef
    if treedef[0] == "dict":
        return {"dict": [[k, _encode(c)] for k, c in zip(treedef[1], treedef[2])]}
    return {treedef[0]: [_encode(c) for c in treedef[1]]}


def _decode(obj):
    if obj is None or obj == "*":
        return obj
    if "dict" in obj:
        return ("dict", tuple(k for k, _ in obj["dict"]),
                tuple(_decode(c) for _, c in obj["dict"]))
    (kind, children), = obj.items()
    return (kind, tuple(_decode(c) for c in children))


def save_pytree_orbax(path: str, tree: Any) -> str:
    """The name of the reference's orbax-backed save, kept for its callers.
    It writes a directory of ``torch.save`` leaves (``leaf_<i>.pt``, JAX's
    flatten order) and ``treedef.json``: not orbax's format, which only the
    JAX package reads.  Returns the absolute path."""
    path = os.path.abspath(path)
    leaves, treedef = tree_flatten(tree)
    os.makedirs(path, exist_ok=True)
    for i, leaf in enumerate(leaves):
        torch.save(torch.from_numpy(np.array(to_host(leaf))), os.path.join(path, f"leaf_{i}.pt"))
    with open(os.path.join(path, "treedef.json"), "w") as f:
        json.dump(_encode(treedef), f)
    return path


def load_pytree_orbax(path: str, like: Any = None) -> Any:
    """Restore a directory written by :func:`save_pytree_orbax`; ``like``
    (optional) gives the structure and each leaf's device (else the saved
    structure, on the CPU)."""
    path = os.path.abspath(path)
    if like is not None:
        leaves, treedef = tree_flatten(like)
        devices = [_like_device(l) for l in leaves]
    else:
        with open(os.path.join(path, "treedef.json")) as f:
            treedef = _decode(json.load(f))
        devices = [torch.device("cpu")] * len(glob.glob(os.path.join(path, "leaf_*.pt")))
    return tree_unflatten(treedef, [
        torch.load(os.path.join(path, f"leaf_{i}.pt"), weights_only=True).to(d)
        for i, d in enumerate(devices)])


class periodic_saver:
    """Save every ``every_n_traces`` processed traces
    (``--save_after_n_traces``, ``util.py:29-37``)."""

    def __init__(self, directory: str, every_n_traces: int, prefix: str = "ckpt"):
        self.directory = directory
        self.every = every_n_traces
        self.prefix = prefix
        self._since = 0
        self._count = 0

    def maybe_save(self, tree: Any, n_new_traces: int) -> Optional[str]:
        self._since += n_new_traces
        if self._since >= self.every:
            self._since = 0
            self._count += 1
            # timestamp + sequence number: several saves within one second
            # must not overwrite each other
            name = os.path.join(
                self.directory,
                f"{self.prefix}-{int(time.time())}-{self._count:05d}",
            )
            return save_pytree(name, tree)
        return None

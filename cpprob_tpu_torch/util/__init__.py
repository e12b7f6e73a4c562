"""Utilities: checkpoints, the train logger, nested-array flattening (the
reference's names), and the port's profiling and parameter-tree helpers."""

from .checkpoint import (
    latest_checkpoint,
    load_pytree,
    load_pytree_orbax,
    periodic_saver,
    save_pytree,
    save_pytree_orbax,
)
from .logging import TrainLogger, hardware_banner
from .ndarray import flatten_nested, to_ndarray

__all__ = [
    "save_pytree",
    "load_pytree",
    "save_pytree_orbax",
    "load_pytree_orbax",
    "latest_checkpoint",
    "periodic_saver",
    "TrainLogger",
    "hardware_banner",
    "to_ndarray",
    "flatten_nested",
]

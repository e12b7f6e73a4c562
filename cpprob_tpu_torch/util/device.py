"""The ``--device`` flag of the command-line entry points (the CLI and the
example drivers): the port's counterpart of ``JAX_PLATFORMS``."""

from __future__ import annotations

import argparse

import torch


def add_device_flag(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default; raises without a "
                         "card) or cpu")


def resolve_device(name: str) -> torch.device:
    """``name`` as a device; a CUDA device with no card raises, as every
    entry point of the port does."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} needs a CUDA card; pass --device cpu "
                           "to run on the CPU")
    return dev

"""Process-group set-up — counterpart of
``cpprob_tpu/parallel/distributed.py``.

The reference calls ``jax.distributed.initialize`` once per host and then
sees every device of the slice.  PyTorch runs one process per device:
call :func:`initialize_multihost` once in each, then build the mesh with
:func:`~cpprob_tpu_torch.parallel.particle_mesh`.  The backend follows the
device: NCCL for CUDA ranks, gloo for CPU ranks.  NCCL refuses two ranks on
one card, so processes that share a card take ``backend="gloo"`` with
``device="cuda:0"``: their particles stay on the card and the transport
goes through the host (:mod:`._collectives`).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

__all__ = ["initialize_multihost", "virtual_devices", "is_multihost"]


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device="cuda",
    backend: Optional[str] = None,
    timeout: float = 60.0,
) -> None:
    """``torch.distributed.init_process_group`` for this process.

    The arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``env://``), ``WORLD_SIZE`` and ``RANK``.
    ``coordinator_address`` is ``"host:port"`` (a TCP store on that port;
    rank 0 serves it) or an init URL (``tcp://...``, ``file://...``).
    ``device``: ``"cuda"`` (the card ``LOCAL_RANK`` names, 0 without it;
    with no card it raises), ``"cuda:i"``, or ``"cpu"``.  ``backend``
    defaults to NCCL for a CUDA device and gloo for the CPU.  ``timeout``
    (seconds) bounds every collective: a rank whose peers never join it
    raises instead of waiting for ever."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize_multihost(device='cuda') needs a CUDA card; "
                           "pass device='cpu' for CPU ranks")
    world = int(os.environ["WORLD_SIZE"]) if num_processes is None else int(num_processes)
    rank = int(os.environ["RANK"]) if process_id is None else int(process_id)
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kwargs = {}
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else int(os.environ.get("LOCAL_RANK", 0))
        dev = torch.device("cuda", index)
        torch.cuda.set_device(dev)
        if backend == "nccl":
            kwargs["device_id"] = dev       # binds the communicator to the card
    dist.init_process_group(
        backend=backend, init_method=init_method, world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout), **kwargs)


def is_multihost() -> bool:
    """Whether an initialized process group has more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def virtual_devices(n: int = 8) -> str:
    """The command prefix that runs a script as ``n`` CPU ranks on one host
    (each calls :func:`initialize_multihost` with ``device="cpu"``): the
    counterpart of the reference's ``--xla_force_host_platform_device_count``
    flag."""
    return f"torchrun --standalone --nproc-per-node={n}"

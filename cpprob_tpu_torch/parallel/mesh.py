"""The particle mesh — counterpart of ``cpprob_tpu/parallel/mesh.py``.

The reference's mesh is a 1-D ``jax.sharding.Mesh`` over devices of one
program; here it is a 1-D ``torch.distributed`` ``DeviceMesh`` over
ranks of the default process group (all of them, or a sub-mesh), one
process per device.  Each rank holds its ``N / k`` particles as
ordinary tensors on its own device (``cuda:{LOCAL_RANK}``, or the CPU
when asked), and the engines call the collectives of :mod:`._collectives`
on the mesh's group where the reference's ``shard_map`` bodies call
``psum``/``all_gather``/``ppermute``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

PARTICLE_AXIS = "particles"

__all__ = [
    "PARTICLE_AXIS",
    "particle_mesh",
    "particle_sharding",
    "replicated_sharding",
]


def particle_mesh(n_devices: Optional[int] = None,
                  devices: Optional[Sequence[int]] = None, *, device="cuda"):
    """The 1-D mesh over the particle axis, a ``DeviceMesh`` with
    ``mesh_dim_names=(PARTICLE_AXIS,)`` over ranks of the default process
    group (:func:`~cpprob_tpu_torch.parallel.initialize_multihost` first).

    ``devices`` are the group's ranks in mesh order (default: all of them)
    and ``n_devices`` keeps the first that many: the counterpart of the
    reference's sub-meshes of one program's devices.  A mesh over fewer
    ranks than the group runs its collectives on a group of its own, which
    PyTorch builds with ``dist.new_group``: so every rank of the default
    group calls ``particle_mesh`` with the same arguments, and a rank
    outside the mesh takes no part in its collectives (it must not run an
    engine on it: :func:`in_mesh`).  ``device``: where each rank's
    particles live, ``"cuda"`` (the rank's current card; with no card it
    raises) or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("particle_mesh(device='cuda') needs a CUDA card; pass "
                           "device='cpu' for CPU ranks")
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "particle_mesh needs an initialized process group: call "
            "cpprob_tpu_torch.parallel.initialize_multihost in every process "
            "first (one process a device)")
    world = dist.get_world_size()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    if n_devices is not None:
        ranks = ranks[:n_devices]
    if not ranks or len(set(ranks)) != len(ranks) or not all(0 <= r < world for r in ranks):
        raise ValueError(f"a particle mesh needs distinct ranks of the {world}-rank "
                         f"process group, asked for {ranks}")
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(dev.type, torch.tensor(ranks), mesh_dim_names=(PARTICLE_AXIS,))


def in_mesh(mesh) -> bool:
    """Whether this process is one of the mesh's ranks."""
    return mesh.get_coordinate() is not None


def rank_device(mesh) -> torch.device:
    """The device of this rank's particles on ``mesh``: its current card for
    a CUDA mesh, else the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _placements():
    import torch.distributed.tensor as dt

    return dt.Shard, dt.Replicate


def particle_sharding(mesh):
    """The placements of a particle-sharded tensor on ``mesh``: the
    counterpart of ``NamedSharding(mesh, P(PARTICLE_AXIS))``."""
    shard, _ = _placements()
    return (shard(0),)


def replicated_sharding(mesh):
    """The placements of a replicated tensor: ``P()``'s counterpart."""
    _, replicate = _placements()
    return (replicate(),)

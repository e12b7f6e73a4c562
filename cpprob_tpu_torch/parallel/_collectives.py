"""The five collectives of the particle mesh: the counterparts of the
``lax.psum``, ``lax.pmax``, ``lax.all_gather``, ``lax.ppermute`` and
``lax.axis_index`` that the reference's ``shard_map`` bodies call.  Every
function of :mod:`cpprob_tpu_torch.parallel` reaches the other ranks
through these, so the communication is found here and nowhere else.

Every rank must issue the same collectives in the same order: a collective
issued on one rank and not on another waits until the group's timeout.

Transport, decided by the group's backend (never by catching an error):

- NCCL takes the device tensors as they are, and nothing is staged.
- gloo takes CUDA tensors in ``all_reduce`` and the all-gather (it copies
  them to the host itself), but its ``isend``/``irecv`` of a CUDA tensor
  aborts the process ("writev: Bad address", seen on an H100 with torch
  2.11).  So a point-to-point buffer of a CUDA tensor on a
  gloo group is copied into pinned host memory before the call and back
  to the card after it, explicitly.  A gloo rank keeps its particles on
  its card, and only the transport goes through the host.

A ``ppermute`` pair from a rank to itself is a local copy: PyTorch's
``isend``/``irecv`` to one's own rank raise, and JAX's ``ppermute`` with
``(i, i)`` is the identity.  At world size 1 no point-to-point call is
made at all.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.distributed as dist

from .mesh import in_mesh

__all__ = ["psum", "pmax", "all_gather", "ppermute", "axis_index", "axis_size",
           "ALL_GATHER_CALL", "BYTES_SENT"]

# the all-gather call, picked once by what torch.distributed has
# (``all_gather_into_tensor`` is deprecated for ``all_gather_single`` in
# newer releases)
ALL_GATHER_CALL = ("all_gather_single" if hasattr(dist, "all_gather_single")
                   else "all_gather_into_tensor")
_ALL_GATHER = getattr(dist, ALL_GATHER_CALL)

# payload bytes this process handed to each kind of call: "ppermute" counts
# only what goes to another rank
BYTES_SENT = {"all_reduce": 0, "all_gather": 0, "ppermute": 0}


def axis_index(mesh) -> int:
    """This rank's index on the mesh's particle axis; a rank outside a
    sub-mesh has none and raises."""
    if not in_mesh(mesh):
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh "
                         f"{mesh.mesh.reshape(-1).tolist()}")
    return mesh.get_local_rank()


def axis_size(mesh) -> int:
    """The number of ranks on the mesh."""
    return mesh.size()


def _stages(group, x: torch.Tensor) -> bool:
    """Whether a point-to-point buffer goes through host memory: a CUDA
    tensor on a gloo group."""
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def _all_reduce(x: torch.Tensor, mesh, op) -> torch.Tensor:
    out = x.clone()                     # all_reduce works in place
    BYTES_SENT["all_reduce"] += out.numel() * out.element_size()
    dist.all_reduce(out, op=op, group=mesh.get_group())
    return out


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, the same on every rank."""
    return _all_reduce(x, mesh, dist.ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh) -> torch.Tensor:
    """The elementwise maximum of ``x`` over the ranks."""
    return _all_reduce(x, mesh, dist.ReduceOp.MAX)


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``x`` stacked on a new leading axis ``(k, ...)``, in
    mesh order."""
    k = mesh.size()
    flat = x.reshape(-1).contiguous()          # gathered as one concatenation
    BYTES_SENT["all_gather"] += flat.numel() * flat.element_size()
    out = torch.empty(k * flat.numel(), dtype=x.dtype, device=x.device)
    _ALL_GATHER(out, flat, group=mesh.get_group())
    return out.reshape((k,) + tuple(x.shape))


def ppermute(x: torch.Tensor, perm: Sequence[Tuple[int, int]], mesh) -> torch.Tensor:
    """``lax.ppermute``: for each pair ``(src, dst)`` of mesh indices, rank
    ``dst`` receives ``src``'s ``x``; a rank that receives nothing gets
    zeros.  One ``batch_isend_irecv`` holds this rank's send and its
    receive, so a ring never deadlocks."""
    my = axis_index(mesh)
    group = mesh.get_group()
    ranks = mesh.mesh.reshape(-1).tolist()       # mesh index -> global rank
    dsts = [d for s, d in perm if s == my]
    srcs = [s for s, d in perm if d == my]
    if len(srcs) > 1:
        raise ValueError(f"ppermute: rank {my} receives from {srcs}")
    if not srcs:
        out = torch.zeros_like(x)
    elif srcs[0] == my:
        out = x.clone()
    else:
        out = None
    remote = [d for d in dsts if d != my]
    if not remote and out is not None:
        return out
    stage = _stages(group, x)
    send = _to_host(x) if stage else x.contiguous()
    ops = [dist.P2POp(dist.isend, send, ranks[d], group) for d in remote]
    BYTES_SENT["ppermute"] += len(remote) * send.numel() * send.element_size()
    recv = None
    if out is None:
        recv = (torch.empty(x.shape, dtype=x.dtype, pin_memory=True) if stage
                else torch.empty_like(x))
        ops.append(dist.P2POp(dist.irecv, recv, ranks[srcs[0]], group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if recv is None:
        return out
    return recv.to(x.device, non_blocking=True) if stage else recv

"""Distributed resampling over the particle mesh — counterpart of
``cpprob_tpu/parallel/resampling.py``.

Each function runs on every rank of the mesh with this rank's slice of the
weights (and states), where the reference's run inside a ``shard_map``
body; ``axis_name`` becomes the mesh.  The global quantities ride the
collectives of :mod:`._collectives`.  As everywhere in the port (F7), the
weights' prefix sums and the slot arithmetic are float64, and the prefix
over the k shard totals is a serial sum, so the ring's block boundaries
and the balanced scheme's ticks are the same float64 numbers.

- ``collective``: exact global systematic resampling.
  :func:`sharded_systematic_ancestors` all-gathers the global CDF;
  :func:`ring_systematic_resample` passes each shard's (states, prefix)
  block around the ring instead, O(N/k) memory a rank.
- :func:`balanced_systematic_resample`: the same population with O(bound)
  rows sent a rank, and the exact ring when the imbalance exceeds the
  bound (decided by one host read, the same on every rank).  With
  ``fallback="none"`` it still checks the fit and raises (the reference
  skips the check there, fault F2).
- ``island``: :func:`local_systematic_ancestors`, systematic within the
  shard, no data motion.
"""

from __future__ import annotations

import math

import torch

from ..distributions.base import host_item, to_device
from ..inference.resampling import systematic_ancestors_from_cdf
from ..util.pytree import tree_flatten, tree_unflatten
from ._collectives import all_gather, axis_index, axis_size, ppermute, psum

__all__ = [
    "global_ess",
    "global_log_mean_exp",
    "sharded_systematic_ancestors",
    "ring_systematic_resample",
    "balanced_systematic_resample",
    "local_systematic_ancestors",
]


def _global_max(log_w_local: torch.Tensor, mesh) -> torch.Tensor:
    """The maximum log-weight over every shard, float64, 0-d (one
    all-gather: on NCCL a one-element all-reduce costs ~6x more device time,
    ``util/sharded_parts.py``)."""
    return torch.max(all_gather(torch.max(log_w_local).reshape(1), mesh)).double()


def _global_sums(log_w_local: torch.Tensor, mesh):
    """(m, sum e^(w - m), sum e^(2(w - m))) over every shard, float64, with m
    the global maximum, from one all-gather of each shard's (local maximum,
    its two sums).  Every rank combines the same gathered numbers by the
    same operations, so the result is the same on every rank, bit for bit."""
    lw = log_w_local.double()
    m = torch.max(lw)
    w = torch.exp(lw - m)
    g = all_gather(torch.stack([m, torch.sum(w), torch.sum(w * w)]), mesh)   # (k, 3)
    gm = torch.max(g[:, 0])
    scale = torch.exp(g[:, 0] - gm)
    return gm, torch.sum(g[:, 1] * scale), torch.sum(g[:, 2] * scale * scale)


def global_log_mean_exp(log_w_local: torch.Tensor, mesh) -> torch.Tensor:
    """logmeanexp over the whole sharded weight vector, float64, the same
    on every rank."""
    m, s, _ = _global_sums(log_w_local, mesh)
    return m + torch.log(s) - math.log(log_w_local.shape[0] * axis_size(mesh))


def global_ess(log_w_local: torch.Tensor, mesh) -> torch.Tensor:
    """Kish ESS of the whole sharded weight vector, float64, the same on
    every rank."""
    _, s1, s2 = _global_sums(log_w_local, mesh)
    return s1 * s1 / s2


def _weighted_mean(vals: torch.Tensor, log_w_local: torch.Tensor, mesh):
    """(the weighted mean of ``vals`` (n, ...) over every shard, this
    shard's weights shifted by the global maximum, their global sum), in
    ``vals``' float type; one all-reduce of the sums."""
    vals = vals.to(torch.promote_types(vals.dtype, torch.float32))
    w = torch.exp(log_w_local.double() - _global_max(log_w_local, mesh)).to(vals.dtype)
    w = w.reshape(w.shape + (1,) * (vals.dim() - 1))
    s = psum(torch.cat([torch.sum(w * vals, 0).reshape(-1), torch.sum(w).reshape(1)]), mesh)
    return (s[:-1] / s[-1]).reshape(vals.shape[1:]), w, s[-1]


def _serial_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix of a short vector, added left to right, so that
    ``out[s] == out[s - 1] + x[s]`` holds bit for bit (a device scan need
    not add in that order)."""
    acc = [x[0]]
    for i in range(1, x.shape[0]):
        acc.append(acc[-1] + x[i])
    return torch.stack(acc)


def _prefix(log_w_local: torch.Tensor, mesh):
    """(local inclusive prefix, shard totals (k,), their serial prefix,
    the total, the shards' offsets), float64, the weights shifted by the
    global maximum, from one all-gather of each shard's (local maximum,
    local total)."""
    lw = log_w_local.double()
    m = torch.max(lw)
    local_cum = torch.cumsum(torch.exp(lw - m), 0)
    g = all_gather(torch.stack([m, local_cum[-1]]), mesh)             # (k, 2)
    scale = torch.exp(g[:, 0] - torch.max(g[:, 0]))    # exactly 1 where m is the max
    local_cum = local_cum * scale[axis_index(mesh)]
    sums = g[:, 1] * scale
    cum = _serial_cumsum(sums)
    offsets = torch.cat([cum.new_zeros(1), cum[:-1]])
    return local_cum, sums, cum, cum[-1], offsets


def _u0(u0, device) -> torch.Tensor:
    return to_device(u0, device, torch.float64).reshape(())


def _expand(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def sharded_systematic_ancestors(u0, log_w_local: torch.Tensor, mesh) -> torch.Tensor:
    """Exact global systematic resampling: the *global* ancestor indices
    (int32, (n_local,)) of this shard's output slots [my*n_local,
    (my+1)*n_local).  ``u0`` must be the same uniform on every rank."""
    n_local = log_w_local.shape[0]
    my, k = axis_index(mesh), axis_size(mesh)
    n_total = n_local * k
    local_cum, _, _, total, offsets = _prefix(log_w_local, mesh)
    my_cdf = (local_cum + offsets[my]) / total
    full_cdf = all_gather(my_cdf, mesh).reshape(n_total)
    anc = systematic_ancestors_from_cdf(full_cdf, _u0(u0, full_cdf.device), n_total)
    return anc[my * n_local:(my + 1) * n_local]


def ring_systematic_resample(u0, log_w_local: torch.Tensor, states_local, mesh):
    """Exact global systematic resampling with O(N/k) memory a rank: each
    shard's (states, prefix) block travels the ring (k - 1 hops), and a
    rank fills those of its output slots whose comb positions fall in the
    block it holds (right-bisect ties, as
    :func:`~cpprob_tpu_torch.inference.resampling.systematic_ancestors_from_cdf`).
    ``u0`` must be the same on every rank; ``states_local`` a tensor or a
    tree of them.  Returns this shard's slice of the resampled population."""
    return _ring(u0, log_w_local, states_local, mesh, _prefix(log_w_local, mesh))


def _ring(u0, log_w_local, states_local, mesh, prefix):
    local_cum, _, cum, total, offsets = prefix
    n_local = log_w_local.shape[0]
    my, k = axis_index(mesh), axis_size(mesh)
    n_total = n_local * k
    j = my * n_local + torch.arange(n_local, dtype=torch.float64, device=local_cum.device)
    p = (j + _u0(u0, local_cum.device)) / n_total
    leaves, treedef = tree_flatten(states_local)
    out = [torch.zeros_like(x) for x in leaves]
    filled = torch.zeros(n_local, dtype=torch.bool, device=local_cum.device)
    ring = [(i, (i + 1) % k) for i in range(k)]
    cur, cur_cum = leaves, local_cum
    for r in range(k):
        s = (my - r) % k                        # the block held this round
        bc = (cur_cum + offsets[s]) / total     # its global CDF segment
        t = torch.clamp(torch.searchsorted(bc, p, right=True), 0, n_local - 1)
        inb = (p >= offsets[s] / total) & ~filled
        if s != k - 1:                          # the last block takes the rest
            inb = inb & (p < cum[s] / total)
        out = [torch.where(_expand(inb, o), c[t], o) for o, c in zip(out, cur)]
        filled = filled | inb
        if r < k - 1:
            cur = [ppermute(c, ring, mesh) for c in cur]
            cur_cum = ppermute(cur_cum, ring, mesh)
    return tree_unflatten(treedef, out)


def balanced_systematic_resample(u0, log_w_local: torch.Tensor, states_local, mesh,
                                 bound: int | None = None, fallback: str = "ring"):
    """Exact global systematic resampling with O(bound) rows sent a rank.

    Shard s's weight segment receives output slots [ticks[s-1], ticks[s])
    with ``ticks = ceil(N * cumsum(S) / total - u0)`` from the shard totals
    S, the same on every rank; each rank produces the ancestors of its own
    slots against its local CDF, and two ``bound``-row buffers to its ring
    neighbours re-balance the population to n_local a rank.  When the
    imbalance fits the bound the result is slot for slot that of
    :func:`ring_systematic_resample`.

    The fit (the largest |ticks - (s+1)·n_local| over the ranks) is read
    on the host, one counted read (``HOST_READS["smc_sharded"]``), so
    every rank takes the same branch.
    If it does not fit, ``fallback="ring"`` runs the exact ring; with
    ``fallback="none"`` it raises ``ValueError`` naming the bound the
    weights needed.  ``bound`` defaults to ``max(1024, n_local // 64)``,
    capped at n_local."""
    if fallback not in ("ring", "none"):
        raise ValueError(f"fallback must be 'ring' or 'none', got {fallback!r}")
    n_local = log_w_local.shape[0]
    my, k = axis_index(mesh), axis_size(mesh)
    n_total = n_local * k
    if bound is None:
        bound = max(1024, n_local // 64)
    bound = min(bound, n_local)
    prefix = _prefix(log_w_local, mesh)
    local_cum, _, cum, total, offsets = prefix
    dev = local_cum.device
    u0 = _u0(u0, dev)

    # segment slot boundaries, the same on every rank
    ticks = torch.clamp(torch.ceil(n_total * (cum / total) - u0), 0, n_total)
    ticks = torch.cat([ticks[:-1], torch.full_like(ticks[-1:], n_total)])
    ticks = torch.cummax(ticks, 0).values.long()
    t_lo = ticks[my - 1] if my > 0 else ticks.new_zeros(())
    t_hi = ticks[my]
    dev_rows = torch.maximum(torch.abs(t_lo - my * n_local),
                             torch.abs(t_hi - (my + 1) * n_local))
    need = host_item(torch.max(all_gather(dev_rows.reshape(1), mesh)), "smc_sharded")
    if need > bound:
        if fallback == "none":
            raise ValueError(
                f"balanced_systematic_resample: these weights need bound >= {need} "
                f"rows, above bound={bound}, and fallback='none' leaves out the "
                f"exact ring")
        return _ring(u0, log_w_local, states_local, mesh, prefix)

    # local production of my produced slots [t_lo, t_hi) into a static
    # (n_local + 2*bound) buffer
    cap = n_local + 2 * bound
    j = t_lo + torch.arange(cap, device=dev)
    p = (j.double() + u0) / n_total
    bc = (local_cum + offsets[my]) / total
    t = torch.clamp(torch.searchsorted(bc, p, right=True), 0, n_local - 1)
    j_eff = torch.where(j < t_hi, j, -1)        # rows past my range go nowhere
    leaves, treedef = tree_flatten(states_local)
    produced = [x[t] for x in leaves]

    # boundary redistribution: my head rows may belong to the left
    # neighbour's slots, my tail rows to the right neighbour's
    n_mine = torch.clamp(t_hi - t_lo, 0, cap)
    tail_idx = torch.clamp(n_mine - bound, 0, cap - bound) + torch.arange(bound, device=dev)
    perm_l = [(i, (i - 1) % k) for i in range(k)]
    perm_r = [(i, (i + 1) % k) for i in range(k)]
    from_right = [ppermute(x[:bound], perm_l, mesh) for x in produced]
    from_right_j = ppermute(j_eff[:bound], perm_l, mesh)
    from_left = [ppermute(x[tail_idx], perm_r, mesh) for x in produced]
    from_left_j = ppermute(j_eff[tail_idx], perm_r, mesh)

    # assembly of my target slots [my*n_local, (my+1)*n_local): my own rows
    # are contiguous in slot order (|base - t_lo| <= bound after the fit
    # check), the neighbours' are placed by slot, each slot having one
    # producer; rows outside my range land in a spare slot that is cut off
    base = my * n_local
    i = torch.arange(n_local, device=dev)
    own_ok = (base + i >= t_lo) & (base + i < t_hi)
    own_idx = torch.clamp(base - t_lo + i, 0, cap - 1)
    out = []
    for prod, rl, rr in zip(produced, from_left, from_right):
        own = torch.where(_expand(own_ok, prod), prod[own_idx], torch.zeros_like(prod[:1]))
        ext = torch.cat([own, torch.zeros_like(prod[:1])])
        for buf, bj in ((rl, from_left_j), (rr, from_right_j)):
            rel = bj - base
            ext[torch.where((rel >= 0) & (rel < n_local), rel, n_local)] = buf
        out.append(ext[:n_local])
    return tree_unflatten(treedef, out)


def local_systematic_ancestors(u0, log_w_local: torch.Tensor, mesh) -> torch.Tensor:
    """Island resampling: systematic within the shard, *local* ancestor
    indices (int32).  The comb's offset is decorrelated across shards
    (``u0 + 0.618... · rank`` mod 1).  The caller keeps the island's mean
    weight as the carried log-weight, so the evidence stays unbiased at
    the island level."""
    n_local = log_w_local.shape[0]
    w = torch.exp(log_w_local.double() - torch.max(log_w_local).double())
    cdf = torch.cumsum(w, 0)
    cdf = cdf / cdf[-1]
    u = torch.remainder(_u0(u0, cdf.device) + axis_index(mesh) * 0.6180339887, 1.0)
    positions = (u + torch.arange(n_local, dtype=torch.float64, device=cdf.device)) / n_local
    anc = torch.searchsorted(cdf, positions, right=True)
    return torch.clamp(anc, 0, n_local - 1).to(torch.int32)

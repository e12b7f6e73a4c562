"""NUTS — No-U-Turn Sampler — counterpart of ``cpprob_tpu/inference/nuts.py``:
the iterative tree-doubling algorithm with multinomial sampling within
subtrees and biased progressive sampling across doublings (Betancourt
2017), in the checkpoint formulation (a subtree of depth d needs only
``max_depth`` momentum checkpoints for its internal U-turn checks).

**All chains build their trees in lockstep.**  The reference's two
``while_loop``s run, under ``jax.vmap``, while any chain's condition
holds, and freeze the finished chains by select.  Here the doublings and
the leapfrog steps of a subtree are Python loops over all chains, and
every per-chain update (the tree's edges and proposal, its log-weight, the
checkpoints, the acceptance statistic and the leaf count) is a select on
that chain's own mask: a chain that has turned or diverged changes no
more.  A loop ends when no chain is left in it, which is a host read:
**one a doubling and one a leapfrog step**, each of one flag over all
chains, counted in ``distributions.base.HOST_READS["nuts"]`` (they are the
only synchronisations of a transition, allowed under
``torch.cuda.set_sync_debug_mode("error")``).  A transition therefore runs
as many leapfrog steps as the vmapped reference, those of its
longest-running chain.

Each leapfrog step takes one gradient evaluation: the gradient (and the
potential) at a tree's edges are carried, where the reference evaluates
two gradients and a potential a step.

Warmup shares the HMC machinery (:func:`.hmc.adaptive_run`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..distributions.base import host_any
from .hmc import HMCResult, adaptive_run
from .potential import FlatModel, batched_grad, flatten_model
from .sis import _generator

__all__ = ["nuts", "make_nuts_kernel"]

_MAX_DELTA_ENERGY = 1000.0


def _is_turning(inv_mass, r_left, r_right, r_sum):
    """The U-turn criterion; positions and momenta (..., dim), one flag
    per leading index."""
    v_left = inv_mass * r_left
    v_right = inv_mass * r_right
    r_sum_c = r_sum - 0.5 * (r_left + r_right)
    return (torch.sum(v_left * r_sum_c, -1) <= 0) | (torch.sum(v_right * r_sum_c, -1) <= 0)


def _bit_length(x):
    """Bits of the non-negative int (or int tensor) ``x`` below 2^31."""
    return sum((x >> b) > 0 for b in range(31))


def _leaf_to_ckpt_idxs(n):
    """leaf index (within a subtree) -> (idx_min, idx_max) checkpoint range,
    as the reference's two loops compute it: idx_max is the bit length of
    ``n >> 1``, and the range spans as many checkpoints as ``n`` has
    trailing ones (``n ^ (n + 1)`` has one more bit than that)."""
    idx_max = _bit_length(n >> 1)
    num_subtrees = _bit_length(n ^ (n + 1)) - 1
    return idx_max - num_subtrees + 1, idx_max


def _iterative_turning(inv_mass, r_ckpts, r_sum_ckpts, r, r_sum, idx_min: int, idx_max: int):
    """Whether the subtree ending at the leaf with momentum ``r`` turns
    against any checkpoint in ``[idx_min, idx_max]`` (the reference's loop
    stops at the first that does; the result is their OR)."""
    turning = torch.zeros(r.shape[:-1], dtype=torch.bool, device=r.device)
    for i in range(idx_max, idx_min - 1, -1):
        subtree_r_sum = r_sum - r_sum_ckpts[i] + r_ckpts[i]
        turning = turning | _is_turning(inv_mass, r_ckpts[i], r, subtree_r_sum)
    return turning


class _Draws:
    """A transition's random numbers, drawn from ``generator`` when they are
    needed, or read from ``pinned``: a dict of standard-normal momenta
    "mom" (n_chains, dim), per doubling the direction "dir" (True:
    forward) and the biased-progressive uniform "bias" (n_chains,
    max_depth), per leaf of a subtree its multinomial uniform "leaf"
    (n_chains, max_depth, 2^(max_depth - 1))."""

    def __init__(self, generator, n: int, pinned=None):
        self.generator, self.n, self.pinned = generator, n, pinned

    def _rand(self, shape=()):
        return torch.rand((self.n,) + shape, generator=self.generator,
                          device=self.generator.device)

    def mom(self, dim):
        if self.pinned is not None:
            return self.pinned["mom"]
        return torch.randn((self.n, dim), generator=self.generator,
                           device=self.generator.device)

    def dir(self, depth):
        return self.pinned["dir"][:, depth] if self.pinned is not None else self._rand() < 0.5

    def bias(self, depth):
        return self.pinned["bias"][:, depth] if self.pinned is not None else self._rand()

    def leaf(self, depth, k):
        return self.pinned["leaf"][:, depth, k] if self.pinned is not None else self._rand()


def _sel(mask, new, old):
    """``new`` where the per-chain ``mask`` holds, else ``old``."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.dim() - mask.dim())), new, old)


def make_nuts_tree(potential: Callable, max_depth: int = 10):
    """One transition's tree for a population of chains: ``tree(generator,
    z (n_chains, dim), eps, inv_mass, draws=None)`` -> the final tree state
    (a dict of per-chain tensors: its edges, proposal ``z_prop`` and its
    potential ``u_prop``, ``diverging``, ``turning``, ``sum_accept``,
    ``num_leaves``); ``draws`` (the dict :class:`_Draws` reads) pins the
    random numbers."""
    vgrad = batched_grad(potential)

    def energy(u, r, inv_mass):
        return u + 0.5 * torch.sum(inv_mass * r * r, -1)

    def build_subtree(start, direction, depth, eps, inv_mass, h0, active, draws):
        """2^depth leapfrog steps from the edge ``start`` = (z, r, g, U) in
        ``direction`` (±1 per chain) for the chains in ``active``;
        multinomial proposal within the subtree; checkpointed internal
        U-turn checks."""
        z, r, g, u = start
        n = z.shape[0]
        dev = z.device
        signed_eps = (direction * eps)[:, None]
        r_ckpts = [torch.zeros_like(r) for _ in range(max_depth + 1)]
        r_sum_ckpts = [torch.zeros_like(r) for _ in range(max_depth + 1)]
        st = {
            "z_right": z, "r_right": r, "g_right": g, "u_right": u,
            "z_prop": z, "u_prop": u,
            "log_weight": torch.full((n,), -torch.inf, device=dev),
            "r_sum": torch.zeros_like(r),
            "diverging": torch.zeros(n, dtype=torch.bool, device=dev),
            "turning": torch.zeros(n, dtype=torch.bool, device=dev),
            "sum_accept": torch.zeros(n, device=dev),
            "num_leaves": torch.zeros(n, device=dev),
        }
        for k in range(1 << depth):
            live = active & ~st["turning"] & ~st["diverging"]
            if k and not host_any(live, "nuts"):   # at k = 0, live is active
                break
            # leapfrog from the subtree's last leaf, its gradient carried
            r1 = r - 0.5 * signed_eps * g
            z1 = z + signed_eps * inv_mass * r1
            g1, u1 = vgrad(z1)
            r1 = r1 - 0.5 * signed_eps * g1
            delta = energy(u1, r1, inv_mass) - h0
            delta = torch.where(torch.isnan(delta), torch.inf, delta)
            lw_leaf = -delta
            new_lw = torch.logaddexp(st["log_weight"], lw_leaf)
            take = torch.log(draws.leaf(depth, k)) < lw_leaf - new_lw
            r_sum = st["r_sum"] + r1
            idx_min, idx_max = _leaf_to_ckpt_idxs(k)
            if k % 2 == 0:
                r_ckpts[idx_max] = _sel(live, r1, r_ckpts[idx_max])
                r_sum_ckpts[idx_max] = _sel(live, r_sum, r_sum_ckpts[idx_max])
                turning = torch.zeros_like(live)
            else:
                turning = _iterative_turning(inv_mass, r_ckpts, r_sum_ckpts, r1, r_sum,
                                             idx_min, idx_max)
            new = {
                "z_right": z1, "r_right": r1, "g_right": g1, "u_right": u1,
                "z_prop": _sel(take, z1, st["z_prop"]), "u_prop": torch.where(take, u1, st["u_prop"]),
                "log_weight": new_lw, "r_sum": r_sum,
                "diverging": delta > _MAX_DELTA_ENERGY, "turning": turning,
                "sum_accept": st["sum_accept"] + torch.clamp(torch.exp(-delta), max=1.0),
                "num_leaves": st["num_leaves"] + 1.0,
            }
            st = {k_: _sel(live, new[k_], st[k_]) for k_ in st}
            z, r, g = st["z_right"], st["r_right"], st["g_right"]
        return st

    def tree(generator, z, eps, inv_mass, draws=None):
        n, dim = z.shape
        draws = _Draws(generator, n, draws)
        r = draws.mom(dim) / torch.sqrt(inv_mass)
        g, u = vgrad(z)
        h0 = energy(u, r, inv_mass)
        dev = z.device
        ts = {
            "z_left": z, "r_left": r, "g_left": g, "u_left": u,
            "z_right": z, "r_right": r, "g_right": g, "u_right": u,
            "z_prop": z, "u_prop": u,
            "log_weight": torch.zeros(n, device=dev), "r_sum": r,
            "diverging": torch.zeros(n, dtype=torch.bool, device=dev),
            "turning": torch.zeros(n, dtype=torch.bool, device=dev),
            "sum_accept": torch.zeros(n, device=dev),
            "num_leaves": torch.ones(n, device=dev),
        }
        for depth in range(max_depth):
            active = ~ts["turning"] & ~ts["diverging"]
            if not host_any(active, "nuts"):
                break
            fwd = draws.dir(depth)
            direction = torch.where(fwd, 1.0, -1.0)
            start = tuple(_sel(fwd, ts[f"{a}_right"], ts[f"{a}_left"]) for a in "zrgu")
            sub = build_subtree(start, direction, depth, eps, inv_mass, h0, active, draws)
            # biased progressive sampling across the doubling
            log_accept = torch.clamp(sub["log_weight"] - ts["log_weight"], max=0.0)
            take = torch.log(draws.bias(depth)) < log_accept
            take = take & ~sub["diverging"] & ~sub["turning"]
            new = {}
            for a in "zrgu":
                new[f"{a}_left"] = _sel(fwd, ts[f"{a}_left"], sub[f"{a}_right"])
                new[f"{a}_right"] = _sel(fwd, sub[f"{a}_right"], ts[f"{a}_right"])
            new["z_prop"] = _sel(take, sub["z_prop"], ts["z_prop"])
            new["u_prop"] = torch.where(take, sub["u_prop"], ts["u_prop"])
            new["r_sum"] = ts["r_sum"] + sub["r_sum"]
            new["turning"] = sub["turning"] | _is_turning(
                inv_mass, new["r_left"], new["r_right"], new["r_sum"])
            new["log_weight"] = torch.logaddexp(ts["log_weight"], sub["log_weight"])
            new["diverging"] = sub["diverging"]
            new["sum_accept"] = ts["sum_accept"] + sub["sum_accept"]
            new["num_leaves"] = ts["num_leaves"] + sub["num_leaves"]
            ts = {k_: _sel(active, new[k_], ts[k_]) for k_ in ts}
        return ts

    return tree


def make_nuts_kernel(
    potential: Callable,
    max_depth: int = 10,
):
    """One NUTS transition for a population of chains:
    ``kernel(generator, z (n_chains, dim), eps, inv_mass, draws=None) ->
    (z', mean_accept, U(z'))``; ``draws`` (the dict :class:`_Draws` reads)
    pins the random numbers."""
    tree = make_nuts_tree(potential, max_depth)

    def kernel(generator, z, eps, inv_mass, draws=None):
        ts = tree(generator, z, eps, inv_mass, draws)
        mean_accept = ts["sum_accept"] / torch.clamp(ts["num_leaves"] - 1.0, min=1.0)
        return ts["z_prop"], mean_accept, ts["u_prop"]

    return kernel


def nuts(
    model: Callable,
    args: Tuple,
    key,
    *,
    n_samples: int = 1000,
    n_warmup: int = 500,
    n_chains: int = 4,
    max_depth: int = 8,
    initial_step_size: float = 0.1,
    target_accept: float = 0.8,
    flat: Optional[FlatModel] = None,
    jit: bool = True,
    device="cuda",
) -> HMCResult:
    """Adaptive NUTS over the model's continuous latents; same result type
    and warmup scheme as :func:`cpprob_tpu_torch.inference.hmc.hmc`."""
    flat = flat or flatten_model(model, args, device)
    kernel = make_nuts_kernel(flat.potential, max_depth)
    return adaptive_run(kernel, flat, _generator(key, flat.device), n_chains, n_warmup,
                        n_samples, initial_step_size, target_accept)

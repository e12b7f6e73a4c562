"""Effect-aware loops over model sites — counterpart of
``cpprob_tpu/core/scanner.py``.

:func:`scan_sites` runs ``body(carry, x, idx) -> (carry, out)`` over the
leading axis of ``xs`` with primitive statements allowed in the body.  The
port has no ``lax.scan``: both paths are Python loops that thread the same
carry, and they differ in addresses and bookkeeping exactly as the
reference's do:

- **fast path** (the stack holds ``Seed`` / ``Scope`` / ``LogWeight`` /
  ``PredictCollector`` and messengers with a ``scan_adapter`` hook, such as
  a guided-inference messenger): each iteration runs the body under a
  fresh inner stack, the addresses are tied (``idx`` formats as ``*``),
  each ``LogWeight`` receives the loop's summed log-weight as one term, and
  each ``PredictCollector`` one stacked ``(length, ...)`` block per name.
  A messenger's adapter gives ``init``, ``make(state)`` (the iteration's
  messenger), ``extract(messenger)`` and ``commit(final_state)``.
- **fallback** (any other handler — ``TraceHandler``, ``SimulateObserves``,
  ``Replay``, ...): the loop unrolls with concrete indices in the addresses
  (``z[1]``, ``z[2]``, ...), so a scan-form model has the same trace
  addresses as its unrolled twin.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils import _pytree as pytree

from . import handlers
from .handlers import LogWeight, PredictCollector, Scope, Seed, as_tensor

__all__ = ["scan_sites", "SiteIndex"]


class SiteIndex:
    """Loop-index placeholder for site addresses inside ``scan_sites``
    bodies: formats as the concrete index in the unrolled fallback, and as
    ``*`` in the fast path (tied addresses)."""

    __slots__ = ("value",)

    def __init__(self, value: Optional[int] = None):
        self.value = value

    def __str__(self):
        return "*" if self.value is None else str(self.value)

    def __format__(self, spec):
        return format(str(self), spec)

    def __repr__(self):
        return f"SiteIndex({self.value})"


def _classify(stack, length):
    """Partition the active handler stack for the fast path; None => fallback."""
    seed = None
    passthrough = []   # stateless messengers included verbatim (Scope)
    lw_handlers = []   # LogWeight (and subclasses): one summed term
    pc_handlers = []   # PredictCollector: one stacked block per name
    adapted = []       # (handler, adapter) for scan-aware messengers
    for h in stack:
        if isinstance(h, Seed):
            seed = h  # innermost Seed wins
        elif isinstance(h, Scope):
            passthrough.append(h)
        elif isinstance(h, LogWeight):  # includes LogJoint
            lw_handlers.append(h)
        elif isinstance(h, PredictCollector):
            pc_handlers.append(h)
        else:
            make = getattr(h, "scan_adapter", None)
            ad = make(length) if make is not None else None
            if ad is None:
                return None
            adapted.append((h, ad))
    if seed is None:
        return None
    return seed, passthrough, lw_handlers, pc_handlers, adapted


def _stack_outs(outs):
    if not outs or outs[0] is None:
        return None
    return pytree.tree_map(lambda *v: torch.stack(v), *outs)


def scan_sites(
    body: Callable,
    init: Any,
    xs: Any,
    *,
    length: Optional[int] = None,
    index_offset: int = 0,
):
    """Run ``body(carry, x, idx) -> (carry, out)`` over the leading axis of
    ``xs``, with primitive statements allowed inside the body.

    Returns ``(final_carry, stacked_outs)`` (outs stacked over iterations, or
    None if the body returns None).
    """
    if length is None:
        leaves = pytree.tree_leaves(xs)
        if not leaves:
            raise ValueError("scan_sites needs xs or an explicit length")
        length = leaves[0].shape[0]

    def x_at(t):
        return None if xs is None else pytree.tree_map(lambda a: a[t], xs)

    classified = _classify(handlers.current_stack(), length)
    if classified is None:
        # ---- unrolled fallback: full handler generality ----
        carry, outs = init, []
        for t in range(length):
            carry, out = body(carry, x_at(t), SiteIndex(t + index_offset))
            outs.append(out)
        return carry, _stack_outs(outs)

    seed, passthrough, lw_handlers, pc_handlers, adapted = classified
    carry = init
    states = [ad.init for _, ad in adapted]
    totals = [None] * len(lw_handlers)
    preds, outs = {}, []
    saved = handlers._STACK[:]
    try:
        for t in range(length):
            inner_lws = [type(h)() for h in lw_handlers]
            inner_pc = PredictCollector()
            step_msgrs = [ad.make(st) for (_, ad), st in zip(adapted, states)]
            handlers._STACK[:] = ([Seed(seed.generator)] + passthrough + inner_lws
                                  + [inner_pc] + step_msgrs)
            carry, out = body(carry, x_at(t), SiteIndex(None))
            outs.append(out)
            totals = [lw.log_weight if acc is None else acc + lw.log_weight
                      for acc, lw in zip(totals, inner_lws)]
            states = [ad.extract(m) for (_, ad), m in zip(adapted, step_msgrs)]
            for name, vals in inner_pc.predicts.items():
                preds.setdefault(name, []).append(
                    vals[0] if len(vals) == 1 else torch.stack(vals))
    finally:
        handlers._STACK[:] = saved

    for h, total in zip(lw_handlers, totals):
        h._terms.append(as_tensor(0.0) if total is None else total)
    for h in pc_handlers:
        for name, vals in preds.items():
            h.predicts.setdefault(name, []).append(torch.stack(vals))
    for (_, ad), st in zip(adapted, states):
        ad.commit(st)
    return carry, _stack_outs(outs)

"""Effect-handler substrate — counterpart of ``cpprob_tpu/core/handlers.py``
(the reference's global mode state machine, ``include/cpprob/state.hpp``,
becomes a stack of *messengers* installed as context managers).

The primitives (:func:`cpprob_tpu_torch.sample`, ``observe``, ``predict``,
``factor``) dispatch through the stack; the four reference modes are
compositions, as in the JAX package:

- ``sis``     = ``Seed`` + ``LogWeight`` + ``PredictCollector``
- ``compile`` = ``Seed`` + ``SimulateObserves`` + ``TraceHandler``
- ``csis``    = ``sis`` + a proposal messenger
- ``dryrun``  = ``Seed`` alone (effects disabled)

**The particle axis is ``torch.func.vmap``.**  A model is written for one
particle, and an engine runs a population by
``torch.func.vmap(particle, randomness="different")`` over a dummy
``(n,)`` tensor, with one explicit ``torch.Generator``:

- The models are written per particle.  The JAX package's models index
  with one particle's value (``trans[state]``, ``means[state]``,
  ``points[i, 0]``), and :class:`LogWeight` sums a site's event
  dimensions with one ``sum``.  Over an explicit particle dimension each
  of these changes meaning; under vmap each keeps it, so a model runs on
  both packages with only the array type changed.
- Under ``randomness="different"`` a draw from the generator inside the
  vmapped function is one draw of the population's shape, so every
  particle draws its own value, with the generator's device and state.

Consequences, the port's deviations from the reference:

- :class:`Seed` takes a ``torch.Generator`` where the reference takes a
  key, and hands that one generator to every site in site order.  The
  reference folds the site index into its key (``fold_in(key, i)``); the
  port has no counterpart, so a site's draws depend on the order of the
  sites and on the population's size.
- A model must not branch on a value or read one back (``bool(t)``,
  ``.item()``): under vmap these raise, as under ``jax.vmap``.  The
  rejection loops read one flag a round over the whole population
  (:func:`cpprob_tpu_torch.distributions.base.host_any`).
- While a handled model runs, numbers and host arrays in a model go to the
  innermost ``Seed``'s generator's device
  (:func:`cpprob_tpu_torch.distributions.base.default_device`,
  :func:`as_tensor`); a distribution given ``device=`` keeps it.

Messages carry tensors; each handled execution builds fresh handler
instances.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional

import torch

from ..distributions.base import default_device, to_device

__all__ = [
    "Messenger",
    "Seed",
    "TraceHandler",
    "Substitute",
    "Replay",
    "LogWeight",
    "LogJoint",
    "PredictCollector",
    "SimulateObserves",
    "RejectionGuard",
    "Scope",
    "Mask",
    "apply_stack",
    "current_stack",
]

_STACK: List["Messenger"] = []


def current_stack() -> List["Messenger"]:
    return _STACK


def current_device() -> Optional[torch.device]:
    """The device of the innermost :class:`Seed`'s generator, or None
    outside any ``Seed``."""
    for h in reversed(_STACK):
        if isinstance(h, Seed):
            return h.generator.device
    return None


def as_tensor(x, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on :func:`default_device` (the innermost ``Seed``'s
    generator's device while a handled model runs), without waiting on the
    card: the models' counterpart of ``jnp.asarray``."""
    return to_device(x, default_device(), dtype)


class Messenger:
    """Base effect handler.  Subclasses override ``process_message`` (runs
    innermost-first, before the site's default behavior) and/or
    ``postprocess_message`` (runs outermost-first, after)."""

    def __enter__(self):
        _STACK.append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        popped = _STACK.pop()
        assert popped is self, "handler stack corrupted"
        return False

    def process_message(self, msg: Dict[str, Any]) -> None:
        pass

    def postprocess_message(self, msg: Dict[str, Any]) -> None:
        pass


def new_message(mtype: str, name: Optional[str], dist=None, value=None, **kw) -> Dict[str, Any]:
    msg = {
        "type": mtype,          # 'sample' | 'observe' | 'metaobserve' | 'predict' | 'factor'
        "name": name,           # address string (None => auto-named by Seed/Scope)
        "dist": dist,
        "value": value,
        "key": None,            # the torch.Generator provided by Seed
        "control": True,        # reference's `control` flag (cpprob.hpp:28-35)
        "is_observed": False,
        "log_weight": None,     # importance-weight increment for this site
        "proposal_dist": None,  # set by guided (CSIS) messengers
        "rejection": False,     # inside a rejection_sampling guard
        "postselect": None,     # (done_flag, kept_value): freeze the site's
                                # value once a rejection loop has accepted
        "mask": None,           # multiplicative mask on weight contributions
        "stop": False,
        "done": False,
    }
    msg.update(kw)
    return msg


def apply_stack(msg: Dict[str, Any]) -> Dict[str, Any]:
    """Run a site message through the handler stack.

    process_message: innermost (most recently entered) → outermost, until a
    handler sets ``stop``; then the site's default behavior; then
    postprocess_message over the handlers already visited, outermost-last.
    """
    stack = _STACK
    pointer = 0
    for pointer, handler in enumerate(reversed(stack)):
        handler.process_message(msg)
        if msg["stop"]:
            break

    default_process(msg)

    for handler in stack[len(stack) - pointer - 1:]:
        handler.postprocess_message(msg)
    return msg


def default_process(msg: Dict[str, Any]) -> None:
    """Default site behavior once all handlers ran.

    sample:  draw from the proposal distribution if a guided messenger
             installed one (accumulating the Radon–Nikodym correction,
             cf. ``cpprob.hpp:43-56``), else from the prior.
    observe: weight increment = log p(x) (cf. ``cpprob.hpp:87-89``).
    factor:  weight increment = value.
    """
    if msg["done"]:
        return
    mtype = msg["type"]
    if mtype == "sample":
        dist = msg["dist"]
        if msg["value"] is None:
            proposal = msg["proposal_dist"]
            if msg["key"] is None:
                raise RuntimeError(
                    f"sample site {msg['name']!r} needs a generator: wrap the "
                    "model in cpprob_tpu_torch.handlers.Seed(generator)"
                )
            x = (proposal if proposal is not None else dist).sample(msg["key"])
            if msg["postselect"] is not None:
                # rejection-loop exit: once `done`, the site keeps
                # re-emitting the accepted value, so the LAST occurrence per
                # address is the accepted draw (state.cpp:124-142)
                done, kept = msg["postselect"]
                x = torch.where(done, kept, x)
            msg["value"] = x
            if proposal is not None:
                msg["log_weight"] = dist.log_prob(x) - proposal.log_prob(x)
        elif msg["proposal_dist"] is not None and msg["log_weight"] is None:
            x = msg["value"]
            msg["log_weight"] = dist.log_prob(x) - msg["proposal_dist"].log_prob(x)
        elif msg["is_observed"] and msg["log_weight"] is None:
            # conditioned sample site: likelihood contribution
            msg["log_weight"] = dist.log_prob(msg["value"])
    elif mtype in ("observe", "metaobserve"):
        if msg["value"] is None:
            # SimulateObserves cleared the value (compile mode): draw it.
            if msg["key"] is None:
                raise RuntimeError(
                    f"observe site {msg['name']!r} simulation needs a generator"
                )
            msg["value"] = msg["dist"].sample(msg["key"])
            msg["log_weight"] = None
        elif mtype == "observe":
            msg["log_weight"] = msg["dist"].log_prob(msg["value"])
        # metaobserve: no weight contribution outside compile mode
        # (cpprob.hpp:108-114)
    elif mtype == "factor":
        msg["log_weight"] = msg["value"]
    msg["done"] = True


# ---------------------------------------------------------------------------
# Concrete messengers
# ---------------------------------------------------------------------------


class Seed(Messenger):
    """Provides every site's randomness, replacing the reference's single
    global ``std::mt19937`` (``utils.cpp:16-20``): the one explicit
    ``torch.Generator`` is handed to every site, in site order (the module
    docstring says why there is no per-site ``fold_in``).  Also performs
    auto-naming of anonymous sites (``sample/Normal#0``, ...), and makes the
    generator's device the default device of the model's numbers."""

    def __init__(self, generator: torch.Generator):
        if not isinstance(generator, torch.Generator):
            raise TypeError(f"Seed takes a torch.Generator, not {type(generator).__name__}")
        self.generator = generator
        self._name_counts: Dict[str, int] = collections.Counter()

    def process_message(self, msg):
        if msg["name"] is None:
            base = msg["type"]
            if msg["dist"] is not None:
                base = f"{msg['type']}/{type(msg['dist']).__name__}"
            n = self._name_counts[base]
            self._name_counts[base] += 1
            msg["name"] = f"{base}#{n}"
        if msg["type"] in ("sample", "observe", "metaobserve") and msg["key"] is None:
            msg["key"] = self.generator


class Scope(Messenger):
    """Prefix site addresses — nested scopes reproduce 'address = path
    through the program' without backtraces."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def process_message(self, msg):
        if msg["name"] is not None and not msg.get("_scoped_" + self.prefix, False):
            msg["name"] = f"{self.prefix}/{msg['name']}"
            msg["_scoped_" + self.prefix] = True


class TraceHandler(Messenger):
    """Records every site — counterpart of ``TraceCompile``/``TraceInfer``
    (``trace.hpp``).  ``trace`` maps address → message dict."""

    def __init__(self):
        self.trace: "collections.OrderedDict[str, Dict[str, Any]]" = collections.OrderedDict()

    def postprocess_message(self, msg):
        if msg["type"] in ("sample", "observe", "metaobserve"):
            name = msg["name"]
            if name in self.trace:
                if msg["rejection"]:
                    # inside a rejection guard: keep only the LAST draw per
                    # address (state.cpp:124-142)
                    self.trace[name] = dict(msg)
                    return
                # repeated address (loops without scoping): suffix occurrence
                i = 1
                while f"{name}@{i}" in self.trace:
                    i += 1
                name = f"{name}@{i}"
            self.trace[name] = dict(msg)


class Substitute(Messenger):
    """Fix values at sample sites (by address) — potentials for HMC/NUTS/SVI
    and trace replay."""

    def __init__(self, data: Dict[str, Any]):
        self.data = data

    def process_message(self, msg):
        if msg["type"] == "sample" and msg["name"] in self.data and msg["value"] is None:
            msg["value"] = self.data[msg["name"]]


class Replay(Messenger):
    """Replay sample values from a recorded trace.  Repeated addresses are
    matched by occurrence order (TraceHandler stores them as ``name``,
    ``name@1``, ``name@2``, ...)."""

    def __init__(self, trace):
        self.trace = trace
        self._counts: Dict[str, int] = collections.Counter()

    def process_message(self, msg):
        if msg["type"] != "sample" or msg["value"] is not None:
            return
        name = msg["name"]
        if name is None:
            return
        i = self._counts[name]
        self._counts[name] += 1
        key = name if i == 0 else f"{name}@{i}"
        if key in self.trace:
            msg["value"] = self.trace[key]["value"]


class LogWeight(Messenger):
    """Accumulates the importance log-weight of one model execution —
    counterpart of ``StateInfer::increment_log_prob`` + ``TraceInfer::log_w_``
    (``state.cpp:212-223``).

    Contributions: observe-site log-probs, factor sites, and Radon–Nikodym
    terms from guided sample sites.  Sites inside a ``rejection_sampling``
    guard contribute *only their last occurrence per address*
    (``state.cpp:225-238``).
    """

    def __init__(self):
        self._terms: List[torch.Tensor] = []
        self._rejection_terms: Dict[str, torch.Tensor] = {}
        self._device = None

    def __enter__(self):
        self._device = default_device()
        return super().__enter__()

    def postprocess_message(self, msg):
        lw = msg["log_weight"]
        if lw is None:
            return
        if msg["mask"] is not None:
            lw = lw * msg["mask"]
        lw = torch.sum(as_tensor(lw))
        if msg["rejection"] and msg["type"] == "sample":
            self._rejection_terms[msg["name"]] = lw  # keep-last semantics
        else:
            self._terms.append(lw)

    @property
    def log_weight(self) -> torch.Tensor:
        terms = self._terms + list(self._rejection_terms.values())
        if not terms:
            return torch.zeros((), device=self._device or default_device())
        total = terms[0]
        for t in terms[1:]:
            total = total + t
        return total


class LogJoint(LogWeight):
    """Like :class:`LogWeight` but also adds the *prior* log-prob of every
    (unguided, unobserved) sample site — the HMC/NUTS/SVI potential."""

    def postprocess_message(self, msg):
        if (
            msg["type"] == "sample"
            and msg["log_weight"] is None
            and msg["proposal_dist"] is None
            and msg["value"] is not None
        ):
            msg = dict(msg)
            msg["log_weight"] = msg["dist"].log_prob(msg["value"])
        super().postprocess_message(msg)


class PredictCollector(Messenger):
    """Collects ``predict`` sites — counterpart of ``TraceInfer``'s typed
    predict lists (``trace.hpp:37-62``).  Repeated predicts at one address
    (e.g. the HMM's per-step "State") are stacked in call order."""

    def __init__(self):
        self.predicts: "collections.OrderedDict[str, List[Any]]" = collections.OrderedDict()

    def postprocess_message(self, msg):
        if msg["type"] == "predict":
            self.predicts.setdefault(msg["name"], []).append(as_tensor(msg["value"]))

    def stacked(self) -> Dict[str, torch.Tensor]:
        out = {}
        for name, vals in self.predicts.items():
            if len(vals) == 1:
                out[name] = vals[0]
                continue
            if len({tuple(a.shape) for a in vals}) == 1:
                out[name] = torch.stack(vals)
            else:
                # mixed per-site scalars and scan-stacked (k, ...) blocks
                # (scan_sites fast path): concatenate on the leading axis
                nd = max(a.dim() for a in vals)
                out[name] = torch.cat([a if a.dim() == nd else a[None] for a in vals])
        return out


class SimulateObserves(Messenger):
    """Compile-mode behavior: ``observe(d, x)`` ignores ``x`` and *simulates*
    the observation by drawing from ``d`` (``cpprob.hpp:83-85``)."""

    def process_message(self, msg):
        if msg["type"] in ("observe", "metaobserve"):
            msg["value"] = None  # force a draw in default_process


class RejectionGuard(Messenger):
    """Marks sites as inside a rejection-sampling block — counterpart of the
    RAII ``cpprob::rejection_sampling`` guard (``cpprob.hpp:116-125``)."""

    def process_message(self, msg):
        if msg["type"] == "sample":
            msg["rejection"] = True


class Mask(Messenger):
    """Multiplies weight contributions by a (0/1) mask tensor — the
    substrate for bounded-iteration variable-structure models where
    inactive steps must not contribute."""

    def __init__(self, mask):
        self.mask = mask

    def process_message(self, msg):
        if msg["mask"] is None:
            msg["mask"] = self.mask
        else:
            msg["mask"] = msg["mask"] * self.mask

"""External black-box simulator bridge — counterpart of
``cpprob_tpu/external.py``.

CPProb exists to do inference on models that wrap *external,
non-differentiable, non-introspectable* simulators (its flagship model calls
the SHERPA event generator, ``src/models/sherpa.cpp:29-86``).  Here a model
body may call an out-of-process simulator, and the vmapped engines still
run it:

- :class:`SubprocessSimulator` — a persistent child process speaking a
  line protocol (one whitespace-separated float vector in, one out per
  event), in any language.  It has no PyTorch in it: the port's own copy
  of the reference's.
- :func:`observe_external` — the simulator call as an operator
  (``torch.library.custom_op``) whose vmap rule hands the child the whole
  particle batch in one pipelined exchange, so the host round trip is paid
  once a site for the population (the reference pays one synchronous ZMQ
  round trip *per sample statement*, ``socket.hpp:57-79``).

Eager engines (:class:`~cpprob_tpu_torch.inference.csis_dynamic.DynamicCSIS`,
``sis_host``) may call the simulator directly in the model body.

Typical model shape (``sherpa.cpp:49-68``: simulate, then ABC-observe the
detector response)::

    sim = SubprocessSimulator([...argv...], obs_dim=64)

    def model(observed):
        ch = sample(UniformInt(0, 3), addr="Decay Channel")
        e = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = observe_external(sim, torch.stack([ch.float(), e]), 64)
        observe(make_abc(lambda g: deposits, abc_kernel(deposits)),
                observed, addr="calo")
        predict(ch, "Channel")
"""

from __future__ import annotations

import itertools
import subprocess
import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .distributions.base import HOST_READS, to_device

__all__ = ["SubprocessSimulator", "observe_external"]


class SubprocessSimulator:
    """Persistent out-of-process simulator speaking a text line protocol:
    parent writes one whitespace-separated float vector per event request,
    child answers with one whitespace-separated float vector per line.

    The child is any executable (``argv``); it must answer requests 1:1 in
    order.  ``batch`` pipelines a whole population of requests through the
    pipe with a writer thread (no deadlock on full pipe buffers);
    ``n_exchanges`` counts its calls.
    """

    def __init__(self, argv: Sequence[str], obs_dim: int,
                 start_timeout: float = 30.0):
        self.argv = list(argv)
        self.obs_dim = obs_dim
        self.n_exchanges = 0
        self.proc = subprocess.Popen(
            self.argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            text=True, bufsize=1,
        )
        self._lock = threading.Lock()
        # handshake: child prints "ready <obs_dim>" on startup
        line = self.proc.stdout.readline()
        parts = line.split()
        if len(parts) != 2 or parts[0] != "ready":
            raise RuntimeError(
                f"simulator {self.argv!r} bad handshake: {line!r}"
            )
        child_dim = int(parts[1])
        if child_dim != obs_dim:
            raise RuntimeError(
                f"simulator obs_dim {child_dim} != declared {obs_dim}"
            )

    def __call__(self, params: np.ndarray) -> np.ndarray:
        return self.batch(np.asarray(params, np.float64)[None, :])[0]

    def batch(self, params: np.ndarray) -> np.ndarray:
        """Run one event per row of ``params`` (n, d) -> (n, obs_dim)."""
        params = np.asarray(params, np.float64)
        n = params.shape[0]
        lines = "\n".join(
            " ".join(repr(float(x)) for x in row) for row in params
        ) + "\n"
        out = np.empty((n, self.obs_dim), np.float32)
        with self._lock:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"simulator {self.argv!r} exited with "
                    f"{self.proc.returncode}"
                )
            self.n_exchanges += 1
            writer = threading.Thread(
                target=self.proc.stdin.write, args=(lines,)
            )
            writer.start()
            for i in range(n):
                line = self.proc.stdout.readline()
                if not line:
                    raise RuntimeError("simulator closed its output pipe")
                out[i] = np.fromiter(
                    map(float, line.split()), np.float32,
                    count=self.obs_dim,
                )
            writer.join()
        return out

    def close(self):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
            except OSError:
                pass
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


# the simulators an operator call may reach, by integer id (an operator
# takes tensors and numbers, not Python objects)
_SIMULATORS: Dict[int, SubprocessSimulator] = {}
_ids = itertools.count(1)


def _sim_id(sim: SubprocessSimulator) -> int:
    sid = getattr(sim, "_registry_id", None)
    if sid is None:
        sid = next(_ids)
        sim._registry_id = sid
        _SIMULATORS[sid] = sim
    return sid


def _host_rows(x: torch.Tensor) -> np.ndarray:
    """``x`` copied to the host: the one synchronisation of an exchange,
    counted in ``HOST_READS["observe_external"]`` and allowed under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    HOST_READS["observe_external"] += 1
    if x.device.type != "cuda":
        return x.numpy()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        return x.cpu().numpy()
    finally:
        torch.cuda.set_sync_debug_mode(mode)


@torch.library.custom_op("cpprob_tpu_torch::observe_external", mutates_args=())
def _exchange(inputs: torch.Tensor, sim_id: int, obs_dim: int) -> torch.Tensor:
    """One exchange with the simulator for every row of ``inputs`` (..., d)
    -> (..., obs_dim) float32, on ``inputs``' device."""
    lead = tuple(inputs.shape[:-1])
    rows = _host_rows(inputs.reshape(-1, inputs.shape[-1]))
    out = _SIMULATORS[sim_id].batch(rows).reshape(lead + (obs_dim,))
    return to_device(out, inputs.device)


@_exchange.register_fake
def _(inputs, sim_id, obs_dim):
    return inputs.new_empty(tuple(inputs.shape[:-1]) + (obs_dim,))


@_exchange.register_vmap
def _(info, in_dims, inputs, sim_id, obs_dim):
    """The particle axis to the front, then one call on the (n, ..., d)
    rows: one exchange for the population (under nested vmaps, one for
    all of them)."""
    (dim, _, _) = in_dims
    if dim is None:
        return _exchange(inputs, sim_id, obs_dim), None
    return _exchange(inputs.movedim(dim, 0), sim_id, obs_dim), 0


def observe_external(sim: SubprocessSimulator, inputs, obs_dim: Optional[int]
                     = None, *, salt: Optional[int] = None):
    """Run the external simulator from inside a model run by the vmapped
    engines.

    ``inputs``: 1-D float32 simulator parameters for ONE event.  Under
    ``torch.func.vmap`` (the particle axis) the operator receives the whole
    (n, d) batch and makes a single pipelined exchange with the child
    process.  Returns the (obs_dim,) simulated observation per particle, a
    non-differentiable constant (the reference's contract for wrapped
    simulators), on the inputs' device.

    ``salt`` is kept for the reference's surface and does nothing: it stops
    XLA from merging two identical ``pure_callback`` calls into one, and
    eager PyTorch merges nothing (a deviation).
    """
    del salt
    obs_dim = sim.obs_dim if obs_dim is None else obs_dim
    x = inputs if isinstance(inputs, torch.Tensor) else torch.as_tensor(
        np.asarray(inputs, np.float32))
    return _exchange(x.detach().float(), _sim_id(sim), int(obs_dim))

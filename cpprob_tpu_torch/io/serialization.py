"""Text serialization — the port's copy of ``cpprob_tpu/io/serialization.py``
(numpy only; the port imports nothing of the JAX package; a result's
tensors are copied to the host to be written, and what is read comes back
as numpy arrays and lists, as in the JAX package).  Counterpart of
``include/cpprob/serialization.hpp``
(s-expression-ish format: tuples ``( a b )``, vectors ``[ a b ]``) and of the
posterior dump files written per trace by ``StateInfer::dump_predicts``
(``state.cpp:250-267``: lines ``([(id value) ...] log_w)`` plus a ``.ids``
address file).

Enables: (1) CLI observation parsing compatible with the reference's
``-o [[1 2.1] [2 3.9] ...]`` syntax (``main.cpp``), (2) dumping/loading
posteriors in the reference's on-disk layout, (3) binary ``.npz`` dumps for
large runs.
"""

from __future__ import annotations

import os
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from ..distributions.base import to_host

__all__ = [
    "parse_value",
    "parse_observes",
    "format_value",
    "dump_posterior",
    "load_posterior",
    "dump_posterior_npz",
    "load_posterior_npz",
]

_TOKEN = re.compile(r"[()\[\]{}]|[^\s()\[\]{}]+")


def _tokenize(s: str) -> List[str]:
    return _TOKEN.findall(s)


def _parse_tokens(tokens: List[str], pos: int) -> Tuple[Any, int]:
    t = tokens[pos]
    if t in "([{":
        close = {"(": ")", "[": "]", "{": "}"}[t]
        items = []
        pos += 1
        while tokens[pos] != close:
            item, pos = _parse_tokens(tokens, pos)
            items.append(item)
        if t == "(":
            return tuple(items), pos + 1
        if t == "{":
            return dict(zip(items[::2], items[1::2])), pos + 1
        return items, pos + 1
    pos += 1
    try:
        return int(t), pos
    except ValueError:
        pass
    try:
        return float(t), pos
    except ValueError:
        return t, pos


def parse_value(s: str) -> Any:
    """Parse one s-expression value (``serialization.hpp`` operator>> family)."""
    tokens = _tokenize(s)
    if not tokens:
        raise ValueError("empty input")
    value, pos = _parse_tokens(tokens, 0)
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in {s!r}")
    return value


def parse_observes(s: str) -> Tuple:
    """Parse an observes string into a tuple of model arguments — counterpart
    of ``parse_string`` into the observes tuple (``serialization.hpp:260-285``).
    Top-level whitespace-separated values become tuple elements; lists become
    numpy arrays when rectangular-numeric."""
    tokens = _tokenize(s)
    values = []
    pos = 0
    while pos < len(tokens):
        v, pos = _parse_tokens(tokens, pos)
        values.append(_to_array(v))
    return tuple(values)


def _to_array(v):
    if isinstance(v, list):
        try:
            arr = np.asarray(v, dtype=np.float32)
            return arr
        except (ValueError, TypeError):
            return [_to_array(x) for x in v]
    return v


def format_value(v) -> str:
    """Inverse of :func:`parse_value` (``serialization.hpp`` operator<<)."""
    if isinstance(v, tuple):
        return "( " + " ".join(format_value(x) for x in v) + " )"
    if isinstance(v, dict):
        return "{ " + " ".join(
            f"{format_value(k)} {format_value(val)}" for k, val in v.items()
        ) + " }"
    if isinstance(v, (list, np.ndarray)):
        return "[ " + " ".join(format_value(x) for x in np.asarray(v).tolist()) + " ]"
    if isinstance(v, float):
        return repr(v)
    return str(v)


# ---------------------------------------------------------------------------
# Posterior files (reference on-disk layout)
# ---------------------------------------------------------------------------


def dump_posterior(path: str, result) -> None:
    """Write ``<path>.ids`` + ``<path>.real`` / ``<path>.int`` in the
    reference's format: one line per particle ``([(id value) ...] log_w)``
    (``state.cpp:250-267``)."""
    names = list(result.predicts.keys())
    with open(path + ".ids", "w") as f:
        for n in names:
            f.write(n + "\n")
    log_w = to_host(result.log_weights)
    by_kind = {"int": [], "real": []}
    for i, name in enumerate(names):
        vals = to_host(result.predicts[name])
        kind = "int" if np.issubdtype(vals.dtype, np.integer) else "real"
        by_kind[kind].append((i, vals))
    n = log_w.shape[0]
    for kind, cols in by_kind.items():
        if not cols:
            continue
        with open(f"{path}.{kind}", "w") as f:
            for p in range(n):
                entries = []
                for idx, vals in cols:
                    v = vals[p]
                    if v.ndim == 0:
                        entries.append(f"( {idx} {format_value(v.item())} )")
                    else:
                        for x in v.tolist():
                            entries.append(f"( {idx} {format_value(x)} )")
                f.write(f"( [ {' '.join(entries)} ] {float(log_w[p])!r} )\n")


def _parse_posterior_file_native(fp: str, as_int: bool):
    """Parse one ``.real``/``.int`` file with the native C++ parser
    (``native/src/posterior_parse.cpp``, built by the port into
    ``ops/_build/``: :func:`cpprob_tpu_torch.io.tracefile._load_native`).
    Returns (log_ws, offsets, ids, values) numpy
    arrays, or None when the native library is unavailable."""
    from .tracefile import _load_native

    lib = _load_native()
    if lib is None:
        return None
    import ctypes

    h = lib.cpprob_posterior_parse(fp.encode())
    if not h:
        return None
    try:
        h = ctypes.c_void_p(h)
        n = lib.cpprob_posterior_n_particles(h)
        ne = lib.cpprob_posterior_n_entries(h)
        log_ws = np.ctypeslib.as_array(
            lib.cpprob_posterior_log_weights(h), shape=(n,)
        ).copy()
        offsets = np.ctypeslib.as_array(
            lib.cpprob_posterior_offsets(h), shape=(n + 1,)
        ).copy()
        ids = np.ctypeslib.as_array(lib.cpprob_posterior_ids(h), shape=(ne,)).copy()
        values = np.ctypeslib.as_array(
            lib.cpprob_posterior_values(h), shape=(ne,)
        ).copy()
    finally:
        lib.cpprob_posterior_free(h)
    if as_int:
        values = values.astype(np.int64)
    return log_ws, offsets, ids, values


def load_posterior(path: str, native: Optional[bool] = None):
    """Read files written by :func:`dump_posterior` (or by the C++ reference)
    into {name: (values list per particle)} + log_weights — the parsing half
    of ``StatsPrinter`` (``stats_printer.hpp:88-120``).

    ``native=None`` takes the C++ parser when its build loads and the
    Python s-expression parser otherwise; ``True``/``False`` force one
    path (``True`` raises when the build fails)."""
    with open(path + ".ids") as f:
        names = [line.strip() for line in f if line.strip()]
    out = {n: [] for n in names}
    # In the reference dump format one particle writes one line to EACH of
    # .int/.real with the SAME log weight (state.cpp:262-267), so when both
    # files exist the weights must be taken from only one of them — extending
    # across files would double the weight vector vs the per-predict value
    # counts (ADVICE r3 medium).
    log_ws: list = []

    def _merge_log_ws(file_lws):
        nonlocal log_ws
        if not log_ws:
            log_ws = list(file_lws)
        elif len(file_lws) != len(log_ws):
            raise ValueError(
                f"posterior dump {path!r}: .int/.real particle counts differ "
                f"({len(log_ws)} vs {len(file_lws)})"
            )

    for kind in ("int", "real"):
        fp = f"{path}.{kind}"
        if not os.path.exists(fp):
            continue
        parsed = (
            _parse_posterior_file_native(fp, as_int=(kind == "int"))
            if native in (None, True)
            else None
        )
        if parsed is not None:
            lws, offsets, ids, values = parsed
            _merge_log_ws(lws.tolist())
            n = len(lws)
            k = len(ids) // n if n else 0
            if n and k * n == len(ids) and np.array_equal(
                ids.reshape(n, k), np.broadcast_to(ids[:k], (n, k))
            ):
                # regular structure (same id pattern every particle): assemble
                # columnarly — no per-particle Python loop
                vals2d = values.reshape(n, k)
                for idx in np.unique(ids[:k]):
                    cols = vals2d[:, ids[:k] == idx]
                    out[names[idx]].extend(
                        cols[:, 0] if cols.shape[1] == 1 else list(cols)
                    )
            else:
                for p in range(n):
                    lo, hi = offsets[p], offsets[p + 1]
                    per_name = {}
                    for idx, value in zip(
                        ids[lo:hi].tolist(), values[lo:hi].tolist()
                    ):
                        per_name.setdefault(idx, []).append(value)
                    for idx, vals in per_name.items():
                        out[names[idx]].append(
                            vals[0] if len(vals) == 1 else vals
                        )
            continue
        if native is True:
            raise RuntimeError(
                f"native posterior parser unavailable for {fp!r}"
            )
        file_lws = []
        with open(fp) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                entries, log_w = parse_value(line)
                file_lws.append(float(log_w))
                per_name = {}
                for idx, value in entries:
                    per_name.setdefault(idx, []).append(value)
                for idx, vals in per_name.items():
                    out[names[idx]].append(vals[0] if len(vals) == 1 else vals)
        _merge_log_ws(file_lws)
    return out, np.asarray(log_ws)


def dump_posterior_npz(path: str, result) -> None:
    """Binary columnar dump for large runs."""
    arrays = {"log_weights": to_host(result.log_weights)}
    for name, vals in result.predicts.items():
        arrays[f"predict::{name}"] = to_host(vals)
    np.savez_compressed(path, **arrays)


def load_posterior_npz(path: str):
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    log_w = data["log_weights"]
    predicts = {
        k.split("::", 1)[1]: data[k] for k in data.files if k.startswith("predict::")
    }
    return predicts, log_w

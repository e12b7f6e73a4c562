"""The program's spans in a traced slice, and the arithmetic the per-layer
readers of them share.

The port marks its layers with ``torch.profiler.record_function`` while a
profiler records (``cpprob_tpu_torch/util/profiling.py``): each span is a
``user_annotation`` host event on the clock of the device's events.
``smc.run`` is one query; inside it lie ``smc.init``, one ``smc.chunk`` or
``smc.step`` a loop body, ``resample.epoch`` and one ``launch.<kernel>`` a
ctypes launch of a port kernel.  A query's spans are those inside its
``smc.run``: the slice has one query in flight.  A checkout whose program
opens no span gives no ``smc.run``, and every reader returns ``None``."""

from __future__ import annotations

import bisect

from . import stats

RUN = "smc.run"
EPOCH = "resample.epoch"
LAUNCH = "launch."


def _interval(event: dict) -> tuple:
    ts = float(event["ts"])
    return ts, ts + float(event["dur"])


class Spans:
    """The ``smc.run``, ``resample.epoch`` and ``launch.*`` intervals of
    ``host`` (a trace's host events), each list in order of start."""

    def __init__(self, host: list):
        marks = [e for e in host if e.get("cat") == "user_annotation"]
        pick = lambda keep: sorted(_interval(e) for e in marks if keep(e["name"]))
        self.runs = pick(lambda n: n == RUN)
        self.epochs = pick(lambda n: n == EPOCH)
        self.launches = pick(lambda n: n.startswith(LAUNCH))

    def _in_runs(self, intervals: list) -> list:
        return [iv for iv in intervals
                if any(a <= iv[0] and iv[1] <= b for a, b in self.runs)]

    def launch_ms(self) -> float:
        """Host ms inside the ``launch.*`` spans of the queries."""
        return sum(b - a for a, b in self._in_runs(self.launches)) * 1e-3

    def epoch_self_ms(self) -> float:
        """Host ms inside the queries' ``resample.epoch`` spans and outside
        the ``launch.*`` spans within them."""
        return sum((b - a) - stats.union_length(self.launches, a, b)
                   for a, b in self._in_runs(self.epochs)) * 1e-3

    def glue_ms(self) -> float:
        """Host ms inside ``smc.run`` spans covered by no ``launch.*`` and no
        ``resample.epoch`` span."""
        marked = self.launches + self.epochs
        return sum((b - a) - stats.union_length(marked, a, b) for a, b in self.runs) * 1e-3

    @staticmethod
    def _holds(intervals: list, t: float) -> bool:
        """Whether one of ``intervals`` (not overlapping, in order of start)
        holds ``t``: only the last one to start before ``t`` can."""
        i = bisect.bisect_right(intervals, (t, float("inf"))) - 1
        return i >= 0 and t <= intervals[i][1]

    def unmarked_launches(self, launches: list) -> int:
        """How many of the launch calls ``launches`` start inside an
        ``smc.run`` span and inside no ``launch.*`` span: the query's own
        glue.  Calls outside every ``smc.run`` are not the program's and
        are not counted."""
        return sum(self._holds(self.runs, t) and not self._holds(self.launches, t)
                   for t in (float(e["ts"]) for e in launches))

    def idle_in_runs_ms(self, device: list) -> float:
        """Ms inside ``smc.run`` spans in which no event of ``device`` ran
        on the card."""
        busy = [_interval(e) for e in device]
        return sum((b - a) - stats.union_length(busy, a, b) for a, b in self.runs) * 1e-3


def per_query(ctx, value):
    """``value(spans)`` over the traced queries, or ``None`` where the
    slice holds no ``smc.run`` span or ``value`` gives ``None``."""
    if ctx.trace is None or not ctx.traced_queries:
        return None
    spans = Spans(ctx.trace.host)
    total = value(spans) if spans.runs else None
    return None if total is None else total / ctx.traced_queries

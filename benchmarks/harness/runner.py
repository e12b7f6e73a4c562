"""One run of one cell: set-up, the measured window of closed-loop
queries, the optional traced slice, the reference check after the window
and the result line."""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np

from . import check, manifest, trace as tracing
from .traffic import WARM_QUERIES, Plan

FORBIDDEN = ("jax", "jaxlib", "flax", "cpprob_tpu")


@dataclasses.dataclass
class Query:
    q: int
    t0: float          # the call to ``run``
    t1: float          # ``run`` returned: the work is enqueued
    t2: float          # log Z-hat read back: the query's end
    log_z: float
    summary: object = None   # final population summary, where sampled
    flags: object = None     # the query's ``resampled`` flags (traced runs)

    @property
    def ms(self) -> float:
        return (self.t2 - self.t0) * 1e3


@dataclasses.dataclass
class RunContext:
    """What a metric reader sees of a run."""

    cell: object
    plan: Plan
    setup_s: float
    window_s: float
    queries: list
    steady: list             # queries a traced run times: after the slice
    trace: object = None     # tracing.Trace of the traced slice
    traced_queries: int = 0
    logz_errors: object = None
    filter_errors: object = None

    @property
    def n(self) -> int:
        return self.plan.n

    @property
    def T(self) -> int:
        return self.plan.T


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its relatives' or the
    JAX package's, compared whole."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


class Loop:
    """The closed loop's client: one query in flight, each ending when its
    log Z-hat is back on the host."""

    def __init__(self, run, pool, plan: Plan, summarize, keep_flags: bool):
        self.run, self.pool, self.plan = run, pool, plan
        self.summarize, self.keep_flags = summarize, keep_flags
        self.clock = time.perf_counter

    def query(self, q: int, sample: bool, annotate=None) -> Query:
        plan = self.plan
        seed, obs = plan.particle_seed(q), self.pool[plan.series(q)]
        t0 = self.clock()
        if annotate is None:
            res = self.run(seed, obs)
            t1 = self.clock()
            log_z = float(res.log_evidence)
        else:
            with annotate("bench.run"):
                res = self.run(seed, obs)
            t1 = self.clock()
            with annotate("bench.read"):
                log_z = float(res.log_evidence)
        t2 = self.clock()
        summary = self.summarize(res).cpu().numpy() if sample else None
        flags = res.resampled if self.keep_flags else None
        return Query(q, t0, t1, t2, log_z, summary, flags)


def run_cell(cell, seed: int, seconds: float, trace: bool, *, t_start: float,
             device: str = "cuda", max_queries: int | None = None, wrap_model=None, wrap_run=None,
             log=lambda msg: None):
    """Set up the cell, run its window and check it.  Returns ``(result,
    checks, ctx)``: the result line's object, the numbers compared and
    what the metric readers saw.  A traced run profiles its first queries,
    then runs ``seconds`` more.  ``wrap_model``, ``wrap_run``: tests break
    the timed path with them; ``log`` takes the set-up's stages."""
    stage = [time.perf_counter()]
    import torch
    from cpprob_tpu_torch import build_smc_run

    def mark(what):
        now = time.perf_counter()
        log(f"setup: {what} {now - stage[0]:.3f} s")
        stage[0] = now

    mark("the port imported")
    plan = Plan(cell.traffic, cell.config, cell.reference, seed)
    model = cell.system.model(cell.traffic)
    if wrap_model is not None:
        model = wrap_model(model)
    run = build_smc_run(model, plan.n, ess_threshold=plan.ess_threshold,
                        chunk=plan.chunk)
    if wrap_run is not None:
        run = wrap_run(run)
    pool = torch.as_tensor(plan.pool, device=device)
    mark("the model built, the pool on the device")
    summarize = lambda res: cell.reference.summarize(
        res.final_states, res.final_log_weights, cell.config)
    loop = Loop(run, pool, plan, summarize, keep_flags=trace)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    for w in range(WARM_QUERIES):
        loop.query(-1 - w, sample=True)
        sync()
        mark(f"warm query {w + 1}")
    setup_s = time.perf_counter() - t_start

    queries, slice_end, tr, traced = [], 0, None, 0
    t_open = time.perf_counter()
    deadline = t_open + seconds
    if trace:
        from torch.profiler import record_function

        def traced_queries(k):
            for _ in range(k):
                queries.append(loop.query(len(queries), sample=False,
                                          annotate=record_function))

        out_file = manifest.BENCH_DIR / "out" / f"trace-{cell.name}.json"
        tr = tracing.traced_slice(traced_queries, plan.trace_queries, out_file)
        traced = plan.trace_queries
        slice_end = len(queries) + 1      # the first query after the slice warms again
        deadline = time.perf_counter() + seconds
    while True:
        q = len(queries)
        queries.append(loop.query(q, sample=q >= slice_end and plan.sampled(q)))
        if queries[-1].t2 >= deadline or len(queries) == max_queries:
            break
    window_s = queries[-1].t2 - t_open
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    flags = [int(torch.as_tensor(qr.flags).sum()) if qr.flags is not None else None
             for qr in queries]
    del run, model, loop, pool
    for qr, f in zip(queries, flags):
        qr.flags = f

    bad = forbidden_modules()
    if bad:
        raise RuntimeError(f"modules of JAX or the JAX package loaded: {bad}")

    # the reference, once the window has closed and the program's state is freed
    exact_logz, exact_filter = cell.reference.exact(plan.pool, cell.config)
    est = np.array([qr.log_z for qr in queries])
    series = np.array([plan.series(qr.q) for qr in queries])
    finite = np.isfinite(est)
    errors = est[finite] - exact_logz[series[finite]]
    filter_errors = [cell.reference.filter_error(qr.summary, exact_filter[plan.series(qr.q)])
                     for qr in queries if qr.summary is not None]
    values = check.numbers(plan.n, errors, filter_errors)
    correct, checks = check.judge(values, cell.limits, int((~finite).sum()))

    ctx = RunContext(cell, plan, setup_s, window_s, queries,
                     steady=queries[slice_end:] if trace else queries,
                     trace=tr, traced_queries=traced, logz_errors=errors,
                     filter_errors=filter_errors)
    metrics = {}
    for m in cell.manifest.metrics(cell.name, trace):
        value = cell.manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    result = {"correct": bool(correct), "attempted": len(queries),
              "failed": int((~finite).sum()), "metrics": metrics,
              "device": {"platform": "gpu" if device == "cuda" else device,
                         "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
                         "count": cell.chips, "memory_peak_bytes": int(memory_peak)}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s()
        result["device"]["window_s"] = tr.window_s()
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = checks
    return result, checks, ctx

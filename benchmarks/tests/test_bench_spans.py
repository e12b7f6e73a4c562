"""The readers of the program's spans on a hand-made profiler trace of two
queries: self time with nested children, the card's idle time inside and
outside ``smc.run``, launch calls inside and outside ``launch.*`` spans,
and nothing read from a trace without the spans."""

import pytest

from harness import manifest, spans
from harness import trace as tracing

M = manifest.Manifest()
READERS = ("launch_host_ms", "epoch_host_ms", "glue_host_ms", "glue_launches_per_query",
           "enqueue_idle_ms")


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _launch(ts, corr):
    return _ev("cuda_runtime", "cudaLaunchKernel", ts, 1.0, corr)


EVENTS = [
    _ev("user_annotation", tracing.WINDOW, 0.0, 1000.0),
    # query 1: a chunk holding an epoch (two launches) and the chunk kernel
    _ev("user_annotation", "bench.run", 10.0, 400.0),
    _ev("user_annotation", "smc.run", 20.0, 380.0),
    _ev("user_annotation", "smc.chunk", 50.0, 250.0),
    _ev("user_annotation", "resample.epoch", 60.0, 100.0),
    _ev("user_annotation", "launch.lse_stats_kernel", 70.0, 10.0),
    _ev("user_annotation", "launch.pass1_scan_kernel", 100.0, 10.0),
    _ev("user_annotation", "launch.lg_chunk_kernel", 200.0, 30.0),
    _ev("cpu_op", "aten::where", 240.0, 20.0),
    _launch(72.0, 1), _launch(101.0, 2), _launch(205.0, 3),     # in launch.* spans
    _launch(40.0, 4), _launch(250.0, 5),                        # the glue's
    _ev("kernel", "lse_stats_kernel", 80.0, 70.0, 1),
    _ev("kernel", "lg_chunk_kernel", 230.0, 160.0, 3),
    # between the queries: a launch and device work outside any smc.run
    _launch(450.0, 6),
    _ev("kernel", "fill_kernel", 420.0, 30.0, 6),
    # query 2: the init kernel alone
    _ev("user_annotation", "bench.run", 500.0, 400.0),
    _ev("user_annotation", "smc.run", 510.0, 380.0),
    _ev("user_annotation", "smc.init", 515.0, 15.0),
    _ev("user_annotation", "launch.hmm_init_kernel", 518.0, 7.0),
    _launch(519.0, 7),
    _ev("kernel", "hmm_init_kernel<3>", 600.0, 200.0, 7),
]


class Ctx:
    def __init__(self, events, queries=2):
        self.trace = tracing.Trace(events)
        self.traced_queries = queries


def test_spans_grouped_by_name_and_containment():
    s = spans.Spans(tracing.Trace(EVENTS).host)
    assert s.runs == [(20.0, 400.0), (510.0, 890.0)]
    assert s.epochs == [(60.0, 160.0)]
    assert len(s.launches) == 4


def test_readers_on_a_hand_made_trace():
    ctx = Ctx(EVENTS)
    got = {name: M.reader(name)(ctx) for name in READERS}
    # launch spans: 10 + 10 + 30 us in query 1, 7 in query 2
    assert got["launch_host_ms"] == pytest.approx(57e-3 / 2)
    # the epoch's 100 us less its two 10 us launch children
    assert got["epoch_host_ms"] == pytest.approx(80e-3 / 2)
    # query 1: 380 - (the epoch 100 + the chunk launch 30); query 2: 380 - 7
    assert got["glue_host_ms"] == pytest.approx((250 + 373) * 1e-3 / 2)
    # self times and the glue make up the mean smc.run, exactly
    assert (got["launch_host_ms"] + got["epoch_host_ms"] + got["glue_host_ms"]
            == pytest.approx(380e-3))
    # of seven launch calls, four start in launch.* spans, two in query 1's
    # glue and one between the queries, in no smc.run: not the program's
    assert got["glue_launches_per_query"] == pytest.approx(2 / 2)
    assert got["glue_launches_per_query"] + (4 + 1) / 2 == M.reader("launches_per_query")(ctx)
    # idle inside the runs: [20, 80] + [150, 230] + [390, 400] and
    # [510, 600] + [800, 890]; the idle [400, 420] and [450, 510] lie outside
    assert got["enqueue_idle_ms"] == pytest.approx((150 + 180) * 1e-3 / 2)


def test_no_epoch_no_epoch_time():
    events = [e for e in EVENTS if e["name"] != "resample.epoch"]
    assert M.reader("epoch_host_ms")(Ctx(events)) is None
    # without the epoch its two launches stand alone: 380 - 50 in query 1
    assert M.reader("glue_host_ms")(Ctx(events)) == pytest.approx((330 + 373) * 1e-3 / 2)


@pytest.mark.parametrize("name", READERS)
def test_a_program_without_spans_reads_nothing(name):
    # the parent's trace: the harness's annotations and the card's work only
    bare = [e for e in EVENTS if e["cat"] != "user_annotation"
            or e["name"] in (tracing.WINDOW, "bench.run")]
    assert M.reader(name)(Ctx(bare)) is None
    untraced = Ctx(EVENTS)
    untraced.trace = None
    assert M.reader(name)(untraced) is None

"""The trace reader on a hand-made profiler trace: the window, the launch
calls, the device's busy time, the kernels by name and the idle gaps."""

import pytest

from harness import trace as tracing


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _ev("kernel", "warm_kernel", 5.0, 1.0, 1),                       # before the window
    _ev("user_annotation", tracing.WINDOW, 10.0, 100.0),
    _ev("user_annotation", "bench.run", 12.0, 30.0),
    _ev("cpu_op", "aten::where", 40.0, 5.0),
    _ev("cuda_runtime", "cudaLaunchKernel", 13.0, 2.0, 2),
    _ev("cuda_runtime", "cudaLaunchKernelExC", 20.0, 2.0, 3),
    _ev("cuda_runtime", "cudaMemcpyAsync", 60.0, 30.0, 4),
    _ev("kernel", "void (anonymous namespace)::hmm_chunk_kernel<3>(float const*, int)", 15.0, 20.0, 2),
    _ev("kernel", "lse_stats_kernel(double*)", 30.0, 10.0, 3),       # overlaps the first
    _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 80.0, 2.0, 4),
    _ev("gpu_user_annotation", "bench.run", 15.0, 60.0),             # not an operation
]


def test_window_launches_and_busy_time():
    t = tracing.Trace(EVENTS)
    assert (t.lo, t.hi) == (10.0, 110.0)
    assert len(t.launches) == 2 and t.complete
    # busy: [15, 40] and [80, 82] of [10, 110]
    assert t.busy_s() == pytest.approx(27e-6)
    assert t.window_s() == pytest.approx(100e-6)
    assert t.kernel_s("hmm_chunk_kernel") == pytest.approx(20e-6)
    assert t.kernel_s("lse_stats_kernel", "pass1_scan_kernel") == pytest.approx(10e-6)


def test_breakdown():
    t = tracing.Trace(EVENTS)
    ops = t.device_ops()
    assert ops[0] == ["hmm_chunk_kernel<3>", pytest.approx(20e-6)]
    assert [o[0] for o in ops] == ["hmm_chunk_kernel<3>", "lse_stats_kernel",
                                   "Memcpy DtoH"]
    # idle: [40, 80] (its middle in the memcpy call), [82, 110] (under no
    # host event), [10, 15] (under bench.run), longest first
    assert t.idle_gaps() == [["cudaMemcpyAsync", pytest.approx(40e-6)],
                             ["host: outside any operator", pytest.approx(28e-6)],
                             ["bench.run", pytest.approx(5e-6)]]


def test_a_partial_window_is_not_complete():
    events = [e for e in EVENTS if e["cat"] != "kernel"]
    assert not tracing.Trace(events).complete


def test_short_names():
    assert tracing.short_name("void (anonymous namespace)::lg_chunk_kernel(float const*, int)") == "lg_chunk_kernel"
    assert tracing.short_name("void at::native::reduce_kernel<512, 1>(at::native::R<(int)1>)") == "at::native::reduce_kernel<512, 1>"

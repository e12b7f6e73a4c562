"""The port's spans and counters (``cpprob_tpu_torch/util/profiling.py``)
on the CPU: the shared no-op while no profiler records, the spans of a
``build_smc_run`` sweep nested as the layers are in a ``profile_trace``
export, and the one registry of the launch and host-read counters."""

import dataclasses
import json

import pytest
import torch

from cpprob_tpu_torch import build_smc_run
from cpprob_tpu_torch.distributions import base
from cpprob_tpu_torch.models.linear_gaussian import (
    linear_gaussian_ssm,
    simulate_observations,
)
from cpprob_tpu_torch.ops import (
    calibrate,
    fused_hmm,
    fused_lg,
    guided_scalar,
    guided_tc,
    stream_resample,
    user_chunk,
)
from cpprob_tpu_torch.util import profiling

N, T = 256, 6

# the linear-Gaussian model with its per-particle hooks alone: every draw
# and density runs under torch.func.vmap
per_particle_lg = dataclasses.replace(
    linear_gaussian_ssm, init_sample_batch=None, step_sample_batch=None,
    obs_logpdf_batch=None)


def _observations():
    return torch.as_tensor(simulate_observations(T, 0))


def _refuse(name, *args, **kwargs):
    raise AssertionError(f"record_function({name!r}) entered with no profiler")


def test_span_is_the_shared_noop_without_a_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    first = profiling.span("smc.run")
    assert first is profiling.span("resample.epoch")
    with profiling.span("smc.step") as inside:
        assert inside is None
    # a whole sweep, every span of its path passed through
    res = build_smc_run(linear_gaussian_ssm, N)(0, _observations())
    assert torch.isfinite(res.log_evidence)


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
            for e in events if e.get("cat") == "user_annotation"]


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


@pytest.mark.parametrize("model", [linear_gaussian_ssm, per_particle_lg],
                         ids=["batched", "per-particle-vmap"])
def test_a_sweep_exports_nested_spans(tmp_path, model):
    run = build_smc_run(model, N)
    obs = _observations()
    with profiling.profile_trace(str(tmp_path)):
        for seed in range(2):
            run(seed, obs)
    spans = _spans(tmp_path / "trace.json")
    by_name = {}
    for s in spans:
        by_name.setdefault(s[0], []).append(s)
    runs = by_name["smc.run"]
    assert len(runs) == 2
    assert len(by_name["smc.init"]) == 2
    assert len(by_name["smc.step"]) == 2 * (T - 1)
    # the scalar population resamples by value: one epoch a step
    assert len(by_name["resample.epoch"]) == 2 * (T - 1)
    assert "smc.chunk" not in by_name
    for s in by_name["smc.init"] + by_name["smc.step"]:
        assert sum(_inside(s, r) for r in runs) == 1, s
    for e in by_name["resample.epoch"]:
        assert sum(_inside(e, s) for s in by_name["smc.step"]) == 1, e
    # no other span of the port: none opened inside the mapped functions
    assert set(by_name) <= {"smc.run", "smc.init", "smc.step", "resample.epoch"}


def test_a_chunked_sweep_opens_a_chunk_span_a_chunk(tmp_path):
    from cpprob_tpu_torch.ops.fused_lg import make_fused_lg_ssm

    with profiling.profile_trace(str(tmp_path)):
        build_smc_run(make_fused_lg_ssm(), N, chunk=2)(0, _observations())
    names = [s[0] for s in _spans(tmp_path / "trace.json")]
    # T - 1 = 5 updates in chunks of 2: three chunks, an epoch each
    assert names.count("smc.chunk") == 3 == names.count("resample.epoch")
    assert names.count("smc.run") == 1 == names.count("smc.init")


def test_counters_see_every_group():
    groups = {"fused_hmm": fused_hmm.LAUNCHES, "fused_lg": fused_lg.LAUNCHES,
              "stream_resample": stream_resample.LAUNCHES,
              "user_chunk": user_chunk.LAUNCHES,
              "guided_scalar": guided_scalar.LAUNCHES,
              "guided_tc": guided_tc.LAUNCHES, "calibrate": calibrate.LAUNCHES,
              "host_reads": base.HOST_READS}
    snap = profiling.counters()
    for name, group in groups.items():
        # the module's dict is the registered one, under its own keys
        assert profiling.counter_group(name, tuple(group)) is group
        for key, value in group.items():
            assert snap[f"{name}.{key}"] == value
    base.HOST_READS["nuts"] += 1
    try:
        assert profiling.counters()["host_reads.nuts"] == snap["host_reads.nuts"] + 1
    finally:
        base.HOST_READS["nuts"] -= 1

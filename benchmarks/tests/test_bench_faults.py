"""A run with the timed path broken underneath reads not correct: the
whole run (set-up, the window of queries, the reference check) on the
CPU, where the port's kernels run their plain versions, at a population
the CPU holds, with the limits of the cell as they stand.  The faults a
one-chip SMC cell can have: a step that returns its population's states
unchanged; half of the population left out, the estimate taken over the
rest; one answer altered where it is produced.  The sound run at that size
reads correct, so each fault's reading is the fault's."""

import dataclasses
import time

import pytest
import torch

from harness import manifest, runner

M = manifest.Manifest()
N = 1 << 14
QUERIES = 192
SEED = 2**33 + 17

HOOKS = ("fused_chunk_exchange_t_batch", "fused_step_exchange_batch",
         "fused_chunk_t_batch", "fused_step_batch", "fused_step_ess_batch")


def _cell(workload):
    cell = M.cell(workload)
    cell.traffic = dict(cell.traffic, particles=N, filter_every=4)
    return cell


def frozen_states(model):
    """Every step and chunk hook returns the states it was given."""
    def freeze(hook):
        return lambda key, states, *rest: (states, *hook(key, states, *rest)[1:])

    return dataclasses.replace(model, **{h: freeze(getattr(model, h)) for h in HOOKS
                                         if getattr(model, h) is not None})


def _half_population(cell):
    from cpprob_tpu_torch import build_smc_run

    half = build_smc_run(cell.system.model(cell.traffic), N // 2,
                         ess_threshold=cell.traffic["ess_threshold"],
                         chunk=cell.traffic["chunk"])

    def wrap(run):
        def call(seed, obs):
            r = half(seed, obs)
            return r._replace(final_states=torch.cat([r.final_states] * 2),
                              final_log_weights=torch.cat([r.final_log_weights] * 2))
        return call
    return wrap


def altered_answer(run):
    """The fifth query after the warm-up answers the log-evidence negated."""
    calls = []

    def call(seed, obs):
        r = run(seed, obs)
        calls.append(seed)
        return r._replace(log_evidence=-r.log_evidence) if len(calls) == 7 else r
    return call


def _run(cell, **wrap):
    torch.manual_seed(0)
    result, checks, _ = runner.run_cell(cell, SEED, 1e9, False, t_start=time.perf_counter(),
                                     device="cpu", max_queries=QUERIES, **wrap)
    assert result["attempted"] == QUERIES
    return result["correct"], checks


@pytest.mark.parametrize("workload", sorted(M.workloads))
def test_the_sound_run_reads_correct(workload):
    correct, checks = _run(_cell(workload))
    assert correct, checks


@pytest.mark.parametrize("fault", ["frozen_states", "half_population", "altered_answer"])
@pytest.mark.parametrize("workload", sorted(M.workloads))
def test_a_broken_timed_path_reads_not_correct(workload, fault):
    cell = _cell(workload)
    wrap = {"frozen_states": {"wrap_model": frozen_states},
            "half_population": {"wrap_run": _half_population(cell)},
            "altered_answer": {"wrap_run": altered_answer}}[fault]
    correct, checks = _run(cell, **wrap)
    assert not correct, checks

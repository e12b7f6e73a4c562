"""The captured query of ``build_smc_run`` (``cpprob_tpu_torch.inference.smc``):
which path and model a card captures, the device key every keyed wrapper
and its plain version take, the one generator a ``run`` reuses, and, on
the card, the replayed query against the eager one, bit for bit.

On the CPU nothing is captured: the CPU tests hold the decision, the
plain versions given a device key, and the run's generator.  The
``cuda``-marked tests run the four benchmark cells' models at 2^16
particles on the card.
"""

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cpprob_tpu_torch import build_smc_run
from cpprob_tpu_torch.examples.kernel_bench import lg_step_elem
from cpprob_tpu_torch.interop import mlp_params_from_numpy, spec_from_numpy
from cpprob_tpu_torch.models import hmm_ssm
from cpprob_tpu_torch.models import simulate_observations as hmm_observations
from cpprob_tpu_torch.models.hmm import HMM_MEANS, HMM_TRANS
from cpprob_tpu_torch.models.linear_gaussian import (
    iapf_transition,
    linear_gaussian_nd_ssm,
    linear_gaussian_ssm,
    nd_step_elem,
    obs_logpdf_elem,
    simulate_observations,
    simulate_observations_nd,
    trans_logpdf_elem,
)
from cpprob_tpu_torch.ops import fused_hmm, fused_lg
from cpprob_tpu_torch.ops.fused_hmm import make_fused_hmm_ssm
from cpprob_tpu_torch.ops.fused_lg import make_fused_lg_ssm
from cpprob_tpu_torch.ops.fused_ssm import (
    attach_fused_guided_scalar_kernels,
    attach_fused_scalar_kernels,
)
from cpprob_tpu_torch.ops.philox import device_key, launch_key, split_seed
from cpprob_tpu_torch.ops.user_chunk import UserKernel
from cpprob_tpu_torch.ops.population import (owned_scratch, stream_scratch,
                                             takes_device_key)
from cpprob_tpu_torch.util.profiling import (add_counts, counter_group, counters,
                                             recorded_counts)

port_smc = importlib.import_module("cpprob_tpu_torch.inference.smc")

NET_FILE = Path(__file__).resolve().parents[1] / "benchmarks" / "configs" / "guided_lg_net.json"
# seeds whose key words are small, use the top bit of a word, and fill both
SEEDS = (0, 7, 2 ** 31 + 5, 2 ** 64 - 3, 0x9E3779B97F4A7C15)


def _net(scale: float = 0.1, width: int = 8):
    g = torch.Generator().manual_seed(0)
    return [{"w": scale * torch.randn(3, width, generator=g), "b": torch.zeros(width)},
            {"w": scale * torch.randn(width, width, generator=g), "b": torch.zeros(width)},
            {"w": scale * torch.randn(width, 2, generator=g), "b": torch.zeros(2)}]


def _guided_lg(mxu: bool = True, net=None, device="cpu", base=None):
    net = _net() if net is None else net
    net = [{k: v.to(device) for k, v in layer.items()} for layer in net]
    return attach_fused_guided_scalar_kernels(
        make_fused_lg_ssm() if base is None else base, net, 16,
        trans_logpdf_elem=trans_logpdf_elem, obs_logpdf_elem=obs_logpdf_elem, mxu=mxu)


def _committed_guided_lg(device):
    """The benchmark's guided model: the committed [3,64,64,2] net."""
    with open(NET_FILE) as f:
        layers = json.load(f)["layers"]
    params = mlp_params_from_numpy(
        [{"w": np.asarray(layer["w"], np.float32), "b": np.asarray(layer["b"], np.float32)}
         for layer in layers], device=device)
    return attach_fused_guided_scalar_kernels(
        linear_gaussian_ssm, params, 16, trans_logpdf_elem=trans_logpdf_elem,
        obs_logpdf_elem=obs_logpdf_elem)


def _stub(**hooks):
    out = (torch.zeros(4), torch.zeros(4), torch.ones((), dtype=torch.float64))
    return dataclasses.replace(linear_gaussian_ssm, **{
        name: (takes_device_key(lambda *a: out) if marked else (lambda *a: out))
        for name, marked in hooks.items()})


CASES = {
    "hmm3 chunk16 island8": (lambda: make_fused_hmm_ssm(island_every=8), 16,
                             "chunk_exchange", True),
    "hmm3 island counts": (lambda: make_fused_hmm_ssm(island_every=8, island_counts=[]),
                           16, "chunk_exchange", False),
    "hmm3 per step": (make_fused_hmm_ssm, 1, "step_exchange", True),
    "hmm (no kernels)": (lambda: hmm_ssm, 1, "step", False),
    "lg chunk8": (make_fused_lg_ssm, 8, "chunk_value", True),
    "lg per step": (make_fused_lg_ssm, 1, "step_ctrl", True),
    "K10 chunk8": (lambda: attach_fused_scalar_kernels(make_fused_lg_ssm(), lg_step_elem),
                   8, "chunk_value", False),
    "K11 d=10 per step": (lambda: linear_gaussian_nd_ssm(iapf_transition(10)), 1,
                          "step_ctrl", True),
    "K11 d=10 chunk4": (lambda: linear_gaussian_nd_ssm(iapf_transition(10)), 4,
                        "chunk_value", True),
    "K12 twin chunk8": (_guided_lg, 8, "chunk_value", True),
    "K12 FMA chunk8": (lambda: _guided_lg(mxu=False), 8, "chunk_value", False),
    "K13 chunk8": (lambda: dataclasses.replace(
        _guided_hmm(), fused_hooks_guided=True), 8, "chunk_exchange", False),
    "stub: chunk and start keyed": (lambda: _stub(fused_chunk_t_batch=True,
                                                  fused_init_ctrl_batch=True),
                                    8, "chunk_value", True),
    "stub: start not keyed": (lambda: _stub(fused_chunk_t_batch=True,
                                            fused_init_ctrl_batch=False),
                              8, "chunk_value", False),
    "stub: chunk without time": (lambda: _stub(fused_chunk_batch=True), 8,
                                 "chunk_value", False),
    "stub: prior start, chunk keyed": (lambda: _stub(fused_chunk_t_batch=True), 8,
                                       "chunk_value", True),
    "stub: step hook not keyed": (lambda: _stub(fused_step_ctrl_batch=False), 1,
                                  "step_ctrl", False),
    "stub: prior start, a user's draw": (lambda: _stub(fused_chunk_t_batch=True,
                                                       init_sample_batch=False),
                                         8, "chunk_value", False),
    "stub: prior start, a user's density": (lambda: _stub(fused_chunk_t_batch=True,
                                                          obs_logpdf_batch=False),
                                            8, "chunk_value", False),
    "stub: start from a user's proposal": (lambda: _stub(
        fused_chunk_t_batch=True, init_proposal_sample=False,
        init_proposal_logpdf=True, init_logpdf=True), 8, "chunk_value", False),
    "stub: start from a keyed proposal": (lambda: _stub(
        fused_chunk_t_batch=True, init_proposal_sample=True,
        init_proposal_logpdf=True, init_logpdf=True), 8, "chunk_value", True),
    "K12 twin over a user's base model": (lambda: _guided_lg(base=_stub(
        init_sample_batch=False)), 8, "chunk_value", False),
}


def _guided_hmm():
    """A guided 3-state HMM on K13 (whose hooks take no device key)."""
    from cpprob_tpu_torch.ops.fused_ssm import attach_fused_guided_discrete_kernels

    trans = np.array([[0.8, 0.1, 0.1], [0.1, 0.8, 0.1], [0.1, 0.1, 0.8]])
    g = torch.Generator().manual_seed(0)
    params = [{"w": 0.1 * torch.randn(3 + 2, 8, generator=g), "b": torch.zeros(8)},
              {"w": 0.1 * torch.randn(8, 3, generator=g), "b": torch.zeros(3)}]
    return attach_fused_guided_discrete_kernels(trans, np.array([-1.0, 0.0, 1.0]),
                                                params=params, T=16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_capture_decision(case):
    """A path is captured (``keyed``) only where it is a fast path and every
    hook it calls declares a device key: the four keyed kernel families
    (the HMM chain, the LG kernel, K12's tensor-core twin, K11 with its
    one-step launch) do, K10, K12 on the FMA pipe and K13 do not, nor a model whose hooks append to a host
    list, nor a chunk hook without time (its seed a chunk is made on the
    host); a start from the prior is keyed where its hooks are (the
    built-in models' are), and not where a user's hook draws or scores
    it."""
    build, chunk, name, keyed = CASES[case]
    path = port_smc._sweep_path(build(), 4096, 0.5, "systematic", False, chunk)
    assert (path.name, path.keyed) == (name, keyed)
    history = port_smc._sweep_path(build(), 4096, 0.5, "systematic", True, 1)
    assert (history.name, history.keyed) == ("step", False)


def test_cpu_run_is_never_captured():
    """On the CPU a keyed path runs eagerly and counts nothing."""
    before = counters()
    run = build_smc_run(make_fused_lg_ssm(), 1 << 12, chunk=8)
    obs = torch.as_tensor(simulate_observations(16, 0))
    for seed in range(3):
        run(seed, obs)
    assert {k: v - before.get(k, 0) for k, v in counters().items()
            if k.startswith("sweep_graph")} == {
        "sweep_graph.capture": 0, "sweep_graph.replay": 0, "sweep_graph.eager": 0}


@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_words(seed):
    """A device key holds the seed's two key words, read back on the host
    whatever their top bits; a launch takes it as the address of its words,
    and refuses another dtype or a key on another device."""
    key = device_key(seed, "cpu")
    assert key.dtype == torch.int32 and key.shape == (2,)
    assert split_seed(key) == split_seed(seed)
    assert launch_key(key, "cpu") == key.data_ptr()
    with pytest.raises(ValueError):
        launch_key(key.to(torch.int64), "cpu")
    with pytest.raises(ValueError):
        launch_key(key, "meta")


def _population(n, seed, discrete=False):
    g = torch.Generator().manual_seed(seed)
    s = (torch.randint(0, 3, (n,), generator=g, dtype=torch.int32) if discrete
         else torch.randn(n, generator=g))
    return s, torch.randn(n, generator=g)


def _wrapper_calls(device="cpu"):
    """Each keyed wrapper's call on tensors on ``device`` (on the CPU its
    plain version), as a function of the seed."""
    n = 8192
    ys = torch.as_tensor(simulate_observations(16, 3), device=device)
    x, w = (t.to(device) for t in _population(n, 1))
    s, sw = (t.to(device) for t in _population(n, 2, discrete=True))
    flag = torch.ones((), dtype=torch.int32, device=device)
    hspec = spec_from_numpy(HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3))
    ctrl = torch.tensor([1, 3000, 6000, 9], dtype=torch.int32, device=device)
    twin = _guided_lg(device=device).fused_chunk_t_batch.kernel
    nv = torch.tensor(5, dtype=torch.int32, device=device)
    A = iapf_transition(4)
    k11 = UserKernel(nd_step_elem(A), 4, 4)
    xv = torch.randn(n, 4, generator=torch.Generator().manual_seed(4)).to(device)
    yv = torch.as_tensor(simulate_observations_nd(A, 9, 3), device=device)
    return {
        "lg_chunk": lambda k: fused_lg.lg_chunk(k, x, w, ys[1:9], nv, t0=3),
        "lg_step_ctrl": lambda k: fused_lg.lg_step_ctrl(k, x, w, ys[4], 4, flag, n / 2),
        "lg_init": lambda k: fused_lg.lg_init(k, n, ys[0], n / 2),
        "hmm_init": lambda k: fused_hmm.hmm_init(k, ys[0], n, hspec),
        "hmm_chunk": lambda k: fused_hmm.hmm_chunk(k, s, sw, ys[1:10], ctrl, hspec, t0=2,
                                                   island_every=4),
        "guided_tc": lambda k: twin.chunk(k, x, w, ys[1:9], nv, t0=1),
        "user_chunk": lambda k: k11.chunk(k, xv, w, yv[1:9], nv, t0=3),
        "user_step_ctrl": lambda k: k11.step_ctrl(k, xv, w, yv[4], 4, flag, n / 2),
    }


@pytest.mark.parametrize("seed", SEEDS[1:4])
@pytest.mark.parametrize("wrapper", ["lg_chunk", "lg_step_ctrl", "lg_init", "hmm_init",
                                     "hmm_chunk", "guided_tc", "user_chunk",
                                     "user_step_ctrl"])
def test_plain_versions_take_a_device_key(wrapper, seed):
    """Each keyed wrapper's plain version given the key as a 2-word int32
    tensor draws exactly what it draws given the integer seed."""
    call = _wrapper_calls()[wrapper]
    by_int, by_key = call(seed), call(device_key(seed, "cpu"))
    assert len(by_int) == len(by_key)
    for a, b in zip(by_int, by_key):
        assert torch.equal(a, b)
    other = call(seed + 1)
    assert not torch.equal(other[0], by_int[0]) or not torch.equal(other[1], by_int[1])


def test_run_reuses_one_generator():
    """``run`` draws from one generator a device, seeded at each call, and
    gives what a fresh run (a fresh generator) gives at each call."""
    seen = []

    def init_sample_batch(gen, n):
        seen.append(gen)
        return linear_gaussian_ssm.init_sample_batch(gen, n)

    model = dataclasses.replace(make_fused_lg_ssm(), fused_init_ctrl_batch=None,
                                init_sample_batch=init_sample_batch)
    obs = torch.as_tensor(simulate_observations(16, 1))
    run = build_smc_run(model, 1 << 12, chunk=8)
    reused = [run(seed, obs) for seed in (3, 4, 3)]
    assert len(seen) == 3 and seen[0] is seen[1] is seen[2]
    for seed, res in zip((3, 4, 3), reused):
        fresh = build_smc_run(model, 1 << 12, chunk=8)(seed, obs)
        assert torch.equal(res.log_evidence, fresh.log_evidence)
        assert torch.equal(res.final_states, fresh.final_states)
        assert torch.equal(res.resampled, fresh.resampled)
    assert torch.equal(reused[0].final_log_weights, reused[2].final_log_weights)
    assert not torch.equal(reused[0].final_states, reused[1].final_states)


def test_recorded_counts_take_back_and_add_again():
    """What a block adds to the counters is recorded and taken back;
    ``add_counts`` adds it again."""
    group = counter_group("test_sweep_graph", ("a", "b"))
    group["a"] = 5
    with recorded_counts() as added:
        group["a"] += 3
        group["b"] += 1
    assert added == {("test_sweep_graph", "a"): 3, ("test_sweep_graph", "b"): 1}
    assert (group["a"], group["b"]) == (5, 0)
    add_counts(added)
    add_counts(added)
    assert (group["a"], group["b"]) == (11, 2)


def test_owned_scratch_is_the_owners_own():
    """While a graph is captured its kernels' per-stream scratch lives in
    its own tables, held by the owner; outside, in the modules' tables."""
    table = {}
    assert stream_scratch(table) is table
    with owned_scratch() as first:
        mine = stream_scratch(table)
        mine["x"] = 1
        with owned_scratch() as second:
            assert stream_scratch(table) == {}
        assert stream_scratch(table) is mine
    assert table == {} and first == {id(table): {"x": 1}} and second == {id(table): {}}


# ---------------------------------------------------------------------------
# on the card


def _card_models():
    dev = torch.device("cuda")
    return {
        "hmm3-chunk16-island8": (lambda: make_fused_hmm_ssm(island_every=8), 16,
                                 lambda s: hmm_observations(16, s)),
        "lg1d-chunk8": (make_fused_lg_ssm, 8, lambda s: simulate_observations(16, s)),
        "lg1d-perstep": (make_fused_lg_ssm, 1, lambda s: simulate_observations(16, s)),
        "guided-lg-chunk8": (lambda: _committed_guided_lg(dev), 8,
                             lambda s: simulate_observations(16, s)),
    }


def _kept(res):
    return [t.clone() for t in (res.final_states, res.final_log_weights,
                                res.log_evidence, res.resampled)]


def _moved(before):
    return {k: v - before.get(k, 0) for k, v in counters().items()
            if v != before.get(k, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["hmm3-chunk16-island8", "lg1d-chunk8", "lg1d-perstep",
                                  "guided-lg-chunk8"])
def test_captured_query_equals_eager_on_card(cell):
    """The four cells' models at 2^16 particles, T = 16: the first call runs
    eagerly, the second captures, every later one replays; each replayed
    query equals the eager query of the same seed and series bit for bit
    (three seeds, two series, the replays' seeds all different); an
    earlier call's evidence and flags stay as they were; ``sweep_graph``
    counts one capture, then replays; a replay counts each kernel as the
    eager query does; a replay raises nothing under sync-debug "error";
    the graph's scratch is its own."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    build, chunk, series = _card_models()[cell]
    dev = torch.device("cuda")
    n = 1 << 16
    model = build()
    obs = [torch.as_tensor(series(s), dtype=torch.float32, device=dev) for s in (11, 12)]
    run = build_smc_run(model, n, chunk=chunk)
    graph_counts = counter_group("sweep_graph", ("capture", "replay", "eager"))
    start = dict(graph_counts)
    run(999, obs[0])                                    # eager: the warm-up
    assert graph_counts["eager"] == start["eager"] + 1
    tickets_before = set(fused_lg._TICKETS)
    earlier, earlier_kept, eager_moves, replay_moves = None, None, [], []
    for seed in (5, 2 ** 40 + 17, 2 ** 63 + 9):
        for y in obs:
            before = counters()
            eager_res = build_smc_run(model, n, chunk=chunk)(seed, y)
            eager = _kept(eager_res)
            torch.cuda.synchronize()
            eager_moves.append(_moved(before))
            before = counters()
            res = run(seed, y)
            torch.cuda.synchronize()
            replay_moves.append(_moved(before))
            got = _kept(res)
            for a, b in zip(got, eager):
                assert torch.equal(a, b), cell
            if earlier is not None:
                assert torch.equal(earlier.log_evidence, earlier_kept[0])
                assert torch.equal(earlier.resampled, earlier_kept[1])
            earlier, earlier_kept = res, [got[2], got[3]]
    assert graph_counts["capture"] == start["capture"] + 1
    assert graph_counts["replay"] == start["replay"] + 6
    for eager_moved, replay_moved in zip(eager_moves, replay_moves):
        kernels = {k: v for k, v in eager_moved.items() if not k.startswith("sweep_graph")}
        assert kernels and {k: replay_moved.get(k) for k in kernels} == kernels
        assert {k for k in replay_moved if not k.startswith("sweep_graph")} == set(kernels)
    # the scratch the capture made is the graph's, not the module's
    assert set(fused_lg._TICKETS) == tickets_before
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = run(31, obs[1])
        got = _kept(res)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    eager = _kept(build_smc_run(model, n, chunk=chunk)(31, obs[1]))
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert graph_counts["replay"] == start["replay"] + 7


@pytest.mark.cuda
def test_no_capture_under_sync_debug_on_card():
    """A call that sync-debug "error" guards never captures: it runs
    eagerly, its result the eager one, and a later unguarded call
    captures."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    obs = torch.as_tensor(simulate_observations(16, 4), device=dev)
    run = build_smc_run(make_fused_lg_ssm(), 1 << 16, chunk=8)
    graph_counts = counter_group("sweep_graph", ("capture", "replay", "eager"))
    start = dict(graph_counts)
    torch.cuda.set_sync_debug_mode("error")
    try:
        guarded = [_kept(run(s, obs)) for s in (1, 2)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert graph_counts["eager"] == start["eager"] + 2
    assert graph_counts["capture"] == start["capture"]
    replayed = _kept(run(2, obs))
    assert graph_counts["capture"] == start["capture"] + 1
    assert all(torch.equal(a, b) for a, b in zip(replayed, guarded[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["lg_chunk", "lg_step_ctrl", "lg_init", "hmm_init",
                                     "hmm_chunk", "guided_tc", "user_chunk",
                                     "user_step_ctrl"])
def test_wrappers_take_a_device_key_on_card(wrapper):
    """Each keyed wrapper's kernel draws the same given the seed as an
    integer (written into the stream's own key) and as a device key, bit
    for bit, for seeds that fill both words; an integer seed under capture
    raises, a device key does not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    call = _wrapper_calls(dev)[wrapper]
    for seed in SEEDS[1:4]:
        by_int, by_key = call(seed), call(device_key(seed, dev))
        for a, b in zip(by_int, by_key):
            assert torch.equal(a, b), (wrapper, seed)
    key = device_key(SEEDS[2], dev)
    call(key)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="integer seed"):
        with torch.cuda.graph(graph):
            call(SEEDS[2])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(key)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(out, call(SEEDS[2])):
        assert torch.equal(a, b), wrapper


@pytest.mark.cuda
def test_one_graph_a_run_on_card():
    """A run holds one graph: a call of another length runs eagerly, two
    calls in a row of one length capture it in place of the graph before,
    and lengths that alternate at every call never capture; every result
    equals the eager query's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    dev = torch.device("cuda")
    model = make_fused_lg_ssm()
    series = {T: torch.as_tensor(simulate_observations(T, 7), device=dev) for T in (16, 12)}
    run = build_smc_run(model, 1 << 16, chunk=8)
    graph_counts = counter_group("sweep_graph", ("capture", "replay", "eager"))
    # (T, what the call does): e eager, c capture and replay, r replay
    calls = [(16, "e"), (16, "c"), (12, "e"), (16, "r"), (12, "e"), (12, "c"),
             (16, "e"), (12, "r"), (16, "e"), (12, "r"), (16, "e"), (16, "c")]
    for i, (T, what) in enumerate(calls):
        start = dict(graph_counts)
        got = _kept(run(100 + i, series[T]))
        moved = {k: graph_counts[k] - start[k] for k in start}
        assert moved == {"e": {"capture": 0, "replay": 0, "eager": 1},
                         "c": {"capture": 1, "replay": 1, "eager": 0},
                         "r": {"capture": 0, "replay": 1, "eager": 0}}[what], (i, T)
        eager = _kept(build_smc_run(model, 1 << 16, chunk=8)(100 + i, series[T]))
        assert all(torch.equal(a, b) for a, b in zip(got, eager)), (i, T)

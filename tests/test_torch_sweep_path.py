"""The sweep driver of ``build_smc_run`` (``cpprob_tpu_torch.inference.smc``)
on its own: which path each model and options take, what the kernel
builders leave on a model, and the PyTorch operations the driver's glue
issues around the model's hooks.

The glue is counted with every kernel hook, sampling hook and resample
epoch replaced by a stub that returns tensors made beforehand, so every
ATen operation counted is the driver's or its loop body's: the start's
statistics, the flags, the ticks, the evidence, the close.  On the card
most of them are launches, and the cells ``lg1d-2e24-chunk8`` and
``lg1d-2e24-perstep`` are paced by the host that enqueues them.
"""

import collections
import contextlib
import dataclasses
import importlib

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cpprob_tpu_torch import build_smc_run
from cpprob_tpu_torch.examples.kernel_bench import lg_step_elem
from cpprob_tpu_torch.inference import resampling as rs
from cpprob_tpu_torch.models import hmm_ssm
from cpprob_tpu_torch.models.linear_gaussian import (
    linear_gaussian_ssm,
    obs_logpdf_elem,
    trans_logpdf_elem,
)
from cpprob_tpu_torch.ops import stream_resample as sr
from cpprob_tpu_torch.ops.fused_hmm import make_fused_hmm_ssm
from cpprob_tpu_torch.ops.fused_lg import make_fused_lg_ssm
from cpprob_tpu_torch.ops.fused_ssm import (
    attach_fused_guided_scalar_kernels,
    attach_fused_scalar_kernels,
    attach_fused_vector_kernels,
)

# the package's ``smc`` attribute is the function, not the module
port_smc = importlib.import_module("cpprob_tpu_torch.inference.smc")

N = 64
T = 16
K = 3
PLANES = 10
BODY_SPANS = ("smc.chunk", "smc.step")


class _Fixed:
    """Tensors the stubs return, made before anything is counted."""

    def __init__(self, discrete: bool, planes: int = 0):
        g = torch.Generator().manual_seed(0)
        self.states = (torch.randint(0, K, (N,), generator=g, dtype=torch.int32)
                       if discrete else torch.randn(N, *(planes,) * bool(planes),
                                                    generator=g))
        self.log_w = torch.randn(N, generator=g)
        self.ess = torch.tensor(N / 4, dtype=torch.float64)
        self.flag = torch.tensor(1, dtype=torch.int32)
        self.cat_w = torch.full((K,), 1.0 / K, dtype=torch.float64)
        self.lme = torch.tensor(-1.5, dtype=torch.float64)
        self.anc = torch.arange(N, dtype=torch.int32).flip(0)
        self.stats = torch.tensor([0.5, 3.0], dtype=torch.float64)
        self.obs = torch.randn(T, *(planes,) * bool(planes), generator=g)


def _stub_model(case: str, f: _Fixed, calls: list):
    """The model of ``case`` with every hook it calls stubbed, each call
    noted in ``calls``."""
    s, w = f.states, f.log_w
    prior = dict(init_sample_batch=lambda gen, n: s,
                 obs_logpdf_batch=lambda states, y, t: w)
    exchange_out = (s, w, f.ess, f.cat_w, f.lme)
    hooks = {
        "chunk_exchange": (hmm_ssm, dict(
            fused_init_batch=lambda seed, n, y0: exchange_out,
            fused_chunk_exchange_t_batch=lambda *a: exchange_out)),
        "chunk_exchange/prior": (hmm_ssm, dict(
            fused_chunk_exchange_t_batch=lambda *a: exchange_out, **prior)),
        "chunk_value": (linear_gaussian_ssm, dict(
            fused_init_ctrl_batch=lambda seed, n, y0, thr: (s, w, f.ess, f.flag),
            fused_chunk_t_batch=lambda *a: (s, w, f.ess))),
        "chunk_value/prior": (linear_gaussian_ssm, dict(
            fused_chunk_t_batch=lambda *a: (s, w, f.ess), **prior)),
        "step_exchange": (hmm_ssm, dict(
            fused_step_exchange_batch=lambda *a: exchange_out, **prior)),
        "step_ctrl": (linear_gaussian_ssm, dict(
            fused_init_ctrl_batch=lambda seed, n, y0, thr: (s, w, f.ess, f.flag),
            fused_step_ctrl_batch=lambda *a: (s, w, f.flag))),
        "step_ctrl/prior": (linear_gaussian_ssm, dict(
            fused_step_ctrl_batch=lambda *a: (s, w, f.flag), **prior)),
        "step_ctrl/vector": (dataclasses.replace(
            linear_gaussian_ssm, scalar_state=False, vector_state_dim=PLANES), dict(
            fused_step_ctrl_batch=lambda *a: (s, w, f.flag), **prior)),
        "step": (linear_gaussian_ssm, dict(
            fused_step_batch=lambda *a: (s, w), **prior)),
        "step/history": (linear_gaussian_ssm, dict(
            fused_step_batch=lambda *a: (s, w), **prior)),
    }
    base, stubs = hooks[case]

    def noted(name, stub):
        return lambda *a: calls.append(name) or stub(*a)

    return dataclasses.replace(base, **{k: noted(k, v) for k, v in stubs.items()})


class _CountOps(TorchDispatchMode):
    """Counts ATen operations, by the innermost program span open."""

    def __init__(self, spans):
        super().__init__()
        self.spans, self.ops = spans, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(self.spans[-1] if self.spans else None)
        return func(*args, **(kwargs or {}))


# (ops in a sweep, of which in the loop bodies' spans) at N = 64, T = 16:
# what the driver issued while ``build_smc_run`` still chose each path
# itself, but for ``step``, whose body without history no longer builds
# the ancestors nothing reads (2 ops a step, 272 and 225 before);
# ``step_ctrl/vector`` (added with the vector one-step launch: (n, 10)
# states, (T, 10) observations, started from the prior) issues what the
# scalar path from the prior issues: the observations' rows are one view
# each, as a scalar series' elements are, and the close takes K14's stats
GLUE_OPS = {
    "chunk_exchange": (61, 42),
    "chunk_exchange/prior": (80, 43),
    "chunk_value": (38, 14),
    "chunk_value/prior": (45, 14),
    "step_exchange": (371, 316),
    "step_ctrl": (101, 60),
    "step_ctrl/prior": (110, 60),
    "step_ctrl/vector": (110, 60),
    "step": (242, 195),
    "step/history": (318, 270),
}


@pytest.mark.parametrize("case", sorted(GLUE_OPS))
def test_glue_ops_a_sweep(case, monkeypatch):
    """One sweep of each path calls its start's hooks once and its kernel
    hook once a loop body, and issues the ATen operations it issued when
    the path was first written, no more, and as many of them inside the
    loop bodies: a change to the driver's glue shows here before it shows
    on the card's host clock."""
    f = _Fixed(discrete=case.startswith(("chunk_exchange", "step_exchange")),
               planes=PLANES if case.endswith("vector") else 0)
    spans = []

    @contextlib.contextmanager
    def span(name):
        spans.append(name)
        try:
            yield
        finally:
            spans.pop()

    monkeypatch.setattr(port_smc, "span", span)
    monkeypatch.setattr(port_smc, "continuous_resample_values_lme",
                        lambda gen, log_w, states, flag=None: (f.states, f.lme))
    monkeypatch.setattr(sr, "logsumexp_stats", lambda log_w, flag=None: f.stats)
    monkeypatch.setitem(rs._RESAMPLERS, "systematic", lambda gen, log_w: f.anc)
    calls = []
    model = _stub_model(case, f, calls)
    history = case == "step/history"
    run = build_smc_run(model, N, store_history=history,
                        chunk=8 if case.startswith("chunk") else 1)
    with _CountOps(spans) as counted:
        res = run(7, f.obs)
    total = len(counted.ops)
    in_bodies = sum(s in BODY_SPANS for s in counted.ops)
    bodies = -(-(T - 1) // 8) if case.startswith("chunk") else T - 1
    assert res.resampled.dtype == torch.bool and res.resampled.shape == (1 + bodies,)
    assert (res.states is not None) == history
    assert collections.Counter(calls) == {
        hook: bodies if hook.startswith(("fused_chunk", "fused_step")) else 1
        for hook in set(calls)}
    assert (total, in_bodies) == GLUE_OPS[case]


def _guided_lg(base=None):
    """``base`` (the fused LG model) guided by an untrained [3, 8, 2] net."""
    g = torch.Generator().manual_seed(0)
    net = [{"w": 0.1 * torch.randn(3, 8, generator=g), "b": torch.zeros(8)},
           {"w": 0.1 * torch.randn(8, 2, generator=g), "b": torch.zeros(2)}]
    return attach_fused_guided_scalar_kernels(
        base or make_fused_lg_ssm(), net, 16, trans_logpdf_elem=trans_logpdf_elem,
        obs_logpdf_elem=obs_logpdf_elem)


def _lg2_step_elem(x0, x1, y, e0, e1):
    n0, n1 = 0.9 * x0 + e0, 0.8 * x1 + e1
    d = y - (n0 + n1)
    return n0, n1, -0.5 * d * d


def _proposal(key, states, *rest):
    return states


MODELS = {
    "hmm": lambda: hmm_ssm,
    "fused_hmm": make_fused_hmm_ssm,
    "guided_hmm": lambda: dataclasses.replace(
        make_fused_hmm_ssm(), proposal_sample=_proposal, proposal_logpdf=_proposal,
        fused_hooks_guided=True),
    "lg": lambda: linear_gaussian_ssm,
    "fused_lg": make_fused_lg_ssm,
    "k10": lambda: attach_fused_scalar_kernels(make_fused_lg_ssm(), lg_step_elem),
    "k11": lambda: attach_fused_vector_kernels(
        dataclasses.replace(linear_gaussian_ssm, scalar_state=False), _lg2_step_elem, 2),
    "guided_lg": _guided_lg,
    "proposal_lg": lambda: dataclasses.replace(
        make_fused_lg_ssm(), proposal_sample=_proposal, proposal_logpdf=_proposal),
}


@pytest.mark.parametrize("model,chunk,history,resampling,name", [
    ("fused_hmm", 8, False, "systematic", "chunk_exchange"),
    ("fused_hmm", 1, False, "systematic", "step_exchange"),
    ("fused_hmm", 1, True, "systematic", "step"),
    ("fused_hmm", 1, False, "stratified", "step"),
    ("fused_hmm", 8, False, "stratified", ValueError),
    ("fused_hmm", 8, True, "systematic", ValueError),
    ("guided_hmm", 8, False, "systematic", "chunk_exchange"),
    ("guided_hmm", 1, False, "systematic", "step_exchange"),
    ("hmm", 1, False, "systematic", "step"),
    ("hmm", 8, False, "systematic", ValueError),
    ("fused_lg", 8, False, "systematic", "chunk_value"),
    ("fused_lg", 1, False, "systematic", "step_ctrl"),
    ("fused_lg", 1, True, "systematic", "step"),
    ("fused_lg", 1, False, "multinomial", "step"),
    ("fused_lg", 1, False, "no_such_scheme", ValueError),
    ("lg", 1, False, "systematic", "step"),
    ("k10", 8, False, "systematic", "chunk_value"),
    ("k10", 1, False, "systematic", "step"),
    ("k11", 8, False, "systematic", "chunk_value"),
    ("k11", 1, False, "systematic", "step_ctrl"),
    ("k11", 1, True, "systematic", "step"),
    ("guided_lg", 8, False, "systematic", "chunk_value"),
    ("guided_lg", 1, False, "systematic", "step"),
    ("proposal_lg", 8, False, "systematic", ValueError),
    ("proposal_lg", 1, False, "systematic", "step"),
])
def test_sweep_path(model, chunk, history, resampling, name):
    """The path each model takes under each option: the fused paths need
    systematic resampling, no history and, for a guided model, its guided
    kernels; chunk > 1 without a chunk kernel on those terms is refused."""
    m = MODELS[model]()
    if name is ValueError:
        with pytest.raises(ValueError):
            port_smc._sweep_path(m, 1024, 0.5, resampling, history, chunk)
    else:
        assert port_smc._sweep_path(m, 1024, 0.5, resampling, history, chunk).name == name


@pytest.mark.parametrize("builder", ["scalar", "vector", "guided_scalar"])
def test_builders_clear_every_kernel_hook(builder):
    """A continuous-state builder keeps no kernel hook of its base model:
    every hook of ``_KERNEL_HOOKS`` it does not install is cleared."""
    def theirs(*a):
        raise AssertionError("a hook of the base model was kept")

    base = dataclasses.replace(linear_gaussian_ssm,
                               **dict.fromkeys(port_smc._KERNEL_HOOKS, theirs))
    model = {"scalar": lambda: attach_fused_scalar_kernels(base, lg_step_elem),
             "vector": lambda: attach_fused_vector_kernels(base, _lg2_step_elem, 2),
             "guided_scalar": lambda: _guided_lg(base)}[builder]()
    hooks = {h: getattr(model, h) for h in port_smc._KERNEL_HOOKS}
    assert theirs not in hooks.values()
    assert hooks["fused_chunk_t_batch"] is not None

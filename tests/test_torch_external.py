"""The port's external-simulator bridge (``cpprob_tpu_torch/external.py``)
against the JAX package's ``cpprob_tpu/external.py``.

Both packages' ``SubprocessSimulator`` run a fresh child of the port's
example twin (``python -m cpprob_tpu_torch.examples.external_simulator
--simulator``, its own copy of the reference's numpy child) with
``EXTSIM_SEED=7``, and the reference's child too: the same requests give
identical rows.  A vmapped SIS reaches the child in exactly one exchange a
site, and the reference's ``tests/test_external.py`` cases run on the port.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpprob_tpu_torch as pt
from cpprob_tpu.external import SubprocessSimulator as RefSimulator
from cpprob_tpu.external import observe_external as ref_observe_external
from cpprob_tpu_torch.core import observe, predict, sample
from cpprob_tpu_torch.distributions import Uniform, UniformInt, make_abc
from cpprob_tpu_torch.distributions.base import HOST_READS
from cpprob_tpu_torch.examples.external_simulator import child_argv, make_models
from cpprob_tpu_torch.external import SubprocessSimulator, observe_external
from cpprob_tpu_torch.inference.csis_dynamic import DynamicCSIS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CHILD = [sys.executable, os.path.join(ROOT, "examples", "external_simulator.py"),
             "--simulator"]
GRID, OBS_DIM, N_CHANNELS = 8, 64, 3
REQUESTS = np.array([[0.0, 30.0], [2.0, 15.0], [1.0, 45.0], [1.0, 12.5], [0.0, 49.0]])


@pytest.fixture
def seeded(monkeypatch):
    monkeypatch.setenv("EXTSIM_SEED", "7")


@pytest.fixture(scope="module")
def sim():
    s = SubprocessSimulator(child_argv(), OBS_DIM)
    yield s
    s.close()


def test_both_bridges_on_fresh_twin_children_agree(seeded):
    outs = []
    for cls, argv in ((SubprocessSimulator, child_argv()), (RefSimulator, child_argv()),
                      (RefSimulator, REF_CHILD)):
        with cls(argv, OBS_DIM) as s:
            outs.append((s.batch(REQUESTS), s(np.array([2.0, 33.0]))))
    for batch, one in outs[1:]:
        np.testing.assert_array_equal(batch, outs[0][0])
        np.testing.assert_array_equal(one, outs[0][1])
    assert outs[0][0].shape == (len(REQUESTS), OBS_DIM) and outs[0][0].dtype == np.float32


def test_observe_external_equals_reference_callback(seeded):
    """The same rows through the port's operator under vmap and through the
    reference's ``pure_callback`` under ``jax.vmap``, each on a fresh child:
    identical observations, one exchange each."""
    x = REQUESTS.astype(np.float32)
    with SubprocessSimulator(child_argv(), OBS_DIM) as s:
        got = torch.func.vmap(lambda p: observe_external(s, p, OBS_DIM))(torch.as_tensor(x))
        assert s.n_exchanges == 1
    with RefSimulator(child_argv(), OBS_DIM) as s:
        want = jax.vmap(lambda p: ref_observe_external(s, p, OBS_DIM))(jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_protocol_roundtrip(sim):
    out = sim(np.array([0.0, 30.0]))
    assert out.shape == (OBS_DIM,)
    assert out.sum() > 0
    batch = sim.batch(np.array([[0.0, 30.0], [2.0, 15.0], [1.0, 45.0]]))
    assert batch.shape == (3, OBS_DIM)
    assert batch[2].sum() > batch[1].sum()


def test_operator_seam_under_vmap(sim):
    """The counterpart of the reference's ``pure_callback`` under jit+vmap:
    the whole batch reaches the child in one pipelined exchange, nested
    vmaps included; the output is a constant of the inputs' device."""
    def f(p):
        return observe_external(sim, p, OBS_DIM).sum()

    x = torch.tensor([[0.0, 20.0], [1.0, 20.0], [2.0, 20.0], [1.0, 40.0]])
    n0, r0 = sim.n_exchanges, HOST_READS["observe_external"]
    tot = torch.func.vmap(f)(x)
    assert tot.shape == (4,) and float(tot[3]) > float(tot[1])
    assert sim.n_exchanges - n0 == 1 and HOST_READS["observe_external"] - r0 == 1
    nested = torch.func.vmap(torch.func.vmap(f))(x.reshape(2, 2, 2))
    assert nested.shape == (2, 2) and sim.n_exchanges - n0 == 2
    one = observe_external(sim, [1.0, 20.0], salt=5)
    assert one.shape == (OBS_DIM,) and not one.requires_grad
    p = x[0].clone().requires_grad_(True)
    assert not observe_external(sim, p).requires_grad


def test_vmapped_sis_makes_one_exchange_a_site(seeded):
    with SubprocessSimulator(child_argv(), OBS_DIM) as s:
        _, model = make_models(s)
        observed = torch.as_tensor(s(np.array([1.0, 37.0])))
        n0 = s.n_exchanges
        res = pt.sis(model, (observed,), 64, 0, device="cpu")
        assert s.n_exchanges - n0 == 1
        assert res.log_weights.shape == (64,)
        assert torch.isfinite(res.log_weights).any()


def _abc_logpdf(simulated):
    def logpdf(observed):
        var = torch.clamp(simulated, min=1.0)
        d = observed - simulated
        return torch.sum(-0.5 * d * d / var - 0.5 * torch.log(2 * np.pi * var))
    return logpdf


def test_compile_infer_against_external_process(sim):
    """The reference's workflow at its sizes: a proposal trained from prior
    traces generated through the external process, then guided inference
    recovers the channel of a held-out event."""

    def model_eager(observed):
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = torch.as_tensor(sim(np.array([float(ch), float(energy)])))
        observe(make_abc(lambda g: deposits, _abc_logpdf(deposits)), observed, addr="calo")
        predict(ch, "Channel")
        predict(energy, "Energy")

    def model_traced(observed):
        ch = sample(UniformInt(0, N_CHANNELS - 1), addr="Decay Channel")
        energy = sample(Uniform(10.0, 50.0), addr="Energy")
        deposits = observe_external(sim, torch.stack([ch.float(), energy]), OBS_DIM)
        observe(make_abc(lambda g: deposits, _abc_logpdf(deposits)), observed, addr="calo")
        predict(ch, "Channel")

    true_ch = 1
    observed = torch.as_tensor(sim(np.array([true_ch, 35.0])))
    eng = DynamicCSIS(model_eager, (torch.zeros(OBS_DIM),), probe=8, device="cpu")
    params, stats = eng.compile(0, n_traces=600)
    assert stats["losses"][-1] < stats["losses"][0]

    n = 128
    res_prior = pt.sis(model_traced, (observed,), n, 1, device="cpu")
    res_guided = eng.infer(params, (observed,), n, 2)

    def channel_post(res):
        w = res.normalized_weights.numpy()
        chs = res.predicts["Channel"].numpy()
        return np.array([(w * (chs == c)).sum() for c in range(N_CHANNELS)])

    post_p, post_g = channel_post(res_prior), channel_post(res_guided)
    assert post_p.argmax() == true_ch
    assert post_g.argmax() == true_ch
    assert post_g[true_ch] > 0.9

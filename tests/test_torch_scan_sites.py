"""The port's ``scan_sites`` (``cpprob_tpu_torch.core.scanner``) against the
JAX package's, as ``tests/test_scan_sites.py`` holds the reference.

Fallback (``TraceHandler`` and the like in the stack): the same per-step
addresses as the unrolled model, and as the JAX package's ``hmm_scan``.
Fast path (the SIS stack): tied addresses, one summed log-weight term and
one stacked predict block per name, the same posterior as the unrolled
model and as the JAX package's at the same N (4 SE + 0.02), and the
``scan_adapter`` hook a guided messenger plugs into.  The guided cases of
the reference's file wait for CSIS (slice 5).
"""

import contextlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpprob_tpu as jt
import cpprob_tpu.models as jm
import cpprob_tpu_torch as pt
import cpprob_tpu_torch.models as pm
from cpprob_tpu.core import handlers as jh
from cpprob_tpu_torch.core import handlers as ph
from cpprob_tpu_torch.core.scanner import SiteIndex, scan_sites
from cpprob_tpu_torch.distributions import Normal

torch.set_num_threads(2)


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _simulate_obs(T):
    """The observations of ``tests/test_scan_sites.py`` (the JAX model's)."""
    tr = jh.TraceHandler()
    with jh.Seed(jax.random.key(99)), jh.SimulateObserves(), tr:
        jm.hmm(jnp.zeros(T))
    return np.stack([np.asarray(tr.trace[f"y[{t}]"]["value"]) for t in range(T)])


def _trace(model, T, seed):
    tr = ph.TraceHandler()
    with ph.Seed(gen(seed)), ph.SimulateObserves(), tr:
        model(torch.zeros(T))
    return tr.trace


def test_discovery_addresses_match_unrolled():
    """TraceHandler in the stack => unrolled fallback => the addresses and
    site types of the hand-unrolled model, and of the JAX package's."""
    T = 8
    t1, t2 = _trace(pm.hmm, T, 0), _trace(pm.hmm_scan, T, 0)
    jtr = jh.TraceHandler()
    with jh.Seed(jax.random.key(0)), jh.SimulateObserves(), jtr:
        jm.hmm_scan(jnp.zeros(T))
    assert list(t1) == list(t2) == list(jtr.trace)
    assert [s["type"] for s in t1.values()] == [s["type"] for s in t2.values()] \
        == [s["type"] for s in jtr.trace.values()]


def test_trace_values_roundtrip():
    """The same generator => the fallback scan model and the unrolled model
    give identical traces."""
    t1, t2 = _trace(pm.hmm, 6, 3), _trace(pm.hmm_scan, 6, 3)
    for k in t1:
        assert torch.equal(t1[k]["value"], t2[k]["value"]), k


def _marginals(res):
    states = np.asarray(res.predicts["State"])
    w = np.asarray(res.normalized_weights, np.float64)
    return np.stack([(w[:, None] * (states == s)).sum(0) for s in range(3)], 1)


def test_prior_sis_matches_unrolled_and_reference():
    """The bounds of ``tests/test_scan_sites.py``: prior SIS on T=16 leaves
    an ESS of a few hundred at 50,000 particles, so the marginals are held
    within 0.12 of the exact ones and 0.15 of the JAX package's."""
    obs = _simulate_obs(16)
    exact = pm.hmm_exact_posterior(obs)
    r1 = pt.sis(pm.hmm, (obs,), 50_000, 0, device="cpu")
    r2 = pt.sis(pm.hmm_scan, (obs,), 50_000, 0, device="cpu")
    rj = jt.sis(jm.hmm_scan, (jnp.asarray(obs),), 50_000, jax.random.key(0))
    assert r2.predicts["State"].shape == r1.predicts["State"].shape == (50_000, 16)
    m1, m2, mj = _marginals(r1), _marginals(r2), _marginals(rj)
    assert np.abs(m2 - exact).max() < 0.12
    assert np.abs(m2 - mj).max() < 0.15
    assert abs(float(r2.log_evidence) - float(rj.log_evidence)) < 0.3
    # one draw order: the fast path and the unrolled model give one population
    np.testing.assert_allclose(m1, m2, atol=1e-6)
    assert abs(float(r1.log_evidence) - float(r2.log_evidence)) < 1e-4


def test_logjoint_scan():
    """LogJoint (a LogWeight subclass) takes the fast path: the prior
    log-probs of all T latent sites accumulate beside the T observe terms
    (the HMC potential path), equal to the unrolled model's."""
    T = 6
    obs = torch.zeros(T)
    out = []
    for model in (pm.hmm_scan, pm.hmm):
        lj = ph.LogJoint()
        with ph.Seed(gen(0)), lj:
            model(obs)
        out.append(float(lj.log_weight))
    assert math.isfinite(out[0]) and out[0] < -T * 0.5
    assert abs(out[0] - out[1]) < 1e-5


class _Names(ph.Messenger):
    """A scan-aware messenger: records each site's address; in the fast path
    its adapter threads a count of the loop's iterations."""

    def __init__(self):
        self.names, self.committed = [], None

    def process_message(self, msg):
        self.names.append(msg["name"])

    def scan_adapter(self, length):
        outer = self

        class Adapter:
            init = 0

            @staticmethod
            def make(state):
                m = _Names()
                m.names, m.count = outer.names, state + 1
                return m

            @staticmethod
            def extract(m):
                return m.count

            @staticmethod
            def commit(state):
                outer.committed = state

        return Adapter()


class _NoAdapter(ph.Messenger):
    def scan_adapter(self, length):
        return None


def test_scan_adapter_hook_and_fallback():
    obs = torch.zeros(5)
    names = _Names()
    pc = ph.PredictCollector()
    with ph.Seed(gen(0)), ph.LogWeight(), pc, names:
        pm.hmm_scan(obs)
    assert names.names == ["z[0]", "State", "y[0]"] + ["z[*]", "State", "y[*]"] * 4
    assert names.committed == 4
    states = pc.stacked()["State"]
    assert states.shape == (5,)
    # a messenger whose adapter declines sends the loop to the fallback
    names = _Names()
    with ph.Seed(gen(0)), ph.LogWeight(), _NoAdapter(), names:
        pm.hmm_scan(obs)
    assert names.names[3:6] == ["z[1]", "State", "y[1]"] and names.committed is None


def test_scan_outs_offsets_and_errors():
    def body(carry, x, idx):
        y = pt.sample(Normal(carry, 1.0), addr=f"x[{idx}]")
        pt.observe(Normal(y, 1.0), x, addr=f"y[{idx}]")
        return y, (y, y * 2)

    xs = torch.arange(4.0)
    for stack, addr in (((), "x[*]"), ((ph.TraceHandler(),), "x[7]")):
        lw = ph.LogWeight()
        with contextlib.ExitStack() as es:
            for h in (ph.Seed(gen(1)), lw) + stack:
                es.enter_context(h)
            carry, (ys, ys2) = scan_sites(body, torch.zeros(()), xs, index_offset=7)
        assert ys.shape == (4,) and torch.equal(ys2, 2 * ys) and torch.equal(carry, ys[-1])
        assert str(SiteIndex(None)) == "*" and f"{SiteIndex(7)}" == "7"
        want = sum(float(Normal(ys[t], 1.0, device="cpu").log_prob(xs[t])) for t in range(4))
        assert abs(float(lw.log_weight) - want) < 1e-4
        if stack:
            assert list(stack[0].trace)[:2] == [addr, "y[7]"]
    with pytest.raises(ValueError, match="xs or an explicit length"):
        with ph.Seed(gen()):
            scan_sites(body, torch.zeros(()), ())
    with ph.Seed(gen()):
        carry, outs = scan_sites(lambda c, x, i: (c + 1, None), torch.zeros(()), None, length=3)
    assert float(carry) == 3.0 and outs is None

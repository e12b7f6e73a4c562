"""The port's dynamic-structure CSIS (``cpprob_tpu_torch.inference.csis_dynamic``)
on the CPU: the cases of ``tests/test_csis_dynamic.py`` — a model with a
Python ``while`` on a sampled value trains one shared network from eager
traces bucketed by structure, and guided inference dispatches heads by
address with the prior fallback — held to the same enumeration gates, and
the trace signatures held to the JAX package's on the same traces.
"""

import jax
import numpy as np
import pytest
import torch

import cpprob_tpu as jt
import cpprob_tpu_torch as pt
from cpprob_tpu import distributions as jd
from cpprob_tpu.inference import csis_dynamic as jdyn
from cpprob_tpu_torch import distributions as pd
from cpprob_tpu_torch.inference.csis_dynamic import DynamicCSIS, _trace_signature, sis_host

torch.set_num_threads(2)

P_MORE = 0.4
K_MAX = 6
OBS_STD = 0.5


def _dyn_model(ct, D):
    def dyn_model(y):
        """Geometric number of latent sites — genuinely dynamic structure."""
        k = 0
        while k < K_MAX and int(ct.sample(D.Bernoulli(P_MORE), addr=f"more[{k}]")) == 1:
            k += 1
        mu = ct.sample(D.Normal(float(k), 1.0), addr="mu")
        ct.observe(D.Normal(mu, OBS_STD), y, addr="y")
        ct.predict(mu, "Mu")
        return mu
    return dyn_model


dyn_model = _dyn_model(pt, pd)


def exact_posterior_mean_mu(y):
    """Enumerate k: p(k|y) ∝ p(k) N(y; k, 1+OBS_STD²); E[mu|y,k] conjugate."""
    v = 1.0 + OBS_STD**2
    pk = np.array([P_MORE**k * (1 - P_MORE) for k in range(K_MAX)] + [P_MORE**K_MAX])
    ks = np.arange(K_MAX + 1, dtype=np.float64)
    lik = np.exp(-0.5 * (y - ks) ** 2 / v) / np.sqrt(v)
    post_k = pk * lik
    post_k /= post_k.sum()
    prec = 1.0 + 1.0 / OBS_STD**2
    mu_given_k = (ks + y / OBS_STD**2) / prec
    return float((post_k * mu_given_k).sum())


@pytest.fixture(scope="module")
def trained():
    eng = DynamicCSIS(dyn_model, (0.0,), embedding_dim=32, bucket_batch=64, probe=128,
                      device="cpu")
    params, stats = eng.compile(0, n_traces=6000)
    return eng, params, stats


def test_probe_finds_buckets(trained):
    eng, _, stats = trained
    assert stats["n_buckets"] >= 3           # several k-values realized
    assert "mu" in eng.spec_table
    assert "more[0]" in eng.spec_table
    assert eng.obs_dim == 1


def test_bucketed_training_losses_finite_and_improving(trained):
    _, _, stats = trained
    losses = np.asarray(stats["losses"])
    assert np.isfinite(losses).all()
    n = len(losses)
    assert losses[-n // 4 :].mean() < losses[: n // 4].mean()


def test_guided_inference_beats_prior(trained):
    eng, params, _ = trained
    y = 2.0
    n = 300
    guided = eng.infer(params, (y,), n, 5)
    prior = sis_host(dyn_model, (y,), n, 6, device="cpu")
    assert float(guided.ess) > 1.3 * float(prior.ess)
    got = float(guided.mean("Mu"))
    assert abs(got - exact_posterior_mean_mu(y)) < 0.25, got


def test_prior_fallback_for_unknown_address(trained):
    """A site the probe never saw samples from the prior with RN = 0."""
    eng, params, _ = trained

    def model2(y):
        extra = pt.sample(pd.Normal(0.0, 1.0), addr="never_seen")
        mu = pt.sample(pd.Normal(0.0, 1.0), addr="mu")
        pt.observe(pd.Normal(mu + 0.0 * extra, OBS_STD), y, addr="y")
        pt.predict(mu, "Mu")

    factory = eng.proposal_factory(params, (1.0,))
    res = sis_host(model2, (1.0,), 50, 7, proposal_messenger=factory, device="cpu")
    assert np.isfinite(res.log_weights.numpy()).all()


def test_inconsistent_family_rejected():
    flip = {"n": 0}

    def bad():
        # same address alternates families across traces
        if flip["n"] % 2 == 0:
            pt.sample(pd.Normal(0.0, 1.0), addr="x")
        else:
            pt.sample(pd.Bernoulli(0.5), addr="x")
        flip["n"] += 1
        pt.observe(pd.Normal(0.0, 1.0), 0.0, addr="y")

    with pytest.raises(ValueError, match="different families"):
        DynamicCSIS(bad, (), probe=4, device="cpu")


def test_trace_signatures_match_jax():
    """The same traces (the k of each pinned by ``Substitute``) give equal
    signatures in both packages, and the probes' spec tables agree on the
    addresses both saw (their random streams differ, so a rare deep
    address may be seen by one probe alone)."""
    jeng = jdyn.DynamicCSIS(_dyn_model(jt, jd), (0.0,), embedding_dim=8, probe=64)
    peng = DynamicCSIS(dyn_model, (0.0,), embedding_dim=8, probe=64, device="cpu")
    common = set(peng.spec_table) & set(jeng.spec_table)
    assert {"mu", "more[0]", "more[1]"} <= common
    for a in common:
        assert _trace_signature((peng.spec_table[a],)) == jdyn._trace_signature(
            (jeng.spec_table[a],))
    from cpprob_tpu.core import handlers as jh
    from cpprob_tpu_torch.core import handlers as ph

    for k in range(K_MAX + 1):
        pins = {f"more[{i}]": int(i < k) for i in range(min(k + 1, K_MAX))}
        sigs = []
        for eng, h, key in ((jeng, jh, jax.random.key(k)), (peng, ph, None)):
            gen = key if key is not None else torch.Generator().manual_seed(k)
            with h.Substitute({a: (np.int32(v) if key is not None else torch.tensor(v))
                               for a, v in pins.items()}):
                sites, _, _ = eng._trace_once(gen)
            sigs.append(sites)
        assert _trace_signature(sigs[1]) == jdyn._trace_signature(sigs[0])
        assert len(sigs[1]) == min(k + 1, K_MAX) + 1


class TestVectorizedCompile:
    def test_vectorized_trains_to_guided_inference(self):
        """compile_vectorized: batches drawn under vmap with the skeleton's
        discrete sites pinned train a net whose guided inference beats the
        prior."""
        eng = DynamicCSIS(dyn_model, (0.0,), embedding_dim=32, bucket_batch=64, probe=128,
                          device="cpu")
        params_v, stats_v = eng.compile_vectorized(0, n_traces=4096, batch_size=64)
        assert stats_v["vectorized"] is True
        assert stats_v["n_buckets"] >= 3
        assert np.isfinite(np.asarray(stats_v["losses"])).all()
        y = 2.0
        guided = eng.infer(params_v, (y,), 300, 5)
        prior = sis_host(dyn_model, (y,), 300, 6, device="cpu")
        assert float(guided.ess) > 1.2 * float(prior.ess)
        w = guided.normalized_weights.numpy()
        got = float((w * guided.predicts["Mu"].numpy()).sum())
        assert abs(got - exact_posterior_mean_mu(y)) < 0.3

    def test_flow_on_continuous_falls_back(self):
        """A model branching on a continuous draw cannot run under vmap —
        compile_vectorized finds it at the first batch and runs the eager
        path."""

        def cont_flow_model(y):
            x = pt.sample(pd.Normal(0.0, 1.0), addr="x")
            if float(x) > 0:                      # flow on a continuous draw
                mu = pt.sample(pd.Normal(1.0, 1.0), addr="mu_pos")
            else:
                mu = pt.sample(pd.Normal(-1.0, 1.0), addr="mu_neg")
            pt.observe(pd.Normal(mu, 1.0), y, addr="y")
            pt.predict(mu, "Mu")

        eng = DynamicCSIS(cont_flow_model, (0.0,), embedding_dim=16, probe=64, device="cpu")
        params, stats = eng.compile_vectorized(0, n_traces=256, batch_size=32)
        assert stats["vectorized"] is False
        assert np.isfinite(np.asarray(stats["losses"])).all()


def test_no_card_raises_without_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DynamicCSIS(dyn_model, (0.0,), probe=2)


def test_unprobed_address_left_out_of_the_loss():
    """A training trace can reach an address the probe never saw (here a
    probe of 4 traces, and up to K_MAX = 6 ``more[k]`` sites).  The port's
    loss leaves such a site out, as guided inference falls back to the
    prior there; the JAX package's ``compile`` raises ``KeyError`` on it."""
    eng = DynamicCSIS(dyn_model, (0.0,), embedding_dim=8, bucket_batch=16, probe=4,
                      device="cpu")
    params, stats = eng.compile(0, n_traces=400)
    assert np.isfinite(np.asarray(stats["losses"])).all()
    deep = [a for a in (f"more[{k}]" for k in range(K_MAX)) if a not in eng.spec_table]
    assert deep and all(a not in params["heads"] for a in deep)
    res = eng.infer(params, (2.0,), 50, 1)
    assert np.isfinite(res.log_weights.numpy()).all()

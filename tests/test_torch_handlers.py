"""The port's trace substrate (``cpprob_tpu_torch.core``: handlers and
primitives) against the JAX package's, on the same numpy inputs.

Each case of ``tests/test_handlers.py`` has its counterpart here, with the
JAX package's value beside the port's where the case has a number (1e-6);
the port's handled models vmap in place of the ``jax.jit`` case.  The
models of both packages run under ``Substitute`` / ``Replay`` with the same
numpy site values for 64 particles (vmapped in each package): the
log-weights agree within 1e-5, the trace addresses and the predicts are
identical.  The port's draws come from a ``torch.Generator``, so where a
case draws, it is held to its own runs and to its law, not to JAX's draws.
"""

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
from cpprob_tpu.distributions import Normal as JNormal
from cpprob_tpu.distributions import UniformInt as JUniformInt
from cpprob_tpu_torch import distributions as pdist
from cpprob_tpu_torch.core import handlers as ph
from cpprob_tpu_torch.distributions import Normal, UniformInt
from cpprob_tpu_torch.distributions.base import HOST_READS

torch.set_num_threads(2)

N_SUB = 64


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def simple_model(y):
    mu = pt.sample(Normal(0.0, 1.0), addr="mu")
    pt.observe(Normal(mu, 1.0), y, addr="y")
    pt.predict(mu, "Mu")
    return mu


def j_simple_model(y):
    mu = jt.sample(JNormal(0.0, 1.0), addr="mu")
    jt.observe(JNormal(mu, 1.0), y, addr="y")
    jt.predict(mu, "Mu")
    return mu


# --- counterparts of tests/test_handlers.py --------------------------------


def test_seed_determinism():
    def run(g):
        with ph.Seed(g):
            a = pt.sample(Normal(0.0, 1.0), addr="a")
            b = pt.sample(Normal(0.0, 1.0), addr="b")
        return a, b

    a1, b1 = run(gen(0))
    a2, b2 = run(gen(0))
    assert a1 == a2 and b1 == b2 and a1 != b1


def test_auto_addressing(key):
    def names(h, seed, sample, N, U):
        tr = h.TraceHandler()
        with h.Seed(seed), tr:
            sample(N(0.0, 1.0))
            sample(N(0.0, 1.0))
            sample(U(0, 3))
        return list(tr.trace)

    got = names(ph, gen(), pt.sample, Normal, UniformInt)
    assert got == names(jh, key, jt.sample, JNormal, JUniformInt)
    assert got == ["sample/Normal#0", "sample/Normal#1", "sample/UniformInt#0"]


def test_scope_prefixing():
    tr = ph.TraceHandler()
    with ph.Seed(gen()), tr:
        with ph.Scope("outer"):
            with ph.Scope("inner"):
                pt.sample(Normal(0.0, 1.0), addr="x")
    assert list(tr.trace) == ["outer/inner/x"]


def test_log_weight_observe(key):
    lw = ph.LogWeight()
    with ph.Seed(gen()), lw:
        pt.observe(Normal(0.0, 1.0), 0.5, addr="y")
    jlw = jh.LogWeight()
    with jh.Seed(key), jlw:
        jt.observe(JNormal(0.0, 1.0), 0.5, addr="y")
    np.testing.assert_allclose(float(lw.log_weight), float(jlw.log_weight), rtol=1e-6)
    assert lw.log_weight.device.type == "cpu"


def test_log_joint_includes_prior(key):
    lj = ph.LogJoint()
    with ph.Substitute({"mu": torch.tensor(0.3)}), ph.Seed(gen()), lj:
        simple_model(1.0)
    jlj = jh.LogJoint()
    with jh.Substitute({"mu": jnp.asarray(0.3)}), jh.Seed(key), jlj:
        j_simple_model(1.0)
    want = float(JNormal(0.0, 1.0).log_prob(0.3) + JNormal(0.3, 1.0).log_prob(1.0))
    np.testing.assert_allclose(float(lj.log_weight), float(jlj.log_weight), rtol=1e-6)
    np.testing.assert_allclose(float(lj.log_weight), want, rtol=1e-6)


def test_substitute_fixes_value():
    with ph.Substitute({"mu": torch.tensor(2.5)}), ph.Seed(gen()):
        with ph.LogWeight():
            mu = simple_model(1.0)
    assert float(mu) == 2.5


def test_replay():
    tr = ph.TraceHandler()
    with ph.Seed(gen(0)), tr:
        simple_model(1.0)
    with ph.Replay(tr.trace), ph.Seed(gen(99)):
        mu2 = simple_model(1.0)
    assert float(mu2) == float(tr.trace["mu"]["value"])


def test_simulate_observes():
    """Compile mode: observe ignores the given value and draws."""
    tr = ph.TraceHandler()
    with ph.Seed(gen()), ph.SimulateObserves(), tr:
        simple_model(123.456)
    assert float(tr.trace["y"]["value"]) != 123.456


def test_rejection_guard_keeps_last(key):
    def run(h, seed, sample, rejection_sampling, N, tensor):
        lw = h.LogWeight()
        with h.Seed(seed), lw:
            with rejection_sampling():
                sample(N(0.0, 1.0), addr="x", obs=tensor(0.0))
                sample(N(0.0, 1.0), addr="x", obs=tensor(1.0))
        return float(lw.log_weight)

    got = run(ph, gen(), pt.sample, pt.rejection_sampling, Normal, torch.tensor)
    want = run(jh, key, jt.sample, jt.rejection_sampling, JNormal, jnp.asarray)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_allclose(got, float(JNormal(0.0, 1.0).log_prob(1.0)), rtol=1e-6)


def test_mask_zeroes_contribution():
    lw = ph.LogWeight()
    with ph.Seed(gen()), lw:
        with ph.Mask(torch.tensor(0.0)):
            pt.observe(Normal(0.0, 1.0), 5.0, addr="y")
    assert float(lw.log_weight) == 0.0


def test_factor():
    lw = ph.LogWeight()
    with ph.Seed(gen()), lw:
        pt.factor(-1.5, addr="penalty")
    assert float(lw.log_weight) == -1.5


def test_predict_collector_stacks():
    pc = ph.PredictCollector()
    with ph.Seed(gen()), pc:
        for t in range(3):
            pt.predict(torch.tensor(float(t)), "State")
    np.testing.assert_allclose(pc.stacked()["State"].numpy(), [0.0, 1.0, 2.0])


def test_dryrun_mode():
    """Seed alone = dryrun: the model runs, no effects accumulated."""
    with ph.Seed(gen()):
        mu = simple_model(1.0)
    assert math.isfinite(float(mu))


def test_sample_outside_handlers_raises():
    with pytest.raises(RuntimeError, match="outside any handler"):
        pt.sample(Normal(0.0, 1.0, device="cpu"), addr="x")
    with pytest.raises(TypeError, match="torch.Generator"):
        ph.Seed(0)


def _weighted(mu):
    lw = ph.LogWeight()
    with ph.Substitute({"mu": mu}), ph.Seed(gen()), lw:
        simple_model(1.0)
    return lw.log_weight


def test_handled_model_vmaps_as_it_runs_alone():
    """The counterpart of the ``jax.jit`` case: a handled model under
    ``torch.func.vmap`` gives what it gives particle by particle."""
    mus = torch.linspace(-2.0, 2.0, 9)
    batched = torch.func.vmap(_weighted, randomness="different")(mus)
    one_by_one = torch.stack([_weighted(m) for m in mus])
    torch.testing.assert_close(batched, one_by_one, rtol=1e-6, atol=1e-6)


def test_handled_model_vmaps():
    g = gen(1)

    def weighted(_):
        lw = ph.LogWeight()
        with ph.Seed(g), lw:
            simple_model(1.0)
        return lw.log_weight

    out = torch.func.vmap(weighted, randomness="different")(torch.empty(32))
    assert out.shape == (32,) and bool(torch.isfinite(out).all())
    assert len(set(out.tolist())) == 32   # every particle drew its own mu


def test_replay_repeated_addresses():
    """Repeated addresses replay by occurrence order (trace suffixes @i)."""
    def m():
        a = pt.sample(Normal(0.0, 1.0), addr="x")
        b = pt.sample(Normal(0.0, 1.0), addr="x")  # same address again
        return a, b

    tr = ph.TraceHandler()
    with ph.Seed(gen(0)), tr:
        a1, b1 = m()
    assert list(tr.trace) == ["x", "x@1"]
    with ph.Replay(tr.trace), ph.Seed(gen(123)):
        a2, b2 = m()
    assert float(a2) == float(a1) and float(b2) == float(b1) and float(a1) != float(b1)


# --- devices ------------------------------------------------------------------


def test_seed_device_is_the_models_default_device():
    """While a handled model runs, numbers go to the innermost Seed's
    generator's device; outside, to the card, with no CPU fallback."""
    with ph.Seed(gen()):
        assert Normal(1.0, 1.5).device.type == "cpu"
        assert pt.core.as_tensor([1.0, 2.0]).device.type == "cpu"
        assert Normal(1.0, 1.5, device="meta").device.type == "meta"
        assert pdist.base.default_device().type == "cpu"
    assert pdist.base.default_device().type == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            Normal(1.0, 1.5)
        with pytest.raises(RuntimeError):
            pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), 16, 0)


def test_to_device_keeps_as_tensor_dtypes():
    to = pdist.base.to_device
    for v in (3.0, 2, True, np.float64(1.5), np.int32(4), [1.0, 2.0], np.arange(3)):
        want = torch.as_tensor(v)
        got = to(v, "cpu")
        assert got.dtype == want.dtype and torch.equal(got, want), v
    assert to(3, "cpu", torch.float32).dtype == torch.float32


# --- rejection -----------------------------------------------------------------


def test_rejection_sample_law_and_iterations():
    """``rejection_sample`` under vmap: per-particle (x, n_iters), the
    accepted-draw law (N(0, 1) above 1), ``max_iters`` honoured, one host
    read a round."""
    n = 4096
    prop = Normal(0.0, 1.0, device="cpu")
    accept = lambda x, g: x > 1.0
    g = gen(5)

    def run(max_iters):
        return torch.func.vmap(
            lambda _: pt.rejection_sample(g, prop.sample, accept, max_iters),
            randomness="different")(torch.empty(n))

    HOST_READS["rejection_sample"] = 0
    x, iters = run(10_000)
    assert bool((x > 1.0).all()) and iters.dtype == torch.int32
    rounds = HOST_READS["rejection_sample"]
    assert int(iters.max()) == rounds and int(iters.min()) >= 1
    # P(x > 1) = 0.1587: the proposals a particle takes are geometric
    p = 0.15865525393145707
    assert abs(float(iters.double().mean()) - 1 / p) < 5 * math.sqrt((1 - p) / p**2 / n)
    # E[x | x > 1] = phi(1) / (1 - Phi(1))
    m = 0.24197072451914337 / p
    assert abs(float(x.mean()) - m) < 0.05
    x3, it3 = run(3)
    assert int(it3.max()) == 3 and float((x3 > 1.0).double().mean()) < 0.5
    # outside vmap: one particle
    x1, it1 = pt.rejection_sample(g, prop.sample, accept)
    assert x1.shape == () and float(x1) > 1.0 and int(it1) >= 1


def test_truncated_rejection_under_vmap():
    """``Truncated`` over a base without ``icdf`` samples by rejection; under
    vmap its flag is the whole population's."""
    tr = pdist.Truncated(pdist.Gamma(2.0, 1.0, device="cpu"), 0.5, 3.0)
    g = gen(3)
    before = HOST_READS["truncated"]
    x = torch.func.vmap(lambda _: tr.sample(g), randomness="different")(torch.empty(2048))
    assert x.shape == (2048,) and bool(((x >= 0.5) & (x <= 3.0)).all())
    assert HOST_READS["truncated"] > before
    assert len(set(x.tolist())) == 2048


def _accept_gt1(x):
    return x > 1.0


def test_guard_trace_records_accepted_draw():
    """TraceHandler keeps ONE entry per guarded address — the accepted
    draw — with no @i suffixes; vmapped, the traces hold accepted draws."""
    def model():
        x, _ = pt.guarded_rejection(Normal(0.0, 2.0), _accept_gt1, addr="x", max_iters=16)
        pt.predict(x, "X")

    g = gen(0)

    def one(_):
        tr = ph.TraceHandler()
        with ph.Seed(g), ph.SimulateObserves(), tr:
            model()
        assert [k for k in tr.trace if k.startswith("x")] == ["x"]
        return tr.trace["x"]["value"]

    xs = torch.func.vmap(one, randomness="different")(torch.empty(4096))
    assert float((xs > 1.0).double().mean()) > 0.99
    # N(0, 2) truncated to x > 1: mean 2.283, std 1.035
    assert abs(float(xs.mean()) - 2.283) < 0.1 and abs(float(xs.std()) - 1.035) < 0.1


def test_guard_logweight_counts_accepted_rn_only():
    """Guided: the guard contributes exactly one RN term, the accepted
    draw's (state.cpp:225-238)."""
    class ConstProposal(ph.Messenger):
        def __init__(self, dist):
            self.dist = dist

        def process_message(self, msg):
            if (msg["type"] == "sample" and msg["control"]
                    and msg["proposal_dist"] is None and msg["value"] is None):
                msg["proposal_dist"] = self.dist

    prior = Normal(0.0, 2.0, device="cpu")
    prop = Normal(2.0, 1.0, device="cpu")
    lw, tr = ph.LogWeight(), ph.TraceHandler()
    with ph.Seed(gen(3)), lw, ConstProposal(prop), tr:
        pt.guarded_rejection(prior, _accept_gt1, addr="x", max_iters=16)
    x = tr.trace["x"]["value"]
    torch.testing.assert_close(lw.log_weight, prior.log_prob(x) - prop.log_prob(x),
                               rtol=1e-5, atol=1e-6)


# --- substituted models, element by element ----------------------------------

_PTS = np.array([[1, 2.1], [2, 3.9], [3, 5.3], [4, 7.7]], np.float32)
_HMM_OBS = np.array([0.9, 0.8, 0.7, 0.0, -0.025, -5.0, -2.0, -0.1], np.float32)
_LG_OBS = np.array([0.5, 1.0, 0.3, -0.2, 0.8], np.float32)

# name -> (args, handler of the site values: "substitute" or "replay")
MODELS = {
    "gaussian_unknown_mean": ((3.0, 4.0), "substitute"),
    "gaussian_unknown_mean_readme": ((3.0, 4.0), "substitute"),
    "Gauss": ((3.0, 4.0), "replay"),
    "gaussian_2d_unknown_mean": ((np.array([3.0, 4.0], np.float32),), "substitute"),
    "all_distr": ((0, 0), "substitute"),
    "normal_rejection_sampling_guard": ((3.0, 4.0), "substitute"),
    "poly_adjustment": ((_PTS,), "substitute"),
    "linear_regression": ((_PTS,), "substitute"),
    "poly_adjustment_prior_gen": ((1, 6), "substitute"),
    "hmm": ((_HMM_OBS,), "replay"),
    "hmm_scan": ((_HMM_OBS,), "substitute"),
    "linear_gaussian_1d": ((_LG_OBS,), "substitute"),
}


def _model(pkg, name):
    m = getattr(pkg, name)
    return m() if name == "Gauss" else m


def _run_jax(name, args, mode, values):
    """The JAX model under Substitute/Replay with ``values``, vmapped over
    the particles: (log-weights, predicts, trace addresses)."""
    model = _model(jm, name)

    def one(vals):
        lw, pc, tr = jh.LogWeight(), jh.PredictCollector(), jh.TraceHandler()
        fix = (jh.Substitute(vals) if mode == "substitute"
               else jh.Replay({k: {"value": v} for k, v in vals.items()}))
        with fix, jh.Seed(jax.random.key(0)), lw, pc, tr:
            model(*args)
        return lw.log_weight, pc.stacked(), list(tr.trace)

    names = one({k: v[0] for k, v in values.items()})[2]
    lw, preds = jax.vmap(lambda v: one(v)[:2])(values)
    return np.asarray(lw), {k: np.asarray(v) for k, v in preds.items()}, names


def _run_port(name, args, mode, values):
    model = _model(pm, name)
    g = gen(0)
    names = []

    def one(vals):
        lw, pc, tr = ph.LogWeight(), ph.PredictCollector(), ph.TraceHandler()
        fix = (ph.Substitute(vals) if mode == "substitute"
               else ph.Replay({k: {"value": v} for k, v in vals.items()}))
        with fix, ph.Seed(g), lw, pc, tr:
            model(*args)
        names[:] = list(tr.trace)
        return lw.log_weight, pc.stacked()

    lw, preds = torch.func.vmap(one, randomness="different")(values)
    return lw.numpy(), {k: v.numpy() for k, v in preds.items()}, names


def _site_values(name, args):
    """The sample-site values of N_SUB prior runs of the JAX model (the
    last draw per address inside a rejection guard), as numpy arrays."""
    model = _model(jm, name)

    def one(k):
        tr = jh.TraceHandler()
        with jh.Seed(k), tr:
            model(*args)
        return {a: s["value"] for a, s in tr.trace.items() if s["type"] == "sample"}

    vals = jax.vmap(one)(jax.random.split(jax.random.key(7), N_SUB))
    return {k: np.asarray(v) for k, v in vals.items()}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_substituted_models_match_reference(name):
    args, mode = MODELS[name]
    values = _site_values(name, args)
    j_lw, j_preds, j_names = _run_jax(name, args, mode, {k: jnp.asarray(v) for k, v in values.items()})
    p_vals = {k: torch.from_numpy(np.array(v, np.int64 if v.dtype == np.int32 else v.dtype))
              for k, v in values.items()}
    p_lw, p_preds, p_names = _run_port(name, args, mode, p_vals)
    assert p_names == j_names
    assert np.isfinite(j_lw).all()
    np.testing.assert_allclose(p_lw, j_lw, rtol=1e-5, atol=1e-5)
    assert sorted(p_preds) == sorted(j_preds)
    for k in j_preds:
        assert p_preds[k].shape == j_preds[k].shape, k
        np.testing.assert_array_equal(p_preds[k], j_preds[k].astype(p_preds[k].dtype))


def test_rejection_model_weights_its_accepted_draw():
    """``normal_rejection_sampling`` draws its loop from one uncontrolled
    site's generator, so it cannot be substituted across packages: its
    addresses are the reference's, and its log-weight is the JAX
    likelihood at its own accepted draw."""
    res = pt.sis(pm.normal_rejection_sampling, (3.0, 4.0), N_SUB, 0, device="cpu")
    mu = res.predicts["Mu"].numpy()
    want = np.asarray(JNormal(jnp.asarray(mu), math.sqrt(2.0)).log_prob(3.0)
                      + JNormal(jnp.asarray(mu), math.sqrt(2.0)).log_prob(4.0))
    np.testing.assert_allclose(res.log_weights.numpy(), want, rtol=1e-5, atol=1e-5)
    tr = ph.TraceHandler()
    with ph.Seed(gen()), tr:
        pm.normal_rejection_sampling(3.0, 4.0)
    jtr = jh.TraceHandler()
    with jh.Seed(jax.random.key(0)), jtr:
        jm.normal_rejection_sampling(3.0, 4.0)
    assert list(tr.trace) == list(jtr.trace) == ["mu_rejection_key", "y1", "y2"]
    assert isinstance(tr.trace["mu_rejection_key"]["value"], torch.Generator)

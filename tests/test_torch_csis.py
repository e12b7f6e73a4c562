"""The port's CSIS (``cpprob_tpu_torch.inference.csis``, ``nn``,
``regularize``) against the JAX package's, on the CPU.

- Exact parts, from the same numpy inputs and the JAX package's weights
  carried across (``interop.csis_params_from_numpy``): structure discovery
  and tying, every proposal family's ``log_prob`` (1e-5), the observation
  embeddings (1e-5), the LSTM steps (1e-6), ``dro_loss`` (1e-6).
- Loss and gradient: ``csis_loss`` on a trace batch drawn by the JAX
  package, untied, tied and with ``dro_rho``, within 1e-5 relative; its
  gradients against ``jax.grad`` within 1e-4.
- Training: Adam steps (``torch.optim.Adam`` through ``compile_offline``
  against ``optax.adam``) from the same weights and batches: one step
  within 1e-6, twenty within 1e-4.
- Guided log-weights: each particle the port's messenger draws has the
  log-weight the JAX package gives it (its log-joint minus its guided
  log-density of the drawn values), within 1e-4: the LSTM recursion of
  inference against that of training, across packages.
- Statistics at small widths (embedding 32) and 2^14-2^16 particles, as
  ``tests/test_csis.py`` and ``test_csis_tied.py`` hold the JAX package.
- Weights carried across by checkpoint, both ways.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import cpprob_tpu as jt
import cpprob_tpu.inference.csis as jcsis
import cpprob_tpu.inference.nn as jnn
import cpprob_tpu.inference.regularize as jreg
import cpprob_tpu.models as jm
import cpprob_tpu_torch as pt
import cpprob_tpu_torch.inference.csis as pcsis
import cpprob_tpu_torch.inference.nn as pnn
import cpprob_tpu_torch.inference.regularize as preg
import cpprob_tpu_torch.models as pm
from cpprob_tpu import distributions as jd
from cpprob_tpu.core import handlers as jh
from cpprob_tpu_torch import distributions as pd
from cpprob_tpu_torch.interop import csis_params_from_numpy
from cpprob_tpu_torch.util.pytree import tree_leaves, tree_map

torch.set_num_threads(2)

E = 16                       # widths of the exact checks
HMM_OBS6 = np.array([0.9, 0.8, -1.0, 0.0, 1.1, -0.8], np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _port_params(jparams):
    return csis_params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _close(a, b, tol, what=""):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    err = np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))) if a.size else 0.0
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# structure


def _tm_model(ct, D):
    def model(y):
        x = ct.sample(D.Truncated(D.Normal(0.0, 1.0), -1.0, 2.0), addr="x")
        z = ct.sample(D.Mixture(D.Normal(np.array([-1.0, 1.0], np.float32),
                                         np.array([0.5, 0.5], np.float32)),
                                np.array([0.3, 0.7], np.float32)), addr="z")
        ct.observe(D.Normal(x + z, 0.5), y, addr="y")
        ct.predict(x, "X")
    return model


PTS = np.array([[1, 2.1], [2, 3.9], [3, 5.3]], np.float32)
STRUCT_CASES = {
    "gaussian_readme": (lambda M: M.gaussian_unknown_mean_readme, (0.0, 0.0)),
    "hmm": (lambda M: M.hmm, (np.zeros(5, np.float32),)),
    "hmm_scan": (lambda M: M.hmm_scan, (np.zeros(5, np.float32),)),
    "all_distr": (lambda M: M.all_distr, (0, 0)),
    "poly": (lambda M: M.poly_adjustment, (PTS,)),
    "linear_regression": (lambda M: M.linear_regression, (PTS,)),
}


def _fields(s):
    return (tuple((x.addr, x.kind, tuple(float(m) for m in x.meta), x.value_dim,
                   x.discrete_k, x.n_out, x.param_key) for x in s.sites),
            tuple(s.observe_addrs), s.obs_dim, tuple(s.segments),
            tuple(tuple(o) for o in s.observe_shapes))


@pytest.mark.parametrize("name", list(STRUCT_CASES) + ["truncated_mixture"])
def test_discover_and_tie_structure_match(name):
    if name == "truncated_mixture":
        jmod, pmod, args = _tm_model(jt, jd), _tm_model(pt, pd), (0.3,)
    else:
        get, args = STRUCT_CASES[name]
        jmod, pmod = get(jm), get(pm)
    js = jcsis.discover_structure(jmod, args)
    ps = pcsis.discover_structure(pmod, args)
    assert _fields(ps) == _fields(js)
    assert _fields(pcsis.tie_structure(ps)) == _fields(jcsis.tie_structure(js))
    assert len(ps.sites) > 0


# ---------------------------------------------------------------------------
# proposal families

FAMILIES = {
    "normal": ((), 2), "mdn": ((3,), 9), "nsf": ((4,), 13), "uniform": ((-2.0, 3.0), 24),
    "uniform_int": ((2, 5), 5), "categorical": ((4,), 4), "poisson": ((), 1),
    "bernoulli": ((), 1), "beta": ((), 2), "gamma": ((), 2), "laplace": ((), 2),
    "exponential": ((), 1), "mvn_diag": ((3,), 6),
}


def _family_values(kind, meta, n, rng):
    if kind == "uniform":
        return rng.uniform(meta[0], meta[1], n).astype(np.float32)
    if kind == "uniform_int":
        return rng.integers(meta[0], meta[0] + meta[1], n).astype(np.int32)
    if kind == "categorical":
        return rng.integers(0, meta[0], n).astype(np.int32)
    if kind == "poisson":
        return rng.integers(0, 7, n).astype(np.int32)
    if kind == "bernoulli":
        return rng.integers(0, 2, n).astype(np.int32)
    if kind == "beta":
        return rng.uniform(0.02, 0.98, n).astype(np.float32)
    if kind in ("gamma", "exponential"):
        return rng.uniform(0.05, 4.0, n).astype(np.float32)
    if kind == "mvn_diag":
        return rng.standard_normal((n, meta[0])).astype(np.float32)
    return (2.0 * rng.standard_normal(n)).astype(np.float32)


@pytest.mark.parametrize("kind", list(FAMILIES))
def test_proposal_family_log_prob_matches(kind):
    meta, n_out = FAMILIES[kind]
    rng = np.random.default_rng(list(FAMILIES).index(kind))
    raw = rng.standard_normal((64, n_out)).astype(np.float32)
    x = _family_values(kind, meta, 64, rng)
    dim = meta[0] if kind == "mvn_diag" else 1
    args = ("a", kind, meta, dim, 0, n_out)
    jlp = jcsis.make_proposal_dist(jcsis.SiteSpec(*args), jnp.asarray(raw)).log_prob(jnp.asarray(x))
    plp = pcsis.make_proposal_dist(pcsis.SiteSpec(*args), torch.as_tensor(raw)).log_prob(
        torch.as_tensor(x).long() if x.dtype == np.int32 else torch.as_tensor(x))
    assert np.isfinite(np.asarray(jlp)).all()
    _close(plp, jlp, 1e-5, kind)


# ---------------------------------------------------------------------------
# the building blocks


def test_lstm_steps_and_sequence_match():
    key = jax.random.key(3)
    jp = jnn.lstm_init(key, 2 * E, E, layers=2)
    pp = _port_params(jp)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 2 * E)).astype(np.float32)
    st = [(rng.standard_normal((5, E)).astype(np.float32),
           rng.standard_normal((5, E)).astype(np.float32)) for _ in range(2)]
    jst = [tuple(map(jnp.asarray, s)) for s in st]
    pst = [tuple(map(torch.as_tensor, s)) for s in st]
    jh_, jnew = jnn.lstm_step(jp, jnp.asarray(x), jst)
    ph_, pnew = pnn.lstm_step(pp, torch.as_tensor(x), pst)
    _close(ph_, jh_, 1e-6, "lstm_step")
    for (a, b), (c, d) in zip(pnew, jnew):
        _close(a, c, 1e-6)
        _close(b, d, 1e-6)
    gate_j = jnn.lstm_obs_gate(jp, jnp.asarray(x[:, E:]))
    gate_p = pnn.lstm_obs_gate(pp, torch.as_tensor(x[:, E:]))
    _close(gate_p, gate_j, 1e-6, "obs gate")
    jh2, _ = jnn.lstm_step_split(jp, jnp.asarray(x[:, :E]), gate_j, jst)
    ph2, _ = pnn.lstm_step_split(pp, torch.as_tensor(x[:, :E]), gate_p, pst)
    _close(ph2, jh2, 1e-6, "lstm_step_split")
    _close(ph2, ph_, 1e-6, "split against concat")
    seq = rng.standard_normal((7, 3, 2 * E)).astype(np.float32)
    _close(pnn.lstm_embed_sequence(pp, torch.as_tensor(seq)),
           jnn.lstm_embed_sequence(jp, jnp.asarray(seq)), 1e-6, "sequence")
    tab = jnn.embedding_init(key, 5, E)
    idx = np.array([[0, 4], [2, 2]])
    _close(pnn.embedding_lookup(torch.as_tensor(np.asarray(tab)), torch.as_tensor(idx)),
           jnn.embedding_lookup(tab, jnp.asarray(idx)), 0.0, "embedding")


def _obs_structure(mod):
    return mod.ModelStructure((), ("vol", "y1", "y2"), 50,
                              observe_shapes=((4, 4, 3), (), (1,)))


@pytest.mark.parametrize("mode", ["fc", "lstm", "cnn3d", "site-lstm"])
def test_embed_observation_matches(mode):
    js, ps = _obs_structure(jcsis), _obs_structure(pcsis)
    oshape = (5, 5, 2) if mode == "cnn3d" else None
    jp = jcsis.init_csis_params(jax.random.key(1), js, E, mode, oshape)
    pp = _port_params(jp)
    obs = np.random.default_rng(2).standard_normal((3, 50)).astype(np.float32)
    je = jcsis.embed_observation(jp, jnp.asarray(obs), mode, oshape, js)
    pe = pcsis.embed_observation(pp, torch.as_tensor(obs), mode, oshape, ps)
    assert pe.shape == (3, E)
    _close(pe, je, 1e-5, mode)


@pytest.mark.parametrize("rho", [0.1, 1.0, 25.0])
def test_dro_loss_matches(rho):
    losses = np.random.default_rng(4).gamma(2.0, 1.5, 37).astype(np.float32)
    _close(preg.chi_square_weights(torch.as_tensor(losses), rho),
           jreg.chi_square_weights(jnp.asarray(losses), rho), 1e-6, "weights")
    _close(preg.dro_loss(torch.as_tensor(losses), rho),
           jreg.dro_loss(jnp.asarray(losses), rho), 1e-6, "loss")


# ---------------------------------------------------------------------------
# loss, gradient and training across packages


def _engines(name, tie=False, embedding_dim=E):
    jmod, pmod = {"hmm": (jm.hmm, pm.hmm), "hmm_scan": (jm.hmm_scan, pm.hmm_scan),
                  "gaussian": (jm.gaussian_unknown_mean_readme,
                               pm.gaussian_unknown_mean_readme)}[name]
    args = (0.0, 0.0) if name == "gaussian" else (np.zeros(6, np.float32),)
    je = jcsis.CSIS(jmod, args, embedding_dim=embedding_dim, tie_addresses=tie)
    pe = pcsis.CSIS(pmod, args, embedding_dim=embedding_dim, tie_addresses=tie, device="cpu")
    return je, pe


def _jax_batch(je, seed, n=32):
    values, obs = je._gen(jax.random.key(seed), n)
    return values, obs


def _port_batch(pe, values, obs):
    ints = {s.addr for s in pe.structure.sites if s.discrete_k > 0}
    out = {k: (torch.as_tensor(np.asarray(v)).long() if k in ints
               else torch.as_tensor(np.asarray(v)))
           for k, v in values.items() if k != "__masks__"}
    out["__masks__"] = {k: torch.as_tensor(np.asarray(v)) for k, v in values["__masks__"].items()}
    return out, torch.as_tensor(np.asarray(obs))


@pytest.mark.parametrize("case", ["hmm", "hmm_tied", "hmm_dro", "gaussian"])
def test_csis_loss_and_grad_match(case):
    name = "hmm_scan" if case == "hmm_tied" else case.split("_")[0]
    je, pe = _engines(name, tie=case == "hmm_tied")
    if case == "hmm_tied":
        assert any(length > 1 for _, length in pe.structure.segments)
    rho = 0.5 if case == "hmm_dro" else None
    jp = je.init(jax.random.key(7))
    values, obs = _jax_batch(je, 8)
    jl, jg = jax.value_and_grad(jcsis.csis_loss)(jp, je.structure, values, obs, "fc", None, rho)
    pp = tree_map(lambda t: t.requires_grad_(), _port_params(jp))
    pv, po = _port_batch(pe, values, obs)
    pl = pcsis.csis_loss(pp, pe.structure, pv, po, "fc", None, rho)
    pl.backward()
    _close(pl, jl, 1e-5, "loss")
    jleaves = jax.tree_util.tree_leaves(jg)
    # a leaf the loss does not reach (the last site's value embedding) has
    # no gradient in torch and a zero one in JAX
    pleaves = [torch.zeros_like(t) if t.grad is None else t.grad for t in tree_leaves(pp)]
    assert len(jleaves) == len(pleaves)
    for i, (a, b) in enumerate(zip(pleaves, jleaves)):
        b = np.asarray(b)
        scale = max(1.0, float(np.abs(b).max()))
        assert np.abs(_np(a) - b).max() <= 1e-4 * scale, (i, np.abs(_np(a) - b).max(), scale)


class _Batches:
    """A loader of fixed (values, obs) batches in the shard layout
    (``__mask__<addr>`` columns)."""

    def __init__(self, batches):
        self.batches = list(batches)
        self.i = 0

    def next_batch(self):
        values, obs = self.batches[self.i]
        self.i += 1
        out = {k: v for k, v in values.items() if k != "__masks__"}
        out.update({f"__mask__{k}": v for k, v in values["__masks__"].items()})
        return out, obs


def _optax_run(je, jp, batches, lr=1e-3):
    opt = optax.adam(lr)
    state = opt.init(jp)
    step = jax.jit(lambda p, s, v, o: _optax_step(opt, je.structure, p, s, v, o))
    for values, obs in batches:
        jp, state, _ = step(jp, state, values, obs)
    return jp


def test_adam_one_step_matches_optax():
    """One ``torch.optim.Adam`` step against ``optax.adam`` from the same
    weights and batch, within 1e-6.  Adam's first step is lr·g/(|g| + 1e-8):
    where a gradient component is near 1e-8 it magnifies the packages'
    float32 rounding of that component (absolute ~1e-9, held within 1e-4 by
    ``test_csis_loss_and_grad_match``) up to 1e5-fold.  So the step is held
    to optax's step of the port's own gradient within 1e-6 everywhere, and
    to the JAX package's whole step within 1e-6 wherever its gradient
    component is at least 1e-6."""
    je, pe = _engines("hmm")
    jp0 = je.init(jax.random.key(11))
    values, obs = _jax_batch(je, 100)
    pp, losses = pe.compile_offline(_Batches([_port_batch(pe, values, obs)]), steps=1,
                                    params=_port_params(jp0), learning_rate=1e-3)
    assert losses.shape == (1,)
    jgrad = jax.grad(jcsis.csis_loss)(jp0, je.structure, values, obs)
    p0 = tree_map(lambda t: t.requires_grad_(), _port_params(jp0))
    pcsis.csis_loss(p0, pe.structure, *_port_batch(pe, values, obs)).backward()
    pgrad = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(jp0),
        [np.zeros(t.shape, np.float32) if t.grad is None else _np(t.grad)
         for t in tree_leaves(p0)])
    opt = optax.adam(1e-3)
    upd, _ = opt.update(pgrad, opt.init(jp0))
    from_pgrad = optax.apply_updates(jp0, upd)
    jp1 = _optax_run(je, jp0, [(values, obs)])
    for a, b, c, g in zip(tree_leaves(pp), jax.tree_util.tree_leaves(from_pgrad),
                          jax.tree_util.tree_leaves(jp1), jax.tree_util.tree_leaves(jgrad)):
        a, b, c, g = _np(a), np.asarray(b), np.asarray(c), np.abs(np.asarray(g))
        assert np.abs(a - b).max() <= 1e-6
        assert np.abs(a - c)[g >= 1e-6].max(initial=0.0) <= 1e-6


def test_adam_twenty_steps_match_optax():
    """Twenty Adam steps on twenty batches drawn by the JAX package, from
    the same weights: within 1e-4 of ``optax.adam``."""
    je, pe = _engines("hmm")
    jp0 = je.init(jax.random.key(11))
    batches = [_jax_batch(je, 100 + s) for s in range(20)]
    jp = _optax_run(je, jp0, batches)
    pp, losses = pe.compile_offline(_Batches([_port_batch(pe, v, o) for v, o in batches]),
                                    steps=20, params=_port_params(jp0), learning_rate=1e-3)
    assert losses.shape == (20,)
    for a, b in zip(tree_leaves(pp), jax.tree_util.tree_leaves(jp)):
        assert np.abs(_np(a) - np.asarray(b)).max() <= 1e-4


def _optax_step(opt, structure, params, state, values, obs):
    loss, grads = jax.value_and_grad(jcsis.csis_loss)(params, structure, values, obs)
    updates, state = opt.update(grads, state)
    return optax.apply_updates(params, updates), state, loss


# ---------------------------------------------------------------------------
# guided log-weights: the port's draws, the JAX package's densities


def _jax_log_joint(model, args, subs):
    lj = jh.LogJoint()
    with jh.Seed(jax.random.key(0)), jh.Substitute(subs), lj:
        model(*args)
    return lj.log_weight


@pytest.mark.parametrize("name", ["hmm", "gaussian"])
def test_guided_log_weights_match_jax_densities(name):
    je, pe = _engines(name)
    jp = je.init(jax.random.key(5))
    if name == "hmm":
        args, addr = (HMM_OBS6,), lambda t: f"z[{t}]"
        pred = "State"
    else:
        args, addr, pred = (3.0, 4.0), None, "Mean"
    res = pe.infer(_port_params(jp), args, 64, 9)
    drawn = _np(res.predicts[pred])
    jmodel = je.model
    if name == "hmm":
        subs = {addr(t): jnp.asarray(drawn[:, t].astype(np.int32)) for t in range(drawn.shape[1])}
        vals = {k: v for k, v in subs.items()}
    else:
        subs = {"mu": jnp.asarray(drawn)}
        vals = dict(subs)
    log_joint = jax.vmap(lambda s: _jax_log_joint(jmodel, args, s))(subs)
    obs = jnp.broadcast_to(je.obs_vector(args), (64, je.structure.obs_dim))

    def neg_log_q(v, o):
        one = {k: x[None] for k, x in v.items()}
        one["__masks__"] = {s.addr: jnp.ones((1,)) for s in je.structure.sites}
        return jcsis.csis_loss(jp, je.structure, one, o[None])

    nlq = jax.vmap(neg_log_q)(vals, obs)
    want = np.asarray(log_joint) + np.asarray(nlq)
    got = _np(res.log_weights)
    assert np.abs(got - want).max() <= 1e-4 * max(1.0, np.abs(want).max()), np.abs(got - want).max()


# ---------------------------------------------------------------------------
# statistics (tests/test_csis.py, test_csis_tied.py)


def _w(res):
    lw = _np(res.log_weights).astype(np.float64)
    w = np.exp(lw - lw.max())
    return w / w.sum()


@pytest.fixture(scope="module")
def gaussian_engine():
    eng = pcsis.CSIS(pm.gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=32,
                     device="cpu")
    params, losses = eng.compile(0, steps=300, batch_size=256)
    return eng, params, losses


def test_gaussian_training_converges(gaussian_engine):
    _, _, losses = gaussian_engine
    assert losses.shape == (300,) and torch.isfinite(losses).all()
    assert float(losses[-10:].mean()) < float(losses[0]) - 0.5


def test_gaussian_guided_posterior_and_ess(gaussian_engine):
    eng, params, _ = gaussian_engine
    n = 1 << 16
    res = eng.infer(params, (3.0, 4.0), n, 1)
    assert abs(float(res.mean("Mean")) - 2.32353) < 0.03
    assert abs(float(res.variance("Mean")) - 1.05882) < 0.05
    prior = pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), n, 1, device="cpu")
    assert float(res.ess) > 1.5 * float(prior.ess)
    mean, _ = pm.gaussian_posterior_analytic([-1.0, 0.5], mu0=1.0, sigma0=1.5, sigma=2.0)
    other = eng.infer(params, (-1.0, 0.5), n, 2)
    assert abs(float(other.mean("Mean")) - float(mean)) < 0.04
    with pytest.raises(TypeError, match="sis options"):        # the reference drops them
        eng.infer(params, (3.0, 4.0), 64, 1, mesh=object(), batch_size=16)


def test_gaussian_defensive_and_infer_many(gaussian_engine):
    eng, params, _ = gaussian_engine
    res = eng.infer(params, (3.0, 4.0), 1 << 14, 3, defensive=0.2)
    assert abs(float(res.mean("Mean")) - 2.32353) < 0.05
    many = eng.infer_many(params, (3.0, 4.0), 256, [4, 5, 6])
    assert many.log_weights.shape == (3, 256)
    for i, s in enumerate([4, 5, 6]):
        one = eng.infer(params, (3.0, 4.0), 256, s)
        assert torch.equal(many.log_weights[i], one.log_weights)
        assert torch.equal(many.predicts["Mean"][i], one.predicts["Mean"])


@pytest.fixture(scope="module")
def hmm_engines():
    obs = np.zeros(6, np.float32)
    untied = pcsis.CSIS(pm.hmm, (obs,), embedding_dim=32, device="cpu")
    tied = pcsis.CSIS(pm.hmm_scan, (obs,), embedding_dim=32, device="cpu", tie_addresses=True)
    return ((untied, untied.compile(0, steps=300, batch_size=256)[0]),
            (tied, tied.compile(0, steps=300, batch_size=256)[0]))


def _marginals(res, T=6):
    w = _w(res)
    states = _np(res.predicts["State"])
    return np.array([[np.sum(w * (states[:, t] == s)) for s in range(3)] for t in range(T)])


@pytest.mark.parametrize("which", ["untied", "tied"])
def test_hmm_guided_marginals_and_ess(hmm_engines, which):
    eng, params = hmm_engines[0 if which == "untied" else 1]
    if which == "tied":
        n_params = sum(t.numel() for t in tree_leaves(params))
        n_untied = sum(t.numel() for t in tree_leaves(hmm_engines[0][1]))
        assert n_params < n_untied
    n = 1 << 15
    res = eng.infer(params, (HMM_OBS6,), n, 0)
    exact = np.asarray(pm.hmm_exact_posterior(HMM_OBS6))
    assert np.abs(_marginals(res) - exact).max() < 0.04
    prior = pt.sis(eng.model, (HMM_OBS6,), n, 0, device="cpu")
    assert float(res.ess) > 2.0 * float(prior.ess)


def test_tied_and_untied_agree(hmm_engines):
    (eu, pu), (et, ptied) = hmm_engines
    lz = []
    for eng, params in ((eu, pu), (et, ptied)):
        vals = [float(eng.infer(params, (HMM_OBS6,), 1 << 14, s).log_evidence) for s in range(4)]
        lz.append((np.mean(vals), np.std(vals, ddof=1) / 2.0))
    exact = pm.hmm_log_evidence(HMM_OBS6)
    for m, se in lz:
        assert abs(m - exact) < 4 * se + 0.02
    assert abs(lz[0][0] - lz[1][0]) < 4 * math.hypot(lz[0][1], lz[1][1]) + 0.02


def test_prior_fallback_on_unknown_address():
    eng = pcsis.CSIS(pm.gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=32,
                     device="cpu")
    params = eng.init(0)

    def other_model(y1, y2):
        mu = pt.sample(pd.Normal(1.0, 1.5), addr="other_mu")  # unknown address
        pt.observe(pd.Normal(mu, 2.0), y1, addr="y1")
        pt.observe(pd.Normal(mu, 2.0), y2, addr="y2")
        pt.predict(mu, "Mean")

    res = pt.sis(other_model, (3.0, 4.0), 1 << 15, 0, device="cpu",
                 proposal_messenger=eng.proposal_factory(params, (3.0, 4.0)))
    ref = pt.sis(other_model, (3.0, 4.0), 1 << 15, 0, device="cpu")
    assert torch.equal(res.log_weights, ref.log_weights)   # the prior, RN term zero
    assert abs(float(res.mean("Mean")) - 2.32353) < 0.05


def _bounded_model(kind):
    def model(y):
        if kind == "uniform":
            x = pt.sample(pd.Uniform(-2.0, 3.0), addr="x")
        elif kind == "truncated":
            x = pt.sample(pd.Truncated(pd.Normal(0.0, 2.0), -2.0, 3.0), addr="x")
        else:
            x = pt.sample(pd.Mixture(pd.Normal(np.array([-1.5, 1.5], np.float32),
                                               np.array([0.7, 0.7], np.float32)),
                                     np.array([0.5, 0.5], np.float32)), addr="x")
        pt.observe(pd.Normal(x, 0.3), y, addr="y")
        pt.predict(x, "X")
    return model


@pytest.mark.parametrize("kind", ["uniform", "truncated", "mixture", "mdn"])
def test_bounded_and_mixture_heads(kind):
    model = _bounded_model("mixture" if kind == "mdn" else kind)
    eng = pcsis.CSIS(model, (0.0,), embedding_dim=32, device="cpu",
                     mdn_components=3 if kind == "mdn" else 0)
    want = {"uniform": "uniform", "truncated": "uniform", "mixture": "mdn", "mdn": "mdn"}
    assert eng.structure.sites[0].kind == want[kind]
    params, losses = eng.compile(0, steps=200, batch_size=128)
    assert torch.isfinite(losses).all()
    res = eng.infer(params, (1.0,), 1 << 14, 1)
    xs = _np(res.predicts["X"])
    assert np.isfinite(_np(res.log_weights)).all()
    if kind in ("uniform", "truncated"):
        assert xs.min() >= -2.0 and xs.max() <= 3.0
    # the posterior sits near y = 1 (likelihood sd 0.3)
    assert abs(float(res.mean("X")) - 1.0) < 0.15


def test_infer_many_takes_a_model_that_branches_on_args():
    """The model of ``tests/test_csis.py::test_infer_falls_back_when_model_branches_on_args``
    through the port's ``infer_many``.  The JAX package's ``infer_many``
    lacks the eager fallback that its ``infer`` has (``csis.py:1131``); the
    port's runs the one eager path of ``infer``."""

    def m(y, flag):
        mu = pt.sample(pd.Normal(0.0, 2.0), addr="mu")
        if float(flag) > 0:  # Python branch on an argument
            pt.observe(pd.Normal(mu, 1.0), y, addr="y")
        else:
            pt.observe(pd.Normal(mu, 4.0), y, addr="y")
        pt.predict(mu, "Mu")

    eng = pcsis.CSIS(m, (0.0, 1.0), embedding_dim=32, device="cpu")
    params, _ = eng.compile(0, steps=20, batch_size=32)
    res = eng.infer(params, (2.0, 1.0), 500, 0)
    assert np.isfinite(_np(res.log_weights)).all()
    assert abs(float(res.mean("Mu"))) < 4.0
    many = eng.infer_many(params, (2.0, torch.tensor(-1.0)), 500, [0, 1])
    assert many.log_weights.shape == (2, 500)
    assert torch.isfinite(many.log_weights).all()


def test_no_card_raises_without_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        pcsis.CSIS(pm.gaussian_unknown_mean_readme, (0.0, 0.0))
    eng = pcsis.CSIS(pm.gaussian_unknown_mean_readme, (0.0, 0.0), embedding_dim=8,
                     device="cpu")
    class FakeMesh:                  # the mesh checks come before any collective
        device_type = "cuda"

        def size(self):
            return 4

        def get_local_rank(self):
            return 0

    with pytest.raises(ValueError, match="divide by mesh size 4"):
        eng.compile(0, steps=1, batch_size=6, mesh=FakeMesh())
    with pytest.raises(ValueError, match="mesh ranks on cuda"):
        eng.compile(0, steps=1, batch_size=8, mesh=FakeMesh())


def test_entry_twin_shapes():
    from cpprob_tpu_torch.entry import entry

    fn, args = entry(device="cpu")
    log_w, states = fn(*args)
    assert log_w.shape == (128,) and states.shape == (128, 8)
    assert torch.isfinite(log_w).all()
    assert states.min() >= 0 and states.max() <= 2


# ---------------------------------------------------------------------------
# weights carried across by checkpoint


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_carries_weights_across(direction, tmp_path):
    from cpprob_tpu.util import load_pytree as jload, save_pytree as jsave
    from cpprob_tpu_torch.util import load_pytree as pload, save_pytree as psave

    je, pe = _engines("hmm")
    values, obs = _jax_batch(je, 21)
    pv, po = _port_batch(pe, values, obs)
    if direction == "jax_to_port":
        jp, _ = je.compile(jax.random.key(2), steps=5, batch_size=32)
        path = jsave(str(tmp_path / "ck"), jp)
        pp = pload(path, pe.init(0))
        jl = jcsis.csis_loss(jp, je.structure, values, obs)
    else:
        pp, _ = pe.compile(2, steps=5, batch_size=32)
        path = psave(str(tmp_path / "ck"), pp)
        jp = jload(path, je.init(jax.random.key(0)))
        jl = jcsis.csis_loss(jp, je.structure, values, obs)
        pp = pload(path, pe.init(0))
    pl = pcsis.csis_loss(pp, pe.structure, pv, po)
    _close(pl, jl, 1e-5, direction)


# ---------------------------------------------------------------------------
# the rejection guard and tying (tests/test_rejection_guard.py, test_csis_tied.py)


def _truncated_guard_model():
    """x ~ N(0, 2) inside a guard accepting x > 1: the accepted draw is
    N(0, 2) truncated to (1, inf) (mean ~2.283), the first draw N(0, 2)."""
    x, _ = pt.guarded_rejection(pd.Normal(0.0, 2.0), lambda v: v > 1.0, addr="x",
                                max_iters=16)
    pt.predict(x, "X")
    return x


_ALPHA = 0.5
_LAMBDA = math.exp(-0.5 * _ALPHA ** 2) / math.sqrt(2 * math.pi) / (
    1 - 0.5 * (1 + math.erf(_ALPHA / math.sqrt(2))))
TRUNC_MEAN = 2.0 * _LAMBDA


def test_csis_through_the_rejection_guard():
    """Training sees the accepted draw (keep-last), so the proposal learns
    the truncated law, not the first-draw N(0, 2); guided inference draws
    every attempt of the guard from the one cached proposal."""
    eng = pcsis.CSIS(_truncated_guard_model, (), embedding_dim=32, device="cpu")
    params, losses = eng.compile(0, steps=1500, batch_size=128, learning_rate=3e-3)
    assert float(losses[-20:].mean()) < float(losses[:20].mean())
    spec = eng.structure.sites[0]
    assert spec.addr == "x" and spec.kind == "normal"
    msgr = eng.proposal_factory(params, ())()
    h, _ = msgr._first_step
    prop = pcsis.make_proposal_dist(spec, pnn.mlp_apply(params["heads"][spec.pkey], h))
    assert abs(float(prop.loc) - TRUNC_MEAN) < 0.4 and float(prop.scale) < 1.5
    res = eng.infer(params, (), 4096, 2)
    x = _np(res.predicts["X"])
    w = _w(res)
    assert abs(float((w * x).sum()) - TRUNC_MEAN) < 0.35
    assert x.min() > 1.0 - 1e-6 or w[x <= 1.0].sum() < 1e-3


def test_tied_params_constant_in_trace_length():
    s8 = pcsis.tie_structure(pcsis.discover_structure(pm.hmm, (np.zeros(8, np.float32),)))
    s64 = pcsis.tie_structure(pcsis.discover_structure(pm.hmm, (np.zeros(64, np.float32),)))
    assert s8.segments == ((0, 1), (1, 7))
    assert [x.addr for x in s8.sites] == [f"z[{t}]" for t in range(8)]
    g = lambda: torch.Generator().manual_seed(0)
    p8 = pcsis.init_csis_params(g(), s8, embedding_dim=16)
    p64 = pcsis.init_csis_params(g(), s64, embedding_dim=16)
    assert set(p8["heads"]) == set(p64["heads"]) == {"z[0]", "z[*]"}
    for k in ("heads", "value_emb", "lstm"):
        assert (sum(t.numel() for t in tree_leaves(p8[k]))
                == sum(t.numel() for t in tree_leaves(p64[k])))

"""The port's potential, HMC, ChEES and NUTS (``cpprob_tpu_torch.inference``)
against the JAX package's.

- Exact: the log-joint, potential, gradient, ``constrain`` and the
  inverse transforms at 16 numpy-seeded positions of five models; the
  dual-averaging update and the Welford recursion over fixed sequences;
  ``_halton``; ``_leaf_to_ckpt_idxs`` for every n < 1,024; the U-turn
  checks on random inputs.
- Pinned draws: one HMC transition (jitter on and off), one ChEES
  transition and one NUTS transition over 48 chains, where the reference's
  key chain is replayed with ``jax.random.split`` into the draws the
  port's kernel takes (``draws=``).  The NUTS case has chains that
  diverge, chains that reach the depth limit and chains that turn at
  other depths.
- Statistics: the README Gaussian's posterior moments at 64 chains, with
  ``tests/test_hmc_svi.py``'s and ``tests/test_nuts.py``'s tolerances.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpprob_tpu as jt
import cpprob_tpu.distributions as jd
import cpprob_tpu.models as jm
import cpprob_tpu_torch as pt
import cpprob_tpu_torch.distributions as pd
import cpprob_tpu_torch.models as pm
# the packages' ``inference.hmc`` and ``inference.nuts`` attributes are
# functions, not the modules
jchees, jhmc, jnuts, jpot = (importlib.import_module(f"cpprob_tpu.inference.{m}")
                             for m in ("chees", "hmc", "nuts", "potential"))
pchees, phmc, pnuts, ppot = (importlib.import_module(f"cpprob_tpu_torch.inference.{m}")
                             for m in ("chees", "hmc", "nuts", "potential"))

torch.set_num_threads(2)

README_MEAN, README_VAR = 2.32353, 1.05882
DATA = np.array([1, 1, 1, 0, 1, 1, 0, 1, 1, 1], np.int32)
PTS = np.array([[1, 2.1], [2, 3.9], [3, 5.3], [4, 7.7], [5, 10.2], [6, 12.9]], np.float32)


def _models(ct, D):
    """The same models written against either package."""

    def gamma():
        lam = ct.sample(D.Gamma(3.0, 2.0), addr="lam")
        ct.predict(lam, "Lam")

    def beta_bernoulli(y):
        p = ct.sample(D.Beta(2.0, 2.0), addr="p")
        for i in range(y.shape[0]):
            ct.observe(D.Bernoulli(p), y[i], addr=f"y[{i}]")

    def regression(points):
        a = ct.sample(D.Normal(0.0, 10.0), addr="a")
        b = ct.sample(D.Normal(0.0, 10.0), addr="b")
        for i in range(points.shape[0]):
            ct.observe(D.Normal(a * points[i, 0] + b, 1.0), points[i, 1], addr=f"y[{i}]")

    def interval():
        ct.sample(D.Uniform(2.0, 5.0), addr="x")
        ct.sample(D.Gamma(2.0, 1.0), addr="s")

    def correlated(y):
        x0 = ct.sample(D.Normal(0.0, 1.0), addr="x0")
        x1 = ct.sample(D.Normal(0.0, 1.0), addr="x1")
        ct.observe(D.Normal(x0 + x1, 0.5), y[0], addr="y0")
        ct.observe(D.Normal(x1, 0.5), y[1], addr="y1")

    def anisotropic():
        ct.sample(D.MultivariateNormalDiag(np.array([1.0, -2.0], np.float32),
                                           np.array([10.0, 0.1], np.float32)), addr="x")

    return {
        "readme": (ct.models.gaussian_unknown_mean_readme, (3.0, 4.0)),
        "gamma": (gamma, ()),
        "beta_bernoulli": (beta_bernoulli, (DATA,)),
        "regression": (regression, (PTS,)),
        "interval": (interval, ()),
        "correlated": (correlated, (np.array([1.5, -0.5], np.float32),)),
        "anisotropic": (anisotropic, ()),
    }


JMODELS = _models(jt, jd)
PMODELS = _models(pt, pd)


def _flats(name):
    model, args = JMODELS[name]
    jflat = jpot.flatten_model(model, args)
    model, args = PMODELS[name]
    return jflat, ppot.flatten_model(model, args, device="cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-5, what=""):
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


def _positions(dim, n=16, seed=0, scale=1.5, loc=0.0):
    return (np.random.RandomState(seed).randn(n, dim) * scale + loc).astype(np.float32)


@pytest.mark.parametrize("name", ["readme", "gamma", "beta_bernoulli", "regression", "interval"])
def test_potential_matches_reference(name):
    jflat, pflat = _flats(name)
    assert pflat.dim == jflat.dim
    assert [(l.addr, l.shape, l.size) for l in pflat.latents] == [
        (l.addr, tuple(l.shape), l.size) for l in jflat.latents]
    z = _positions(jflat.dim)
    zt = torch.as_tensor(z)
    _close(torch.func.vmap(pflat.log_joint)(zt), jax.vmap(jflat.log_joint)(z), what="log_joint")
    _close(torch.func.vmap(pflat.potential)(zt), jax.vmap(jflat.potential)(z), what="potential")
    g, u = ppot.batched_grad(pflat.potential)(zt)
    _close(g, jax.vmap(jax.grad(jflat.potential))(z), what="gradient")
    _close(u, jax.vmap(jflat.potential)(z), what="potential from the gradient")
    pc = torch.func.vmap(pflat.constrain)(zt)
    jc = jax.vmap(jflat.constrain)(z)
    for pl, jl in zip(pflat.latents, jflat.latents):
        _close(pc[pl.addr], jc[jl.addr], what=f"constrain {pl.addr}")
        _close(pl.transform.inverse(pc[pl.addr]), jl.transform.inverse(jc[jl.addr]),
               what=f"inverse transform {pl.addr}")


def test_discrete_site_rejected():
    def m():
        pt.sample(pd.Bernoulli(0.5), addr="b")

    with pytest.raises(ValueError, match="discrete/unsupported"):
        ppot.flatten_model(m, (), device="cpu")


def test_engines_need_the_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    model, args = PMODELS["readme"]
    for engine in (pt.hmc, pt.nuts, pchees.chees_hmc):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            engine(model, args, 0, n_warmup=1, n_samples=1)


def test_dual_averaging_and_welford_match_reference():
    acc = np.random.RandomState(1).uniform(0.0, 1.0, 60).astype(np.float32)
    js, ps = jhmc._dual_averaging_init(0.1), phmc._dual_averaging_init(0.1)
    for a in acc:
        js = jhmc._dual_averaging_update(js, jnp.float32(a), 0.8)
        ps = phmc._dual_averaging_update(ps, torch.tensor(a), 0.8)
        for k in js:
            _close(ps[k], js[k], 1e-6, k)
    # the reference's Welford lines (hmc.py:156-162), on chain means
    zs = np.random.RandomState(2).randn(40, 16, 3).astype(np.float32)
    mean, m2, n = np.zeros(3, np.float32), np.zeros(3, np.float32), np.float32(0)
    w = phmc._welford_init(3, "cpu")
    for z in zs:
        zm = z.mean(0)
        delta = zm - mean
        n = n + np.float32(1)
        mean = mean + delta / n
        m2 = m2 + delta * (zm - mean)
        w = phmc._welford_update(w, torch.as_tensor(z))
        inv = np.maximum(m2 / max(n - 1, 1), 1e-3) if n > 10 else np.ones(3)
        _close(w[0], mean, 1e-6)
        _close(w[1], m2, 1e-6)
        _close(phmc._welford_inv_mass(w), inv, 1e-6)


@pytest.mark.parametrize("base", [2, 3])
def test_halton_matches_reference(base):
    i = np.arange(5000, dtype=np.int32)
    got = pchees._halton(torch.as_tensor(i, dtype=torch.int64), base)
    np.testing.assert_array_equal(_np(got), np.asarray(jchees._halton(jnp.asarray(i), base)))


def test_leaf_to_ckpt_idxs_every_leaf_below_1024():
    n = np.arange(1024, dtype=np.int32)
    jmin, jmax = jax.jit(jax.vmap(jnuts._leaf_to_ckpt_idxs))(jnp.asarray(n))
    got = [pnuts._leaf_to_ckpt_idxs(int(k)) for k in n]
    np.testing.assert_array_equal(np.array([g[0] for g in got]), np.asarray(jmin))
    np.testing.assert_array_equal(np.array([g[1] for g in got]), np.asarray(jmax))
    tmin, tmax = pnuts._leaf_to_ckpt_idxs(torch.as_tensor(n, dtype=torch.int64))
    np.testing.assert_array_equal(_np(tmin), np.asarray(jmin))
    np.testing.assert_array_equal(_np(tmax), np.asarray(jmax))


def test_turning_checks_match_reference():
    rng = np.random.RandomState(3)
    dim, depth = 3, 6
    for trial in range(40):
        inv_mass = rng.uniform(0.2, 2.0, dim).astype(np.float32)
        r_l, r_r, r_s = (rng.randn(dim).astype(np.float32) for _ in range(3))
        assert bool(pnuts._is_turning(*(torch.as_tensor(a) for a in (inv_mass, r_l, r_r, r_s)))) \
            == bool(jnuts._is_turning(inv_mass, r_l, r_r, r_s))
        ck, cks = (rng.randn(depth + 1, dim).astype(np.float32) for _ in range(2))
        r, r_sum = (rng.randn(dim).astype(np.float32) for _ in range(2))
        leaf = 2 * trial + 1
        lo, hi = pnuts._leaf_to_ckpt_idxs(leaf)
        got = pnuts._iterative_turning(torch.as_tensor(inv_mass), list(torch.as_tensor(ck)),
                                       list(torch.as_tensor(cks)), torch.as_tensor(r),
                                       torch.as_tensor(r_sum), lo, hi)
        want = jnuts._iterative_turning(inv_mass, jnp.asarray(ck), jnp.asarray(cks), r, r_sum,
                                        lo, hi)
        assert bool(got) == bool(want), trial


# ---------------------------------------------------------------------------
# pinned-draw parity of one transition

C = 48


def _keys(seed):
    return jax.random.split(jax.random.key(seed), C)


def _correlated_state():
    """48 positions near the correlated model's posterior, a step at which
    about a third of the chains reject."""
    jflat, pflat = _flats("correlated")
    z = _positions(2, C, seed=4, scale=0.4, loc=np.array([1.31, -0.14]))
    return jflat, pflat, z, np.float32(0.5), np.array([1.0, 1.0], np.float32)


@pytest.mark.parametrize("jitter", [True, False])
def test_hmc_transition_with_pinned_draws(jitter):
    L = 16
    jflat, pflat, z, eps, inv_mass = _correlated_state()
    keys = _keys(5)
    want = jax.vmap(jhmc.make_hmc_kernel(jflat.potential, L, jitter),
                    in_axes=(0, 0, None, None))(keys, z, eps, inv_mass)

    def draws(key):
        k_mom, k_len, k_acc = jax.random.split(key, 3)
        return (jax.random.normal(k_mom, (2,)), jax.random.randint(k_len, (), 1, L + 1),
                jax.random.uniform(k_acc, ()))

    mom, n_sel, u = (torch.as_tensor(np.array(a)) for a in jax.vmap(draws)(keys))
    if not jitter:
        n_sel = torch.full((C,), L)
    got = phmc.make_hmc_kernel(pflat.potential, L, jitter)(
        None, torch.as_tensor(z), torch.tensor(eps), torch.as_tensor(inv_mass),
        draws=(mom, n_sel, u))
    for g, w, what in zip(got, want, ("z'", "accept", "U")):
        _close(g, w, 1e-5, what)
    moved = np.any(np.asarray(want[0]) != z, axis=1)
    assert 0 < moved.sum() < C, "every chain accepted or every chain rejected"


def _chees_reference_kernel(potential, max_leapfrog):
    """The reference's ChEES transition (``cpprob_tpu/inference/chees.py``
    ``kernel``, nested in ``chees_hmc``), transcribed."""
    grad_fn = jax.grad(potential)

    def kernel(key, z, eps, inv_mass, n_sel):
        k_mom, k_acc = jax.random.split(key)
        p = jax.random.normal(k_mom, z.shape) / jnp.sqrt(inv_mass)

        def body(carry, i):
            z_c, p_c, z_keep, p_keep = carry
            p_half = p_c - 0.5 * eps * grad_fn(z_c)
            z_n = z_c + eps * inv_mass * p_half
            p_n = p_half - 0.5 * eps * grad_fn(z_n)
            take = i + 1 == n_sel
            return (z_n, p_n, jnp.where(take, z_n, z_keep), jnp.where(take, p_n, p_keep)), None

        (_, _, z_new, p_new), _ = jax.lax.scan(body, (z, p, z, p), jnp.arange(max_leapfrog))

        def h(zz, pp):
            return potential(zz) + 0.5 * jnp.sum(inv_mass * pp * pp)

        log_accept = jnp.minimum(0.0, h(z, p) - h(z_new, p_new))
        log_accept = jnp.where(jnp.isnan(log_accept), -jnp.inf, log_accept)
        accept = jnp.log(jax.random.uniform(k_acc, ())) < log_accept
        return jnp.where(accept, z_new, z), z_new, p_new, jnp.exp(log_accept)

    return jax.vmap(kernel, in_axes=(0, 0, None, None, None))


def test_chees_transition_with_pinned_draws():
    L, n_sel = 32, 11
    jflat, pflat, z, eps, inv_mass = _correlated_state()
    keys = _keys(6)
    want = _chees_reference_kernel(jflat.potential, L)(keys, z, eps, inv_mass, n_sel)

    def draws(key):
        k_mom, k_acc = jax.random.split(key)
        return jax.random.normal(k_mom, (2,)), jax.random.uniform(k_acc, ())

    mom, u = (torch.as_tensor(np.array(a)) for a in jax.vmap(draws)(keys))
    got = pchees.make_chees_kernel(pflat.potential, L)(
        None, torch.as_tensor(z), torch.tensor(eps), torch.as_tensor(inv_mass),
        torch.tensor(n_sel), draws=(mom, u))
    for g, w, what in zip(got, want, ("z'", "z_prop", "p_prop", "accept")):
        _close(g, w, 1e-5, what)
    # the reference's criterion (chees.py:96-103) on the same transition
    zb, zpb = z.mean(0), np.asarray(want[1]).mean(0)
    dz = ((np.asarray(want[1]) - zpb) ** 2).sum(1) - ((z - zb) ** 2).sum(1)
    proj = ((np.asarray(want[1]) - zpb) * np.asarray(want[2])).sum(1)
    acc = np.asarray(want[3])
    g = pchees.chees_grad(torch.as_tensor(z), *got[1:4])
    _close(g, (acc * dz * proj).sum() / max(acc.sum(), 1e-6), 1e-4, "ChEES gradient")


def test_nuts_transition_with_pinned_draws():
    """48 chains at max_depth 6 on the anisotropic Gaussian with a step at
    the narrow scale's stability limit: some chains diverge, some reach the
    depth limit, the rest turn at other depths."""
    depth = 6
    jflat, pflat = _flats("anisotropic")
    z = (np.random.RandomState(0).randn(C, 2) * [10.0, 0.3] + [1.0, -2.0]).astype(np.float32)
    eps, inv_mass = np.float32(0.2), np.ones(2, np.float32)
    keys = _keys(7)
    want = jax.vmap(jnuts.make_nuts_kernel(jflat.potential, depth),
                    in_axes=(0, 0, None, None))(keys, z, eps, inv_mass)

    def draws(key):
        """The reference's key chain (nuts.py:178-227, :108-169)."""
        def leaf(k, _):
            k, k_acc = jax.random.split(k)
            return k, jax.random.uniform(k_acc, ())

        def doubling(key, _):
            key, k_dir, k_sub, k_bias = jax.random.split(key, 4)
            _, row = jax.lax.scan(leaf, k_sub, None, length=1 << (depth - 1))
            return key, (jax.random.bernoulli(k_dir, 0.5), jax.random.uniform(k_bias, ()), row)

        key, k_mom = jax.random.split(key)
        _, (dirs, bias, leaves) = jax.lax.scan(doubling, key, None, length=depth)
        return jax.random.normal(k_mom, (2,)), dirs, bias, leaves

    mom, dirs, bias, leaves = (torch.as_tensor(np.array(a))
                               for a in jax.jit(jax.vmap(draws))(keys))
    d = {"mom": mom, "dir": dirs, "bias": bias, "leaf": leaves}
    args = (None, torch.as_tensor(z), torch.tensor(eps), torch.as_tensor(inv_mass))
    got = pnuts.make_nuts_kernel(pflat.potential, depth)(*args, draws=d)
    _close(got[0], want[0], 1e-5, "z'")
    _close(got[1], want[1], 1e-5, "mean accept")
    # U = 50 (x1 + 2)^2 + ... magnifies z''s rounding 100 |x1 + 2|-fold: U is
    # held to the reference's potential at the port's own z'
    _close(got[2], jax.vmap(jflat.potential)(_np(got[0])), 1e-5, "U")
    tree = pnuts.make_nuts_tree(pflat.potential, depth)(*args, draws=d)
    div, leaves_n = _np(tree["diverging"]), _np(tree["num_leaves"])
    assert 0 < div.sum() < C
    assert (leaves_n[~div] == 1 << depth).any()
    assert len(np.unique(leaves_n[~div])) >= 4, np.unique(leaves_n)


# ---------------------------------------------------------------------------
# statistics


def _readme_moments(res):
    mus = _np(res.samples["mu"]).reshape(-1)
    assert abs(mus.mean() - README_MEAN) < 0.05
    assert abs(mus.var() - README_VAR) < 0.12
    return mus


def test_hmc_moments():
    model, args = PMODELS["readme"]
    res = pt.hmc(model, args, 0, n_chains=64, n_warmup=150, n_samples=100, max_leapfrog=8,
                 device="cpu")
    assert res.positions.shape == (64, 100, 1) and res.potential_energy.shape == (64, 100)
    _readme_moments(res)
    assert float(res.accept_rate.mean()) > 0.6


def test_chees_moments():
    model, args = PMODELS["readme"]
    res = pchees.chees_hmc(model, args, 1, n_chains=64, n_warmup=150, n_samples=50,
                           max_leapfrog=32, device="cpu")
    _readme_moments(res)
    assert float(res.accept_rate.mean()) > 0.5


def test_nuts_moments_and_host_reads():
    from cpprob_tpu_torch.distributions.base import HOST_READS

    model, args = PMODELS["readme"]
    before = HOST_READS["nuts"]
    res = pt.nuts(model, args, 2, n_chains=64, n_warmup=150, n_samples=100, max_depth=6,
                  device="cpu")
    _readme_moments(res)
    assert float(res.accept_rate.mean()) > 0.6
    # at least the first doubling's read a transition, and at most one a
    # doubling and one a leapfrog step
    reads = HOST_READS["nuts"] - before
    assert 250 <= reads <= 250 * (6 + (1 << 6))


@pytest.mark.cuda
def test_hmc_and_nuts_on_the_card_without_sync():
    """Every transition queues its work without a sync; NUTS's counted
    reads are the only ones (``host_any`` allows them under "error")."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    model, args = PMODELS["readme"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = pt.hmc(model, args, 0, n_chains=1024, n_warmup=50, n_samples=20)
        n = pt.nuts(model, args, 0, n_chains=1024, n_warmup=50, n_samples=20, max_depth=6)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for res in (h, n):
        assert res.positions.device.type == "cuda"
        assert torch.isfinite(res.positions).all()

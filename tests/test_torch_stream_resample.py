"""The port's resamplers (``cpprob_tpu_torch.inference.resampling``) and its
streaming resample epoch (``cpprob_tpu_torch.ops.stream_resample``) against
the JAX package.

On the CPU the epoch's wrappers run their plain PyTorch versions; the
Pallas kernels run in interpret mode.  The port's prefix and slot
arithmetic are float64 and the reference's float32, so start slots may
differ by one; pass 2 is held to the exact expansion of its own start
slots, and to the reference wherever the two sets of slots agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.inference import resampling as ref_rs
from cpprob_tpu.ops.pallas_resample import _pass1, _streaming_resample, logsumexp_stats
from cpprob_tpu_torch.inference import resampling as rs
from cpprob_tpu_torch.ops import stream_resample as sr

torch.set_num_threads(2)

TILE = 128 * 128          # the reference epoch's tile


def _weights_values(seed, n, spread=2.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, spread, n).astype(np.float32),
            rng.normal(0, 1, n).astype(np.float32))


def _expand(st, vals):
    """The exact expansion: slot i holds the value of the last j with
    st_j <= i."""
    n = len(vals)
    en = np.concatenate([st[1:], [n]])
    out = np.zeros(n, vals.dtype)
    for j in np.nonzero(en > st)[0]:
        out[st[j]:en[j]] = vals[j]
    return out


def _owners(st, n):
    return np.searchsorted(st, np.arange(n), side="right") - 1


def test_logsumexp_stats_matches_pallas():
    lw, _ = _weights_values(7, 2 * TILE, 3.0)
    m_j, wtot_j = logsumexp_stats(jnp.asarray(lw), interpret=True)
    stats = sr.logsumexp_stats_plain(torch.as_tensor(lw))
    assert stats.dtype == torch.float64 and stats.shape == (2,)
    assert float(stats[0]) == float(m_j)
    np.testing.assert_allclose(float(stats[1]), float(wtot_j), rtol=1e-5)
    assert torch.equal(sr.logsumexp_stats(torch.as_tensor(lw)), stats)


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_pass1_matches_pallas(n_tiles):
    n = TILE * n_tiles
    lw, vals = _weights_values(42, n)
    u0 = 0.61
    st_j, _ = _pass1(jnp.float32(u0), jnp.asarray(lw), jnp.asarray(vals),
                     interpret=True)
    lw_t = torch.as_tensor(lw)
    st = sr.resample_pass1(torch.tensor(u0, dtype=torch.float64), lw_t,
                           sr.logsumexp_stats(lw_t)).numpy()
    assert st.dtype == np.int32 and st[0] == 0
    assert np.all(np.diff(st) >= 0) and st.max() <= n
    diff = np.abs(st.astype(np.int64) - np.asarray(st_j).ravel())
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02
    # float64 against an independent numpy prefix
    w = np.exp(lw.astype(np.float64) - lw.max())
    prev = np.concatenate([[0.0], np.cumsum(w)[:-1]]) / w.sum()
    want = np.clip(np.ceil(n * prev - u0), 0, n)
    assert np.abs(st - want).max() <= 1 and (st != want).sum() <= 2


@pytest.mark.parametrize("n_tiles", [1, 3])
def test_pass2_is_exact_and_matches_pallas(n_tiles):
    n = TILE * n_tiles
    lw, vals = _weights_values(43 + n_tiles, n)
    u0 = 0.37
    lw_t, v_t = torch.as_tensor(lw), torch.as_tensor(vals)
    st = sr.resample_pass1(u0, lw_t, sr.logsumexp_stats(lw_t))
    out = sr.resample_pass2(st, v_t).numpy()
    np.testing.assert_array_equal(out, _expand(st.numpy(), vals))
    st_j, _ = _pass1(jnp.float32(u0), jnp.asarray(lw), jnp.asarray(vals),
                     interpret=True)
    out_j = np.asarray(_streaming_resample(
        jnp.float32(u0), jnp.asarray(lw), jnp.asarray(vals), interpret=True,
        impl="scatter"))
    same = _owners(st.numpy(), n) == _owners(np.asarray(st_j).ravel(), n)
    assert same.mean() > 0.98
    np.testing.assert_allclose(out[same], out_j[same], atol=1e-4)


def test_degenerate_one_heavy_particle():
    lw = np.full(TILE, -100.0, np.float32)
    lw[12345] = 0.0
    vals = np.arange(TILE, dtype=np.float32)
    key = torch.Generator().manual_seed(0)
    out = sr.streaming_systematic_resample_values(
        key, torch.as_tensor(lw), torch.as_tensor(vals)).numpy()
    assert (out == 12345.0).all()
    out_j = np.asarray(_streaming_resample(
        jnp.float32(0.5), jnp.asarray(lw), jnp.asarray(vals), interpret=True,
        impl="scatter"))
    assert (out_j == 12345.0).mean() > 0.999


def test_uniform_weights_identity():
    vals = np.random.default_rng(3).normal(0, 1, TILE).astype(np.float32)
    lw = torch.zeros(TILE)
    st = sr.resample_pass1(0.25, lw, sr.logsumexp_stats(lw))
    assert torch.equal(st, torch.arange(TILE, dtype=torch.int32))
    out = sr.resample_pass2(st, torch.as_tensor(vals)).numpy()
    np.testing.assert_array_equal(out, vals)
    out_j = np.asarray(_streaming_resample(
        jnp.float32(0.25), jnp.zeros(TILE, np.float32), jnp.asarray(vals),
        interpret=True, impl="scatter"))
    assert np.isclose(np.sort(out_j), np.sort(vals), atol=1e-4).mean() > 0.995


def test_epoch_with_the_flag_off_returns_the_population():
    lw, vals = _weights_values(5, 4096)
    lw_t, v_t = torch.as_tensor(lw), torch.as_tensor(vals)
    for flag, moved in ((0, False), (1, True)):
        f = torch.tensor(flag, dtype=torch.int32)
        out, lme = rs.continuous_resample_values_lme(
            torch.Generator().manual_seed(2), lw_t, v_t, flag=f)
        assert torch.equal(out, v_t) != moved
        np.testing.assert_allclose(
            float(lme), float(torch.logsumexp(lw_t.double(), 0) - np.log(4096)),
            rtol=1e-12)
    # non-float32 scalar states take the sorted fill, flag included
    out = rs.continuous_resample_values(torch.Generator().manual_seed(2),
                                        lw_t, v_t.double(),
                                        flag=torch.tensor(0, dtype=torch.int32))
    assert torch.equal(out, v_t.double())


def test_streaming_resample_is_unbiased():
    n = 2 * TILE
    lw, vals = _weights_values(0, n)
    out = sr.streaming_systematic_resample_values(
        torch.Generator().manual_seed(9), torch.as_tensor(lw),
        torch.as_tensor(vals)).numpy()
    w = np.exp(lw - lw.max())
    w /= w.sum()
    wmean = float((w * vals).sum())
    se = float(np.sqrt((w * (vals - wmean) ** 2).sum() / n)) + 1e-3
    assert abs(out.mean() - wmean) < 6 * se
    # each particle gets floor or ceil of n w_j copies (values = indices)
    idx = sr.streaming_systematic_resample_values(
        torch.Generator().manual_seed(9), torch.as_tensor(lw),
        torch.arange(n, dtype=torch.float32)).numpy()
    counts = np.bincount(idx.astype(np.int64), minlength=n)
    w64 = np.exp(lw.astype(np.float64) - lw.max())
    assert np.all(np.abs(counts - n * w64 / w64.sum()) < 1.0 + 1e-9)


def test_sorted_fill_matches_reference(monkeypatch):
    n = 4096
    lw, vals = _weights_values(11, n)
    key = jax.random.key(3)
    out_j = np.asarray(ref_rs.sorted_systematic_resample_values(
        key, jnp.asarray(lw), jnp.asarray(vals)))
    u0 = float(jax.random.uniform(key, ()))
    monkeypatch.setattr(rs, "_uniform", lambda k, device: torch.tensor(
        u0, dtype=torch.float64, device=device))
    out = rs.sorted_systematic_resample_values(
        None, torch.as_tensor(lw), torch.as_tensor(vals)).numpy()
    assert np.all(np.diff(out) >= 0)
    assert (out == out_j).mean() > 0.99


def _counts(draw, reps, n):
    return np.stack([np.bincount(np.asarray(draw(i)), minlength=n)
                     for i in range(reps)])


@pytest.mark.parametrize("name", ["stratified", "multinomial", "residual"])
def test_resamplers_match_reference_in_distribution(name):
    n, n_out, reps = 20, 2000, 64
    w = np.random.RandomState(0).dirichlet(np.ones(n))
    lw = np.log(w).astype(np.float32)
    port = rs.get_resampler(name)
    ref = jax.jit(lambda k: ref_rs.get_resampler(name)(k, jnp.asarray(lw), n_out))
    c_p = _counts(lambda i: port(torch.Generator().manual_seed(i),
                                 torch.as_tensor(lw), n_out).numpy(), reps, n)
    c_r = _counts(lambda i: ref(jax.random.key(i)), reps, n)
    assert c_p.shape == c_r.shape and (c_p.sum(1) == n_out).all()
    # unbiased: mean offspring counts n_out w_i, for both packages alike
    sd = np.sqrt(n_out * w * (1 - w) / reps) + 1e-3
    np.testing.assert_array_less(np.abs(c_p.mean(0) - n_out * w), 5 * sd)
    np.testing.assert_array_less(np.abs(c_p.mean(0) - c_r.mean(0)), 7 * sd)
    # the spread of the counts: the scheme's, not another's
    v_p, v_r = c_p.var(0).sum(), c_r.var(0).sum()
    assert 0.6 < (v_p + 1) / (v_r + 1) < 1.6, (v_p, v_r)
    if name == "stratified":
        assert np.all(np.abs(c_p - n_out * w) < 2.0)
    if name == "residual":      # the floor count (reference fault F4)
        assert np.all(c_p >= np.floor(n_out * w))


def test_residual_floor_count():
    """``tests/test_smc.py::test_residual`` with its assertion."""
    n = 512
    lw = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    anc = rs.residual_resample(torch.Generator().manual_seed(0), lw).numpy()
    assert anc.shape == (n,) and anc.min() >= 0 and anc.max() < n
    counts = np.bincount(anc, minlength=n)
    w = np.arange(1, n + 1) / (n * (n + 1) / 2)
    assert counts[-1] >= np.floor(n * w[-1]) == 1
    assert np.all(counts >= np.floor(n * w))

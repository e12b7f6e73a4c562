"""The port's fused HMM kernels (``cpprob_tpu_torch.ops.fused_hmm``) against
the JAX package's Pallas kernels.

On the CPU the wrappers run their plain PyTorch versions.  The Pallas
kernels run in interpret mode, which pins the transition draws to u = 0 and
the island offset to u0 = 0.5; the plain versions get the same pinned
draws.  Inputs are made with numpy from a seed and handed to both packages.
The kernels themselves are compared with the plain versions on the card
(the ``cuda`` test, run by ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cpprob_tpu.models.hmm import HMM_MEANS, HMM_TRANS
from cpprob_tpu.ops.pallas_hmm import pallas_hmm_fused_chunk, pallas_hmm_fused_init
from cpprob_tpu_torch.interop import population_from_numpy, spec_from_numpy
from cpprob_tpu_torch.ops import fused_hmm
from cpprob_tpu_torch.ops.fused_hmm import (
    hmm_chunk,
    hmm_chunk_plain,
    hmm_init,
    hmm_init_plain,
    stats_from_partials,
)
from cpprob_tpu_torch.ops.philox import philox4x32, philox_uniform

torch.set_num_threads(2)

N = 1 << 14
BLOCK_R = 64                 # JAX island = 64 * 128 = 8192 particles
ISLAND = BLOCK_R * 128
N_STEPS = 16
SPEC = spec_from_numpy(HMM_TRANS, HMM_MEANS, np.ones(3), np.full(3, 1 / 3))
_HALF_LOG_2PI = 0.5 * np.log(2 * np.pi)


def _assert_stats(rec, n, ess, cat_w, lme):
    ess_p, cat_p, lme_p = (x.numpy() for x in stats_from_partials(rec, n))
    np.testing.assert_allclose(ess_p, np.asarray(ess), rtol=1e-5)
    np.testing.assert_allclose(lme_p, np.asarray(lme), rtol=1e-5)
    np.testing.assert_allclose(cat_p, np.asarray(cat_w), atol=1e-6)


def test_init_matches_pallas_interpret():
    y0 = np.float32(0.37)
    s_j, w_j, ess, cat_w, lme = pallas_hmm_fused_init(
        jnp.int32(0), jnp.float32(y0), n=N, block_r=BLOCK_R, interpret=True)
    s, w, rec = hmm_init_plain(0, torch.tensor(y0), N, SPEC,
                               draws=torch.zeros(N))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-5)
    _assert_stats(rec, N, ess, cat_w, lme)


@pytest.mark.parametrize("island_every,island_thresh",
                         [(0, 0.5), (8, 0.0), (8, 2.0)])
@pytest.mark.parametrize("n_valid", [15, 2])
@pytest.mark.parametrize("flag", [0, 1])
def test_chunk_matches_pallas_interpret(flag, n_valid, island_every,
                                        island_thresh):
    rng = np.random.RandomState(100 + 10 * flag + n_valid)
    states = rng.randint(0, 3, N).astype(np.int32)
    log_w = (2.0 * rng.normal(size=N)).astype(np.float32)
    ys = rng.normal(size=N_STEPS).astype(np.float32)
    ticks = np.array([N // 3, 2 * N // 3], np.int32)
    s_j, w_j, ess, cat_w, lme, parts = pallas_hmm_fused_chunk(
        jnp.int32(0), jnp.asarray(states), jnp.asarray(log_w), jnp.asarray(ys),
        jnp.int32(n_valid), jnp.int32(flag), jnp.asarray(ticks),
        n_steps=N_STEPS, block_r=BLOCK_R, interpret=True,
        island_every=island_every, island_thresh=island_thresh,
        return_partials=True)

    s_t, w_t = population_from_numpy(states, log_w)
    ctrl = torch.tensor([flag, *ticks, n_valid], dtype=torch.int32)
    n_checks = 1 if island_every else 0      # t = 7 only
    draws = (torch.zeros(N_STEPS, N), torch.full((n_checks, N // ISLAND), 0.5))
    s, w, rec = hmm_chunk_plain(
        0, s_t, w_t, torch.as_tensor(ys), ctrl, SPEC,
        island_every=island_every, island_thresh=island_thresh,
        island_size=ISLAND, draws=draws)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=1e-5)
    _assert_stats(rec, N, ess, cat_w, lme)
    counts = rec[:, 6].numpy()
    np.testing.assert_array_equal(counts, np.asarray(parts)[::8, 6])
    fires = island_every and island_thresh > 1.0 and n_valid > 8
    np.testing.assert_array_equal(counts, np.full(N // ISLAND, float(fires)))


def _numpy_transitions(states, u):
    cdf = np.cumsum(HMM_TRANS.astype(np.float64), axis=1)[:, :-1]
    return (u[:, None] >= cdf[states]).sum(1)


def test_transition_and_emission_with_random_draws():
    rng = np.random.RandomState(5)
    n, steps = 8192, 4
    states = rng.randint(0, 3, n).astype(np.int32)
    log_w = rng.normal(size=n).astype(np.float32)
    ys = rng.normal(size=steps).astype(np.float32)
    u = rng.randint(0, 1 << 24, size=(steps, n)).astype(np.float32) / (1 << 24)
    s_t, w_t = population_from_numpy(states, log_w)
    ctrl = torch.tensor([0, 0, 0, steps], dtype=torch.int32)
    s, w, _ = hmm_chunk_plain(0, s_t, w_t, torch.as_tensor(ys), ctrl, SPEC,
                              island_size=n, draws=(torch.as_tensor(u), None))
    s_ref, w_ref = states.astype(np.int64), log_w.astype(np.float64)
    for t in range(steps):
        s_ref = _numpy_transitions(s_ref, u[t])
        w_ref = w_ref - 0.5 * (ys[t] - HMM_MEANS[s_ref].astype(np.float64)) ** 2 - _HALF_LOG_2PI
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_allclose(w.numpy(), w_ref, atol=1e-4)

    # init: state from the uniform initial CDF, t=0 emission
    u0 = torch.as_tensor(u[0])
    s0, w0, _ = hmm_init_plain(0, torch.tensor(ys[0]), n, SPEC, draws=u0)
    np.testing.assert_array_equal(
        s0.numpy(), (u[0][:, None] >= np.array([1 / 3, 2 / 3])).sum(1))
    np.testing.assert_allclose(
        w0.numpy(), -0.5 * (ys[0] - HMM_MEANS[s0.numpy()]) ** 2 - _HALF_LOG_2PI,
        atol=1e-5)


def test_tables_of_another_hmm():
    """A 4-state chain with its own stds and initial probabilities through
    spec_from_numpy: the plain chunk and init follow its tables."""
    rng = np.random.RandomState(8)
    K, n, steps = 4, 4096, 3
    trans = rng.dirichlet(np.ones(K), size=K)
    means, stds = rng.normal(size=K), rng.uniform(0.5, 2.0, K)
    init = rng.dirichlet(np.ones(K))
    spec = spec_from_numpy(trans, means, stds, init)
    assert spec.K == K and spec.packed().shape == (K * (K - 1) + 3 * K + K - 1,)
    states = rng.randint(0, K, n).astype(np.int32)
    ys = rng.normal(size=steps).astype(np.float32)
    u = rng.randint(0, 1 << 24, size=(steps, n)).astype(np.float32) / (1 << 24)
    s_t, w_t = population_from_numpy(states, np.zeros(n))
    ctrl = torch.tensor([0, 0, 0, 0, steps], dtype=torch.int32)
    s, w, rec = hmm_chunk_plain(0, s_t, w_t, torch.as_tensor(ys), ctrl, spec,
                                island_size=n, draws=(torch.as_tensor(u), None))
    cdf = np.cumsum(trans, axis=1)[:, :-1].astype(np.float32)
    s_ref, w_ref = states.astype(np.int64), np.zeros(n)
    for t in range(steps):
        s_ref = (u[t][:, None] >= cdf[s_ref]).sum(1)
        z = (ys[t] - means[s_ref]) / stds[s_ref]
        w_ref = w_ref - 0.5 * z * z - np.log(stds[s_ref]) - _HALF_LOG_2PI
    np.testing.assert_array_equal(s.numpy(), s_ref)
    np.testing.assert_allclose(w.numpy(), w_ref, atol=1e-4)
    assert rec.shape == (1, K + 4)
    s0, _, _ = hmm_init_plain(0, torch.tensor(ys[0]), n, spec,
                              draws=torch.as_tensor(u[0]))
    icdf = np.cumsum(init)[:-1].astype(np.float32)
    np.testing.assert_array_equal(s0.numpy(), (u[0][:, None] >= icdf).sum(1))


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, key, want):
    out = philox4x32(*counter, *key)
    assert tuple(int(o) for o in out) == want


def test_philox_uniforms():
    n = 1 << 16
    u = philox_uniform(12345, torch.arange(n), 3, 0).numpy()
    assert u.dtype == np.float32
    assert (u >= 0).all() and (u < 1).all()
    assert abs(u.mean() - 0.5) < 4 * np.sqrt(1 / 12 / n)
    hist = np.histogram(u, bins=16, range=(0, 1))[0]
    expect = n / 16
    assert np.all(np.abs(hist - expect) < 5 * np.sqrt(expect))
    # another time step or stream draws other numbers
    assert not np.array_equal(u, philox_uniform(12345, torch.arange(n), 4, 0).numpy())
    assert not np.array_equal(u, philox_uniform(12345, torch.arange(n), 3, 1).numpy())


@pytest.mark.parametrize("s0", [0, 1, 2])
def test_seeded_transition_frequencies(s0):
    n = 1 << 15
    states = torch.full((n,), s0, dtype=torch.int32)
    ctrl = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    s, _, _ = hmm_chunk(7, states, torch.zeros(n), torch.tensor([0.3]), ctrl,
                        SPEC)
    freq = np.bincount(s.numpy(), minlength=3) / n
    np.testing.assert_allclose(freq, HMM_TRANS[s0], atol=0.01)


def test_wrappers_dispatch_cpu_to_plain_and_check_inputs():
    y0 = torch.tensor(0.2)
    for a, b in zip(hmm_init(3, y0, 4096, SPEC), hmm_init_plain(3, y0, 4096, SPEC)):
        assert torch.equal(a, b)
    ctrl = torch.tensor([0, 0, 0, 2], dtype=torch.int32)
    s, w = torch.zeros(4096, dtype=torch.int32), torch.zeros(4096)
    with pytest.raises(ValueError):          # not a multiple of the island
        hmm_chunk(3, s[:1000], w[:1000], torch.zeros(2), ctrl, SPEC)
    with pytest.raises(ValueError):          # ctrl of the wrong length
        hmm_chunk(3, s, w, torch.zeros(2), ctrl[:3], SPEC)
    # no kernel launched on the CPU
    before = dict(fused_hmm.LAUNCHES)
    hmm_chunk(3, s, w, torch.zeros(2), ctrl, SPEC)
    assert fused_hmm.LAUNCHES == before


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    import chip_smoke

    errs = chip_smoke.check_kernels(1 << 16)
    assert errs["init"] < 1e-4 and errs["chunk"] < 1e-3

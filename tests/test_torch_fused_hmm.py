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
    ISLAND_SIZE,
    hmm_chunk,
    hmm_chunk_plain,
    hmm_init,
    hmm_init_plain,
    stats_from_partials,
)
from cpprob_tpu_torch.ops.philox import (
    philox4x32,
    philox_uniform,
    philox_uniforms4,
    split_seed,
    uniform_from_bits,
)

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

    s_t, w_t = population_from_numpy(states, log_w, device="cpu")
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
    s_t, w_t = population_from_numpy(states, log_w, device="cpu")
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
    s_t, w_t = population_from_numpy(states, np.zeros(n), device="cpu")
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


# --------------------------------------------------------------------------
# the transition draws: four steps from each Philox call


def _chain_spec(K):
    rng = np.random.RandomState(30 + K)
    return spec_from_numpy(rng.dirichlet(np.ones(K), size=K), 2 * rng.normal(size=K),
                           rng.uniform(0.5, 1.5, K), rng.dirichlet(np.ones(K)))


def test_philox_uniforms4_are_the_four_words():
    g = torch.arange(1000)
    u4 = philox_uniforms4(99, g, 7, 2)
    words = philox4x32(g, 7, 2, 0, *split_seed(99))
    assert u4.shape == (4, 1000) and u4.dtype == torch.float32
    for j in range(4):
        assert torch.equal(u4[j], uniform_from_bits(words[j]))
    assert torch.equal(u4[0], philox_uniform(99, g, 7, 2))


@pytest.mark.parametrize("ta", [4, 5, 6, 7, 9])
def test_plain_draw_is_word_t_mod_4_of_the_group_counter(ta):
    """A one-step chunk at absolute step ta moves particle g with word
    ta & 3 of Philox at (g, ta >> 2, 2, 0): its next states are that
    uniform's against the transition CDF, and no other word's."""
    n, seed = ISLAND_SIZE, 4242
    rng = np.random.RandomState(ta)
    s0 = torch.as_tensor(rng.randint(0, 3, n).astype(np.int32))
    ctrl = torch.tensor([0, 0, 0, 1], dtype=torch.int32)
    s, _, _ = hmm_chunk_plain(seed, s0, torch.zeros(n), torch.tensor([0.4]), ctrl,
                              SPEC, t0=ta)
    assert fused_hmm.TRANSITION_STREAM == 2
    words = philox4x32(torch.arange(n), ta >> 2, 2, 0, *split_seed(seed))
    cdf = torch.as_tensor(SPEC.trans_cdf)[s0.long()]
    moved = [(uniform_from_bits(x)[:, None] >= cdf).sum(1) for x in words]
    assert torch.equal(s.long(), moved[ta & 3])
    assert not any(torch.equal(s.long(), m) for j, m in enumerate(moved) if j != ta & 3)


def test_init_island_and_transition_counters_never_coincide():
    """Over a sweep's range (two islands, absolute steps 1 to 63) the init
    draws (g >> 2, 0, 0), the island offsets (island, t, 1) and the
    transition groups (g, t >> 2, 2) are disjoint sets of counters, each
    particle takes an init (counter, word) of its own, and each (particle,
    step) a transition (counter, word) of its own."""
    n, T = 2 * ISLAND_SIZE, 64
    gg, tt = np.meshgrid(np.arange(n), np.arange(1, T), indexing="ij")
    gg, tt = gg.ravel().tolist(), tt.ravel().tolist()
    init = {(g >> 2, 0, fused_hmm.INIT_STREAM) for g in range(n)}
    island = {(i, t, fused_hmm.ISLAND_STREAM)
              for i in range(n // ISLAND_SIZE) for t in range(1, T)}
    trans = {(g, t >> 2, fused_hmm.TRANSITION_STREAM) for g, t in zip(gg, tt)}
    assert not init & island and not init & trans and not island & trans
    assert len(init) == n // 4 and len({(g >> 2, g & 3) for g in range(n)}) == n
    assert len({(g, t >> 2, t & 3) for g, t in zip(gg, tt)}) == len(gg)
    assert len(trans) == n * 16          # groups 0 .. 15


@pytest.mark.parametrize("n", [4096, 4099, 5, 1])
def test_init_state_is_word_g_mod_4_of_the_quad_counter(n):
    """The plain init draws particle g's uniform from word g & 3 of Philox
    at (g >> 2, 0, 0, 0), four particles a call, ragged n included: its
    states are those uniforms against the initial CDF."""
    seed = 777
    spec = _chain_spec(5)
    s, w, rec = hmm_init_plain(seed, torch.tensor(0.3), n, spec)
    g = torch.arange(n)
    words = philox4x32(g >> 2, 0, fused_hmm.INIT_STREAM, 0, *split_seed(seed))
    u = torch.stack([uniform_from_bits(x) for x in words])[g & 3, g]
    assert torch.equal(fused_hmm.init_uniforms(seed, n, "cpu"), u)
    want = (u[:, None] >= torch.as_tensor(spec.init_cdf)[None, :]).sum(1)
    assert s.dtype == torch.int32 and torch.equal(s.long(), want)
    assert s.shape == w.shape == (n,) and rec.shape == (1, 5 + 4)
    # the quads' words, not one call a particle
    assert not torch.equal(u, philox_uniform(seed, g, 0, fused_hmm.INIT_STREAM)) or n == 1


def _host_init_record(tmp_path):
    """The init kernels' record arithmetic (``init_record`` of
    ``csrc/fused_hmm.cu``, cut from the source) compiled as host C++."""
    import ctypes
    import re
    import shutil
    import subprocess
    from pathlib import Path

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    cu = (Path(fused_hmm.__file__).parent / "csrc" / "fused_hmm.cu").read_text()
    fn = re.search(r"__device__ __forceinline__ void init_record\(.*?\n}\n", cu, re.S)
    src = ("#include <math.h>\n#define __device__\n#define __forceinline__ inline\n"
           + fn.group(0)
           + 'extern "C" void run(const int* h, const float* e, int K, float* out) '
           "{ init_record(h, e, K, out); }\n")
    (tmp_path / "r.cpp").write_text(src)
    subprocess.run([cxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
                    "-o", str(tmp_path / "r.so"), str(tmp_path / "r.cpp")],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(tmp_path / "r.so"))

    def record(hist, emis):
        K = len(hist)
        out = np.empty(K + 4, np.float32)
        lib.run(np.ascontiguousarray(hist, np.int32).ctypes.data_as(ctypes.c_void_p),
                np.ascontiguousarray(emis, np.float32).ctypes.data_as(ctypes.c_void_p),
                ctypes.c_int(K), out.ctypes.data_as(ctypes.c_void_p))
        return torch.as_tensor(out)

    return record


@pytest.mark.parametrize("K", [1, 3, 5, 12])
def test_init_record_from_counts_matches_records(K, tmp_path):
    """The init kernels form a CTA's record from its state counts (every
    particle in state k carries the t = 0 weight e_k): (max e_k over the
    states present, sum c_k x_k, sum c_k x_k^2, c_k x_k, 0), x_k = exp(e_k -
    max).  Held to ``_records`` of the plain version (float32 sums over
    the particles) at ``chip_smoke.py``'s ``_close_stats`` tolerances, on a
    CTA's share of the main path's init (about 2^16 particles), with a
    state left absent."""
    record = _host_init_record(tmp_path)
    spec = _chain_spec(K) if K > 1 else spec_from_numpy([[1.0]], [0.3], [1.2], [1.0])
    n = 63_551
    y0 = torch.tensor(0.8)
    s, w, rec_p = hmm_init_plain(11, y0, n, spec)
    if K > 2:      # a state no particle takes: its emission must not set the max
        keep = s != int(torch.argmax(fused_hmm._emission(spec.tables("cpu"), y0)))
        s, w = s[keep], w[keep]
        rec_p = fused_hmm._records(w[None], s[None], K, torch.zeros(1))
    hist = np.bincount(s.numpy(), minlength=K)
    emis = fused_hmm._emission(spec.tables("cpu"), y0).numpy()
    rec_k = record(hist, emis)[None]
    m = s.shape[0]
    ess_k, cat_k, lme_k = stats_from_partials(rec_k, m)
    ess_p, cat_p, lme_p = stats_from_partials(rec_p, m)
    torch.testing.assert_close(ess_k, ess_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(lme_k, lme_p, rtol=1e-4, atol=0)
    torch.testing.assert_close(cat_k, cat_p, rtol=0, atol=1e-4)
    assert float(rec_k[0, 0]) == float(w.max()) and float(rec_k[0, -1]) == 0.0


def _one_step_launches(run, s, w, ys, ctrl, K, t0):
    """The steps of a chunk launched one at a time, up to n_valid: the
    chunk's flag and ticks on the first launch, flag 0 after."""
    rec = None
    for t in range(int(ctrl[K])):
        c = ctrl.clone()
        c[K] = 1
        if t:
            c[0] = 0
        s, w, rec = run(s, w, ys[t:t + 1], c, t0 + t)
    return s, w, rec


def pinned_step_draws(seed, n, t0, steps, island_every):
    """The draws of a chunk from step t0, taken step by step: ``(u, u0)``
    for ``draws=``, u[t] word (t0 + t) & 3 of (g, (t0 + t) >> 2, 2, 0), one
    u0 row (island, t0 + t, 1, 0) per check."""
    g = torch.arange(n)
    u = torch.stack([philox_uniforms4(seed, g, (t0 + t) >> 2, 2)[(t0 + t) & 3]
                     for t in range(steps)])
    checks = [t for t in range(steps - 1) if (t + 1) % island_every == 0]
    u0 = torch.stack([philox_uniform(seed, torch.arange(n // ISLAND_SIZE), t0 + t, 1)
                      for t in checks])
    return u, u0


CHECKS = {"none": (0, 0.5), "silent": (3, 0.0), "firing": (3, 2.0)}


@pytest.mark.parametrize("checks", list(CHECKS))
@pytest.mark.parametrize("t0", [4, 5, 6, 7])
@pytest.mark.parametrize("K", [3, 5, 12])
def test_chunk_equals_its_steps_one_at_a_time(K, t0, checks):
    """A chunk starting at t0 = 0, 1, 2, 3 (mod 4), with n_valid 6 of 8
    cutting a group of four steps, against its steps launched one at a
    time, bit for bit: without island checks, and with a check every 3
    steps that never fires (thresh 0: the kernels end a tile there and
    draw the cut group again).  With a check that fires (thresh 2), against
    the same chunk on the per-step draws pinned through ``draws=``."""
    n, steps, n_valid, seed = 2 * ISLAND_SIZE, 8, 6, 77
    spec = SPEC if K == 3 else _chain_spec(K)
    rng = np.random.RandomState(10 * K + t0)
    s0 = torch.as_tensor(rng.randint(0, K, n).astype(np.int32))
    w0 = torch.as_tensor(rng.normal(size=n).astype(np.float32))
    ys = torch.as_tensor(rng.normal(size=steps).astype(np.float32))
    ctrl = torch.tensor([1, *[n * (k + 1) // K for k in range(K - 1)], n_valid],
                        dtype=torch.int32)
    every, thresh = CHECKS[checks]
    out = hmm_chunk_plain(seed, s0, w0, ys, ctrl, spec, t0=t0,
                          island_every=every, island_thresh=thresh)
    if checks == "firing":
        ref = hmm_chunk_plain(seed, s0, w0, ys, ctrl, spec, t0=t0,
                              island_every=every, island_thresh=thresh,
                              draws=pinned_step_draws(seed, n, t0, steps, every))
        assert float(out[2][:, -1].min()) == 1.0    # the t = 2 check, every island
    else:
        ref = _one_step_launches(
            lambda s, w, y, c, t: hmm_chunk_plain(seed, s, w, y, c, spec, t0=t),
            s0, w0, ys, ctrl, K, t0)
        assert float(out[2][:, -1].max()) == 0.0
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_chain_parts_variants_find_their_lines(tmp_path):
    """``util/chain_parts.py`` (the card's comparison of the chain kernels'
    designs) builds its variants by substituting one line of
    ``csrc/fused_hmm.cu`` each: each still finds its line, only ``kept`` is
    the source unchanged, and the headers are included from the source's
    own directory."""
    from cpprob_tpu_torch.util import chain_parts

    kept = chain_parts.variant_source(chain_parts.VARIANTS["kept"])
    assert f'#include "{chain_parts._CSRC.resolve()}/philox.cuh"' in kept
    for name, subs in chain_parts.VARIANTS.items():
        text = chain_parts.variant_source(subs)
        assert (text == kept) == (name == "kept")
    assert "constexpr int kTile = 4;" in chain_parts.variant_source(
        chain_parts.VARIANTS["tile4"])
    (tmp_path / "fused_hmm.cu").write_text(
        (chain_parts._CSRC / "fused_hmm.cu").read_text().replace("kTile = 32;", "kTile = 64;"))
    assert f'#include "{tmp_path.resolve()}/' in chain_parts.variant_source([], tmp_path)
    with pytest.raises(ValueError, match="is gone"):
        chain_parts.variant_source(chain_parts.VARIANTS["tile4"], tmp_path)


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

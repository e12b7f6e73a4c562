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
    """The port's float64 (m, wtot) against the reference kernel's float32
    pair (the reference's own test holds its wtot to XLA's at the same
    rtol, tests/test_pallas_resample.py:148) and against an independent
    numpy float64 sum; every message carries the numbers."""
    lw, _ = _weights_values(7, 2 * TILE, 3.0)
    m_j, wtot_j = logsumexp_stats(jnp.asarray(lw), interpret=True)
    stats = sr.logsumexp_stats_plain(torch.as_tensor(lw))
    exact = np.exp(lw.astype(np.float64) - lw.max()).sum()
    said = (f"reference (m, wtot) = ({float(m_j)!r}, {float(wtot_j)!r}); port "
            f"{stats.tolist()}; numpy float64 wtot {exact!r}")
    assert stats.dtype == torch.float64 and stats.shape == (2,), said
    assert float(stats[0]) == float(m_j) == float(lw.max()), said
    np.testing.assert_allclose(float(stats[1]), exact, rtol=1e-12, err_msg=said)
    np.testing.assert_allclose(float(stats[1]), float(wtot_j), rtol=1e-5, err_msg=said)
    assert torch.equal(sr.logsumexp_stats(torch.as_tensor(lw)), stats), said


def test_logsumexp_stats_first_call_in_a_fresh_process():
    """The port's first float64 statistics of a process, at the default
    intra-op thread count, against an independent numpy float64 sum at
    1e-12, and equal to a second call: importing the port makes PyTorch's
    first multi-threaded CPU ``exp`` (``util/cpu_math.py``), which can be
    wrong in one thread's chunk where every later one is exact."""
    import os
    import subprocess
    import sys

    code = (
        "import numpy as np, torch\n"
        "from cpprob_tpu_torch.ops import stream_resample as sr\n"
        "lw = np.random.default_rng(7).normal(0, 3.0, 8 * 32768).astype(np.float32)\n"
        "stats = sr.logsumexp_stats_plain(torch.as_tensor(lw))\n"
        "exact = np.exp(lw.astype(np.float64) - lw.max()).sum()\n"
        "np.testing.assert_allclose(float(stats[1]), exact, rtol=1e-12)\n"
        "assert torch.equal(sr.logsumexp_stats_plain(torch.as_tensor(lw)), stats)\n"
        "print(torch.get_num_threads())\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("seed", [0, 1])
def test_first_exp_after_the_import_is_exact(seed):
    """``util/first_exp.py``'s fresh process with the port imported: its
    first float32 (seed 0: float64 first) and float64 ``exp`` within 4 ulp
    and 1e-13 of numpy's."""
    from cpprob_tpu_torch.util import first_exp

    got = first_exp.first_exp_errors(True, seed)
    assert got["first"] == ("float64" if seed == 0 else "float32")
    assert got["float32"] <= 2.4e-7 and got["float64"] <= 1e-13, got


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


# ---------------------------------------------------------------------------
# the pass-2 variants fast and merge (pass2_tile_kernel)


def _tile_transpose(x):
    """The merge layout of a row-major expansion: slot og*128 + s of tile t
    at t*16384 + s*128 + og."""
    return x.reshape(-1, 128, 128).transpose(0, 2, 1).reshape(-1)


@pytest.mark.parametrize("impl", ["fast", "merge"])
@pytest.mark.parametrize("n_tiles", [1, 3])
def test_pass2_variants_match_pallas(n_tiles, impl):
    """The port's pass 2 on the reference's own start slots against the
    reference's variant, within its telescoping error (1e-4,
    tests/test_pallas_resample.py:59); the layout exactly."""
    n = TILE * n_tiles
    lw, vals = _weights_values(60 + n_tiles, n)
    u0 = 0.61
    st_j, _ = _pass1(jnp.float32(u0), jnp.asarray(lw), jnp.asarray(vals),
                     interpret=True)
    st = torch.as_tensor(np.array(st_j).ravel())
    out = sr.resample_pass2(st, torch.as_tensor(vals), impl=impl).numpy()
    want = _expand(st.numpy(), vals)
    if impl == "merge":
        want = _tile_transpose(want)
    np.testing.assert_array_equal(out, want)
    out_j = np.asarray(_streaming_resample(
        jnp.float32(u0), jnp.asarray(lw), jnp.asarray(vals), interpret=True,
        impl=impl))
    np.testing.assert_allclose(out, out_j, rtol=0, atol=1e-4)


@pytest.mark.parametrize("impl", ["fast", "merge"])
def test_pass2_variants_flag_and_heavy_particle(impl):
    n = 2 * TILE
    lw, vals = _weights_values(70, n)
    lw_t, v_t = torch.as_tensor(lw), torch.as_tensor(vals)
    st = sr.resample_pass1(0.3, lw_t, sr.logsumexp_stats(lw_t))
    scatter = sr.resample_pass2(st, v_t).numpy()
    for flag, want in ((0, vals), (1, scatter if impl == "fast"
                                    else _tile_transpose(scatter))):
        got = sr.resample_pass2(st, v_t, torch.tensor(flag, dtype=torch.int32),
                                impl=impl).numpy()
        np.testing.assert_array_equal(got, want)
    heavy = np.full(n, -100.0, np.float32)
    heavy[12345] = 0.0
    out = sr.streaming_systematic_resample_values(
        torch.Generator().manual_seed(0), torch.as_tensor(heavy),
        torch.arange(n, dtype=torch.float32), impl=impl).numpy()
    assert (out == 12345.0).all()
    out_j = np.asarray(_streaming_resample(
        jnp.float32(0.5), jnp.asarray(heavy), jnp.arange(n, dtype=jnp.float32),
        interpret=True, impl=impl))
    assert (out_j == 12345.0).mean() > 0.999


@pytest.mark.parametrize("impl", ["scatter", "fast", "merge"])
def test_streaming_epoch_by_variant_matches_pallas(impl):
    """The slice as a whole: the port's epoch (its own comb offset, float64
    slots) against the reference's epoch at the same offset, on the slots
    whose owners agree."""
    n = 2 * TILE
    lw, vals = _weights_values(80, n)
    gen = torch.Generator().manual_seed(5)
    u0 = float(torch.rand((), generator=torch.Generator().manual_seed(5),
                          dtype=torch.float64))
    out = sr.streaming_systematic_resample_values(
        gen, torch.as_tensor(lw), torch.as_tensor(vals), impl=impl).numpy()
    out_j = np.asarray(_streaming_resample(
        jnp.float32(u0), jnp.asarray(lw), jnp.asarray(vals), interpret=True,
        impl=impl))
    lw_t = torch.as_tensor(lw)
    st = sr.resample_pass1(u0, lw_t, sr.logsumexp_stats(lw_t)).numpy()
    st_j, _ = _pass1(jnp.float32(u0), jnp.asarray(lw), jnp.asarray(vals),
                     interpret=True)
    same = _owners(st, n) == _owners(np.asarray(st_j).ravel(), n)
    if impl == "merge":
        same = _tile_transpose(same)
    assert same.mean() > 0.98
    np.testing.assert_allclose(out[same], out_j[same], rtol=0, atol=1e-4)


def test_pass2_variants_validate():
    st = torch.zeros(TILE + 128, dtype=torch.int32)
    v = torch.zeros(TILE + 128)
    with pytest.raises(ValueError, match="multiple of 16384"):
        sr.resample_pass2(st, v, impl="merge")
    with pytest.raises(ValueError, match="multiple of 16384"):
        sr.streaming_systematic_resample_values(
            torch.Generator().manual_seed(0), v, v, impl="merge")
    with pytest.raises(ValueError, match="impl must be one of"):
        sr.resample_pass2(st, v, impl="sorted")
    # fast takes a ragged last tile
    out = sr.resample_pass2(torch.arange(TILE + 128, dtype=torch.int32), v + 2,
                            impl="fast")
    assert torch.equal(out, v + 2)


@pytest.mark.parametrize("impl", ["scatter", "fast", "merge"])
def test_pass2_first_start_slot_past_zero(impl):
    """Start slots whose first is past slot 0 (``resample_pass2`` takes any
    monotone int32 slots): the slots before it take input 0's value in every
    variant."""
    n = 2 * TILE
    lw, vals = _weights_values(75, n)
    lw_t, v_t = torch.as_tensor(lw), torch.as_tensor(vals)
    st = torch.clamp(sr.resample_pass1(0.3, lw_t, sr.logsumexp_stats(lw_t)) + 5,
                     max=n)
    assert int(st[0]) == 5
    want = _expand(st.numpy(), vals)
    want[:5] = vals[0]
    if impl == "merge":
        want = _tile_transpose(want)
    np.testing.assert_array_equal(sr.resample_pass2(st, v_t, impl=impl).numpy(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3 * TILE, 3 * TILE + 77])
def test_pass2_tile_kernel_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    lw, vals = (torch.as_tensor(a, device=dev) for a in _weights_values(90, n))
    st = sr.resample_pass1(0.4, lw, sr.logsumexp_stats(lw))
    # the start slots as pass 1 gives them, and shifted past slot 0
    for s in (st, torch.clamp(st + 5, max=n)):
        for impl in sr.IMPLS if n % TILE == 0 else ("scatter", "fast"):
            assert torch.equal(sr.resample_pass2(s, vals, impl=impl),
                               sr.resample_pass2_plain(s, vals, impl=impl))


# ---------------------------------------------------------------------------
# pass 1 as one single-pass scan (pass1_scan_kernel): a race in its
# look-back shows only as an intermittent mismatch, so each case runs the
# kernel many times


def _pass1_card_case(lw, u0=0.37, flag=None):
    stats = sr.logsumexp_stats(lw)
    u0 = torch.tensor(u0, dtype=torch.float64, device=lw.device)
    st = sr.resample_pass1(u0, lw, stats, flag)
    want = sr.resample_pass1_plain(u0, lw, stats)
    # float64 sums in another order (the tile scan, the reciprocal of wtot):
    # at most 16 slots of 2^24 may move, as chip_smoke.py's PASS1_SLACK
    assert int((st != want).sum()) <= 16
    assert bool((st[1:] >= st[:-1]).all()) and int(st[0]) == 0
    return st


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4097, (1 << 20) + 3, 1 << 24])
def test_pass1_scan_kernel_on_the_card(n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pass1_scan_kernel runs only on the card")
    gen = torch.Generator(device="cuda").manual_seed(n)
    lw = 2 * torch.randn(n, generator=gen, device="cuda")
    first = _pass1_card_case(lw)
    assert torch.equal(sr.resample_pass1(0.37, lw, sr.logsumexp_stats(lw)), first)


def _lse_card_case(lw, flag=None):
    """K14 against its plain version: the max bit-equal, wtot within rtol
    1e-12 (chip_smoke.py's check), and a second call bit-equal."""
    got = sr.logsumexp_stats(lw, flag)
    want = sr.logsumexp_stats_plain(lw)
    assert float(got[0]) == float(want[0]), (got, want)
    torch.testing.assert_close(got[1], want[1], rtol=1e-12, atol=0)
    assert torch.equal(sr.logsumexp_stats(lw, flag), got)
    return got


@pytest.mark.cuda
def test_lse_stats_kernel_on_the_card():
    """K14 (one launch, the combine by the last CTA) at 2^24, at 2^24 - 3
    (a ragged tail), on a view at a one-float offset (a scalar head), with
    a block of -inf weights, and with the flag 0 (no record written, the
    ticket left at 0) and then 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: lse_stats_kernel runs only on the card")
    from cpprob_tpu_torch.ops.population import current_stream

    n = 1 << 24
    gen = torch.Generator(device="cuda").manual_seed(11)
    lw = 2 * torch.randn(n, generator=gen, device="cuda")
    first = _lse_card_case(lw)
    for _ in range(16):
        assert torch.equal(sr.logsumexp_stats(lw), first)
    _lse_card_case(2 * torch.randn(n - 3, generator=gen, device="cuda"))
    _lse_card_case(lw[1:])
    holes = lw.clone()
    holes[n // 3: n // 3 + 1_000_003] = -float("inf")
    _lse_card_case(holes)
    dev = lw.device
    rec_m, rec_s, ticket = sr._LSE_SCRATCH[(dev, current_stream(dev).value)]
    before = (rec_m.clone(), rec_s.clone())
    off, on = (torch.tensor(f, dtype=torch.int32, device="cuda") for f in (0, 1))
    sr.logsumexp_stats(lw, off)
    assert int(ticket) == 0
    assert torch.equal(rec_m, before[0]) and torch.equal(rec_s, before[1])
    assert torch.equal(_lse_card_case(lw, on), first)


def test_lse_parts_variants_find_their_lines():
    """``util/lse_parts.py`` (the card's breakdown of K14's time) builds
    its variants by substituting lines of the kernel source: each still
    finds its line, only ``kept`` is the source unchanged, and the design
    it replaced is carried whole."""
    from pathlib import Path

    from cpprob_tpu_torch.util import lse_parts

    src = (Path(sr.__file__).parent / "csrc" / "stream_resample.cu").read_text()
    variants = lse_parts.variant_sources(src)
    assert set(variants) == set(lse_parts.VARIANTS) | {"two_launch"}
    assert [k for k, v in variants.items() if v == src] == ["kept"]
    assert "lse_stats_launch" in variants["two_launch"]
    with pytest.raises(ValueError, match="is gone"):
        lse_parts.variant_sources(src.replace("if (!last_s) return;", "if (!last) return;"))


@pytest.mark.cuda
def test_pass1_scan_kernel_back_to_back_and_degenerate_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pass1_scan_kernel runs only on the card")
    n = 1 << 24
    lw = 2 * torch.randn(n, generator=torch.Generator(device="cuda").manual_seed(5),
                         device="cuda")
    first = _pass1_card_case(lw)
    stats = sr.logsumexp_stats(lw)
    for _ in range(64):
        assert torch.equal(sr.resample_pass1(0.37, lw, stats), first)
    # flag 0 leaves the scratch clean for the flag-1 call after it
    off, on = (torch.tensor(f, dtype=torch.int32, device="cuda") for f in (0, 1))
    sr.resample_pass1(0.37, lw, stats, off)
    assert torch.equal(_pass1_card_case(lw, flag=on), first)
    heavy = torch.full((n,), -100.0, device="cuda")
    heavy[12345] = 0.0
    st = _pass1_card_case(heavy)
    assert int(st[12345]) == 0 and int(st[12346]) == n
    lone = torch.full((n,), -float("inf"), device="cuda")
    lone[777] = 0.0
    st = _pass1_card_case(lone)
    assert int(st[777]) == 0 and int(st[778]) == n


def test_pass1_parts_variants_find_their_lines():
    """``util/pass1_parts.py`` (the card's breakdown of pass 1's time)
    builds its variants by substituting lines of the kernel source: each
    still finds its line, and only ``full`` is the source unchanged."""
    from pathlib import Path

    from cpprob_tpu_torch.util import pass1_parts

    src = (Path(sr.__file__).parent / "csrc" / "stream_resample.cu").read_text()
    variants = pass1_parts.variant_sources(src)
    assert set(variants) == set(pass1_parts.VARIANTS)
    assert [k for k, v in variants.items() if v == src] == ["full"]
    with pytest.raises(ValueError, match="is gone"):
        pass1_parts.variant_sources(src.replace("look_back(held", "look_back2(held"))

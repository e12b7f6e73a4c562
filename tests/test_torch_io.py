"""The port's I/O and utilities (``cpprob_tpu_torch.io``, ``util.ndarray``,
``util.checkpoint``, ``util.logging``) against the JAX package's, on the
CPU: the counterparts of ``tests/test_io_util.py``'s serialization,
ndarray, checkpoint and logger cases; trace shards and posterior dumps
written by each package and read by the other; the port's own build of
``native/src`` against its numpy loader; and the offline CSIS path
(``dump_traces`` → ``TraceLoader`` → ``compile_offline`` → checkpoint →
``infer``).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cpprob_tpu as jt
import cpprob_tpu_torch as pt
import cpprob_tpu_torch.models as pm
from cpprob_tpu.io import dump_posterior as j_dump_posterior
from cpprob_tpu.io import format_value as j_format_value
from cpprob_tpu.io import load_posterior as j_load_posterior
from cpprob_tpu.io.tracefile import TraceLoader as JTraceLoader
from cpprob_tpu.io.tracefile import write_trace_shard as j_write_trace_shard
from cpprob_tpu.util import load_pytree as j_load_pytree
from cpprob_tpu.util import TrainLogger as JTrainLogger
from cpprob_tpu.util import save_pytree as j_save_pytree
from cpprob_tpu_torch.inference.sis import ImportanceResult
from cpprob_tpu_torch.io import (
    dump_posterior,
    dump_posterior_npz,
    format_value,
    load_posterior,
    load_posterior_npz,
    parse_observes,
    parse_value,
)
from cpprob_tpu_torch.io import tracefile as tf
from cpprob_tpu_torch.io.tracefile import TraceLoader, native_available, write_trace_shard
from cpprob_tpu_torch.postprocess.stats import StatsPrinter
from cpprob_tpu_torch.util import (
    TrainLogger,
    flatten_nested,
    hardware_banner,
    latest_checkpoint,
    load_pytree,
    load_pytree_orbax,
    periodic_saver,
    save_pytree,
    save_pytree_orbax,
    to_ndarray,
)
from cpprob_tpu_torch.util.pytree import tree_flatten, treedef_str

torch.set_num_threads(2)


def _gauss_result(n=500, seed=0):
    return pt.sis(pm.gaussian_unknown_mean_readme, (3.0, 4.0), n, seed, device="cpu")


class TestSerialization:
    def test_parse_scalars(self):
        assert parse_value("3") == 3
        assert parse_value("3.5") == 3.5
        assert parse_value("( 1 2.5 )") == (1, 2.5)
        assert parse_value("[ 1 2 3 ]") == [1, 2, 3]

    def test_parse_nested(self):
        assert parse_value("( [ ( 0 1.5 ) ( 1 2 ) ] -3.25 )") == ([(0, 1.5), (1, 2)], -3.25)

    def test_parse_observes_reference_syntax(self):
        obs = parse_observes("[[1 2.1] [2 3.9] [3 5.3]]")
        assert len(obs) == 1
        np.testing.assert_allclose(obs[0], [[1, 2.1], [2, 3.9], [3, 5.3]], rtol=1e-6)

    def test_parse_observes_scalars(self):
        assert parse_observes("3.0 4.0") == (3.0, 4.0)

    def test_roundtrip_format(self):
        v = ([1, 2, 3], (4.5, 6))
        assert parse_value(format_value(v)) == ([1, 2, 3], (4.5, 6))
        assert format_value(v) == j_format_value(v)

    def test_posterior_dump_roundtrip(self, tmp_path):
        res = _gauss_result()
        path = str(tmp_path / "posterior")
        dump_posterior(path, res)
        assert os.path.exists(path + ".ids") and os.path.exists(path + ".real")
        predicts, log_w = load_posterior(path)
        np.testing.assert_allclose(np.asarray(predicts["Mean"], np.float32),
                                   res.predicts["Mean"].numpy(), rtol=1e-5)
        np.testing.assert_allclose(log_w, res.log_weights.numpy(), rtol=1e-5)

    def test_posterior_native_python_parity(self, tmp_path):
        """The port's native parser agrees exactly with the Python
        s-expression parser on a mixed dump with repeated predicts."""
        assert native_available(), tf._lib_error
        obs = np.array([0.9, -0.8, 0.7, 0.0, 1.1], np.float32)
        res = pt.sis(pm.hmm, (obs,), 400, 0, device="cpu")
        path = str(tmp_path / "post")
        dump_posterior(path, res)
        pred_py, lw_py = load_posterior(path, native=False)
        pred_nat, lw_nat = load_posterior(path, native=True)
        np.testing.assert_allclose(lw_nat, lw_py, rtol=1e-12)
        assert pred_py.keys() == pred_nat.keys()
        for name in pred_py:
            np.testing.assert_allclose(np.asarray(pred_nat[name], np.float64),
                                       np.asarray(pred_py[name], np.float64), rtol=1e-12)

    @pytest.mark.parametrize("native", [False, None])
    def test_mixed_int_real_dump_single_weight_vector(self, tmp_path, native):
        """A dump with both .int and .real files yields one weight per
        particle, and ``StatsPrinter.from_dump`` summarizes it."""
        n = 50
        rng = np.random.default_rng(0)
        res = ImportanceResult(
            torch.as_tensor(rng.standard_normal(n), dtype=torch.float32),
            {"Channel": torch.as_tensor(rng.integers(0, 4, n)),
             "Momentum": torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)},
        )
        path = str(tmp_path / "mixed")
        dump_posterior(path, res)
        assert os.path.exists(path + ".int") and os.path.exists(path + ".real")
        predicts, log_w = load_posterior(path, native=native)
        assert log_w.shape == (n,)
        np.testing.assert_allclose(log_w, res.log_weights.numpy(), rtol=1e-6)
        assert len(predicts["Channel"]) == n and len(predicts["Momentum"]) == n
        s = StatsPrinter.from_dump(path, native=native).summary()
        assert s["Channel"]["kind"] == "int"
        assert s["Momentum"]["kind"] == "real"
        w = np.exp(log_w - log_w.max())
        np.testing.assert_allclose(
            float(s["Momentum"]["mean"]),
            float(np.sum(w * np.asarray(predicts["Momentum"])) / np.sum(w)), rtol=1e-4)

    def test_posterior_npz_roundtrip(self, tmp_path):
        res = _gauss_result()
        path = str(tmp_path / "posterior.npz")
        dump_posterior_npz(path, res)
        predicts, log_w = load_posterior_npz(path)
        np.testing.assert_allclose(predicts["Mean"], res.predicts["Mean"].numpy(), rtol=1e-6)
        np.testing.assert_allclose(log_w, res.log_weights.numpy(), rtol=1e-6)

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_posterior_dump_crosses_packages(self, tmp_path, writer):
        """A posterior dump written by either package loads in the other,
        and ``StatsPrinter.from_dump`` of the port summarizes the JAX
        package's."""
        obs = np.array([0.9, -0.8, 0.7], np.float32)
        path = str(tmp_path / "post")
        if writer == "port":
            res = pt.sis(pm.hmm, (obs,), 200, 0, device="cpu")
            dump_posterior(path, res)
            predicts, log_w = j_load_posterior(path)
            want_lw, want_states = res.log_weights.numpy(), res.predicts["State"].numpy()
        else:
            res = jt.sis(jt.models.hmm, (jnp.asarray(obs),), 200, jax.random.key(0))
            j_dump_posterior(path, res)
            predicts, log_w = load_posterior(path)
            want_lw, want_states = np.asarray(res.log_weights), np.asarray(res.predicts["State"])
            s = StatsPrinter.from_dump(path).summary()
            assert s["State"]["kind"] == "int" and s["State"]["count"] == 200
        np.testing.assert_allclose(log_w, want_lw, rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(predicts["State"]), want_states)


class TestNdarray:
    def test_scalar(self):
        assert to_ndarray(3.0).shape == ()

    def test_nested_ragged_padding(self):
        np.testing.assert_allclose(to_ndarray([[1.0, 2.0], [3.0]]), [[1.0, 2.0], [3.0, 0.0]])

    def test_tuple_mix(self):
        out = flatten_nested((1.0, [2.0, 3.0]))
        np.testing.assert_allclose(out[:1], [1.0])
        assert out.size >= 3

    def test_deep_nesting(self):
        assert to_ndarray([[[1.0], [2.0]], [[3.0], [4.0]]]).shape == (2, 2, 1)

    def test_matches_jax_package_and_takes_tensors(self):
        from cpprob_tpu.util import flatten_nested as jflat

        v = (1.0, [[2.0, 3.0], [4.0]], np.arange(3.0))
        np.testing.assert_array_equal(flatten_nested(v), jflat(v))
        np.testing.assert_array_equal(to_ndarray(torch.arange(3.0)), np.arange(3.0))


class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        tree = {"a": torch.arange(3.0), "b": [torch.zeros((2, 2)), torch.ones(())]}
        p = save_pytree(str(tmp_path / "ckpt-1"), tree)
        like = {"a": torch.zeros(3), "b": [torch.zeros((2, 2)), torch.zeros(())]}
        loaded = load_pytree(p, like)
        np.testing.assert_allclose(loaded["a"].numpy(), [0, 1, 2])
        assert isinstance(loaded["b"][1], torch.Tensor)

    def test_shape_mismatch_raises(self, tmp_path):
        p = save_pytree(str(tmp_path / "ckpt-2"), {"a": torch.zeros(3)})
        with pytest.raises(ValueError, match="shape"):
            load_pytree(p, {"a": torch.zeros(4)})

    def test_latest(self, tmp_path):
        import time

        save_pytree(str(tmp_path / "ckpt-1"), {"a": torch.zeros(1)})
        time.sleep(0.01)
        p2 = save_pytree(str(tmp_path / "ckpt-2"), {"a": torch.zeros(1)})
        assert latest_checkpoint(str(tmp_path)) == p2

    def test_orbax_named_roundtrip(self, tmp_path):
        tree = {"w": torch.arange(4.0), "b": (torch.ones((2,)), None)}
        p = save_pytree_orbax(str(tmp_path / "ock"), tree)
        out = load_pytree_orbax(p)
        np.testing.assert_allclose(out["w"].numpy(), [0, 1, 2, 3])
        assert out["b"][1] is None and isinstance(out["b"], tuple)
        out2 = load_pytree_orbax(p, like={"w": torch.zeros(4), "b": (torch.zeros(2), None)})
        np.testing.assert_allclose(out2["b"][0].numpy(), [1, 1])

    def test_periodic_saver(self, tmp_path):
        saver = periodic_saver(str(tmp_path), every_n_traces=100)
        assert saver.maybe_save({"a": torch.zeros(1)}, 60) is None
        p = saver.maybe_save({"a": torch.zeros(1)}, 60)
        assert p is not None and latest_checkpoint(str(tmp_path)) == p

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_checkpoint_crosses_packages_in_jax_flatten_order(self, tmp_path, writer):
        """Dict keys inserted out of order: both packages write (and read)
        the leaves in JAX's sorted order, with JAX's treedef string."""
        tree = {"z": [np.arange(3.0, dtype=np.float32), np.ones((2,), np.float32)],
                "a": {"y": np.full((1,), 5.0, np.float32), "b": np.zeros((2, 2), np.float32)}}
        ttree = {"z": [torch.as_tensor(t) for t in tree["z"]],
                 "a": {k: torch.as_tensor(v) for k, v in tree["a"].items()}}
        assert treedef_str(tree_flatten(ttree)[1]) == str(jax.tree_util.tree_structure(tree))
        path = str(tmp_path / "ck")
        if writer == "port":
            p = save_pytree(path, ttree)
            loaded = j_load_pytree(p, tree)
            got = jax.tree_util.tree_leaves(loaded)
        else:
            p = j_save_pytree(path, jax.tree_util.tree_map(jnp.asarray, tree))
            got = tree_flatten(load_pytree(p, ttree))[0]
        for a, b in zip(got, jax.tree_util.tree_leaves(tree)):
            np.testing.assert_array_equal(np.asarray(a), b)


class TestLogger:
    def test_logs(self, capsys):
        lg = TrainLogger(stream=sys.stderr, print_every=1)
        lg.log(1.0, 64)
        lg.log(0.5, 64)
        err = capsys.readouterr().err
        assert "loss" in err and "traces/s" in err
        assert lg.HEADER == JTrainLogger.HEADER

    def test_banner(self):
        assert "cpprob_tpu_torch on" in hardware_banner()


# ---------------------------------------------------------------------------
# trace shards


def _shards(d, writer=write_trace_shard):
    rng = np.random.RandomState(0)
    for s in range(3):
        values = {"mu": rng.normal(size=64).astype(np.float32),
                  "vec": rng.normal(size=(64, 2)).astype(np.float32)}
        writer(str(d), values, rng.normal(size=(64, 5)).astype(np.float32), name=f"shard{s}")
    return sorted(os.path.join(d, f) for f in os.listdir(d) if f.endswith(".cptt"))


def test_shards_are_byte_identical_across_packages(tmp_path):
    a, b = tmp_path / "port", tmp_path / "jax"
    for pa, pb in zip(_shards(a), _shards(b, j_write_trace_shard)):
        assert open(pa, "rb").read() == open(pb, "rb").read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_read_across_packages(tmp_path, writer):
    paths = _shards(tmp_path, write_trace_shard if writer == "port" else j_write_trace_shard)
    reader = (JTraceLoader(paths, batch_size=8, force_python=True) if writer == "port"
              else TraceLoader(paths, batch_size=8, force_python=True, device="cpu"))
    assert reader.site_names == ["mu", "vec"] and reader.site_sizes == [1, 2]
    assert reader.obs_dim == 5 and reader.total_traces == 192
    values, obs = reader.next_batch()
    assert tuple(obs.shape) == (8, 5) and tuple(values["vec"].shape) == (8, 2)


def test_native_loader_builds_and_matches_numpy_loader(tmp_path):
    """The port builds ``native/src`` into ``ops/_build/`` and its loader
    returns rows of the shards, with the numpy loader's metadata."""
    paths = _shards(tmp_path)
    assert native_available(), tf._lib_error
    lib_path = tf._native_path()
    assert lib_path.exists() and lib_path.parent.name == "_build"
    py = TraceLoader(paths, batch_size=4, force_python=True, device="cpu")
    nat = TraceLoader(paths, batch_size=64, n_threads=1, seed=3, device="cpu")
    assert nat.native and not py.native
    for k in ("row_len", "obs_dim", "total_traces", "site_names", "site_sizes"):
        assert getattr(nat, k) == getattr(py, k), k
    rows = np.concatenate(py._py_shards, axis=0)
    batch = nat.next_batch_raw()
    for row in batch:
        assert np.any(np.all(rows == row, axis=1))
    values, obs = nat.next_batch()
    assert isinstance(obs, torch.Tensor) and obs.shape == (64, 5)
    nat.close()


def test_failed_native_build_raises_unless_force_python(tmp_path, monkeypatch):
    paths = _shards(tmp_path)
    monkeypatch.setattr(tf, "_lib_tried", True)
    monkeypatch.setattr(tf, "_lib", None)
    monkeypatch.setattr(tf, "_lib_error", "RuntimeError: g++ failed")
    with pytest.raises(RuntimeError, match="force_python"):
        TraceLoader(paths, batch_size=4, device="cpu")
    assert TraceLoader(paths, batch_size=4, force_python=True, device="cpu").native is False
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TraceLoader(paths, batch_size=4, force_python=True)


def test_offline_compile_and_checkpoint_roundtrip(tmp_path):
    """dump_traces → native TraceLoader → compile_offline → save/load →
    the same inference log-weights bit for bit."""
    obs = np.zeros(5, np.float32)
    eng = pt.CSIS(pm.hmm, (obs,), embedding_dim=16, device="cpu")
    paths = eng.dump_traces(str(tmp_path / "shards"), 0, 1024, shard_size=256)
    assert len(paths) == 4
    loader = TraceLoader(paths, batch_size=64, device="cpu")
    assert loader.native
    assert "__mask__z[0]" in loader.site_names
    params, losses = eng.compile_offline(loader, 0, steps=40)
    assert losses.shape == (40,) and torch.isfinite(losses).all()
    assert float(losses[-10:].mean()) < float(losses[:10].mean())
    path = save_pytree(str(tmp_path / "ckpt-1"), params)
    back = load_pytree(path, eng.init(1))
    y = np.array([0.9, -0.8, 0.7, 0.0, 1.1], np.float32)
    a = eng.infer(params, (y,), 512, 3)
    b = eng.infer(back, (y,), 512, 3)
    assert torch.equal(a.log_weights, b.log_weights)
    loader.close()

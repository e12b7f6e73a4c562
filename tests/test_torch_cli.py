"""The port's command-line driver (``cpprob_tpu_torch/cli.py``) against the
JAX package's ``cpprob_tpu/cli.py``: the same model list, estimates held to
the exact values (4 SE, and 4 SE + 0.02 for the evidence over seeds),
every misuse exiting with 2, and files crossing between the packages: a
posterior dumped by either CLI is summarized by the other's ``-m
estimate``, and a checkpoint written by the reference's ``-m compile``
serves the port's ``-m csis``.  Then the cases of ``tests/test_cli.py``.
Every port run passes ``--device cpu``.
"""

import glob
import math
import re

import jax
import numpy as np
import pytest
import torch

from cpprob_tpu.cli import main as ref_main
from cpprob_tpu_torch.cli import build_parser, main
from cpprob_tpu_torch.models import hmm_log_evidence

torch.set_num_threads(2)

HMM_OBS = "[0.9 0.8 0.7 0.0 -0.025 -5.0 -2.0 -0.1 0.0 0.13]"
README_MEAN = 2.32353


def pmain(argv):
    return main(list(argv) + ["--device", "cpu"])


def _number(out, label):
    return float(re.search(rf"{label}:?\s+(-?[0-9.]+(?:e-?\d+)?)", out).group(1))


def test_list_matches_reference(capsys):
    assert ref_main(["--model", "x", "--list"]) == 0
    want = capsys.readouterr().out
    assert main(["--model", "x", "--list"]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert len(got.splitlines()) == 9


def test_parser_keeps_every_reference_flag():
    from cpprob_tpu.cli import build_parser as ref_parser

    def flags(p):
        return {a.dest: (a.default, tuple(a.choices or ())) for a in p._actions}

    ref, port = flags(ref_parser()), flags(build_parser())
    assert set(port) - set(ref) == {"device"}
    for dest, spec in ref.items():
        assert port[dest] == spec, dest
    assert port["device"][0] == "cuda"


def test_no_card_raises_without_cpu_request():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "gaussian", "-n", "10"])


def test_sis_gaussian_within_4_se(capsys):
    assert pmain(["--model", "gaussian", "-m", "sis", "-n", "4000", "-o", "3.0 4.0",
                  "--seed", "1"]) == 0
    out = capsys.readouterr().out
    mean = float(out.split("Mean:")[-1].split()[0])
    var = float(out.split("Variance:")[-1].split()[0])
    ess = _number(out, "ESS")
    assert abs(mean - README_MEAN) < 4 * math.sqrt(var / ess), (mean, var, ess)


def test_smc_hmm_evidence(capsys):
    zs = []
    for seed in range(4):
        assert pmain(["--model", "hmm", "-m", "smc", "-n", "4096", "-o", HMM_OBS,
                      "--seed", str(seed)]) == 0
        out = capsys.readouterr().out
        zs.append(_number(out, "log_evidence"))
        assert "resampling epochs:" in out and "final-state mean:" in out
    obs = np.array([float(x) for x in HMM_OBS.strip("[]").split()], np.float32)
    exact = hmm_log_evidence(obs)
    se = np.std(zs, ddof=1) / math.sqrt(len(zs))
    assert abs(np.mean(zs) - exact) < 4 * se + 0.02, (zs, exact)


def test_pg_and_tempered_and_dryrun(capsys):
    assert pmain(["--model", "hmm", "-m", "pg", "-n", "64", "--iters", "20",
                  "--burn-in", "5", "-o", HMM_OBS]) == 0
    out = capsys.readouterr().out
    assert "particle-Gibbs: 15 kept sweeps" in out and "z[9]" in out
    assert pmain(["--model", "gaussian", "-m", "tempered", "-n", "512",
                  "-o", "3.0 4.0"]) == 0
    out = capsys.readouterr().out
    assert abs(_number(out, "log_evidence") - (-4.398851)) < 0.1
    assert pmain(["--model", "hmm", "-m", "dryrun"]) == 0
    assert "dryrun ok" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["--model", "nope"],
    ["--model", "gaussian", "-m", "estimate"],
    ["--model", "gaussian", "-m", "smc"],
    ["--model", "gaussian", "-m", "pg"],
    ["--model", "gaussian", "-m", "compile", "--resume"],
    ["--model", "gaussian", "-m", "compile", "--save-every", "10"],
    ["--model", "gaussian", "-m", "csis"],
    ["--model", "gaussian", "-m", "csis", "--ckpt-dir", "{empty}"],
    ["--model", "gaussian", "-m", "compile", "--traces-dir", "{empty}"],
    ["--model", "gaussian", "-m", "csis", "--dynamic", "--defensive", "0.2",
     "--ckpt-dir", "{ckpt}"],
], ids=["unknown_model", "estimate_no_dump", "smc_no_ssm", "pg_no_ssm",
        "resume_no_ckpt", "save_every_no_ckpt", "csis_no_ckpt", "csis_empty_ckpt",
        "traces_dir_empty", "dynamic_defensive"])
def test_every_misuse_exits_2(argv, tmp_path, capsys):
    empty, ckpt = tmp_path / "empty", tmp_path / "ckpt"
    empty.mkdir()
    if "{ckpt}" in argv:
        assert pmain(["--model", "gaussian", "-m", "compile", "--steps", "1",
                      "--batch-size", "8", "--ckpt-dir", str(ckpt), "--dynamic"]) == 0
    argv = [a.replace("{empty}", str(empty)).replace("{ckpt}", str(ckpt)) for a in argv]
    assert pmain(argv) == 2
    assert capsys.readouterr().err


def test_dynamic_incompatible_with_tied():
    with pytest.raises(SystemExit) as e:
        pmain(["--model", "gaussian", "-m", "compile", "--dynamic", "--tie-addresses",
               "--steps", "1"])
    assert e.value.code == 2


def _estimate(run, path, capsys, extra=()):
    assert run(["--model", "gaussian", "-m", "estimate", "--dump-path", path, *extra]) == 0
    out = capsys.readouterr().out
    return (float(out.split("Mean:")[-1].split()[0]),
            float(out.split("Variance:")[-1].split()[0]))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_posterior_dump_crosses_packages(writer, tmp_path, capsys):
    path = str(tmp_path / "post")
    argv = ["--model", "gaussian", "-m", "sis", "-n", "2000", "-o", "3.0 4.0",
            "--dump-path", path]
    assert (pmain(argv) if writer == "port" else ref_main(argv)) == 0
    capsys.readouterr()
    got = _estimate(pmain, path, capsys)
    want = _estimate(ref_main, path, capsys)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert abs(got[0] - README_MEAN) < 0.2


def test_reference_checkpoint_serves_port_csis(tmp_path, capsys):
    ckpt = str(tmp_path / "nn")
    assert ref_main(["--model", "gaussian", "-m", "compile", "--steps", "300",
                     "--batch-size", "128", "--ckpt-dir", ckpt]) == 0
    capsys.readouterr()
    assert pmain(["--model", "gaussian", "-m", "csis", "-n", "4000", "-o", "3.0 4.0",
                  "--ckpt-dir", ckpt, "--seed", "3"]) == 0
    out = capsys.readouterr().out
    mean = float(out.split("Mean:")[-1].split()[0])
    var = float(out.split("Variance:")[-1].split()[0])
    assert abs(mean - README_MEAN) < 4 * math.sqrt(var / _number(out, "ESS"))
    assert _number(out, "ESS") > 2000     # the trained proposal, not the prior


def test_port_checkpoint_serves_reference_csis(tmp_path, capsys):
    ckpt = str(tmp_path / "nn")
    assert pmain(["--model", "gaussian", "-m", "compile", "--steps", "300",
                  "--batch-size", "128", "--ckpt-dir", ckpt]) == 0
    capsys.readouterr()
    assert ref_main(["--model", "gaussian", "-m", "csis", "-n", "4000", "-o", "3.0 4.0",
                     "--ckpt-dir", ckpt, "--seed", "3"]) == 0
    out = capsys.readouterr().out
    mean = float(out.split("Mean:")[-1].split()[0])
    var = float(out.split("Variance:")[-1].split()[0])
    assert abs(mean - README_MEAN) < 4 * math.sqrt(var / _number(out, "ESS"))
    assert _number(out, "ESS") > 2000


def test_offline_traces_through_the_cli(tmp_path, capsys):
    traces, ckpt = str(tmp_path / "traces"), str(tmp_path / "nn")
    assert pmain(["--model", "gaussian", "-m", "compile", "--dump-traces-dir", traces,
                  "--n-traces", "512", "--batch-size", "16"]) == 0
    assert len(glob.glob(traces + "/*.cptt")) == 2
    assert pmain(["--model", "gaussian", "-m", "compile", "--traces-dir", traces,
                  "--steps", "4", "--batch-size", "32", "--ckpt-dir", ckpt]) == 0
    assert glob.glob(ckpt + "/ckpt-*.npz")


# --------------------------------------------------------------------------
# the cases of tests/test_cli.py


def test_compile_save_every_resume_csis(tmp_path, capsys):
    ckpt = str(tmp_path / "nn")
    assert pmain(["--model", "gaussian", "-m", "compile", "--steps", "6",
                  "--batch-size", "16", "--ckpt-dir", ckpt, "--save-every", "32",
                  "--seed", "0"]) == 0
    assert len(glob.glob(ckpt + "/ckpt-*.npz")) >= 3
    assert pmain(["--model", "gaussian", "-m", "compile", "--steps", "3",
                  "--batch-size", "16", "--ckpt-dir", ckpt, "--resume", "--seed", "1"]) == 0
    assert "resuming from" in capsys.readouterr().err
    assert pmain(["--model", "gaussian", "-m", "csis", "-n", "800", "-o", "3.0 4.0",
                  "--ckpt-dir", ckpt, "--seed", "2"]) == 0
    assert "Mean" in capsys.readouterr().out


def test_resume_warm_starts_standard_engine(tmp_path, capsys, monkeypatch):
    from cpprob_tpu_torch.inference.csis import CSIS

    ckpt = str(tmp_path / "nn")
    assert pmain(["--model", "gaussian", "-m", "compile", "--steps", "2",
                  "--batch-size", "8", "--ckpt-dir", ckpt, "--seed", "0"]) == 0
    seen = {}
    orig = CSIS.compile

    def spy(self, key, *a, **kw):
        seen["params"] = kw.get("params")
        return orig(self, key, *a, **kw)

    monkeypatch.setattr(CSIS, "compile", spy)
    assert pmain(["--model", "gaussian", "-m", "compile", "--steps", "2",
                  "--batch-size", "8", "--ckpt-dir", ckpt, "--resume", "--seed", "1"]) == 0
    assert "resuming from" in capsys.readouterr().err
    assert seen["params"] is not None


def test_compile_interrupt_returns_partial(tmp_path):
    from cpprob_tpu_torch.inference.csis import CSIS
    from cpprob_tpu_torch.models import gaussian_unknown_mean_readme
    from cpprob_tpu_torch.util import periodic_saver

    eng = CSIS(gaussian_unknown_mean_readme, (0.0, 0.0), device="cpu")
    saver = periodic_saver(str(tmp_path), 16)
    calls = []

    def log_fn(loss, n):
        calls.append(loss)
        if len(calls) == 3:
            raise KeyboardInterrupt

    params, losses = eng.compile(0, steps=50, batch_size=16, log_fn=log_fn, saver=saver)
    assert params is not None
    assert 0 < losses.shape[0] < 50
    assert len(glob.glob(str(tmp_path) + "/ckpt-*.npz")) >= 1
    res = eng.infer(params, (3.0, 4.0), 200, 1)
    assert torch.isfinite(res.log_weights).all()


@pytest.mark.parametrize("flags", [["--mdn", "3"], ["--defensive", "0.2"],
                                   ["--obs-embedding", "lstm"], ["--dynamic"]],
                         ids=["mdn", "defensive", "lstm", "dynamic"])
def test_engine_option_flags(flags, tmp_path, capsys):
    ckpt = str(tmp_path / "nn")
    train = [f for f in flags if f not in ("--defensive", "0.2")]
    assert pmain(["--model", "gaussian", "-m", "compile", "--steps", "2",
                  "--batch-size", "8", "--ckpt-dir", ckpt, *train]) == 0
    if flags[0] == "--obs-embedding":
        return
    n = "50" if flags == ["--dynamic"] else "200"
    assert pmain(["--model", "gaussian", "-m", "csis", "-n", n, "-o", "3.0 4.0",
                  "--ckpt-dir", ckpt, *flags]) == 0
    assert "Mean" in capsys.readouterr().out

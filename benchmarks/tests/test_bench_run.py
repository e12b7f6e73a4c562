"""``run.py`` as the command: it refuses to run without a CUDA card and
prints no result then; on the card (marked ``cuda``) a short run prints
the result line."""

import json
import shutil
import subprocess
import sys

import pytest

from harness.manifest import BENCH_DIR, ROOT


def _run(root, *extra, timeout=600):
    return subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "lg1d-2e24-perstep",
         "--seed", str(2**32 + 3), *extra],
        cwd=root, capture_output=True, text=True, timeout=timeout)


def test_no_result_without_a_card(monkeypatch):
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "lg1d-2e24-perstep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_no_result_from_the_benchmark_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmarks",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "lg1d-2e24-perstep",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card(trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = _run(ROOT, "--seconds", "3", "--trace", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace == "1":
        assert line["device"]["busy_s"] > 0 and line["breakdown"]["device_ops"]
    assert out.stderr.strip().splitlines()[-1].startswith("check failed")

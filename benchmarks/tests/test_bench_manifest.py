"""The manifest and the files it names: every cell's configuration,
traffic, limits and metric readers are found by name, and a new one is
picked up by adding files and entries, with no edit to a file that is
there."""

import hashlib
import json
import re
import shutil

import pytest

from harness import check, manifest

M = manifest.Manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_manifest_keys_and_names():
    d = M.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert d["paths"] == ["benchmarks"] and d["command"][1] == "benchmarks/run.py"
    assert 1 <= d["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in d[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" for m in d["end_to_end"])
    for m in d["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= set(M.workloads)


@pytest.mark.parametrize("workload", sorted(M.workloads))
def test_every_cell_finds_its_files(workload):
    cell = M.cell(workload)
    assert cell.config["series_length"] == 16
    assert callable(cell.system.model) and callable(cell.reference.exact)
    assert {"logz_medsq_n", "filter_medsq_n"} <= set(cell.limits) <= set(check.NUMBERS)
    for trace in (False, True):
        metrics = M.metrics(workload, trace)
        assert metrics
        for m in metrics:
            assert callable(M.reader(m["name"]))
    e2e = {m["name"] for m in M.metrics(workload, False)}
    assert {"particle_steps_per_s", "query_ms_p95", "setup_s"} <= e2e


def _digest(folder):
    return {p.relative_to(folder).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_data(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmarks"
    shutil.copytree(manifest.BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "out", "tests"))
    data = json.loads((manifest.ROOT / "BENCHMARK.json").read_text())
    before = _digest(bench)
    # a later change adds a traffic mix, a configuration, a metric and a
    # cell: files and entries only
    (bench / "traffic" / "closed-n2e22-chunk4.json").write_text(json.dumps(
        dict(json.loads((bench / "traffic" / "closed-n2e24-chunk8.json").read_text()),
             particles=1 << 22, chunk=4)))
    for suffix in (".json", ".py"):
        shutil.copy(bench / "configs" / f"hmm3{suffix}", bench / "configs" / f"hmm3b{suffix}")
    shutil.copy(bench / "reference" / "hmm3.py", bench / "reference" / "hmm3b.py")
    (bench / "metrics" / "queries_per_s.py").write_text(
        "def read(ctx):\n    return len(ctx.queries) / ctx.window_s\n")
    (bench / "limits" / "hmm3b-2e22-chunk4.json").write_text(
        (bench / "limits" / "hmm3-2e26-chunk16-island8.json").read_text())
    data["configs"].append(dict(data["configs"][0], name="hmm3b",
                                file="benchmarks/configs/hmm3b.json"))
    data["workloads"].append({"name": "hmm3b-2e22-chunk4", "config": "hmm3b",
                              "traffic": "closed-n2e22-chunk4", "chips": 1, "why": "test"})
    data["per_layer"].append({"name": "queries_per_s", "unit": "1/s", "better": "higher",
                              "source": "host_clock", "layer": "sweep driver",
                              "moves": "particle_steps_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    after = _digest(bench)
    assert all(after[k] == v for k, v in before.items())

    m = manifest.Manifest(root, bench)
    cell = m.cell("hmm3b-2e22-chunk4")
    assert cell.traffic["particles"] == 1 << 22 and cell.config_name == "hmm3b"
    names = [x["name"] for x in m.metrics("hmm3b-2e22-chunk4", True)]
    assert "queries_per_s" in names
    # a metric without a workloads key belongs to every cell
    assert "queries_per_s" in [x["name"] for x in m.metrics("hmm3-2e20-perstep", True)]
    ctx = type("Ctx", (), {"queries": [1, 2, 3], "window_s": 1.5})()
    assert m.reader("queries_per_s")(ctx) == 2.0

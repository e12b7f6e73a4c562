"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
references import nothing of the program."""

import ast
import json
import subprocess
import sys

from harness.manifest import BENCH_DIR, ROOT

PROBE = r"""
import importlib, json, sys
from pathlib import Path
bench = Path(sys.argv[1]); sys.path[:0] = [str(bench), str(bench.parent)]
from harness import manifest, runner, trace, stats, check, control, traffic, yardstick, device
m = manifest.Manifest(bench.parent, bench)
for w in m.workloads:
    cell = m.cell(w)
    cell.system.model(cell.traffic)          # the port's model: imports the port
    for trace_on in (False, True):
        for metric in m.metrics(w, trace_on):
            m.reader(metric["name"])
print(json.dumps(sorted({k.split(".", 1)[0] for k in sys.modules})))
"""


def test_no_jax_after_importing_every_harness_module():
    out = subprocess.run([sys.executable, "-c", PROBE, str(BENCH_DIR)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "cpprob_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "cpprob_tpu"}


def test_references_import_nothing_of_the_program():
    for path in sorted((BENCH_DIR / "reference").glob("*.py")):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".", 1)[0] in {"__future__", "math", "numpy", "torch"}, (
                    f"{path.name} imports {name}")


def test_nothing_reads_bench_py():
    for path in sorted(BENCH_DIR.rglob("*.py")):
        if "tests" in path.parts:
            continue
        assert "bench.py" not in path.read_text().replace("benchmarks/run.py", ""), path

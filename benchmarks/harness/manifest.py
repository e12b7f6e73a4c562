"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix, limits and metric readers, each found by its name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module called ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Manifest:
    """The benchmark as ``BENCHMARK.json`` describes it; ``bench_dir`` is
    the folder whose ``configs/``, ``reference/``, ``traffic/``,
    ``metrics/`` and ``limits/`` hold the files found by name."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root, self.bench_dir = Path(root), Path(bench_dir)
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)
        self.configs = {c["name"]: c for c in self.data["configs"]}
        self.workloads = {w["name"]: w for w in self.data["workloads"]}

    def cell(self, workload: str) -> "Cell":
        if workload not in self.workloads:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                           f"(have {sorted(self.workloads)})")
        return Cell(self, self.workloads[workload])

    def metrics(self, workload: str, trace: bool) -> list:
        """The metrics a run of ``workload`` reports: its end-to-end
        metrics with ``trace`` off, its per-layer metrics with it on; a
        metric without a ``workloads`` key belongs to every cell."""
        kind = "per_layer" if trace else "end_to_end"
        return [m for m in self.data[kind]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The reader of ``metric``: ``metrics/<name>.py``'s ``read``."""
        path = self.bench_dir / "metrics" / f"{metric}.py"
        return load_module(path, f"bench_metric_{metric}").read


class Cell:
    """One workload: its configuration (the file of sizes, the module that
    builds the port's model and the plain reference), its traffic mix and
    the limits of its correctness check."""

    def __init__(self, manifest: Manifest, entry: dict):
        self.manifest, self.entry = manifest, entry
        self.name, self.chips = entry["name"], int(entry["chips"])
        cfg_entry = manifest.configs[entry["config"]]
        bench = manifest.bench_dir
        with open(manifest.root / cfg_entry["file"]) as f:
            self.config = json.load(f)
        self.config_name = cfg_entry["name"]
        self.system = load_module(bench / "configs" / f"{self.config_name}.py",
                                  f"bench_config_{self.config_name}")
        self.reference = load_module(bench / "reference" / f"{self.config_name}.py",
                                     f"bench_reference_{self.config_name}")
        with open(bench / "traffic" / f"{entry['traffic']}.json") as f:
            self.traffic = json.load(f)
        with open(bench / "limits" / f"{self.name}.json") as f:
            self.limits = json.load(f)

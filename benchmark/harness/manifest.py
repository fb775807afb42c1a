"""`BENCHMARK.json` and the files it names, found by name: a configuration
by its `file`, a traffic mix at `mixes/<traffic>.json`, a cell's limits at
`limits/<workload>.json`, a per-layer metric's reader at
`metrics/<metric>.py`."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


class Manifest:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench_dir = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, traffic: str) -> Dict:
        return json.loads((self.bench_dir / "mixes" / f"{traffic}.json").read_text())

    def limits(self, workload: str) -> Dict:
        return json.loads((self.bench_dir / "limits" / f"{workload}.json").read_text())

    def end_to_end(self, workload: str) -> List[Dict]:
        """The end-to-end metrics the cell reports."""
        return [m for m in self.data["end_to_end"] if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> List[Dict]:
        """The per-layer metrics the cell reports: those that list it, and
        those without a list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.data["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def metric_reader(self, name: str) -> ModuleType:
        path = self.bench_dir / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name.replace('.', '_')}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

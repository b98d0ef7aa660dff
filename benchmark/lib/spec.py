"""BENCHMARK.json and the files it names, found by name.

A cell (an entry of `workloads`) names a configuration and a traffic mix.
The configuration's `file` names its `system`,
benchmark/systems/<system>.py, which sets up and runs the port; the mix is
benchmark/traffic/<traffic>.json, whose `generator` is
benchmark/generators/<generator>.py; the limits of the cell's correctness
check are benchmark/limits/<cell>.json; each metric is read by
benchmark/metrics/<metric>.py.  A new cell, mix or metric is new files and
new entries, and no edit of a file here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "bench_" + path.stem.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell of BENCHMARK.json, with its files loaded."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        self.bench = bench
        self.root = root
        self.entry = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = _json(root / self.config_entry["file"])
        self.traffic = _json(root / "benchmark" / "traffic"
                             / f"{self.entry['traffic']}.json")
        self.limits = _json(root / "benchmark" / "limits" / f"{name}.json")
        self.chips = int(self.entry["chips"])

    def system(self):
        return _module(self.root / "benchmark" / "systems"
                       / f"{self.config['system']}.py")

    def generator(self):
        return _module(self.root / "benchmark" / "generators"
                       / f"{self.traffic['generator']}.py")

    def end_to_end(self) -> list:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> list:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str):
        return _module(self.root / "benchmark" / "metrics" / f"{metric}.py")


def load(name: str, root: Path = ROOT) -> Cell:
    return Cell(_json(root / "BENCHMARK.json"), name, root)

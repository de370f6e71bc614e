"""The benchmark's data, found by name.

``BENCHMARK.json`` at the root of the checkout lists the configurations,
the cells (a configuration under a traffic mix) and the metrics. Everything
that belongs to one of them is a file of its own under ``dmrbench/``:

- a configuration: the file its entry names (``configs/<config>.json``);
- a traffic mix: ``traffic/<traffic>.json``;
- a cell's limits on the numbers that decide ``correct``:
  ``limits/<cell>.json``;
- a per-layer metric: ``metrics/<metric>.py``, a reader with a function
  ``read(rec)`` that returns the metric's value from a run's records, or
  None where it finds nothing to read.

A later cell, mix or metric is new files and new entries; no code changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

DATA = "dmrbench"


def read_json(path: Path):
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    entry: dict            # the cell's entry in BENCHMARK.json
    config: dict           # its configuration file
    mix: dict              # its traffic mix file
    limits: dict           # its limits file
    end_to_end: List[dict]  # the end-to-end metrics it reports
    per_layer: List[dict]   # the per-layer metrics it reports
    readers: Dict[str, Callable]


def reports(metric: dict, cell: str) -> bool:
    """Whether an end-to-end metric is reported by ``cell``."""
    return "workloads" not in metric or cell in metric["workloads"]


def load_reader(path: Path) -> Callable:
    spec = importlib.util.spec_from_file_location(
        f"dmrbench_metric_{path.stem.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Bench:
    """``BENCHMARK.json`` under ``root`` and the files it names."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = self.root / DATA
        self.spec = read_json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return read_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return read_json(self.data / "traffic" / f"{name}.json")

    def limits(self, cell: str) -> dict:
        return read_json(self.data / "limits" / f"{cell}.json")

    def end_to_end(self, cell: str) -> List[dict]:
        return [m for m in self.spec["end_to_end"] if reports(m, cell)]

    def per_layer(self, cell: str) -> List[dict]:
        """The per-layer metrics of ``cell``: those that list it, and those
        without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", ())
                or ("workloads" not in m and m["moves"] in e2e)]

    def reader(self, metric: str) -> Callable:
        return load_reader(self.data / "metrics" / f"{metric}.py")

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        per_layer = self.per_layer(name)
        return Cell(name=name, entry=w, config=self.config(w["config"]),
                    mix=self.mix(w["traffic"]), limits=self.limits(name),
                    end_to_end=self.end_to_end(name), per_layer=per_layer,
                    readers={m["name"]: self.reader(m["name"])
                             for m in per_layer})

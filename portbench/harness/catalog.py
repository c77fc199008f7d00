"""Everything a cell needs, found by name.

``BENCHMARK.json`` at the root of the checkout lists the cells; a cell
names its configuration (``configs`` entry, whose ``file`` holds it) and
its traffic mix (``portbench/traffic/<mix>.json``, which names its driver,
``portbench/drivers/<driver>.py``). Each metric is read by
``portbench/metrics/<metric>.py`` and each cell's comparison limits are in
``portbench/limits/<cell>.json``. Adding a cell, a configuration, a mix or a
metric means adding files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from types import ModuleType
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(BENCH_DIR)


def _read(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _module(kind: str, name: str, root: str) -> ModuleType:
    path = os.path.join(root, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Catalog:
    """The benchmark file and the benchmark's folder (defaults: this
    checkout's)."""

    def __init__(self, repo: str = REPO_DIR, bench: str = BENCH_DIR):
        self.repo, self.bench = repo, bench
        self.spec = _read(os.path.join(repo, "BENCHMARK.json"))

    def cell(self, name: str) -> dict:
        for cell in self.spec["workloads"]:
            if cell["name"] == name:
                return cell
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{[c['name'] for c in self.spec['workloads']]}")

    def config(self, name: str) -> dict:
        for entry in self.spec["configs"]:
            if entry["name"] == name:
                return _read(os.path.join(self.repo, entry["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _read(os.path.join(self.bench, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        return _read(os.path.join(self.bench, "limits", f"{cell}.json"))

    def driver(self, name: str) -> ModuleType:
        return _module("drivers", name, self.bench)

    def reader(self, metric: str) -> ModuleType:
        return _module("metrics", metric, self.bench)

    def metrics(self, cell: str, trace: bool) -> List[dict]:
        """The metrics a run of ``cell`` reports: its end-to-end ones
        untraced, its per-layer ones traced. A metric with ``workloads``
        belongs to the cells it lists; an end-to-end one without them to
        every cell; a per-layer one without them to every cell that
        reports the end-to-end metric it moves."""
        end_to_end = [m for m in self.spec["end_to_end"]
                      if cell in m.get("workloads", [cell])]
        if not trace:
            return end_to_end
        reported = {m["name"] for m in end_to_end}
        return [m for m in self.spec["per_layer"]
                if cell in m.get("workloads", ())
                or "workloads" not in m and m["moves"] in reported]

    def readers(self, cell: str, trace: bool) -> Dict[str, tuple]:
        """{metric: (unit, reader module)} of the run's metrics."""
        return {m["name"]: (m["unit"], self.reader(m["name"])) for m in self.metrics(cell, trace)}

"""One run of one cell: set-up, the measured window, the comparison with the
reference, and the result line.

A driver (``portbench/drivers/<driver>.py``) runs the cell's loop and
returns its record: the window's work and times, the set-up seconds, the
peak memory, what a traced run saw, and the numbers compared with the
reference. The metric readers turn the record into the metrics; the
cell's limits into ``correct``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional

from . import checks, guard
from .catalog import Catalog


@dataclass
class Run:
    """What a driver is handed: the cell, its configuration (``desc`` is the
    model section), traffic mix and limits, the run's arguments, and the
    process's start time (wall clock, for the set-up time)."""

    name: str
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    started: float
    device: str = "cuda"
    argv: List[str] = field(default_factory=list)

    @property
    def desc(self) -> dict:
        return self.config["model"]

    @property
    def chips(self) -> int:
        return int(self.cell["chips"])

    def port_config(self, extra=()):
        """The program's configuration: the configuration file's overrides
        and the mix's (segments, batch)."""
        from attention_based_tbn_tpu_torch.config import load_config

        return load_config(overrides=list(self.config["overrides"]) + list(extra))

    def since_start(self) -> float:
        return time.time() - self.started


def power_limit_w() -> Optional[float]:
    """The first card's power limit by nvidia-smi (None where it cannot
    say)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def build(args, started: float, catalog: Catalog = None, device: str = "cuda") -> Run:
    catalog = catalog or Catalog()
    cell = catalog.cell(args.workload)
    return Run(name=cell["name"], cell=cell, config=catalog.config(cell["config"]),
               traffic=catalog.traffic(cell["traffic"]), seed=int(args.seed),
               seconds=float(args.seconds), trace=bool(args.trace),
               started=started, device=device,
               argv=["--workload", args.workload, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", str(args.trace)])


def result_line(run: Run, record: dict, catalog: Catalog) -> dict:
    """The contract's line from a driver's record: ``checks`` last."""
    metrics = {}
    for name, (unit, reader) in catalog.readers(run.name, run.trace).items():
        value = reader.read(record)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": unit}
    correct, judged = checks.judge(record["numbers"], catalog.limits(run.name))
    device = {"platform": "gpu", "kind": record["device_kind"], "count": run.chips,
              "memory_peak_bytes": int(record["peak_bytes"]),
              "power_limit_w": record.get("power_limit_w")}
    line = {"correct": correct and record["failed"] == 0, "attempted": int(record["attempted"]),
            "failed": int(record["failed"]), "metrics": metrics, "device": device}
    if run.trace and record.get("trace"):
        device["busy_s"] = record["trace"]["busy_s"]
        device["window_s"] = record["trace"]["wall_s"]
        line["breakdown"] = record["trace"]["breakdown"]
    line["checks"] = judged
    return line


def main(args, started: float) -> int:
    import torch

    catalog = Catalog()
    run = build(args, started, catalog)
    driver = catalog.driver(run.traffic["driver"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < run.chips:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {run.name} needs {run.chips} CUDA card(s), found {count}",
              file=sys.stderr)
        return 2
    record = driver.run(run)
    bad = guard.loaded_forbidden()
    if bad:
        print(f"portbench: the run loaded {bad}: the benchmark measures the port alone",
              file=sys.stderr)
        return 3
    record["power_limit_w"] = power_limit_w()
    line = result_line(run, record, catalog)
    print(f"setup {record['setup_s']:.3f} s: " + json.dumps(record.get("setup_phases", {})),
          file=sys.stderr)
    print("numbers: " + json.dumps(record["numbers"]), file=sys.stderr)
    if record.get("errors"):
        print("failed requests: " + json.dumps(record["errors"]), file=sys.stderr)
    if record.get("worst_leaves"):
        print("worst leaves: " + json.dumps(record["worst_leaves"]), file=sys.stderr)
    for name, judged in line["checks"].items():
        print(f"check {name}: {judged['value']!r} limit {judged['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0

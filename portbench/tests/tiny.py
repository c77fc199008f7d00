"""Cells of the benchmark cut to a size the CPU runs in seconds, for the
tests: the same drivers, configurations and limits, small shapes."""

from __future__ import annotations

import copy

from portbench.harness.catalog import Catalog
from portbench.harness.runner import Run

SMALL_OVERRIDES = ["data.test_crop_size=64", "data.train_crop_size=64",
                   "data.audio.audio_length=1.279", "model.resnet.depth=50"]


def small_config(config: dict, dtype: str = "float32") -> dict:
    config = copy.deepcopy(config)
    desc = config["model"]
    desc.update(crop=64, compute_dtype=dtype)
    desc["audio"]["seconds"] = 1.279
    if desc["attention"]:
        desc["attention"]["window"] = 8
    if desc["arch"] == "resnet":
        desc["resnet_depth"] = 50
    config["overrides"] = config["overrides"] + SMALL_OVERRIDES + [f"tpu.compute_dtype={dtype}"]
    return config


SMALL_TRAFFIC = {
    "serve_closed": {"clients": 2, "clips_per_request": 2, "segments": 2,
                     "distinct_per_client": 2, "traced_requests_per_client": 1},
    "train": {"clips_per_step": 4, "segments": 2, "distinct_batches": 4, "checked_steps": 3,
              "traced_steps": 1},
}


def small_run(cell: str, seed: int = 7, seconds: float = 1.0, dtype: str = "float32",
              catalog: Catalog = None) -> Run:
    catalog = catalog or Catalog()
    entry = catalog.cell(cell)
    traffic = catalog.traffic(entry["traffic"])
    traffic.update(SMALL_TRAFFIC[traffic["driver"]])
    return Run(name=cell, cell=entry, config=small_config(catalog.config(entry["config"]), dtype),
               traffic=traffic, seed=seed, seconds=seconds, trace=False, started=0.0,
               device="cpu")


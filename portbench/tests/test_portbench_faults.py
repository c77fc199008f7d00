"""Each fault a cell can have, planted under the timed path, turns
``correct`` false: the harness's look for a card is skipped and the rest
of a run is driven on the CPU at a small size, judged by the cell's own
limits. The same runs without a fault are correct."""

from __future__ import annotations

import pytest

from portbench.harness import faults, runner
from portbench.harness.catalog import Catalog
from portbench.tests import tiny

CASES = [("flagship.serve_b10_closed2", "altered_answer"),
         ("resnet101.serve_b10_closed2", "altered_answer"),
         ("flagship.train_b48", "unchanged_state"),
         ("flagship.train_b48", "half_batch"),
         ("flagship.train_b48", "half_batch_rows")]


def _correct(catalog: Catalog, run, record: dict) -> bool:
    record["power_limit_w"] = None
    return runner.result_line(run, record, catalog)["correct"]


@pytest.mark.parametrize("cell", sorted({c for c, _ in CASES}))
def test_a_sound_run_is_correct(cell):
    catalog = Catalog()
    run = tiny.small_run(cell, seconds=2.0 if "serve" in cell else 0.2, catalog=catalog)
    assert _correct(catalog, run, catalog.driver(run.traffic["driver"]).run(run))


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    catalog = Catalog()
    run = tiny.small_run(cell, seconds=2.0 if "serve" in cell else 0.2, catalog=catalog)
    with faults.planted(fault):
        record = catalog.driver(run.traffic["driver"]).run(run)
    assert not _correct(catalog, run, record)


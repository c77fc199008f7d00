"""The control (the reference computed in fp8, the precision below the
configurations' bfloat16, put in the program's place) is not correct by
each cell's limits, while the program is: on the CPU at a small size, and
on the card at the cell's own size on three seeds (``cuda`` marker)."""

from __future__ import annotations

import argparse
import time

import pytest

import portbench.calibrate as calibrate
from portbench.harness import checks, runner
from portbench.harness.catalog import Catalog
from portbench.tests import tiny

CELLS = ("flagship.serve_b10_closed2", "flagship.train_b48", "resnet101.serve_b10_closed2")
CARD_SEEDS = (2100000001, 2100000002, 2100000003)


def _judge(run, catalog: Catalog):
    readings = dict(calibrate.readings(run, catalog.driver(run.traffic["driver"]), control=True))
    limits = catalog.limits(run.name)
    return (checks.judge(readings["program"], limits)[0],
            checks.judge(readings["control_fp8"], limits)[0])


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_a_small_size(cell):
    catalog = Catalog()
    run = tiny.small_run(cell, seconds=2.0 if "serve" in cell else 0.2, catalog=catalog)
    assert _judge(run, catalog) == (True, False)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_at_the_cells_size(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the cell's own size runs on an NVIDIA card")
    catalog = Catalog()
    for seed in CARD_SEEDS:
        args = argparse.Namespace(workload=cell, seed=seed, seconds=2.0, trace=0)
        assert _judge(runner.build(args, time.time(), catalog), catalog) == (True, False)

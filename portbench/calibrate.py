#!/usr/bin/env python3
"""The readings that a cell's limits are set from, at the cell's own size,
in one process: for each seed the program's compared numbers (a short
window), the control's (the reference in fp8 put in the program's place),
and, where asked, the numbers with a fault planted under the timed path
and the program's own float32 path (``--float32``: the configuration's
compute dtype set to float32, TF32 off), a witness of what bf16 rounding
alone moves.

    python3 portbench/calibrate.py --workload <cell> --seconds 2 \\
        --seeds 11 12 13 --control --faults half_batch --float32

One JSON line per seed and reading on standard output. Needs the card for
the cell's real size; the tests call :func:`readings` on the CPU at a
small size.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import copy  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def float32_run(run):
    """The same run on the program's float32 path."""
    config = copy.deepcopy(run.config)
    config["model"]["compute_dtype"] = "float32"
    config["overrides"] = list(config["overrides"]) + ["tpu.compute_dtype=float32"]
    return dataclasses.replace(run, config=config)


def readings(run, driver, control: bool, faults=(), float32: bool = False):
    """Yield (reading, numbers) for one run's seed."""
    from portbench.harness import faults as planted
    from portbench.reference.precision import Precision

    record = driver.run(run)
    yield "program", dict(record["numbers"], setup_s=record["setup_s"],
                          worst_leaves=record.get("worst_leaves"))
    if control:
        yield "control_fp8", driver.control_numbers(run, record, Precision("fp8"))
    del record
    for fault in faults:
        with planted.planted(fault):
            yield f"fault_{fault}", driver.run(run)["numbers"]
    if float32:
        record = driver.run(float32_run(run))
        yield "program_float32", dict(record["numbers"], worst_leaves=record.get("worst_leaves"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--faults", nargs="*", default=[])
    parser.add_argument("--float32", action="store_true")
    args = parser.parse_args(argv)

    import torch

    from portbench.harness import runner
    from portbench.harness.catalog import Catalog

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    catalog = Catalog()
    for seed in args.seeds:
        ns = argparse.Namespace(workload=args.workload, seed=seed, seconds=args.seconds, trace=0)
        run = runner.build(ns, time.time(), catalog)
        driver = catalog.driver(run.traffic["driver"])
        for reading, numbers in readings(run, driver, args.control, args.faults, args.float32):
            print(json.dumps({"cell": run.name, "seed": seed, "reading": reading, **numbers}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

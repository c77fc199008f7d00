#!/usr/bin/env python3
"""Run one cell of the port's benchmark once on the card and print its line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix, driver, metrics and limits are found by
name (``portbench/harness/catalog.py``). With ``--trace 0`` the line holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.
Exits non-zero, printing no result, without enough cards, or when JAX or
the JAX package was loaded.
"""

import time

STARTED = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache at a fixed path inside the checkout
CACHE = os.path.join(REPO, ".portbench_cache")
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(CACHE, _sub)
os.environ["USE_FLAX"] = "0"
if REPO not in sys.path:
    sys.path.insert(0, REPO)


def parse(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return parser.parse_args(argv)


if __name__ == "__main__":
    from portbench.harness import runner

    sys.exit(runner.main(parse(), STARTED))

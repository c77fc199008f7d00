"""Time a checkout's ceil max pool kernel against torch's pool on the card.

The twelve stride-2 pools of one train step (12 x 3 = 36 rows, bf16, the
layouts the step hands the kernel: RGB and Flow channels-last, Audio NCHW),
forward alone and forward + backward (``torch.autograd.grad``), each on two
yardsticks:

* ``event``: CUDA events around back-to-back calls; where the wrapper's host
  work takes longer than the kernel, this is the host's pace;
* ``graph``: the calls captured in one CUDA graph and replayed between CUDA
  events: the device's own time, the host out of the way.

``--root`` names the checkout whose package is imported (default: the one
holding this file), so two commits are compared on one card by unpacking
the older one with ``git archive`` into a git-ignored directory and running
this script once per checkout, in the order old, new, new, old:

    python3 attention_based_tbn_tpu_torch/tools/pool_timing.py --root DIR --label NAME

Prints the card's name and power limit (``nvidia-smi``), then one JSON line:
per pool and summed over the twelve, each time the median of ``--repeats``
measurements. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

# Run as a file, this script's directory leads sys.path; its neighbours
# (serve.py, test.py, train.py) must not shadow other modules.
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import torch  # noqa: E402

VISUAL = ((64, 112, 112), (192, 56, 56), (320, 28, 28), (608, 14, 14))
AUDIO = ((64, 128, 210), (192, 64, 105), (320, 32, 52), (608, 16, 26))
# (shape, channels_last) of the twelve stride-2 pools of one train step
STEP_POOLS = ([(s, True) for s in VISUAL] * 2) + [(s, False) for s in AUDIO]
ROWS = 36


def event_ms(fn, iters: int = 20) -> float:
    """Mean ms of one call by CUDA events around ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms of one call: ``iters`` calls in one CUDA graph, replayed
    between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def median(values: list) -> float:
    values = sorted(values)
    return values[len(values) // 2]


def time_pool(kernels, shape, channels_last: bool, gen, repeats: int) -> dict:
    """ms of the kernel's and torch's forward and forward + backward on one
    pool's input, on both yardsticks."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.randn(ROWS, *shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    x = x.contiguous(memory_format=fmt)
    xg = x.detach().requires_grad_(True)
    g = torch.randn(kernels.ceil_max_pool2d_plain(x).shape, generator=gen, device="cuda",
                    dtype=torch.bfloat16).contiguous(memory_format=fmt)
    fns = {
        "kernel_fwd": lambda: kernels.ceil_max_pool2d(x),
        "torch_fwd": lambda: kernels.ceil_max_pool2d_plain(x),
        "kernel_fwd_bwd": lambda: torch.autograd.grad(kernels.ceil_max_pool2d(xg), xg, g),
        "torch_fwd_bwd": lambda: torch.autograd.grad(kernels.ceil_max_pool2d_plain(xg), xg, g),
    }
    times = {}
    for name, fn in fns.items():
        times[f"{name}_event_ms"] = median([event_ms(fn) for _ in range(repeats)])
        try:
            times[f"{name}_graph_ms"] = median([graph_ms(fn) for _ in range(repeats)])
        except RuntimeError as err:  # a route that cannot be captured: say so
            times[f"{name}_graph_ms"] = None
            times[f"{name}_graph_error"] = str(err)[:300]
    return times


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                        help="checkout whose attention_based_tbn_tpu_torch is timed")
    parser.add_argument("--label", default="", help="name of the checkout in the output")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("pool_timing: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from attention_based_tbn_tpu_torch.ops import kernels  # the checkout's own package

    if not os.path.abspath(kernels.__file__).startswith(root + os.sep):
        print(f"pool_timing: imported {kernels.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    pools = []
    for shape, channels_last in STEP_POOLS:
        pools.append({"shape": list(shape),
                      "layout": "channels_last" if channels_last else "nchw",
                      **time_pool(kernels, shape, channels_last, gen, args.repeats)})
    keys = [k for k in pools[0] if k.endswith("_ms")]
    print(json.dumps({"phase": "pool_timing", "label": args.label, "root": root, "gpu": card,
                      "torch": torch.__version__, "rows": ROWS, "dtype": "bfloat16",
                      "repeats": args.repeats,
                      "step_sums": {k: (None if any(p[k] is None for p in pools)
                                        else sum(p[k] for p in pools)) for k in keys},
                      "pools": pools}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

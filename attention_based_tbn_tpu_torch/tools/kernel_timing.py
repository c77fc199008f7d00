"""Time a checkout's kernels on the card, beside the library's calls.

``--kernels`` picks any of:

* ``max_pool``: the twelve stride-2 pools of one train step (12 x 3 = 36
  rows, bf16, the layouts the step hands the kernel: RGB and Flow
  channels-last, Audio NCHW), forward alone and forward + backward
  (``torch.autograd.grad``), beside torch's pool; per pool and summed;
* ``conv3x3`` (bf16) at the fused-block probe's default (200 x 28 x 28 x 96
  -> 128) and at BN-Inception's inception_3a_double_3x3_1 (250 x 28 x 28 x
  64 -> 96) and inception_5a_3x3 (250 x 7 x 7 x 192 -> 320), beside cuDNN's
  conv + ReLU on the same NHWC memory;
* ``consensus_heads`` (bf16, verb / noun heads 125 + 352) at the
  evaluation's (2, 250, 512) and a served b=10 request's (10, 25, 512).

Each on two yardsticks, from ``utils/timing.py`` beside this file (the same
for every checkout timed):

* ``event``: CUDA events around back-to-back calls; where the wrapper's host
  work takes longer than the kernel, this is the host's pace;
* ``graph``: the calls captured in one CUDA graph and replayed between CUDA
  events: the device's own time, the host out of the way.

``--root`` names the checkout whose package is imported (default: the one
holding this file), so two commits are compared on one card by unpacking
the older one with ``git archive`` into a git-ignored directory and running
this script once per checkout, in the order old, new, new, old:

    python3 attention_based_tbn_tpu_torch/tools/kernel_timing.py --root DIR --label NAME

Prints the card's name and power limit (``nvidia-smi``), then one JSON line,
each time the median of ``--repeats`` measurements. Exits 1 without a CUDA
device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
from statistics import median

# Run as a file, this script's directory leads sys.path; its neighbours
# (serve.py, test.py, train.py) must not shadow other modules.
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402


def _load_timing():
    """utils/timing.py of this file's checkout, whichever checkout is timed."""
    path = os.path.join(os.path.dirname(_HERE), "utils", "timing.py")
    spec = importlib.util.spec_from_file_location("kernel_timing_yardsticks", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_TIMING = _load_timing()

VISUAL = ((64, 112, 112), (192, 56, 56), (320, 28, 28), (608, 14, 14))
AUDIO = ((64, 128, 210), (192, 64, 105), (320, 32, 52), (608, 16, 26))
# (shape, channels_last) of the twelve stride-2 pools of one train step
STEP_POOLS = ([(s, True) for s in VISUAL] * 2) + [(s, False) for s in AUDIO]
POOL_ROWS = 36
# (case, rows, H, W, C_in, C_out)
CONV_CASES = (
    ("probe", 200, 28, 28, 96, 128),
    ("inception_3a_double_3x3_1", 250, 28, 28, 64, 96),
    ("inception_5a_3x3", 250, 7, 7, 192, 320),
)
CONSENSUS_SHAPES = ((2, 250), (10, 25))  # (B, N); F = 512
HEADS = (125, 352)
FUSION = 512
KERNELS = ("max_pool", "conv3x3", "consensus_heads")


def times(fns: dict, repeats: int) -> dict:
    """Median event and graph ms of each function; a call that cannot be
    captured in a graph says so in ``<name>_graph_error``."""
    out = {}
    for name, fn in fns.items():
        out[f"{name}_event_ms"] = median([_TIMING.event_ms(fn) for _ in range(repeats)])
        try:
            out[f"{name}_graph_ms"] = median([_TIMING.graph_ms(fn, 20) for _ in range(repeats)])
        except RuntimeError as err:
            out[f"{name}_graph_ms"] = None
            out[f"{name}_graph_error"] = str(err)[:300]
    return out


def pool_case(kernels, shape, channels_last: bool, gen, repeats: int) -> dict:
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    x = torch.randn(POOL_ROWS, *shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    x = x.contiguous(memory_format=fmt)
    xg = x.detach().requires_grad_(True)
    g = torch.randn(kernels.ceil_max_pool2d_plain(x).shape, generator=gen, device="cuda",
                    dtype=torch.bfloat16).contiguous(memory_format=fmt)
    return times({
        "kernel_fwd": lambda: kernels.ceil_max_pool2d(x),
        "torch_fwd": lambda: kernels.ceil_max_pool2d_plain(x),
        "kernel_fwd_bwd": lambda: torch.autograd.grad(kernels.ceil_max_pool2d(xg), xg, g),
        "torch_fwd_bwd": lambda: torch.autograd.grad(kernels.ceil_max_pool2d_plain(xg), xg, g),
    }, repeats)


def max_pool(kernels, gen, repeats: int) -> dict:
    pools = [{"shape": list(shape), "layout": "channels_last" if channels_last else "nchw",
              **pool_case(kernels, shape, channels_last, gen, repeats)}
             for shape, channels_last in STEP_POOLS]
    keys = [k for k in pools[0] if k.endswith("_ms")]
    return {"rows": POOL_ROWS,
            "step_sums": {k: (None if any(p[k] is None for p in pools)
                              else sum(p[k] for p in pools)) for k in keys},
            "pools": pools}


def conv_case(kernels, rows, h, w, c_in, c_out, gen, repeats: int) -> dict:
    x = torch.randn(rows, h, w, c_in, generator=gen, device="cuda").bfloat16()
    weight = (torch.randn(c_out, c_in, 3, 3, generator=gen, device="cuda")
              / (9 * c_in) ** 0.5).bfloat16()
    bias = torch.randn(c_out, generator=gen, device="cuda").bfloat16()
    x_nchw = x.permute(0, 3, 1, 2)  # channels-last view of the NHWC memory
    weight_cl = weight.contiguous(memory_format=torch.channels_last)
    got = kernels.conv3x3(x, weight, bias).float()
    want = kernels.conv3x3_plain(x, weight, bias).float()
    return {"max_abs_err_vs_plain": (got - want).abs().max().item(), **times({
        "kernel": lambda: kernels.conv3x3(x, weight, bias),
        "cudnn": lambda: F.relu(F.conv2d(x_nchw, weight_cl, bias, 1, 1), inplace=True),
    }, repeats)}


def conv3x3(kernels, gen, repeats: int) -> list:
    torch.backends.cudnn.allow_tf32 = False
    return [{"case": case, "rows": rows, "shape": [h, w, c_in, c_out],
             **conv_case(kernels, rows, h, w, c_in, c_out, gen, repeats)}
            for case, rows, h, w, c_in, c_out in CONV_CASES]


def consensus_case(kernels, b, n, gen, repeats: int) -> dict:
    feats = torch.randn(b, n, FUSION, generator=gen, device="cuda").relu().bfloat16()
    weights = [(torch.randn(c, FUSION, generator=gen, device="cuda") * 0.03).bfloat16()
               for c in HEADS]
    biases = [(torch.randn(c, generator=gen, device="cuda") * 0.1).bfloat16() for c in HEADS]
    got = kernels.consensus_heads(feats, weights, biases)
    want = kernels.consensus_heads_plain(feats, weights, biases)
    err = max((g - w).abs().max().item() for g, w in zip(got, want))
    return {"max_abs_err_vs_plain": err, **times(
        {"kernel": lambda: kernels.consensus_heads(feats, weights, biases)}, repeats)}


def consensus_heads(kernels, gen, repeats: int) -> list:
    return [{"shape": [b, n, FUSION], "heads": list(HEADS),
             **consensus_case(kernels, b, n, gen, repeats)} for b, n in CONSENSUS_SHAPES]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(_HERE)),
                        help="checkout whose attention_based_tbn_tpu_torch is timed")
    parser.add_argument("--label", default="", help="name of the checkout in the output")
    parser.add_argument("--kernels", default=",".join(KERNELS),
                        help=f"comma-separated, of {', '.join(KERNELS)}")
    parser.add_argument("--repeats", type=int, default=5)
    args = parser.parse_args(argv)
    chosen = [k for k in args.kernels.split(",") if k]
    if not chosen or any(k not in KERNELS for k in chosen):
        parser.error(f"--kernels: {args.kernels!r}, not a list of {', '.join(KERNELS)}")
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device available", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from attention_based_tbn_tpu_torch.ops import kernels  # the checkout's own package

    if not os.path.abspath(kernels.__file__).startswith(root + os.sep):
        print(f"kernel_timing: imported {kernels.__file__}, not from {root}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timers = {"max_pool": max_pool, "conv3x3": conv3x3, "consensus_heads": consensus_heads}
    results = {k: timers[k](kernels, gen, args.repeats) for k in chosen}
    print(json.dumps({"phase": "kernel_timing", "label": args.label, "root": root, "gpu": card,
                      "torch": torch.__version__, "dtype": "bfloat16", "repeats": args.repeats,
                      **results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

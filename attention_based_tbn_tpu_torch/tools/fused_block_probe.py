"""Probe: can a hand-written 3x3 / stride-1 / pad-1 conv + bias + ReLU beat
the library's on the card?

    python -m attention_based_tbn_tpu_torch.tools.fused_block_probe [H W Cin Cout] \\
        [--device cuda|cpu] [--dtype bfloat16|float32]

The port's counterpart of the JAX package's ``benchmarks/fused_block_probe.py``;
its answer decides whether a fused inception-block kernel is worth building.
The defaults are that probe's: a batch of 200 NHWC (28, 28, 96) maps -> 128
channels, bf16. The inputs are drawn as that probe draws them:
``np.random.default_rng(0)`` gives x, then the HWIO kernel / sqrt(9 Cin),
then the bias, each rounded to the type from float32, so both probes see
the same numbers.

Prints the relative error (max |got - want| / max |want|, the JAX probe's
formula) of the kernel (``ops/kernels.conv3x3``) against the library
composition, cuDNN ``F.conv2d(x, w, b)`` then ``F.relu`` in channels-last
(two calls; TF32 off at float32), and against the plain version
(``ops/kernels.conv3x3_plain``); then, for the library composition and the
kernel, ms and TF/s on two yardsticks: CUDA events around 50 back-to-back
calls, and one CUDA graph of 50 calls (the counterpart of the JAX probe's
50-step ``fori_loop`` chain: dispatch out of the measurement). The last
line is all of it as one JSON object. With ``--device cpu`` the wrapper
runs the plain version and nothing is timed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from ..models.bridge import conv3x3_weight_from_jax
from ..ops import kernels
from ..utils.device import resolve_device, tf32_scope
from ..utils.timing import event_ms, graph_ms

BATCH = 200
DEFAULT_SHAPE = (28, 28, 96, 128)  # H, W, Cin, Cout
CHAIN = 50  # calls per timing, as the JAX probe's chain
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def probe_inputs(h: int, w: int, cin: int, cout: int, dtype, device):
    """x (BATCH, H, W, Cin), the torch-layout weight and the bias, drawn in
    the JAX probe's order from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, h, w, cin))
    kernel = rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)
    bias = rng.standard_normal(cout)

    def tensor(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)

    return tensor(x), tensor(conv3x3_weight_from_jax(kernel)), tensor(bias)


def rel_err(got, want) -> float:
    """max |got - want| / max(max |want|, 1e-6), in float32."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max().clamp_min(1e-6)).item()


def parse_args(argv):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("shape", nargs="*", type=int, help="H W Cin Cout (default 28 28 96 128)")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--dtype", default="bfloat16", choices=sorted(DTYPES))
    args = parser.parse_args(argv)
    if args.shape and len(args.shape) != 4:
        parser.error(f"give all four of H W Cin Cout, got {args.shape}")
    return args


def main(argv=None) -> dict:
    """Run the probe; prints its lines and returns the JSON line's object."""
    args = parse_args(argv)
    h, w, cin, cout = args.shape or DEFAULT_SHAPE
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    flops = 2 * BATCH * h * w * 9 * cin * cout
    result = {"probe": "fused_block", "device": str(device), "dtype": args.dtype,
              "batch": BATCH, "shape": [h, w, cin, cout], "flops": flops,
              "gpu": torch.cuda.get_device_name(device) if device.type == "cuda" else None}
    with tf32_scope(args.dtype):
        x, weight, bias = probe_inputs(h, w, cin, cout, dtype, device)
        # the library composition on NHWC memory: a channels-last NCHW view
        x_nchw = x.permute(0, 3, 1, 2)
        weight_cl = weight.contiguous(memory_format=torch.channels_last)

        def library():
            return F.relu(F.conv2d(x_nchw, weight_cl, bias, 1, 1), inplace=True)

        def kernel():
            return kernels.conv3x3(x, weight, bias)

        got = kernel()
        result["rel_err_vs_library"] = rel_err(got, library().permute(0, 2, 3, 1))
        result["rel_err_vs_plain"] = rel_err(got, kernels.conv3x3_plain(x, weight, bias))
        print(f"rel err {result['rel_err_vs_library']:.2e} vs the library, "
              f"{result['rel_err_vs_plain']:.2e} vs the plain version", flush=True)
        for name, fn in (("library", library), ("conv3x3", kernel)):
            if device.type != "cuda":
                result[name] = {"ms": None, "graph_ms": None, "tflops": None, "graph_tflops": None}
                continue
            ms, g_ms = event_ms(fn, CHAIN), graph_ms(fn, CHAIN)
            result[name] = {"ms": ms, "graph_ms": g_ms, "tflops": flops / ms / 1e9,
                            "graph_tflops": flops / g_ms / 1e9}
            print(f"{name:8s} ({BATCH},{h},{w},{cin})->{cout}: {ms:7.3f} ms "
                  f"{flops / ms / 1e9:6.1f} TF/s; graph {g_ms:7.3f} ms "
                  f"{flops / g_ms / 1e9:6.1f} TF/s", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()

"""The least time the chip could take for the work of each hand-written
kernel of the port, from the shapes the cell runs.

Least time = max(operations / peak operations, bytes / peak bandwidth),
each input byte counted read once and each output byte written once,
whatever the kernel reads again; the operations at the peak of the units
the kernel computes on (the bf16 tensor cores for the PE block, MHA and
the stem; the float32 units for the pool and the consensus heads).
Copied from the smoke's ``*_cost`` functions so that a later change to
the program cannot move the yardstick.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

_DIR = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(_DIR, "peaks.json")) as _fh:
    PEAKS = json.load(_fh)
with open(os.path.join(_DIR, "kernel_names.json")) as _fh:
    KERNEL_NAMES = {k: v for k, v in json.load(_fh).items() if k != "about"}

STEM_CHANNELS = 64


def least_s(bytes_moved: float, ops: float, ops_per_s: float) -> float:
    return max(bytes_moved / PEAKS["hbm_bytes_per_s"], ops / ops_per_s)


def ceil_out(size: int) -> int:
    """Output size of a 3x3 / stride-2 / pad-0 ceil-mode pool."""
    return -(-(size - 3) // 2) + 1


def pe_block(rows: int, s: int, e: int, d: int, elt: int) -> float:
    moved = elt * (2 * rows * s * e + e * (e + d) + 3 * e + s * d)
    ops = 2 * rows * s * e * e + 2 * s * d * e + 7 * rows * s * e
    return least_s(moved, ops, PEAKS["bf16_flops_per_s"])


def mha(rows: int, s: int, e: int, elt: int) -> float:
    # query, keyval (read once: keys and values come from it), output,
    # weights; the four projections' parameters
    moved = elt * (2 * rows * e + rows * s * e + rows * s + 4 * e * e + 4 * e)
    ops = 4 * rows * e * e + 4 * rows * s * e * e + 4 * rows * s * e
    return least_s(moved, ops, PEAKS["bf16_flops_per_s"])


def max_pool(rows: int, c: int, h: int, w: int, elt: int, backward: bool) -> float:
    """Forward: input read, output written, 8 comparisons an output. With
    ``backward`` the training pair: also a tap byte an output written, and
    the gradient and the taps read and the input's gradient written."""
    inputs = rows * c * h * w
    outputs = rows * c * ceil_out(h) * ceil_out(w)
    moved = elt * (inputs + outputs)
    ops = 8 * outputs
    if backward:
        moved += outputs + elt * outputs + outputs + elt * inputs
        ops += 4 * inputs
    return least_s(moved, ops, PEAKS["fp32_flops_per_s"])


def fused_stem(rows: int, h: int, w: int, c: int, in_elt: int, elt: int) -> float:
    """Normalize, 7x7 / 2 conv to 64 channels, bias, ReLU, 3x3 / 2 pool."""
    conv_out = rows * STEM_CHANNELS * (h // 2) * (w // 2)
    pooled = rows * STEM_CHANNELS * (h // 4) * (w // 4)
    moved = (rows * h * w * c * in_elt + STEM_CHANNELS * c * 49 * elt
             + 4 * (STEM_CHANNELS + 2 * c) + pooled * elt)
    ops = conv_out * (2 * 49 * c + 2) + 8 * pooled + 2 * rows * h * w * c
    return least_s(moved, ops, PEAKS["bf16_flops_per_s"])


def consensus_heads(b: int, n: int, f: int, classes: int, elt: int) -> float:
    moved = elt * (b * n * f + classes * f + classes) + 4 * b * classes
    ops = b * n * f + 2 * b * f * classes
    return least_s(moved, ops, PEAKS["fp32_flops_per_s"])


def work(kernels: List[str], shapes: dict, train: bool) -> Dict[str, float]:
    """{kernel: least seconds for one request (serving) or one step
    (training)} of the ``kernels`` the configuration's path runs, at
    ``shapes`` (costs/flops.model_shapes)."""
    rows, elt = shapes["rows"], shapes["elt"]
    out: Dict[str, float] = {}
    if "pe_block" in kernels:
        out["pe_block"] = pe_block(rows, shapes["seq"], shapes["width"], shapes["pe_channels"],
                                   elt)
    if "mha" in kernels:
        out["mha"] = mha(rows, shapes["seq"], shapes["width"], elt)
    if "fused_stem" in kernels:
        out["fused_stem"] = sum(fused_stem(rows, h, w, c, in_elt, elt)
                                for h, w, c, in_elt in shapes["stems"])
    if "consensus_heads" in kernels:
        out["consensus_heads"] = consensus_heads(shapes["clips"], shapes["segments"],
                                                 shapes["fusion"], shapes["classes"], elt)
    if "max_pool" in kernels:
        pools = []
        for tower in shapes["pools"]:
            # a fused stem pools its own output: the tower's first pool
            pools += tower[1:] if "fused_stem" in kernels else tower
        out["max_pool"] = sum(max_pool(rows, c, h, w, elt, train) for c, h, w in pools)
    return out

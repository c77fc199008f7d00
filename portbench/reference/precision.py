"""Operand rounding of the reference: float32 (none) or the control's fp8.

The configurations state bfloat16; the nearest precision below it is fp8.
The control is the reference with every convolution, projection and
product operand, and every convolution and projection output (the
activations a program stores), rounded to float8 e4m3 with a per-tensor
scale (amax over 448, e4m3's largest normal), as the bfloat16 program
rounds them to bfloat16. In training the rounding is straight-through:
the forward sees the fp8 values, the backward runs in float32 through
them.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0
PRECISIONS = ("float32", "fp8")


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in PRECISIONS:
            raise ValueError(f"precision {name!r} not in {PRECISIONS}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        value = x.detach()
        scale = value.abs().amax().clamp_min(1e-30) / E4M3_MAX
        rounded = (value / scale).to(torch.float8_e4m3fn).to(value.dtype) * scale
        if x.requires_grad:
            return x + (rounded - value)
        return rounded


FLOAT32 = Precision("float32")

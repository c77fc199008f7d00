"""BN-Inception feature tower, NCHW.

Port of the JAX package's ``models/bn_inception.py``: the public
Inception-BN graph the reference takes from ``pretrainedmodels``

    stem: 7x7/2 conv(64) -> maxpool/2 -> 1x1 conv(64) -> 3x3 conv(192) -> maxpool/2
    inception 3a 3b | 3c(/2) | 4a 4b 4c 4d | 4e(/2) | 5a 5b -> global avg pool

with torch ``ceil_mode`` pools. Every conv is followed by BatchNorm and
ReLU. At eval the BatchNorm folds into the conv (layers.FoldCache); in
training (``.train()``) it runs on live batch statistics in float32 and
updates the running statistics (layers.batch_norm_train), with a per-row
mask that keeps a loader's pad rows out of them. The conv bias cancels
through live BatchNorm, so in training the conv runs without it and the
running mean records it, as the JAX package does (its bias gradient is
then None rather than zero: the optimizer reads it as zero). Statistics
keep updating under ``partialbn``, which only freezes affine parameters in
the optimizer.

``pool_impl`` (``tpu.pool_impl``) and ``pool_fast_vjp``
(``tpu.pool_fast_vjp``) go to every max pool (ops/pooling.max_pool2d);
with "pallas" the four 3x3 / stride-2 ceil pools (stem pool1 and pool2,
the passthrough of inception 3c and 4e) run the hand-written kernel on a
CUDA tensor; ``pool_fast_vjp`` gives every pool the kernel does not take
the JAX package's all-ties gradient in training.

``fused_stem`` (``tpu.fused_stem``): at eval, a 7x7 stem on an input whose
H and W are multiples of 4 runs normalize -> conv -> BN -> ReLU -> pool1 as
one kernel (ops/kernels.fused_stem), on the conv's BN-folded float32
weights rounded to the compute type and a float32 bias, as the JAX package
gates it (bn_inception.py:563-589). Training, the audio stem and other
shapes keep the regular stem and pool1.

Modules are flat attributes named as in the reference state dict
(``conv1_7x7_s2`` + ``conv1_7x7_s2_bn``, ``inception_3a_1x1`` + ``..._bn``),
so weights in the reference ``.pth`` layout load with ``strict=True``.

Head variants (reference bn_inception.py:16-35): global average pool ->
(B, 1024); ``freq_pool_only`` (audio tower under attention) pools the
frequency axis only -> (B, T, 1024). ``audio_stem`` replaces the 7x7 stem
with two parallel stride-2 convs, (3,1) and (1,3), concatenated to 64
channels (reference bn_inception_audio.py:11-23; the reference's "1x3" conv
has a (3,1) kernel and vice versa).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.kernels import fused_stem, fused_stem_shape_error
from ..ops.pooling import avg_pool2d, global_avg_pool, max_pool2d
from .layers import BN_EPSILON, FoldCache, batch_norm_train, variance_scaling_


@dataclass(frozen=True)
class InceptionSpec:
    """Channel widths of one Inception-BN block."""

    b1x1: int  # 1x1 branch (0 = reduction block, branch absent)
    r3x3: int  # 3x3 branch reduce
    b3x3: int  # 3x3 branch out
    rd3x3: int  # double-3x3 branch reduce
    d3x3: int  # double-3x3 branch out (both convs)
    proj: int  # pool-projection out (0 = passthrough max pool)
    pool: str  # "avg" or "max" pool branch
    stride: int = 1


# Standard Inception-BN configuration. Output channels:
# 3a 256, 3b 320, 3c 576, 4a-4b 576, 4c-4d 608, 4e 1056, 5a-5b 1024.
BN_INCEPTION_BLOCKS: Tuple[Tuple[str, InceptionSpec], ...] = (
    ("inception_3a", InceptionSpec(64, 64, 64, 64, 96, 32, "avg")),
    ("inception_3b", InceptionSpec(64, 64, 96, 64, 96, 64, "avg")),
    ("inception_3c", InceptionSpec(0, 128, 160, 64, 96, 0, "max", stride=2)),
    ("inception_4a", InceptionSpec(224, 64, 96, 96, 128, 128, "avg")),
    ("inception_4b", InceptionSpec(192, 96, 128, 96, 128, 128, "avg")),
    ("inception_4c", InceptionSpec(160, 128, 160, 128, 160, 128, "avg")),
    ("inception_4d", InceptionSpec(96, 128, 192, 160, 192, 128, "avg")),
    ("inception_4e", InceptionSpec(0, 128, 192, 192, 256, 0, "max", stride=2)),
    ("inception_5a", InceptionSpec(352, 192, 320, 160, 224, 128, "avg")),
    ("inception_5b", InceptionSpec(352, 192, 320, 192, 224, 128, "max")),
)

FEATURE_SIZE = 1024


class BNInception(nn.Module):
    """BN-Inception tower; ``forward`` runs the eval graph or, in training
    mode, the train graph."""

    feature_size = FEATURE_SIZE

    def __init__(self, in_channels: int, freq_pool_only: bool = False,
                 audio_stem: bool = False, pool_impl: str = "reduce_window",
                 fused_stem: bool = False, pool_fast_vjp: bool = False):
        super().__init__()
        self.freq_pool_only = freq_pool_only
        self.audio_stem = audio_stem
        self.pool_impl = pool_impl
        self.pool_fast_vjp = pool_fast_vjp
        self.fused_stem = fused_stem
        self._folded = FoldCache()
        if audio_stem:
            self._conv_bn("conv1_1x3_s2", in_channels, 32, (3, 1), 2, (1, 0))
            self._conv_bn("conv1_3x1_s2", in_channels, 32, (1, 3), 2, (0, 1))
        else:
            self._conv_bn("conv1_7x7_s2", in_channels, 64, 7, 2, 3)
        self._conv_bn("conv2_3x3_reduce", 64, 64, 1)
        self._conv_bn("conv2_3x3", 64, 192, 3, 1, 1)
        cin = 192
        for name, s in BN_INCEPTION_BLOCKS:
            if s.b1x1:
                self._conv_bn(f"{name}_1x1", cin, s.b1x1, 1)
            self._conv_bn(f"{name}_3x3_reduce", cin, s.r3x3, 1)
            self._conv_bn(f"{name}_3x3", s.r3x3, s.b3x3, 3, s.stride, 1)
            self._conv_bn(f"{name}_double_3x3_reduce", cin, s.rd3x3, 1)
            self._conv_bn(f"{name}_double_3x3_1", s.rd3x3, s.d3x3, 3, 1, 1)
            self._conv_bn(f"{name}_double_3x3_2", s.d3x3, s.d3x3, 3, s.stride, 1)
            if s.proj:
                self._conv_bn(f"{name}_pool_proj", cin, s.proj, 1)
            cin = s.b1x1 + s.b3x3 + s.d3x3 + (s.proj if s.proj else cin)

    def _conv_bn(self, name, cin, cout, kernel, stride=1, padding=0):
        self.add_module(name, nn.Conv2d(cin, cout, kernel, stride, padding))
        self.add_module(f"{name}_bn", nn.BatchNorm2d(cout, eps=BN_EPSILON))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: fan-out truncated-normal conv kernels,
        zero biases, identity BatchNorm."""
        for module in self.children():
            if isinstance(module, nn.Conv2d):
                variance_scaling_(module.weight, 2.0, "fan_out", generator)
                module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def _cbr(self, name: str, x: torch.Tensor,
             row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Conv + BN + ReLU, computed in x's dtype: BN folded into the conv at
        eval, live float32 BN in training."""
        conv, bn = getattr(self, name), getattr(self, f"{name}_bn")
        if self.training:
            y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
            return F.relu(batch_norm_train(y, bn, conv.bias, row_mask).to(x.dtype))
        w, b = self._folded.get(name, conv, bn, x.dtype)
        # in place: the conv's backward needs its input and weight, not its output
        return F.relu(F.conv2d(x, w, b, conv.stride, conv.padding), inplace=True)

    def uses_fused_stem(self, x: torch.Tensor) -> bool:
        """Whether the fused stem takes NCHW ``x`` in the current mode."""
        return (self.fused_stem and not self.training and not self.audio_stem
                and not fused_stem_shape_error(x.permute(0, 2, 3, 1)))

    def _fused_stem(self, x: torch.Tensor, dtype: torch.dtype,
                    input_scale: Optional[torch.Tensor],
                    input_offset: Optional[torch.Tensor]) -> torch.Tensor:
        """Stem + pool1 of NCHW ``x`` (raw uint8 with its affine, or float)
        in one kernel; the tower's input is NHWC memory, read as it lies."""
        conv, bn = self.conv1_7x7_s2, self.conv1_7x7_s2_bn
        w, b = self._folded.get("conv1_7x7_s2/fused", conv, bn, dtype, torch.float32)
        if input_scale is None:
            input_scale = torch.ones(x.shape[1], device=x.device)
            input_offset = torch.zeros(x.shape[1], device=x.device)
        return fused_stem(x.permute(0, 2, 3, 1).contiguous(), w, b, input_scale, input_offset,
                          dtype)

    def _max_pool(self, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
        return max_pool2d(x, 3, stride, padding, ceil_mode=True, impl=self.pool_impl,
                          fast_vjp=self.pool_fast_vjp)

    def _block(self, name: str, s: InceptionSpec, x: torch.Tensor,
               row_mask: Optional[torch.Tensor]) -> torch.Tensor:
        def cbr(cell, inp):
            return self._cbr(f"{name}_{cell}", inp, row_mask)

        branches = []
        if s.b1x1:
            branches.append(cbr("1x1", x))
        branches.append(cbr("3x3", cbr("3x3_reduce", x)))
        branches.append(cbr("double_3x3_2", cbr("double_3x3_1", cbr("double_3x3_reduce", x))))
        if s.proj:
            if s.pool == "avg":
                pooled = avg_pool2d(x, 3, 1, 1, ceil_mode=True, count_include_pad=True)
            else:
                pooled = self._max_pool(x, 1, 1)
            branches.append(cbr("pool_proj", pooled))
        else:
            branches.append(self._max_pool(x, s.stride, 0))
        return torch.cat(branches, dim=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                input_scale: Optional[torch.Tensor] = None,
                input_offset: Optional[torch.Tensor] = None,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW input -> features in ``dtype``.

        (input_scale, input_offset): per-channel affine that normalizes a raw
        uint8 input, applied in ``dtype`` before the stem's zero padding.
        ``row_mask``: 0/1 per row, training only; zero rows are left out of
        every BatchNorm statistic."""
        if self.uses_fused_stem(x):
            y = self._fused_stem(x, dtype, input_scale, input_offset)
        else:
            x = x.to(dtype)
            if input_scale is not None:
                x = (x * input_scale.to(dtype)[:, None, None]
                     + input_offset.to(dtype)[:, None, None])
            if self.audio_stem:
                y = torch.cat([self._cbr("conv1_1x3_s2", x, row_mask),
                               self._cbr("conv1_3x1_s2", x, row_mask)], dim=1)
            else:
                y = self._cbr("conv1_7x7_s2", x, row_mask)
            y = self._max_pool(y, 2, 0)
        y = self._cbr("conv2_3x3", self._cbr("conv2_3x3_reduce", y, row_mask), row_mask)
        y = self._max_pool(y, 2, 0)
        for name, s in BN_INCEPTION_BLOCKS:
            y = self._block(name, s, y, row_mask)
        return global_avg_pool(y, freq_only=self.freq_pool_only)

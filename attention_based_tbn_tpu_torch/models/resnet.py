"""torchvision-layout ResNet feature towers, NCHW.

Port of the JAX package's ``models/resnet.py`` (reference
core/models/resnet.py): torchvision's resnet{18,34,50,101,152} without its
``fc`` classifier, ending in a global average pool to ``feature_size =
512 * expansion`` features. A modality with other input channels than 3
gets a first conv of its own width (``models/convert.adapt_first_conv``
mean-tiles a pretrained one).

The torchvision network sits under ``model`` (the reference wraps it so:
``Base_<m>.model.conv1.weight``, ``Base_<m>.model.layer1.0.downsample.1.
running_var``), so a reference state dict loads with ``strict=True``.

Every conv is bias-free and followed by BatchNorm, applied after the conv
in the compute dtype as the JAX package does (``layers.conv_bn``: not
folded). The stem is the plain 7x7 / 2 / pad 3 conv: the JAX package's
``space_to_depth`` stem is an exact TPU rewrite of the same conv and is not
ported. The 3x3 / 2 / pad 1 max pool is floor-mode and runs torch's pool:
the JAX package runs it through ``reduce_window``, not its Pallas pool.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import global_avg_pool, max_pool2d
from .layers import BN_EPSILON, CastCache, conv_bn, variance_scaling_

# depth -> (block type, blocks per stage, expansion), the JAX package's table
RESNET_CONFIGS = {
    18: ("basic", (2, 2, 2, 2), 1),
    34: ("basic", (3, 4, 6, 3), 1),
    50: ("bottleneck", (3, 4, 6, 3), 4),
    101: ("bottleneck", (3, 4, 23, 3), 4),
    152: ("bottleneck", (3, 8, 36, 3), 4),
}
WIDTHS = (64, 128, 256, 512)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, kernel, stride, kernel // 2, bias=False)


def _bn(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=BN_EPSILON)


class _Block(nn.Module):
    """A residual block: ``conv<i>`` + ``bn<i>`` for each (C_in, C_out,
    kernel, stride) of ``shapes``, ReLU between them, and the
    ``downsample`` 1x1 conv + BN on the identity where the stride or the
    width changes."""

    def __init__(self, shapes, cin: int, cout: int, stride: int):
        super().__init__()
        for i, (a, b, k, s) in enumerate(shapes, start=1):
            self.add_module(f"conv{i}", _conv(a, b, k, s))
            self.add_module(f"bn{i}", _bn(b))
        self.n_convs = len(shapes)
        self.downsample = None
        if stride != 1 or cin != cout:
            self.downsample = nn.Sequential(_conv(cin, cout, 1, stride), _bn(cout))

    def forward(self, x: torch.Tensor, cache: CastCache, prefix: str,
                row_mask: Optional[torch.Tensor]) -> torch.Tensor:
        y = x
        for i in range(1, self.n_convs + 1):
            y = conv_bn(y, getattr(self, f"conv{i}"), getattr(self, f"bn{i}"), cache,
                        f"{prefix}.conv{i}", row_mask)
            if i < self.n_convs:
                y = F.relu(y, inplace=not self.training)
        if self.downsample is not None:
            x = conv_bn(x, self.downsample[0], self.downsample[1], cache,
                        f"{prefix}.downsample", row_mask)
        return F.relu(y + x, inplace=not self.training)


class BasicBlock(_Block):
    """torchvision's BasicBlock: two 3x3 convs, the first with the stride."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__(((cin, width, 3, stride), (width, width, 3, 1)), cin, width, stride)


class Bottleneck(_Block):
    """torchvision's Bottleneck: 1x1, 3x3 with the stride, 1x1 to 4x the
    width."""

    expansion = 4

    def __init__(self, cin: int, width: int, stride: int):
        cout = width * self.expansion
        super().__init__(((cin, width, 1, 1), (width, width, 3, stride), (width, cout, 1, 1)),
                         cin, cout, stride)


class ResNetBody(nn.Module):
    """The torchvision module tree: conv1, bn1, layer1..layer4."""

    def __init__(self, in_channels: int, depth: int):
        super().__init__()
        kind, sizes, expansion = RESNET_CONFIGS[depth]
        block = BasicBlock if kind == "basic" else Bottleneck
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        cin = 64
        for stage, (width, n_blocks) in enumerate(zip(WIDTHS, sizes), start=1):
            blocks = []
            for i in range(n_blocks):
                blocks.append(block(cin, width, 2 if stage > 1 and i == 0 else 1))
                cin = width * expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))


class ResNet(nn.Module):
    """ResNet tower: NCHW input -> (B, feature_size) in the compute dtype."""

    def __init__(self, in_channels: int, depth: int = 101):
        super().__init__()
        self.feature_size = 512 * RESNET_CONFIGS[depth][2]
        self.model = ResNetBody(in_channels, depth)
        self._cast = CastCache()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: fan-out truncated-normal conv kernels,
        identity BatchNorm."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                variance_scaling_(module.weight, 2.0, "fan_out", generator)
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``row_mask``: 0/1 per row, training only; zero rows are left out
        of every BatchNorm statistic."""
        net = self.model
        y = conv_bn(x.to(dtype), net.conv1, net.bn1, self._cast, "conv1", row_mask)
        y = max_pool2d(F.relu(y, inplace=not self.training), 3, 2, 1)
        for stage in range(1, 5):
            for i, block in enumerate(getattr(net, f"layer{stage}")):
                y = block(y, self._cast, f"layer{stage}.{i}", row_mask)
        return global_avg_pool(y)

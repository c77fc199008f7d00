"""torchvision-layout VGG feature towers, NCHW.

Port of the JAX package's ``models/vgg.py`` (reference core/models/vgg.py):
torchvision's vgg{11,16}[_bn] without the classifier's last Linear. Each
conv (with bias) is followed by BatchNorm on the ``bn`` types (applied
after the conv, ``layers.conv_bn``) and ReLU; an ``"M"`` of the config is a
2x2 / 2 max pool. Then the adaptive average pool to 7 x 7, an NCHW flatten
to 25088, and the classifier's two Linear (4096) + ReLU + Dropout(0.5)
stages, the tower's 4096 features. Dropout draws from the forward's
``torch.Generator``.

Module names are torchvision's, under ``model`` as the reference wraps
them: ``model.features.<i>`` at torchvision's indices (conv, [bn,] ReLU,
..., pool) and ``model.classifier.0`` / ``model.classifier.3``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import adaptive_avg_pool2d, max_pool2d
from .layers import (BN_EPSILON, CastCache, conv_bn, dropout, reset_linear_,
                     variance_scaling_)

# torchvision cfgs: number = conv out-channels, "M" = 2x2/2 max pool
VGG_CONFIGS = {
    "11": (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
           512, 512, 512, "M"),
}
FEATURE_SIZE = 4096
POOL_HW = (7, 7)
DROPOUT = 0.5  # the classifier's two dropouts (the JAX package's default)


def vgg_base_type(vgg_type: str) -> str:
    """A VGG type string ("16", "16bn", "11_bn", ...) -> its VGG_CONFIGS key,
    exactly as the JAX package normalizes it."""
    return vgg_type.rstrip("bn").rstrip("_") or vgg_type


def vgg_conv_feature_indices(vgg_type: str, batch_norm: bool) -> Dict[int, int]:
    """torchvision ``features.<idx>`` of each conv -> its index among the
    convs (the JAX package's ``convert.vgg_conv_feature_indices``)."""
    mapping = {}
    feat_idx = conv_idx = 0
    for item in VGG_CONFIGS[vgg_base_type(vgg_type)]:
        if item == "M":
            feat_idx += 1
        else:
            mapping[feat_idx] = conv_idx
            feat_idx += 3 if batch_norm else 2  # conv (+ bn) + relu
            conv_idx += 1
    return mapping


class VGGBody(nn.Module):
    """The torchvision module tree: ``features`` and ``classifier``, their
    children keyed by torchvision's indices; the parameter-free ones (ReLU,
    pools, dropout) are left out and applied functionally."""

    def __init__(self, in_channels: int, vgg_type: str):
        super().__init__()
        cfg = VGG_CONFIGS[vgg_base_type(vgg_type)]
        batch_norm = vgg_type.endswith("bn")
        convs = vgg_conv_feature_indices(vgg_type, batch_norm)
        widths = [c for c in cfg if c != "M"]
        modules, cin = {}, in_channels
        for idx, conv in convs.items():
            modules[str(idx)] = nn.Conv2d(cin, widths[conv], 3, 1, 1)
            if batch_norm:
                modules[str(idx + 1)] = nn.BatchNorm2d(widths[conv], eps=BN_EPSILON)
            cin = widths[conv]
        self.features = nn.ModuleDict(modules)
        self.classifier = nn.ModuleDict({
            "0": nn.Linear(cin * POOL_HW[0] * POOL_HW[1], FEATURE_SIZE),
            "3": nn.Linear(FEATURE_SIZE, FEATURE_SIZE)})
        # the forward's plan: a conv's feature index, or "M"
        plan, feat = [], 0
        for item in cfg:
            plan.append("M" if item == "M" else feat)
            feat += 1 if item == "M" else (3 if batch_norm else 2)
        self.plan = tuple(plan)
        self.batch_norm = batch_norm


class VGG(nn.Module):
    """VGG tower: NCHW input -> (B, 4096) in the compute dtype."""

    feature_size = FEATURE_SIZE

    def __init__(self, in_channels: int, vgg_type: str = "16"):
        super().__init__()
        self.dropout_rate = DROPOUT
        self.model = VGGBody(in_channels, vgg_type)
        self._cast = CastCache()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: fan-out truncated-normal conv kernels and
        zero biases, identity BatchNorm, lecun-normal Linear kernels and
        zero biases."""
        for module in self.modules():
            if isinstance(module, nn.Conv2d):
                variance_scaling_(module.weight, 2.0, "fan_out", generator)
                module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()
            elif isinstance(module, nn.Linear):
                reset_linear_(module, generator)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                row_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``row_mask``: 0/1 per row, training only; zero rows are left out
        of every BatchNorm statistic. ``generator``: the dropout's noise,
        training only."""
        net = self.model
        y = x.to(dtype)
        for item in net.plan:
            if item == "M":
                y = max_pool2d(y, 2, 2, 0)
                continue
            bn = net.features[str(item + 1)] if net.batch_norm else None
            y = conv_bn(y, net.features[str(item)], bn, self._cast, f"features.{item}", row_mask)
            y = F.relu(y, inplace=not self.training)
        # torchvision pools to 7 x 7 whatever the input size, then flattens
        # in NCHW order
        y = adaptive_avg_pool2d(y, POOL_HW).flatten(1)
        for idx in ("0", "3"):
            layer = net.classifier[idx]
            # TorchLinear: the product rounded to dtype, then the rounded bias
            w, b = self._cast.get(f"classifier.{idx}", (layer.weight, layer.bias), dtype)
            y = F.relu(F.linear(y.to(dtype), w) + b)
            if self.training:
                y = dropout(y, self.dropout_rate, generator)
        return y

"""Fusion and the multi-head classifier (reference
core/models/model.py:337-387; JAX package ``models/heads.py``).

* Fusion: Linear(sum of tower features -> 512) + ReLU + Dropout (training
  only, noise from the caller's generator), weights N(0, 1e-3), zero bias;
* Classifier: one Linear head per class type (verb / noun), same init.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import dropout, linear, reset_linear_

HEAD_INIT_STD = 1e-3


class Fusion(nn.Module):
    def __init__(self, in_features: int, out_size: int = 512, dropout_rate: float = 0.0):
        super().__init__()
        self.dropout_rate = dropout_rate
        # reference layout: fusion_layer = Sequential(Linear, ReLU, Dropout);
        # only the Linear holds parameters
        self.fusion_layer = nn.Sequential(nn.Linear(in_features, out_size))

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_linear_(self.fusion_layer[0], generator, std=HEAD_INIT_STD)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: torch.Generator = None) -> torch.Tensor:
        y = F.relu(linear(x, self.fusion_layer[0], dtype))
        if self.training:
            y = dropout(y, self.dropout_rate, generator)
        return y


class Classifier(nn.ModuleDict):
    def __init__(self, in_features: int, num_classes: Mapping[str, int]):
        super().__init__({name: nn.Linear(in_features, n) for name, n in num_classes.items()})

    def reset_parameters(self, generator: torch.Generator) -> None:
        for head in self.values():
            reset_linear_(head, generator, std=HEAD_INIT_STD)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> Dict[str, torch.Tensor]:
        return {name: linear(x, head, dtype) for name, head in self.items()}

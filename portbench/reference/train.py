"""One training step of the TBN recipe in plain PyTorch, float32.

The recipe (EPIC-Fusion's training, as the attention recipe runs it):
cross-entropy per head, summed; SGD with momentum (``buf = g`` on the
first step, then ``buf = m * buf + g``; ``p -= lr * buf``), no weight
decay; the gradients of the trainable parameters clipped to a global norm
of ``clip`` first; under ``partialbn`` every BatchNorm affine parameter of
a tower is frozen except the first one's (the stem's); the running
statistics move with momentum 0.1 towards the batch's mean and unbiased
variance. A conv bias in front of BatchNorm cancels in training; its
gradient is nought to rounding.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import tbn
from .precision import FLOAT32, Precision

STEM_BNS = ("conv1_7x7_s2_bn", "model.bn1")


def trainable(spec: Dict[str, tuple], freeze: str) -> List[str]:
    """The names the optimizer updates: parameters (not statistics or the
    table), without the frozen BatchNorm affines under ``partialbn``."""
    names = []
    for name, (_, kind, _) in spec.items():
        if kind in ("bn_mean", "bn_var", "count", "pe_table"):
            continue
        if freeze == "partialbn" and kind in ("bn_weight", "bn_bias") and name.startswith("Base_"):
            module = name.split(".", 1)[1].rsplit(".", 1)[0]
            if module not in STEM_BNS:
                continue
        names.append(name)
    return names


def loss_of(out: Dict[str, torch.Tensor], labels: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    losses = {head: F.cross_entropy(out[head], labels[head].long()) for head in labels}
    losses["total"] = sum(losses.values())
    return losses


class Trainer:
    """The reference's training state: float32 parameters, momentum buffers
    and the dropout generator; :meth:`step` takes one batch."""

    def __init__(self, params: Dict[str, torch.Tensor], desc: dict, recipe: dict,
                 generator: torch.Generator, prec: Precision = FLOAT32):
        self.desc, self.recipe, self.prec = desc, recipe, prec
        self.spec = tbn.param_spec(desc)
        self.names = trainable(self.spec, recipe["freeze"])
        self.params = {k: v.detach().clone().float() for k, v in params.items()}
        self.buffers: Dict[str, torch.Tensor] = {}
        self.generator = generator
        self.first_grads: Dict[str, torch.Tensor] = {}

    def step(self, batch: dict, labels: Dict[str, torch.Tensor]):
        """One step; returns (the losses, the step's logits per head)."""
        leaves = {k: self.params[k].requires_grad_(True) for k in self.names}
        ctx = tbn.Context(train=True, generator=self.generator, prec=self.prec)
        out = tbn.forward(self.params, self.desc, batch, ctx)
        losses = loss_of(out, labels)
        grads = torch.autograd.grad(losses["total"], [leaves[k] for k in self.names],
                                    allow_unused=True)
        grads = [torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(self.names, grads)]
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads)).float()
        scale = torch.clamp(self.recipe["clip"] / norm, max=1.0)
        momentum, lr = self.recipe["momentum"], self.recipe["lr"]
        with torch.no_grad():
            for k, g in zip(self.names, grads):
                g = g * scale
                buf = self.buffers.get(k)
                buf = g if buf is None else momentum * buf + g
                self.buffers[k] = buf
                self.params[k] = (self.params[k] - lr * buf).detach()
            if not self.first_grads:
                self.first_grads = {k: self.buffers[k].clone() for k in self.names}
            m = self.recipe["bn_momentum"]
            for bn, (mean, var) in ctx.stats.items():
                for leaf, value in (("running_mean", mean), ("running_var", var)):
                    key = f"{bn}.{leaf}"
                    self.params[key] = (1 - m) * self.params[key] + m * value
        return ({k: float(v.detach()) for k, v in losses.items()},
                {head: out[head].detach() for head in labels})

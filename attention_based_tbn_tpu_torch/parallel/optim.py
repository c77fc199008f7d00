"""Optimizer, learning-rate schedule and parameter freezing.

Port of the JAX package's ``parallel/optim.py`` (reference
core/tools/train.py:189-217, core/models/model.py:148-176):

* SGD(momentum) + MultiStepLR(milestones, gamma), or Adam;
* the GradualWarmupScheduler ramp (``lr_at_epoch``);
* global grad-norm clipping over the TRAINABLE parameters only (in the JAX
  package the clip sits inside ``optax.multi_transform``'s "train" branch);
* weight decay added to the clipped gradient;
* freeze rules ``all`` (whole towers frozen) and ``partialbn`` (BN affine
  parameters frozen except the stem's first BN; see ``STEM_BN_TRAINABLE``),
  which applies to BN-Inception only: ResNet and VGG towers train every
  parameter under it, as in the reference, and a warning says so as the
  JAX package's does;
* gradient accumulation as ``optax.MultiSteps``: the mean gradient of
  ``accumulator_step`` backward passes, one update every k of them;
* with several ranks (``parallel/mesh``), each backward's gradients summed
  over the ranks first (one flat buffer per dtype): the losses are the
  ranks' shares of the global mean, so the sum is the global gradient
  (an average, as DDP's, would divide by the world a second time), and
  the clip sees the global norm, as ``optax.clip_by_global_norm`` does
  under SPMD.

The update itself is ``torch.optim``'s where it equals optax's: SGD with
momentum and no dampening keeps ``buf = m * buf + g`` (the first step
``buf = g``) and steps by ``-lr * buf``, as ``optax.sgd``'s trace does, and
its ``weight_decay`` adds ``wd * p`` to the gradient it is given, i.e. after
the clip, as ``optax.add_decayed_weights`` sits after ``clip_by_global_norm``
in the chain; ``torch.optim.Adam`` with eps 1e-8 is ``optax.adam``'s bias-
corrected update (L2 decay, not AdamW, on both sides).
"""

from __future__ import annotations

import logging
from typing import Dict, List

import torch

from . import mesh

# Stem modules whose BN affine parameters stay trainable under partialbn:
# the reference keeps the tower's FIRST BN child trainable, conv1_7x7_s2_bn
# on the 7x7 stem and conv1_1x3_s2_bn on the two-branch audio stem (its
# Audio clause is dead code, so conv1_3x1_s2_bn is frozen as written).
STEM_BN_TRAINABLE = ("conv1_7x7_s2", "conv1_1x3_s2")


def lr_at_epoch(cfg, epoch: int) -> float:
    """MultiStepLR ``lr * gamma^(milestones passed)``, with the optional
    warmup ramp: epoch ``e <= T`` trains at ``base * e / T`` (multiplier 1)
    or ``base * ((m - 1) * e / T + 1)``, later epochs at
    ``base * m * gamma^(milestones <= e - T)``. Adam keeps its base LR."""
    base = float(cfg.train.optim.lr)
    if cfg.train.optim.type.lower() == "adam":
        return base
    steps = list(cfg.train.scheduler.lr_steps or [])
    gamma = float(cfg.train.scheduler.lr_decay)
    warm = cfg.train.warmup
    if not warm.enable:
        return base * (gamma ** sum(1 for s in steps if epoch >= s))
    total = max(int(warm.epochs), 1)
    mult = float(warm.multiplier)
    if mult < 1.0:
        raise ValueError("train.warmup.multiplier must be >= 1")
    if epoch <= total:
        if mult == 1.0:
            return base * epoch / total
        return base * ((mult - 1.0) * epoch / total + 1.0)
    return base * mult * (gamma ** sum(1 for s in steps if epoch - total >= s))


def freeze_labels(model: torch.nn.Module, cfg) -> Dict[str, str]:
    """{parameter name: "train" or "freeze"} by the config's freeze rule."""
    freeze_base = bool(cfg.model.freeze_base)
    mode = cfg.model.freeze_mode
    arch = cfg.model.arch
    partial = mode == "partialbn" and arch == "bninception"
    if freeze_base and mode == "partialbn" and not partial:
        # the reference ignores partialbn for these towers without a word
        # (model.py:164); the JAX package's warning (parallel/optim.py:84-96)
        logging.getLogger(__name__).warning(
            "model.freeze_mode='partialbn' only applies to the bninception "
            "arch (reference model.py:164-176); arch=%r trains ALL tower "
            "parameters — use model.freeze_mode='all' to freeze the towers.",
            arch,
        )
    labels = {}
    for name, _ in model.named_parameters():
        tower, _, rest = name.partition(".")
        label = "train"
        if freeze_base and tower.startswith("Base_"):
            module = rest.rpartition(".")[0]
            if mode == "all":
                label = "freeze"
            elif partial and module.endswith("_bn") and module[:-3] not in STEM_BN_TRAINABLE:
                label = "freeze"
        labels[name] = label
    return labels


class Optimizer:
    """The trainable parameters' update rule; frozen parameters are never
    touched. Call :meth:`step` after each ``backward``: it clips, decays,
    accumulates and updates, and clears the gradients."""

    def __init__(self, cfg, model: torch.nn.Module):
        opt_cfg = cfg.train.optim
        labels = freeze_labels(model, cfg)
        named = dict(model.named_parameters())
        self.trainable: List[torch.nn.Parameter] = [
            p for n, p in named.items() if labels[n] == "train"]
        self.frozen_names = [n for n, label in labels.items() if label == "freeze"]
        self.clip = float(cfg.train.clip_grad or 0)
        self.every_k = max(int(opt_cfg.accumulator_step), 1)
        self._acc: List[torch.Tensor] = []
        self._micro = 0
        lr, wd = float(opt_cfg.lr), float(opt_cfg.weight_decay)
        kind = opt_cfg.type.lower()
        if kind == "sgd":
            self.inner = torch.optim.SGD(self.trainable, lr=lr, momentum=float(opt_cfg.momentum),
                                         dampening=0.0, weight_decay=wd, nesterov=False)
        elif kind == "adam":
            self.inner = torch.optim.Adam(self.trainable, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                          weight_decay=wd)
        else:
            raise ValueError(f"Unsupported optimizer {opt_cfg.type!r}")
        self._model = model

    def _grads(self) -> List[torch.Tensor]:
        # a parameter autograd did not reach (a conv bias under live BN) has
        # gradient zero, as it has in the JAX package's tree
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in self.trainable]

    def step(self) -> bool:
        """Apply one micro-step; returns True when the parameters changed."""
        grads = self._grads()
        mesh.all_reduce_flat_(grads)
        self._model.zero_grad(set_to_none=True)
        if self.every_k > 1:
            # optax.MultiSteps' running mean: acc += (g - acc) / (micro + 1)
            if not self._acc:
                self._acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(self._acc, grads):
                a.add_((g - a) / (self._micro + 1))
            self._micro += 1
            if self._micro < self.every_k:
                return False
            grads, self._acc, self._micro = self._acc, [], 0
        if self.clip > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            torch._foreach_mul_(grads, scale)
        for p, g in zip(self.trainable, grads):
            p.grad = g
        self.inner.step()
        for p in self.trainable:
            p.grad = None
        return True

    def state_dict(self) -> Dict:
        """What a restored optimizer needs to step exactly as this one
        would: the inner ``torch.optim`` state (momentum or Adam moments,
        the learning rate) and the partial accumulation of
        ``accumulator_step`` (its running mean and micro-step count)."""
        return {"inner": self.inner.state_dict(), "acc": list(self._acc),
                "micro": self._micro, "lr": self.current_learning_rate()}

    def load_state_dict(self, state: Dict) -> None:
        if not isinstance(state, dict) or set(state) != {"inner", "acc", "micro", "lr"}:
            raise ValueError("not an optimizer state of the port (Optimizer.state_dict): "
                             f"keys {sorted(state) if isinstance(state, dict) else state!r}")
        acc = list(state["acc"])
        if acc and len(acc) != len(self.trainable):
            raise ValueError(f"the saved accumulation holds {len(acc)} tensors for "
                             f"{len(self.trainable)} trainable parameters")
        self.inner.load_state_dict(state["inner"])
        self._acc = [a.to(p.device, p.dtype) for a, p in zip(acc, self.trainable)]
        self._micro = int(state["micro"])
        self.set_learning_rate(state["lr"])

    def set_learning_rate(self, lr: float) -> None:
        for group in self.inner.param_groups:
            group["lr"] = float(lr)

    def current_learning_rate(self) -> float:
        return float(self.inner.param_groups[0]["lr"])

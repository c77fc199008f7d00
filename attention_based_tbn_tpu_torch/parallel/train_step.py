"""Train, eval and infer steps.

Port of the JAX package's ``parallel/train_step.py`` (reference
core/tools/train.py:69-104) for one device: forward, loss, backward, grad
clip, optimizer update and the BatchNorm running-stat update of one batch.
PyTorch runs eagerly, so where the JAX package compiles a masked and an
unmasked program and routes a batch between them on ``true_bs`` (the loader
pads a ragged batch to the mesh size), here the same routing decides
whether the forward and the loss get a pad-row mask at all: a full batch
(``true_bs == rows``) takes no mask and pays for none.

The state is updated in place (the model's parameters and statistics, the
optimizer's buffers, the step count, the generator); each step returns it
so that callers read like the JAX package's. The scanned and the fused
accumulation steps (``make_multi_train_step``, ``make_fused_accum_step``)
are opt-ins that are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ..models.losses import tbn_loss
from ..models.tbn import TBNModel
from ..utils.device import tf32_scope
from .optim import Optimizer


@dataclass
class TrainState:
    """The model, its optimizer, the step count and the noise source of
    every dropout and gumbel draw (a generator on the model's device)."""

    model: TBNModel
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device


def create_train_state(cfg, model: TBNModel, seed: int = None) -> TrainState:
    """A train state around ``model`` with the config's optimizer; the noise
    generator is seeded from ``seed`` (default ``cfg.data.manual_seed``)."""
    device = next(model.parameters()).device
    seed = int(cfg.data.manual_seed if seed is None else seed)
    return TrainState(model, Optimizer(cfg, model),
                      torch.Generator(device=device).manual_seed(seed))


def to_device(tree: Any, device: torch.device) -> Any:
    """numpy arrays and tensors of a nested dict -> tensors on ``device``."""
    if isinstance(tree, Mapping):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return torch.as_tensor(tree).to(device, non_blocking=True)
    return tree


def _rows(batch: Mapping[str, Any]) -> int:
    return next(int(v.shape[0]) for v in batch.values() if hasattr(v, "shape"))


def make_train_step(cfg) -> Callable:
    """fn(state, batch, targets, epoch, true_bs) -> (state, loss dict,
    preds). Rows from ``true_bs`` on are padding: masked out of every loss
    mean and every BatchNorm statistic. Losses and predictions are detached
    device tensors; nothing synchronizes with the host."""

    def step(state: TrainState, batch, targets, epoch: int, true_bs: int):
        model = state.model
        model.train()
        batch = to_device(batch, state.device)
        targets = to_device(targets, state.device)
        tb = None if int(true_bs) == _rows(batch) else int(true_bs)
        # the backward's convolutions and products take the forward's TF32 rule
        with tf32_scope(model.spec.compute_dtype):
            preds = model(batch, true_batch=tb, generator=state.generator)
            loss = tbn_loss(preds, targets, cfg, epoch=epoch, train=True,
                            attention_weights=preds.get("weights"), true_batch=tb)
            loss["total"].backward()
        state.optimizer.step()
        state.step += 1
        return state, _detach(loss), _detach(preds)

    return step


def make_eval_step(cfg) -> Callable:
    """fn(state, batch, targets, epoch, true_bs) -> (loss dict, preds), with
    running-statistics BatchNorm; pad rows are masked out of the loss."""

    @torch.no_grad()
    def step(state: TrainState, batch, targets, epoch: int, true_bs: int):
        model = state.model
        model.eval()
        batch = to_device(batch, state.device)
        targets = to_device(targets, state.device)
        tb = None if int(true_bs) == _rows(batch) else int(true_bs)
        preds = model(batch)
        loss = tbn_loss(preds, targets, cfg, epoch=epoch, train=False,
                        attention_weights=preds.get("weights"), true_batch=tb)
        return loss, preds

    return step


def make_infer_step() -> Callable:
    """fn(state, batch) -> preds: the eval forward alone."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        state.model.eval()
        return state.model(to_device(batch, state.device))

    return step


def _detach(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

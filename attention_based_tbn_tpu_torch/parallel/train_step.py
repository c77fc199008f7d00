"""Train, eval and infer steps.

Port of the JAX package's ``parallel/train_step.py`` (reference
core/tools/train.py:69-104): forward, loss, backward, grad clip, optimizer
update and the BatchNorm running-stat update of one batch. PyTorch runs
eagerly, so where the JAX package compiles a masked and an unmasked
program and routes a batch between them on ``true_bs`` (the loader pads a
ragged batch to the mesh size), here the same routing decides whether the
forward and the loss get a pad-row mask at all: a full global batch
(``true_bs`` = the global rows) takes no mask and pays for none.

Several ranks (``parallel/mesh``, one process per card under ``torchrun``)
run the JAX package's SPMD step: each takes its contiguous slice of the
global batch; BatchNorm's statistics and every loss mean are the global
batch's; the gradients are summed over the ranks (``optim.Optimizer``)
and every rank takes the same update. The steps return the global losses
and the global batch's predictions on every rank, as the JAX package's
replicated outputs.

The state is updated in place (the model's parameters and statistics, the
optimizer's buffers, the step count, the generator); each step returns it
so that callers read like the JAX package's.

Noise: every dropout and gumbel draw of a run comes from ONE
``torch.Generator`` that runs on across steps and epochs, where the JAX
package folds the epoch into its key (tools/train.py:399). The generator's
state is part of the checkpoint (:meth:`TrainState.state_dict`), so a
resumed run draws what an uninterrupted one would have drawn.

The JAX package's scanned and fused accumulation steps
(``make_multi_train_step`` under ``tpu.steps_per_call``,
``make_fused_accum_step`` under ``tpu.fuse_accum``) group steps into one
TPU dispatch; they state the math of sequential steps, which is what the
port runs (``tools/train.run_trainer`` warns that the keys do nothing).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

from ..models.losses import tbn_loss
from ..models.tbn import TBNModel
from ..utils.device import tf32_scope
from . import mesh
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

    def state_dict(self) -> Dict[str, Any]:
        """The optimizer's state, the generator's state and the step count
        (the model's weights are saved on their own, in the reference
        layout)."""
        return {"optimizer": self.optimizer.state_dict(),
                "generator": self.generator.get_state(), "step": int(self.step)}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        """Restore what :meth:`state_dict` holds; keys a file lacks keep
        their current value."""
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        if "generator" in state:
            self.generator.set_state(torch.as_tensor(state["generator"], dtype=torch.uint8))
        if "step" in state:
            self.step = int(state["step"])


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


def _true_batch(batch: Mapping[str, Any], true_bs: int):
    """None for a full global batch, else the global true batch size."""
    return None if int(true_bs) == _rows(batch) * mesh.world_size() else int(true_bs)


def global_losses(loss: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The ranks' loss shares summed into the global losses, by one
    collective (the dict itself for one process)."""
    if mesh.world_size() == 1:
        return loss
    keys = list(loss)
    device = next(v.device for v in loss.values() if isinstance(v, torch.Tensor))
    stacked = torch.stack([torch.as_tensor(loss[k], dtype=torch.float32, device=device)
                           for k in keys])
    return dict(zip(keys, mesh.all_reduce_(stacked).unbind()))


def global_rows(tree: Any) -> Any:
    """Every tensor of a nested dict as the global batch's rows on every
    rank (``mesh.gather_rows``): the predictions, and the labels the
    metrics read (the tree itself for one process)."""
    if isinstance(tree, Mapping):
        return {k: global_rows(v) for k, v in tree.items()}
    return mesh.gather_rows(tree) if isinstance(tree, torch.Tensor) else tree


def make_train_step(cfg) -> Callable:
    """fn(state, batch, targets, epoch, true_bs) -> (state, loss dict,
    preds). Rows from ``true_bs`` (of the global batch) on are padding:
    masked out of every loss mean and every BatchNorm statistic. Losses
    (global) and predictions (the global batch's) are detached device
    tensors; nothing synchronizes with the host."""

    def step(state: TrainState, batch, targets, epoch: int, true_bs: int):
        model = state.model
        model.train()
        batch = to_device(batch, state.device)
        targets = to_device(targets, state.device)
        tb = _true_batch(batch, true_bs)
        # the backward's convolutions and products take the forward's TF32 rule
        with tf32_scope(model.spec.compute_dtype):
            preds = model(batch, true_batch=tb, generator=state.generator)
            loss = tbn_loss(preds, targets, cfg, epoch=epoch, train=True,
                            attention_weights=preds.get("weights"), true_batch=tb)
            loss["total"].backward()
        state.optimizer.step()
        state.step += 1
        return state, global_losses(_detach(loss)), global_rows(_detach(preds))

    return step


def make_eval_step(cfg) -> Callable:
    """fn(state, batch, targets, epoch, true_bs) -> (loss dict, preds), with
    running-statistics BatchNorm; pad rows are masked out of the loss. The
    losses are global and the predictions the global batch's."""

    @torch.no_grad()
    def step(state: TrainState, batch, targets, epoch: int, true_bs: int):
        model = state.model
        model.eval()
        batch = to_device(batch, state.device)
        targets = to_device(targets, state.device)
        tb = _true_batch(batch, true_bs)
        preds = model(batch)
        loss = tbn_loss(preds, targets, cfg, epoch=epoch, train=False,
                        attention_weights=preds.get("weights"), true_batch=tb)
        return global_losses(loss), global_rows(preds)

    return step


def make_infer_step() -> Callable:
    """fn(state, batch) -> preds: the eval forward alone (the global
    batch's predictions)."""

    @torch.no_grad()
    def step(state: TrainState, batch):
        state.model.eval()
        return global_rows(state.model(to_device(batch, state.device)))

    return step


def _detach(tree: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in tree.items()}

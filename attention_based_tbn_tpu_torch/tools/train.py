"""The training loop: an epoch of train steps, and validation.

Port of the sequential path of the JAX package's ``tools/train.py``
(``train_one_epoch`` :83-241, ``validate`` :244-256). Both take any loader
that yields ``(batch, targets, meta)`` with ``meta["batch_size"]`` the true
batch size (the contract of the JAX package's ``data/loader.py``), has a
``__len__`` (the number of batches) and a ``set_epoch``.

Not ported yet: ``run_trainer`` and ``main.py`` (the data pipeline, the
checkpoints and the TensorBoard scalars around this loop wait for the data
slice), and the grouped dispatch of ``tpu.steps_per_call`` and
``tpu.fuse_accum``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..utils.metrics import Metric


def train_one_epoch(cfg, state, step_fn, loader, metric: Metric, epoch: int, logger):
    """One pass over ``loader`` through ``step_fn`` (parallel/train_step.
    make_train_step); returns (state, the epoch's mean losses). Logs the
    running loss four times an epoch and the epoch's clips/s, measured to
    the metric's readback, which waits for every step to finish."""
    no_batches = max(len(loader), 1)
    log_interval = max(no_batches // 4, 1)
    loss_tracker = None  # device-resident running loss: no per-step sync
    step_times = []
    clips_done = 0
    epoch_start = time.perf_counter()
    loader.set_epoch(epoch)
    for iter_no, (batch, targets, meta) in enumerate(loader):
        bs = int(meta["batch_size"])
        step_start = time.perf_counter()
        state, loss, preds = step_fn(state, batch, targets, epoch, bs)
        step_times.append(time.perf_counter() - step_start)
        clips_done += bs
        metric.update(preds, targets, loss, batch_size=bs)
        total = loss["total"]
        loss_tracker = total if loss_tracker is None else loss_tracker + total
        if iter_no == 0 or (iter_no + 1) % log_interval == 0:
            logger.info(
                "Batch Progress: [{}/{}] || Train Loss: {:.5f} || {:.3f} s/step".format(
                    iter_no + 1, no_batches, float(loss_tracker) / (iter_no + 1),
                    float(np.mean(step_times[-log_interval:])),
                )
            )
    train_loss, _, _ = metric.compute()
    wall = time.perf_counter() - epoch_start
    if clips_done and wall > 0:
        logger.info(
            "Train epoch throughput: {:.2f} clips/s ({} clips in {:.1f} s, loader in "
            "loop, synced by the metric readback)".format(clips_done / wall, clips_done, wall)
        )
    return state, train_loss


def validate(cfg, state, eval_fn, loader, epoch: int, logger):
    """Losses and accuracies of ``eval_fn`` (make_eval_step) over
    ``loader``: (loss, accuracy, confusion matrices)."""
    metric = Metric(cfg, max(len(loader), 1))
    with torch.no_grad():
        for batch, targets, meta in loader:
            bs = int(meta["batch_size"])
            loss, preds = eval_fn(state, batch, targets, epoch, bs)
            metric.update(preds, targets, loss, batch_size=bs)
    return metric.compute()

"""Training: epochs of train steps, validation, checkpoints.

Port of the JAX package's ``tools/train.py`` (reference core/tools/
train.py): ``run_trainer`` builds the data mesh (``parallel/mesh``: one
process per card under ``torchrun``, or one process), the model and the
loaders (each rank its shard of every global batch), loads the pretrained
towers on every rank (seeded and read from the same files, so the ranks
start equal), and runs epochs of ``train_one_epoch`` at the learning
rate of ``lr_at_epoch``, each followed by ``validate`` (``val.enable``) and
a checkpoint (utils/checkpoint.py; the best one under ``train.save_best``),
with TensorBoard scalars; ``train.pre_trained`` resumes a checkpoint and
extends ``train.epochs`` by the epochs it holds, as the reference does. Rank 0
writes the checkpoints (every rank restores from them) and the
TensorBoard scalars.

``train_one_epoch`` and ``validate`` take any loader that yields
``(batch, targets, meta)`` with ``meta["batch_size"]`` the true size of the
global batch (the contract of ``data/loader.py``), has a ``__len__`` (the
number of batches) and a ``set_epoch``; the metrics read the global
batch's predictions and labels, the same on every rank.

``tpu.steps_per_call`` and ``tpu.fuse_accum`` group steps into one TPU
dispatch in the JAX package, with the math of sequential steps (it refuses
them across processes); here they do nothing but log a warning, and every
batch is one step, on any number of ranks.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

from ..data.loader import create_dataloader
from ..models.builder import build_model, load_pretrained_towers
from ..parallel.mesh import make_mesh
from ..parallel.optim import lr_at_epoch
from ..parallel.train_step import (create_train_state, global_rows, make_eval_step,
                                   make_train_step, to_device)
from ..utils.checkpoint import restore_checkpoint, save_checkpoint, wait_until_finished
from ..utils.logging import Plotter
from ..utils.metrics import Metric
from ..utils.misc import get_time_diff


def _start_profile(device: torch.device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, run_dir: str, logger) -> None:
    prof.stop()
    out_dir = os.path.join(run_dir, "profile")
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    logger.info(f"Saved the profiler trace to {out_dir}")


def train_one_epoch(cfg, state, step_fn, loader, metric: Metric, epoch: int, logger,
                    run_dir: str = None):
    """One pass over ``loader`` through ``step_fn`` (parallel/train_step.
    make_train_step); returns (state, the epoch's mean losses). Logs the
    running loss four times an epoch and the epoch's clips/s, measured to
    the metric's readback, which waits for every step to finish. With
    ``tpu.profile_steps`` = N and a ``run_dir``, epoch 0's first N steps are
    traced by ``torch.profiler`` into ``<run_dir>/profile/trace.json``."""
    no_batches = max(len(loader), 1)
    log_interval = max(no_batches // 4, 1)
    loss_tracker = None  # device-resident running loss: no per-step sync
    step_times = []
    clips_done = 0
    profile_steps = int(cfg.get_path("tpu.profile_steps", 0) or 0)
    prof = (_start_profile(state.device)
            if profile_steps > 0 and epoch == 0 and run_dir else None)
    epoch_start = time.perf_counter()
    loader.set_epoch(epoch)
    for iter_no, (batch, targets, meta) in enumerate(loader):
        bs = int(meta["batch_size"])
        step_start = time.perf_counter()
        state, loss, preds = step_fn(state, batch, targets, epoch, bs)
        step_times.append(time.perf_counter() - step_start)
        clips_done += bs
        metric.update(preds, global_rows(to_device(targets, state.device)), loss, batch_size=bs)
        total = loss["total"]
        loss_tracker = total if loss_tracker is None else loss_tracker + total
        if prof is not None and iter_no + 1 >= profile_steps:
            _stop_profile(prof, run_dir, logger)
            prof = None
        if iter_no == 0 or (iter_no + 1) % log_interval == 0:
            logger.info(
                "Batch Progress: [{}/{}] || Train Loss: {:.5f} || {:.3f} s/step".format(
                    iter_no + 1, no_batches, float(loss_tracker) / (iter_no + 1),
                    float(np.mean(step_times[-log_interval:])),
                )
            )
    if prof is not None:  # fewer steps than tpu.profile_steps
        _stop_profile(prof, run_dir, logger)
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
            metric.update(preds, global_rows(to_device(targets, state.device)), loss,
                          batch_size=bs)
    return metric.compute()


def checkpoint_stem(cfg, modality: List[str]) -> str:
    """``<out_dir>/<checkpoint_dir>/<exp_name>/[<dataset>_]tbn_<arch>_<mods>``;
    the checkpoint is this stem + ``.pth``."""
    name = "tbn_{}_{}".format(cfg.model.arch, "_".join(modality))
    if cfg.data.dataset:
        name = "_".join([cfg.data.dataset, name])
    return os.path.join(cfg.out_dir, cfg.model.checkpoint_dir, cfg.exp_name, name)


def _warn_grouped_dispatch(cfg, logger) -> None:
    steps_per_call = int(cfg.get_path("tpu.steps_per_call", 1) or 1)
    if steps_per_call > 1 or bool(cfg.get_path("tpu.fuse_accum", False)):
        logger.warning(
            f"tpu.steps_per_call={steps_per_call} / tpu.fuse_accum="
            f"{cfg.get_path('tpu.fuse_accum', False)} group TPU dispatches in the JAX "
            "package; the port runs every batch as one step (the same math)")


def run_trainer(cfg, logger, modality: List[str], writer=None, device="cuda"):
    """Train ``cfg.train.epochs`` epochs (more after a resume) on
    ``device`` ("cpu" or "cuda": this rank's card, ``parallel/mesh.
    make_mesh``); returns the final train state, the same on every rank."""
    mesh = make_mesh(cfg, device)
    device = mesh.device
    logger.info(mesh.describe())
    epochs = int(cfg.train.epochs)
    _warn_grouped_dispatch(cfg, logger)

    logger.info("Initializing model...")
    model = build_model(cfg, modality, device=device)
    load_pretrained_towers(cfg, modality, model, logger)
    state = create_train_state(cfg, model)
    train_loader = create_dataloader(cfg, modality, mode="train", device=device)
    val_loader = (create_dataloader(cfg, modality, mode="val", device=device)
                  if cfg.val.enable else None)
    logger.info(f"Model initialized on {device}.")

    start_epoch = 0
    train_loss_hist: List = []
    val_loss_hist: List = []
    # every accuracy Metric reports, with the combined "all_class" of a
    # multi-head model: the best checkpoint's ranking metric
    val_acc_hist: Dict[str, List] = {k: [] for k in cfg.model.num_classes.keys()}
    if len(cfg.model.num_classes) > 1:
        val_acc_hist["all_class"] = []
    checkpoint = checkpoint_stem(cfg, modality)

    if cfg.train.pre_trained:
        logger.info("Loading pre-trained state...")
        state, history = restore_checkpoint(cfg.train.pre_trained, state)
        start_epoch = int(history.get("epoch", -1)) + 1
        epochs += start_epoch  # reference semantics: resume extends epochs
        train_loss_hist = list(history.get("train_loss", []))
        val_loss_hist = list(history.get("validation_loss", []))
        restored_acc = dict(history.get("validation_accuracy", val_acc_hist))
        # histories without a curve: None for each epoch, so every curve
        # keeps the same length
        for key in val_acc_hist:
            if key not in restored_acc:
                depth = max((len(v) for v in restored_acc.values()), default=0)
                restored_acc[key] = [None] * depth
        val_acc_hist = {k: list(v) for k, v in restored_acc.items()}
        logger.info(f"Model will continue training from epoch no {start_epoch + 1}")

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    # the best-checkpoint threshold survives a resume: re-seeded from the
    # restored history, so a worse epoch after it cannot overwrite the best
    rank_key = ("all_class" if len(cfg.model.num_classes) > 1
                else next(iter(cfg.model.num_classes)))
    seen_best = [acc[0] for acc in (val_acc_hist.get(rank_key) or []) if acc]
    best_acc = max(seen_best) if seen_best else float("-inf")

    plotter = Plotter(writer)
    plotter.add_config(cfg)

    logger.info("Training in progress...")
    start_time = time.time()
    for epoch in range(start_epoch, epochs):
        epoch_start = time.time()
        lr = lr_at_epoch(cfg, epoch)
        state.optimizer.set_learning_rate(lr)
        metric = Metric(cfg, max(len(train_loader), 1))
        state, train_loss = train_one_epoch(cfg, state, train_step, train_loader, metric, epoch,
                                            logger, run_dir=cfg.get_path("run_dir"))
        train_loss_hist.append(train_loss)

        val_loss, val_acc, conf_mat = None, None, None
        if cfg.val.enable:
            logger.info("Validation in progress...")
            val_loss, val_acc, conf_mat = validate(cfg, state, eval_step, val_loader, epoch,
                                                   logger)
            val_loss_hist.append(val_loss)
            for key in val_acc_hist:
                val_acc_hist[key].append(val_acc.get(key))

        history = (train_loss_hist, val_loss_hist, val_acc_hist, conf_mat)
        save_checkpoint(checkpoint, state, epoch, *history)
        # ranked by the combined accuracy of a multi-head model, else by
        # its one head
        cur_acc = (val_acc["all_class"] if val_acc and "all_class" in val_acc
                   else next(iter(val_acc.values())) if val_acc else None)
        if (cfg.get_path("train.save_best", False) and cfg.val.enable
                and cur_acc is not None and cur_acc[0] > best_acc):
            best_acc = cur_acc[0]
            save_checkpoint(checkpoint + "_best", state, epoch, *history)

        plotter.plot_scalar(lr, epoch, "train/learning_rate")
        for key, value in train_loss.items():
            plotter.plot_scalar(value, epoch, f"train/{key}_loss")
            if val_loss is not None and key in val_loss:
                plotter.plot_scalar(val_loss[key], epoch, f"val/{key}_loss")
        for cls, accs in (val_acc or {}).items():
            for k_idx, acc in enumerate(accs):
                plotter.plot_scalar(acc, epoch, f"val/accuracy/{cls}_top_{cfg.val.topk[k_idx]}")

        hours, minutes, seconds = get_time_diff(epoch_start, time.time())
        logger.info("-" * 58)
        logger.info(f"Epoch: [{epoch + 1}/{epochs}] || Learning Rate: {lr}")
        logger.info(f"Train_loss: {train_loss}")
        logger.info(f"Val_Loss: {val_loss}")
        logger.info(f"Epoch Time: {hours} hours, {minutes} minutes, {seconds} seconds")
        logger.info(f"Accuracy Top {cfg.val.topk}:")
        logger.info(json.dumps(val_acc, indent=2))
        logger.info("-" * 58)

    wait_until_finished()
    hours, minutes, seconds = get_time_diff(start_time, time.time())
    logger.info(f"Training completed. Total time taken: {hours} hours, "
                f"{minutes} minutes, {seconds} seconds")
    return state

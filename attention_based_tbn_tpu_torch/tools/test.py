"""The evaluation and challenge-submission entry point.

Port of the JAX package's ``tools/test.py`` (reference core/tools/
test.py): restores ``test.pre_trained`` (utils/checkpoint.py), runs every
annotation file of ``test.annotation_file`` through the data pipeline in
test mode (10-crop under ``test.ten_crop``), computes loss and accuracy
where the file has labels, logs the sustained clips/s, and with
``test.save_results`` writes one Epic-Kitchens challenge JSON per file into
``<out_dir>/inferences/``.

With several ranks (``parallel/mesh``) each rank decodes and runs its shard
of every global batch; the predictions are the global batch's on every
rank, the uids come in global order from the loader's pre-shard indices,
the clips/s counts the global batch, and rank 0 alone writes the JSON (the
JAX package's tools/test.py:108-116, 150-160, 189-192).
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

import numpy as np

from ..data.dataset import VideoDataset
from ..data.loader import DataLoader
from ..data.records import read_pickle, read_vid_list, resolve_vid_list_path
from ..models.builder import build_model
from ..parallel.mesh import make_mesh
from ..parallel.train_step import (TrainState, global_rows, make_eval_step, make_infer_step,
                                   to_device)
from ..utils.checkpoint import load_eval_weights
from ..utils.metrics import Metric
from ..utils.misc import get_time_diff, save_scores


def load_state(cfg, logger, modality: List[str], device="cuda") -> TrainState:
    """The model of ``cfg`` on ``device`` with the weights of
    ``test.pre_trained``, in an eval state (no optimizer)."""
    if not cfg.test.pre_trained:
        raise ValueError("No pre-trained weights exist. Please set the pre_trained "
                         "parameter for test in config file.")
    logger.info(f"Loading pre-trained weights {cfg.test.pre_trained}...")
    model = build_model(cfg, modality, device=device)
    left_out = load_eval_weights(model, cfg.test.pre_trained)
    if left_out["not_in_file"] or left_out["not_in_model"]:
        logger.info(f"Regenerated {len(left_out['not_in_file'])} buffers; ignored "
                    f"{len(left_out['not_in_model'])} keys of the file")
    logger.info("Done.")
    return TrainState(model=model, optimizer=None, generator=None)


def _ready(preds) -> None:
    """Wait for a batch's forward to finish, by one readback."""
    float(next(iter(preds.values())).sum())


def run_tester(cfg, logger, modality: List[str], state: Optional[TrainState] = None,
               device="cuda"):
    """Per annotation file: (loss, accuracy, confusion matrices) when it has
    labels, else None. ``device``: "cpu" or "cuda" (this rank's card,
    ``parallel/mesh.make_mesh``)."""
    mesh = make_mesh(cfg, device)
    device = mesh.device
    logger.info(mesh.describe())
    if state is None:
        state = load_state(cfg, logger, modality, device)
    eval_step = make_eval_step(cfg)
    infer_step = make_infer_step()

    annotation_files = cfg.test.annotation_file
    if isinstance(annotation_files, str):
        annotation_files = [annotation_files]
    logger.info(f"No of files to test: {len(annotation_files)}")
    if cfg.test.save_results and len(annotation_files) != len(cfg.test.results_file):
        raise ValueError(
            f"Number of annotations files to test ({len(annotation_files)}) and number "
            f"of result files ({len(cfg.test.results_file)}) do not match")

    start_time = time.time()
    all_results = []
    for idx, annotation in enumerate(annotation_files):
        vid_list = None
        if cfg.test.vid_list:
            vid_list = read_vid_list(resolve_vid_list_path(cfg.test.vid_list))
        logger.info(f"Creating the dataset using {annotation}...")
        dataset = VideoDataset(cfg, vid_list, annotation, modality, mode="test")
        loader = DataLoader(dataset, batch_size=int(cfg.test.batch_size), shuffle=False,
                            num_workers=int(cfg.num_workers),
                            prefetch=int(cfg.get_path("tpu.prefetch", 2) or 2), device=device,
                            pad_to=mesh.size,
                            shard=(mesh.rank, mesh.world) if mesh.world > 1 else None)
        logger.info(f"{len(dataset)} action segments to be processed.")
        logger.info("Inference in progress...")

        metric = Metric(cfg, max(round(len(dataset) / loader.batch_size), 1))
        labeled = False
        output = {"action_id": [], **{key: [] for key in cfg.model.num_classes}}
        sweep_start = time.perf_counter()
        first_done = first_clips = None
        clips_done = 0
        preds = None
        for batch, targets, meta in loader:
            true_bs = int(meta["batch_size"])
            clips_done += true_bs
            if targets["class"] is not None:
                labeled = True
                loss, preds = eval_step(state, batch, targets, 0, true_bs)
                metric.update(preds, global_rows(to_device(targets, device)), loss,
                              batch_size=true_bs)
            else:
                preds = infer_step(state, batch)
            if first_done is None:
                # the first batch to completion, so the sustained rate below
                # leaves out the kernels' build and the warm-up
                _ready(preds)
                first_done, first_clips = time.perf_counter(), clips_done
            if cfg.test.save_results:
                # the global batch's uids, in global order, on every rank
                uids = [dataset.record(int(i)).action_id
                        for i in meta["global_indices"][:true_bs]]
                output["action_id"].append(np.asarray(uids))
                for key in cfg.model.num_classes:
                    output[key].append(preds[key][:true_bs].float().cpu().numpy())

        if clips_done:
            _ready(preds)
            end = time.perf_counter()
            wall = end - sweep_start
            msg = (f"Inference throughput: {clips_done / wall:.2f} clips/s "
                   f"({clips_done} clips in {wall:.1f} s incl. the first batch")
            if clips_done > first_clips and end > first_done:
                sustained = (clips_done - first_clips) / (end - first_done)
                msg += f"; sustained {sustained:.2f} clips/s excl. first batch"
            logger.info(msg + ")")

        if labeled:
            test_loss, test_acc, conf_mat = metric.compute()
            logger.info(f"Test_Loss: {test_loss}")
            logger.info(f"Accuracy Top {cfg.val.topk}:")
            logger.info(json.dumps(test_acc, indent=2))
            all_results.append((test_loss, test_acc, conf_mat))
        else:
            all_results.append(None)

        if cfg.test.save_results and mesh.is_primary():
            out_file = os.path.join(cfg.out_dir or ".", "inferences", cfg.test.results_file[idx])
            names_path = os.path.join(cfg.data_dir, "annotations", "action_id_to_name.pkl")
            action_names = read_pickle(names_path) if os.path.exists(names_path) else None
            save_scores(output, out_file, action_names)
            logger.info(f"Saved results to {out_file}")
        if cfg.test.save_results:
            mesh.barrier()  # every rank returns once the file is in place

    hours, minutes, seconds = get_time_diff(start_time, time.time())
    logger.info(f"Inference time: {hours} hours, {minutes} minutes, {seconds} seconds")
    return all_results

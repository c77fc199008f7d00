"""Attention-weight visualization: the numbers on the card, the drawing offline.

Port of the JAX package's ``tools/vis.py`` (reference core/tools/vis.py +
Visualize.ipynb without the qgrid / moviepy interactivity): load a
checkpoint (:func:`initialize`), build an action-filtered dataset
(:func:`create_dataset`), sweep it into a table of ground truth,
predictions and attention entropy (:func:`get_info`; :func:`sweep` also
returns the scores), and draw one sample's
grid of RGB frames, spectrograms, attention curves and top-5 class scores
to a PNG (:func:`visualize`, which draws what :func:`panels` returns), or
trim its clip (:func:`save_action_segment`).

The model runs on ``tpu.platform``'s device (``utils/platform.device_for``:
CUDA unless the config asks for the CPU), with the kernels of the config
(``config_vis`` sets ``tpu.use_pallas``: ``pe_block`` and ``mha`` at eval).
matplotlib and cv2 are imported only where a figure is drawn or a clip
written::

    from attention_based_tbn_tpu_torch.tools import vis
    cfg, model, modality, state = vis.initialize(["data_dir=/data/epic"], "tbn.pth")
    dataset = vis.create_dataset(cfg, modality, action_list=[("take", "plate")])
    rows = vis.get_info(cfg, model, state, dataset, max_samples=4)
    vis.visualize(cfg, model, state, dataset, 0, out_path="results/vis.png")
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import ConfigNode, load_config
from ..data.dataset import VideoDataset
from ..data.loader import collate
from ..models.builder import build_model
from ..ops.spectrogram import log_power_stft
from ..parallel.train_step import TrainState, make_infer_step
from ..utils.misc import get_modality
from ..utils.platform import device_for


def initialize(config_path_or_overrides=None, checkpoint: Optional[str] = None,
               config_name: str = "config_vis"):
    """(cfg, model, modality, state): the config, the model on
    ``device_for(cfg)``'s device with the weights of ``checkpoint`` (default
    ``test.pre_trained``), and its eval state (None without a checkpoint;
    the model then keeps its seeded weights). Reference vis.py:314-364; the
    default config is the vis entry point ``config_vis`` (3 segments,
    batch 1); ``config_name="config"`` takes the main one."""
    if isinstance(config_path_or_overrides, (list, tuple)):
        cfg = load_config(overrides=config_path_or_overrides, config_name=config_name)
    elif isinstance(config_path_or_overrides, ConfigNode):
        cfg = config_path_or_overrides
    else:
        cfg = load_config(config_name=config_name)
    modality = get_modality(cfg)
    model = build_model(cfg, modality, device=device_for(cfg))
    checkpoint = checkpoint or cfg.get_path("test.pre_trained", "")
    state = None
    if checkpoint:
        from ..utils.checkpoint import load_weights, read_state_dict

        load_weights(model, read_state_dict(str(checkpoint)), str(checkpoint))
        state = TrainState(model=model, optimizer=None, generator=None)
    return cfg, model, modality, state


def create_dataset(cfg, modality, action_list=None, annotation_file=None) -> VideoDataset:
    """The eval dataset of ``train.annotation_file`` (or
    ``annotation_file``) over ``val.vid_list``, kept to the (verb, noun)
    pairs of ``action_list`` (reference vis.py:240-311)."""
    annotation_file = annotation_file or cfg.train.annotation_file
    vid_list = None
    if cfg.get_path("val.vid_list"):
        from ..data.records import read_vid_list, resolve_vid_list_path

        vid_list = read_vid_list(resolve_vid_list_path(cfg.val.vid_list))
    return VideoDataset(cfg, vid_list, annotation_file, modality, mode="test",
                        action_list=action_list)


def _eval_state(model, state) -> TrainState:
    return state if state is not None else TrainState(model=model, optimizer=None,
                                                      generator=None)


def _forward(infer, state, dataset, index: int):
    """(sample, targets, meta, preds as float32 numpy) of one sample."""
    sample = dataset.sample(index)
    batch, targets, meta = collate([sample])
    preds = infer(state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return sample, targets, meta, {k: v.float().cpu().numpy() for k, v in preds.items()}


def attention_entropy(weights: np.ndarray) -> float:
    """The reference's entropy on the raw softmax weights,
    ``-(w * log(w + 1e-6)).sum(-1).mean()`` (reference vis.py:80-86), in
    float32: not a renormalized distribution's (each row sums to 1)."""
    wts = np.asarray(weights, np.float32).reshape(-1, weights.shape[-1])
    return float(-(wts * np.log(wts + 1e-6)).sum(-1).mean())


def get_info(cfg, model, state, dataset, max_samples: Optional[int] = None,
             epic_classes=None) -> List[Dict]:
    """The summary table (reference vis.py:30-93): one row per sample with
    its uid, video, predicted and true class of each head and the attention
    entropy, from one eval forward each (``parallel/train_step.
    make_infer_step``; ``state`` None: the model's own weights).
    ``epic_classes`` (a ``data/classes.EpicClasses``) adds the class names
    (``pred_verb_name``, ``gt_verb_name``, ...)."""
    return sweep(cfg, model, state, dataset, max_samples, epic_classes)[0]


def sweep(cfg, model, state, dataset, max_samples: Optional[int] = None,
          epic_classes=None):
    """(rows, scores): :func:`get_info`'s rows and, from the same forwards,
    each head's (n, classes) float32 scores."""
    infer = make_infer_step()
    state = _eval_state(model, state)
    name_tables = {}
    if epic_classes is not None:
        name_tables = {"verb": epic_classes.verbs, "noun": epic_classes.nouns}
    rows: List[Dict] = []
    scores: Dict[str, List[np.ndarray]] = {key: [] for key in cfg.model.num_classes.keys()}
    n = len(dataset) if max_samples is None else min(len(dataset), max_samples)
    for index in range(n):
        _, targets, meta, preds = _forward(infer, state, dataset, index)
        row = {"uid": meta["uid"][0], "vid_id": meta["vid_id"][0]}
        for key in cfg.model.num_classes.keys():
            scores[key].append(preds[key][0])
            row[f"pred_{key}"] = int(preds[key][0].argmax())
            if targets["class"] is not None:
                row[f"gt_{key}"] = int(targets["class"][key][0])
            names = name_tables.get(key)
            if names:
                row[f"pred_{key}_name"] = names[row[f"pred_{key}"]]
                if f"gt_{key}" in row:
                    row[f"gt_{key}_name"] = names[row[f"gt_{key}"]]
        if "weights" in preds:
            row["attn_entropy"] = attention_entropy(preds["weights"])
        rows.append(row)
    return rows, {key: np.stack(value) if value else np.empty((0, 0), np.float32)
                  for key, value in scores.items()}


def panels(cfg, model, state, dataset, index: int) -> Dict:
    """What :func:`visualize` draws for sample ``index``, from one eval
    forward on the model's device: ``rgb`` (N, H, W, 3) uint8 frames in RGB
    order (decoded BGR), ``spectrograms`` (N, F, T) float32 log power of the
    audio windows (``ops/spectrogram.log_power_stft`` on the same device),
    ``weights`` (N, S) attention curves, ``top5`` {head: (class ids, scores)}
    and the sample's ``meta``. A modality the config lacks, or attention
    off, leaves its entry out."""
    state = _eval_state(model, state)
    sample, _, meta, preds = _forward(make_infer_step(), state, dataset, index)
    n_seg = sample["RGB"].shape[0] if "RGB" in sample else sample["Audio"].shape[0]
    out: Dict = {"meta": {k: v[0] for k, v in meta.items()}}
    if "RGB" in sample:
        out["rgb"] = np.ascontiguousarray(sample["RGB"][..., ::-1])  # BGR -> RGB
    if "Audio" in sample:
        audio = torch.from_numpy(np.asarray(sample["Audio"], np.float32)).to(state.device)
        out["spectrograms"] = log_power_stft(
            audio, sr=int(cfg.data.audio.sampling_rate)).cpu().numpy()
    if "weights" in preds:
        out["weights"] = preds["weights"].reshape(n_seg, -1)
    out["top5"] = {}
    for key in cfg.model.num_classes.keys():
        scores = preds[key][0]
        top = np.argsort(scores)[::-1][:5]
        out["top5"][key] = (top, scores[top])
    return out


def save_action_segment(data_dir: str, vid_id: str, start_time, stop_time,
                        out_path: str = "results/temp.MP4", fps: float = 60.0,
                        rgb_prefix: str = "links") -> str:
    """Trim the action's clip to ``out_path`` (reference vis.py:96-114 used
    moviepy). Sources, in order:

    * ``<data_dir>/vid_symlinks/<vid_id>.MP4`` through cv2.VideoCapture;
    * the frame directory ``<data_dir>/<rgb_prefix>/<vid_id>/img_*.jpg``
      (0-indexed, as ``preprocessing/create_symlinks.py`` lays it out;
      ``rgb_prefix`` is ``cfg.data.rgb.dir_prefix``).

    Writes an animated GIF (PIL) instead when cv2 has no mp4 encoder.
    Returns the written path."""
    import cv2

    def _to_seconds(value) -> float:
        if isinstance(value, (int, float)):
            return float(value)
        parts = [float(p) for p in str(value).split(":")]
        return sum(p * 60.0**i for i, p in enumerate(reversed(parts)))

    start_s, stop_s = _to_seconds(start_time), _to_seconds(stop_time)

    frames = []
    vid_file = os.path.join(data_dir, "vid_symlinks", f"{vid_id}.MP4")
    if os.path.exists(vid_file):
        cap = cv2.VideoCapture(vid_file)
        src_fps = cap.get(cv2.CAP_PROP_FPS) or fps
        cap.set(cv2.CAP_PROP_POS_MSEC, start_s * 1000.0)
        while cap.isOpened():
            ok, frame = cap.read()
            if not ok or cap.get(cv2.CAP_PROP_POS_MSEC) > stop_s * 1000.0:
                break
            frames.append(frame)
        cap.release()
        fps = src_fps
    else:
        frame_dir = os.path.join(data_dir, rgb_prefix, vid_id)
        for i in range(int(start_s * fps), int(stop_s * fps) + 1):
            path = os.path.join(frame_dir, f"img_{i:010d}.jpg")
            if os.path.exists(path):
                frame = cv2.imread(path)
                if frame is None:  # zero-byte / corrupt JPEG
                    continue
                frames.append(frame)
    if not frames:
        raise FileNotFoundError(f"no video source for {vid_id} under {data_dir} "
                                "(vid_symlinks/*.MP4 or rgb frame dir)")

    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    h, w = frames[0].shape[:2]
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    if writer.isOpened():
        for frame in frames:
            writer.write(frame)
        writer.release()
        if os.path.getsize(out_path) > 0:
            return out_path
    # no mp4 encoder in this cv2 build: an animated GIF
    from PIL import Image

    gif_path = os.path.splitext(out_path)[0] + ".gif"
    images = [Image.fromarray(f[..., ::-1]) for f in frames]  # BGR -> RGB
    images[0].save(gif_path, save_all=True, append_images=images[1:],
                   duration=int(1000.0 / fps), loop=0)
    return gif_path


def visualize(cfg, model, state, dataset, index: int, out_path: str = "results/vis.png",
              save_clip: bool = False) -> str:
    """Draw sample ``index`` to a PNG: a row each of RGB frames,
    spectrograms and attention curves, and the top-5 scores of each head,
    as :func:`panels` returns them (reference vis.py:96-237). With
    ``save_clip`` also trim its clip to ``temp.MP4`` beside it. Returns the
    PNG's path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = panels(cfg, model, state, dataset, index)
    rows = [name for name in ("rgb", "spectrograms", "weights") if name in grid]
    n_seg = len(grid[rows[0]]) if rows else len(grid["top5"])
    fig, axes = plt.subplots(len(rows) + 1, n_seg, figsize=(3 * n_seg, 3 * (len(rows) + 1)),
                             squeeze=False)
    for row, name in enumerate(rows):
        for seg in range(n_seg):
            ax = axes[row][seg]
            if name == "rgb":
                ax.imshow(grid["rgb"][seg])
                ax.set_title(f"segment {seg}")
                ax.axis("off")
            elif name == "spectrograms":
                ax.imshow(grid["spectrograms"][seg], aspect="auto", origin="lower")
                ax.axis("off")
            else:
                ax.plot(grid["weights"][seg])
                ax.set_ylim(0, 1)
    for col, (key, (top, scores)) in enumerate(grid["top5"].items()):
        if col >= n_seg:
            break
        axes[len(rows)][col].bar([str(i) for i in top], scores)
        axes[len(rows)][col].set_title(key)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=80)
    plt.close(fig)
    if save_clip:
        meta = grid["meta"]
        save_action_segment(cfg.data_dir, meta["vid_id"], meta["start_time"],
                            meta["stop_time"],
                            out_path=os.path.join(os.path.dirname(os.path.abspath(out_path)),
                                                  "temp.MP4"),
                            fps=float(cfg.data.vid_fps), rgb_prefix=cfg.data.rgb.dir_prefix)
    return out_path

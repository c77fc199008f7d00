"""The Epic-Kitchens video dataset: index -> numpy sample dict.

Port of the JAX package's ``data/dataset.py`` (reference
core/dataset/dataset.py) as a pure ``sample(index, rng)`` over immutable
state: annotation rows filtered to the split, TSN segment sampling
(sampling.py), frame decode (BGR, like the reference), flow stacks (JPEG
pairs or ``.npz`` stacks), audio windows (the waveform: the spectrogram
runs on the device), attention priors, and the geometric transforms
(transforms.py), in train, val and test mode, with 10-crop in test mode
under ``test.ten_crop``.

Under ``tpu.native_io`` (the default) RGB frames, Flow JPEG pairs and WAV
audio are decoded by the port's native library (``native/``), where the JAX
package decodes them natively (its ``dataset.py:60-66``, ``:117``,
``:128-150``); a library that cannot build raises and names what is
missing. ``tpu.native_io=false`` selects cv2 for JPEG (without cv2 a JPEG
read raises and names the missing decoder) and the Python WAV reader.

Outputs per sample:
  RGB      (N, crop, crop, 3)  uint8 (N x 10 rows under 10-crop)
  Flow     (N, crop, crop, 2*win) uint8
  Audio    (N, L) float32 waveform windows
  weights / target_weights  (N, W, 1) float32 priors, when configured
  labels   {"verb": int, "noun": int[, "action": int]} or -1
  uid, vid_id, start_time, stop_time, indices
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from .. import native
from ..ops.spectrogram import log_power_stft_np
from . import transforms as T
from .audio import AudioCache, extract_window, read_audio_sample
from .priors import attention_prior, attention_window_size
from .records import EpicRecord, load_annotations, record_from_row
from .sampling import flow_stack_indices, sample_indices


def _cv2():
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            "decoding JPEG frames under tpu.native_io=false needs cv2 (opencv), which is "
            "not installed; use the native decoder (tpu.native_io=true), .npz flow stacks "
            "(data.flow.read_flow_pickle=true), or install opencv"
        ) from exc
    return cv2


class VideoDataset:
    def __init__(self, cfg, vid_list: Optional[Sequence[str]], annotation_file: str,
                 modality: Sequence[str] = ("RGB",), mode: str = "train", action_list=None):
        self.cfg = cfg
        self.root_dir = cfg.data_dir
        self.modality = list(modality)
        self.mode = mode
        self.num_segments = {"train": cfg.train.num_segments, "val": cfg.val.num_segments,
                             "test": cfg.test.num_segments}[mode]
        self.flow_win = int(cfg.data.flow.win_length)
        self.use_attention = bool(cfg.model.attention.enable)
        self.attn_win = attention_window_size(cfg.data.audio.audio_length)
        # the native decoder, or None under tpu.native_io=false (cv2 and the
        # Python WAV reader); a library that cannot build raises here
        self.native = native.ensure_built() if cfg.get_path("tpu.native_io", True) else None

        action_ids = None
        if action_list:
            from .classes import EpicClasses

            classes = EpicClasses(os.path.join(cfg.data_dir, "annotations"))
            action_ids = [classes.action_id_string(verb, noun) for verb, noun in action_list]
        path = annotation_file
        if not os.path.isabs(path):
            path = os.path.join(self.root_dir, annotation_file)
        self.annotations = load_annotations(path, list(vid_list) if vid_list else None,
                                            action_ids)
        self.include_action = "action" in dict(cfg.model.num_classes)
        if "Audio" in self.modality:
            self._audio_cache = AudioCache(self._load_audio, max_items=16)

    def __len__(self) -> int:
        return len(self.annotations)

    def record(self, index: int) -> EpicRecord:
        return record_from_row(self.annotations[index], include_action_class=self.include_action)

    # ------------------------------------------------------------------ IO

    def _load_audio(self, vid_id: str) -> np.ndarray:
        audio = self.cfg.data.audio
        return read_audio_sample(self.root_dir, audio.dir_prefix, vid_id,
                                 file_ext=audio.file_ext, sampling_rate=int(audio.sampling_rate),
                                 read_pickle=bool(audio.read_audio_pickle),
                                 use_native=self.native is not None)

    def _rgb_path(self, vid_id: str, frame_idx: int) -> str:
        rgb = self.cfg.data.rgb
        return os.path.join(self.root_dir, rgb.dir_prefix, vid_id,
                            f"img_{frame_idx:010d}.{rgb.file_ext}")

    def _read_rgb(self, vid_id: str, frame_idx: int) -> np.ndarray:
        path = self._rgb_path(vid_id, frame_idx)
        if self.native is not None:
            return self.native.decode_jpeg_file(path)  # BGR, as cv2
        img = _cv2().imread(path)  # BGR, like the reference (dataset.py:305-311)
        if img is None:
            raise IOError(f"Problem reading file {path}")
        return img

    def _read_flow_pair(self, vid_id: str, frame_idx: int) -> List[np.ndarray]:
        flow = self.cfg.data.flow
        base = os.path.join(self.root_dir, flow.dir_prefix, vid_id)
        maps = []
        for axis in ("x", "y"):
            path = os.path.join(base, f"{axis}_{frame_idx:010d}.{flow.file_ext}")
            if self.native is not None:
                maps.append(self.native.decode_jpeg_file(path, grayscale=True))
                continue
            img = _cv2().imread(path, 0)
            if img is None:
                raise IOError(f"Problem reading file {path}")
            maps.append(img)
        return maps

    def _read_flow_stack_npz(self, vid_id: str, frame_idx: int) -> np.ndarray:
        path = os.path.join(self.root_dir, self.cfg.data.flow.dir_prefix, vid_id,
                            f"frame_{frame_idx:010d}.npz")
        with np.load(path) as data:
            return data["flow"]  # (H, W, 2*win)

    # ------------------------------------------------------------ sampling

    def sample(self, index: int, rng: Optional[np.random.Generator] = None) -> Dict:
        record = self.record(index)
        vid_id = record.untrimmed_video_name
        indices = sample_indices(record, self.modality, self.num_segments, self.flow_win,
                                 mode=self.mode, sampling=self.cfg.data.sampling, rng=rng)
        out: Dict = {"vid_id": vid_id, "uid": record.action_id,
                     "start_time": record.start_timestamp, "stop_time": record.stop_timestamp,
                     "indices": indices}
        attention = self.cfg.model.attention
        for m in self.modality:
            if m == "RGB":
                frames = np.stack([self._read_rgb(vid_id, i) for i in indices[m]], axis=0)
                out[m] = self._transform_visual(frames, "RGB", rng)
            elif m == "Flow":
                out[m] = self._transform_visual(self._flow_frames(vid_id, indices[m]), "Flow",
                                                rng)
            elif m == "Audio":
                out[m], priors = self._audio_windows(vid_id, indices[m])
                if self.use_attention:
                    if attention.use_fixed:
                        out["weights"] = priors
                    elif attention.use_prior:
                        out["target_weights"] = priors
        out["labels"] = record.label
        return out

    def _flow_frames(self, vid_id: str, seg_indices: np.ndarray) -> np.ndarray:
        if self.cfg.data.flow.read_flow_pickle:
            return np.stack([self._read_flow_stack_npz(vid_id, i) for i in seg_indices], axis=0)
        frame_idx = flow_stack_indices(seg_indices, self.flow_win, self.num_segments)
        maps: List[np.ndarray] = []
        for i in frame_idx:
            maps.extend(self._read_flow_pair(vid_id, i))
        grouped = np.stack(maps, axis=0)  # (N * 2 * win, H, W)
        n, per_seg = self.num_segments, 2 * self.flow_win
        return grouped.reshape(n, per_seg, *grouped.shape[1:]).transpose(0, 2, 3, 1)

    def _audio_windows(self, vid_id: str, seg_indices: np.ndarray):
        sample = self._audio_cache(vid_id)
        audio = self.cfg.data.audio
        sr, length = int(audio.sampling_rate), float(audio.audio_length)
        fps = float(self.cfg.data.vid_fps)
        windows = np.stack([extract_window(sample, int(i), fps, length, sr) for i in seg_indices])
        priors = None
        attention = self.cfg.model.attention
        if self.use_attention and (attention.use_fixed or attention.use_prior):
            prior_type = attention.prior_type
            priors = np.stack([
                attention_prior("loud", self.attn_win, log_power_stft_np(w, sr=sr))
                if prior_type == "loud" else attention_prior(prior_type, self.attn_win)
                for w in windows
            ]).astype(np.float32)  # (N, W, 1)
        return windows, priors

    def _transform_visual(self, frames: np.ndarray, modality: str,
                          rng: Optional[np.random.Generator]) -> np.ndarray:
        data = self.cfg.data
        if self.mode == "train":
            scales = [1, 0.875, 0.75, 0.66] if modality == "RGB" else [1, 0.875, 0.75]
            return T.train_visual_transform(frames, int(data.train_crop_size), scales, 0.5, rng)
        if self.mode == "test" and self.cfg.get_path("test.ten_crop", False):
            # 10-crop eval (5 locations x flip); the model tiles the audio
            # feature to match (reference transform.py FixedCrop +
            # model.py:243-248)
            rescaled = T.rescale(frames, int(data.test_scale_size))
            return T.ten_crop(rescaled, int(data.test_crop_size))
        return T.eval_visual_transform(frames, int(data.test_scale_size),
                                       int(data.test_crop_size))

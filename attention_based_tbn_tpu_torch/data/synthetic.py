"""Synthetic Epic-Kitchens-like fixture dataset.

Port of the JAX package's ``data/synthetic.py``: the same arguments, the
same seeded content and the same files. It writes the directory tree the
loader expects (RGB JPEGs ``img_##########.jpg``, flow pairs
``x_/y_##########.jpg``, one WAV per video, the annotation CSV and the split
list), so the whole pipeline (decode, sampling, transforms, spectrogram,
training) runs without the real dataset. JPEGs are written by
``cv2.imwrite``, as there, and the CSV by the ``csv`` module, in pandas'
``to_csv`` layout: pandas is not needed.
"""

from __future__ import annotations

import csv
import os
import wave
from typing import List, Optional, Sequence

import numpy as np


def _write_wav(path: str, samples: np.ndarray, sr: int) -> None:
    pcm = np.clip(samples * 32767.0, -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as handle:
        handle.setnchannels(1)
        handle.setsampwidth(2)
        handle.setframerate(sr)
        handle.writeframes(pcm.tobytes())


def generate(
    root: str,
    videos: Optional[Sequence[str]] = None,
    frames_per_video: int = 120,
    actions_per_video: int = 3,
    image_hw=(256, 342),
    fps: int = 60,
    sampling_rate: int = 24000,
    num_verbs: int = 125,
    num_nouns: int = 352,
    seed: int = 0,
    rgb_prefix: str = "links",
    flow_prefix: str = "links",
    audio_prefix: str = "audio",
    learnable: bool = False,
    class_jitter: float = 0.0,
    noun_jitter: Optional[float] = None,
) -> List[str]:
    """Create the fixture tree under ``root``; returns the video id list.

    ``learnable=True`` makes the class labels recoverable from the content
    (for convergence tests / benchmarks, not just pipeline plumbing):

    * verb class: brightness of each action span's upper image half;
    * noun class: brightness of the lower half AND the frequency of a pure
      tone spanning the whole video (one noun class per video, so audio
      windows never straddle two classes);
    * classes cycle deterministically over actions/videos so every class
      appears in any >=num_classes-sized split.

    ``class_jitter`` (requires ``learnable=True``) makes the task
    Bayes-limited instead of perfectly separable: every action's verb
    signal and every video's noun signal is offset by a Gaussian draw of
    the given sigma IN CLASS-STEP UNITS, so adjacent classes overlap and
    the best achievable accuracy sits mid-range (for sigma ~0.5-0.6,
    roughly P(|N(0,s)| < 1/2) interior ~ 0.6-0.7). The convergence
    differential uses this so its cross-framework agreement bound
    actually discriminates (a saturating fixture cannot). Jitter draws
    come from a SEPARATE rng stream, so ``class_jitter=0`` remains byte
    identical to the pre-jitter ``learnable=True`` output. With jitter on,
    flow frames inside action spans also carry the (jittered) verb signal
    so the Flow tower has something to learn.

    ``noun_jitter`` overrides the NOUN signal's sigma (default: same as
    ``class_jitter``). The noun signal is per-VIDEO (one audio tone per
    video), so a small fixture trains the noun boundary on only n_videos
    points — a gentler noun sigma keeps the per-video boundary variance
    (and the confident-wrong CE tail it causes) bounded while the
    per-action verb signal carries the full difficulty.

    ``learnable=False`` keeps the original content (random labels), byte
    identical to earlier revisions for the differential replay tests.
    """
    import cv2

    if class_jitter and not learnable:
        raise ValueError("class_jitter requires learnable=True")
    jrng = np.random.default_rng((seed, 77)) if class_jitter else None

    rng = np.random.default_rng(seed)
    videos = list(videos or ["P01_01", "P01_02"])
    h, w = image_hw

    rows = []
    uid = 0
    for v_idx, vid in enumerate(videos):
        rgb_dir = os.path.join(root, rgb_prefix, vid)
        flow_dir = os.path.join(root, flow_prefix, vid)
        audio_dir = os.path.join(root, audio_prefix)
        os.makedirs(rgb_dir, exist_ok=True)
        os.makedirs(flow_dir, exist_ok=True)
        os.makedirs(audio_dir, exist_ok=True)

        span = frames_per_video // actions_per_video
        if learnable:
            vid_noun = v_idx % num_nouns
            noun_sigma = class_jitter if noun_jitter is None else noun_jitter
            noun_jit = float(jrng.normal(0.0, noun_sigma)) if jrng is not None else 0.0
            spans = []
            for a in range(actions_per_video):
                verb_jit = (
                    float(jrng.normal(0.0, class_jitter)) if jrng is not None else 0.0
                )
                spans.append(
                    (
                        a * span + 2,
                        min((a + 1) * span, frames_per_video - 1),
                        (a + v_idx) % num_verbs,
                        vid_noun,
                        verb_jit,
                    )
                )
            dv = 160.0 / max(num_verbs - 1, 1)
            dn = 160.0 / max(num_nouns - 1, 1)
            base = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for i in range(frames_per_video):
                act = next((s for s in spans if s[0] <= i <= s[1]), None)
                if act is None:
                    frame = np.roll(base, (i * 3) % w, axis=1)
                else:
                    _, _, verb_c, noun_c, verb_jit = act
                    noise = rng.integers(-10, 10, (h, w, 3))
                    frame = np.empty((h, w, 3), np.float64)
                    frame[: h // 2] = 40.0 + (verb_c + verb_jit) * dv
                    frame[h // 2 :] = 40.0 + (noun_c + noun_jit) * dn
                    frame = np.clip(frame + noise, 0, 255).astype(np.uint8)
                cv2.imwrite(os.path.join(rgb_dir, f"img_{i:010d}.jpg"), frame)
            gray = base.mean(axis=2).astype(np.uint8)
            for i in range(frames_per_video // 2 + 10):
                if jrng is not None:
                    # flow frame i ~ rgb frame 2*i (stride-2 extraction);
                    # carry the action's jittered verb signal so the Flow
                    # tower has a learnable input in tri-modal runs
                    act = next(
                        (
                            s
                            for s in spans
                            if s[0] <= min(2 * i, frames_per_video - 1) <= s[1]
                        ),
                        None,
                    )
                    if act is not None:
                        _, _, verb_c, _, verb_jit = act
                        level = np.clip(40.0 + (verb_c + verb_jit) * dv, 0, 255)
                        fnoise = rng.integers(-10, 10, (h, w))
                        fx = np.clip(level + fnoise, 0, 255).astype(np.uint8)
                        fy = np.clip(level + rng.integers(-10, 10, (h, w)), 0, 255).astype(
                            np.uint8
                        )
                        cv2.imwrite(os.path.join(flow_dir, f"x_{i:010d}.jpg"), fx)
                        cv2.imwrite(os.path.join(flow_dir, f"y_{i:010d}.jpg"), fy)
                        continue
                cv2.imwrite(os.path.join(flow_dir, f"x_{i:010d}.jpg"),
                            np.roll(gray, i, axis=1))
                cv2.imwrite(os.path.join(flow_dir, f"y_{i:010d}.jpg"),
                            np.roll(gray, i, axis=0))

            duration = frames_per_video / fps
            t = (
                np.arange(int(duration * sampling_rate) + sampling_rate)
                / sampling_rate
            )
            tone = 0.3 * np.sin(
                2 * np.pi * (400.0 + (vid_noun + noun_jit) * 500.0) * t
            )
            tone += 0.02 * rng.standard_normal(t.shape)
            _write_wav(os.path.join(audio_dir, f"{vid}.wav"), tone, sampling_rate)
        else:
            base = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
            for i in range(frames_per_video):
                shift = (i * 3) % w
                frame = np.roll(base, shift, axis=1)
                cv2.imwrite(os.path.join(rgb_dir, f"img_{i:010d}.jpg"), frame)
            gray = base.mean(axis=2).astype(np.uint8)
            for i in range(frames_per_video // 2 + 10):
                cv2.imwrite(os.path.join(flow_dir, f"x_{i:010d}.jpg"),
                            np.roll(gray, i, axis=1))
                cv2.imwrite(os.path.join(flow_dir, f"y_{i:010d}.jpg"),
                            np.roll(gray, i, axis=0))

            duration = frames_per_video / fps
            t = (
                np.arange(int(duration * sampling_rate) + sampling_rate)
                / sampling_rate
            )
            tone = 0.3 * np.sin(2 * np.pi * (220 + 50 * rng.integers(8)) * t)
            tone += 0.05 * rng.standard_normal(t.shape)
            _write_wav(os.path.join(audio_dir, f"{vid}.wav"), tone, sampling_rate)

        for a in range(actions_per_video):
            start = a * span + 2
            stop = min((a + 1) * span, frames_per_video - 1)
            if learnable:
                verb = (a + v_idx) % num_verbs
                noun = v_idx % num_nouns
            else:
                verb = int(rng.integers(num_verbs))
                noun = int(rng.integers(num_nouns))
            rows.append(
                {
                    "uid": uid,
                    "participant_id": vid.split("_")[0],
                    "video_id": vid,
                    "narration": f"action {uid}",
                    "start_timestamp": "00:00:00.00",
                    "stop_timestamp": "00:00:02.00",
                    "start_frame": start,
                    "stop_frame": stop,
                    "verb": f"verb{verb}",
                    "verb_class": verb,
                    "noun": f"noun{noun}",
                    "noun_class": noun,
                    "all_nouns": f"['noun{noun}']",
                    "all_noun_classes": f"[{noun}]",
                    "action": f"{verb},{noun}",
                    "action_class": uid % 17,
                }
            )
            uid += 1

    ann_dir = os.path.join(root, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    # pandas' DataFrame.to_csv(index=False) layout: a header, minimal quoting
    with open(os.path.join(ann_dir, "epic_train_val.csv"), "w", newline="") as handle:
        writer = csv.writer(handle, lineterminator="\n")
        writer.writerow(list(rows[0]) if rows else [])
        writer.writerows([list(row.values()) for row in rows])

    with open(os.path.join(root, "train_split.txt"), "w") as handle:
        handle.write("\n".join(videos) + "\n")

    return videos

"""Host geometric transforms of frame groups (numpy, cv2 to resize).

Port of the JAX package's ``data/transforms.py`` (reference
core/dataset/transform.py): one crop / flip decision per sample, applied to
every frame of every segment. Normalization (ToTensor /255 + Normalize)
runs on the device (models/tbn.py): the host hands uint8 stacks over.

Train (RGB / Flow): MultiScaleCrop (TSN scales + fixed-offset jitter) ->
RandomHorizontalFlip. Eval: rescale the shorter side -> centre crop, or
10-crop (5 locations x flip) under ``test.ten_crop``.

cv2 is imported only when a frame group must really be resized, so frames
that already have the target size (the ``.npz`` flow stacks written at the
shorter side 256) need no cv2.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

_INTER_LINEAR = 1  # cv2.INTER_LINEAR


def rescale(frames: np.ndarray, size, interpolation=_INTER_LINEAR) -> np.ndarray:
    """Shorter-side (int ``size``) or exact ((h, w) ``size``) rescale of
    (N, H, W, C); returns ``frames`` itself when the size already matches."""
    n, h, w = frames.shape[:3]
    if isinstance(size, int):
        if h > w:
            new_h, new_w = int(size * h / w), size
        else:
            new_h, new_w = size, int(size * w / h)
    else:
        new_h, new_w = size
    if (new_h, new_w) == (h, w):
        return frames
    try:
        import cv2
    except ImportError as exc:
        raise ImportError(
            f"resizing frames from {(h, w)} to {(new_h, new_w)} needs cv2 (opencv), "
            "which is not installed"
        ) from exc
    out = np.empty((n, new_h, new_w) + frames.shape[3:], dtype=frames.dtype)
    for i in range(n):
        resized = cv2.resize(frames[i], (new_w, new_h), interpolation=interpolation)
        out[i] = resized.reshape(out.shape[1:])
    return out


def center_crop(frames: np.ndarray, size: int) -> np.ndarray:
    h, w = frames.shape[1:3]
    y0, x0 = (h - size) // 2, (w - size) // 2
    return frames[:, y0 : y0 + size, x0 : x0 + size]


def crop_at(frames: np.ndarray, y0: int, x0: int, ch: int, cw: int) -> np.ndarray:
    return frames[:, y0 : y0 + ch, x0 : x0 + cw]


def horizontal_flip(frames: np.ndarray) -> np.ndarray:
    return frames[:, :, ::-1]


def fixed_crop_offsets(image_w: int, image_h: int, crop_w: int, crop_h: int,
                       more_fix_crop: bool = True) -> List[Tuple[int, int]]:
    """TSN's fixed (x, y) offset grid (reference transform.py:389-412):
    corners and centre, plus edge and quarter positions."""
    w_step = (image_w - crop_w) / 4
    h_step = (image_h - crop_h) / 4
    ret = [(0, 0), (4 * w_step, 0), (0, 4 * h_step), (4 * w_step, 4 * h_step),
           (2 * w_step, 2 * h_step)]
    if more_fix_crop:
        ret += [(0, 2 * h_step), (4 * w_step, 2 * h_step), (2 * w_step, 4 * h_step),
                (2 * w_step, 0 * h_step), (1 * w_step, 1 * h_step), (3 * w_step, 1 * h_step),
                (1 * w_step, 3 * h_step), (3 * w_step, 3 * h_step)]
    return [(int(x), int(y)) for x, y in ret]


def multi_scale_crop(frames: np.ndarray, input_size: int,
                     scales: Sequence[float] = (1, 0.875, 0.75, 0.66), max_distort: int = 1,
                     fix_crop: bool = True, more_fix_crop: bool = True,
                     rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """TSN MultiScaleCrop (reference transform.py:284-412): a (crop_w,
    crop_h) pair from the scale grid (|i - j| <= max_distort, snapped
    within 3 px of input_size), cropped at a random fixed offset, rescaled
    to input_size. Without ``fix_crop`` a zero-span offset is 0 where the
    reference's randint(0, 0) raises, as in the JAX package."""
    if rng is None:
        raise ValueError("multi_scale_crop needs an explicit rng")
    img_h, img_w = frames.shape[1:3]
    base = min(img_h, img_w)
    crop_sizes = [int(base * s) for s in scales]
    snapped = [input_size if abs(x - input_size) < 3 else x for x in crop_sizes]
    pairs = [(w, h) for i, h in enumerate(snapped) for j, w in enumerate(snapped)
             if abs(i - j) <= max_distort]
    crop_w, crop_h = pairs[rng.integers(len(pairs))]
    if fix_crop:
        offsets = fixed_crop_offsets(img_w, img_h, crop_w, crop_h, more_fix_crop)
        x0, y0 = offsets[rng.integers(len(offsets))]
    else:
        span_w, span_h = img_w - crop_w, img_h - crop_h
        x0 = int(rng.integers(0, span_w)) if span_w > 0 else 0
        y0 = int(rng.integers(0, span_h)) if span_h > 0 else 0
    return rescale(crop_at(frames, y0, x0, crop_h, crop_w), (input_size, input_size))


def ten_crop(frames: np.ndarray, size: int) -> np.ndarray:
    """FixedCrop at 5 locations x (as is, flipped) -> (10 * N, size, size,
    C), crop-major (reference transform.py:106-179)."""
    h, w = frames.shape[1:3]
    locations = [((h - size) // 2, (w - size) // 2), (0, 0), (0, w - size), (h - size, 0),
                 (h - size, w - size)]
    out = []
    for y0, x0 in locations:
        crop = crop_at(frames, y0, x0, size, size)
        for frame, flipped in zip(crop, horizontal_flip(crop)):
            out.append(frame)
            out.append(flipped)
    return np.stack(out, axis=0)


def train_visual_transform(frames: np.ndarray, crop_size: int, scales: Sequence[float],
                           flip_prob: float, rng: np.random.Generator) -> np.ndarray:
    out = multi_scale_crop(frames, crop_size, scales=scales, rng=rng)
    if rng.random() < flip_prob:
        out = horizontal_flip(out)
    return np.ascontiguousarray(out)


def eval_visual_transform(frames: np.ndarray, scale_size: int, crop_size: int) -> np.ndarray:
    return np.ascontiguousarray(center_crop(rescale(frames, scale_size), crop_size))

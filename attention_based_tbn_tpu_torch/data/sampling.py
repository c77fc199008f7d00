"""TSN-style temporal segment sampling.

Port of the JAX package's ``data/sampling.py``: pure numpy with an explicit
generator. The offsets reproduce the reference's distributions
(core/dataset/dataset.py:194-239):

* train: the span splits into ``num_segments`` windows of ``seg_len``; one
  uniform offset per window (``frame_len - 1`` frames reserved at the end
  so a whole flow stack fits);
* val / test: the centre offset ``seg_len // 2``, flow windows re-centred
  by ``win_length // 2`` (clamped at 0);
* a degenerate span (``seg_len <= 0``) collapses onto the start frame.

Sync sampling copies the first modality's indices to the others, halved
for Flow (reference dataset.py:160-163); async draws fresh offsets per
modality.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .records import EpicRecord


def segment_offsets(num_frames: int, num_segments: int, frame_len: int = 1,
                    mode: str = "train", is_flow: bool = False,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-segment frame offsets relative to the record's start frame."""
    if mode == "train":
        seg_len = (num_frames - frame_len + 1) // num_segments
    else:
        seg_len = num_frames // num_segments
    if seg_len <= 0:
        return np.zeros(num_segments, dtype=np.int64)
    if mode == "train":
        if rng is None:
            raise ValueError("train-mode sampling needs an explicit rng")
        offsets = rng.integers(0, seg_len, size=num_segments)
    else:
        offsets = seg_len // 2
        if is_flow:
            offsets = max(offsets - frame_len // 2, 0)
    return (np.arange(num_segments, dtype=np.int64) * seg_len + offsets).astype(np.int64)


def sample_indices(record: EpicRecord, modality: List[str], num_segments: int,
                   flow_win_length: int, mode: str = "train", sampling: str = "sync",
                   rng: Optional[np.random.Generator] = None) -> Dict[str, np.ndarray]:
    """Sampled absolute frame indices per modality for one record."""
    indices: Dict[str, np.ndarray] = {}
    for m_no, m in enumerate(modality):
        if m_no > 0 and sampling == "sync":
            base = indices[modality[0]]
            indices[m] = (base / 2).astype(np.int64) if m == "Flow" else base.copy()
        else:
            offsets = segment_offsets(
                record.num_frames[m], num_segments,
                frame_len=flow_win_length if m == "Flow" else 1,
                mode=mode, is_flow=(m == "Flow"), rng=rng,
            )
            indices[m] = record.start_frame[m] + offsets
    return indices


def flow_stack_indices(segment_indices: np.ndarray, win_length: int,
                       num_segments: int) -> np.ndarray:
    """Per-segment flow indices -> the interleaved per-frame index list
    (reference dataset.py:168-173): segment index i becomes i .. i+win-1."""
    return (np.repeat(segment_indices, win_length)
            + np.tile(np.arange(win_length), num_segments)).astype(np.int64)

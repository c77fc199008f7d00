"""Small utilities shared by the entry points: modality resolution,
timing, and the Epic-Kitchens challenge JSON."""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np


def get_modality(cfg) -> List[str]:
    """Enabled modalities in the canonical RGB, Flow, Audio order
    (reference core/utils/misc.py:7-26)."""
    modality = []
    if cfg.data.rgb.enable:
        modality.append("RGB")
    if cfg.data.flow.enable:
        modality.append("Flow")
    if cfg.data.audio.enable:
        modality.append("Audio")
    return modality


def get_time_diff(start_time: float, end_time: float) -> Tuple[int, int, int]:
    """(hours, minutes, seconds) between two timestamps."""
    hours = int((end_time - start_time) / 3600)
    minutes = int((end_time - start_time) / 60) - hours * 60
    seconds = int(math.floor((end_time - start_time) % 60))
    return hours, minutes, seconds


def save_scores(scores: Mapping[str, list], file_name: str,
                action_names: Optional[Mapping[int, str]] = None,
                top_actions: int = 100) -> None:
    """The Epic-Kitchens challenge JSON (reference core/utils/misc.py:
    115-165; the JAX package's ``utils/misc.save_scores``):
    {"version": "0.1", "challenge": "action_recognition", "results":
    {uid: {verb: {class: score}, noun: {...}, action: top-100, named}}}.

    ``scores`` holds "action_id" (a list of uid arrays) and per-head logits
    (lists of (B, C) arrays), batch by batch."""
    merged = {key: np.concatenate([np.asarray(v) for v in value], axis=0)
              for key, value in scores.items()}
    results: Dict[str, Dict] = {}
    uids = merged["action_id"]
    for idx in range(uids.shape[0]):
        uid = str(int(uids[idx]))
        results[uid] = {}
        for key, value in merged.items():
            if key == "action_id":
                continue
            row = value[idx]
            if key == "action":
                top_idx = np.argsort(row)[::-1][:top_actions]
                results[uid][key] = {
                    (action_names[int(i)] if action_names else str(int(i))): float(row[i])
                    for i in top_idx
                }
            else:
                results[uid][key] = {str(i): float(s) for i, s in enumerate(row)}
    out = {"version": "0.1", "challenge": "action_recognition", "results": results}
    os.makedirs(os.path.dirname(os.path.abspath(file_name)), exist_ok=True)
    with open(file_name, "w") as handle:
        json.dump(out, handle, indent=4)

"""Small utilities shared by the entry points."""

from __future__ import annotations

import math
from typing import List, Tuple


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

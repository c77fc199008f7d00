"""Small utilities shared by the entry points."""

from __future__ import annotations

from typing import List


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

"""Model construction (the JAX package's ``models/builder.py``, without
pretrained-file loading: no tower weights can be fetched yet)."""

from __future__ import annotations

from typing import List

import torch

from ..utils.device import resolve_device
from .tbn import TBNModel, TBNSpec


def build_model(cfg, modality: List[str], device="cuda", seed: int = None) -> TBNModel:
    """The TBN for ``cfg`` and ``modality``, initialized from ``seed``
    (default ``cfg.data.manual_seed``) with a ``torch.Generator``, on
    ``device`` and in eval mode. Raises without CUDA unless ``device`` is
    the CPU."""
    device = resolve_device(device)
    model = TBNModel(TBNSpec.from_config(cfg, modality))
    seed = int(cfg.data.manual_seed if seed is None else seed)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

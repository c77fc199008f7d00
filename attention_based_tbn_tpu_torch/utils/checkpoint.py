"""Eval restore of weights into the port's model.

``test.pre_trained`` names a ``.pth`` file in the reference PyTorch layout:
``{"model": state_dict, ...}`` as the reference's training checkpoints and
the JAX package's ``models/convert_back.py`` write it, a flat state dict,
or the port's own ``torch.save(model.state_dict())``. The load is strict
except for the keys the JAX package's converter also leaves out
(models/convert.py:83, :289-290, :341): ``num_batches_tracked`` counters,
the ``pe.0`` sin/cos table and ``prototype_wts`` (both regenerated), and a
tower's ``last_linear`` head. An Orbax directory of the JAX package is
refused with the way to export it. Checkpoint saving and resume come with
``run_trainer``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Mapping

import torch
import torch.nn as nn


def tolerated_key(key: str) -> bool:
    """Keys a file may lack or carry beyond the model's."""
    parts = key.split(".")
    return (parts[-1] == "num_batches_tracked" or key.startswith("pe.0.")
            or key == "attention_layer.prototype_wts"
            or (key.startswith("Base_") and len(parts) > 1 and parts[1] == "last_linear"))


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in a ``.pth`` file (unwrapping ``{"model": ...}``)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an Orbax checkpoint of the JAX package; the port "
            "reads .pth state dicts. Export one with `python -m "
            "attention_based_tbn_tpu.models.convert_back --output <file>.pth "
            "test.pre_trained=<dir> <the run's model overrides>` and pass the .pth"
        )
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")
    data = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(data, Mapping) and isinstance(data.get("model"), Mapping):
        data = data["model"]
    if not isinstance(data, Mapping):
        raise ValueError(f"{path} holds a {type(data).__name__}, not a state dict")
    return {k: torch.as_tensor(v) for k, v in data.items()}


def load_eval_weights(model: nn.Module, path: str) -> Dict[str, List[str]]:
    """Load ``path`` into ``model``: every key of the model must be in the
    file and every key of the file in the model, tolerated keys aside;
    shapes must match. Returns the tolerated keys left out on each side."""
    state = read_state_dict(path)
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state and not tolerated_key(k))
    unknown = sorted(k for k in state if k not in own and not tolerated_key(k))
    if missing or unknown:
        raise KeyError(f"{path} does not fit the model: missing {missing[:8]} "
                       f"({len(missing)}), unknown {unknown[:8]} ({len(unknown)})")
    model.load_state_dict({k: v for k, v in state.items() if k in own}, strict=False)
    return {"not_in_file": sorted(k for k in own if k not in state),
            "not_in_model": sorted(k for k in state if k not in own)}

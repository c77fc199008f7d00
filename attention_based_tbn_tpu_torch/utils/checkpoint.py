"""Training checkpoints with resume, and weight restore for evaluation.

Port of the JAX package's ``utils/checkpoint.py``. A training checkpoint
is ``<stem>.pth``, written with ``torch.save``: the reference's dict
(reference core/utils/misc.py:56-112) ``epoch``, ``model`` (the state dict
in the reference key layout), ``optimizer``, ``train_loss``,
``validation_loss``, ``validation_accuracy`` and ``conf_mat``, plus the
port's ``generator`` (the state of the dropout / gumbel generator) and
``step``. Beside it, ``<stem>.history.json`` holds the epoch and the
metric histories as the JAX package's sidecar does.

Durability, as in the JAX package: a save writes ``<stem>.pth.tmp-<epoch>``,
syncs it and renames it over ``<stem>.pth`` (``os.replace``), so a save cut
short leaves the previous checkpoint whole; the history is replaced only
after the checkpoint it describes is in place. Saves are synchronous, so
``wait_until_finished`` (the JAX package's wait for its asynchronous Orbax
save) has nothing to wait for. With several ranks (``parallel/mesh``) the
ranks hold one state, so rank 0 alone writes, and every rank waits at a
barrier until the files are in place (the JAX package's primary-host
writes, checkpoint.py:42-51, 85-90); every rank restores from the same
file.

Evaluation (``test.pre_trained``) reads the model of such a file, of the
reference's training checkpoints, of the JAX package's
``models/convert_back.py`` export, a flat state dict, or the port's own
``torch.save(model.state_dict())``. The load is strict except for the keys
the JAX package's converter also leaves out (models/convert.py:83,
:289-290, :341): ``num_batches_tracked`` counters, the ``pe.0``
sin/cos table and ``prototype_wts`` (both regenerated), and a tower's
ImageNet head, which the reference strips: BN-Inception's ``last_linear``,
ResNet's ``model.fc`` and VGG's ``model.classifier.6``. An Orbax directory
of the JAX package is refused with the way to export it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..parallel import mesh

HISTORY_KEYS = ("epoch", "train_loss", "validation_loss", "validation_accuracy")


def tolerated_key(key: str) -> bool:
    """Keys a file may lack or carry beyond the model's."""
    parts = key.split(".")
    head = ".".join(parts[1:-1]) if key.startswith("Base_") else None
    return (parts[-1] == "num_batches_tracked" or key.startswith("pe.0.")
            or key == "attention_layer.prototype_wts"
            or head in ("last_linear", "model.fc", "model.classifier.6"))


def history_path(stem: str) -> str:
    return stem + ".history.json"


def read_checkpoint(path: str) -> Dict:
    """The object in a ``.pth`` file (tensors on the CPU)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory, an Orbax checkpoint of the JAX package; the port "
            "reads .pth state dicts. Export one with `python -m "
            "attention_based_tbn_tpu.models.convert_back --output <file>.pth "
            "test.pre_trained=<dir> <the run's model overrides>` and pass the .pth"
        )
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no checkpoint file at {path}")
    return torch.load(path, map_location="cpu", weights_only=True)


def model_state(data) -> Dict[str, torch.Tensor]:
    """The state dict in a checkpoint's object (unwrapping ``{"model": ...}``)."""
    if isinstance(data, Mapping) and isinstance(data.get("model"), Mapping):
        data = data["model"]
    if not isinstance(data, Mapping):
        raise ValueError(f"a checkpoint holds a {type(data).__name__}, not a state dict")
    return {k: torch.as_tensor(v) for k, v in data.items()}


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict in a ``.pth`` file (unwrapping ``{"model": ...}``)."""
    return model_state(read_checkpoint(path))


def load_weights(model: nn.Module, state: Mapping[str, torch.Tensor],
                 source: str = "the checkpoint") -> Dict[str, List[str]]:
    """Load ``state`` into ``model``: every key of the model must be in the
    state and every key of the state in the model, tolerated keys aside;
    shapes must match. Returns the tolerated keys left out on each side."""
    own = model.state_dict()
    missing = sorted(k for k in own if k not in state and not tolerated_key(k))
    unknown = sorted(k for k in state if k not in own and not tolerated_key(k))
    if missing or unknown:
        raise KeyError(f"{source} does not fit the model: missing {missing[:8]} "
                       f"({len(missing)}), unknown {unknown[:8]} ({len(unknown)})")
    model.load_state_dict({k: v for k, v in state.items() if k in own}, strict=False)
    return {"not_in_file": sorted(k for k in own if k not in state),
            "not_in_model": sorted(k for k in state if k not in own)}


def load_eval_weights(model: nn.Module, path: str) -> Dict[str, List[str]]:
    """Load the model weights of the file at ``path`` (see :func:`load_weights`)."""
    return load_weights(model, read_state_dict(path), path)


def wait_until_finished() -> None:
    """Saves are synchronous: every checkpoint is in place when
    :func:`save_checkpoint` returns."""


def _write_replacing(path: str, tmp: str, write) -> None:
    """``write(handle)`` into ``tmp``, synced, then renamed over ``path``;
    a failed write removes ``tmp`` and leaves ``path`` as it was."""
    try:
        with open(tmp, "wb") as handle:
            write(handle)
            handle.flush()
            os.fsync(handle.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise


def save_checkpoint(stem: str, state, epoch: int, train_loss_hist=None, val_loss_hist=None,
                    val_acc_hist=None, conf_mat: Optional[Dict] = None) -> str:
    """Write ``<stem>.pth`` and then ``<stem>.history.json`` for ``state``
    (a ``parallel/train_step.TrainState``) after ``epoch``; returns the
    ``.pth`` path. Rank 0 writes; every rank returns once both are in
    place."""
    stem = os.path.abspath(stem)
    path = stem + ".pth"
    if mesh.is_primary():
        _write_checkpoint(stem, path, state, epoch, train_loss_hist, val_loss_hist,
                          val_acc_hist, conf_mat)
    mesh.barrier()
    return path


def _write_checkpoint(stem: str, path: str, state, epoch: int, train_loss_hist,
                      val_loss_hist, val_acc_hist, conf_mat) -> None:
    os.makedirs(os.path.dirname(stem), exist_ok=True)
    history = {"epoch": int(epoch), "train_loss": list(train_loss_hist or []),
               "validation_loss": list(val_loss_hist or []),
               "validation_accuracy": dict(val_acc_hist or {})}
    conf = {k: np.asarray(v, np.float64) for k, v in (conf_mat or {}).items()}
    payload = {
        **history,
        "model": {k: v.detach().cpu() for k, v in state.model.state_dict().items()},
        "conf_mat": {k: torch.from_numpy(v) for k, v in conf.items()},
        **state.state_dict(),
    }
    _write_replacing(path, f"{path}.tmp-{int(epoch)}", lambda fh: torch.save(payload, fh))
    if conf:
        history["conf_mat"] = {k: v.tolist() for k, v in conf.items()}
    hist = history_path(stem)
    _write_replacing(hist, hist + ".tmp", lambda fh: fh.write(json.dumps(history).encode()))


def restore_checkpoint(path: str, state) -> Tuple[object, Dict]:
    """Restore ``state`` (a ``TrainState``) from the ``.pth`` at ``path``:
    the model's weights, and the optimizer, generator and step where the
    file holds them. Returns (state, history): the history keys of the file
    (``epoch``, the loss and accuracy histories); a file without them (a
    bare state dict) gives an empty history."""
    data = read_checkpoint(path)
    load_weights(state.model, model_state(data), path)
    history: Dict = {}
    if isinstance(data, Mapping) and isinstance(data.get("model"), Mapping):
        state.load_state_dict(data)
        history = {k: data[k] for k in HISTORY_KEYS if k in data}
    return state, history

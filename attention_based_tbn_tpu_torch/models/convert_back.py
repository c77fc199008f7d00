"""The port's weights -> the reference PyTorch checkpoint.

Port of the JAX package's ``models/convert_back.py``. The port already
keeps the reference ``TBNModel`` key layout (reference
core/models/model.py:52-101), so the export is the port's state dict in
float32 on the CPU with the buffers the reference holds and the port's
loader regenerates (``utils/checkpoint.tolerated_key``) written afresh, as
the JAX package writes them: every BatchNorm's ``num_batches_tracked``
(0), the positional-encoding table ``pe.0.pe`` as (1, 10, win)
(reference attention.py:25-33) and ``attention_layer.prototype_wts`` of
prototype attention (attention.py:121-132). The result loads with
``strict=True`` into the reference ``TBNModel`` of the same config, and
into the port through ``utils/checkpoint.load_weights``.

The CLI reads the port's ``.pth`` training checkpoint (``test.pre_trained``)
and writes the reference's checkpoint layout (reference
core/utils/misc.py:92-112) as the JAX package does: ``epoch``, the three
histories, ``optimizer`` ({}: the port's optimizer state follows its own
parameter order) and ``model``. The port-only ``generator`` and ``step``
entries, and ``conf_mat``, are not written. An Orbax directory of the JAX
package is refused (``utils/checkpoint.read_checkpoint``): only the JAX
package reads Orbax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Union

import torch
import torch.nn as nn

from ..utils.checkpoint import tolerated_key
from .attention import PE_CHANNELS, positional_encoding_table, prototypes


def export_tbn_state_dict(source: Union[nn.Module, Mapping[str, torch.Tensor]], spec
                          ) -> Dict[str, torch.Tensor]:
    """A port model (or its state dict) -> the reference
    ``TBNModel.state_dict()``: float32 tensors on the CPU, and the
    regenerated buffers. ``spec`` (a ``models/tbn.TBNSpec``) gives the
    attention type and window of ``pe.0.pe`` / ``prototype_wts``."""
    state = source.state_dict() if isinstance(source, nn.Module) else source
    out: Dict[str, torch.Tensor] = {}
    for key, value in state.items():
        if tolerated_key(key):  # the regenerated buffers: written afresh
            continue
        out[key] = torch.as_tensor(value).detach().to("cpu", torch.float32).contiguous()
        if key.endswith(".running_var"):
            out[key[: -len("running_var")] + "num_batches_tracked"] = torch.zeros(
                (), dtype=torch.int64)
    if "pe.1.weight" in out:
        table = positional_encoding_table(PE_CHANNELS, spec.attn_win)
        out["pe.0.pe"] = torch.from_numpy(table.T.copy())[None]
    if spec.attention_type == "proto" and "attention_layer.seq.0.weight" in out:
        out["attention_layer.prototype_wts"] = torch.from_numpy(prototypes(spec.attn_win))
    return out


def save_reference_checkpoint(path: str, source, spec, epoch: int = 0,
                              train_loss_hist: Optional[list] = None,
                              val_loss_hist: Optional[list] = None,
                              val_acc_hist: Optional[Any] = None) -> Dict[str, Any]:
    """Write a reference-format ``.pth`` training checkpoint of ``source``
    (a port model or state dict): the dict layout of reference
    core/utils/misc.py:92-112 without optimizer state. It loads in the
    reference's eval path (``data_dict["model"]``), in the port's
    ``test.pre_trained`` and in the JAX package's importer."""
    data = {
        "epoch": int(epoch),
        "train_loss": train_loss_hist or [],
        "validation_loss": val_loss_hist or [],
        "validation_accuracy": val_acc_hist or [],
        "optimizer": {},
        "model": export_tbn_state_dict(source, spec),
    }
    torch.save(data, path)
    return data


def main(argv=None):
    """CLI: the port's ``.pth`` training checkpoint -> a reference ``.pth``::

        python -m attention_based_tbn_tpu_torch.models.convert_back \\
            --output tbn_reference.pth \\
            test.pre_trained=<out_dir>/tbn_weights/<exp>/epic_tbn_bninception_RGB_Flow_Audio.pth \\
            model.attention.type=mha data.audio.audio_length=2.1

    The model overrides must match the training run's (they give the key
    layout and the regenerated buffers). Runs on the CPU: no card needed.
    """
    import argparse
    import sys

    from ..config import load_config
    from ..utils.checkpoint import model_state, read_checkpoint
    from ..utils.misc import get_modality
    from .tbn import TBNSpec

    parser = argparse.ArgumentParser(
        description="Export the port's .pth checkpoint as a reference PyTorch .pth")
    parser.add_argument("--output", required=True, help="destination .pth path")
    args, overrides = parser.parse_known_args(argv)

    cfg = load_config(overrides=overrides)
    if not cfg.test.pre_trained:
        raise SystemExit("set test.pre_trained=<the port's .pth checkpoint>")
    data = read_checkpoint(str(cfg.test.pre_trained))
    spec = TBNSpec.from_config(cfg, get_modality(cfg))
    history = data if isinstance(data, Mapping) and "model" in data else {}
    save_reference_checkpoint(
        args.output, model_state(data), spec,
        epoch=int(history.get("epoch", 0)),
        train_loss_hist=history.get("train_loss"),
        val_loss_hist=history.get("validation_loss"),
        val_acc_hist=history.get("validation_accuracy"),
    )
    print(f"wrote {args.output}", file=sys.stderr)


if __name__ == "__main__":
    main()

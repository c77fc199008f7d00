"""Model FLOPs and the kernels' shapes, counted from the reference.

The plain reference runs on the ``meta`` device (shapes only, no data)
under ``torch.utils.flop_counter.FlopCounterMode``, which counts the
convolutions and matrix products: 2 FLOPs a multiply-add. Serving counts
the forward; training the forward and the backward as the step takes them
(no gradient for the input frames; nothing recomputed).
"""

from __future__ import annotations

from typing import Dict

import torch

from ..reference import tbn, train as ref_train

ELT = {"bfloat16": 2, "float32": 4}


def _meta_batch(desc: dict, clips: int, segments: int) -> Dict[str, torch.Tensor]:
    out = {}
    crop = desc["crop"]
    for m in desc["modality"]:
        if m == "Audio":
            a = desc["audio"]
            out[m] = torch.empty(clips, segments, int(a["seconds"] * a["sampling_rate"]),
                                 device="meta")
        else:
            channels = 3 if m == "RGB" else desc["flow_channels"]
            out[m] = torch.empty(clips, segments, crop, crop, channels, dtype=torch.uint8,
                                 device="meta")
    return out


def _meta_params(desc: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.empty(shape, device="meta", dtype=torch.long if kind == "count"
                           else torch.float32)
            for k, (shape, kind, _) in tbn.param_spec(desc).items()}


def spectrogram_shape(audio: dict) -> tuple:
    """(frequency bins, frames) of the centred STFT of the audio window."""
    length = int(audio["seconds"] * audio["sampling_rate"])
    hop = int(round(audio["hop_ms"] * audio["sampling_rate"] / 1e3))
    n_fft = audio["n_fft"]
    return n_fft // 2 + 1, 1 + (length + 2 * (n_fft // 2) - n_fft) // hop


def flops_per_clip(desc: dict, segments: int, train: bool, recipe: dict = None) -> float:
    from torch.utils.flop_counter import FlopCounterMode

    params = _meta_params(desc)
    batch = _meta_batch(desc, 1, segments)
    names = ref_train.trainable(tbn.param_spec(desc), recipe["freeze"]) if train else []
    for name in names:
        params[name].requires_grad_(True)
    with FlopCounterMode(display=False) as counter:
        out = tbn.forward(params, desc, batch, tbn.Context(train=train))
        if train:
            loss = sum(out[h].sum() for h in desc["num_classes"])
            torch.autograd.grad(loss, [params[n] for n in names], allow_unused=True)
    return float(counter.get_total_flops())


def model_shapes(desc: dict, clips: int, segments: int) -> dict:
    """The shapes the kernels' costs read (costs/kernels.work)."""
    ctx = tbn.Context(pools=[])
    with torch.no_grad():
        tbn.forward(_meta_params(desc), desc, _meta_batch(desc, clips, segments), ctx)
    towers = len(desc["modality"])
    per = len(ctx.pools) // towers if ctx.pools else 0
    stems = []
    for m in desc["modality"]:
        if m == "Audio":
            f, t = spectrogram_shape(desc["audio"])
            stems.append((f, t, 1, 4))  # float32 log power
        else:
            stems.append((desc["crop"], desc["crop"], 3 if m == "RGB" else desc["flow_channels"],
                          1))
    att = desc["attention"] or {}
    return {
        "clips": clips, "segments": segments, "rows": clips * segments,
        "elt": ELT[desc["compute_dtype"]], "width": tbn.feature_size(desc),
        "seq": att.get("window", 0), "pe_channels": att.get("pe_channels", 0),
        "fusion": desc["fusion"], "classes": sum(desc["num_classes"].values()),
        "stems": stems,
        "pools": [ctx.pools[i * per:(i + 1) * per] for i in range(towers)] if per else [],
    }

"""Weights and inputs made from the run's seed, on the device, in bulk.

One seed gives one set of weights and one set of inputs; the program and
the reference are handed the same. Each use draws from its own generator
(weights, inputs, the program's dropout noise), so a change in one leaves
the others as they were.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..reference import tbn

STREAMS = {"weights": 1, "inputs": 2, "noise": 3}
AUDIO_SCALE = 0.1  # waveform standard deviation


def stream_seed(seed: int, stream: str) -> int:
    return (int(seed) * 8 + STREAMS[stream]) % (1 << 63)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def make_params(desc: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every state-dict tensor of the model, float32 (the type the program
    holds them in), from one normal draw: convolutions He-scaled, linear
    layers LeCun-scaled, BatchNorm and GroupNorm near the identity with
    some spread, small biases; the positional table as the recipe defines
    it."""
    spec = tbn.param_spec(desc)
    drawn = [n for n, (_, kind, _) in spec.items() if kind not in ("count", "pe_table")]
    total = sum(math.prod(spec[n][0]) for n in drawn)
    noise = torch.randn(total, generator=generator(seed, "weights", device), device=device)
    params, offset = {}, 0
    for name, (shape, kind, fan_in) in spec.items():
        if kind == "count":
            params[name] = torch.zeros((), dtype=torch.long, device=device)
            continue
        if kind == "pe_table":
            params[name] = tbn.pe_table(shape[1], shape[2])[None].to(device)
            continue
        n = math.prod(shape)
        z = noise[offset:offset + n].view(shape)
        offset += n
        if kind == "conv":
            params[name] = z * math.sqrt(2.0 / fan_in)
        elif kind == "linear":
            params[name] = z * math.sqrt(1.0 / fan_in)
        elif kind in ("bn_weight", "gn_weight"):
            params[name] = 1.0 + 0.1 * z
        elif kind == "bn_var":
            params[name] = torch.exp(0.1 * z)
        else:  # biases, BatchNorm shifts and running means
            params[name] = 0.05 * z
    return params


def clips(desc: dict, batch: int, segments: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """A batch of clips in the served layouts: uint8 RGB and Flow frames at
    the crop size, the audio waveform of the configured length."""
    crop = desc["crop"]
    out = {}
    for m in desc["modality"]:
        if m == "Audio":
            audio = desc["audio"]
            length = int(audio["seconds"] * audio["sampling_rate"])
            out[m] = torch.randn(batch, segments, length, generator=gen, device=device) * AUDIO_SCALE
        else:
            channels = 3 if m == "RGB" else desc["flow_channels"]
            out[m] = torch.randint(0, 256, (batch, segments, crop, crop, channels), generator=gen,
                                   device=device, dtype=torch.uint8)
    return out


def labels(desc: dict, batch: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Uniform class labels per head."""
    return {head: torch.randint(0, classes, (batch,), generator=gen, device=device)
            for head, classes in desc["num_classes"].items()}

"""Pretrained tower weights -> a tower of the port.

Port of the JAX package's ``models/convert.py`` (``convert_bninception``,
``convert_resnet``, ``convert_vgg``, ``adapt_first_conv_at``) for the files
``models/builder.load_pretrained_towers`` reads (a ``.npz`` through
``models/convert_cli.load_npz``):

* a pretrainedmodels BN-Inception state dict (``imagenet_bninception_rgb.pth``,
  ``kinetics_bninception_flow.pth``; reference weights/download.sh). The
  port keeps the reference key layout, so its tower takes the keys as they
  are, without the ImageNet / Kinetics classifier (``last_linear``) and
  the ``num_batches_tracked`` counters;
* a torchvision ResNet or VGG state dict (``resnet<depth>.pth``,
  ``vgg<type>.pth``), whose keys the port's ``ResNet`` / ``VGG`` towers keep
  under ``model.``, without the ImageNet classifier (``fc``, VGG's
  ``classifier.6``) and the batch counters;
* any of these towers converted by the JAX package to a ``.npz`` of Flax
  trees (``params/<path>``, ``batch_stats/<path>``), through
  ``bridge.jax_tower_to_state_dict``.

A first conv with other input channels than the modality's is averaged
over its input channels and tiled to them (TSN cross-modality init,
reference bn_inception.py:78-80), in the port's OIHW layout. As in the JAX
package this covers ResNet's ``conv1`` and VGG's ``features.0`` too (the
reference assigns ResNet's mean untiled, which only fits one channel, and
leaves VGG's new conv random: a documented divergence of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .bridge import jax_tower_to_state_dict
from .convert_cli import load_npz

# the first conv of each tower family (state-dict module name)
FIRST_CONVS = {"bninception": "conv1_7x7_s2", "resnet": "conv1", "vgg": "features.0"}


def convert_bninception(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """pretrainedmodels BN-Inception state dict -> the port's tower state
    dict (float32; no classifier, no batch counters)."""
    return {k: torch.as_tensor(v).to(torch.float32) for k, v in state_dict.items()
            if not k.startswith("last_linear") and not k.endswith("num_batches_tracked")}


def convert_resnet(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision ResNet state dict -> the port's ``ResNet.model`` state
    dict (float32; no ``fc``, no batch counters)."""
    return {k: torch.as_tensor(v).to(torch.float32) for k, v in state_dict.items()
            if not k.startswith("fc.") and not k.endswith("num_batches_tracked")}


def convert_vgg(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """torchvision VGG state dict -> the port's ``VGG.model`` state dict
    (float32; no last classifier Linear, ``classifier.6``, no batch
    counters)."""
    return {k: torch.as_tensor(v).to(torch.float32) for k, v in state_dict.items()
            if not k.startswith("classifier.6.") and not k.endswith("num_batches_tracked")}


def load_npz_tower(path: str, arch: str = "bninception", vgg_type: str = "16"
                   ) -> Dict[str, torch.Tensor]:
    """A tower converted to ``.npz`` by the JAX package (``params/...`` and
    ``batch_stats/...`` arrays) -> the port's tower state dict (ResNet's and
    VGG's in torchvision's keys)."""
    params, stats = load_npz(path)
    state = jax_tower_to_state_dict(params, stats, arch, vgg_type)
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()
            if not k.endswith("num_batches_tracked")}


def adapt_first_conv(state: Dict[str, torch.Tensor], in_channels: int,
                     conv: str = "conv1_7x7_s2") -> Dict[str, torch.Tensor]:
    """Replace the (O, I, H, W) weight of ``conv`` by its mean over the I
    input channels, tiled to ``in_channels`` (the JAX package's
    ``adapt_first_conv_at``; a float32 numpy mean, whose in-order sum is
    the JAX package's)."""
    weight = state[f"{conv}.weight"].to(torch.float32).numpy()
    mean = weight.mean(axis=1, keepdims=True)
    state[f"{conv}.weight"] = torch.from_numpy(np.tile(mean, (1, in_channels, 1, 1)))
    return state


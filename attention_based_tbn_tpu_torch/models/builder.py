"""Model construction and pretrained tower weights.

Port of the JAX package's ``models/builder.py`` (reference
core/models/model_builder.py): ``build_model`` checks the arch, loss and
quantize choices and builds the seeded TBN; ``load_pretrained_towers``
loads converted pretrained weights into each tower when the files exist,
and warns and keeps the seeded init when they do not: for BN-Inception
ImageNet for RGB and Audio, Kinetics for Flow (reference
bn_inception.py:38-107); for ResNet and VGG torchvision's ImageNet file of
the configured depth / type, shared by every modality (reference
resnet.py:26-36, vgg.py:20-33); a first conv of other input channels is
channel-meaned and tiled.
"""

from __future__ import annotations

import os
from typing import Dict, List

import torch

from ..utils.checkpoint import load_weights, read_state_dict
from ..utils.device import resolve_device
from .convert import (FIRST_CONVS, adapt_first_conv, convert_bninception, convert_resnet,
                      convert_vgg, load_npz_tower)
from .tbn import TBNModel, TBNSpec

_MODEL_TYPES = ("vgg", "resnet", "bninception")
_LOSS_TYPES = ("crossentropy", "nll", "kl", "mse", "smoothl1")
# BN-Inception's pretrained file stem per modality (``<weights_dir>/<stem>.{npz,pth}``)
PRETRAINED_STEMS = {"RGB": "imagenet_bninception_rgb", "Audio": "imagenet_bninception_rgb",
                    "Flow": "kinetics_bninception_flow"}


def check_config(cfg) -> None:
    """The JAX package's arch / loss choices: an unknown arch or loss, and a
    prior-loss name as the head loss, are refused. (Audio attention on a
    ResNet or VGG tower is refused by ``TBNSpec.validate``, ``tpu.quantize``
    by :func:`build_model`.)"""
    if cfg.model.arch not in _MODEL_TYPES:
        raise ValueError(f"Model type '{cfg.model.arch}' not supported")
    if cfg.model.loss_fn not in _LOSS_TYPES:
        raise ValueError(f"Loss type '{cfg.model.loss_fn}' not supported")
    if cfg.model.loss_fn not in ("crossentropy", "nll"):
        # the reference registers these names but its head loss hardwires
        # crossentropy (core/models/model.py:294); they are prior losses
        raise ValueError(
            f"model.loss_fn={cfg.model.loss_fn!r} is a prior-loss (model.attention.wt_loss) "
            "option, not a head loss; use 'crossentropy' or 'nll'"
        )


def build_model(cfg, modality: List[str], device="cuda", seed: int = None) -> TBNModel:
    """The TBN for ``cfg`` and ``modality``, initialized from ``seed``
    (default ``cfg.data.manual_seed``) with a ``torch.Generator``, on
    ``device`` and in eval mode. Raises without CUDA unless ``device`` is
    the CPU."""
    device = resolve_device(device)
    check_config(cfg)
    spec = TBNSpec.from_config(cfg, modality)
    spec.validate()
    if spec.quantize:
        # the JAX package's refusal (models/builder.py:41-52): the drivers
        # carry no calibrated amaxes; the int8 towers are API-only
        raise ValueError(
            "tpu.quantize is an opt-in serving mode, not a driver mode: build the model "
            "directly and calibrate via models.tbn.calibrate_quantization; unset "
            "tpu.quantize for train/test/export"
        )
    model = TBNModel(spec)
    seed = int(cfg.data.manual_seed if seed is None else seed)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


def weights_dir(cfg) -> str:
    """``model.weights_dir``; a relative one is taken from the repository
    root (the directory that holds the package), as the JAX package does."""
    configured = cfg.get_path("model.weights_dir", "weights") or "weights"
    if os.path.isabs(configured):
        return configured
    repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(repo_root, configured)


def pretrained_stems(cfg) -> Dict[str, str]:
    """{modality: file stem} of the pretrained towers of ``model.arch``."""
    arch = cfg.model.arch
    if arch == "resnet":
        return dict.fromkeys(("RGB", "Flow", "Audio"), f"resnet{int(cfg.model.resnet.depth)}")
    if arch == "vgg":
        return dict.fromkeys(("RGB", "Flow", "Audio"), f"vgg{cfg.model.vgg.type}")
    return dict(PRETRAINED_STEMS)


def load_pretrained_towers(cfg, modality: List[str], model: TBNModel, logger=None
                           ) -> Dict[str, str]:
    """Load ``<weights_dir>/<stem>.npz`` (a tower converted by the JAX
    package), else ``<stem>.pth`` (a pretrainedmodels BN-Inception or a
    torchvision ResNet / VGG state dict), into each modality's tower; a
    first conv of other input channels is adapted
    (``convert.adapt_first_conv``). Nothing under ``model.pretrained=false``;
    a missing file, and the Audio tower under ``model.bninception.
    audio_stem`` (no pretrained counterpart), keep the seeded init with a
    warning. Returns {tower: file loaded}."""
    loaded: Dict[str, str] = {}
    if not cfg.get_path("model.pretrained", True):
        return loaded
    arch = cfg.model.arch
    vgg_type = str(cfg.model.vgg.type)
    convert = {"bninception": convert_bninception, "resnet": convert_resnet,
               "vgg": convert_vgg}[arch]
    first_conv = FIRST_CONVS[arch]
    stems = pretrained_stems(cfg)
    directory = weights_dir(cfg)
    audio_alt_stem = arch == "bninception" and bool(
        cfg.get_path("model.bninception.audio_stem", False))
    in_channels = {"RGB": 3, "Flow": 2 * int(cfg.data.flow.win_length), "Audio": 1}
    for m in modality:
        tower = f"Base_{m}"
        if m == "Audio" and audio_alt_stem:
            if logger:
                logger.warning(
                    "model.bninception.audio_stem=true: the (3,1)/(1,3) stem has no pretrained "
                    "counterpart (the reference never loads BNInception_Audio either); "
                    "Base_Audio keeps random init")
            continue
        stem = os.path.join(directory, stems[m])
        if os.path.exists(stem + ".npz"):
            state, path = load_npz_tower(stem + ".npz", arch, vgg_type), stem + ".npz"
        elif os.path.exists(stem + ".pth"):
            state, path = convert(read_state_dict(stem + ".pth")), stem + ".pth"
        else:
            if logger:
                logger.warning(f"Pretrained weights {stem}.{{npz,pth}} not found; "
                               f"{tower} keeps random init")
            continue
        if state[f"{first_conv}.weight"].shape[1] != in_channels[m]:
            adapt_first_conv(state, in_channels[m], first_conv)
        target = getattr(model, tower)
        # the torchvision towers' keys sit under the tower's ``model``
        load_weights(target if arch == "bninception" else target.model, state,
                     f"{path} ({tower})")
        loaded[tower] = path
        if logger:
            logger.info(f"{tower} initialized from {os.path.basename(path)}")
    return loaded

#!/usr/bin/env python
"""CLI: a PyTorch checkpoint -> the ``.npz`` of Flax trees the JAX package reads.

Port of the JAX package's ``models/convert_cli.py``::

  python -m attention_based_tbn_tpu_torch.models.convert_cli \\
      --input weights/imagenet_bninception_rgb.pth \\
      --kind bninception --output weights/imagenet_bninception_rgb.npz

  python -m attention_based_tbn_tpu_torch.models.convert_cli \\
      --input ckpt.pth --kind tbn --arch bninception --output ckpt.npz

``--kind bninception|resnet|vgg`` takes one tower (pretrainedmodels'
BN-Inception, torchvision's ResNet or VGG; the ImageNet head and the batch
counters are dropped), ``--kind tbn`` a whole TBN state dict (the port's,
the reference's, or a ``{"model": ...}`` training checkpoint). The trees
come from ``models/bridge.py`` (``tower_state_dict_to_jax``,
``state_dict_to_jax``), in float32. ``--in-channels`` adapts a
BN-Inception tower's first conv to that many input channels (the channel
mean, tiled), as the JAX CLI does.

The ``.npz`` holds flattened ``params/<path>`` and ``batch_stats/<path>``
arrays; :func:`load_npz` reassembles the trees.
"""

from __future__ import annotations

import argparse
from typing import Dict, Tuple

import numpy as np


def flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def save_npz(path: str, params: Dict, batch_stats: Dict) -> None:
    payload = {}
    payload.update({f"params/{k}": v for k, v in flatten(params).items()})
    payload.update({f"batch_stats/{k}": v for k, v in flatten(batch_stats).items()})
    np.savez_compressed(path, **payload)


def load_npz(path: str) -> Tuple[Dict, Dict]:
    with np.load(path) as data:
        params_flat = {
            k[len("params/"):]: data[k] for k in data.files if k.startswith("params/")
        }
        stats_flat = {
            k[len("batch_stats/"):]: data[k]
            for k in data.files
            if k.startswith("batch_stats/")
        }
    return unflatten(params_flat), unflatten(stats_flat)


def _float32(tree: Dict) -> Dict:
    """Every leaf as a C-contiguous float32 array (the JAX converter's)."""
    return unflatten({k: np.ascontiguousarray(v, dtype=np.float32)
                      for k, v in flatten(tree).items()})


def adapt_first_conv(params: Dict, in_channels: int, conv: str = "conv1_7x7_s2") -> Dict:
    """The HWIO kernel of ``conv`` -> its mean over the input channels,
    tiled to ``in_channels`` (TSN cross-modality init, reference
    bn_inception.py:78-80; the JAX package's ``adapt_first_conv``)."""
    node = params[conv]["conv"]
    mean = node["kernel"].mean(axis=2, keepdims=True)
    node["kernel"] = np.tile(mean, (1, 1, in_channels, 1)).astype(np.float32)
    return params


def convert(state_dict, kind: str, arch: str = "bninception", vgg_type: str = "16",
            in_channels: int = 0) -> Tuple[Dict, Dict]:
    """A state dict -> (params, batch_stats) trees for ``kind`` (see the
    module docstring). The bridge tells a tower's family and VGG depth by
    its keys; ``arch`` (``kind="tbn"``) and ``vgg_type`` (``kind="vgg"``)
    must agree with them."""
    from ..utils.checkpoint import tolerated_key
    from .bridge import state_dict_to_jax, tower_arch, tower_state_dict_to_jax
    from .convert import convert_bninception, convert_resnet, convert_vgg
    from .vgg import VGG_CONFIGS, vgg_base_type

    if kind == "tbn":
        towers: Dict[str, list] = {}
        for key in state_dict:
            if key.startswith("Base_"):
                tower, _, rest = key.partition(".")
                towers.setdefault(tower, []).append(rest)
        found = {tower: tower_arch(keys) for tower, keys in towers.items()}
        if any(family != arch for family in found.values()):
            raise ValueError(f"--arch {arch}: the checkpoint's towers are {found}")
        trees = state_dict_to_jax({k: v for k, v in state_dict.items()
                                   if not tolerated_key(k)})
    else:
        tower = {"bninception": convert_bninception, "resnet": convert_resnet,
                 "vgg": convert_vgg}[kind](state_dict)
        trees = tower_state_dict_to_jax(tower, kind)
        if kind == "vgg":
            convs = sum(c != "M" for c in VGG_CONFIGS[vgg_base_type(vgg_type)])
            if sum(name.startswith("conv") for name in trees["params"]) != convs:
                raise ValueError(f"--vgg-type {vgg_type}: the state dict holds another "
                                 "number of convs")
    params, stats = _float32(trees["params"]), _float32(trees["batch_stats"])
    if kind == "bninception" and in_channels:
        adapt_first_conv(params, in_channels)
    return params, stats


def main(argv=None):
    from ..utils.checkpoint import read_state_dict

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--input", required=True, help=".pth file")
    parser.add_argument(
        "--kind", required=True,
        choices=["bninception", "resnet", "vgg", "tbn"],
    )
    parser.add_argument("--arch", default="bninception", help="tower arch for --kind tbn")
    parser.add_argument("--vgg-type", default="16")
    parser.add_argument(
        "--in-channels", type=int, default=0,
        help="adapt the first conv to this many input channels (0 = keep)",
    )
    parser.add_argument("--output", required=True, help=".npz output path")
    args = parser.parse_args(argv)

    params, stats = convert(read_state_dict(args.input), args.kind, args.arch, args.vgg_type,
                            args.in_channels)
    save_npz(args.output, params, stats)
    n = len(flatten(params)) + len(flatten(stats))
    print(f"Wrote {n} arrays to {args.output}")


if __name__ == "__main__":
    main()

"""Weight bridge between the JAX package's variables and the port.

The JAX package keeps its weights as Flax variables: nested dicts of arrays
under ``params`` and ``batch_stats`` (HWIO conv kernels, (in, out) dense
kernels). The port keeps the reference PyTorch state-dict layout, the one
the JAX package's ``models/convert_back.export_tbn_state_dict`` emits:
``Base_RGB.conv1_7x7_s2.weight``, ``Base_RGB.conv1_7x7_s2_bn.running_var``,
``pe.1.weight``, ``attention_layer.attention_layer.in_proj_weight``, ...;
ResNet and VGG towers in torchvision's layout under ``Base_<m>.model.``
(``Base_RGB.model.layer1.0.downsample.1.running_var``,
``Base_RGB.model.features.0.weight``, ``Base_RGB.model.classifier.3.bias``).

* :func:`jax_to_state_dict` — variables (numpy) -> state dict (numpy), for
  ``load_state_dict(strict=True)``; buffers the reference also stores (the
  PE table, the prototype curves, ``num_batches_tracked``) are regenerated.
* :func:`jax_tower_to_state_dict` — the same for one tower's trees, as a
  converted pretrained ``.npz`` tower holds them (models/convert.py).
* :func:`state_dict_to_jax` — the inverse, so that weights drawn by the
  port can be fed to the JAX package (the tests do). It takes no spec: a
  tower's family is told by its keys (``model.layer...`` ResNet,
  ``model.features...`` VGG, else BN-Inception), VGG's BatchNorm by its
  running statistics and its depth by its number of convs.
* :func:`kernel_keys` — the state-dict keys whose tensors are images of
  JAX ``kernel`` leaves (conv and dense weights: what the serving export
  quantizes or casts).
* :func:`quant_stats_to_jax` / :func:`load_quant_stats` — the towers'
  calibrated int8 amaxes (``tpu.quantize``) <-> the JAX package's separate
  ``quant_stats`` collection (``Base_<m>/conv2_3x3_reduce/amax``,
  ``Base_<m>/inception_3a/in_amax``, ...); the state dict holds none.
* :func:`conv3x3_weight_from_jax` / :func:`conv3x3_weight_to_jax` — one
  3x3 conv kernel, HWIO (3, 3, C_in, C_out) <-> torch's (C_out, C_in, 3,
  3), for the fused-block probe's convolution (``ops/kernels.conv3x3``).

The port keeps its own copy of this numpy logic; it imports nothing of the
JAX package.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .attention import PE_CHANNELS, positional_encoding_table, prototypes
from .vgg import VGG_CONFIGS, vgg_base_type, vgg_conv_feature_indices

_MHA_PROJ = ("q_proj", "k_proj", "v_proj")


def _np(value) -> np.ndarray:
    return np.asarray(value, dtype=np.float32)


def _get(tree: Optional[Mapping], *path):
    node = tree
    for key in path:
        if not isinstance(node, Mapping) or key not in node:
            return None
        node = node[key]
    return node


def _set(tree: Dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _emit_conv_bn(out: Dict[str, np.ndarray], key: str, node: Mapping,
                  stats: Optional[Mapping]) -> None:
    """{conv: {kernel, bias}, bn: {scale, bias}} -> ``key.*`` + ``key_bn.*``."""
    out[f"{key}.weight"] = np.transpose(_np(node["conv"]["kernel"]), (3, 2, 0, 1)).copy()
    out[f"{key}.bias"] = _np(node["conv"]["bias"])
    scale = _np(node["bn"]["scale"])
    bn_stats = _get(stats, "bn") or {}
    out[f"{key}_bn.weight"] = scale
    out[f"{key}_bn.bias"] = _np(node["bn"]["bias"])
    # without statistics: a fresh BatchNorm's mean 0 / var 1
    out[f"{key}_bn.running_mean"] = _np(bn_stats.get("mean", np.zeros_like(scale)))
    out[f"{key}_bn.running_var"] = _np(bn_stats.get("var", np.ones_like(scale)))
    out[f"{key}_bn.num_batches_tracked"] = np.zeros((), dtype=np.int64)


def _emit_tower(out: Dict[str, np.ndarray], prefix: str, params: Mapping,
                stats: Optional[Mapping]) -> None:
    """A BN-Inception tower's Flax tree -> ``prefix + <module>.*`` keys."""
    for name, sub in params.items():
        sub_stats = _get(stats, name)
        if "conv" in sub:
            _emit_conv_bn(out, f"{prefix}{name}", sub, sub_stats)
        else:  # inception block: children are branch cells
            for branch, cell in sub.items():
                _emit_conv_bn(out, f"{prefix}{name}_{branch}", cell, _get(sub_stats, branch))


def _emit_bn(out: Dict[str, np.ndarray], key: str, node: Mapping,
             stats: Optional[Mapping]) -> None:
    """{scale, bias} (+ {mean, var}) -> torch BatchNorm ``key.*``."""
    scale = _np(node["scale"])
    out[f"{key}.weight"] = scale
    out[f"{key}.bias"] = _np(node["bias"])
    stats = stats or {}
    out[f"{key}.running_mean"] = _np(stats.get("mean", np.zeros_like(scale)))
    out[f"{key}.running_var"] = _np(stats.get("var", np.ones_like(scale)))
    out[f"{key}.num_batches_tracked"] = np.zeros((), dtype=np.int64)


def _emit_conv(out: Dict[str, np.ndarray], key: str, node: Mapping) -> None:
    out[f"{key}.weight"] = np.transpose(_np(node["kernel"]), (3, 2, 0, 1)).copy()
    if "bias" in node:
        out[f"{key}.bias"] = _np(node["bias"])


def export_resnet(params: Mapping, stats: Optional[Mapping] = None) -> Dict[str, np.ndarray]:
    """A ResNet tower's Flax trees -> torchvision's state dict without ``fc``
    (the JAX package's ``convert_back.export_resnet``): ``layer<s>_<i>``
    blocks become ``layer<s>.<i>``, their ``downsample_conv`` /
    ``downsample_bn`` ``downsample.0`` / ``downsample.1``."""
    out: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        node_stats = _get(stats, name)
        if name == "conv1":
            _emit_conv(out, name, node)
        elif name == "bn1":
            _emit_bn(out, name, node, node_stats)
        elif name.startswith("layer"):
            prefix = ".".join(name.rsplit("_", 1))
            for sub, sub_node in node.items():
                key = {"downsample_conv": "downsample.0",
                       "downsample_bn": "downsample.1"}.get(sub, sub)
                if "kernel" in sub_node:
                    _emit_conv(out, f"{prefix}.{key}", sub_node)
                else:
                    _emit_bn(out, f"{prefix}.{key}", sub_node, _get(node_stats, sub))
    return out


def export_vgg(params: Mapping, stats: Optional[Mapping] = None,
               vgg_type: str = "16") -> Dict[str, np.ndarray]:
    """A VGG tower's Flax trees -> torchvision's state dict without the last
    classifier Linear (the JAX package's ``convert_back.export_vgg``):
    ``conv<i>`` / ``bn<i>`` at their ``features.<idx>``, ``fc1`` / ``fc2``
    as ``classifier.0`` / ``classifier.3``."""
    feat_of_conv = {conv: feat for feat, conv in vgg_conv_feature_indices(
        vgg_type, vgg_type.endswith("bn") or bool(stats)).items()}
    out: Dict[str, np.ndarray] = {}
    for name, node in params.items():
        if name.startswith("conv"):
            _emit_conv(out, f"features.{feat_of_conv[int(name[4:])]}", node)
        elif name.startswith("bn"):
            _emit_bn(out, f"features.{feat_of_conv[int(name[2:])] + 1}", node,
                     _get(stats, name))
        elif name in ("fc1", "fc2"):
            key = "classifier.0" if name == "fc1" else "classifier.3"
            out[f"{key}.weight"] = _np(node["kernel"]).T.copy()
            out[f"{key}.bias"] = _np(node["bias"])
    return out


def jax_tower_to_state_dict(params: Mapping, stats: Optional[Mapping] = None,
                            arch: str = "bninception", vgg_type: str = "16"
                            ) -> Dict[str, np.ndarray]:
    """One tower's Flax ``params`` / ``batch_stats`` trees (as a converted
    ``.npz`` tower holds them) -> the tower's state dict: BN-Inception's
    keys relative to the tower (``conv1_7x7_s2.weight``, ...), ResNet's and
    VGG's torchvision keys (``conv1.weight``, ``features.0.weight``, ...)."""
    if arch == "resnet":
        return export_resnet(params, stats)
    if arch == "vgg":
        return export_vgg(params, stats, vgg_type)
    out: Dict[str, np.ndarray] = {}
    _emit_tower(out, "", params, stats)
    return out


def _tower_prefix(tower: str, arch: str) -> str:
    """The state-dict prefix of a tower's keys: the reference wraps the
    torchvision ResNet and VGG under ``.model``; BN-Inception's keys sit
    directly under the tower."""
    return f"{tower}." if arch == "bninception" else f"{tower}.model."


def jax_to_state_dict(variables: Mapping[str, Any], spec) -> Dict[str, np.ndarray]:
    """Flax TBN variables -> the port's (reference-layout) state dict."""
    if spec.arch not in ("bninception", "resnet", "vgg"):
        raise ValueError(f"Unknown arch {spec.arch!r}")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    for tower, node in params.items():
        if tower.startswith("Base_"):
            tower_sd = jax_tower_to_state_dict(node, _get(stats, tower), spec.arch,
                                               getattr(spec, "vgg_type", "16"))
            prefix = _tower_prefix(tower, spec.arch)
            out.update({prefix + k: v for k, v in tower_sd.items()})

    fusion = _get(params, "fusion", "fc")
    if fusion is not None:
        out["fusion.fusion_layer.0.weight"] = _np(fusion["kernel"]).T.copy()
        out["fusion.fusion_layer.0.bias"] = _np(fusion["bias"])
    for cls, node in (_get(params, "classifier") or {}).items():
        out[f"classifier.{cls}.weight"] = _np(node["kernel"]).T.copy()
        out[f"classifier.{cls}.bias"] = _np(node["bias"])

    pe = _get(params, "pe")
    if pe is not None:
        table = positional_encoding_table(PE_CHANNELS, spec.attn_win)
        out["pe.0.pe"] = np.ascontiguousarray(table.T)[None]
        out["pe.1.weight"] = _np(pe["conv"]["kernel"]).T.copy()[..., None]
        out["pe.1.bias"] = _np(pe["conv"]["bias"])
        out["pe.2.weight"] = _np(pe["norm"]["scale"])
        out["pe.2.bias"] = _np(pe["norm"]["bias"])

    attn = _get(params, "attention_layer")
    if attn is not None:
        if spec.attention_type == "mha":
            prefix = "attention_layer.attention_layer"
            out[f"{prefix}.in_proj_weight"] = np.concatenate(
                [_np(attn[p]["kernel"]).T for p in _MHA_PROJ], axis=0
            )
            out[f"{prefix}.in_proj_bias"] = np.concatenate(
                [_np(attn[p]["bias"]) for p in _MHA_PROJ]
            )
            out[f"{prefix}.out_proj.weight"] = _np(attn["out_proj"]["kernel"]).T.copy()
            out[f"{prefix}.out_proj.bias"] = _np(attn["out_proj"]["bias"])
        else:  # unimodal / proto MLP: Sequential(Linear, ReLU, Linear)
            for idx, fc in ((0, "fc1"), (2, "fc2")):
                out[f"attention_layer.seq.{idx}.weight"] = _np(attn[fc]["kernel"]).T.copy()
                out[f"attention_layer.seq.{idx}.bias"] = _np(attn[fc]["bias"])
            if spec.attention_type == "proto":
                out["attention_layer.prototype_wts"] = prototypes(spec.attn_win)
    return out


def _conv_to_jax(params: Dict, path, leaf: str, value) -> None:
    if leaf == "weight":
        _set(params, path + ["kernel"], np.transpose(value, (2, 3, 1, 0)))
    elif leaf == "bias":
        _set(params, path + ["bias"], value)


def _bn_to_jax(params: Dict, stats: Dict, path, leaf: str, value) -> None:
    if leaf in ("weight", "bias"):
        _set(params, path + ["scale" if leaf == "weight" else "bias"], value)
    elif leaf in ("running_mean", "running_var"):
        _set(stats, path + ["mean" if leaf == "running_mean" else "var"], value)


def _bninception_to_jax(tower: str, sd: Mapping, params: Dict, stats: Dict) -> None:
    for key, value in sd.items():
        name, _, leaf = key.rpartition(".")
        is_bn = name.endswith("_bn")
        cell = name[: -len("_bn")] if is_bn else name
        if cell.startswith("inception_"):
            _, block, branch = cell.split("_", 2)
            path = [tower, f"inception_{block}", branch]
        else:
            path = [tower, cell]
        if is_bn:
            _bn_to_jax(params, stats, path + ["bn"], leaf, value)
        else:
            _conv_to_jax(params, path + ["conv"], leaf, value)


def _resnet_to_jax(tower: str, sd: Mapping, params: Dict, stats: Dict) -> None:
    """torchvision ResNet keys (the JAX package's ``convert.convert_resnet``:
    ``fc`` and the batch counters dropped)."""
    for key, value in sd.items():
        parts = key.split(".")
        leaf = parts[-1]
        if parts[0] == "fc" or leaf == "num_batches_tracked":
            continue
        if parts[0] in ("conv1", "bn1"):
            path, is_conv = [tower, parts[0]], parts[0] == "conv1"
        elif parts[2] == "downsample":
            is_conv = parts[3] == "0"
            path = [tower, f"{parts[0]}_{parts[1]}",
                    "downsample_conv" if is_conv else "downsample_bn"]
        else:
            path, is_conv = [tower, f"{parts[0]}_{parts[1]}", parts[2]], parts[2].startswith("conv")
        if is_conv:
            _conv_to_jax(params, path, leaf, value)
        else:
            _bn_to_jax(params, stats, path, leaf, value)


def _vgg_to_jax(tower: str, sd: Mapping, params: Dict, stats: Dict) -> None:
    """torchvision VGG keys (the JAX package's ``convert.convert_vgg``:
    ``classifier.6`` and the batch counters dropped). BatchNorm is told by
    the running statistics, the VGG config by the number of convs."""
    batch_norm = any(k.endswith(".running_mean") for k in sd)
    n_convs = len({k for k in sd if k.startswith("features.") and k.endswith(".weight")
                   and np.ndim(sd[k]) == 4})
    types = [t for t, cfg in VGG_CONFIGS.items() if sum(c != "M" for c in cfg) == n_convs]
    if not types:
        raise ValueError(f"{tower}: {n_convs} VGG convs match no config of {sorted(VGG_CONFIGS)}")
    conv_map = vgg_conv_feature_indices(types[0], batch_norm)
    for key, value in sd.items():
        parts = key.split(".")
        leaf = parts[-1]
        if leaf == "num_batches_tracked":
            continue
        idx = int(parts[1])
        if parts[0] == "features" and idx in conv_map:
            _conv_to_jax(params, [tower, f"conv{conv_map[idx]}"], leaf, value)
        elif parts[0] == "features" and batch_norm and idx - 1 in conv_map:
            _bn_to_jax(params, stats, [tower, f"bn{conv_map[idx - 1]}"], leaf, value)
        elif parts[0] == "classifier" and idx in (0, 3):
            _set(params, [tower, "fc1" if idx == 0 else "fc2",
                          "kernel" if leaf == "weight" else "bias"],
                 value.T if leaf == "weight" else value)


def _tower_arch(tower_keys) -> str:
    """A tower's family from its state-dict keys (relative to the tower)."""
    rest = [k[len("model."):] for k in tower_keys if k.startswith("model.")]
    if any(k.startswith("features.") for k in rest):
        return "vgg"
    if rest:
        return "resnet"
    return "bninception"


def state_dict_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """The port's state dict -> Flax variables {"params", "batch_stats"} as
    numpy (inverse of :func:`jax_to_state_dict`; regenerated buffers are
    dropped)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in state_dict.items()}
    towers: Dict[str, Dict[str, np.ndarray]] = {}
    for key, value in sd.items():
        if key.startswith("Base_"):
            tower, _, rest = key.partition(".")
            towers.setdefault(tower, {})[rest] = value
    for tower, tower_sd in towers.items():
        arch = _tower_arch(tower_sd)
        if arch == "bninception":
            _bninception_to_jax(tower, tower_sd, params, stats)
        else:
            body = {k[len("model."):]: v for k, v in tower_sd.items()}
            (_vgg_to_jax if arch == "vgg" else _resnet_to_jax)(tower, body, params, stats)
    for key, value in sd.items():
        if key.startswith("Base_"):
            continue
        head, _, leaf = key.rpartition(".")
        if key.startswith("fusion.fusion_layer.0."):
            _set(params, ["fusion", "fc", "kernel" if leaf == "weight" else "bias"],
                 value.T if leaf == "weight" else value)
        elif key.startswith("classifier."):
            cls = head.split(".")[1]
            _set(params, ["classifier", cls, "kernel" if leaf == "weight" else "bias"],
                 value.T if leaf == "weight" else value)
        elif key in ("pe.1.weight", "pe.1.bias"):
            _set(params, ["pe", "conv", "kernel" if leaf == "weight" else "bias"],
                 value[..., 0].T if leaf == "weight" else value)
        elif key in ("pe.2.weight", "pe.2.bias"):
            _set(params, ["pe", "norm", "scale" if leaf == "weight" else "bias"], value)
        elif key.startswith("attention_layer.attention_layer."):
            if leaf in ("in_proj_weight", "in_proj_bias"):
                for proj, part in zip(_MHA_PROJ, np.split(value, 3, axis=0)):
                    _set(params, ["attention_layer", proj,
                                  "kernel" if leaf == "in_proj_weight" else "bias"],
                         part.T if leaf == "in_proj_weight" else part)
            else:
                _set(params, ["attention_layer", "out_proj",
                              "kernel" if leaf == "weight" else "bias"],
                     value.T if leaf == "weight" else value)
        elif key.startswith("attention_layer.seq."):
            fc = {"0": "fc1", "2": "fc2"}[head.split(".")[2]]
            _set(params, ["attention_layer", fc, "kernel" if leaf == "weight" else "bias"],
                 value.T if leaf == "weight" else value)
        # pe.0.pe, prototype_wts and num_batches_tracked are regenerated
    return {"params": params, "batch_stats": stats}


def kernel_keys(state_dict: Mapping[str, Any]) -> set:
    """The keys of ``state_dict`` that :func:`state_dict_to_jax` places
    under a ``kernel`` leaf: every conv and dense weight, the MHA's packed
    in-projection (the q, k and v kernels) and its out-projection; not the
    BatchNorm and GroupNorm affines, biases, statistics or buffers. Found
    by running the bridge on each key's index broadcast to its shape, so
    the rule is the bridge's own."""
    keys = list(state_dict)
    tagged = {k: np.broadcast_to(np.float64(i), tuple(state_dict[k].shape))
              for i, k in enumerate(keys)}
    found = set()

    def walk(node):
        for name, value in node.items():
            if isinstance(value, Mapping):
                walk(value)
            elif name == "kernel":
                found.add(keys[int(np.asarray(value).flat[0])])

    walk(state_dict_to_jax(tagged)["params"])
    return found


def quant_stats_to_jax(model: torch.nn.Module) -> Dict[str, Dict]:
    """The towers' recorded int8 amaxes -> the JAX package's ``quant_stats``
    tree, float32 scalars (empty before calibration)."""
    tree: Dict[str, Dict] = {}
    for name, tower in model.named_children():
        for site, amax in getattr(tower, "quant_stats", dict)().items():
            _set(tree, [name] + site.split("/"), np.asarray(amax.detach().cpu().numpy(),
                                                            dtype=np.float32))
    return tree


def load_quant_stats(model: torch.nn.Module, quant_stats: Mapping[str, Any]) -> None:
    """The JAX package's ``quant_stats`` tree -> the towers' int8 amaxes."""
    for tower, cells in quant_stats.items():
        for cell, leaves in cells.items():
            for leaf, value in leaves.items():
                getattr(model, tower).set_quant_stat(f"{cell}/{leaf}", np.asarray(value))


def conv3x3_weight_from_jax(kernel_hwio) -> np.ndarray:
    """An HWIO (3, 3, C_in, C_out) conv kernel -> (C_out, C_in, 3, 3), in
    its own type."""
    kernel = np.asarray(kernel_hwio)
    if kernel.ndim != 4 or kernel.shape[:2] != (3, 3):
        raise ValueError(f"kernel must be HWIO (3, 3, C_in, C_out), got {kernel.shape}")
    return np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1)))


def conv3x3_weight_to_jax(weight) -> np.ndarray:
    """The inverse of :func:`conv3x3_weight_from_jax`: (C_out, C_in, 3, 3)
    (numpy, or a tensor, taken as float32) -> HWIO (3, 3, C_in, C_out)."""
    if isinstance(weight, torch.Tensor):
        weight = weight.detach().cpu().float().numpy()
    weight = np.asarray(weight)
    if weight.ndim != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f"weight must be (C_out, C_in, 3, 3), got {weight.shape}")
    return np.ascontiguousarray(np.transpose(weight, (2, 3, 1, 0)))


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]) -> None:
    """Load Flax variables into a port model with ``strict=True``."""
    sd = jax_to_state_dict(variables, model.spec)
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                          strict=True)

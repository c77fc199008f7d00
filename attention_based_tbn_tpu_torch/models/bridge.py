"""Weight bridge between the JAX package's variables and the port.

The JAX package keeps its weights as Flax variables: nested dicts of arrays
under ``params`` and ``batch_stats`` (HWIO conv kernels, (in, out) dense
kernels). The port keeps the reference PyTorch state-dict layout, the one
the JAX package's ``models/convert_back.export_tbn_state_dict`` emits:
``Base_RGB.conv1_7x7_s2.weight``, ``Base_RGB.conv1_7x7_s2_bn.running_var``,
``pe.1.weight``, ``attention_layer.attention_layer.in_proj_weight``, ...

* :func:`jax_to_state_dict` — variables (numpy) -> state dict (numpy), for
  ``load_state_dict(strict=True)``; buffers the reference also stores (the
  PE table, the prototype curves, ``num_batches_tracked``) are regenerated.
* :func:`state_dict_to_jax` — the inverse, so that weights drawn by the
  port can be fed to the JAX package (the tests do).
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


def jax_to_state_dict(variables: Mapping[str, Any], spec) -> Dict[str, np.ndarray]:
    """Flax TBN variables -> the port's (reference-layout) state dict."""
    if spec.arch != "bninception":
        raise ValueError(f"arch {spec.arch!r} is not ported yet")
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    out: Dict[str, np.ndarray] = {}

    for tower, node in params.items():
        if not tower.startswith("Base_"):
            continue
        for name, sub in node.items():
            sub_stats = _get(stats, tower, name)
            if "conv" in sub:
                _emit_conv_bn(out, f"{tower}.{name}", sub, sub_stats)
            else:  # inception block: children are branch cells
                for branch, cell in sub.items():
                    _emit_conv_bn(out, f"{tower}.{name}_{branch}", cell,
                                  _get(sub_stats, branch))

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


def state_dict_to_jax(state_dict: Mapping[str, Any]) -> Dict[str, Dict]:
    """The port's state dict -> Flax variables {"params", "batch_stats"} as
    numpy (inverse of :func:`jax_to_state_dict`; regenerated buffers are
    dropped)."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    sd = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
          for k, v in state_dict.items()}
    for key, value in sd.items():
        head, _, leaf = key.rpartition(".")
        if key.startswith("Base_"):
            tower, _, name = head.partition(".")
            is_bn = name.endswith("_bn")
            cell = name[: -len("_bn")] if is_bn else name
            if cell.startswith("inception_"):
                block, branch = cell.split("_", 2)[1], cell.split("_", 2)[2]
                path = [tower, f"inception_{block}", branch]
            else:
                path = [tower, cell]
            if not is_bn:
                v = np.transpose(value, (2, 3, 1, 0)) if leaf == "weight" else value
                _set(params, path + ["conv", "kernel" if leaf == "weight" else "bias"], v)
            elif leaf in ("weight", "bias"):
                _set(params, path + ["bn", "scale" if leaf == "weight" else "bias"], value)
            elif leaf in ("running_mean", "running_var"):
                _set(stats, path + ["bn", "mean" if leaf == "running_mean" else "var"], value)
        elif key.startswith("fusion.fusion_layer.0."):
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

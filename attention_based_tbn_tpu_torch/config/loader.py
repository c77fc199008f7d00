"""Hydra-compatible config composition for the PyTorch port.

The port's own copy of the JAX package's ``config/loader.py``: config groups
composed by a defaults list, arbitrary dot-path CLI overrides
(``model.attention.type=mha``), group swaps (``data=tbn_data``) and a
managed run directory, on top of plain YAML. The defaults live in this
package (``config/defaults/``), with the same keys and values.

Public API:
    cfg = load_config(overrides=["train.batch_size=8"], config_dir=None)
    cfg.train.batch_size        # attribute access
    cfg["train"]["batch_size"]  # mapping access
    cfg.pretty()                # YAML dump
    make_run_dir(cfg)           # hydra-style run dir
"""

from __future__ import annotations

import ast
import copy
import datetime
import os
from typing import Any, Iterable, Mapping, Optional

import yaml

_DEFAULTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "defaults")


class ConfigNode(dict):
    """A dict with attribute access, recursive wrapping and YAML dumping."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        super().__init__()
        if data:
            for key, value in data.items():
                self[key] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ConfigNode):
            value = ConfigNode(value)
        super().__setitem__(key, value)

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo):
        return ConfigNode({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        out = {}
        for key, value in self.items():
            out[key] = value.to_dict() if isinstance(value, ConfigNode) else value
        return out

    def pretty(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=False, sort_keys=False)

    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], ConfigNode):
                node[part] = ConfigNode()
            node = node[part]
        node[parts[-1]] = value


def _parse_value(text: str) -> Any:
    """Parse a CLI override value the way OmegaConf would."""
    text = text.strip()
    lowered = text.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("null", "none", "~"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        pass
    try:
        # YAML handles scientific notation (1e-2) and flow lists ([20, 30]).
        # YAML 1.1 bool words (yes/no/on/off) coerce to bool here BY DESIGN:
        # OmegaConf 1.4's merge_with_dotlist yaml.loads override values with
        # a SafeLoader subclass that keeps those resolvers, so the reference
        # CLI surface (Hydra 0.11) behaves identically.
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _merge(base: ConfigNode, extra: Mapping[str, Any]) -> None:
    for key, value in extra.items():
        if (
            key in base
            and isinstance(base[key], Mapping)
            and isinstance(value, Mapping)
        ):
            _merge(base[key], value)
        else:
            base[key] = value


_SCI_RE = __import__("re").compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _normalize_scalars(node: Any) -> Any:
    """YAML 1.1 reads ``1e-2`` as a string; treat it as a float like OmegaConf."""
    if isinstance(node, dict):
        return {k: _normalize_scalars(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_normalize_scalars(v) for v in node]
    if isinstance(node, str) and _SCI_RE.match(node):
        return float(node)
    return node


def _load_yaml(path: str) -> dict:
    with open(path, "r") as handle:
        data = yaml.safe_load(handle)
    return _normalize_scalars(data or {})


def _find_group_file(config_dir: str, group: str, name: str) -> str:
    for ext in (".yaml", ".yml"):
        candidate = os.path.join(config_dir, group, name + ext)
        if os.path.isfile(candidate):
            return candidate
    raise FileNotFoundError(
        f"Config group file not found: group={group!r} name={name!r} under {config_dir}"
    )


def load_config(
    overrides: Optional[Iterable[str]] = None,
    config_dir: Optional[str] = None,
    config_name: str = "config",
) -> ConfigNode:
    """Compose the config from group defaults and apply CLI overrides.

    Overrides support two forms, exactly like hydra:
      * group swap:   ``data=my_data``  (picks <config_dir>/data/my_data.yaml)
      * value change: ``model.attention.type=proto``
    """
    search_dirs = []
    if config_dir:
        search_dirs.append(os.path.abspath(config_dir))
    search_dirs.append(_DEFAULTS_DIR)

    def find_root() -> str:
        for base in search_dirs:
            for ext in (".yaml", ".yml"):
                candidate = os.path.join(base, config_name + ext)
                if os.path.isfile(candidate):
                    return candidate
        raise FileNotFoundError(f"Root config {config_name!r} not found in {search_dirs}")

    root_raw = _load_yaml(find_root())
    defaults = root_raw.pop("defaults", [])

    # Group swaps can come from the CLI before composition.
    overrides = list(overrides or [])
    group_names = {}
    for item in defaults:
        if isinstance(item, Mapping):
            for group, name in item.items():
                group_names[str(group)] = str(name)

    value_overrides = []
    for entry in overrides:
        if "=" not in entry:
            raise ValueError(f"Override {entry!r} must be key=value")
        key, _, value = entry.partition("=")
        key = key.strip().lstrip("+")
        if key in group_names:
            group_names[key] = value.strip()
        else:
            value_overrides.append((key, value))

    cfg = ConfigNode()
    for group, name in group_names.items():
        found = None
        for base in search_dirs:
            try:
                found = _find_group_file(base, group, name)
                break
            except FileNotFoundError:
                continue
        if found is None:
            raise FileNotFoundError(f"No config file for group {group!r} name {name!r}")
        _merge(cfg, _load_yaml(found))

    _merge(cfg, root_raw)

    for key, value in value_overrides:
        cfg.set_path(key, _parse_value(value))

    return cfg


def make_run_dir(cfg: ConfigNode, now: Optional[datetime.datetime] = None) -> str:
    """Create the hydra-style run directory.

    Mirrors the reference layout (reference config/hydra/custom.yaml:2-3):
    ``${out_dir}/log/${exp_name}/run_<arch>_<dataset>_<date>_<time>``
    """
    now = now or datetime.datetime.now()
    run_name = "run_{}_{}_{}".format(
        cfg.model.arch, cfg.data.dataset, now.strftime("%Y-%m-%d_%H-%M-%S")
    )
    run_dir = os.path.join(cfg.out_dir, "log", cfg.exp_name, run_name)
    os.makedirs(run_dir, exist_ok=True)
    return run_dir

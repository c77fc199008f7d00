"""Device selection from the ``tpu.platform`` key, and the platform keys the
port accepts and does not need.

Port of the JAX package's ``utils/platform.py``. There, ``tpu.platform``
must reach JAX before it initializes, ``tpu.host_devices=N`` fakes N CPU
devices (an XLA flag) and ``tpu.compile_cache`` points XLA's persistent
compilation cache at a directory keyed by ``host_fingerprint()``. In the
port:

* ``tpu.platform`` picks the torch device (:func:`device_for`): "cpu", or
  CUDA for "" (the default), "gpu" or "cuda". ``main``, ``tools/export``,
  ``tools/serve`` and ``tools/vis`` read it; the two CLIs with a
  ``--device`` flag take either and refuse the two naming different
  devices (:func:`cli_device`).
* ``tpu.host_devices`` does nothing: the port's ranks are processes under
  ``torchrun`` (``parallel/mesh.py``), so there are no virtual devices to
  fake. A value above 0 logs one line saying so (:func:`note_unused_keys`)
  and is not refused, so command lines written for the JAX package run.
* ``tpu.compile_cache`` does nothing: the port compiles no XLA program. Its
  CUDA kernels (``ops/build.py``) and native IO library (``native/``) are
  built into git-ignored directories keyed by a digest of their sources and
  compiler flags, so a build of another host or source is never loaded.
  That key is why ``host_fingerprint`` and ``enable_compile_cache`` have no
  counterpart here.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch


def device_for(cfg) -> str:
    """"cpu" for ``tpu.platform=cpu``, "cuda" for "" (the default), "gpu"
    or "cuda"; other platforms are refused. The card of each rank is
    ``parallel/mesh.make_mesh``'s."""
    platform = str(cfg.get_path("tpu.platform", "") or "").lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("", "gpu", "cuda"):
        return "cuda"
    raise ValueError(f"tpu.platform={platform!r}: the port runs on 'cpu' or 'cuda'")


def cli_device(cfg, device: Optional[str] = None) -> str:
    """The device of a CLI with a ``--device`` flag: ``device`` when given,
    else :func:`device_for`'s. A ``device`` of another type than a
    ``tpu.platform`` the config sets is refused."""
    if device is None:
        return device_for(cfg)
    if str(cfg.get_path("tpu.platform", "") or ""):
        want = device_for(cfg)
        if torch.device(device).type != want:
            raise ValueError(f"--device {device} and tpu.platform="
                             f"{cfg.get_path('tpu.platform')} name different devices")
    return device


def note_unused_keys(cfg, logger: Optional[logging.Logger] = None) -> list:
    """Log one line for each of ``tpu.host_devices`` (above 0) and
    ``tpu.compile_cache`` (set) that the config sets: the port does nothing
    with them. Returns the lines."""
    logger = logger or logging.getLogger(__name__)
    lines = []
    host_devices = int(cfg.get_path("tpu.host_devices", 0) or 0)
    if host_devices > 0:
        lines.append(f"tpu.host_devices={host_devices} does nothing in the port: its ranks "
                     "are processes under torchrun (parallel/mesh.py)")
    cache = str(cfg.get_path("tpu.compile_cache", "") or "")
    if cache:
        lines.append(f"tpu.compile_cache={cache} does nothing in the port: it compiles no "
                     "XLA program; its kernel builds are keyed by their sources")
    for line in lines:
        logger.info(line)
    return lines

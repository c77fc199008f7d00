"""Command line of the port: the JAX package's ``main.py`` override surface.

    python -m attention_based_tbn_tpu_torch.main train.enable=true data_dir=/data/epic ...
    python -m attention_based_tbn_tpu_torch.main train.enable=false test.enable=true \\
        test.pre_trained=/path/weights.pth data_dir=/data/epic ...

Composes the config (``config/defaults`` of the port, same keys), makes
the hydra-style run dir ``<out_dir>/log/<exp_name>/run_...``, sets up the
run log and the TensorBoard writer, then trains (``train.enable``:
``tools/train.run_trainer``, checkpoints under
``<out_dir>/<model.checkpoint_dir>/<exp_name>/``) and evaluates
(``test.enable``: ``tools/test.run_tester`` on ``test.pre_trained``). The
device is CUDA unless ``tpu.platform=cpu`` asks for the CPU.

Several cards: one process per card under ``torchrun`` (``parallel/mesh``:
data parallelism with the JAX package's SPMD semantics; NCCL, or gloo where
ranks share a card or run on the CPU)::

    torchrun --nproc_per_node=N -m attention_based_tbn_tpu_torch.main train.enable=true ...

Rank 0 alone makes the run dir, writes the run log's file and the
TensorBoard scalars; the other ranks log warnings to the console.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from .config import load_config, make_run_dir
from .parallel.mesh import make_mesh, shutdown
from .utils.logging import setup_log
from .utils.misc import get_modality
from .utils.platform import device_for, note_unused_keys


def build_once_per_host(cfg, mesh) -> None:
    """With several ranks, the first rank of each host compiles what the
    run loads (the kernels on a card, the native IO library under
    ``tpu.native_io``) while the others wait, so no two ranks run the same
    compiler. One process builds at first use, as before."""
    if mesh.world == 1:
        return
    if mesh.local_rank == 0:
        if mesh.device.type == "cuda":
            from .ops import build

            build.build()
        if bool(cfg.get_path("tpu.native_io", True)):
            from . import native

            native.build()
    mesh.barrier()


def main(argv=None):
    """Returns run_tester's per-file results (None without test.enable)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    config_dir, overrides = None, []
    i = 0
    while i < len(argv):
        if argv[i] in ("--config-dir", "-cd"):
            if i + 1 >= len(argv):
                raise SystemExit(f"error: missing value for {argv[i]}")
            config_dir = argv[i + 1]
            i += 2
        else:
            overrides.append(argv[i])
            i += 1

    cfg = load_config(overrides=overrides, config_dir=config_dir)
    device = device_for(cfg)
    mesh = make_mesh(cfg, device)
    build_once_per_host(cfg, mesh)
    seed = int(cfg.data.manual_seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    modality = get_modality(cfg)
    run_dir = make_run_dir(cfg) if mesh.is_primary() else None
    cfg.run_dir = run_dir
    logger, writer = setup_log(modality, run_dir, primary=mesh.is_primary())
    logger.info("Initializing the pipeline...")
    logger.info(cfg.pretty())
    logger.info(f"Modality: {modality}")
    logger.info(f"Run dir: {run_dir}")
    logger.info(f"Device: {mesh.device}")
    note_unused_keys(cfg, logger)
    logger.info(mesh.describe())
    logger.info("-" * 58)

    results = None
    try:
        if cfg.train.enable:
            logger.info("Training the model.")
            from .tools.train import run_trainer

            run_trainer(cfg, logger, modality, writer, device=device)
        if cfg.test.enable:
            logger.info("Evaluating the model.")
            from .tools.test import run_tester

            results = run_tester(cfg, logger, modality, device=device)
    except Exception as exc:  # noqa: BLE001 — logged into the run dir, then raised
        logger.exception(exc)
        raise
    finally:
        if writer is not None:
            writer.close()
    return results


if __name__ == "__main__":
    try:
        main()
    finally:
        shutdown()

"""Run logging: a Python logger to the console and the run directory, and
a TensorBoard writer when tensorboardX imports.

Port of the JAX package's ``utils/logging.py``: ``setup_log`` (reference
core/utils/log.py: format ``%(levelname)s : %(asctime)s : %(message)s``,
console and file) and ``Plotter`` (reference core/utils/plot.py: scalars
and the config as text).
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional

_FORMAT = "%(levelname)s : %(asctime)s : %(message)s"


def setup_log(modality: List[str], run_dir: Optional[str] = None, primary: bool = True):
    """(logger, writer): the writer is a tensorboardX SummaryWriter into
    ``run_dir``, or None without tensorboardX or a run dir. A rank other
    than the primary (``primary=False``) logs warnings and errors only
    (``main`` gives it no run dir)."""
    name = "tbn_" + "_".join(modality)
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO if primary else logging.WARNING)
    logger.handlers.clear()
    logger.propagate = False  # no duplicate lines through the root logger
    formatter = logging.Formatter(_FORMAT)
    console = logging.StreamHandler()
    console.setFormatter(formatter)
    logger.addHandler(console)
    writer = None
    if run_dir:
        os.makedirs(run_dir, exist_ok=True)
        file_handler = logging.FileHandler(os.path.join(run_dir, f"{name}.log"))
        file_handler.setFormatter(formatter)
        logger.addHandler(file_handler)
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            SummaryWriter = None
        if SummaryWriter is not None:
            writer = SummaryWriter(logdir=run_dir)
    return logger, writer


class Plotter:
    """Scalars and a config dump to the TensorBoard writer of
    :func:`setup_log`; does nothing without one."""

    def __init__(self, writer):
        self.writer = writer

    def plot_scalar(self, scalar, epoch: int, out_name: str) -> None:
        if self.writer is not None and scalar is not None:
            self.writer.add_scalar(out_name, scalar, epoch)

    def add_config(self, cfg) -> None:
        if self.writer is not None:
            self.writer.add_text("config", cfg.pretty().replace("\n", "  \n"), 0)

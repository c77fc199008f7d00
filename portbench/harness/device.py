"""Device helpers that also run on the CPU, where the tests drive a cell at
a small size: synchronize, peak memory, the card's name, freeing the
program's memory, and the reference's exact float32 regime."""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, Iterable

import torch


def is_cuda(device) -> bool:
    return torch.device(device).type == "cuda"


def sync(device) -> None:
    if is_cuda(device):
        torch.cuda.synchronize()


def reset_peak(device) -> None:
    if is_cuda(device):
        torch.cuda.reset_peak_memory_stats()


def peak_bytes(device) -> int:
    return torch.cuda.max_memory_allocated() if is_cuda(device) else 0


def kind(device) -> str:
    return torch.cuda.get_device_name(torch.device(device)) if is_cuda(device) else "cpu"


def release(device) -> None:
    """Return the freed program's memory to the card before the reference
    runs beside nothing else."""
    gc.collect()
    if is_cuda(device):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


@contextlib.contextmanager
def exact_float32():
    """float32 products and convolutions without TF32 (cuDNN allows TF32 by
    default); the earlier setting restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Phases:
    """Seconds of each named stretch of the set-up, from ``started`` (the
    process's start, wall clock) on."""

    def __init__(self, started: float):
        self.last = started
        self.seconds: Dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.time()
        self.seconds[name] = now - self.last
        self.last = now


def build_kernels(device, names: Iterable[str]) -> None:
    """Build the cell's hand-written kernels now, all at once (the program
    builds each at its first launch, one after another). Nothing to build
    on the CPU, where the kernels' plain versions run."""
    names = list(names)
    if is_cuda(device) and names:
        from attention_based_tbn_tpu_torch.ops import build

        build.build(names)

"""Explicit device selection and the float32 precision regime.

Every entry point of the port takes a ``device`` and defaults to
``"cuda"``. Without a card it raises instead of running on the CPU; a
caller who wants the CPU (the tests) says ``device="cpu"``.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch device for ``device``; raises when it names CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev


@contextlib.contextmanager
def tf32_scope(compute_dtype: str):
    """TF32 for float32 matmuls and cuDNN convolutions inside the block,
    the process's earlier setting restored after it.

    Off for a float32 compute dtype: cuDNN convolutions default to TF32 on
    Hopper, which breaks float32 parity. On for bfloat16: there the towers,
    Fusion and the heads run in bf16, and the float32 products left are the
    spectrogram's (bf16-rounded operands, exact in TF32), the mel
    filterbank's, and the plain PE/MHA versions' weight products when the
    kernels are off, all of which then round their operands to TF32. The
    kernels' own products are float32 either way."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    allow = compute_dtype == "bfloat16"
    torch.backends.cuda.matmul.allow_tf32 = allow
    torch.backends.cudnn.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

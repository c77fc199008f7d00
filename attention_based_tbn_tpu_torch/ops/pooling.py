"""Pools of the BN-Inception towers, on NCHW tensors.

Port of the JAX package's ``ops/pooling.py``, which rebuilds torch's
``ceil_mode`` pooling on XLA: output size ``ceil((H + 2p - k) / s) + 1``,
minus a last window that would start inside the right padding; the
average divisor counts the explicit zero padding but never the extra ceil
padding. torch's own pools have exactly these semantics (the CPU tests hold
them against the JAX package, odd 210-wide audio maps included), so here
they are the torch calls, named for the JAX functions they replace.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool2d(x: torch.Tensor, kernel_size, stride, padding=0,
               ceil_mode: bool = False) -> torch.Tensor:
    """torch.nn.MaxPool2d on NCHW input."""
    return F.max_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode)


def avg_pool2d(x: torch.Tensor, kernel_size, stride, padding=0, ceil_mode: bool = False,
               count_include_pad: bool = True) -> torch.Tensor:
    """torch.nn.AvgPool2d on NCHW input; the divisor counts explicit padding
    (count_include_pad) but not the ceil-mode overhang."""
    return F.avg_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode,
                        count_include_pad=count_include_pad)


def global_avg_pool(x: torch.Tensor, freq_only: bool = False) -> torch.Tensor:
    """Tower head pool, accumulated in float32 whatever the compute dtype.

    NCHW (B, C, F, T) -> (B, C) by default; with ``freq_only`` (the audio
    tower under attention) only the frequency axis is pooled and the time
    axis kept, giving the sequence layout (B, T, C)."""
    xf = x.float()
    if freq_only:
        return xf.mean(dim=2).transpose(1, 2).to(x.dtype).contiguous()
    return xf.mean(dim=(2, 3)).to(x.dtype)

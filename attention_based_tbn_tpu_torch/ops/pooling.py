"""Pools of the BN-Inception towers, on NCHW tensors.

Port of the JAX package's ``ops/pooling.py``, which rebuilds torch's
``ceil_mode`` pooling on XLA: output size ``ceil((H + 2p - k) / s) + 1``,
minus a last window that would start inside the right padding; the
average divisor counts the explicit zero padding but never the extra ceil
padding. torch's own pools have exactly these semantics (the CPU tests hold
them against the JAX package, odd 210-wide audio maps included), so here
they are the torch calls, named for the JAX functions they replace.

``impl`` (``tpu.pool_impl``) picks the max pool's lowering as in the JAX
package: ``reduce_window`` and ``slices`` are two XLA lowerings of one
function and both are the plain torch pool here; ``pallas`` sends every
3x3 / stride-2 / pad-0 ceil-mode max pool of a CUDA tensor to the
hand-written kernel (``ops/kernels.ceil_max_pool2d``). The JAX gate
``pallas_pool.supported`` (bf16 only, even H, H*W >= 6000, W <= 128) is not
carried over: those limits came from Mosaic and from TPU timings, not from
the function, and max is exact, so taking every such pool changes no number.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels

POOL_IMPLS = ("reduce_window", "slices", "pallas")


def _pair(v):
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


def max_pool2d(x: torch.Tensor, kernel_size, stride, padding=0,
               ceil_mode: bool = False, impl: str = "reduce_window") -> torch.Tensor:
    """torch.nn.MaxPool2d on NCHW input; see the module docstring for
    ``impl``."""
    if (impl == "pallas" and x.device.type == "cuda" and ceil_mode
            and _pair(kernel_size) == (3, 3) and _pair(stride) == (2, 2)
            and _pair(padding) == (0, 0)):
        return kernels.ceil_max_pool2d(x)
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

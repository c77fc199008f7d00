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
That is the one place where the dispatch below differs from JAX's.

``fast_vjp`` (``tpu.pool_fast_vjp``) gives a floating-point max pool the
JAX package's ``_max_pool_fast_vjp`` gradient: on an exact tie every
maximal input of a window receives the window's gradient (torch's and the
kernel's backward give it to one). The forward is torch's pool either way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import kernels

POOL_IMPLS = ("reduce_window", "slices", "pallas")


def _pair(v):
    return (v, v) if isinstance(v, int) else (int(v[0]), int(v[1]))


class MaxPoolAllTies(torch.autograd.Function):
    """torch's max pool forward; the backward of the JAX package's
    ``_max_pool_fast_vjp`` (ops/pooling.py:96-186): each input equal to its
    window's max takes the window's gradient, summed in float32 over the
    window taps in row-major order (JAX's order for every input element)
    and rounded once to the input's type. The input is padded with -inf,
    which never equals a window's max, for the explicit and the ceil-mode
    padding."""

    @staticmethod
    def forward(ctx, x, kernel_size, stride, padding, ceil_mode):
        y = F.max_pool2d(x, kernel_size, stride, padding, ceil_mode=ceil_mode)
        ctx.save_for_backward(x, y)
        ctx.window = (_pair(kernel_size), _pair(stride), _pair(padding))
        return y

    @staticmethod
    def backward(ctx, grad):
        x, y = ctx.saved_tensors
        (kh, kw), (sh, sw), (ph, pw) = ctx.window
        h, w = x.shape[2:]
        oh, ow = y.shape[2:]
        hp, wp = max(h + 2 * ph, sh * (oh - 1) + kh), max(w + 2 * pw, sw * (ow - 1) + kw)
        xp = F.pad(x, (pw, wp - w - pw, ph, hp - h - ph), value=float("-inf"))
        acc = torch.zeros(xp.shape, device=x.device, dtype=torch.float32)
        g = grad.float()
        for dy in range(kh):
            for dx in range(kw):
                rows = slice(dy, dy + sh * (oh - 1) + 1, sh)
                cols = slice(dx, dx + sw * (ow - 1) + 1, sw)
                acc[:, :, rows, cols] += torch.where(xp[:, :, rows, cols] == y, g, 0.0)
        channels_last = x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
        fmt = torch.channels_last if channels_last else torch.contiguous_format
        dx = acc[:, :, ph:ph + h, pw:pw + w].to(x.dtype).contiguous(memory_format=fmt)
        return dx, None, None, None, None


def max_pool2d(x: torch.Tensor, kernel_size, stride, padding=0, ceil_mode: bool = False,
               impl: str = "reduce_window", fast_vjp: bool = False) -> torch.Tensor:
    """torch.nn.MaxPool2d on NCHW input; see the module docstring for
    ``impl`` and ``fast_vjp``. The order of the JAX dispatch: the kernel,
    then ``slices``, then ``fast_vjp``, then the default."""
    if (impl == "pallas" and x.device.type == "cuda" and ceil_mode
            and _pair(kernel_size) == (3, 3) and _pair(stride) == (2, 2)
            and _pair(padding) == (0, 0)):
        return kernels.ceil_max_pool2d(x)
    if (impl != "slices" and fast_vjp and x.is_floating_point() and torch.is_grad_enabled()
            and x.requires_grad):
        return MaxPoolAllTies.apply(x, kernel_size, stride, padding, ceil_mode)
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

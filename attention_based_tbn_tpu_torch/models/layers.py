"""Building blocks with the JAX package's numerics.

Port of the math of the JAX package's ``models/layers.py``: convolutions
with bias; BatchNorm on running statistics (eps 1e-5) folded into the
preceding convolution at eval (BN-Inception), or applied after it as a
per-channel affine (``conv_bn``: ResNet and VGG, as TorchBatchNorm does),
and with live batch statistics, pad-row masks and the running-stat update
in training (``batch_norm_train``);
Linear layers computed in the compute dtype; dropout from an explicit
generator; and the seeded initializers. Parameters stay float32 nn.Module parameters
in the reference PyTorch layout (OIHW convs, (out, in) linears); compute
casts them to the compute dtype, as the JAX package does.

The JAX package's TPU lowerings (the column-packed stem, FoldedConvBN with
merged 1x1 convolutions) are exact rewrites of the same math and are not
ported.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel import mesh
from ..utils.device import tracing

BN_EPSILON = 1e-5
BN_MOMENTUM = 0.1
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# Standard deviation of a unit normal truncated to [-2, 2]; flax's
# truncated_normal variance scaling divides by it.
_TRUNC_STD = 0.87962566103423978


def compute_dtype(name: str) -> torch.dtype:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {name!r} not in {sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


def fold_conv_bn(conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype,
                 bias_dtype: torch.dtype = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """BN(conv(x, W) + b) on running statistics == conv(x, W*s) + (b*s + o)
    with s = gamma / sqrt(var + eps), o = beta - mean*s; folded in float32,
    the kernel returned in ``dtype``, the bias in ``bias_dtype`` (default
    ``dtype``). The caller turns autograd off: toggling it here would put a
    grad-mode region per convolution into an exported graph, which
    ``torch.export`` then inlines one by one (minutes at this model's 70
    convolutions a tower)."""
    s = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    w = conv.weight * s[:, None, None, None]
    b = conv.bias * s + (bn.bias - bn.running_mean * s)
    return w.to(dtype), b.to(bias_dtype or dtype)


class FoldCache:
    """Folded (kernel, bias) per convolution, refolded whenever a source
    tensor changed: an in-place update (``load_state_dict``) bumps the
    tensor's version, a ``.to(device)`` swaps its storage. Saves the ~10
    small launches per convolution that folding costs on every forward.
    While the forward is traced (``utils.device.tracing``: an export) the
    fold is computed inline and kept nowhere, so it becomes part of the
    traced program."""

    def __init__(self):
        self._entries: Dict[str, tuple] = {}

    def get(self, name: str, conv: nn.Conv2d, bn: nn.BatchNorm2d, dtype: torch.dtype,
            bias_dtype: torch.dtype = None):
        if tracing():
            return fold_conv_bn(conv, bn, dtype, bias_dtype)
        sources = (conv.weight, conv.bias, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var)
        key = (dtype, bias_dtype) + tuple((t.data_ptr(), t._version) for t in sources)
        hit = self._entries.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key,) + fold_conv_bn(conv, bn, dtype, bias_dtype)
            self._entries[name] = hit
        return hit[1], hit[2]


class CastCache:
    """Parameters rounded to the compute dtype, as the JAX package's call
    sites round them (``.astype(self.dtype)``), recast whenever a source
    changed: an in-place update (``load_state_dict``, an optimizer step)
    bumps a tensor's version, a ``.to(device)`` swaps its storage. A cached
    forward launches no cast. While autograd records through a parameter
    (training), the casts are taken fresh: ``.to`` is differentiable, so the
    gradients reach the float32 parameters. At float32 the tensors pass
    through unchanged. While the forward is traced (an export) the casts
    are computed inline and kept nowhere."""

    def __init__(self):
        self._entries: Dict[str, tuple] = {}

    def get(self, name: str, tensors: Tuple[torch.Tensor, ...], dtype: torch.dtype):
        if all(t.dtype == dtype for t in tensors):
            return tuple(tensors)
        if tracing() or torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return tuple(t.to(dtype) for t in tensors)
        key = (dtype,) + tuple((t.data_ptr(), t._version) for t in tensors)
        hit = self._entries.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, tuple(t.to(dtype) for t in tensors))
            self._entries[name] = hit
        return hit[1]

    def derive(self, name: str, tensors: Tuple[torch.Tensor, ...], dtype: torch.dtype, fn):
        """``fn`` of the ``tensors`` rounded to ``dtype`` (a kernel's packed
        operands), computed without autograd once per version of the
        sources and cached under ``name``, so a cached forward launches no
        copy; computed inline while traced."""
        if tracing():
            return fn(*(t.to(dtype) for t in tensors))
        key = (dtype,) + tuple((t.data_ptr(), t._version) for t in tensors)
        hit = self._entries.get(name)
        if hit is None or hit[0] != key:
            with torch.no_grad():
                hit = (key, fn(*(t.to(dtype) for t in tensors)))
            self._entries[name] = hit
        return hit[1]


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm2d, mean_offset: torch.Tensor = None,
                     row_mask: torch.Tensor = None) -> torch.Tensor:
    """BatchNorm with live batch statistics over (N, H, W) of NCHW ``x``,
    the JAX package's TorchBatchNorm in training (layers.py:377-415).
    Returns float32.

    * single-pass moments in float32, var = E[x^2] - mean^2 clamped at 0;
    * normalizes with the biased variance; the running statistics take the
      unbiased one, ``(1 - m) * running + m * batch`` with m = 0.1, updated
      in place (no gradient);
    * ``mean_offset``: a per-channel constant the caller left out of x (the
      preceding convolution's bias, which cancels through live BN); only
      the running mean records it;
    * ``row_mask``: 0/1 per row of N; masked rows (a loader's pad rows) are
      left out of the statistics, and the count is the masked count.
      ``nn.BatchNorm2d`` has no row mask, hence this function;
    * several ranks (``parallel/mesh``): the statistics are the global
      batch's, as under the JAX package's SPMD: the masked sums of x and
      x^2 and the count, in float32, are summed over the ranks by a
      differentiable all-reduce (its backward sums their gradients), so
      every rank normalizes and updates its running statistics alike. A
      row mask on one process takes the same sums (the all-reduce is then
      the identity); one process without a mask takes plain means.
    """
    xf = x.float()
    axes = (0, 2, 3)
    if row_mask is None and mesh.world_size() == 1:
        mean = xf.mean(dim=axes)
        sq = xf.square().mean(dim=axes)
        n = x.shape[0] * x.shape[2] * x.shape[3]
        correction = n / max(n - 1, 1)
    else:
        hw = x.shape[2] * x.shape[3]
        if row_mask is None:
            s1, s2 = xf.sum(dim=axes), xf.square().sum(dim=axes)
            n = xf.new_full((1,), float(x.shape[0] * hw))
        else:
            w = row_mask.float().view(-1, 1, 1, 1)
            s1, s2 = (xf * w).sum(dim=axes), (xf.square() * w).sum(dim=axes)
            n = (row_mask.float().sum() * hw).view(1)
        c = s1.shape[0]
        total = mesh.all_reduce_sum(torch.cat([s1, s2, n]))
        count = total[2 * c].clamp_min(1.0)
        mean, sq = total[:c] / count, total[c:2 * c] / count
        correction = count / (count - 1.0).clamp_min(1.0)
    var = (sq - mean.square()).clamp_min(0.0)
    with torch.no_grad():
        recorded = mean if mean_offset is None else mean + mean_offset
        bn.running_mean.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * recorded)
        bn.running_var.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * correction)
    inv = torch.rsqrt(var + bn.eps) * bn.weight
    return (xf - mean.view(1, -1, 1, 1)) * inv.view(1, -1, 1, 1) + bn.bias.view(1, -1, 1, 1)


def bn_eval_affine(mean: torch.Tensor, var: torch.Tensor, gamma: torch.Tensor,
                   beta: torch.Tensor, eps: float, dtype: torch.dtype
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """BatchNorm on running statistics as a per-channel (scale, offset),
    the JAX package's TorchBatchNorm at eval (layers.py:364-375): scale =
    rsqrt(var + eps) * gamma and offset = beta - mean * scale in float32,
    each rounded to ``dtype``."""
    scale = torch.rsqrt(var + eps) * gamma
    return scale.to(dtype), (beta - mean * scale).to(dtype)


def conv_bn(x: torch.Tensor, conv: nn.Conv2d, bn, cache: CastCache, name: str,
            row_mask: torch.Tensor = None) -> torch.Tensor:
    """Conv -> BatchNorm of the ResNet and VGG towers (no activation), in
    x's dtype, unfolded as the JAX package computes them (only BN-Inception
    folds; folding here would round the kernel, not the output, at bf16):

    * the convolution in x's dtype; its bias, where it has one (VGG), added
      after the product's rounding, as TorchConv adds it;
    * eval: ``y * scale + offset`` with :func:`bn_eval_affine`'s pair,
      cached per version of the statistics, rounded once (``addcmul``);
    * training (``bn.training``): live float32 statistics
      (:func:`batch_norm_train`, pad rows masked by ``row_mask``), the
      output rounded to x's dtype;
    * ``bn`` None: the convolution alone (VGG without BatchNorm).

    ``cache`` holds the parameters rounded to x's dtype (``name`` keys
    them)."""
    dtype = x.dtype
    sources = (conv.weight,) if conv.bias is None else (conv.weight, conv.bias)
    params = cache.get(name, sources, dtype)
    y = F.conv2d(x, params[0], None, conv.stride, conv.padding)
    if conv.bias is not None:
        y = y + params[1].view(1, -1, 1, 1)
    if bn is None:
        return y
    if bn.training:
        return batch_norm_train(y, bn, None, row_mask).to(dtype)
    scale, offset = cache.derive(
        f"{name}/bn/{dtype}", (bn.running_mean, bn.running_var, bn.weight, bn.bias),
        torch.float32, lambda m, v, g, b: bn_eval_affine(m, v, g, b, bn.eps, dtype))
    return torch.addcmul(offset.view(1, -1, 1, 1), y, scale.view(1, -1, 1, 1))


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with the noise drawn from ``generator`` (flax
    ``nn.Dropout``: keep with probability 1 - rate, scale kept values by
    1 / (1 - rate)); rows lead ``x``."""
    if rate <= 0.0:
        return x
    if rate >= 1.0:
        return torch.zeros_like(x)
    # the global batch's draw, this rank's rows kept (parallel/mesh)
    keep = mesh.global_noise(
        x.shape, lambda shape: torch.rand(shape, generator=generator, device=x.device)) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """nn.Linear computed in ``dtype`` as the JAX package's TorchLinear: the
    product rounded to ``dtype``, then the sum with the rounded bias rounded
    again (``F.linear`` with a bias rounds once, which differs at bf16)."""
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


@torch.no_grad()
def variance_scaling_(weight: torch.Tensor, scale: float, mode: str,
                      generator: torch.Generator) -> None:
    """flax ``variance_scaling(scale, mode, "truncated_normal")`` on a torch-
    layout weight ((out, in, *kernel) or (out, in))."""
    receptive = math.prod(weight.shape[2:]) if weight.dim() > 2 else 1
    fan = weight.shape[0 if mode == "fan_out" else 1] * receptive
    std = math.sqrt(scale / fan) / _TRUNC_STD
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense kernel init."""
    variance_scaling_(weight, 1.0, "fan_in", generator)


@torch.no_grad()
def normal_init_(weight: torch.Tensor, std: float, generator: torch.Generator) -> None:
    """N(0, std) — the reference's head init (heads.py normal_init)."""
    weight.normal_(0.0, std, generator=generator)


@torch.no_grad()
def reset_linear_(layer: nn.Linear, generator: torch.Generator,
                  std: float = None) -> None:
    """Lecun-normal kernel (or N(0, std) when given) and a zero bias."""
    if std is None:
        lecun_normal_(layer.weight, generator)
    else:
        normal_init_(layer.weight, std, generator)
    layer.bias.zero_()

"""The port's hand-written kernels, each beside its plain PyTorch version.

* ``pe_block`` — concat PE -> 1x1 conv -> GroupNorm on (B, S, C) in one
  pass (csrc/pe_block.cu; replaces the JAX package's
  ``ops/pallas_kernels.py:pe_block_pallas``); at bf16 ``pe_block_bf16``,
  on the tensor cores, from the split operands of ``pe_block_split``.
* ``mha`` — single-query multi-head attention with key == value, returning
  the output and the head-averaged weights (csrc/mha.cu; replaces
  ``ops/pallas_kernels.py:mha_pallas``).
* ``ceil_max_pool2d`` — the towers' 3x3 / stride-2 / pad-0 ceil-mode max
  pool on NCHW or channels-last input (csrc/max_pool.cu; replaces
  ``ops/pallas_pool.py:ceil_max_pool2d_pallas``), differentiable: the
  forward records each window's winning tap, and a second kernel gathers
  the gradient from them.
* ``fused_stem`` — the eval stem of a 7x7 tower: normalize -> 7x7/2 conv
  with BatchNorm folded in -> + float32 bias -> ReLU -> 3x3/2 ceil max pool
  (csrc/fused_stem.cu; replaces ``ops/fused_stem.py:fused_stem_pallas``).
* ``consensus_heads`` — the segment mean of (B, N, F) features and every
  classifier head on it, float32 logits (csrc/consensus_heads.cu; replaces
  ``ops/pallas_kernels.py:consensus_heads_pallas``).
* ``conv3x3`` — the fused-block probe's 3x3 / stride-1 / pad-1 conv + fp32
  bias + ReLU on NHWC input (csrc/conv3x3.cu; replaces
  ``benchmarks/fused_block_probe.py:conv3x3_pallas``); at bf16 on the tensor
  cores from :func:`pack_conv3x3_weight`'s operand, by one of two routes
  (:func:`conv3x3_route`).
* ``quantize`` and ``qconv`` — the int8 compute path of BN-Inception's
  towers (``tpu.quantize=int8``): an activation quantized to int8 NHWC
  with its calibrated scale, then the s8 x s8 -> s32 convolution on the
  int8 tensor cores with the dequantize, ReLU and rounding in its epilogue
  (csrc/qconv.cu; replaces XLA's s8 convolution of the JAX package's
  ``models/layers.py:conv2d_apply_q``, not a ``pallas_call``).

Dispatch rule of every wrapper: a tensor on the CPU takes the plain version
(``*_plain``); a CUDA tensor goes to the kernel's ``torch.library`` op
(``tbn::<name>``), which launches the kernel or raises when the kernel
cannot take it. Nothing falls back silently. The op is opaque to
``torch.export``: an exported program holds it as one node, and its real
implementation (the launch) runs when the program runs, so the eager model
and an exported one go through the same code. Everything that needs real
data (pointers, their alignment, the operand caches) and the launch
counters live in the real implementations; each op's fake implementation
checks what the shapes alone decide and gives the outputs' shapes. Each
wrapper counts its launches in ``<wrapper>.launches`` (one per launch that
reached the card; a trace counts none), so a run can show that it went
through the kernels.

Activations are fp32 or bf16, and so are the parameters of ``pe_block``,
``mha`` and ``consensus_heads``: in the activations' type, in torch layout
((out, in) matrices). At bf16 the model hands them rounded once, as the
JAX package's call sites round theirs (``models/layers.CastCache``); the
kernels and the plain versions widen them to fp32 and compute in fp32.
``fused_stem`` and ``conv3x3`` take their weight in the compute type and
their bias in fp32 (``conv3x3`` widens its own; ``fused_stem`` also takes
its input affine in fp32). The plain versions return what the kernels return.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_BF16 = torch.bfloat16
# C signatures of csrc/*.cu's exported functions: (restype, argtypes).
_SIGNATURES = {
    "pe_block": {
        "pe_block_forward": (
            _I, [_I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
        ),
        "pe_block_forward_bf16": (_I, [_I] + [_P] * 6 + [_I] * 5 + [_F, _P]),
        "pe_block_bf16_grid": (_I, [_I, _I, _I, _I, _P]),
        "pe_block_limits": (_I, [_I, _P]),
        "pe_block_error_string": (ctypes.c_char_p, [_I]),
    },
    "mha": {
        "mha_forward": (_I, [_I, _I] + [_P] * 11 + [_I, _I, _I, _I, _P]),
        "mha_max_heads": (_I, []),
        "mha_max_seq": (_I, []),
        "mha_bf16_tile": (_I, []),
        "mha_wgmma_probe": (_I, [_I, _I, _P, _P, _P, _P]),
        "mha_error_string": (ctypes.c_char_p, [_I]),
    },
    "max_pool": {
        "max_pool_forward": (_I, [_I, _I, _P, _P, _P] + [_I] * 7 + [_P]),
        "max_pool_backward": (_I, [_I, _I, _P, _P, _P] + [_I] * 7 + [_P]),
        "max_pool_error_string": (ctypes.c_char_p, [_I]),
    },
    "fused_stem": {
        "fused_stem_forward": (_I, [_I, _I, _I] + [_P] * 6 + [_I] * 4 + [_P]),
        "fused_stem_error_string": (ctypes.c_char_p, [_I]),
    },
    "consensus_heads": {
        "consensus_heads_forward": (_I, [_I, _I] + [_P] * 5 + [_I] * 4 + [_P]),
        "consensus_heads_max_features": (_I, []),
        "consensus_heads_max_heads": (_I, []),
        "consensus_heads_cluster": (_I, []),
        "consensus_heads_error_string": (ctypes.c_char_p, [_I]),
    },
    "conv3x3": {
        "conv3x3_forward": (_I, [_I, _I] + [_P] * 4 + [_I] * 5 + [_P]),
        "conv3x3_limits": (_I, [_I, _P]),
        "conv3x3_route": (_I, [_I, _I, _I, _P]),
        "conv3x3_wgmma_rs_probe": (_I, [_I, _P, _P, _P, _P]),
        "conv3x3_error_string": (ctypes.c_char_p, [_I]),
    },
    "qconv": {
        "quantize_forward": (_I, [_I, _I, _P, _P, _P, _I, _I, _I, _I, ctypes.c_longlong,
                                  ctypes.c_longlong, _P]),
        "qconv_forward": (_I, [_I] + [_P] * 4 + [_I] * 12 + [_P, _I, _P, _P]),
        "qconv_wgmma_probe": (_I, [_I, _I, _P, _P, _P, _P]),
        "qconv_resident_b_limit": (_I, []),
        "qconv_error_string": (ctypes.c_char_p, [_I]),
    },
}
_STEM_INPUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_MAX_GRID_Y = 65535  # the kernels put the batch on the grid's y axis
_MAX_GRID_Z = 65535  # quantize puts it on the z axis
_GROUP_CHANNELS = (4, 8, 16, 32, 64)  # channels per group the kernel handles


# --------------------------------------------------------------- PE block


def _group_norm(h, gn_scale, gn_bias, num_groups: int, eps: float, dtype,
                single_pass: bool):
    """GroupNorm of float32 ``h`` (B, S, C) over S x C / num_groups per
    sample and group, then the affine, rounded to ``dtype``. The variance
    is two-pass (``pe_block_reference``), or with ``single_pass`` the
    Pallas kernel's (pallas_kernels.py:92-117): sums times 1 / n,
    E[h^2] - mean^2 clamped at 0."""
    b, s, _ = h.shape
    grouped = h.view(b, s, num_groups, -1)
    if single_pass:
        inv_n = 1.0 / (s * grouped.shape[-1])
        mean = grouped.sum(dim=(1, 3), keepdim=True) * inv_n
        sq = (grouped * grouped).sum(dim=(1, 3), keepdim=True) * inv_n
        var = (sq - mean * mean).clamp_min(0)
    else:
        mean = grouped.mean(dim=(1, 3), keepdim=True)
        var = (grouped - mean).square().mean(dim=(1, 3), keepdim=True)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).view(b, s, -1)
    return (normed * gn_scale.float() + gn_bias.float()).to(dtype)


def pe_block_plain(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
                   num_groups: int = 64, eps: float = 1e-5):
    """(B, S, C_in) -> (B, S, C_out): concat the (S, D) PE table, 1x1 conv
    with ``conv_weight`` (C_out, C_in + D), GroupNorm(num_groups) with a
    two-pass variance. Mirrors ``pe_block_reference`` of the JAX package."""
    b, s, _ = x.shape
    pe = pe_table.float()[None].expand(b, s, pe_table.shape[1])
    h = torch.cat([x.float(), pe], dim=-1) @ conv_weight.float().T + conv_bias.float()
    return _group_norm(h, gn_scale, gn_bias, num_groups, eps, x.dtype, single_pass=False)


def pe_block_split(pe_table, conv_weight, conv_bias):
    """The bf16 kernel's operands from the conv's parameters: W's x columns
    as a contiguous (C_out, C_in) tensor in W's type, and the batch-invariant
    (S, C_out) float32 term PE @ W_pe^T + b, as the TPU wrapper splits
    ``[x | PE] @ W + b`` (pallas_kernels.py:82-90; exact float32 products).
    The model caches the pair per parameter version
    (``layers.CastCache.derive``), so a served request makes no copy."""
    d = pe_table.shape[1]
    c_in = conv_weight.shape[1] - d
    w_pe = conv_weight[:, c_in:].float()
    pe_bias = (pe_table.float()[:, None, :] * w_pe[None]).sum(dim=-1) + conv_bias.float()
    return conv_weight[:, :c_in].contiguous(), pe_bias.contiguous()


def pe_block_split_plain(x, split, gn_scale, gn_bias, num_groups: int = 64,
                         eps: float = 1e-5):
    """:func:`pe_block_bf16`'s plain version, from :func:`pe_block_split`'s
    ``(w_x, pe_bias)``: h = x @ w_x^T + pe_bias in float32, GroupNorm with
    single-pass statistics, rounded to x's type: the Pallas kernel's order
    (pallas_kernels.py:92-117)."""
    w_x, pe_bias = split
    h = x.float() @ w_x.float().T + pe_bias
    return _group_norm(h, gn_scale, gn_bias, num_groups, eps, x.dtype, single_pass=True)


# Each route's (longest sequence, multiple of C_out, multiple of C_in): the
# rows and channels of a block (pe_block.cu). The library reports the same
# through pe_block_limits (:func:`pe_block_library_limits`).
PE_BLOCK_LIMITS = {torch.float32: (16, 64, 1), torch.bfloat16: (64, 64, 64)}


def _pe_block_limits_error(x, c_out: int, gn_scale, gn_bias, num_groups: int) -> str:
    """What both routes refuse ("" when nothing): x's shape, type and
    contiguity, the route's limits, 4 to 64 channels per group, the
    GroupNorm affine's shape."""
    if x.dim() != 3:
        return f"x must be (B, S, C_in), got {tuple(x.shape)}"
    if x.dtype not in PE_BLOCK_LIMITS:
        return f"dtype {x.dtype} not in {list(PE_BLOCK_LIMITS)}"
    b, s, c_in = x.shape
    max_seq, c_out_tile, c_in_tile = PE_BLOCK_LIMITS[x.dtype]
    if not 1 <= s <= max_seq:
        return f"sequence {s} outside [1, {max_seq}] at {x.dtype}"
    if c_in % c_in_tile:
        return f"C_in {c_in} must be a multiple of {c_in_tile} at {x.dtype}"
    if b < 1 or c_out % c_out_tile or c_out % num_groups:
        return f"C_out {c_out} must be a multiple of {c_out_tile} and of {num_groups} groups"
    if c_out // num_groups not in _GROUP_CHANNELS:
        return f"{c_out // num_groups} channels per group; the kernel takes {_GROUP_CHANNELS}"
    for name, t in (("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        if tuple(t.shape) != (c_out,):
            return f"{name} {tuple(t.shape)} != ({c_out},)"
    if not x.is_contiguous():
        return "activations must be contiguous"
    return ""


def pe_block_shape_error(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
                         num_groups: int) -> str:
    """Why :func:`pe_block`'s kernel cannot take these arguments ("" when
    it can), checked without a card: float32 activations (bf16 ones go
    through :func:`pe_block_bf16`), the conv's and the table's shapes, and
    the limits of ``PE_BLOCK_LIMITS``."""
    if x.dtype == _BF16:
        return "at bf16 the kernel takes the split operands: call pe_block_bf16"
    c_out = conv_weight.shape[0]
    if x.dim() == 3:
        s, c_in = x.shape[1:]
        d = pe_table.shape[-1]
        if tuple(conv_weight.shape) != (c_out, c_in + d):
            return f"conv_weight {tuple(conv_weight.shape)} != ({c_out}, {c_in + d})"
        if tuple(pe_table.shape) != (s, d):
            return f"pe_table {tuple(pe_table.shape)} != ({s}, {d})"
        if tuple(conv_bias.shape) != (c_out,):
            return f"conv_bias {tuple(conv_bias.shape)} != ({c_out},)"
    return _pe_block_limits_error(x, c_out, gn_scale, gn_bias, num_groups)


def _pe_block_bf16_operands_error(x, split, gn_scale, gn_bias, num_groups: int) -> str:
    """:func:`pe_block_bf16_shape_error` without the alignment, which needs
    real data (the op's fake implementation checks this much)."""
    if x.dtype != _BF16:
        return f"the wgmma route takes bf16 activations, got {x.dtype}: call pe_block"
    w_x, pe_bias = split
    c_out = w_x.shape[0]
    problem = _pe_block_limits_error(x, c_out, gn_scale, gn_bias, num_groups)
    if problem:
        return problem
    s, c_in = x.shape[1:]
    if tuple(w_x.shape) != (c_out, c_in) or w_x.dtype != _BF16 or not w_x.is_contiguous():
        return f"split weight must be contiguous ({c_out}, {c_in}) bf16"
    if tuple(pe_bias.shape) != (s, c_out) or pe_bias.dtype != torch.float32 or (
            not pe_bias.is_contiguous()):
        return f"split PE bias must be contiguous ({s}, {c_out}) float32"
    return ""


def pe_block_bf16_shape_error(x, split, gn_scale, gn_bias, num_groups: int) -> str:
    """Why :func:`pe_block_bf16`'s kernel cannot take these arguments (""
    when it can), checked without a card: bf16 activations, the limits of
    ``PE_BLOCK_LIMITS``, and :func:`pe_block_split`'s operands, contiguous
    and 16-byte aligned."""
    problem = _pe_block_bf16_operands_error(x, split, gn_scale, gn_bias, num_groups)
    if not problem and (x.data_ptr() % 16 or split[0].data_ptr() % 16):
        return "x and the split weight must start on 16 bytes"
    return problem


def pe_block(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
             num_groups: int = 64, eps: float = 1e-5):
    """:func:`pe_block_plain` on the CPU; on the card the fp32-core kernel
    (op ``tbn::pe_block``), float32 only (the bf16 kernel is
    :func:`pe_block_bf16`)."""
    if x.device.type == "cpu":
        return pe_block_plain(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
                              num_groups, eps)
    _require_cuda(x)
    return _pe_block_op(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias, num_groups,
                        eps)


@torch.library.custom_op("tbn::pe_block", mutates_args=(), device_types="cuda")
def _pe_block_op(x: torch.Tensor, pe_table: torch.Tensor, conv_weight: torch.Tensor,
                 conv_bias: torch.Tensor, gn_scale: torch.Tensor, gn_bias: torch.Tensor,
                 num_groups: int, eps: float) -> torch.Tensor:
    problem = pe_block_shape_error(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
                                   num_groups)
    if problem:
        raise ValueError(f"pe_block: {problem}")
    for name, t in (("conv_weight", conv_weight), ("conv_bias", conv_bias),
                    ("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        _check_param("pe_block", name, t, x.device, x.dtype)
    # The kernel reads the table through its strides (the model passes a
    # transposed view of its buffer), so it need not be contiguous.
    if pe_table.device != x.device or pe_table.dtype != x.dtype:
        raise ValueError(f"pe_block: pe_table must be {x.dtype} on {x.device}")
    b, s, c_in = x.shape
    c_out, d = conv_weight.shape[0], pe_table.shape[-1]
    lib = _library("pe_block")
    out = torch.empty_like(x)
    err = lib.pe_block_forward(
        x.device.index or 0, _ptr(x), _ptr(pe_table), pe_table.stride(0),
        pe_table.stride(1), _ptr(conv_weight), _ptr(conv_bias), _ptr(gn_scale),
        _ptr(gn_bias), _ptr(out), b, s, c_in, d, c_out, num_groups, eps, _stream(x))
    _raise_on_error("pe_block", lib.pe_block_error_string, err)
    pe_block.launches += 1
    return out


@_pe_block_op.register_fake
def _(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias, num_groups, eps):
    _raise_if("pe_block", pe_block_shape_error(x, pe_table, conv_weight, conv_bias, gn_scale,
                                               gn_bias, num_groups))
    return torch.empty_like(x)


pe_block.launches = 0  # launches of either route (pe_block and pe_block_bf16)


def pe_block_bf16(x, split, gn_scale, gn_bias, num_groups: int = 64, eps: float = 1e-5):
    """:func:`pe_block_split_plain` on the CPU; on the card the wgmma
    kernel (op ``tbn::pe_block_bf16``). ``split`` is :func:`pe_block_split`
    of the table, conv weight and bias rounded to bf16; ``gn_scale`` and
    ``gn_bias`` are bf16. Its launches count in ``pe_block.launches``."""
    if x.device.type == "cpu":
        return pe_block_split_plain(x, split, gn_scale, gn_bias, num_groups, eps)
    _require_cuda(x)
    w_x, pe_bias = split
    return _pe_block_bf16_op(x, w_x, pe_bias, gn_scale, gn_bias, num_groups, eps)


@torch.library.custom_op("tbn::pe_block_bf16", mutates_args=(), device_types="cuda")
def _pe_block_bf16_op(x: torch.Tensor, w_x: torch.Tensor, pe_bias: torch.Tensor,
                      gn_scale: torch.Tensor, gn_bias: torch.Tensor, num_groups: int,
                      eps: float) -> torch.Tensor:
    problem = pe_block_bf16_shape_error(x, (w_x, pe_bias), gn_scale, gn_bias, num_groups)
    if problem:
        raise ValueError(f"pe_block_bf16: {problem}")
    for name, t in (("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        _check_param("pe_block_bf16", name, t, x.device, _BF16)
    if w_x.device != x.device or pe_bias.device != x.device:
        raise ValueError(f"pe_block_bf16: split operands must be on {x.device}")
    b, s, c_in = x.shape
    lib = _library("pe_block")
    out = torch.empty_like(x)
    err = lib.pe_block_forward_bf16(
        x.device.index or 0, _ptr(x), _ptr(w_x), _ptr(pe_bias), _ptr(gn_scale),
        _ptr(gn_bias), _ptr(out), b, s, c_in, w_x.shape[0], num_groups, eps, _stream(x))
    _raise_on_error("pe_block_bf16", lib.pe_block_error_string, err)
    pe_block.launches += 1
    return out


@_pe_block_bf16_op.register_fake
def _(x, w_x, pe_bias, gn_scale, gn_bias, num_groups, eps):
    _raise_if("pe_block_bf16", _pe_block_bf16_operands_error(x, (w_x, pe_bias), gn_scale,
                                                             gn_bias, num_groups))
    return torch.empty_like(x)


def pe_block_grid(b: int, s: int, c_out: int, device=0):
    """The bf16 kernel's launch on ``device`` for (B, S, C_out), from the
    library: (row tiles, channel tiles, warpgroups per block)."""
    grid = (ctypes.c_int * 3)()
    lib = _library("pe_block")
    _raise_on_error("pe_block", lib.pe_block_error_string,
                    lib.pe_block_bf16_grid(device, b, s, c_out, grid))
    return tuple(grid)


def pe_block_library_limits(dtype):
    """``PE_BLOCK_LIMITS[dtype]`` as the built library states it."""
    limits = (ctypes.c_int * 3)()
    lib = _library("pe_block")
    _raise_on_error("pe_block", lib.pe_block_error_string,
                    lib.pe_block_limits(_DTYPE_CODES[dtype], limits))
    return tuple(limits)


# -------------------------------------------------------------------- MHA


def mha_plain(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight,
              out_proj_bias, num_heads: int, drop=None):
    """Single-query MHA, (B, E) x (B, S, E) -> ((B, E), (B, S) head-averaged
    weights). ``in_proj_weight`` packs [Wq; Wk; Wv] like torch's
    MultiheadAttention. Mirrors ``mha_reference`` of the JAX package, in
    the Pallas kernel's arithmetic: parameters widened to fp32, q, k and v
    in fp32, logits scaled after the dot product.

    ``drop`` (training only; the kernel has none): a function applied to the
    (B, H, S) attention probabilities before the weighted sum, i.e. dropout;
    the returned weights are then the dropped ones, as torch's
    MultiheadAttention and the JAX package return them."""
    b, s, e = keyval.shape
    hd = e // num_heads
    wq, wk, wv = in_proj_weight.float().chunk(3)
    bq, bk, bv = in_proj_bias.float().chunk(3)
    kv = keyval.float()
    q = (query.float() @ wq.T + bq).view(b, num_heads, hd)
    k = (kv @ wk.T + bk).view(b, s, num_heads, hd)
    v = (kv @ wv.T + bv).view(b, s, num_heads, hd)
    # scaled after the dot product, as the Pallas kernel and the CUDA one
    logits = torch.einsum("bhd,bshd->bhs", q, k) * (1.0 / math.sqrt(hd))
    probs = torch.softmax(logits, dim=-1)
    if drop is not None:
        probs = drop(probs)
    out = torch.einsum("bhs,bshd->bhd", probs, v).reshape(b, e)
    out = out @ out_proj_weight.float().T + out_proj_bias.float()
    return out.to(query.dtype), probs.mean(dim=1).to(query.dtype)


def mha(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight, out_proj_bias,
        num_heads: int):
    """:func:`mha_plain` on the CPU; the CUDA kernels on the card (op
    ``tbn::mha``)."""
    if query.device.type == "cpu":
        return mha_plain(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight,
                         out_proj_bias, num_heads)
    _require_cuda(query)
    return _mha_op(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight,
                   out_proj_bias, num_heads)


def _mha_shape_error(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight,
                     out_proj_bias, num_heads: int, max_heads: int, max_seq: int,
                     bf16_tile: int) -> str:
    """Why the kernel cannot take these arguments ("" when it can), against
    the library's limits."""
    if keyval.dim() != 3 or query.dim() != 2:
        return (f"query (B, E) and keyval (B, S, E) expected, got {tuple(query.shape)} and "
                f"{tuple(keyval.shape)}")
    b, s, e = keyval.shape
    if tuple(query.shape) != (b, e):
        return f"query {tuple(query.shape)} != ({b}, {e})"
    if not 1 <= num_heads <= max_heads or e % num_heads:
        return f"{num_heads} heads do not divide E={e} (max {max_heads})"
    if not 1 <= s <= max_seq:
        return f"sequence {s} outside [1, {max_seq}]"
    for t in (query, keyval):
        if t.dtype not in _DTYPE_CODES:
            return f"dtype {t.dtype} not in {list(_DTYPE_CODES)}"
        if not t.is_contiguous():
            return "activations must be contiguous"
    if keyval.dtype != query.dtype or keyval.device != query.device:
        return "query and keyval must share dtype and device"
    shapes = {
        "in_proj_weight": (in_proj_weight, (3 * e, e)),
        "in_proj_bias": (in_proj_bias, (3 * e,)),
        "out_proj_weight": (out_proj_weight, (e, e)),
        "out_proj_bias": (out_proj_bias, (e,)),
    }
    for name, (t, shape) in shapes.items():
        if t.device != query.device or t.dtype != query.dtype or not t.is_contiguous():
            return f"{name} must be contiguous {query.dtype} on {query.device}"
        if tuple(t.shape) != shape:
            return f"{name} {tuple(t.shape)} != {shape}"
    if query.dtype == _BF16 and e % bf16_tile:
        return f"the bf16 route needs E % {bf16_tile} == 0, got {e}"
    return ""


# The library's limits (mha_max_heads, mha_max_seq, mha_bf16_tile), for the
# op's fake implementation, which runs without the library; the smoke holds
# them against the built library (env phase).
MHA_LIMITS = (16, 64, 64)


@torch.library.custom_op("tbn::mha", mutates_args=(), device_types="cuda")
def _mha_op(query: torch.Tensor, keyval: torch.Tensor, in_proj_weight: torch.Tensor,
            in_proj_bias: torch.Tensor, out_proj_weight: torch.Tensor,
            out_proj_bias: torch.Tensor, num_heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    lib = _library("mha")
    problem = _mha_shape_error(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight,
                               out_proj_bias, num_heads, lib.mha_max_heads(),
                               lib.mha_max_seq(), lib.mha_bf16_tile())
    if problem:
        raise ValueError(f"mha: {problem}")
    b, s, e = keyval.shape
    f32 = dict(device=query.device, dtype=torch.float32)
    q_buf = torch.empty((b, e), **f32)
    kv_buf = torch.empty((b * s, 2 * e), **f32)
    # the attended values: fp32, or at bf16 their hi | lo bf16 halves (mha.cu)
    att_buf = (torch.empty((b, 2 * e), device=query.device, dtype=_BF16)
               if query.dtype == _BF16 else torch.empty((b, e), **f32))
    out = torch.empty_like(query)
    wts = torch.empty((b, s), device=query.device, dtype=query.dtype)
    err = lib.mha_forward(
        _DTYPE_CODES[query.dtype], query.device.index or 0,
        _ptr(query), _ptr(keyval), _ptr(in_proj_weight), _ptr(in_proj_bias),
        _ptr(out_proj_weight), _ptr(out_proj_bias), _ptr(q_buf), _ptr(kv_buf),
        _ptr(att_buf), _ptr(out), _ptr(wts), b, s, e, num_heads, _stream(query),
    )
    _raise_on_error("mha", lib.mha_error_string, err)
    mha.launches += 1
    return out, wts


@_mha_op.register_fake
def _(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight, out_proj_bias, num_heads):
    _raise_if("mha", _mha_shape_error(query, keyval, in_proj_weight, in_proj_bias,
                                      out_proj_weight, out_proj_bias, num_heads, *MHA_LIMITS))
    return (torch.empty_like(query),
            query.new_empty((keyval.shape[0], keyval.shape[1])))


mha.launches = 0


def wgmma_probe(a, b, swizzle: bool):
    """(64, K) x (64, K) bf16 on the card -> (64, 64) fp32 ``a @ b.T``
    through one warpgroup's wgmma (mha.cu): K = 16 in the interleaved
    layout, or K = 64 in the kernels' 128-byte-swizzled layout. The check
    of the shared-memory descriptor; counts no launch."""
    _require_cuda(a)
    k = 64 if swizzle else 16
    for t in (a, b):
        if tuple(t.shape) != (64, k) or t.dtype != _BF16 or not t.is_contiguous():
            raise ValueError(f"wgmma_probe: operands must be contiguous (64, {k}) bf16")
    lib = _library("mha")
    c = torch.empty((64, 64), device=a.device, dtype=torch.float32)
    err = lib.mha_wgmma_probe(int(swizzle), a.device.index or 0, _ptr(a), _ptr(b), _ptr(c),
                              _stream(a))
    _raise_on_error("wgmma_probe", lib.mha_error_string, err)
    return c


# --------------------------------------------------------- ceil max pool


def ceil_max_pool2d_plain(x):
    """MaxPool2d(3, stride 2, padding 0, ceil_mode=True), torch's own pool.
    Mirrors ``_xla_pool`` of the JAX package (NCHW here, NHWC there)."""
    return F.max_pool2d(x, 3, 2, 0, ceil_mode=True)


def ceil_out_size(size: int) -> int:
    """Output length of a 3/2/0 ceil-mode pool: ceil((size - 3) / 2) + 1;
    the last window never starts past the input for a kernel of 3."""
    return -(-(size - 3) // 2) + 1


def pool_layout(x) -> bool:
    """True for channels-last memory order, False for NCHW; raises on
    anything else the kernel does not take (checked without a card)."""
    if x.dim() != 4:
        raise ValueError(f"ceil_max_pool2d: x must be (N, C, H, W), got {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"ceil_max_pool2d: dtype {x.dtype} not in {list(_DTYPE_CODES)}")
    if min(x.shape[2:]) < 3:
        raise ValueError(f"ceil_max_pool2d: H and W must be >= 3, got {tuple(x.shape[2:])}")
    if x.is_contiguous():
        return False
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError(
        f"ceil_max_pool2d: strides {x.stride()} are neither NCHW nor channels-last"
    )


def _check_pool_size(x) -> None:
    """The pool kernels' limits: 32-bit index math; N and H on grid axes."""
    if x.numel() >= 2**31 or max(x.shape[0], x.shape[2]) > _MAX_GRID_Y:
        raise ValueError(f"ceil_max_pool2d: {tuple(x.shape)} has 2^31 elements or more, or "
                         f"N or H above {_MAX_GRID_Y}")


def ceil_max_pool2d_taps_plain(x):
    """(out, taps): the pool and, per output, the window's winning tap 0-8
    (row-major in the 3x3 window) as uint8, both in x's memory format;
    torch's pool indices say where the winner lies (the first strict
    maximum, or the last NaN)."""
    out, index = F.max_pool2d(x, 3, 2, 0, ceil_mode=True, return_indices=True)
    oh, ow = out.shape[2:]
    w = x.shape[3]
    oy = torch.arange(oh, device=x.device).view(oh, 1)
    ox = torch.arange(ow, device=x.device).view(1, ow)
    taps = (index // w - 2 * oy) * 3 + (index % w - 2 * ox)
    fmt = torch.channels_last if pool_layout(x) else torch.contiguous_format
    return out, taps.to(torch.uint8).contiguous(memory_format=fmt)


def ceil_max_pool2d_backward_plain(grad, taps, input_shape, channels_last: bool):
    """dx of the pool from the output gradient and the taps (n, c, oh, ow),
    channels-last or NCHW as the input was: each input element sums, in float32, the gradient of the
    windows whose tap points at it, by output row then column ascending,
    rounded to grad's type once (torch's CUDA backward; the taps are summed
    8 down to 0, which is that order)."""
    n, c, h, w = input_shape
    oh, ow = taps.shape[2:]
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    acc = torch.zeros((n, c, h, w), device=grad.device, dtype=torch.float32)
    g = grad.float()
    zero = torch.zeros((), device=grad.device)
    for tap in range(8, -1, -1):
        dy, dx = divmod(tap, 3)
        rows, cols = min(oh, (h - dy + 1) // 2), min(ow, (w - dx + 1) // 2)
        hit = torch.where(taps[:, :, :rows, :cols] == tap, g[:, :, :rows, :cols], zero)
        acc[:, :, dy:dy + 2 * rows - 1:2, dx:dx + 2 * cols - 1:2] += hit
    return acc.to(grad.dtype).contiguous(memory_format=fmt)


def _launch_max_pool(x, with_taps: bool):
    """One launch of csrc/max_pool.cu's forward (op ``tbn::max_pool``):
    (out, taps or None), in x's memory format."""
    out, taps = _max_pool_op(x, with_taps)
    return out, (taps if with_taps else None)


def _pool_outputs(x, with_taps: bool, channels_last: bool):
    """The forward's (out, taps) buffers in x's memory format; without taps
    an empty uint8 tensor stands in for them (an op returns tensors)."""
    n, c, h, w = x.shape
    oh, ow = ceil_out_size(h), ceil_out_size(w)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    out = torch.empty((n, c, oh, ow), device=x.device, dtype=x.dtype, memory_format=fmt)
    if not with_taps:
        return out, torch.empty((0,), device=x.device, dtype=torch.uint8)
    return out, torch.empty((n, c, oh, ow), device=x.device, dtype=torch.uint8,
                            memory_format=fmt)


@torch.library.custom_op("tbn::max_pool", mutates_args=(), device_types="cuda")
def _max_pool_op(x: torch.Tensor, with_taps: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    channels_last = pool_layout(x)
    out, taps = _pool_outputs(x, with_taps, channels_last)
    if out.numel() == 0:
        return out, taps
    _check_pool_size(x)
    n, c, h, w = x.shape
    oh, ow = out.shape[2:]
    lib = _library("max_pool")
    err = lib.max_pool_forward(
        _DTYPE_CODES[x.dtype], x.device.index or 0, _ptr(x), _ptr(out),
        _ptr(taps) if with_taps else None, n, c, h, w, oh, ow, int(channels_last), _stream(x),
    )
    _raise_on_error("max_pool", lib.max_pool_error_string, err)
    ceil_max_pool2d.launches += 1
    return out, taps


@_max_pool_op.register_fake
def _(x, with_taps):
    return _pool_outputs(x, with_taps, pool_layout(x))


def _launch_max_pool_backward(grad, taps, input_shape, channels_last: bool):
    """One launch of csrc/max_pool.cu's backward (op
    ``tbn::max_pool_backward``): dx in the forward input's memory format,
    which the taps have. ``grad`` is taken in that format (autograd may
    hand it in another; it is then made so, as torch's own backward
    does)."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return _max_pool_backward_op(grad.contiguous(memory_format=fmt), taps, list(input_shape),
                                 channels_last)


@torch.library.custom_op("tbn::max_pool_backward", mutates_args=(), device_types="cuda")
def _max_pool_backward_op(grad: torch.Tensor, taps: torch.Tensor, input_shape: List[int],
                          channels_last: bool) -> torch.Tensor:
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    n, c, h, w = input_shape
    oh, ow = taps.shape[2:]
    dx = torch.empty((n, c, h, w), device=grad.device, dtype=grad.dtype, memory_format=fmt)
    if dx.numel() == 0:
        return dx
    _check_pool_size(dx)
    lib = _library("max_pool")
    err = lib.max_pool_backward(
        _DTYPE_CODES[grad.dtype], grad.device.index or 0, _ptr(grad), _ptr(taps), _ptr(dx),
        n, c, h, w, oh, ow, int(channels_last), _stream(grad),
    )
    _raise_on_error("max_pool backward", lib.max_pool_error_string, err)
    ceil_max_pool2d.backward_launches += 1
    return dx


@_max_pool_backward_op.register_fake
def _(grad, taps, input_shape, channels_last):
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    return torch.empty(input_shape, device=grad.device, dtype=grad.dtype, memory_format=fmt)


class CeilMaxPool2d(torch.autograd.Function):
    """The kernel's forward and, when autograd records through the input,
    its tap codes (one uint8 per output); the backward is the tap kernel's
    gather. The JAX kernel's custom_vjp takes XLA's reduce-window gradient
    (pallas_pool.py:140-147), which this equals bit for bit (the CPU tests
    hold the plain twins against it)."""

    forward_impl = staticmethod(_launch_max_pool)
    backward_impl = staticmethod(_launch_max_pool_backward)

    @staticmethod
    def forward(ctx, x):
        out, taps = CeilMaxPool2d.forward_impl(x, ctx.needs_input_grad[0])
        if taps is not None:
            ctx.save_for_backward(taps)
            ctx.input_shape = tuple(x.shape)
            ctx.channels_last = pool_layout(x)
        return out

    @staticmethod
    def backward(ctx, grad):
        (taps,) = ctx.saved_tensors
        return CeilMaxPool2d.backward_impl(grad, taps, ctx.input_shape, ctx.channels_last)


def ceil_max_pool2d(x):
    """:func:`ceil_max_pool2d_plain` on the CPU; the CUDA kernels on the
    card (NCHW or channels-last, fp32 or bf16, no copy), differentiable."""
    if x.device.type == "cpu":
        return ceil_max_pool2d_plain(x)
    _require_cuda(x)
    if torch.is_grad_enabled() and x.requires_grad:
        return CeilMaxPool2d.apply(x)
    return CeilMaxPool2d.forward_impl(x, False)[0]  # no taps, no autograd node


ceil_max_pool2d.launches = 0  # forward launches
ceil_max_pool2d.backward_launches = 0

# ------------------------------------------------------------- fused stem

STEM_CHANNELS = 64


def fused_stem_plain(x, weight, bias, input_scale, input_offset, dtype):
    """(B, H, W, C) uint8 or float NHWC -> (B, 64, H/4, W/4) in ``dtype``.

    Normalizes in ``dtype`` (x * scale + offset), convolves 7x7 / stride 2 /
    pad 3 with the BN-folded ``weight`` (64, C, 7, 7) rounded to ``dtype``,
    accumulating in float32, adds the float32 ``bias``, ReLU, then the 3x3 /
    stride 2 ceil-mode max pool; rounds to ``dtype`` once. Mirrors
    ``fused_stem_reference`` of the JAX package (whose Pallas kernel, like
    the CUDA one, normalizes in float32 before its one rounding: at bf16 the
    two differ there by one rounding of the input)."""
    xf = x.to(dtype) * input_scale.to(dtype) + input_offset.to(dtype)
    y = F.conv2d(xf.permute(0, 3, 1, 2).float(), weight.to(dtype).float(), None, 2, 3)
    y = F.relu(y + bias.float()[:, None, None])
    return ceil_max_pool2d_plain(y).to(dtype)


def stem_k_padded(c: int) -> int:
    """The bf16 stem's GEMM depth: 49 C rounded up to 16 (RGB 160, Flow
    496, Audio 64)."""
    return -(-49 * c // 16) * 16


def pack_stem_weight(weight):
    """(64, C, 7, 7) -> (64, K) K-major: row o holds k = (ky * 7 + kx) * C
    + c, then zeros up to K = ``stem_k_padded(C)``. The bf16 kernel's B
    operand: [im2col rows in the same K order] @ packed.T is the conv."""
    o, c = weight.shape[:2]
    flat = weight.permute(0, 2, 3, 1).reshape(o, 49 * c)
    return F.pad(flat, (0, stem_k_padded(c) - 49 * c)).contiguous()


def fused_stem_shape_error(x) -> str:
    """Why the fused stem cannot take NHWC ``x`` ("" when it can): the JAX
    package's gate (7x7 stem, H and W multiples of 4) and the kernel's
    input types. Checked without a card."""
    if x.dim() != 4:
        return f"x must be (B, H, W, C), got {tuple(x.shape)}"
    if x.shape[1] % 4 or x.shape[2] % 4 or min(x.shape[1:3]) < 4:
        return f"H and W must be positive multiples of 4, got {tuple(x.shape[1:3])}"
    if x.dtype not in _STEM_INPUT_CODES:
        return f"input dtype {x.dtype} not in {list(_STEM_INPUT_CODES)}"
    return ""


def fused_stem(x, weight, bias, input_scale, input_offset, dtype):
    """:func:`fused_stem_plain` on the CPU; the CUDA kernel on the card (op
    ``tbn::fused_stem``), which reads NHWC ``x`` as it lies and returns a
    channels-last tensor."""
    if x.device.type == "cpu":
        return fused_stem_plain(x, weight, bias, input_scale, input_offset, dtype)
    _require_cuda(x)
    return _fused_stem_op(x, weight, bias, input_scale, input_offset, dtype)


def _fused_stem_args_error(x, weight, bias, input_scale, input_offset, dtype) -> str:
    """Why the kernel cannot take these arguments ("" when it can): the
    shape gate, the compute type, the weight, bias and input affine."""
    problem = fused_stem_shape_error(x)
    if problem:
        return problem
    if dtype not in _DTYPE_CODES:
        return f"compute dtype {dtype} not in {list(_DTYPE_CODES)}"
    if not x.is_contiguous():
        return "x must be contiguous NHWC memory"
    b, h, w, c = x.shape
    if b > _MAX_GRID_Y:
        return f"batch {b} > {_MAX_GRID_Y}"
    if tuple(weight.shape) != (STEM_CHANNELS, c, 7, 7):
        return f"weight {tuple(weight.shape)} != ({STEM_CHANNELS}, {c}, 7, 7)"
    if weight.dtype != dtype or weight.device != x.device or not weight.is_contiguous():
        return f"weight must be contiguous {dtype} on {x.device}"
    for name, t, n in (("bias", bias, STEM_CHANNELS), ("input_scale", input_scale, c),
                       ("input_offset", input_offset, c)):
        if t.device != x.device or t.dtype != torch.float32 or not t.is_contiguous():
            return f"{name} must be contiguous float32 on {x.device}"
        if tuple(t.shape) != (n,):
            return f"{name} {tuple(t.shape)} != ({n},)"
    return ""


def _stem_output(x, dtype):
    b, h, w, _ = x.shape
    return torch.empty((b, STEM_CHANNELS, h // 4, w // 4), device=x.device, dtype=dtype,
                       memory_format=torch.channels_last)


@torch.library.custom_op("tbn::fused_stem", mutates_args=(), device_types="cuda")
def _fused_stem_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   input_scale: torch.Tensor, input_offset: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    _raise_if("fused_stem", _fused_stem_args_error(x, weight, bias, input_scale, input_offset,
                                                   dtype))
    if dtype == _BF16:
        weight = pack_stem_weight(weight)  # the wgmma route's K-major B operand
    b, h, w, c = x.shape
    lib = _library("fused_stem")
    out = _stem_output(x, dtype)
    err = lib.fused_stem_forward(
        _STEM_INPUT_CODES[x.dtype], _DTYPE_CODES[dtype], x.device.index or 0, _ptr(x),
        _ptr(weight), _ptr(bias), _ptr(input_scale), _ptr(input_offset), _ptr(out),
        b, c, h, w, _stream(x),
    )
    _raise_on_error("fused_stem", lib.fused_stem_error_string, err)
    fused_stem.launches += 1
    return out


@_fused_stem_op.register_fake
def _(x, weight, bias, input_scale, input_offset, dtype):
    _raise_if("fused_stem", _fused_stem_args_error(x, weight, bias, input_scale, input_offset,
                                                   dtype))
    return _stem_output(x, dtype)


fused_stem.launches = 0


# ------------------------------------------------------- consensus + heads


def consensus_heads_plain(features, weights, biases):
    """(B, N, F) features -> [(B, C_h) float32 logits]: the float32 mean
    over N, then ``pooled @ W_h.T + b_h`` per head (torch-layout (C_h, F)
    weights). At float32 all in float32, as ``consensus_heads_reference``
    of the JAX package. At bf16 features (and parameters) the JAX model's
    fast consensus with TorchLinear heads (models/tbn.py:430-440,
    layers.py:624-625): the mean rounded to bf16, an fp32 product of the
    bf16 operands rounded to bf16, the sum with the bias rounded again."""
    dtype = features.dtype
    pooled = features.float().mean(dim=1).to(dtype).float()
    return [((pooled @ w.float().T).to(dtype).float() + b.float()).to(dtype).float()
            for w, b in zip(weights, biases)]


# The kernel's limits (csrc/consensus_heads.cu); the smoke holds them
# against the library's consensus_heads_max_features / _max_heads.
CONSENSUS_MAX_FEATURES = 4096
CONSENSUS_MAX_HEADS = 4


class ConsensusOperands:
    """The heads' parameters as the kernel takes them: ctypes arrays of the
    weight and bias pointers and of the class counts, with what the wrapper
    checks a call against (F, type, device) and each head's slice of the
    one output buffer."""

    def __init__(self, weights, biases):
        count = len(weights)
        pointers = ctypes.c_void_p * count
        self.weight_ptrs = pointers(*[w.data_ptr() for w in weights])
        self.bias_ptrs = pointers(*[v.data_ptr() for v in biases])
        classes = [w.shape[0] for w in weights]
        self.class_counts = (ctypes.c_int * count)(*classes)
        self.count = count
        self.total = sum(classes)
        # (C_h, classes before head h): head h's (B, C_h) logits start at
        # B times the second in the output buffer
        self.heads = [(c, sum(classes[:h])) for h, c in enumerate(classes)]
        self.features = weights[0].shape[1]
        self.dtype = weights[0].dtype
        self.device = weights[0].device
        # what a CUDA tensor's get_device() returns on that card; -1 (a CPU
        # tensor's) for heads off the card, which no CUDA features match
        self.device_index = self.device.index if self.device.type == "cuda" else -1


def consensus_heads_params_error(weights, biases) -> str:
    """Why the kernel cannot take these heads ("" when it can), checked
    without a card: 1 to CONSENSUS_MAX_HEADS heads of contiguous (C_h, F)
    weights and (C_h,) biases, one F <= CONSENSUS_MAX_FEATURES, one type
    (fp32 or bf16) and one device."""
    if not 1 <= len(weights) <= CONSENSUS_MAX_HEADS or len(weights) != len(biases):
        return (f"{len(weights)} weights, {len(biases)} biases; 1 to {CONSENSUS_MAX_HEADS} "
                "heads")
    w0 = weights[0]
    if w0.dtype not in _DTYPE_CODES:
        return f"dtype {w0.dtype} not in {list(_DTYPE_CODES)}"
    if w0.dim() != 2 or not 1 <= w0.shape[1] <= CONSENSUS_MAX_FEATURES:
        return f"weight {tuple(w0.shape)}: (C, F) with F <= {CONSENSUS_MAX_FEATURES}"
    for w, v in zip(weights, biases):
        for t in (w, v):
            if t.dtype != w0.dtype or t.device != w0.device or not t.is_contiguous():
                return f"every weight and bias must be contiguous {w0.dtype} on {w0.device}"
        if w.dim() != 2 or w.shape[1] != w0.shape[1] or w.shape[0] < 1 or (
                tuple(v.shape) != (w.shape[0],)):
            return (f"weight {tuple(w.shape)} / bias {tuple(v.shape)} do not fit "
                    f"F={w0.shape[1]}")
    return ""


_CONSENSUS_OPERANDS: list = []  # [(weights + biases, head count, their versions, operands)]


def consensus_heads_operands(weights, biases) -> ConsensusOperands:
    """The kernel's :class:`ConsensusOperands` of the heads, checked and
    made once per version of the tensors: the last set is kept (its
    references keep the pointers valid), so a repeated call builds no
    ctypes array and re-checks no parameter."""
    weights, biases = tuple(weights), tuple(biases)
    tensors = weights + biases
    seen = [t._version for t in tensors]
    if _CONSENSUS_OPERANDS:
        kept, kept_count, kept_seen, operands = _CONSENSUS_OPERANDS[0]
        if (kept_count == len(weights) and len(kept) == len(tensors) and kept_seen == seen
                and all(a is b for a, b in zip(kept, tensors))):
            return operands
    problem = consensus_heads_params_error(weights, biases)
    if problem:
        raise ValueError(f"consensus_heads: {problem}")
    operands = ConsensusOperands(weights, biases)
    _CONSENSUS_OPERANDS[:] = [(tensors, len(weights), seen, operands)]
    return operands


def consensus_heads(features, weights, biases):
    """:func:`consensus_heads_plain` on the CPU; one launch of the CUDA
    kernel for every head on the card (op ``tbn::consensus_heads``), its
    operands from :func:`consensus_heads_operands`. Each head's logits are a
    contiguous (B, C_h) view of the op's one float32 buffer (an op's outputs
    may not alias each other, so the op returns the buffer and the split is
    here)."""
    if features.device.type == "cpu":
        return consensus_heads_plain(features, weights, biases)
    _require_cuda(features)
    out = _consensus_heads_op(features, list(weights), list(biases))
    b, start, logits = features.shape[0], 0, []
    for w in weights:
        c = w.shape[0]
        logits.append(out[b * start:b * (start + c)].view(b, c))
        start += c
    return logits


def _consensus_features_error(features, features_count: int, dtype, device) -> str:
    if features.device != device:
        return (f"features on {features.device}, heads on {device}: the kernel needs both on "
                "one card")
    if features.dim() != 3 or features.dtype != dtype or not features.is_contiguous():
        return (f"features must be contiguous (B, N, F) {dtype}, got "
                f"{tuple(features.shape)} {features.dtype}")
    b, n, f = features.shape
    if f != features_count or n < 1 or not 1 <= b <= _MAX_GRID_Y:
        return (f"(B, N, F) {tuple(features.shape)} outside the kernel's range "
                f"(F = {features_count}, N >= 1, B <= {_MAX_GRID_Y})")
    return ""


@torch.library.custom_op("tbn::consensus_heads", mutates_args=(), device_types="cuda")
def _consensus_heads_op(features: torch.Tensor, weights: List[torch.Tensor],
                        biases: List[torch.Tensor]) -> torch.Tensor:
    ops = consensus_heads_operands(weights, biases)
    # the cheapest checks that hold (a CUDA tensor's get_device is its index)
    if features.get_device() != ops.device_index:
        raise ValueError(f"consensus_heads: features on {features.device}, heads on "
                         f"{ops.device}: the kernel needs both on one card")
    _raise_if("consensus_heads",
              _consensus_features_error(features, ops.features, ops.dtype, features.device))
    b, n, f = features.shape
    lib = _library("consensus_heads")
    out = features.new_empty(b * ops.total, dtype=torch.float32)
    err = lib.consensus_heads_forward(
        _DTYPE_CODES[features.dtype], ops.device_index, _ptr(features),
        ops.weight_ptrs, ops.bias_ptrs, _ptr(out), ops.class_counts, ops.count, b, n, f,
        _stream(features),
    )
    _raise_on_error("consensus_heads", lib.consensus_heads_error_string, err)
    consensus_heads.launches += 1
    return out


@_consensus_heads_op.register_fake
def _(features, weights, biases):
    _raise_if("consensus_heads", consensus_heads_params_error(weights, biases))
    _raise_if("consensus_heads", _consensus_features_error(
        features, weights[0].shape[1], weights[0].dtype, weights[0].device))
    total = sum(w.shape[0] for w in weights)
    return features.new_empty(features.shape[0] * total, dtype=torch.float32)


consensus_heads.launches = 0

# --------------------------------------------------------------- conv 3x3

# Each route's (multiple of C_in, multiple of C_out): at bf16 16-byte
# chunks of 8 channels, the unit the kernel copies and stores
# (conv3x3.cu). The library reports the same through conv3x3_limits
# (:func:`conv3x3_library_limits`).
CONV3X3_LIMITS = {torch.float32: (1, 1), torch.bfloat16: (8, 8)}


# The routes of csrc/conv3x3.cu, by the library's route code: fp32 FMAs;
# at bf16 the resident route (the N tile's weight kept in shared memory
# beside the input halos) up to C_in CONV3X3_RESIDENT_MAX_C_IN, the
# streaming implicit GEMM (K through a cp.async ring) beyond. The smoke
# holds the constant against the library's conv3x3_resident_max_c_in.
CONV3X3_ROUTES = ("fma", "streaming", "resident")
CONV3X3_RESIDENT_MAX_C_IN = 96


def conv3x3_route(x_shape, c_out: int, dtype=torch.bfloat16) -> str:
    """The route the kernel takes for NHWC ``x_shape`` (B, H, W, C_in) and
    ``c_out`` (a name of CONV3X3_ROUTES), checked without a card: at bf16
    the resident route up to C_in CONV3X3_RESIDENT_MAX_C_IN, else the
    streaming one. Raises ValueError for a shape neither takes (bf16 channel
    counts must be multiples of 8)."""
    c_in = x_shape[-1]
    if dtype not in CONV3X3_LIMITS:
        raise ValueError(f"conv3x3: dtype {dtype} not in {list(CONV3X3_LIMITS)}")
    c_in_multiple, c_out_multiple = CONV3X3_LIMITS[dtype]
    if c_in < 1 or c_out < 1 or c_in % c_in_multiple or c_out % c_out_multiple:
        raise ValueError(f"conv3x3: no route takes C_in {c_in}, C_out {c_out} at {dtype}")
    if dtype == torch.float32:
        return "fma"
    return "resident" if c_in <= CONV3X3_RESIDENT_MAX_C_IN else "streaming"


def conv3x3_plain(x, weight, bias):
    """(B, H, W, C_in) NHWC -> (B, H, W, C_out) contiguous NHWC in x's
    type: a 3x3 / stride 1 / zero pad 1 conv with the torch-layout
    ``weight`` (C_out, C_in, 3, 3) in float32 on the widened operands, +
    the float32 bias, ReLU, one rounding. Mirrors the JAX probe's
    ``conv3x3_pallas`` (its ``conv3x3_xla`` adds the bias after rounding).
    On a card, float32 convolutions must run with TF32 off."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), weight.float(), None, 1, 1)
    y = F.relu(y + bias.float()[:, None, None])
    return y.to(x.dtype).permute(0, 2, 3, 1).contiguous()


def conv3x3_k_padded(c_in: int) -> int:
    """The bf16 route's GEMM depth: 9 C_in rounded up to 64, one swizzled
    row of the wgmma operands per stage."""
    return -(-9 * c_in // 64) * 64


def pack_conv3x3_weight(weight):
    """(C_out, C_in, 3, 3) -> (C_out rounded up to 64, K) K-major: row o
    holds k = (ky * 3 + kx) * C_in + c, then zeros up to K =
    ``conv3x3_k_padded(C_in)``; the padding rows are zero. The bf16
    kernel's B operand: [im2col rows in the same K order] @ packed.T is the
    conv."""
    o, c = weight.shape[:2]
    flat = weight.permute(0, 2, 3, 1).reshape(o, 9 * c)
    return F.pad(flat, (0, conv3x3_k_padded(c) - 9 * c, 0, -(-o // 64) * 64 - o)).contiguous()


def conv3x3_shape_error(x, weight, bias) -> str:
    """Why :func:`conv3x3`'s kernel cannot take these arguments ("" when
    it can), checked without a card and without real data: NHWC x of fp32
    or bf16, contiguous, the torch-layout weight in x's type, a (C_out,)
    float bias, the route's ``CONV3X3_LIMITS``, fewer than 2^31 elements in
    x and in the output. (The op's real implementation also wants x on 16
    bytes.)"""
    if x.dim() != 4:
        return f"x must be (B, H, W, C_in) NHWC, got {tuple(x.shape)}"
    if x.dtype not in CONV3X3_LIMITS:
        return f"dtype {x.dtype} not in {list(CONV3X3_LIMITS)}"
    b, h, w, c_in = x.shape
    if min(b, h, w, c_in) < 1:
        return f"x {tuple(x.shape)} is empty"
    if weight.dim() != 4 or tuple(weight.shape[1:]) != (c_in, 3, 3) or weight.shape[0] < 1:
        return f"weight {tuple(weight.shape)} != (C_out, {c_in}, 3, 3)"
    if weight.dtype != x.dtype:
        return f"weight must be {x.dtype} (x's type), got {weight.dtype}"
    c_out = weight.shape[0]
    if tuple(bias.shape) != (c_out,) or not bias.is_floating_point():
        return f"bias {tuple(bias.shape)} {bias.dtype} != ({c_out},) float"
    c_in_multiple, c_out_multiple = CONV3X3_LIMITS[x.dtype]
    if c_in % c_in_multiple or c_out % c_out_multiple:
        return (f"C_in {c_in} and C_out {c_out} must be multiples of {c_in_multiple} and "
                f"{c_out_multiple} at {x.dtype}")
    if not x.is_contiguous():
        return "x must be contiguous NHWC memory"
    if x.numel() >= 2**31 or b * h * w * c_out >= 2**31:
        return f"x {tuple(x.shape)} or its output has 2^31 elements or more"
    return ""


_CONV3X3_OPERANDS: list = []  # [(weight, bias, their versions, (operand, fp32 bias))]


def conv3x3_operands(weight, bias):
    """The kernel's operands of the torch-layout ``weight`` and ``bias``:
    at bf16 :func:`pack_conv3x3_weight`, at fp32 the weight contiguous; the
    bias widened to fp32. Made once per version of the pair: the last pair
    is kept, and the references kept to it stop its memory from being
    reused by other tensors, so a repeated call launches no copy."""
    versions = (weight._version, bias._version)
    if _CONV3X3_OPERANDS:
        w, b, seen, operands = _CONV3X3_OPERANDS[0]
        if w is weight and b is bias and seen == versions:
            return operands
    with torch.no_grad():
        packed = pack_conv3x3_weight(weight) if weight.dtype == _BF16 else weight.contiguous()
        # a fresh fp32 copy: the kernel reads the bias in aligned pairs
        operands = (packed, bias.to(torch.float32, copy=True))
    _CONV3X3_OPERANDS[:] = [(weight, bias, versions, operands)]
    return operands


def conv3x3(x, weight, bias):
    """:func:`conv3x3_plain` on the CPU; the CUDA kernel on the card (op
    ``tbn::conv3x3``). Takes NHWC ``x`` as it lies and returns a contiguous
    (B, H, W, C_out) NHWC tensor in x's type."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    _require_cuda(x)
    return _conv3x3_op(x, weight, bias)


def _conv3x3_args_error(x, weight, bias) -> str:
    problem = conv3x3_shape_error(x, weight, bias)
    if not problem and (weight.device != x.device or bias.device != x.device):
        return f"weight and bias must be on {x.device}"
    return problem


@torch.library.custom_op("tbn::conv3x3", mutates_args=(), device_types="cuda")
def _conv3x3_op(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    _raise_if("conv3x3", _conv3x3_args_error(x, weight, bias))
    if x.data_ptr() % 16:
        raise ValueError("conv3x3: x must start on 16 bytes")
    w_op, bias32 = conv3x3_operands(weight, bias)
    b, h, w, c_in = x.shape
    c_out = weight.shape[0]
    out = x.new_empty((b, h, w, c_out))
    lib = _library("conv3x3")
    err = lib.conv3x3_forward(_DTYPE_CODES[x.dtype], x.device.index or 0, _ptr(x), _ptr(w_op),
                              _ptr(bias32), _ptr(out), b, h, w, c_in, c_out, _stream(x))
    _raise_on_error("conv3x3", lib.conv3x3_error_string, err)
    conv3x3.launches += 1
    return out


@_conv3x3_op.register_fake
def _(x, weight, bias):
    _raise_if("conv3x3", _conv3x3_args_error(x, weight, bias))
    return x.new_empty((*x.shape[:3], weight.shape[0]))


conv3x3.launches = 0


def conv3x3_library_limits(dtype):
    """``CONV3X3_LIMITS[dtype]`` as the built library states it."""
    limits = (ctypes.c_int * 2)()
    lib = _library("conv3x3")
    _raise_on_error("conv3x3", lib.conv3x3_error_string,
                    lib.conv3x3_limits(_DTYPE_CODES[dtype], limits))
    return tuple(limits)


def conv3x3_library_route(x_shape, c_out: int, dtype=torch.bfloat16) -> str:
    """:func:`conv3x3_route` as the built library states it."""
    route = ctypes.c_int()
    lib = _library("conv3x3")
    _raise_on_error("conv3x3", lib.conv3x3_error_string,
                    lib.conv3x3_route(_DTYPE_CODES[dtype], x_shape[-1], c_out,
                                      ctypes.byref(route)))
    return CONV3X3_ROUTES[route.value]


def wgmma_rs_probe(a, b):
    """(64, 64) x (64, 64) bf16 on the card -> (64, 64) fp32 ``a @ b.T``
    through four k16 products of wgmma's register-A form, A by ldmatrix
    (conv3x3.cu): the check of wgmma.cuh's RS helpers; counts no launch."""
    _require_cuda(a)
    for t in (a, b):
        if tuple(t.shape) != (64, 64) or t.dtype != _BF16 or not t.is_contiguous():
            raise ValueError("wgmma_rs_probe: operands must be contiguous (64, 64) bf16")
    lib = _library("conv3x3")
    c = torch.empty((64, 64), device=a.device, dtype=torch.float32)
    err = lib.conv3x3_wgmma_rs_probe(a.device.index or 0, _ptr(a), _ptr(b), _ptr(c), _stream(a))
    _raise_on_error("wgmma_rs_probe", lib.conv3x3_error_string, err)
    return c


# ---------------------------------------------------- int8 convolution

QCONV_C_IN_MULTIPLE = 32  # wgmma's s8 k32 step (qconv.cu)
QCONV_K_CHUNK = 64  # K bytes a step: 64 channels of one tap, one 64-byte swizzled row
QCONV_STAGE_CHUNKS = 2  # K steps a stage where B is resident
QCONV_SEGMENT_MULTIPLE = 32  # output segments start on 32-channel boundaries
QCONV_MAX_SEGMENTS = 4
QCONV_TILE_ROWS = 64  # output positions a box: one consumer warpgroup's tile
QCONV_N_TILES = (64, 96, 128, 160, 192, 224, 256)  # the kernel's N tiles: wgmma m64nNk32
# The bytes of B (an N tile's every K step) the kernel may keep in shared
# memory beside its two rings of five stages of two 64-row x 64-channel
# boxes, the warps' epilogue slabs and the N tile's scale and bias
# (qconv.cu qconv_resident_b_limit)
QCONV_RESIDENT_B_BYTES = 232448 - 1024 - (2 * 5 * 2 * 64 * 64 + 8 * 16 * 40 * 4
                                          + 2 * 256 * 4 + 1024)
QCONV_KERNELS = (1, 3)
QCONV_STRIDES = (1, 2)
QCONV_PADDINGS = (0, 1)
# quantize's routes (qconv.cu), by x's memory: quantize_route
QUANTIZE_ROUTES = ("planes", "channels", "channels_narrow")
_INT32_LIMIT = 2**31
_VECTOR_BYTES = 16


def quantize_plain(x, x_scale):
    """(B, C, H, W) fp32 or bf16 -> (B, H, W, C) int8 NHWC: clamp(round(x /
    x_scale), -127, 127) in fp32, round half to even, as the JAX package's
    ``conv2d_apply_q`` quantizes its input. ``x_scale``: a one-element
    float32 tensor on x's device. (A tensor divisor divides exactly on a
    card too, where torch divides by a Python scalar through its
    reciprocal.)"""
    q = torch.round(x.float() / x_scale).clamp_(-127, 127).to(torch.int8)
    return q.permute(0, 2, 3, 1).contiguous()


def quantize_layout(x) -> str:
    """The kernel's name for (B, C, H, W) x's memory ("" when it takes
    neither; any batch stride, as a channel slice of a wider activation
    has): "planes", each (n, c) plane contiguous (NCHW memory), or
    "channels", channels contiguous at any pixel stride (channels-last
    memory: cuDNN's outputs, the int8 towers' block buffers)."""
    _, c, h, w = x.shape
    sn, sc, sh, sw = x.stride()
    if (w == 1 or sw == 1) and (h == 1 or sh == w) and (c == 1 or sc == h * w):
        return "planes"
    if sc == 1 and (h == 1 or sh == w * sw) and (h * w == 1 or sw >= c):
        return "channels"
    return ""


def quantize_route(x) -> str:
    """The kernel's route for x (a name of QUANTIZE_ROUTES; x in a layout of
    :func:`quantize_layout`): "planes" for NCHW memory; for channels
    contiguous, "channels" (16 channels a thread in 16-byte loads) where x's
    start, pixel stride and batch stride are on 16 bytes, else
    "channels_narrow" (four channels a thread, x on 4 elements)."""
    if quantize_layout(x) == "planes":
        return "planes"
    size = x.element_size()
    aligned = (x.data_ptr() % _VECTOR_BYTES == 0
               and x.stride(3) * size % _VECTOR_BYTES == 0
               and x.stride(0) * size % _VECTOR_BYTES == 0)
    return "channels" if aligned else "channels_narrow"


def quantize_shape_error(x, x_scale) -> str:
    """Why :func:`quantize`'s kernel cannot take these arguments ("" when it
    can), checked without a card: 4-D fp32 or bf16 x in a layout of
    :func:`quantize_layout`, C a multiple of 32, at most 65535 rows, a
    one-element float32 scale."""
    if x.dim() != 4:
        return f"x must be (B, C, H, W), got {tuple(x.shape)}"
    if x.dtype not in _DTYPE_CODES:
        return f"dtype {x.dtype} not in {list(_DTYPE_CODES)}"
    b, c, h, w = x.shape
    if min(b, c, h, w) < 1 or c % QCONV_C_IN_MULTIPLE:
        return f"C {c} must be a positive multiple of {QCONV_C_IN_MULTIPLE}; x {tuple(x.shape)}"
    if b > _MAX_GRID_Z:
        return f"batch {b} > {_MAX_GRID_Z}"
    if not quantize_layout(x):
        return f"x must have contiguous planes or contiguous channels, strides {x.stride()}"
    if x.numel() >= _INT32_LIMIT or h * w * c >= _INT32_LIMIT:
        return f"x {tuple(x.shape)} has 2^31 elements or more"
    if tuple(x_scale.shape) != (1,) or x_scale.dtype != torch.float32:
        return f"x_scale must be one float32, got {tuple(x_scale.shape)} {x_scale.dtype}"
    return ""


def quantize(x, x_scale):
    """:func:`quantize_plain` on the CPU; the CUDA kernel on the card (op
    ``tbn::quantize``), which reads NCHW x as it lies (:func:`quantize_route`)
    and writes a contiguous (B, H, W, C) int8 tensor."""
    if x.device.type == "cpu":
        return quantize_plain(x, x_scale)
    _require_cuda(x)
    return _quantize_op(x, x_scale)


def _quantize_args_error(x, x_scale) -> str:
    problem = quantize_shape_error(x, x_scale)
    if not problem and (x_scale.device != x.device or not x_scale.is_contiguous()):
        return f"x_scale must be contiguous on {x.device}"
    return problem


def _quantize_output(x):
    b, c, h, w = x.shape
    return torch.empty((b, h, w, c), dtype=torch.int8, device=x.device)


@torch.library.custom_op("tbn::quantize", mutates_args=(), device_types="cuda")
def _quantize_op(x: torch.Tensor, x_scale: torch.Tensor) -> torch.Tensor:
    _raise_if("quantize", _quantize_args_error(x, x_scale))
    b, c, h, w = x.shape
    out = _quantize_output(x)
    lib = _library("qconv")
    route = quantize_route(x)
    if route == "channels_narrow" and x.data_ptr() % (4 * x.element_size()):
        raise ValueError("quantize: channels-last x must start on 4 elements")
    err = lib.quantize_forward(_DTYPE_CODES[x.dtype], x.device.index or 0, _ptr(x),
                               _ptr(x_scale), _ptr(out), b, c, h * w,
                               QUANTIZE_ROUTES.index(route), x.stride(3), x.stride(0),
                               _stream(x))
    _raise_on_error("quantize", lib.qconv_error_string, err)
    quantize.launches += 1
    return out


@_quantize_op.register_fake
def _(x, x_scale):
    _raise_if("quantize", _quantize_args_error(x, x_scale))
    return _quantize_output(x)


quantize.launches = 0


def qconv_out_size(size: int, kernel: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - kernel) // stride + 1


class QconvPlan(NamedTuple):
    """How the kernel walks one site (qconv.cu): ``route`` "tma_flat" (a 1x1
    / stride-1 / pad-0 site as a plain GEMM over the B H W positions, boxes
    of up to 64 in a row) or "tma_box" (boxes of box_w x box_h output positions
    of box_i images, every tap a shifted TMA box); the N tile of the
    columns; ``b_resident``: the N tile's whole weight (taps x 64-channel
    chunks, padded to whole stages, x N x 64 bytes) fits
    QCONV_RESIDENT_B_BYTES and is loaded once a block, else it streams
    through the rings with the input."""

    route: str
    n_tile: int
    box_w: int
    box_h: int
    box_i: int
    b_resident: bool

    @property
    def name(self) -> str:
        """The route as the kernels line reports it."""
        return f"{self.route}/{'b_resident' if self.b_resident else 'b_streamed'}"


def _box_sides(limit: int) -> List[int]:
    """Box sides up to ``limit``: the powers of two and the limit itself."""
    sides = {limit}
    side = 1
    while side < limit:
        sides.add(side)
        side *= 2
    return sorted(sides)


@functools.lru_cache(maxsize=None)
def qconv_plan(x_shape: Tuple[int, ...], c_out: int, kernel: int, stride: int,
               padding: int) -> QconvPlan:
    """The plan of the kernel for NHWC ``x_shape`` (B, H, W, C_in), checked
    without a card. N: C_out in ceil(C_out / 256) tiles, each the least of
    QCONV_N_TILES that covers its share (544 -> 3 x 192). The boxes of the
    "tma_box" route: the fewest boxes of at most QCONV_TILE_ROWS positions
    over the output (then the widest rows)."""
    b, h, w, c_in = x_shape
    ho, wo = (qconv_out_size(s, kernel, stride, padding) for s in (h, w))
    tiles = -(-c_out // QCONV_N_TILES[-1])
    n_tile = next(n for n in QCONV_N_TILES if n * tiles >= c_out)
    steps = kernel * kernel * -(-c_in // QCONV_K_CHUNK)
    steps += steps % QCONV_STAGE_CHUNKS  # whole stages of two chunks
    resident = steps * n_tile * QCONV_K_CHUNK <= QCONV_RESIDENT_B_BYTES
    if kernel == 1 and stride == 1 and padding == 0:
        return QconvPlan("tma_flat", n_tile, min(QCONV_TILE_ROWS, b * ho * wo), 1, 1, resident)
    best = None
    for box_w in _box_sides(min(wo, QCONV_TILE_ROWS)):
        for box_h in _box_sides(min(ho, QCONV_TILE_ROWS // box_w)):
            box_i = min(b, QCONV_TILE_ROWS // (box_w * box_h))
            boxes = -(-wo // box_w) * -(-ho // box_h) * -(-b // box_i)
            if best is None or (boxes, -box_w) < best[0]:
                best = ((boxes, -box_w), (box_w, box_h, box_i))
    return QconvPlan("tma_box", n_tile, *best[1], resident)


def qconv_plain(xq, wq, scale, bias, stride: int, padding: int, relu_from: int, dtype,
                segments=None):
    """int8 NHWC ``xq`` (B, H, W, C) conv int8 ``wq`` (C_out, KH, KW, C) in
    ``dtype``: the int32 sums exactly (a float64 convolution of the int8
    values: every partial sum stays under 2^53), then ``acc * scale`` and
    ``+ bias`` as two fp32 roundings, the JAX package's dequantize
    (layers.py:92-96), ReLU on the output channels from ``relu_from`` on,
    one rounding to ``dtype``. ``scale`` = s_k * x_scale and ``bias`` are
    (C_out,) fp32.

    ``segments`` None: returns the (B, C_out, H', W') NCHW result. Else the
    kernel's segment contract (:func:`qconv`): consecutive column ranges,
    each written into its NHWC ``out`` (B, H', W', C_seg) view, a float
    segment (x_scale None) copied as it is, an int8 one as
    :func:`quantize_plain` of it with that x_scale; returns None."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(), wq.permute(0, 3, 1, 2).double(), None,
                   stride, padding).to(torch.int32)
    y = acc.float() * scale.view(1, -1, 1, 1)
    y = y + bias.view(1, -1, 1, 1)
    y[:, relu_from:].clamp_(min=0.0)
    y = y.to(dtype)
    if segments is None:
        return y
    begin = 0
    for out, x_scale in segments:
        part = y[:, begin:begin + out.shape[-1]]
        out.copy_(part.permute(0, 2, 3, 1) if x_scale is None else quantize_plain(part, x_scale))
        begin += out.shape[-1]
    if begin != y.shape[1]:
        raise ValueError(f"qconv: segments cover {begin} of {y.shape[1]} output channels")
    return None


def qconv_shape_error(xq, wq, scale, bias, stride: int, padding: int, relu_from: int,
                      dtype) -> str:
    """Why :func:`qconv`'s kernel cannot take these arguments ("" when it
    can), checked without a card: contiguous int8 NHWC xq and (C_out, K, K,
    C_in) wq with K in QCONV_KERNELS, C_in a multiple of 32, stride 1 or 2,
    padding 0 or 1, (C_out,) float32 scale and bias, 0 <= relu_from <=
    C_out, an fp32 or bf16 output of positive size under 2^31 elements."""
    if xq.dim() != 4 or xq.dtype != torch.int8 or not xq.is_contiguous():
        return f"xq must be contiguous int8 (B, H, W, C), got {tuple(xq.shape)} {xq.dtype}"
    b, h, w, c = xq.shape
    if min(b, h, w) < 1 or c < 1 or c % QCONV_C_IN_MULTIPLE:
        return f"C_in {c} must be a positive multiple of {QCONV_C_IN_MULTIPLE}; xq {tuple(xq.shape)}"
    if (wq.dim() != 4 or wq.dtype != torch.int8 or not wq.is_contiguous()
            or wq.shape[1] != wq.shape[2] or wq.shape[1] not in QCONV_KERNELS
            or wq.shape[3] != c or wq.shape[0] < 1):
        return (f"wq must be contiguous int8 (C_out, K, K, {c}) with K in {QCONV_KERNELS}, "
                f"got {tuple(wq.shape)} {wq.dtype}")
    if stride not in QCONV_STRIDES or padding not in QCONV_PADDINGS:
        return f"stride {stride} / padding {padding} not in {QCONV_STRIDES} / {QCONV_PADDINGS}"
    c_out, k = wq.shape[0], wq.shape[1]
    for name, t in (("scale", scale), ("bias", bias)):
        if tuple(t.shape) != (c_out,) or t.dtype != torch.float32 or not t.is_contiguous():
            return f"{name} must be contiguous float32 ({c_out},), got {tuple(t.shape)} {t.dtype}"
    if not 0 <= relu_from <= c_out:
        return f"relu_from {relu_from} outside [0, {c_out}]"
    if dtype not in _DTYPE_CODES:
        return f"dtype {dtype} not in {list(_DTYPE_CODES)}"
    ho, wo = (qconv_out_size(s, k, stride, padding) for s in (h, w))
    if ho < 1 or wo < 1:
        return f"no output from {h} x {w} with kernel {k}, stride {stride}, padding {padding}"
    if xq.numel() >= _INT32_LIMIT or b * c_out * ho * wo >= _INT32_LIMIT:
        return f"xq {tuple(xq.shape)} or its output has 2^31 elements or more"
    return ""


def _pixel_stride(out) -> int:
    """The elements from one output position to the next of an NHWC view
    (B, H, W, C) whose positions lie at one stride in NHWC order (0 when
    they do not)."""
    b, h, w, _ = out.shape
    sizes, strides = (b, h, w), out.stride()[:3]
    step = next((s // math.prod(sizes[i + 1:]) for i, s in reversed(list(enumerate(strides)))
                 if sizes[i] > 1), out.shape[3])
    if out.stride(3) != 1 and out.shape[3] > 1:
        return 0
    for i in range(3):
        if sizes[i] > 1 and strides[i] != step * math.prod(sizes[i + 1:]):
            return 0
    return step


def qconv_segments_error(segments, out_shape, dtype, check_pointers: bool = True) -> str:
    """Why the kernel cannot write ``segments`` ("" when it can), checked
    without a card: 1 to QCONV_MAX_SEGMENTS (out, x_scale) pairs in column
    order, each ``out`` an NHWC (B, H', W', C_seg) view of ``out_shape``'s
    (B, H', W', C_out) with its positions at one pixel stride and its
    channels contiguous, C_seg and so each segment's first column a
    multiple of 32, the pixel stride on 16 bytes; x_scale None: a float
    segment in ``dtype``; else an int8 segment and its one-element float32
    scale; the segments cover C_out. ``check_pointers``: each out also
    starts on 16 bytes (needs real data)."""
    if not 1 <= len(segments) <= QCONV_MAX_SEGMENTS:
        return f"{len(segments)} segments, not 1 to {QCONV_MAX_SEGMENTS}"
    b, ho, wo, c_out = out_shape
    begin = 0
    for i, (out, x_scale) in enumerate(segments):
        if out.dim() != 4 or tuple(out.shape[:3]) != (b, ho, wo) or out.shape[3] < 1:
            return f"segment {i}: out {tuple(out.shape)} is not ({b}, {ho}, {wo}, C)"
        width = out.shape[3]
        if width % QCONV_SEGMENT_MULTIPLE:
            return (f"segment {i}: columns [{begin}, {begin + width}) not on "
                    f"{QCONV_SEGMENT_MULTIPLE}-channel boundaries")
        begin += width
        if x_scale is None:
            if out.dtype != dtype:
                return f"segment {i}: a float segment must be {dtype}, got {out.dtype}"
        elif (out.dtype != torch.int8 or tuple(x_scale.shape) != (1,)
              or x_scale.dtype != torch.float32):
            return (f"segment {i}: an int8 segment takes an int8 out and one float32 "
                    f"x_scale, got {out.dtype} and {tuple(x_scale.shape)} {x_scale.dtype}")
        step = _pixel_stride(out)
        if step < width:
            return f"segment {i}: out's positions are not at one pixel stride, {out.stride()}"
        if step * out.element_size() % _VECTOR_BYTES:
            return f"segment {i}: pixel stride {step} is not on {_VECTOR_BYTES} bytes"
        if check_pointers and out.data_ptr() % _VECTOR_BYTES:
            return f"segment {i}: out does not start on {_VECTOR_BYTES} bytes"
    if begin != c_out:
        return f"the segments cover {begin} of {c_out} output channels"
    return ""


def qconv_output_shape(xq, wq, stride: int, padding: int) -> Tuple[int, int, int, int]:
    """(B, H', W', C_out) of the site."""
    b, h, w, _ = xq.shape
    k = wq.shape[1]
    return (b, qconv_out_size(h, k, stride, padding), qconv_out_size(w, k, stride, padding),
            wq.shape[0])


def qconv(xq, wq, scale, bias, stride: int, padding: int, relu_from: int, dtype,
          segments=None):
    """:func:`qconv_plain` on the CPU; the CUDA kernel on the card (op
    ``tbn::qconv``): the dequantize, ReLU and rounding in its epilogue, the
    output channels-last into column segments.

    ``segments``: up to four (out, x_scale) pairs in column order that the
    output's C_out channels are cut into, each on a 32-channel boundary
    (:func:`qconv_segments_error`): ``out`` an NHWC (B, H', W', C_seg) view
    at any pixel stride (a channel slice of a channels-last buffer), written
    in ``dtype`` where x_scale is None, else quantized for the next int8
    site with that site's scale (as :func:`quantize` of the rounded values).
    Returns None. ``segments`` None: one float segment into a new buffer,
    returned as a (B, C_out, H', W') channels-last tensor."""
    if segments is None:
        b, ho, wo, c_out = qconv_output_shape(xq, wq, stride, padding)
        out = torch.empty((b, ho, wo, c_out), dtype=dtype, device=xq.device)
        qconv(xq, wq, scale, bias, stride, padding, relu_from, dtype, [(out, None)])
        return out.permute(0, 3, 1, 2)
    if xq.device.type == "cpu":
        return qconv_plain(xq, wq, scale, bias, stride, padding, relu_from, dtype, segments)
    _require_cuda(xq)
    _qconv_op(xq, wq, scale, bias, stride, padding, relu_from, dtype,
              [out for out, _ in segments], [x_scale for _, x_scale in segments])
    return None


def _qconv_args_error(xq, wq, scale, bias, stride, padding, relu_from, dtype, outs, x_scales,
                      check_pointers: bool) -> str:
    problem = qconv_shape_error(xq, wq, scale, bias, stride, padding, relu_from, dtype)
    if problem:
        return problem
    tensors = [wq, scale, bias] + outs + [s for s in x_scales if s is not None]
    if any(t.device != xq.device for t in tensors):
        return f"wq, scale, bias and the segments must be on {xq.device}"
    return qconv_segments_error(list(zip(outs, x_scales)),
                                qconv_output_shape(xq, wq, stride, padding), dtype,
                                check_pointers)


@torch.library.custom_op("tbn::qconv", mutates_args=("outs",), device_types="cuda")
def _qconv_op(xq: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              stride: int, padding: int, relu_from: int, dtype: torch.dtype,
              outs: List[torch.Tensor], x_scales: List[Optional[torch.Tensor]]) -> None:
    _raise_if("qconv", _qconv_args_error(xq, wq, scale, bias, stride, padding, relu_from,
                                         dtype, outs, x_scales, True))
    if xq.data_ptr() % _VECTOR_BYTES or wq.data_ptr() % _VECTOR_BYTES:
        raise ValueError("qconv: xq and wq must start on 16 bytes")
    b, h, w, c = xq.shape
    k = wq.shape[1]
    _, ho, wo, c_out = qconv_output_shape(xq, wq, stride, padding)
    plan = qconv_plan(tuple(xq.shape), c_out, k, stride, padding)
    fields, end = [], 0
    for out, x_scale in zip(outs, x_scales):
        end += out.shape[3]
        fields += [end, int(x_scale is not None), _ptr(out), _pixel_stride(out),
                   0 if x_scale is None else _ptr(x_scale)]
    lib = _library("qconv")
    err = lib.qconv_forward(
        xq.device.index or 0, _ptr(xq), _ptr(wq), _ptr(scale), _ptr(bias), b, h, w, c, c_out, k,
        stride, padding, ho, wo, relu_from, _DTYPE_CODES[dtype],
        (ctypes.c_int * 6)(plan.n_tile, plan.box_w, plan.box_h, plan.box_i,
                           int(plan.route == "tma_flat"), int(plan.b_resident)),
        len(outs), (ctypes.c_longlong * len(fields))(*fields), _stream(xq))
    _raise_on_error("qconv", lib.qconv_error_string, err)
    qconv.launches += 1


@_qconv_op.register_fake
def _(xq, wq, scale, bias, stride, padding, relu_from, dtype, outs, x_scales):
    _raise_if("qconv", _qconv_args_error(xq, wq, scale, bias, stride, padding, relu_from,
                                         dtype, outs, x_scales, False))


qconv.launches = 0


def qconv_wgmma_probe(a, b):
    """(64, 128) x (N, 128) int8 on the card -> (64, N) int32 ``a @ b.T``
    through four m64nNk32 products of wgmma's s8 form from two 64-byte-
    swizzled K tiles (qconv.cu), N in QCONV_N_TILES: the check of
    wgmma.cuh's s8 form; counts no launch."""
    _require_cuda(a)
    n = b.shape[0]
    if (tuple(a.shape) != (64, 128) or tuple(b.shape) != (n, 128) or n not in QCONV_N_TILES
            or a.dtype != torch.int8 or b.dtype != torch.int8 or not a.is_contiguous()
            or not b.is_contiguous()):
        raise ValueError(f"qconv_wgmma_probe: operands must be contiguous int8 (64, 128) and "
                         f"(N, 128), N in {QCONV_N_TILES}")
    lib = _library("qconv")
    c = torch.empty((64, n), device=a.device, dtype=torch.int32)
    err = lib.qconv_wgmma_probe(a.device.index or 0, n, _ptr(a), _ptr(b), _ptr(c), _stream(a))
    _raise_on_error("qconv_wgmma_probe", lib.qconv_error_string, err)
    return c


WRAPPERS = {"pe_block": pe_block, "mha": mha, "max_pool": ceil_max_pool2d,
            "fused_stem": fused_stem, "consensus_heads": consensus_heads, "conv3x3": conv3x3,
            "quantize": quantize, "qconv": qconv}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0
    ceil_max_pool2d.backward_launches = 0


# ---------------------------------------------------------------- helpers


_bound: dict = {}  # name -> library with its C signatures set


def _library(name: str) -> ctypes.CDLL:
    lib = _bound.get(name)
    if lib is None:
        lib = build.load(name)
        for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype, fn.argtypes = restype, argtypes
        _bound[name] = lib
    return lib


def _raise_if(fn: str, problem: str) -> None:
    if problem:
        raise ValueError(f"{fn}: {problem}")


def _require_cuda(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"no kernel for device {t.device}; use a CPU or CUDA tensor")


def _check_param(fn: str, name: str, t: torch.Tensor, device: torch.device,
                 dtype: torch.dtype) -> None:
    """A parameter the kernel takes: on ``device``, of ``dtype`` (the
    activations' type, or float32 where the contract says so), contiguous."""
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, activations on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{fn}: {name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    """The handle of the current stream on t's card (the raw getter: no
    Stream object is made, which cost microseconds a launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _raise_on_error(fn: str, error_string, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn}: CUDA launch failed ({err}): {error_string(err).decode()}")

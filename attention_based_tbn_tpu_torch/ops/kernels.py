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

Dispatch rule of every wrapper: a tensor on the CPU takes the plain version
(``*_plain``); a CUDA tensor launches the kernel, or raises when the kernel
cannot take it. Nothing falls back silently. Each wrapper counts its
launches in ``<wrapper>.launches`` (one per call that reached the card), so
a run can show that it went through the kernels.

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
import math

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
}
_STEM_INPUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_MAX_GRID_Y = 65535  # the kernels put the batch on the grid's y axis
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


def pe_block_bf16_shape_error(x, split, gn_scale, gn_bias, num_groups: int) -> str:
    """Why :func:`pe_block_bf16`'s kernel cannot take these arguments (""
    when it can), checked without a card: bf16 activations, the limits of
    ``PE_BLOCK_LIMITS``, and :func:`pe_block_split`'s operands, contiguous
    and 16-byte aligned."""
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
    if x.data_ptr() % 16 or w_x.data_ptr() % 16:
        return "x and the split weight must start on 16 bytes"
    return ""


def pe_block(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
             num_groups: int = 64, eps: float = 1e-5):
    """:func:`pe_block_plain` on the CPU; on the card the fp32-core kernel,
    float32 only (the bf16 kernel is :func:`pe_block_bf16`)."""
    if x.device.type == "cpu":
        return pe_block_plain(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
                              num_groups, eps)
    _require_cuda(x)
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


pe_block.launches = 0  # launches of either route (pe_block and pe_block_bf16)


def pe_block_bf16(x, split, gn_scale, gn_bias, num_groups: int = 64, eps: float = 1e-5):
    """:func:`pe_block_split_plain` on the CPU; on the card the wgmma
    kernel. ``split`` is :func:`pe_block_split` of the table, conv weight
    and bias rounded to bf16; ``gn_scale`` and ``gn_bias`` are bf16. Its
    launches count in ``pe_block.launches``."""
    if x.device.type == "cpu":
        return pe_block_split_plain(x, split, gn_scale, gn_bias, num_groups, eps)
    _require_cuda(x)
    problem = pe_block_bf16_shape_error(x, split, gn_scale, gn_bias, num_groups)
    if problem:
        raise ValueError(f"pe_block_bf16: {problem}")
    for name, t in (("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        _check_param("pe_block_bf16", name, t, x.device, _BF16)
    w_x, pe_bias = split
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
    """:func:`mha_plain` on the CPU; the CUDA kernels on the card."""
    if query.device.type == "cpu":
        return mha_plain(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight,
                         out_proj_bias, num_heads)
    _require_cuda(query)
    lib = _library("mha")
    if keyval.dim() != 3 or query.dim() != 2:
        raise ValueError(
            f"mha: query (B, E) and keyval (B, S, E) expected, got "
            f"{tuple(query.shape)} and {tuple(keyval.shape)}"
        )
    b, s, e = keyval.shape
    if tuple(query.shape) != (b, e):
        raise ValueError(f"mha: query {tuple(query.shape)} != ({b}, {e})")
    if not 1 <= num_heads <= lib.mha_max_heads() or e % num_heads:
        raise ValueError(f"mha: {num_heads} heads do not divide E={e} (max {lib.mha_max_heads()})")
    if not 1 <= s <= lib.mha_max_seq():
        raise ValueError(f"mha: sequence {s} outside [1, {lib.mha_max_seq()}]")
    _check_activation("mha", query)
    _check_activation("mha", keyval)
    if keyval.dtype != query.dtype or keyval.device != query.device:
        raise ValueError("mha: query and keyval must share dtype and device")
    shapes = {
        "in_proj_weight": (in_proj_weight, (3 * e, e)),
        "in_proj_bias": (in_proj_bias, (3 * e,)),
        "out_proj_weight": (out_proj_weight, (e, e)),
        "out_proj_bias": (out_proj_bias, (e,)),
    }
    for name, (t, shape) in shapes.items():
        _check_param("mha", name, t, query.device, query.dtype)
        if tuple(t.shape) != shape:
            raise ValueError(f"mha: {name} {tuple(t.shape)} != {shape}")
    if query.dtype == _BF16 and e % lib.mha_bf16_tile():
        raise ValueError(f"mha: the bf16 route needs E % {lib.mha_bf16_tile()} == 0, got {e}")

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
    """One launch of csrc/max_pool.cu's forward: (out, taps or None), in
    x's memory format."""
    channels_last = pool_layout(x)
    n, c, h, w = x.shape
    oh, ow = ceil_out_size(h), ceil_out_size(w)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    out = torch.empty((n, c, oh, ow), device=x.device, dtype=x.dtype, memory_format=fmt)
    taps = (torch.empty((n, c, oh, ow), device=x.device, dtype=torch.uint8, memory_format=fmt)
            if with_taps else None)
    if out.numel() == 0:
        return out, taps
    _check_pool_size(x)
    lib = _library("max_pool")
    err = lib.max_pool_forward(
        _DTYPE_CODES[x.dtype], x.device.index or 0, _ptr(x), _ptr(out),
        _ptr(taps) if with_taps else None, n, c, h, w, oh, ow, int(channels_last), _stream(x),
    )
    _raise_on_error("max_pool", lib.max_pool_error_string, err)
    ceil_max_pool2d.launches += 1
    return out, taps


def _launch_max_pool_backward(grad, taps, input_shape, channels_last: bool):
    """One launch of csrc/max_pool.cu's backward: dx in the forward input's
    memory format, which the taps have. ``grad`` is taken in that format
    (autograd may hand it in another; it is then made so, as torch's own
    backward does)."""
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    grad = grad.contiguous(memory_format=fmt)
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
    """:func:`fused_stem_plain` on the CPU; the CUDA kernel on the card,
    which reads NHWC ``x`` as it lies and returns a channels-last tensor."""
    if x.device.type == "cpu":
        return fused_stem_plain(x, weight, bias, input_scale, input_offset, dtype)
    _require_cuda(x)
    problem = fused_stem_shape_error(x)
    if problem:
        raise ValueError(f"fused_stem: {problem}")
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"fused_stem: compute dtype {dtype} not in {list(_DTYPE_CODES)}")
    if not x.is_contiguous():
        raise ValueError("fused_stem: x must be contiguous NHWC memory")
    b, h, w, c = x.shape
    if b > _MAX_GRID_Y:
        raise ValueError(f"fused_stem: batch {b} > {_MAX_GRID_Y}")
    if tuple(weight.shape) != (STEM_CHANNELS, c, 7, 7):
        raise ValueError(
            f"fused_stem: weight {tuple(weight.shape)} != ({STEM_CHANNELS}, {c}, 7, 7)")
    if weight.dtype != dtype or weight.device != x.device or not weight.is_contiguous():
        raise ValueError(f"fused_stem: weight must be contiguous {dtype} on {x.device}")
    for name, t, n in (("bias", bias, STEM_CHANNELS), ("input_scale", input_scale, c),
                       ("input_offset", input_offset, c)):
        _check_param("fused_stem", name, t, x.device, torch.float32)
        if tuple(t.shape) != (n,):
            raise ValueError(f"fused_stem: {name} {tuple(t.shape)} != ({n},)")
    if dtype == _BF16:
        weight = pack_stem_weight(weight)  # the wgmma route's K-major B operand
    lib = _library("fused_stem")
    out = torch.empty((b, STEM_CHANNELS, h // 4, w // 4), device=x.device, dtype=dtype,
                      memory_format=torch.channels_last)
    err = lib.fused_stem_forward(
        _STEM_INPUT_CODES[x.dtype], _DTYPE_CODES[dtype], x.device.index or 0, _ptr(x),
        _ptr(weight), _ptr(bias), _ptr(input_scale), _ptr(input_offset), _ptr(out),
        b, c, h, w, _stream(x),
    )
    _raise_on_error("fused_stem", lib.fused_stem_error_string, err)
    fused_stem.launches += 1
    return out


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
    kernel for every head on the card, its operands from
    :func:`consensus_heads_operands`. Each head's logits are a contiguous
    (B, C_h) view of one float32 buffer."""
    if features.device.type == "cpu":
        return consensus_heads_plain(features, weights, biases)
    _require_cuda(features)
    ops = consensus_heads_operands(weights, biases)
    # the cheapest checks that hold (a CUDA tensor's get_device is its index)
    if features.get_device() != ops.device_index:
        raise ValueError(f"consensus_heads: features on {features.device}, heads on "
                         f"{ops.device}: the kernel needs both on one card")
    if features.dim() != 3 or features.dtype != ops.dtype or not features.is_contiguous():
        raise ValueError(f"consensus_heads: features must be contiguous (B, N, F) {ops.dtype}, "
                         f"got {tuple(features.shape)} {features.dtype}")
    b, n, f = features.shape
    if f != ops.features or n < 1 or not 1 <= b <= _MAX_GRID_Y:
        raise ValueError(f"consensus_heads: (B, N, F) {tuple(features.shape)} outside the "
                         f"kernel's range (F = {ops.features}, N >= 1, B <= {_MAX_GRID_Y})")
    lib = _library("consensus_heads")
    out = features.new_empty(b * ops.total, dtype=torch.float32)
    err = lib.consensus_heads_forward(
        _DTYPE_CODES[features.dtype], ops.device_index, _ptr(features),
        ops.weight_ptrs, ops.bias_ptrs, _ptr(out), ops.class_counts, ops.count, b, n, f,
        _stream(features),
    )
    _raise_on_error("consensus_heads", lib.consensus_heads_error_string, err)
    consensus_heads.launches += 1
    return [out.as_strided((b, c), (c, 1), b * start) for c, start in ops.heads]


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
    it can), checked without a card: NHWC x of fp32 or bf16, contiguous and
    16-byte aligned, the torch-layout weight in x's type, a (C_out,) float
    bias, the route's ``CONV3X3_LIMITS``, fewer than 2^31 elements in x
    and in the output."""
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
    if x.data_ptr() % 16:
        return "x must start on 16 bytes"
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
    """:func:`conv3x3_plain` on the CPU; the CUDA kernel on the card. Takes
    NHWC ``x`` as it lies and returns a contiguous (B, H, W, C_out) NHWC
    tensor in x's type."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias)
    _require_cuda(x)
    problem = conv3x3_shape_error(x, weight, bias)
    if problem:
        raise ValueError(f"conv3x3: {problem}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError(f"conv3x3: weight and bias must be on {x.device}")
    w_op, bias32 = conv3x3_operands(weight, bias)
    b, h, w, c_in = x.shape
    c_out = weight.shape[0]
    out = torch.empty((b, h, w, c_out), device=x.device, dtype=x.dtype)
    lib = _library("conv3x3")
    err = lib.conv3x3_forward(_DTYPE_CODES[x.dtype], x.device.index or 0, _ptr(x), _ptr(w_op),
                              _ptr(bias32), _ptr(out), b, h, w, c_in, c_out, _stream(x))
    _raise_on_error("conv3x3", lib.conv3x3_error_string, err)
    conv3x3.launches += 1
    return out


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


WRAPPERS = {"pe_block": pe_block, "mha": mha, "max_pool": ceil_max_pool2d,
            "fused_stem": fused_stem, "consensus_heads": consensus_heads, "conv3x3": conv3x3}


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


def _require_cuda(t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"no kernel for device {t.device}; use a CPU or CUDA tensor")


def _check_activation(fn: str, t: torch.Tensor) -> None:
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: dtype {t.dtype} not in {list(_DTYPE_CODES)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: activations must be contiguous")


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

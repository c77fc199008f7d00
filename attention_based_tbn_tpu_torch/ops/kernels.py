"""The port's hand-written kernels, each beside its plain PyTorch version.

* ``pe_block`` — concat PE -> 1x1 conv -> GroupNorm on (B, S, C) in one
  pass (csrc/pe_block.cu; replaces the JAX package's
  ``ops/pallas_kernels.py:pe_block_pallas``).
* ``mha`` — single-query multi-head attention with key == value, returning
  the output and the head-averaged weights (csrc/mha.cu; replaces
  ``ops/pallas_kernels.py:mha_pallas``).
* ``ceil_max_pool2d`` — the towers' 3x3 / stride-2 / pad-0 ceil-mode max
  pool on NCHW or channels-last input (csrc/max_pool.cu; replaces
  ``ops/pallas_pool.py:ceil_max_pool2d_pallas``), differentiable through
  the plain pool's gradient.
* ``fused_stem`` — the eval stem of a 7x7 tower: normalize -> 7x7/2 conv
  with BatchNorm folded in -> + float32 bias -> ReLU -> 3x3/2 ceil max pool
  (csrc/fused_stem.cu; replaces ``ops/fused_stem.py:fused_stem_pallas``).
* ``consensus_heads`` — the segment mean of (B, N, F) features and every
  classifier head on it, float32 logits (csrc/consensus_heads.cu; replaces
  ``ops/pallas_kernels.py:consensus_heads_pallas``).

Dispatch rule of every wrapper: a tensor on the CPU takes the plain version
(``*_plain``); a CUDA tensor launches the kernel, or raises when the kernel
cannot take it. Nothing falls back silently. Each wrapper counts its
launches in ``<wrapper>.launches`` (one per call that reached the card), so
a run can show that it went through the kernels.

Weights arrive in torch layout ((out, in) matrices, fp32); activations are
fp32 or bf16. The plain versions compute in fp32 and return the input's
type, which is what the kernels do.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from . import build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signatures of csrc/*.cu's exported functions: (restype, argtypes).
_SIGNATURES = {
    "pe_block": {
        "pe_block_forward": (
            _I, [_I, _I, _P, _P, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P]
        ),
        "pe_block_max_seq": (_I, []),
        "pe_block_channel_tile": (_I, []),
        "pe_block_error_string": (ctypes.c_char_p, [_I]),
    },
    "mha": {
        "mha_forward": (_I, [_I, _I] + [_P] * 11 + [_I, _I, _I, _I, _P]),
        "mha_max_heads": (_I, []),
        "mha_max_seq": (_I, []),
        "mha_error_string": (ctypes.c_char_p, [_I]),
    },
    "max_pool": {
        "max_pool_forward": (_I, [_I, _I, _P, _P] + [_I] * 7 + [_P]),
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
        "consensus_heads_error_string": (ctypes.c_char_p, [_I]),
    },
}
_STEM_INPUT_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_MAX_GRID_Y = 65535  # the kernels put the batch on the grid's y axis
_GROUP_CHANNELS = (4, 8, 16, 32, 64)  # channels per group the kernel handles


# --------------------------------------------------------------- PE block


def pe_block_plain(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
                   num_groups: int = 64, eps: float = 1e-5):
    """(B, S, C_in) -> (B, S, C_out): concat the (S, D) PE table, 1x1 conv
    with ``conv_weight`` (C_out, C_in + D), GroupNorm(num_groups) with a
    two-pass variance. Mirrors ``pe_block_reference`` of the JAX package."""
    b, s, _ = x.shape
    pe = pe_table.float()[None].expand(b, s, pe_table.shape[1])
    h = torch.cat([x.float(), pe], dim=-1) @ conv_weight.float().T + conv_bias.float()
    grouped = h.view(b, s, num_groups, -1)
    mean = grouped.mean(dim=(1, 3), keepdim=True)
    var = (grouped - mean).square().mean(dim=(1, 3), keepdim=True)
    normed = ((grouped - mean) * torch.rsqrt(var + eps)).view(b, s, -1)
    return (normed * gn_scale.float() + gn_bias.float()).to(x.dtype)


def pe_block(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
             num_groups: int = 64, eps: float = 1e-5):
    """:func:`pe_block_plain` on the CPU; the CUDA kernel on the card."""
    if x.device.type == "cpu":
        return pe_block_plain(x, pe_table, conv_weight, conv_bias, gn_scale, gn_bias,
                              num_groups, eps)
    _require_cuda(x)
    lib = _library("pe_block")
    if x.dim() != 3:
        raise ValueError(f"pe_block: x must be (B, S, C_in), got {tuple(x.shape)}")
    b, s, c_in = x.shape
    c_out = conv_weight.shape[0]
    d = pe_table.shape[-1]
    if conv_weight.shape != (c_out, c_in + d):
        raise ValueError(
            f"pe_block: conv_weight {tuple(conv_weight.shape)} != ({c_out}, {c_in + d})"
        )
    if tuple(pe_table.shape) != (s, d):
        raise ValueError(f"pe_block: pe_table {tuple(pe_table.shape)} != ({s}, {d})")
    if not 1 <= s <= lib.pe_block_max_seq():
        raise ValueError(f"pe_block: sequence {s} outside [1, {lib.pe_block_max_seq()}]")
    if c_out % lib.pe_block_channel_tile() or c_out % num_groups:
        raise ValueError(
            f"pe_block: C_out {c_out} must be a multiple of "
            f"{lib.pe_block_channel_tile()} and of num_groups {num_groups}"
        )
    if c_out // num_groups not in _GROUP_CHANNELS:
        raise ValueError(
            f"pe_block: {c_out // num_groups} channels per group; the kernel "
            f"takes {_GROUP_CHANNELS}"
        )
    _check_activation("pe_block", x)
    for name, t in (("conv_weight", conv_weight), ("conv_bias", conv_bias),
                    ("gn_scale", gn_scale), ("gn_bias", gn_bias)):
        _check_param("pe_block", name, t, x.device)
    if conv_bias.shape != (c_out,) or gn_scale.shape != (c_out,) or gn_bias.shape != (c_out,):
        raise ValueError("pe_block: conv_bias, gn_scale and gn_bias must be (C_out,)")
    # The kernel reads the table through its strides (the model passes a
    # transposed view of its buffer), so it need not be contiguous.
    if pe_table.device != x.device or pe_table.dtype != torch.float32:
        raise ValueError(f"pe_block: pe_table must be float32 on {x.device}")

    out = torch.empty_like(x)
    err = lib.pe_block_forward(
        _DTYPE_CODES[x.dtype], x.device.index or 0,
        _ptr(x), _ptr(pe_table), pe_table.stride(0), pe_table.stride(1), _ptr(conv_weight),
        _ptr(conv_bias), _ptr(gn_scale), _ptr(gn_bias), _ptr(out), b, s, c_in, d, c_out,
        num_groups, eps, _stream(x),
    )
    _raise_on_error("pe_block", lib.pe_block_error_string, err)
    pe_block.launches += 1
    return out


pe_block.launches = 0


# -------------------------------------------------------------------- MHA


def mha_plain(query, keyval, in_proj_weight, in_proj_bias, out_proj_weight,
              out_proj_bias, num_heads: int, drop=None):
    """Single-query MHA, (B, E) x (B, S, E) -> ((B, E), (B, S) head-averaged
    weights). ``in_proj_weight`` packs [Wq; Wk; Wv] like torch's
    MultiheadAttention. Mirrors ``mha_reference`` of the JAX package.

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
    logits = torch.einsum("bhd,bshd->bhs", q / math.sqrt(hd), k)
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
        _check_param("mha", name, t, query.device)
        if tuple(t.shape) != shape:
            raise ValueError(f"mha: {name} {tuple(t.shape)} != {shape}")

    f32 = dict(device=query.device, dtype=torch.float32)
    q_buf = torch.empty((b, e), **f32)
    kv_buf = torch.empty((b * s, 2 * e), **f32)
    att_buf = torch.empty((b, e), **f32)
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


def _launch_max_pool(x):
    """One launch of csrc/max_pool.cu; the output has x's memory format."""
    channels_last = pool_layout(x)
    n, c, h, w = x.shape
    oh, ow = ceil_out_size(h), ceil_out_size(w)
    fmt = torch.channels_last if channels_last else torch.contiguous_format
    out = torch.empty((n, c, oh, ow), device=x.device, dtype=x.dtype, memory_format=fmt)
    if out.numel() == 0:
        return out
    lib = _library("max_pool")
    err = lib.max_pool_forward(
        _DTYPE_CODES[x.dtype], x.device.index or 0, _ptr(x), _ptr(out), n, c, h, w, oh, ow,
        int(channels_last), _stream(x),
    )
    _raise_on_error("max_pool", lib.max_pool_error_string, err)
    ceil_max_pool2d.launches += 1
    return out


class CeilMaxPool2d(torch.autograd.Function):
    """The kernel's forward; the backward is the plain pool's gradient on
    the saved input, as the JAX kernel's custom_vjp takes XLA's
    reduce-window gradient (pallas_pool.py:140-147)."""

    forward_impl = staticmethod(_launch_max_pool)

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return CeilMaxPool2d.forward_impl(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            leaf = x.detach().requires_grad_(True)
            (dx,) = torch.autograd.grad(ceil_max_pool2d_plain(leaf), leaf, grad)
        return dx


def ceil_max_pool2d(x):
    """:func:`ceil_max_pool2d_plain` on the CPU; the CUDA kernel on the card
    (NCHW or channels-last, fp32 or bf16, no copy), differentiable."""
    if x.device.type == "cpu":
        return ceil_max_pool2d_plain(x)
    _require_cuda(x)
    return CeilMaxPool2d.apply(x)


ceil_max_pool2d.launches = 0

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
        _check_param("fused_stem", name, t, x.device)
        if tuple(t.shape) != (n,):
            raise ValueError(f"fused_stem: {name} {tuple(t.shape)} != ({n},)")
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
    over N, then ``pooled @ W_h.T + b_h`` in float32 per head (torch-layout
    (C_h, F) weights). Mirrors ``consensus_heads_reference`` of the JAX
    package."""
    pooled = features.float().mean(dim=1)
    return [pooled @ w.float().T + b.float() for w, b in zip(weights, biases)]


def consensus_heads(features, weights, biases):
    """:func:`consensus_heads_plain` on the CPU; one launch of the CUDA
    kernel for every head on the card."""
    if features.device.type == "cpu":
        return consensus_heads_plain(features, weights, biases)
    _require_cuda(features)
    lib = _library("consensus_heads")
    if features.dim() != 3:
        raise ValueError(f"consensus_heads: features must be (B, N, F), got "
                         f"{tuple(features.shape)}")
    _check_activation("consensus_heads", features)
    b, n, f = features.shape
    if not 1 <= f <= lib.consensus_heads_max_features() or n < 1 or not 1 <= b <= _MAX_GRID_Y:
        raise ValueError(f"consensus_heads: (B, N, F) {tuple(features.shape)} outside the "
                         f"kernel's range (F <= {lib.consensus_heads_max_features()})")
    if not 1 <= len(weights) <= lib.consensus_heads_max_heads() or len(weights) != len(biases):
        raise ValueError(f"consensus_heads: {len(weights)} weights, {len(biases)} biases; "
                         f"1 to {lib.consensus_heads_max_heads()} heads")
    for w, bias in zip(weights, biases):
        _check_param("consensus_heads", "weight", w, features.device)
        _check_param("consensus_heads", "bias", bias, features.device)
        if w.dim() != 2 or w.shape[1] != f or tuple(bias.shape) != (w.shape[0],):
            raise ValueError(f"consensus_heads: weight {tuple(w.shape)} / bias "
                             f"{tuple(bias.shape)} do not fit F={f}")
    outs = [torch.empty((b, w.shape[0]), device=features.device, dtype=torch.float32)
            for w in weights]
    count = len(weights)
    pointers = ctypes.c_void_p * count
    err = lib.consensus_heads_forward(
        _DTYPE_CODES[features.dtype], features.device.index or 0, _ptr(features),
        pointers(*[_ptr(w) for w in weights]), pointers(*[_ptr(v) for v in biases]),
        pointers(*[_ptr(o) for o in outs]), (ctypes.c_int * count)(*[w.shape[0] for w in weights]),
        count, b, n, f, _stream(features),
    )
    _raise_on_error("consensus_heads", lib.consensus_heads_error_string, err)
    consensus_heads.launches += 1
    return outs


consensus_heads.launches = 0

WRAPPERS = {"pe_block": pe_block, "mha": mha, "max_pool": ceil_max_pool2d,
            "fused_stem": fused_stem, "consensus_heads": consensus_heads}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


# ---------------------------------------------------------------- helpers


def _library(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    for fn_name, (restype, argtypes) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.restype, fn.argtypes = restype, argtypes
    return lib


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"no kernel for device {t.device}; use a CPU or CUDA tensor")


def _check_activation(fn: str, t: torch.Tensor) -> None:
    if t.dtype not in _DTYPE_CODES:
        raise ValueError(f"{fn}: dtype {t.dtype} not in {list(_DTYPE_CODES)}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: activations must be contiguous")


def _check_param(fn: str, name: str, t: torch.Tensor, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} on {t.device}, activations on {device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{fn}: {name} must be float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous")


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on_error(fn: str, error_string, err: int) -> None:
    if err:
        raise RuntimeError(f"{fn}: CUDA launch failed ({err}): {error_string(err).decode()}")

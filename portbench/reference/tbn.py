"""The Temporal Binding Network in plain PyTorch, float32, written from the
published descriptions (EPIC-Fusion, arXiv:1908.08498; the attention
recipe of github.com/tridivb/attention_based_tbn; BN-Inception,
arXiv:1502.03167; ResNet, arXiv:1512.03385), with no kernel, cache or
batching of the measured program.

Parameters are a flat dict in the reference state-dict layout
(``Base_RGB.conv1_7x7_s2.weight``, ``Base_Flow.model.layer1.0.conv1.weight``,
``pe.1.weight``, ``attention_layer.attention_layer.in_proj_weight``,
``fusion.fusion_layer.0.weight``, ``classifier.verb.weight``); every
tensor float32. The model is described by the ``model`` section of a
configuration file of the benchmark (``portbench/configs/*.json``).

Forward:

* RGB (B, N, H, W, 3) and Flow (B, N, H, W, 2 * win) uint8 -> float,
  ``(x / 255 - mean) / std`` per channel; Audio (B, N, L) waveform -> the
  log power STFT (librosa's: periodic Hann of ``window_ms`` zero-padded to
  ``n_fft``, ``hop_ms`` hop, centred with zero padding, log(|S|^2 + eps));
* one tower per modality on the (B * N) folded rows: BN-Inception (every
  conv followed by BatchNorm and ReLU; ceil-mode pools) or torchvision's
  bottleneck ResNet; a global average pool, or for the attended audio the
  mean over frequency, keeping time;
* attention: the audio sequence concatenated with a sinusoidal table, a
  1x1 conv and GroupNorm, then multi-head attention with the RGB feature as
  the one query and the sequence as keys and values; the weights returned
  are the head mean of the softmax;
* the features concatenated -> Linear + ReLU (Fusion; none for one
  modality) -> a linear head per class type -> the mean over the N
  segments.

In training, BatchNorm takes batch statistics (biased variance to
normalize; the running statistics take the unbiased one with momentum
0.1), and dropout (probability ``p``, kept values scaled by 1 / (1 - p))
acts on the attention probabilities and on the Fusion output, its mask
``uniform >= p`` drawn from the caller's generator in that order.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from .precision import FLOAT32, Precision

BN_EPS = 1e-5
GN_EPS = 1e-5
# BN-Inception's blocks: (name, 1x1, 3x3 reduce, 3x3, double reduce,
# double 3x3, pool projection, pool kind, stride). Output channels: 3a 256,
# 3b 320, 3c 576, 4a-4b 576, 4c-4d 608, 4e 1056, 5a-5b 1024.
INCEPTION_BLOCKS = (
    ("inception_3a", 64, 64, 64, 64, 96, 32, "avg", 1),
    ("inception_3b", 64, 64, 96, 64, 96, 64, "avg", 1),
    ("inception_3c", 0, 128, 160, 64, 96, 0, "max", 2),
    ("inception_4a", 224, 64, 96, 96, 128, 128, "avg", 1),
    ("inception_4b", 192, 96, 128, 96, 128, 128, "avg", 1),
    ("inception_4c", 160, 128, 160, 128, 160, 128, "avg", 1),
    ("inception_4d", 96, 128, 192, 160, 192, 128, "avg", 1),
    ("inception_4e", 0, 128, 192, 192, 256, 0, "max", 2),
    ("inception_5a", 352, 192, 320, 160, 224, 128, "avg", 1),
    ("inception_5b", 352, 192, 320, 192, 224, 128, "max", 1),
)
# torchvision's bottleneck ResNets: blocks per stage
RESNET_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
RESNET_WIDTHS = (64, 128, 256, 512)
IN_CHANNELS = {"RGB": 3, "Audio": 1}


def in_channels(desc: dict, modality: str) -> int:
    return desc["flow_channels"] if modality == "Flow" else IN_CHANNELS[modality]


def feature_size(desc: dict) -> int:
    return 1024 if desc["arch"] == "bninception" else 2048


def attends(desc: dict) -> bool:
    return desc["attention"] is not None and "Audio" in desc["modality"]


# ---------------------------------------------------------------- parameters


def _conv_bn_spec(spec: dict, name: str, bn: str, cin: int, cout: int, k, bias: bool) -> None:
    kh, kw = (k, k) if isinstance(k, int) else k
    spec[f"{name}.weight"] = ((cout, cin, kh, kw), "conv", cin * kh * kw)
    if bias:
        spec[f"{name}.bias"] = ((cout,), "bias", 0)
    for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var"),
                       ("num_batches_tracked", "count")):
        spec[f"{bn}.{leaf}"] = (() if kind == "count" else (cout,), kind, 0)


def _bninception_spec(spec: dict, tower: str, cin: int) -> None:
    def cb(name, a, b, k):
        _conv_bn_spec(spec, f"{tower}.{name}", f"{tower}.{name}_bn", a, b, k, True)

    cb("conv1_7x7_s2", cin, 64, 7)
    cb("conv2_3x3_reduce", 64, 64, 1)
    cb("conv2_3x3", 64, 192, 3)
    c = 192
    for name, b1, r3, b3, rd, d3, proj, _, _ in INCEPTION_BLOCKS:
        if b1:
            cb(f"{name}_1x1", c, b1, 1)
        cb(f"{name}_3x3_reduce", c, r3, 1)
        cb(f"{name}_3x3", r3, b3, 3)
        cb(f"{name}_double_3x3_reduce", c, rd, 1)
        cb(f"{name}_double_3x3_1", rd, d3, 3)
        cb(f"{name}_double_3x3_2", d3, d3, 3)
        if proj:
            cb(f"{name}_pool_proj", c, proj, 1)
        c = b1 + b3 + d3 + (proj if proj else c)


def _resnet_spec(spec: dict, tower: str, cin: int, depth: int) -> None:
    def cb(conv, bn, a, b, k):
        _conv_bn_spec(spec, f"{tower}.model.{conv}", f"{tower}.model.{bn}", a, b, k, False)

    cb("conv1", "bn1", cin, 64, 7)
    c = 64
    for stage, (width, blocks) in enumerate(zip(RESNET_WIDTHS, RESNET_BLOCKS[depth]), 1):
        for i in range(blocks):
            p = f"layer{stage}.{i}"
            cb(f"{p}.conv1", f"{p}.bn1", c, width, 1)
            cb(f"{p}.conv2", f"{p}.bn2", width, width, 3)
            cb(f"{p}.conv3", f"{p}.bn3", width, 4 * width, 1)
            if i == 0:
                cb(f"{p}.downsample.0", f"{p}.downsample.1", c, 4 * width, 1)
            c = 4 * width


def param_spec(desc: dict) -> Dict[str, tuple]:
    """{name: (shape, kind, fan in)} of every tensor of the model's state
    dict, in a fixed order."""
    spec: Dict[str, tuple] = {}
    for m in desc["modality"]:
        if desc["arch"] == "bninception":
            _bninception_spec(spec, f"Base_{m}", in_channels(desc, m))
        else:
            _resnet_spec(spec, f"Base_{m}", in_channels(desc, m), desc["resnet_depth"])
    width = feature_size(desc)
    if attends(desc):
        att = desc["attention"]
        d = att["pe_channels"]
        spec["pe.0.pe"] = ((1, d, att["window"]), "pe_table", 0)
        spec["pe.1.weight"] = ((width, width + d, 1), "linear", width + d)
        spec["pe.1.bias"] = ((width,), "bias", 0)
        spec["pe.2.weight"] = ((width,), "gn_weight", 0)
        spec["pe.2.bias"] = ((width,), "gn_bias", 0)
        pre = "attention_layer.attention_layer"
        spec[f"{pre}.in_proj_weight"] = ((3 * width, width), "linear", width)
        spec[f"{pre}.in_proj_bias"] = ((3 * width,), "bias", 0)
        spec[f"{pre}.out_proj.weight"] = ((width, width), "linear", width)
        spec[f"{pre}.out_proj.bias"] = ((width,), "bias", 0)
    features = width * len(desc["modality"])
    if len(desc["modality"]) > 1:
        spec["fusion.fusion_layer.0.weight"] = ((desc["fusion"], features), "linear", features)
        spec["fusion.fusion_layer.0.bias"] = ((desc["fusion"],), "bias", 0)
        features = desc["fusion"]
    for head, classes in desc["num_classes"].items():
        spec[f"classifier.{head}.weight"] = ((classes, features), "linear", features)
        spec[f"classifier.{head}.bias"] = ((classes,), "bias", 0)
    return spec


def pe_table(channels: int, length: int) -> torch.Tensor:
    """(channels, length): row 2i holds sin(p * (i + 1)) and row 2i + 1
    cos(p * (i + 1)) at position p (the attention recipe's table)."""
    p = torch.arange(length, dtype=torch.float64)[None, :]
    i = torch.arange(1, channels // 2 + 1, dtype=torch.float64)[:, None]
    table = torch.zeros(channels, length, dtype=torch.float64)
    table[0::2] = torch.sin(p * i)
    table[1::2] = torch.cos(p * i)
    return table.float()


# ---------------------------------------------------------------- layers


class Context:
    """What one forward needs beside the parameters: training or not, the
    generator of the dropout masks, the operand precision, the batch
    statistics taken (name -> (mean, unbiased variance)) and the inputs
    of the towers' stride-2 max pools, (C, H, W) each."""

    def __init__(self, train: bool = False, generator: Optional[torch.Generator] = None,
                 prec: Precision = FLOAT32, pools: Optional[List[tuple]] = None):
        self.train = train
        self.generator = generator
        self.prec = prec
        self.stats: Dict[str, tuple] = {}
        self.pools = pools


def batch_norm(p: dict, bn: str, y: torch.Tensor, ctx: Context) -> torch.Tensor:
    gamma, beta = p[f"{bn}.weight"], p[f"{bn}.bias"]
    if ctx.train:
        mean = y.mean(dim=(0, 2, 3))
        var = y.var(dim=(0, 2, 3), unbiased=False)
        n = y.numel() // y.shape[1]
        ctx.stats[bn] = (mean.detach(), var.detach() * n / (n - 1))
    else:
        mean, var = p[f"{bn}.running_mean"], p[f"{bn}.running_var"]
    inv = torch.rsqrt(var + BN_EPS) * gamma
    return (y - mean[None, :, None, None]) * inv[None, :, None, None] + beta[None, :, None, None]


def conv_bn(p: dict, conv: str, bn: str, x: torch.Tensor, stride: int, padding, ctx: Context,
            relu: bool = True) -> torch.Tensor:
    y = F.conv2d(ctx.prec(x), ctx.prec(p[f"{conv}.weight"]), p.get(f"{conv}.bias"), stride,
                 padding)
    y = batch_norm(p, bn, ctx.prec(y), ctx)
    return F.relu(y) if relu else y


def ceil_max_pool(x: torch.Tensor, stride: int, ctx: Context) -> torch.Tensor:
    if stride == 2 and ctx.pools is not None:
        ctx.pools.append(tuple(x.shape[1:]))
    return F.max_pool2d(x, 3, stride, 0, ceil_mode=True)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, ctx: Context) -> torch.Tensor:
    return ctx.prec(ctx.prec(x) @ ctx.prec(w).T + b)


def dropout(x: torch.Tensor, rate: float, ctx: Context) -> torch.Tensor:
    if not ctx.train or rate <= 0:
        return x
    keep = torch.rand(x.shape, generator=ctx.generator, device=x.device,
                      dtype=torch.float32) >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


# ---------------------------------------------------------------- towers


def bninception(p: dict, tower: str, x: torch.Tensor, ctx: Context) -> torch.Tensor:
    def cbr(name, inp, stride=1, padding=0):
        return conv_bn(p, f"{tower}.{name}", f"{tower}.{name}_bn", inp, stride, padding, ctx)

    y = ceil_max_pool(cbr("conv1_7x7_s2", x, 2, 3), 2, ctx)
    y = ceil_max_pool(cbr("conv2_3x3", cbr("conv2_3x3_reduce", y), 1, 1), 2, ctx)
    for name, b1, _, _, _, _, proj, pool, stride in INCEPTION_BLOCKS:
        branches = []
        if b1:
            branches.append(cbr(f"{name}_1x1", y))
        branches.append(cbr(f"{name}_3x3", cbr(f"{name}_3x3_reduce", y), stride, 1))
        d = cbr(f"{name}_double_3x3_1", cbr(f"{name}_double_3x3_reduce", y), 1, 1)
        branches.append(cbr(f"{name}_double_3x3_2", d, stride, 1))
        if proj and pool == "avg":
            pooled = F.avg_pool2d(y, 3, 1, 1, ceil_mode=True, count_include_pad=True)
            branches.append(cbr(f"{name}_pool_proj", pooled))
        elif proj:
            branches.append(cbr(f"{name}_pool_proj", F.max_pool2d(y, 3, 1, 1, ceil_mode=True)))
        else:
            branches.append(ceil_max_pool(y, stride, ctx))
        y = torch.cat(branches, dim=1)
    return y


def resnet(p: dict, tower: str, x: torch.Tensor, depth: int, ctx: Context) -> torch.Tensor:
    pre = f"{tower}.model"
    y = conv_bn(p, f"{pre}.conv1", f"{pre}.bn1", x, 2, 3, ctx)
    y = F.max_pool2d(y, 3, 2, 1)
    for stage, blocks in enumerate(RESNET_BLOCKS[depth], 1):
        for i in range(blocks):
            b = f"{pre}.layer{stage}.{i}"
            stride = 2 if stage > 1 and i == 0 else 1
            out = conv_bn(p, f"{b}.conv1", f"{b}.bn1", y, 1, 0, ctx)
            out = conv_bn(p, f"{b}.conv2", f"{b}.bn2", out, stride, 1, ctx)
            out = conv_bn(p, f"{b}.conv3", f"{b}.bn3", out, 1, 0, ctx, relu=False)
            if i == 0:
                y = conv_bn(p, f"{b}.downsample.0", f"{b}.downsample.1", y, stride, 0, ctx,
                            relu=False)
            y = F.relu(out + y)
    return y


# ---------------------------------------------------------------- audio


def log_power_stft(wave: torch.Tensor, audio: dict, ctx: Context) -> torch.Tensor:
    """(R, L) waveform -> (R, 1, n_fft // 2 + 1, frames) float32."""
    sr = audio["sampling_rate"]
    win = int(round(audio["window_ms"] * sr / 1e3))
    hop = int(round(audio["hop_ms"] * sr / 1e3))
    n_fft = audio["n_fft"]
    window = torch.hann_window(win, periodic=True, dtype=torch.float64, device=wave.device)
    spec = torch.stft(ctx.prec(wave).double(), n_fft, hop, win, window, center=True,
                      pad_mode="constant", return_complex=True)
    power = spec.real.square() + spec.imag.square()
    return torch.log(power + audio["eps"]).float()[:, None]


# ---------------------------------------------------------------- attention


def positional_block(p: dict, seq: torch.Tensor, groups: int, ctx: Context) -> torch.Tensor:
    """(R, S, C) -> concat the table, 1x1 conv, GroupNorm -> (R, S, C)."""
    r, s, _ = seq.shape
    table = p["pe.0.pe"][0, :, :s].T
    h = torch.cat([seq, table[None].expand(r, s, table.shape[1])], dim=-1)
    h = linear(h, p["pe.1.weight"][:, :, 0], p["pe.1.bias"], ctx)
    g = h.reshape(r, s, groups, -1)
    mean = g.mean(dim=(1, 3), keepdim=True)
    var = g.var(dim=(1, 3), unbiased=False, keepdim=True)
    h = ((g - mean) * torch.rsqrt(var + GN_EPS)).reshape(r, s, -1)
    return h * p["pe.2.weight"] + p["pe.2.bias"]


def attention(p: dict, query: torch.Tensor, seq: torch.Tensor, heads: int, rate: float,
              ctx: Context):
    """One query (R, E) over (R, S, E) -> (R, E) and (R, S) weights."""
    pre = "attention_layer.attention_layer"
    r, s, e = seq.shape
    wq, wk, wv = p[f"{pre}.in_proj_weight"].chunk(3)
    bq, bk, bv = p[f"{pre}.in_proj_bias"].chunk(3)
    hd = e // heads
    q = linear(query, wq, bq, ctx).reshape(r, heads, 1, hd)
    k = linear(seq, wk, bk, ctx).reshape(r, s, heads, hd).transpose(1, 2)
    v = linear(seq, wv, bv, ctx).reshape(r, s, heads, hd).transpose(1, 2)
    scores = (ctx.prec(q) @ ctx.prec(k).transpose(-1, -2))[:, :, 0] / math.sqrt(hd)
    probs = dropout(torch.softmax(scores, dim=-1), rate, ctx)  # (R, heads, S)
    out = (ctx.prec(probs)[:, :, None] @ ctx.prec(v))[:, :, 0].reshape(r, e)
    out = linear(out, p[f"{pre}.out_proj.weight"], p[f"{pre}.out_proj.bias"], ctx)
    return out, probs.mean(dim=1)


# ---------------------------------------------------------------- model


def forward(p: dict, desc: dict, batch: dict, ctx: Context) -> Dict[str, torch.Tensor]:
    """``batch``: {modality: (B, N, ...)} as the module docstring says ->
    {head: (B, classes) logits, "weights": (B * N, 1, S) where the audio
    attends}."""
    features, weights = [], None
    b = n = None
    for m in desc["modality"]:
        x = batch[m]
        b, n = x.shape[:2]
        if m == "Audio":
            x = log_power_stft(x.reshape(b * n, -1).float(), desc["audio"], ctx)
        else:
            mean = torch.tensor(desc[f"{m.lower()}_mean"], device=x.device)
            std = torch.tensor(desc[f"{m.lower()}_std"], device=x.device)
            c = x.shape[-1]
            mean, std = mean.repeat(c // mean.numel()), std.repeat(c // std.numel())
            x = x.reshape((b * n,) + x.shape[2:]).permute(0, 3, 1, 2).float()
            x = (x / 255.0 - mean[:, None, None]) / std[:, None, None]
        tower = f"Base_{m}"
        if desc["arch"] == "bninception":
            y = bninception(p, tower, x, ctx)
        else:
            y = resnet(p, tower, x, desc["resnet_depth"], ctx)
        if m == "Audio" and attends(desc):
            att = desc["attention"]
            seq = y.mean(dim=2).transpose(1, 2)  # (R, T, C): frequency pooled
            if seq.shape[1] != att["window"]:
                raise ValueError(f"audio sequence of {seq.shape[1]}, window {att['window']}")
            seq = positional_block(p, seq, att["pe_groups"], ctx)
            feature, weights = attention(p, features[0], seq, att["heads"], att["dropout"], ctx)
        else:
            feature = y.mean(dim=(2, 3))
        features.append(feature)
    fused = torch.cat(features, dim=-1)
    if len(features) > 1:  # one modality has no Fusion
        fused = F.relu(linear(fused, p["fusion.fusion_layer.0.weight"],
                              p["fusion.fusion_layer.0.bias"], ctx))
        fused = dropout(fused, desc["fusion_dropout"], ctx)
    out = {}
    for head in desc["num_classes"]:
        logits = linear(fused, p[f"classifier.{head}.weight"], p[f"classifier.{head}.bias"], ctx)
        out[head] = logits.reshape(b, n, -1).mean(dim=1)
    if weights is not None:
        out["weights"] = weights[:, None]
    return out


def forward_in_blocks(p: dict, desc: dict, batch: dict, rows: int,
                      prec: Precision = FLOAT32) -> Dict[str, torch.Tensor]:
    """The eval forward over ``batch`` in blocks of ``rows`` samples, so
    that a large request fits beside nothing else; no gradient."""
    total = next(iter(batch.values())).shape[0]
    parts = []
    with torch.no_grad():
        for start in range(0, total, rows):
            block = {k: v[start:start + rows] for k, v in batch.items()}
            parts.append(forward(p, desc, block, Context(prec=prec)))
    return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}

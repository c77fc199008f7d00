"""BN-Inception feature tower, NCHW.

Port of the JAX package's ``models/bn_inception.py``: the public
Inception-BN graph the reference takes from ``pretrainedmodels``

    stem: 7x7/2 conv(64) -> maxpool/2 -> 1x1 conv(64) -> 3x3 conv(192) -> maxpool/2
    inception 3a 3b | 3c(/2) | 4a 4b 4c 4d | 4e(/2) | 5a 5b -> global avg pool

with torch ``ceil_mode`` pools. Every conv is followed by BatchNorm and
ReLU. At eval the BatchNorm folds into the conv (layers.FoldCache); in
training (``.train()``) it runs on live batch statistics in float32 and
updates the running statistics (layers.batch_norm_train), with a per-row
mask that keeps a loader's pad rows out of them. The conv bias cancels
through live BatchNorm, so in training the conv runs without it and the
running mean records it, as the JAX package does (its bias gradient is
then None rather than zero: the optimizer reads it as zero). Statistics
keep updating under ``partialbn``, which only freezes affine parameters in
the optimizer.

``pool_impl`` (``tpu.pool_impl``) and ``pool_fast_vjp``
(``tpu.pool_fast_vjp``) go to every max pool (ops/pooling.max_pool2d);
with "pallas" the four 3x3 / stride-2 ceil pools (stem pool1 and pool2,
the passthrough of inception 3c and 4e) run the hand-written kernel on a
CUDA tensor; ``pool_fast_vjp`` gives every pool the kernel does not take
the JAX package's all-ties gradient in training.

``fused_stem`` (``tpu.fused_stem``): at eval, a 7x7 stem on an input whose
H and W are multiples of 4 runs normalize -> conv -> BN -> ReLU -> pool1 as
one kernel (ops/kernels.fused_stem), on the conv's BN-folded float32
weights rounded to the compute type and a float32 bias, as the JAX package
gates it (bn_inception.py:563-589). Training, the audio stem and other
shapes keep the regular stem and pool1.

``quantize`` (``tpu.quantize``, eval only; training ignores it, as the
JAX package does): "calibrate" runs the float eval and records the running
max of |x| at each of the tower's 42 int8 sites (:data:`QUANT_SITES`, the
JAX package's quant_stats paths) into a non-persistent buffer; "int8" runs
the JAX package's quantized ``_fused_eval`` (bn_inception.py:349-476) on
the int8 kernels (layers.quantize_site, layers.qconv_site): conv2_3x3_reduce
and conv2_3x3, and in each block one merged 1x1 conv over the block input
in the JAX column order [pool_proj / 9 (bias-free; avg blocks) | 1x1 |
3x3_reduce | double_3x3_reduce], the three 3x3 convs, the avg branch as the
9-tap sum of its projection (project first, pool after: under int8 the two
orders quantize different tensors) + bias + ReLU, and inception_5b's max
branch proj on the pooled input with the block's in_amax. The int8
activations are channels-last: each block writes one channels-last output
buffer, every branch's last site into its channel slice (no concatenation),
and a tensor that only the next int8 site reads (conv2_3x3's input, each
block's 3x3 and double_3x3_1 inputs from the merged 1x1, double_3x3_2's) is
quantized in the epilogue of the qconv that produces it: 12 standalone
quantizes and 43 convolutions a tower. The stem stays float and the fused
stem off. An int8 forward without calibrated amaxes raises; the buffers
stay out of the state dict.

Modules are flat attributes named as in the reference state dict
(``conv1_7x7_s2`` + ``conv1_7x7_s2_bn``, ``inception_3a_1x1`` + ``..._bn``),
so weights in the reference ``.pth`` layout load with ``strict=True``.

Head variants (reference bn_inception.py:16-35): global average pool ->
(B, 1024); ``freq_pool_only`` (audio tower under attention) pools the
frequency axis only -> (B, T, 1024). ``audio_stem`` replaces the 7x7 stem
with two parallel stride-2 convs, (3,1) and (1,3), concatenated to 64
channels (reference bn_inception_audio.py:11-23; the reference's "1x3" conv
has a (3,1) kernel and vice versa).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import kernels
from ..ops.kernels import fused_stem, fused_stem_shape_error
from ..ops.pooling import avg_pool2d, global_avg_pool, max_pool2d
from .layers import (BN_EPSILON, QUANT_MODES, CastCache, FoldCache, batch_norm_train,
                     channels_last, conv_bn_sources, exact_div, fold, nhwc, qconv_operands,
                     qconv_site, quantize_site, record_amax, variance_scaling_)


@dataclass(frozen=True)
class InceptionSpec:
    """Channel widths of one Inception-BN block."""

    b1x1: int  # 1x1 branch (0 = reduction block, branch absent)
    r3x3: int  # 3x3 branch reduce
    b3x3: int  # 3x3 branch out
    rd3x3: int  # double-3x3 branch reduce
    d3x3: int  # double-3x3 branch out (both convs)
    proj: int  # pool-projection out (0 = passthrough max pool)
    pool: str  # "avg" or "max" pool branch
    stride: int = 1


# Standard Inception-BN configuration. Output channels:
# 3a 256, 3b 320, 3c 576, 4a-4b 576, 4c-4d 608, 4e 1056, 5a-5b 1024.
BN_INCEPTION_BLOCKS: Tuple[Tuple[str, InceptionSpec], ...] = (
    ("inception_3a", InceptionSpec(64, 64, 64, 64, 96, 32, "avg")),
    ("inception_3b", InceptionSpec(64, 64, 96, 64, 96, 64, "avg")),
    ("inception_3c", InceptionSpec(0, 128, 160, 64, 96, 0, "max", stride=2)),
    ("inception_4a", InceptionSpec(224, 64, 96, 96, 128, 128, "avg")),
    ("inception_4b", InceptionSpec(192, 96, 128, 96, 128, 128, "avg")),
    ("inception_4c", InceptionSpec(160, 128, 160, 128, 160, 128, "avg")),
    ("inception_4d", InceptionSpec(96, 128, 192, 160, 192, 128, "avg")),
    ("inception_4e", InceptionSpec(0, 128, 192, 192, 256, 0, "max", stride=2)),
    ("inception_5a", InceptionSpec(352, 192, 320, 160, 224, 128, "avg")),
    ("inception_5b", InceptionSpec(352, 192, 320, 192, 224, 128, "max")),
)

FEATURE_SIZE = 1024

# The int8 sites of a tower (``tpu.quantize``) by their path under the tower
# in the JAX package's quant_stats tree: one amax per conv2 cell, four per
# block. The stem is never quantized.
BLOCK_QUANT_SITES = ("in_amax", "r3_amax", "rd_amax", "d_amax")
QUANT_SITES = ("conv2_3x3_reduce/amax", "conv2_3x3/amax") + tuple(
    f"{name}/{site}" for name, _ in BN_INCEPTION_BLOCKS for site in BLOCK_QUANT_SITES)


def quant_buffer(site: str) -> str:
    """The tower's (non-persistent) buffer of a quant_stats site."""
    return "quant_" + site.replace("/", "_")


class BNInception(nn.Module):
    """BN-Inception tower; ``forward`` runs the eval graph or, in training
    mode, the train graph."""

    feature_size = FEATURE_SIZE

    def __init__(self, in_channels: int, freq_pool_only: bool = False,
                 audio_stem: bool = False, pool_impl: str = "reduce_window",
                 fused_stem: bool = False, pool_fast_vjp: bool = False, quantize: str = ""):
        super().__init__()
        if quantize not in QUANT_MODES:
            raise ValueError(f"Unknown quantize mode {quantize!r}")
        self.quantize = quantize
        self.freq_pool_only = freq_pool_only
        self.audio_stem = audio_stem
        self.pool_impl = pool_impl
        self.pool_fast_vjp = pool_fast_vjp
        self.fused_stem = fused_stem
        self._folded = FoldCache()
        self._quantized = CastCache()  # int8 operands per site and source version
        if audio_stem:
            self._conv_bn("conv1_1x3_s2", in_channels, 32, (3, 1), 2, (1, 0))
            self._conv_bn("conv1_3x1_s2", in_channels, 32, (1, 3), 2, (0, 1))
        else:
            self._conv_bn("conv1_7x7_s2", in_channels, 64, 7, 2, 3)
        self._conv_bn("conv2_3x3_reduce", 64, 64, 1)
        self._conv_bn("conv2_3x3", 64, 192, 3, 1, 1)
        cin = 192
        for name, s in BN_INCEPTION_BLOCKS:
            if s.b1x1:
                self._conv_bn(f"{name}_1x1", cin, s.b1x1, 1)
            self._conv_bn(f"{name}_3x3_reduce", cin, s.r3x3, 1)
            self._conv_bn(f"{name}_3x3", s.r3x3, s.b3x3, 3, s.stride, 1)
            self._conv_bn(f"{name}_double_3x3_reduce", cin, s.rd3x3, 1)
            self._conv_bn(f"{name}_double_3x3_1", s.rd3x3, s.d3x3, 3, 1, 1)
            self._conv_bn(f"{name}_double_3x3_2", s.d3x3, s.d3x3, 3, s.stride, 1)
            if s.proj:
                self._conv_bn(f"{name}_pool_proj", cin, s.proj, 1)
            cin = s.b1x1 + s.b3x3 + s.d3x3 + (s.proj if s.proj else cin)

    def _conv_bn(self, name, cin, cout, kernel, stride=1, padding=0):
        self.add_module(name, nn.Conv2d(cin, cout, kernel, stride, padding))
        self.add_module(f"{name}_bn", nn.BatchNorm2d(cout, eps=BN_EPSILON))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX package's init: fan-out truncated-normal conv kernels,
        zero biases, identity BatchNorm."""
        for module in self.children():
            if isinstance(module, nn.Conv2d):
                variance_scaling_(module.weight, 2.0, "fan_out", generator)
                module.bias.zero_()
            elif isinstance(module, nn.BatchNorm2d):
                module.reset_parameters()

    def _cbr(self, name: str, x: torch.Tensor,
             row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Conv + BN + ReLU, computed in x's dtype: BN folded into the conv at
        eval, live float32 BN in training."""
        conv, bn = getattr(self, name), getattr(self, f"{name}_bn")
        if self.training:
            y = F.conv2d(x, conv.weight.to(x.dtype), None, conv.stride, conv.padding)
            return F.relu(batch_norm_train(y, bn, conv.bias, row_mask).to(x.dtype))
        w, b = self._folded.get(name, conv, bn, x.dtype)
        # in place: the conv's backward needs its input and weight, not its output
        return F.relu(F.conv2d(x, w, b, conv.stride, conv.padding), inplace=True)

    def uses_fused_stem(self, x: torch.Tensor) -> bool:
        """Whether the fused stem takes NCHW ``x`` in the current mode (not
        under ``quantize``, as in the JAX package)."""
        return (self.fused_stem and not self.training and not self.audio_stem
                and not self.quantize and not fused_stem_shape_error(x.permute(0, 2, 3, 1)))

    # ---------------------------------------------------------- int8 sites

    def _mode(self) -> str:
        """This forward's quantize mode: training ignores it."""
        return "" if self.training else self.quantize

    def quant_stats(self) -> Dict[str, torch.Tensor]:
        """{site: amax} of the recorded sites of :data:`QUANT_SITES`."""
        return {site: self._buffers[quant_buffer(site)] for site in QUANT_SITES
                if quant_buffer(site) in self._buffers}

    @torch.no_grad()
    def set_quant_stat(self, site: str, amax) -> None:
        """Set one site's amax (a float32 scalar on the tower's device)."""
        if site not in QUANT_SITES:
            raise KeyError(f"{site!r} is not an int8 site of BN-Inception")
        value = torch.tensor(float(amax), dtype=torch.float32)
        name = quant_buffer(site)
        if name in self._buffers:
            self._buffers[name].copy_(value)
        else:
            device = self.conv2_3x3.weight.device
            self.register_buffer(name, value.to(device).clone(), persistent=False)

    def _record(self, site: str, x: torch.Tensor) -> None:
        """Under "calibrate", fold max |x| into the site's running amax."""
        if self._mode() != "calibrate":
            return
        name = quant_buffer(site)
        if name not in self._buffers:
            self.register_buffer(name, torch.zeros((), device=x.device), persistent=False)
        record_amax(self._buffers[name], x)

    def _q_operands(self, key: str, cells: Sequence[str], site: str, proj_first: bool = False):
        """The int8 operands of the site that convolves with ``cells``' float32
        folds concatenated along the output channels, at ``site``'s scale;
        ``proj_first``: the first cell is the avg branch's proj, taken / 9
        and bias-free (its bias is added after the 9-tap sum). Cached per
        version of every source (the amax included)."""
        amax = self._buffers.get(quant_buffer(site))
        if amax is None:
            raise ValueError(f"tpu.quantize=int8: no quant_stats for {site}: run "
                             "models.tbn.calibrate_quantization before the int8 forward")
        pairs = [(getattr(self, c), getattr(self, f"{c}_bn")) for c in cells]
        sources = tuple(t for conv, bn in pairs for t in conv_bn_sources(conv, bn))

        def make(*tensors):
            folds = [fold(*tensors[6 * i:6 * i + 6], bn.eps) for i, (_, bn) in enumerate(pairs)]
            if proj_first:
                kproj, bproj = folds[0]
                folds[0] = (exact_div(kproj, 9.0), torch.zeros_like(bproj))
            return qconv_operands(folds, tensors[-1])

        return self._quantized.derive(key, sources + (amax,), torch.float32, make)

    def _cell_operands(self, cell: str, site: str):
        """The int8 operands of one unmerged cell at ``site``'s scale."""
        return self._q_operands(cell, (cell,), site)

    def _qcell(self, name: str, xq: torch.Tensor, dtype: torch.dtype,
               next_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
        """A conv2 cell at int8 on its int8 NHWC input: conv + BN folded +
        ReLU, the (B, C, H, W) channels-last output in ``dtype``; or, with
        ``next_scale``, that output quantized for the next site in the
        epilogue, int8 NHWC (its float copy never written)."""
        conv = getattr(self, name)
        operands = self._cell_operands(name, f"{name}/amax")
        stride, padding = conv.stride[0], conv.padding[0]
        b, ho, wo, c = kernels.qconv_output_shape(xq, operands[0], stride, padding)
        if next_scale is not None:
            out = xq.new_empty((b, ho, wo, c))
            qconv_site(xq, operands, stride, padding, dtype, [(out, next_scale)])
            return out
        out = channels_last((b, c, ho, wo), dtype, xq.device)
        qconv_site(xq, operands, stride, padding, dtype, [(nhwc(out), None)])
        return out

    def _qcbr(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """A conv2 cell at int8 on float NCHW ``x``: quantize, conv + BN
        folded + ReLU, the float output (channels-last)."""
        xq = quantize_site(x, self._cell_operands(name, f"{name}/amax")[3])
        return self._qcell(name, xq, x.dtype)

    def _qconv2(self, x: torch.Tensor) -> torch.Tensor:
        """conv2_3x3_reduce -> conv2_3x3 at int8 on float NCHW ``x``: the
        reduce's output quantized for conv2_3x3 in its epilogue."""
        reduce, conv = "conv2_3x3_reduce", "conv2_3x3"
        xq = quantize_site(x, self._cell_operands(reduce, f"{reduce}/amax")[3])
        rq = self._qcell(reduce, xq, x.dtype, self._cell_operands(conv, f"{conv}/amax")[3])
        return self._qcell(conv, rq, x.dtype)

    def _proj_sum(self, name: str, proj: torch.Tensor, out: torch.Tensor) -> None:
        """The avg branch after the merged conv, into ``out`` (the block
        output's channel slice): the 9-tap zero-padded sum of its / 9
        projection in the compute dtype, in the JAX package's tap order
        (ops/pooling.py:_pool_via_slices), + the proj's float32 fold bias
        rounded to the dtype, ReLU."""
        cell = f"{name}_pool_proj"
        _, bias = self._folded.get(f"{cell}/bias", getattr(self, cell),
                                   getattr(self, f"{cell}_bn"), torch.float32, proj.dtype)
        h, w = proj.shape[2:]
        padded = F.pad(proj, (1, 1, 1, 1))
        total = None
        for dy in range(3):
            for dx in range(3):
                tap = padded[:, :, dy:dy + h, dx:dx + w]
                total = tap if total is None else total + tap
        torch.clamp_min(total + bias.view(1, -1, 1, 1), 0.0, out=out)

    def _qblock(self, name: str, s: InceptionSpec, x: torch.Tensor) -> torch.Tensor:
        """One block at int8 (the JAX package's quantized _fused_eval) on
        float NCHW ``x``. The block's output is one channels-last buffer;
        each branch's last site writes its channel slice (no concatenation),
        and the merged 1x1's reduce columns and double_3x3_1 are quantized
        for their one consumer in the epilogue."""
        merge_proj = bool(s.proj) and s.pool == "avg"
        cells = [f"{name}_{c}" for c in (["pool_proj"] if merge_proj else [])
                 + (["1x1"] if s.b1x1 else []) + ["3x3_reduce", "double_3x3_reduce"]]
        dtype = x.dtype
        merged = self._q_operands(f"{name}/in", cells, f"{name}/in_amax", merge_proj)
        ops = {cell: self._cell_operands(f"{name}_{cell}", f"{name}/{site}")
               for cell, site in (("3x3", "r3_amax"), ("double_3x3_1", "rd_amax"),
                                  ("double_3x3_2", "d_amax"))}
        b, c_in, h, w = x.shape
        ho, wo = (kernels.qconv_out_size(v, 3, s.stride, 1) for v in (h, w))
        ends = [s.b1x1, s.b1x1 + s.b3x3, s.b1x1 + s.b3x3 + s.d3x3]
        out = channels_last((b, ends[-1] + (s.proj or c_in), ho, wo), dtype, x.device)
        o = nhwc(out)

        xq = quantize_site(x, merged[3])
        r3, rd = (xq.new_empty((b, h, w, c)) for c in (s.r3x3, s.rd3x3))
        proj = x.new_empty((b, h, w, s.proj)) if merge_proj else None
        segments = ([(proj, None)] if merge_proj else []) + (
            [(o[..., :ends[0]], None)] if s.b1x1 else []) + [
            (r3, ops["3x3"][3]), (rd, ops["double_3x3_1"][3])]
        qconv_site(xq, merged, 1, 0, dtype, segments, relu_from=s.proj if merge_proj else 0)
        qconv_site(r3, ops["3x3"], s.stride, 1, dtype, [(o[..., ends[0]:ends[1]], None)])
        d = xq.new_empty((b, h, w, s.d3x3))
        qconv_site(rd, ops["double_3x3_1"], 1, 1, dtype, [(d, ops["double_3x3_2"][3])])
        qconv_site(d, ops["double_3x3_2"], s.stride, 1, dtype, [(o[..., ends[1]:ends[2]], None)])
        if merge_proj:
            self._proj_sum(name, proj.permute(0, 3, 1, 2), out[:, ends[2]:])
        elif s.proj:
            # the max branch: a 3x3 / stride-1 max pool covers every element,
            # so amax(pooled) == amax(x): the proj takes the block's in_amax
            cell = f"{name}_pool_proj"
            operands = self._cell_operands(cell, f"{name}/in_amax")
            pq = quantize_site(self._max_pool(x, 1, 1), operands[3])
            qconv_site(pq, operands, 1, 0, dtype, [(o[..., ends[2]:], None)])
        else:
            out[:, ends[2]:].copy_(self._max_pool(x, s.stride, 0))
        return out

    def _fused_stem(self, x: torch.Tensor, dtype: torch.dtype,
                    input_scale: Optional[torch.Tensor],
                    input_offset: Optional[torch.Tensor]) -> torch.Tensor:
        """Stem + pool1 of NCHW ``x`` (raw uint8 with its affine, or float)
        in one kernel; the tower's input is NHWC memory, read as it lies."""
        conv, bn = self.conv1_7x7_s2, self.conv1_7x7_s2_bn
        w, b = self._folded.get("conv1_7x7_s2/fused", conv, bn, dtype, torch.float32)
        if input_scale is None:
            input_scale = torch.ones(x.shape[1], device=x.device)
            input_offset = torch.zeros(x.shape[1], device=x.device)
        return fused_stem(x.permute(0, 2, 3, 1).contiguous(), w, b, input_scale, input_offset,
                          dtype)

    def _max_pool(self, x: torch.Tensor, stride: int, padding: int) -> torch.Tensor:
        return max_pool2d(x, 3, stride, padding, ceil_mode=True, impl=self.pool_impl,
                          fast_vjp=self.pool_fast_vjp)

    def _block(self, name: str, s: InceptionSpec, x: torch.Tensor,
               row_mask: Optional[torch.Tensor]) -> torch.Tensor:
        if self._mode() == "int8":
            return self._qblock(name, s, x)

        def cbr(cell, inp):
            return self._cbr(f"{name}_{cell}", inp, row_mask)

        def record(site, inp):
            self._record(f"{name}/{site}", inp)
            return inp

        branches = []
        record("in_amax", x)
        if s.b1x1:
            branches.append(cbr("1x1", x))
        branches.append(cbr("3x3", record("r3_amax", cbr("3x3_reduce", x))))
        d = record("d_amax", cbr("double_3x3_1", record("rd_amax", cbr("double_3x3_reduce", x))))
        branches.append(cbr("double_3x3_2", d))
        if s.proj:
            if s.pool == "avg":
                pooled = avg_pool2d(x, 3, 1, 1, ceil_mode=True, count_include_pad=True)
            else:
                pooled = self._max_pool(x, 1, 1)
            branches.append(cbr("pool_proj", pooled))
        else:
            branches.append(self._max_pool(x, s.stride, 0))
        return torch.cat(branches, dim=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                input_scale: Optional[torch.Tensor] = None,
                input_offset: Optional[torch.Tensor] = None,
                row_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW input -> features in ``dtype``.

        (input_scale, input_offset): per-channel affine that normalizes a raw
        uint8 input, applied in ``dtype`` before the stem's zero padding.
        ``row_mask``: 0/1 per row, training only; zero rows are left out of
        every BatchNorm statistic."""
        if self.uses_fused_stem(x):
            y = self._fused_stem(x, dtype, input_scale, input_offset)
        else:
            x = x.to(dtype)
            if input_scale is not None:
                x = (x * input_scale.to(dtype)[:, None, None]
                     + input_offset.to(dtype)[:, None, None])
            if self.audio_stem:
                y = torch.cat([self._cbr("conv1_1x3_s2", x, row_mask),
                               self._cbr("conv1_3x1_s2", x, row_mask)], dim=1)
            else:
                y = self._cbr("conv1_7x7_s2", x, row_mask)
            y = self._max_pool(y, 2, 0)
        self._record("conv2_3x3_reduce/amax", y)
        if self._mode() == "int8":
            y = self._qconv2(y)
        else:
            y = self._cbr("conv2_3x3_reduce", y, row_mask)
            self._record("conv2_3x3/amax", y)
            y = self._cbr("conv2_3x3", y, row_mask)
        y = self._max_pool(y, 2, 0)
        for name, s in BN_INCEPTION_BLOCKS:
            y = self._block(name, s, y, row_mask)
        return global_avg_pool(y, freq_only=self.freq_pool_only)

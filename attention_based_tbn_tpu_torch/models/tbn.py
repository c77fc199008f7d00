"""The Temporal Binding Network's forward in PyTorch, eval and training.

Port of the JAX package's ``models/tbn.py`` (reference
core/models/model.py:205-262):

* per-modality towers (``model.arch``: BN-Inception, ResNet or VGG) run on
  the (batch * segments) folded batch; the audio waveform becomes a log
  spectrogram inside the forward;
* the audio feature is reduced with fixed prior weights, or attended with
  the first modality's feature as query (MHA / unimodal / prototype);
* under 10-crop the audio rows are tiled to the visual crop rows;
* features concat -> Fusion(512) when multimodal -> per-class heads ->
  segment consensus = mean of the logits over segments (with
  ``fast_consensus``, the mean of the features before the heads; with the
  kernels on, both in one ``consensus_heads`` launch at eval).

``tpu.quantize`` (BN-Inception at eval): :func:`calibrate_quantization`
records each int8 site's amax over a few batches, then a model with
``quantize="int8"`` runs its towers' convolutions after the stem on the
int8 kernels (models/bn_inception.py). ``tpu.remat`` recomputes each
tower's training forward in the backward instead of keeping its
activations (layers.rematerialized).

In training (``.train()``) the towers run live BatchNorm, the attention
block its plain compositions with dropout / gumbel noise, Fusion its
dropout, and the audio feature its batch-wide dropout; every draw comes
from the ``torch.Generator`` passed to ``forward``. ``true_batch`` (the
true batch size of a padded batch) becomes a per-row mask that keeps pad
rows out of every BatchNorm statistic.

Inputs keep the JAX package's layouts: RGB (B, N, H, W, 3) and Flow
(B, N, H, W, 2*win), uint8 or float; Audio waveform (B, N, L) or
spectrogram (B, N, F, T, 1); fixed prior weights (B, N, W, 1). Inside the
towers activations are NCHW.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch
import torch.nn as nn

from ..data.priors import attention_window_size
from ..ops.kernels import consensus_heads
from ..ops.pooling import POOL_IMPLS
from ..ops.spectrogram import spectrogram
from ..parallel import mesh
from ..utils.device import tf32_scope
from .attention import MHAttention, PositionalEncoding, PrototypeAttention, UniModalAttention
from .bn_inception import FEATURE_SIZE, BNInception
from .heads import Classifier, Fusion
from .layers import QUANT_MODES, CastCache, compute_dtype, rematerialized
from .resnet import RESNET_CONFIGS, ResNet
from .vgg import VGG, VGG_CONFIGS, vgg_base_type

ARCHS = ("bninception", "resnet", "vgg")


def tile_crop_rows(feature: torch.Tensor, b: int, reps: int) -> torch.Tensor:
    """Broadcast per-(sample, segment) rows to ``reps`` crop rows.

    Visual streams under 10-crop eval are crop-major within each sample:
    row = loc*2N + seg*2 + flip. Audio carries one row per segment; this
    sends row (b, seg) to its ``reps`` crop rows so Fusion pairs matching
    segments. Works on any trailing shape."""
    n_seg = feature.shape[0] // b
    trailing = feature.shape[1:]
    if reps % 2 == 0:  # ten-crop style: (loc, seg, flip) row order
        out = feature.reshape((b, 1, n_seg, 1) + trailing).expand(
            (b, reps // 2, n_seg, 2) + trailing
        )
    else:  # plain per-sample repeat
        out = feature.reshape((b, 1, n_seg) + trailing).expand((b, reps, n_seg) + trailing)
    return out.reshape((b * reps * n_seg,) + trailing)


@dataclass(frozen=True)
class TBNSpec:
    """Model configuration the forward reads from the config tree."""

    modality: Tuple[str, ...] = ("RGB", "Flow", "Audio")
    arch: str = "bninception"
    num_classes: Tuple[Tuple[str, int], ...] = (("verb", 125), ("noun", 352))
    attention_enable: bool = True
    attention_type: str = "mha"
    use_pe: bool = True
    use_fixed: bool = False
    use_gumbel: bool = True
    attn_heads: int = 4
    attn_dropout: float = 0.5
    attn_win: int = 13
    # the reference's inverted polarity: uniform() > audio_dropout DROPS
    audio_dropout: float = 0.0
    fusion_dropout: float = 0.5
    # Modalities whose tower uses the two-branch (3,1)/(1,3) audio stem.
    audio_stem: Tuple[str, ...] = ()
    resnet_depth: int = 101
    vgg_type: str = "16"
    flow_win_length: int = 5
    spec_type: str = "stft"
    sampling_rate: int = 24000
    compute_dtype: str = "float32"
    # Run the hand-written kernels (tpu.use_pallas).
    use_pallas: bool = False
    # Max-pool lowering (tpu.pool_impl, ops/pooling.POOL_IMPLS): "pallas"
    # runs the towers' stride-2 ceil pools on the hand-written kernel.
    pool_impl: str = "reduce_window"
    # tpu.pool_fast_vjp: on an exact tie every maximal input of a max pool
    # window takes the window's gradient (ops/pooling.MaxPoolAllTies).
    pool_fast_vjp: bool = False
    # Average features before the heads instead of logits after them (same
    # math: consensus commutes with the linear heads). With use_pallas, the
    # eval forward runs mean and heads as one kernel (consensus_heads).
    fast_consensus: bool = False
    # Eval stem + pool1 of the 7x7 towers as one kernel (tpu.fused_stem).
    fused_stem: bool = False
    # tpu.quantize: "" | "calibrate" | "int8" (BN-Inception at eval; see
    # calibrate_quantization). Drivers refuse it (models/builder.py).
    quantize: str = ""
    # tpu.merge_inception: the JAX package's merged 1x1 lowering. The port's
    # float eval computes the same math unmerged either way; the int8 path
    # merges, and quantize requires the key on, as the JAX package does.
    merge_inception: bool = True
    # tpu.remat: rematerialize each tower in the backward pass.
    remat: bool = False
    # RGB mean is BGR-ordered, matching the reference's BGR decode.
    rgb_mean: Tuple[float, ...] = (0.408, 0.459, 0.502)
    rgb_std: Tuple[float, ...] = (1.0, 1.0, 1.0)
    flow_mean: Tuple[float, ...] = (0.502,)
    flow_std: Tuple[float, ...] = (1.0,)

    @classmethod
    def from_config(cls, cfg, modality) -> "TBNSpec":
        att = cfg.model.attention
        return cls(
            modality=tuple(modality),
            arch=cfg.model.arch,
            num_classes=tuple(cfg.model.num_classes.items()),
            attention_enable=bool(att.enable),
            attention_type=att.type,
            use_pe=bool(att.use_pe),
            use_fixed=bool(att.use_fixed),
            use_gumbel=bool(att.use_gumbel),
            attn_heads=int(att.attn_heads),
            attn_dropout=float(att.attn_dropout),
            attn_win=attention_window_size(cfg.data.audio.audio_length),
            audio_dropout=float(cfg.data.audio.dropout),
            fusion_dropout=float(cfg.model.fusion_dropout),
            audio_stem=("Audio",) if cfg.get_path("model.bninception.audio_stem", False) else (),
            resnet_depth=int(cfg.model.resnet.depth),
            vgg_type=str(cfg.model.vgg.type),
            rgb_mean=tuple(cfg.data.rgb.mean),
            rgb_std=tuple(cfg.data.rgb.std),
            flow_mean=tuple(cfg.data.flow.mean),
            flow_std=tuple(cfg.data.flow.std),
            flow_win_length=int(cfg.data.flow.win_length),
            spec_type=cfg.data.audio.spec_type,
            sampling_rate=int(cfg.data.audio.sampling_rate),
            compute_dtype=cfg.get_path("tpu.compute_dtype", "float32") or "float32",
            use_pallas=bool(cfg.get_path("tpu.use_pallas", False)),
            pool_impl=str(cfg.get_path("tpu.pool_impl", "reduce_window") or "reduce_window"),
            pool_fast_vjp=bool(cfg.get_path("tpu.pool_fast_vjp", False)),
            fast_consensus=bool(cfg.get_path("tpu.fast_consensus", False)),
            fused_stem=bool(cfg.get_path("tpu.fused_stem", False)),
            quantize=str(cfg.get_path("tpu.quantize", "") or ""),
            merge_inception=bool(cfg.get_path("tpu.merge_inception", True)),
            remat=bool(cfg.get_path("tpu.remat", False)),
        )

    @property
    def multimodal(self) -> bool:
        return len(self.modality) > 1

    @property
    def audio_attends(self) -> bool:
        """Audio tower keeps its temporal axis (freq-only pooling)."""
        return "Audio" in self.modality and self.attention_enable

    @property
    def learned_attention(self) -> bool:
        return self.audio_attends and not self.use_fixed

    def validate(self) -> None:
        if self.arch not in ARCHS:
            raise ValueError(f"Unknown arch {self.arch!r}")
        if self.arch == "resnet" and self.resnet_depth not in RESNET_CONFIGS:
            raise ValueError(f"model.resnet.depth={self.resnet_depth} not in "
                             f"{sorted(RESNET_CONFIGS)}")
        if self.arch == "vgg" and vgg_base_type(self.vgg_type) not in VGG_CONFIGS:
            raise ValueError(f"model.vgg.type={self.vgg_type!r}: the base type must be one of "
                             f"{sorted(VGG_CONFIGS)}")
        if self.attention_enable and not self.use_fixed and self.modality == ("Audio",):
            raise ValueError(
                "learned attention needs a visual query modality; "
                "audio-only supports attention.use_fixed only"
            )
        if self.attention_enable and "Audio" in self.modality and self.arch != "bninception":
            # only the BN-Inception audio tower keeps its temporal axis; the
            # JAX package's error (models/tbn.py:214-225)
            raise ValueError(
                "audio attention requires arch=bninception "
                "(resnet/vgg towers have no temporal feature axis)"
            )
        if self.attention_enable and self.attention_type not in ("mha", "unimodal", "proto"):
            raise ValueError(f"Unknown attention type {self.attention_type!r}")
        if self.pool_impl not in POOL_IMPLS:
            # a misspelt tpu.pool_impl must not fall through to the plain pool
            raise ValueError(f"Unknown pool_impl {self.pool_impl!r}; expected one of {POOL_IMPLS}")
        # the JAX package's checks and messages (models/tbn.py:242-251)
        if self.quantize not in QUANT_MODES:
            raise ValueError(f"Unknown quantize mode {self.quantize!r}")
        if self.quantize:
            if self.arch != "bninception":
                raise ValueError("tpu.quantize supports arch=bninception only")
            if not self.merge_inception:
                raise ValueError(
                    "tpu.quantize requires the merged inception lowering "
                    "(tpu.merge_inception=true)"
                )
        compute_dtype(self.compute_dtype)


class TBNModel(nn.Module):
    """The TBN; module names follow the reference state dict."""

    def __init__(self, spec: TBNSpec):
        super().__init__()
        spec.validate()
        self.spec = spec
        in_channels = {"RGB": 3, "Flow": 2 * spec.flow_win_length, "Audio": 1}
        for m in spec.modality:
            if spec.arch == "resnet":
                tower = ResNet(in_channels[m], spec.resnet_depth)
            elif spec.arch == "vgg":
                tower = VGG(in_channels[m], spec.vgg_type)
            else:
                tower = BNInception(
                    in_channels[m],
                    freq_pool_only=(m == "Audio" and spec.audio_attends),
                    audio_stem=(m in spec.audio_stem),
                    pool_impl=spec.pool_impl,
                    pool_fast_vjp=spec.pool_fast_vjp,
                    fused_stem=spec.fused_stem,
                    quantize=spec.quantize,
                )
            self.add_module(f"Base_{m}", tower)
        if spec.learned_attention:
            if spec.attention_type == "mha":
                if spec.use_pe:
                    self.pe = PositionalEncoding(max_len=spec.attn_win)
                self.attention_layer = MHAttention(FEATURE_SIZE, spec.attn_heads,
                                                   spec.attn_dropout)
            elif spec.attention_type == "unimodal":
                self.attention_layer = UniModalAttention(spec.attn_win, use_gumbel=spec.use_gumbel)
            else:
                self.attention_layer = PrototypeAttention(spec.attn_win,
                                                          use_gumbel=spec.use_gumbel)
        n_features = sum(self.feature_size(m) for m in spec.modality)
        if spec.multimodal:
            self.fusion = Fusion(n_features, 512, spec.fusion_dropout)
            n_features = 512
        self.classifier = Classifier(n_features, dict(spec.num_classes))
        self._cast = CastCache()
        # uint8 -> (v/255 - mean)/std == v*scale + offset, per channel;
        # mean/std repeat across the Flow stack (reference Normalize).
        for m, mean, std in (("RGB", spec.rgb_mean, spec.rgb_std),
                             ("Flow", spec.flow_mean, spec.flow_std)):
            reps = in_channels[m] // len(mean)
            mean_t = torch.tensor(mean * reps, dtype=torch.float32)
            std_t = torch.tensor(std * reps, dtype=torch.float32)
            self.register_buffer(f"_{m}_scale", 1.0 / (255.0 * std_t), persistent=False)
            self.register_buffer(f"_{m}_offset", -mean_t / std_t, persistent=False)
            self.register_buffer(f"_{m}_mean", mean_t, persistent=False)
            self.register_buffer(f"_{m}_std", std_t, persistent=False)

    def feature_size(self, modality: str) -> int:
        """Width of a modality's tower feature: 1024 (BN-Inception), 512 *
        the block expansion (ResNet: 2048 from depth 50 on), 4096 (VGG)."""
        return getattr(self, f"Base_{modality}").feature_size

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX package's initializers, module by module
        in registration order."""
        for module in self.children():
            module.reset_parameters(generator)

    def forward(self, batch: Mapping[str, torch.Tensor], true_batch: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """``batch`` in the layouts of the module docstring -> logits per
        class type (and ``weights`` with learned attention).

        Training only: ``true_batch``, the true batch size when rows past it
        are padding (None: every row is real); with several ranks it counts
        the global batch, of which ``batch`` is this rank's contiguous slice
        (parallel/mesh); ``generator``, the source of every dropout and
        gumbel draw, on the model's device (required)."""
        if self.training and generator is None:
            raise ValueError("the training forward needs a torch.Generator for its noise")
        with tf32_scope(self.spec.compute_dtype):
            return self._forward(batch, true_batch, generator)

    def _forward(self, batch, true_batch, generator) -> Dict[str, torch.Tensor]:
        spec = self.spec
        dtype = compute_dtype(spec.compute_dtype)
        use_kernels = spec.use_pallas
        features = []
        att_wts = None
        for m in spec.modality:
            x = batch[m]
            b, n = x.shape[0], x.shape[1]
            if m == "Audio" and x.dim() == 3:
                x = spectrogram(x.reshape(b * n, x.shape[-1]), spec.spec_type,
                                spec.sampling_rate, dtype)[:, None]
            else:  # (B, N, H, W, C) -> (B*N, C, H, W)
                x = x.reshape((b * n,) + x.shape[2:]).permute(0, 3, 1, 2)
            row_mask = None
            if self.training and true_batch is not None:
                # 0/1 per folded (sample, segment) row; rows are batch-major;
                # true_batch counts the global batch (parallel/mesh)
                row_mask = mesh.row_mask(b, true_batch, x.device)
                row_mask = row_mask.repeat_interleave(x.shape[0] // b)
            tower = getattr(self, f"Base_{m}")
            uint8 = m in ("RGB", "Flow") and x.dtype == torch.uint8
            if spec.arch == "bninception":
                scale = offset = None
                if uint8:
                    scale, offset = getattr(self, f"_{m}_scale"), getattr(self, f"_{m}_offset")
                args = (x, dtype, scale, offset, row_mask)
            else:
                if uint8:
                    x = self._normalize(m, x, dtype)
                args = (x, dtype, row_mask) + ((generator,) if spec.arch == "vgg" else ())
            if spec.remat and self.training and torch.is_grad_enabled():
                feature = rematerialized(tower, *args, generator=generator)
            else:
                feature = tower(*args)
            if m == "Audio":
                feature, att_wts = self._attend(batch, features, feature, b, use_kernels,
                                                generator)
                if self.training and spec.multimodal and spec.audio_dropout > 0:
                    # one draw per step zeroes the whole audio feature; the
                    # reference's polarity (model.py:216-222): u > p DROPS
                    u = torch.rand((), generator=generator, device=feature.device)
                    feature = torch.where(u > spec.audio_dropout, torch.zeros_like(feature),
                                          feature)
                if features and features[0].shape[0] > feature.shape[0]:
                    feature = tile_crop_rows(feature, b, features[0].shape[0] // feature.shape[0])
            features.append(feature)

        n_consensus = features[0].shape[0] // b
        fused = torch.cat(features, dim=-1)
        if spec.multimodal:
            fused = self.fusion(fused, dtype, generator)
        if spec.fast_consensus and use_kernels and not self.training:
            heads = list(self.classifier.items())
            # the heads' parameters rounded to the compute dtype, as TorchLinear
            # does; the same cached tensors every call, so the kernel's
            # operands (ops/kernels.consensus_heads_operands) are made once
            params = self._cast.get("heads", tuple(
                t for _, head in heads for t in (head.weight, head.bias)), dtype)
            logits = consensus_heads(fused.reshape(b, n_consensus, -1), params[0::2],
                                     params[1::2])
            out = {name: v for (name, _), v in zip(heads, logits)}
        elif spec.fast_consensus:
            pooled = fused.reshape(b, n_consensus, -1).float().mean(dim=1).to(dtype)
            out = {k: v.float() for k, v in self.classifier(pooled, dtype).items()}
        else:
            out = {
                k: v.reshape(b, n_consensus, -1).float().mean(dim=1)
                for k, v in self.classifier(fused, dtype).items()
            }
        if att_wts is not None:
            out["weights"] = att_wts
        return out

    def _normalize(self, modality: str, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """uint8 -> (x / 255 - mean) / std in the compute dtype, mean and std
        cast to it: the JAX package's ``_normalize`` (models/tbn.py:468-482)
        for the ResNet and VGG towers. (BN-Inception's stem takes the
        float32 scale / offset form instead, as in the JAX package; the two
        round differently at bf16.)"""
        mean = getattr(self, f"_{modality}_mean").to(dtype)[:, None, None]
        std = getattr(self, f"_{modality}_std").to(dtype)[:, None, None]
        return (x.to(dtype) / 255.0 - mean) / std

    def _attend(self, batch, features, feature, b: int, use_kernels: bool,
                generator) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Audio post-tower path: (feature (B*N, C), weights or None)."""
        spec = self.spec
        if not spec.attention_enable:
            return feature, None  # already globally pooled
        if spec.use_fixed:
            # feature (B*N, T, C); weights (B, N, W, 1) -> (B*N, W)
            weights = batch["weights"].reshape(feature.shape[0], -1).to(feature.dtype)
            out = torch.einsum("btc,bt->bc", feature.float(), weights.float())
            return out.to(feature.dtype), None
        query = features[0]
        if query.shape[0] > feature.shape[0]:
            # 10-crop: each crop row queries its own segment's audio window
            feature = tile_crop_rows(feature, b, query.shape[0] // feature.shape[0])
        if spec.attention_type == "mha":
            seq = self.pe(feature, use_kernels) if spec.use_pe else feature
            return self.attention_layer(query, seq, use_kernels, generator)
        return self.attention_layer(query, feature, generator)


def calibrate_quantization(model: TBNModel, batches: Iterable[Mapping[str, torch.Tensor]]
                           ) -> TBNModel:
    """Post-training int8 calibration (``tpu.quantize=int8``), the port of
    the JAX package's ``calibrate_quantization`` (models/tbn.py:573-613):
    runs the plain float eval forward over ``batches`` (input dicts as
    :meth:`TBNModel.forward` takes them) with every BN-Inception tower
    recording the running max of |x| at each int8 site, so a model with
    ``quantize="int8"`` then uses the recorded scales. The amaxes are
    non-persistent buffers of the towers (``BNInception.quant_stats``): the
    state dict, checkpoints and bundles stay as they were. Existing amaxes
    are max-merged, not overwritten. Returns ``model``, left in eval mode."""
    batches = list(batches)
    if not batches:
        raise ValueError("calibration needs at least one batch")
    dataclasses.replace(model.spec, quantize="calibrate").validate()
    towers = [getattr(model, f"Base_{m}") for m in model.spec.modality]
    modes = [tower.quantize for tower in towers]
    model.eval()
    try:
        for tower in towers:
            tower.quantize = "calibrate"
        with torch.no_grad():
            for batch in batches:
                model(batch)
    finally:
        for tower, mode in zip(towers, modes):
            tower.quantize = mode
    return model

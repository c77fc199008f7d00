"""Audio attention: the RGB segment feature queries the audio feature's
time axis.

Port of the JAX package's ``models/attention.py`` (reference
core/models/attention.py). Layouts are batch-first: features (B, C), audio
sequence (B, S, C). Module and parameter names follow the reference state
dict (``pe.0.pe``, ``pe.1.weight``, ``pe.2.weight``,
``attention_layer.attention_layer.in_proj_weight``,
``attention_layer.seq.0.weight``, ``attention_layer.prototype_wts``).

With ``use_kernels`` the eval PE block and MHA go through
``ops.kernels.pe_block`` / ``ops.kernels.mha``: the CUDA kernels on the card,
their plain versions on the CPU. Every path hands them the parameters
rounded to the compute dtype (``layers.CastCache``), as the JAX package's
call sites do; the bf16 PE kernel (``kernels.pe_block_bf16``) takes the
split operands of ``kernels.pe_block_split`` instead, cached the same way.
Without the kernels, and always in training (the kernels are
inference-only, as the Pallas ones are: attention.py:98-104 and :163-174
of the JAX package), they run the plain compositions, through
which autograd differentiates. Training adds dropout on the MHA's attention
probabilities and the straight-through gumbel-softmax of UniModal /
Prototype attention; all noise comes from the ``torch.Generator`` the
caller passes.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..data.priors import gaussian_kernel
from ..ops import kernels
from ..parallel import mesh
from .layers import CastCache, dropout, lecun_normal_, linear, reset_linear_

PE_CHANNELS = 10  # reference model.py:64 — PositionalEncoding(10, ...)


def positional_encoding_table(dim_size: int, max_len: int) -> np.ndarray:
    """(max_len, dim_size) table; pe[p, 2i] = sin(p*(i+1)), pe[p, 2i+1] =
    cos(p*(i+1)) — the reference's product form (attention.py:26-30)."""
    position = np.arange(max_len, dtype=np.float64)[:, None] * np.arange(
        1, dim_size // 2 + 1, dtype=np.float64
    )
    table = np.zeros((max_len, dim_size), dtype=np.float64)
    table[:, 0::2] = np.sin(position)
    table[:, 1::2] = np.cos(position)
    return table.astype(np.float32)


class _PETable(nn.Module):
    """Holds the reference's ``pe`` buffer, (1, dim, max_len)."""

    def __init__(self, dim_size: int, max_len: int):
        super().__init__()
        table = torch.from_numpy(positional_encoding_table(dim_size, max_len))
        self.register_buffer("pe", table.T.contiguous()[None])


class PositionalEncoding(nn.Sequential):
    """Concat-PE + 1x1 conv (C + dim -> out) + GroupNorm(num_groups), laid
    out as the reference's ``pe`` Sequential (table, Conv1d, GroupNorm)."""

    def __init__(self, dim_size: int = PE_CHANNELS, max_len: int = 25,
                 in_features: int = 1024, out_features: int = 1024, num_groups: int = 64):
        super().__init__(
            _PETable(dim_size, max_len),
            nn.Conv1d(in_features + dim_size, out_features, 1),
            nn.GroupNorm(num_groups, out_features, eps=1e-5),
        )
        self._cast = CastCache()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        conv = self[1]
        lecun_normal_(conv.weight, generator)
        conv.bias.zero_()
        self[2].reset_parameters()

    def forward(self, x: torch.Tensor, use_kernels: bool) -> torch.Tensor:
        """x (B, S, C) -> (B, S, out) in x's dtype; the table and every
        parameter rounded to x's dtype first, as attention.py:115-119 of the
        JAX package rounds them."""
        conv, norm = self[1], self[2]
        table = self[0].pe[0, :, : x.shape[1]].T  # (S, dim)
        sources = (table, conv.weight.view(conv.weight.shape[0], -1), conv.bias)
        groups = dict(num_groups=norm.num_groups, eps=norm.eps)
        if use_kernels and not self.training and x.is_cuda and x.dtype == torch.bfloat16:
            # the wgmma kernel's operands: W's x columns and the PE term (on
            # the CPU, pe_block below is pe_block_plain, as with the kernels off)
            split = self._cast.derive(f"pe{x.shape[1]}/split", sources, x.dtype,
                                      kernels.pe_block_split)
            scale, shift = self._cast.get("norm", (norm.weight, norm.bias), x.dtype)
            return kernels.pe_block_bf16(x, split, scale, shift, **groups)
        params = self._cast.get(f"pe{x.shape[1]}", sources + (norm.weight, norm.bias), x.dtype)
        fn = kernels.pe_block if use_kernels and not self.training else kernels.pe_block_plain
        return fn(x, *params, **groups)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention's parameters (packed in_proj, out_proj),
    batch-first: query (B, L, E), key and value (B, S, E)."""

    def __init__(self, embed_dim: int = 1024, num_heads: int = 4, dropout_rate: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self._cast = CastCache()

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for block in self.in_proj_weight.chunk(3):  # q, k, v: one init each
            lecun_normal_(block, generator)
        self.in_proj_bias.zero_()
        reset_linear_(self.out_proj, generator)

    def forward(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor,
                use_kernels: bool, generator: torch.Generator = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """query (B, L, E), key and value (B, S, E) -> (B, L, E) output and
        (B, L, S) head-averaged weights, both in the query's dtype; the
        projections' weights and biases rounded to it first (attention.py:
        181-186 of the JAX package). In training the attention probabilities
        are dropped out with ``generator``'s noise, and the weights returned
        are the dropped ones.

        The TBN's case, one query position with the key as the value, runs
        the kernel's arithmetic: ``kernels.mha`` at eval with the kernels on
        (where the JAX package runs ``mha_pallas``), else its plain version.
        Every other case runs :func:`multi_head_attention`, the JAX
        package's general composition."""
        params = self._cast.get("mha", (self.in_proj_weight, self.in_proj_bias,
                                        self.out_proj.weight, self.out_proj.bias), query.dtype)
        drop = None
        if self.training:
            drop = lambda p: dropout(p, self.dropout_rate, generator)  # noqa: E731
        if query.shape[1] != 1 or key is not value:
            return multi_head_attention(query, key, value, *params, self.num_heads, drop)
        args = (query[:, 0], key, *params, self.num_heads)
        if self.training:
            out, wts = kernels.mha_plain(*args, drop=drop)
        elif use_kernels:
            out, wts = kernels.mha(*args)
        else:
            out, wts = kernels.mha_plain(*args)
        return out[:, None], wts[:, None]


def multi_head_attention(query, key, value, in_proj_weight, in_proj_bias, out_proj_weight,
                         out_proj_bias, num_heads: int, drop=None):
    """(B, L, E) x (B, S, E) x (B, S, E) -> ((B, L, E), (B, L, S) head-averaged
    weights) in the query's dtype, as the JAX package's MultiheadAttention
    computes it without the kernel: the projections in that dtype, q scaled
    before the dot product, logits and softmax in float32, the probabilities
    rounded to the dtype, then ``drop`` (dropout, training only), the
    weighted sum accumulated in float32. The weights are the head mean of
    the dropped probabilities."""
    dtype = query.dtype
    b, l, e = query.shape
    s = key.shape[1]
    hd = e // num_heads
    wq, wk, wv = in_proj_weight.chunk(3)
    bq, bk, bv = in_proj_bias.chunk(3)
    q = (F.linear(query, wq) + bq).view(b, l, num_heads, hd).transpose(1, 2)
    k = (F.linear(key, wk) + bk).view(b, s, num_heads, hd).transpose(1, 2)
    v = (F.linear(value, wv) + bv).view(b, s, num_heads, hd).transpose(1, 2)
    q = q / torch.tensor(hd, dtype=dtype).sqrt().to(q.device)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(logits, dim=-1).to(dtype)
    if drop is not None:
        probs = drop(probs)
    out = torch.matmul(probs.float(), v.float()).to(dtype)
    out = F.linear(out.transpose(1, 2).reshape(b, l, e), out_proj_weight) + out_proj_bias
    return out, probs.float().mean(dim=1).to(dtype)


class MHAttention(nn.Module):
    """The reference's attention wrapper, holding the MHA as
    ``attention_layer`` (state-dict ``attention_layer.attention_layer.*``)."""

    def __init__(self, embed_dim: int = 1024, num_heads: int = 4, dropout_rate: float = 0.0):
        super().__init__()
        self.attention_layer = MultiheadAttention(embed_dim, num_heads, dropout_rate)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attention_layer.reset_parameters(generator)

    def forward(self, query, keyval, use_kernels: bool, generator: torch.Generator = None):
        """query (B, E), keyval (B, S, E) -> (B, E) output and (B, 1, S)
        weights: one query position, the key as the value."""
        out, wts = self.attention_layer(query[:, None], keyval, keyval, use_kernels, generator)
        return out[:, 0], wts


def gumbel_softmax(logits: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """F.gumbel_softmax(hard=True, tau=1) with the noise drawn from
    ``generator``: the softmax of logits + Gumbel(0, 1) in float32, returned
    as the one-hot of its argmax forward with the softmax's gradient
    backward (straight-through), in the logits' dtype."""
    # the global batch's draw, this rank's rows kept (parallel/mesh)
    gumbels = -mesh.global_noise(logits.shape, lambda shape: torch.empty(
        shape, device=logits.device).exponential_(generator=generator)).log()
    y = torch.softmax(logits.float() + gumbels, dim=-1)
    y_hard = F.one_hot(y.argmax(dim=-1), logits.shape[-1]).to(y.dtype)
    return (y_hard + y - y.detach()).to(logits.dtype)


class UniModalAttention(nn.Module):
    """MLP(rgb) -> distribution over the audio time axis -> weighted sum: a
    softmax at eval, the hard gumbel-softmax in training when
    ``use_gumbel``."""

    def __init__(self, win_size: int, in_features: int = 1024, hidden_size: int = 256,
                 n_out: int = None, use_gumbel: bool = True):
        super().__init__()
        self.use_gumbel = use_gumbel
        self.seq = nn.Sequential(
            nn.Linear(in_features, hidden_size), nn.ReLU(),
            nn.Linear(hidden_size, win_size if n_out is None else n_out),
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        reset_linear_(self.seq[0], generator)
        reset_linear_(self.seq[2], generator)

    def _mix(self, rgb_feature: torch.Tensor, dtype: torch.dtype,
             generator: torch.Generator) -> torch.Tensor:
        y = F.relu(linear(rgb_feature, self.seq[0], dtype))
        logits = linear(y, self.seq[2], dtype)
        if self.training and self.use_gumbel:
            return gumbel_softmax(logits, generator)
        return torch.softmax(logits.float(), dim=-1).to(dtype)

    def forward(self, rgb_feature, audio_sequence, generator: torch.Generator = None):
        """(B, C), (B, S, C) -> (B, C) attended feature, (B, S) weights."""
        dtype = audio_sequence.dtype
        weights = self._mix(rgb_feature, dtype, generator)
        return _weighted_sum(audio_sequence, weights), weights


class PrototypeAttention(UniModalAttention):
    """MLP(rgb) mixes 3 Gaussian prototype curves over the time axis."""

    def __init__(self, win_size: int, in_features: int = 1024, hidden_size: int = 256,
                 use_gumbel: bool = True):
        super().__init__(win_size, in_features, hidden_size, n_out=3, use_gumbel=use_gumbel)
        self.register_buffer("prototype_wts", torch.from_numpy(prototypes(win_size)))

    def forward(self, rgb_feature, audio_sequence, generator: torch.Generator = None):
        dtype = audio_sequence.dtype
        mix = self._mix(rgb_feature, dtype, generator)
        weights = torch.matmul(mix, self.prototype_wts.to(dtype))
        return _weighted_sum(audio_sequence, weights), weights


def prototypes(win_size: int) -> np.ndarray:
    """(3, win) — the centred Gaussian and its +-(win//2 - 2) rolls
    (reference attention.py:121-132)."""
    base = gaussian_kernel(win_size, sigma=1.0)
    shift = win_size // 2 - 2
    return np.concatenate(
        (base, np.roll(base, -shift), np.roll(base, shift)), axis=1
    ).T.astype(np.float32)


def _weighted_sum(sequence: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_s w[b, s] * seq[b, s, :] with float32 accumulation."""
    out = torch.einsum("bsc,bs->bc", sequence.float(), weights.float())
    return out.to(sequence.dtype)

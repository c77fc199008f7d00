#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --out smoke.jsonl   # every line to a file too
    python3 chip_smoke.py --quick   # build and kernel checks only (no ok line)

Builds the hand-written kernels from ``attention_based_tbn_tpu_torch/ops/csrc``
(one ``nvcc`` per source, all at once) and holds each against its plain
PyTorch version at the main paths' shapes. Then drives three paths, each
with the kernels' launch counts set to 0 just before it and read just after:

* serving: the flagship model (tri-modal BN-Inception, 224x224 crops, 25
  segments, 2.1 s audio, MHA attention, bf16, kernels on) with seeded
  weights through ``tools/serve.ServingModel``: requests of batch 1, 3 (in
  the 10 bucket) and 10 through ``predict``, and one HTTP POST; the served
  logits are checked against the same weights run in float32 with the
  kernels off; latency, device profile and per-layer times; then one b=10
  request with ``tpu.pool_impl=pallas`` and one with ``tpu.fused_stem`` +
  ``tpu.fast_consensus`` against the default config's;
* evaluation: the port's ``main`` in test mode at full width on a Flow
  (.npz stacks) + Audio (WAV) fixture written here with numpy, 10-crop, the
  fused stem, fast consensus and the challenge JSON, over a labelled and an
  unlabelled annotation file (200 clips each), from a seeded ``{"model":
  state_dict}`` .pth; the same run with every kernel off must give the same
  uids and scores within the bf16 drift bound; clips/s from the run logs,
  and a device profile of one more sweep;
* training: the flagship recipe (batch 12 x 3 segments, SGD momentum 0.9
  at lr 1e-2, partialbn, clip 20, dropout 0.5, bf16, ``tpu.pool_impl=
  pallas``, seeded weights: ``model.pretrained=false``) through
  ``tools/train.train_one_epoch`` over an in-memory seeded loader (6 batches
  of 12 clips and a ragged one of 7), then ``validate`` on 2 batches of 2
  clips x 25 segments; step time, memory and a device profile of one step;
  and one float32 step with the pool kernel against the same step with the
  plain pool.

One JSON line per phase; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
no CUDA device is present or any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import csv
import io
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np
import torch

from attention_based_tbn_tpu_torch import main as port_main
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.data.records import load_annotations
from attention_based_tbn_tpu_torch.models.attention import PE_CHANNELS, positional_encoding_table
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.ops import build, kernels
from attention_based_tbn_tpu_torch.parallel.optim import lr_at_epoch
from attention_based_tbn_tpu_torch.parallel.train_step import (
    create_train_state, make_eval_step, make_train_step,
)
from attention_based_tbn_tpu_torch.tools.serve import ServingModel, bench, make_server
from attention_based_tbn_tpu_torch.tools.train import train_one_epoch, validate
from attention_based_tbn_tpu_torch.utils.metrics import Metric
from attention_based_tbn_tpu_torch.utils.misc import get_modality

# Published peaks of one H100 SXM (dense): HBM bytes/s and operations/s by
# the activations' type (bf16 tensor cores; fp32 outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# Kernel vs plain version: |err| <= atol + rtol * max|plain|. fp32 differs
# only in summation order over 1024-long dot products; bf16 also in the
# final rounding of outputs up to ~8 (one bf16 ulp there is 0.03).
KERNEL_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# Served (bf16, kernels) vs float32 plain logits: the repo's bf16 drift
# bound (tests/test_bf16_drift.py). float32 kernels vs float32 plain: the
# kernels' own fp32 error carried to the logits.
DRIFT_REL_RMSE = 0.04
FP32_LOGIT_RTOL = 1e-4
ROWS = (25, 250)  # B*N at b=1 and b=10 with 25 segments
S, E, HEADS = 13, 1024, 4
REPLACES = {
    "pe_block": "attention_based_tbn_tpu/ops/pallas_kernels.py:122",
    "mha": "attention_based_tbn_tpu/ops/pallas_kernels.py:232",
    "max_pool": "attention_based_tbn_tpu/ops/pallas_pool.py:88",
    "fused_stem": "attention_based_tbn_tpu/ops/fused_stem.py:264",
    "consensus_heads": "attention_based_tbn_tpu/ops/pallas_kernels.py:299",
}
SOURCES = {
    "pe_block": "attention_based_tbn_tpu_torch/ops/csrc/pe_block.cu",
    "mha": "attention_based_tbn_tpu_torch/ops/csrc/mha.cu",
    "max_pool": "attention_based_tbn_tpu_torch/ops/csrc/max_pool.cu",
    "fused_stem": "attention_based_tbn_tpu_torch/ops/csrc/fused_stem.cu",
    "consensus_heads": "attention_based_tbn_tpu_torch/ops/csrc/consensus_heads.cu",
}
# (H, W, C, input type) of each tower's stem input on the main paths: uint8
# 224x224 RGB and 10-channel Flow, the float32 256x420 spectrogram of 2.1 s
# audio; normalization affine per modality (RGB BGR mean, Flow 0.502).
STEM_INPUTS = {
    "RGB": (224, 224, 3, torch.uint8, (0.408, 0.459, 0.502)),
    "Flow": (224, 224, 10, torch.uint8, (0.502,) * 10),
    "Audio": (256, 420, 1, torch.float32, None),
}
CLASS_HEADS = (125, 352)  # verb, noun
FUSION = 512
# The evaluation path: 2 clips x 25 segments per batch, Flow 10-cropped;
# videos x actions clips in each of its two annotation files.
TEST_BATCH = 2
TEST_VIDEOS, TEST_ACTIONS = 20, 10
TEST_STEMS = (("Flow", 500), ("Audio", 50))  # (modality, rows) of one forward's stems
SERVE_STEMS = tuple((m, ROWS[-1]) for m in STEM_INPUTS)  # a b=10 served request's
CONSENSUS_SHAPES = ((10, ROWS[0]), (10, ROWS[-1]), (TEST_BATCH, 10 * ROWS[0]))  # (B, N)
# (C, H, W) per row of the four stride-2 ceil max pools of a tower (stem
# pool1 and pool2, the passthrough of inception 3c and 4e), 224x224 crops
# and the 256x420 spectrogram of 2.1 s audio.
POOL_SHAPES = {
    "visual": ((64, 112, 112), (192, 56, 56), (320, 28, 28), (608, 14, 14)),
    "audio": ((64, 128, 210), (192, 64, 105), (320, 32, 52), (608, 16, 26)),
}
POOL_ROWS = (36, 250)  # a train step's 12 x 3 rows; a b=10 served request's 250
TOWERS = {"Base_RGB": "visual", "Base_Flow": "visual", "Base_Audio": "audio"}
# Training: the flagship recipe of the config defaults, seeded weights, and
# the towers' stride-2 pools on the kernel.
TRAIN_OVERRIDES = ["model.pretrained=false", "tpu.pool_impl=pallas"]
TRAIN_BATCHES = [12] * 6 + [7]  # a single-card loader does not pad: the last is ragged
VAL_BATCHES = [2, 2]
# One float32 step (TF32 off, dropout 0, deterministic cuDNN) with the pool
# kernel vs the plain pool: the pools are exact, so any gap is cuDNN's
# summation order; loss and parameters within this relative tolerance.
TRAIN_AGREEMENT_RTOL = 1e-5

_LOG = None  # file that every emitted line is also appended to (--out)


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    if _LOG is not None:
        with open(_LOG, "a") as fh:
            fh.write(line + "\n")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float, dtype) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(rows: int, dtype, gen: torch.Generator):
    """Seeded flagship-shape inputs of both kernels, on the card."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda()

    x = rnd(rows, S, E).to(dtype)
    # the table as the model passes it: a transposed view of a (D, S) buffer
    table = positional_encoding_table(PE_CHANNELS, S)
    pe = dict(
        pe_table=torch.from_numpy(table.T.copy()).cuda().T,
        conv_weight=rnd(E, E + PE_CHANNELS, scale=0.03), conv_bias=rnd(E, scale=0.1),
        gn_scale=(torch.rand(E, generator=gen) + 0.5).cuda(), gn_bias=rnd(E, scale=0.1),
    )
    mha = dict(
        in_proj_weight=rnd(3 * E, E, scale=0.03), in_proj_bias=rnd(3 * E, scale=0.1),
        out_proj_weight=rnd(E, E, scale=0.03), out_proj_bias=rnd(E, scale=0.1),
    )
    query = rnd(rows, E).to(dtype)
    return x, pe, query, mha


def pe_block_cost(rows: int, dtype) -> tuple:
    elt = torch.finfo(dtype).bits // 8
    moved = 2 * rows * S * E * elt + 4 * (E * (E + PE_CHANNELS) + 3 * E + S * PE_CHANNELS)
    ops = 2 * rows * S * E * E + 2 * S * PE_CHANNELS * E + 7 * rows * S * E
    return bound(moved, ops, dtype)


def mha_cost(rows: int, dtype) -> tuple:
    elt = torch.finfo(dtype).bits // 8
    # query, keyval (read once: k and v come from it), out, weights; fp32 params
    moved = elt * (2 * rows * E + rows * S * E + rows * S) + 4 * (4 * E * E + 4 * E)
    ops = 4 * rows * E * E + 4 * rows * S * E * E + 4 * rows * S * E
    return bound(moved, ops, dtype)


def max_pool_cost(rows: int, c: int, h: int, w: int, dtype) -> tuple:
    """Each input element read once, each output written once; 8
    comparisons per output on the fp32 ALUs (the kernel compares in fp32)."""
    elt = torch.finfo(dtype).bits // 8
    outputs = rows * c * kernels.ceil_out_size(h) * kernels.ceil_out_size(w)
    return bound(elt * (rows * c * h * w + outputs), 8 * outputs, torch.float32)


def check_max_pool(failures: list) -> list:
    """The pool kernel against its plain version (torch's own pool, also the
    one-call library yardstick) at every tower pool shape, ROWS rows, fp32
    and bf16, NCHW and channels-last: the forward must be equal, in the
    input's memory format, and in fp32 the gradient through the autograd
    Function must equal the plain pool's. Returns one record per case."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for rows in POOL_ROWS:
        for tower, shapes in POOL_SHAPES.items():
            for c, h, w in shapes:
                for dtype in (torch.float32, torch.bfloat16):
                    base = torch.randn(rows, c, h, w, generator=gen, device="cuda", dtype=dtype)
                    for channels_last in (False, True):
                        fmt = torch.channels_last if channels_last else torch.contiguous_format
                        x = base.contiguous(memory_format=fmt)
                        got, want = kernels.ceil_max_pool2d(x), kernels.ceil_max_pool2d_plain(x)
                        torch.cuda.synchronize()
                        exact = bool(torch.equal(got, want)) and got.is_contiguous(
                            memory_format=fmt)
                        err = (got.float() - want.float()).abs().max().item()
                        grad_exact = None
                        if dtype == torch.float32:
                            xg = x.detach().requires_grad_(True)
                            g = torch.randn(want.shape, generator=gen, device="cuda")
                            (dx,) = torch.autograd.grad(kernels.ceil_max_pool2d(xg), xg, g)
                            (dw,) = torch.autograd.grad(kernels.ceil_max_pool2d_plain(xg), xg, g)
                            grad_exact = bool(torch.equal(dx, dw))
                            del xg, g, dx, dw
                        bound_ms, bound_by = max_pool_cost(rows, c, h, w, dtype)
                        record = {
                            "phase": "max_pool_check", "tower": tower, "rows": rows,
                            "shape": [c, h, w], "dtype": str(dtype).replace("torch.", ""),
                            "layout": "channels_last" if channels_last else "nchw",
                            "exact": exact, "grad_exact": grad_exact, "max_abs_err": err,
                            "ms": time_ms(lambda: kernels.ceil_max_pool2d(x), 20),
                            "plain_ms": time_ms(lambda: kernels.ceil_max_pool2d_plain(x), 20),
                            "bound_ms": bound_ms, "bound_by": bound_by,
                        }
                        emit(record)
                        records.append(record)
                        if not exact or grad_exact is False:
                            failures.append(f"max_pool {rows}x{c}x{h}x{w} {dtype} "
                                            f"{record['layout']}: exact={exact} "
                                            f"grad_exact={grad_exact} err={err}")
                    del base, x, got, want
    torch.cuda.empty_cache()
    return records


def pool_step_summary(records: list, rows: int, dtype: str, layout: str) -> dict:
    """The twelve stride-2 pools of one forward (4 per tower, RGB and Flow
    at the visual shapes, Audio at its own) summed: ms, plain ms, bound."""
    by_shape = {(r["tower"], tuple(r["shape"])): r for r in records
                if r["rows"] == rows and r["dtype"] == dtype and r["layout"] == layout}
    pools = [by_shape[(TOWERS[t], shape)] for t in TOWERS for shape in POOL_SHAPES[TOWERS[t]]]
    total = {k: sum(r[k] for r in pools) for k in ("ms", "plain_ms", "bound_ms")}
    return {**total, "library_ms": total["plain_ms"], "bound_by": "bytes",
            "max_abs_err": max(r["max_abs_err"] for r in pools), "rows": rows,
            "dtype": dtype, "layout": layout, "pools": len(pools)}


def stem_inputs(modality: str, rows: int, dtype, gen: torch.Generator):
    """Seeded stem input (NHWC), BN-folded weight in ``dtype``, float32
    bias, scale and offset of one tower, on the card."""
    h, w, c, in_type, mean = STEM_INPUTS[modality]
    if in_type == torch.uint8:
        x = torch.randint(0, 256, (rows, h, w, c), generator=gen, dtype=torch.uint8)
        scale = torch.full((c,), 1.0 / 255.0)
        offset = -torch.tensor(mean)
    else:
        x = torch.randn(rows, h, w, c, generator=gen) * 4.0 - 8.0  # log-power range
        scale, offset = torch.ones(c), torch.zeros(c)
    weight = (torch.randn(64, c, 7, 7, generator=gen) * (2.0 / (49 * c)) ** 0.5).to(dtype)
    bias = torch.randn(64, generator=gen) * 0.1
    return [t.cuda() for t in (x, weight, bias, scale, offset)]


def stem_composition(x, weight, bias, scale, offset, dtype):
    """The port's default eval stem on the same input (the tower without
    tpu.fused_stem): normalize in ``dtype`` on the NCHW view of the NHWC
    input, cuDNN conv with the folded weight and the bias in ``dtype``,
    ReLU, then pool1 (torch's ceil max pool)."""
    xc = x.permute(0, 3, 1, 2).to(dtype)
    xc = xc * scale.to(dtype)[:, None, None] + offset.to(dtype)[:, None, None]
    y = torch.nn.functional.relu(
        torch.nn.functional.conv2d(xc, weight, bias.to(dtype), 2, 3), inplace=True)
    return kernels.ceil_max_pool2d_plain(y)


def fused_stem_cost(modality: str, rows: int, dtype) -> tuple:
    """Input, weight, bias and output bytes once; the conv's 2 * 49 * C
    operations per conv output and output channel, its bias and ReLU, and
    8 comparisons per pooled output, at the peak of ``dtype``."""
    h, w, c, in_type, _ = STEM_INPUTS[modality]
    elt = torch.finfo(dtype).bits // 8
    in_elt = 1 if in_type == torch.uint8 else 4
    conv_out = rows * 64 * (h // 2) * (w // 2)
    pooled = rows * 64 * (h // 4) * (w // 4)
    moved = rows * h * w * c * in_elt + 64 * c * 49 * elt + 4 * (64 + 2 * c) + pooled * elt
    ops = conv_out * (2 * 49 * c + 2) + 8 * pooled + 2 * rows * h * w * c
    return bound(moved, ops, dtype)


def check_fused_stem(failures: list) -> list:
    """The fused stem kernel against its plain version for each tower's
    stem at ROWS rows and at the evaluation path's TEST_STEMS, fp32 (TF32
    off) and bf16; plain_ms is the port's default composition (conv + bias
    + ReLU + pool1), plain_function_ms the plain version's own time.
    Returns one record per case."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(3)
    records = []
    cases = [(m, rows) for rows in ROWS for m in STEM_INPUTS] + list(TEST_STEMS)
    for modality, rows in cases:
        for dtype in (torch.float32, torch.bfloat16):
            args = stem_inputs(modality, rows, dtype, gen)
            got = kernels.fused_stem(*args, dtype)
            want = kernels.fused_stem_plain(*args, dtype)
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[dtype]
            err = (got.float() - want.float()).abs().max().item()
            tol = atol + rtol * want.float().abs().max().item()
            ok = err <= tol and got.is_contiguous(memory_format=torch.channels_last)
            bound_ms, bound_by = fused_stem_cost(modality, rows, dtype)
            record = {
                "phase": "fused_stem_check", "modality": modality, "rows": rows,
                "input": str(args[0].dtype).replace("torch.", ""),
                "dtype": str(dtype).replace("torch.", ""), "shape": list(got.shape),
                "max_abs_err": err, "tolerance": tol, "ok": ok,
                "ms": time_ms(lambda: kernels.fused_stem(*args, dtype), 10),
                "plain_ms": time_ms(lambda: stem_composition(*args, dtype), 10),
                "plain_function_ms": time_ms(lambda: kernels.fused_stem_plain(*args, dtype), 3),
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            }
            emit(record)
            records.append(record)
            if not ok:
                failures.append(f"fused_stem {modality} {rows} {dtype}: err {err} > {tol}")
            del args, got, want
    torch.cuda.empty_cache()
    return records


def stem_forward_summary(records: list, stems: tuple, dtype: str) -> dict:
    """The stems of one forward, ``stems`` as (modality, rows), summed."""
    cases = [r for r in records if (r["modality"], r["rows"]) in stems and r["dtype"] == dtype]
    total = {k: sum(r[k] for r in cases) for k in ("ms", "plain_ms", "bound_ms")}
    return {**total, "library_ms": None, "bound_by": "operations",
            "max_abs_err": max(r["max_abs_err"] for r in cases),
            "stems": [[r["modality"], r["rows"]] for r in cases], "dtype": dtype}


def consensus_cost(b: int, n: int, dtype) -> tuple:
    """Features, weights, biases and logits once; N adds per feature and a
    multiply-add per feature and class, on the fp32 units (the kernel
    computes in fp32)."""
    elt = torch.finfo(dtype).bits // 8
    classes = sum(CLASS_HEADS)
    moved = elt * b * n * FUSION + 4 * (classes * FUSION + classes + b * classes)
    ops = b * n * FUSION + 2 * b * FUSION * classes
    return bound(moved, ops, torch.float32)


def check_consensus_heads(failures: list) -> list:
    """The consensus + heads kernel against its plain version at (B, N,
    512) for (B, N) in CONSENSUS_SHAPES with the verb / noun heads, fp32
    and bf16 features; composition_ms is the port's fast consensus without
    the kernel (mean, round to the compute type, Linear heads in it)."""
    gen = torch.Generator().manual_seed(4)
    records = []
    for b, n in CONSENSUS_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(b, n, FUSION, generator=gen).relu().cuda().to(dtype)
            weights = [(torch.randn(c, FUSION, generator=gen) * 0.03).cuda() for c in CLASS_HEADS]
            biases = [(torch.randn(c, generator=gen) * 0.1).cuda() for c in CLASS_HEADS]

            def composition():
                pooled = feats.float().mean(dim=1).to(dtype)
                return [torch.nn.functional.linear(pooled, w.to(dtype), v.to(dtype)).float()
                        for w, v in zip(weights, biases)]

            got = kernels.consensus_heads(feats, weights, biases)
            want = kernels.consensus_heads_plain(feats, weights, biases)
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[torch.float32]  # fp32 arithmetic in both
            errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
            tols = [atol + rtol * w.abs().max().item() for w in want]
            ok = all(e <= t for e, t in zip(errs, tols))
            bound_ms, bound_by = consensus_cost(b, n, dtype)
            record = {
                "phase": "consensus_heads_check", "shape": [b, n, FUSION],
                "heads": list(CLASS_HEADS),
                "dtype": str(dtype).replace("torch.", ""), "max_abs_err": max(errs),
                "tolerance": tols, "ok": ok,
                "ms": time_ms(lambda: kernels.consensus_heads(feats, weights, biases)),
                "plain_ms": time_ms(lambda: kernels.consensus_heads_plain(feats, weights, biases)),
                "composition_ms": time_ms(composition), "library_ms": None,
                "bound_ms": bound_ms, "bound_by": bound_by,
            }
            emit(record)
            records.append(record)
            if not ok:
                failures.append(f"consensus_heads {b}x{n} {dtype}: {errs} > {tols}")
    return records


def check_kernels(failures: list) -> dict:
    """Each kernel against its plain version at B*N in ROWS, fp32 (TF32
    off) and bf16. Returns the main path's case (bf16, 250 rows) per
    kernel: errors and times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    main_case = {}
    for rows in ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            x, pe, query, mha = kernel_inputs(rows, dtype, gen)
            atol, rtol = KERNEL_TOL[dtype]
            cases = {
                "pe_block": (lambda: (kernels.pe_block(x, **pe),),
                             lambda: (kernels.pe_block_plain(x, **pe),), None,
                             pe_block_cost(rows, dtype)),
                "mha": (lambda: kernels.mha(query, x, num_heads=HEADS, **mha),
                        lambda: kernels.mha_plain(query, x, num_heads=HEADS, **mha),
                        library_mha(query, x, mha, dtype), mha_cost(rows, dtype)),
            }
            for name, (kernel_fn, plain_fn, library_fn, (bound_ms, bound_by)) in cases.items():
                got, want = kernel_fn(), plain_fn()
                torch.cuda.synchronize()
                errs = []
                for g, w in zip(got, want):
                    diff = (g.float() - w.float()).abs().max().item()
                    scale = w.float().abs().max().item()
                    errs.append((diff, scale, atol + rtol * scale))
                ok = all(d <= tol and np.isfinite(d) for d, _, tol in errs)
                result = {
                    "phase": "kernel_check", "kernel": name, "rows": rows,
                    "dtype": str(dtype).replace("torch.", ""),
                    "max_abs_err": max(d for d, _, _ in errs),
                    "max_rel_err": max(d / max(s, 1e-30) for d, s, _ in errs),
                    "tolerance": [tol for _, _, tol in errs], "ok": ok,
                    "ms": time_ms(kernel_fn), "plain_ms": time_ms(plain_fn),
                    "library_ms": time_ms(library_fn) if library_fn else None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                emit(result)
                if not ok:
                    failures.append(f"{name} {rows} {dtype}: {errs}")
                if rows == ROWS[-1] and dtype == torch.bfloat16:
                    main_case[name] = result
    emit({"phase": "kernels", "kernels": [
        {"name": n, "status": "ported", "route": "cuda", "source": SOURCES[n]} for n in SOURCES
    ]})
    return main_case


def library_mha(query, keyval, mha, dtype):
    """One PyTorch call computing the same function (yardstick only): the
    functional torch MultiheadAttention, weights cast to the input type."""
    q = query[None]
    kv = keyval.transpose(0, 1)
    w = {k: v.to(dtype) for k, v in mha.items()}

    def call():
        return torch.nn.functional.multi_head_attention_forward(
            q, kv, kv, E, HEADS, w["in_proj_weight"], w["in_proj_bias"], None, None, False,
            0.0, w["out_proj_weight"], w["out_proj_bias"], training=False,
            need_weights=True, average_attn_weights=True,
        )
    return call


def check_outputs(name: str, out: dict, b: int, failures: list) -> None:
    shapes = {"verb": (b, 125), "noun": (b, 352), "weights": (b * 25, 1, S)}
    for key, shape in shapes.items():
        arr = out.get(key)
        if arr is None or arr.shape != shape or not np.isfinite(arr).all():
            failures.append(f"{name}: {key} {None if arr is None else arr.shape} != {shape} "
                            "or not finite")


def post(url: str, body: bytes):
    req = urllib.request.Request(url, data=body, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read()


def serve_requests(model: ServingModel, failures: list) -> dict:
    """The main path: predict at b=1, 3 (bucket 10) and 10, one HTTP POST."""
    outputs = {}
    for b in (1, 3, 10):
        batch = model.example_batch(b, seed=b)
        start = time.perf_counter()
        out = model.predict(batch)
        emit({"phase": "serve", "batch": b, "bucket": model.last_bucket,
              "seconds": time.perf_counter() - start,
              "shapes": {k: list(v.shape) for k, v in out.items()}})
        check_outputs(f"predict b={b}", out, b, failures)
        outputs[b] = (batch, out)

    server = make_server(model, 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            health = json.loads(resp.read())
        buf = io.BytesIO()
        np.savez(buf, **model.example_batch(2, seed=2))
        code, body = post(base + "/predict", buf.getvalue())
        http_out = dict(np.load(io.BytesIO(body))) if code == 200 else {}
        bad = io.BytesIO()
        wrong = model.example_batch(1)
        wrong["Audio"] = wrong["Audio"].astype(np.float64)
        np.savez(bad, **wrong)
        bad_code, _ = post(base + "/predict", bad.getvalue())
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    emit({"phase": "http", "healthz": health["status"], "predict_status": code,
          "shapes": {k: list(v.shape) for k, v in http_out.items()},
          "bad_dtype_status": bad_code})
    if code != 200:
        failures.append(f"POST /predict returned {code}: {body[:200]!r}")
    else:
        check_outputs("http b=2", http_out, 2, failures)
    if bad_code != 400:
        failures.append(f"bad-dtype POST returned {bad_code}, expected 400")
    return outputs


def rel_rmse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(np.mean((a - b) ** 2)) / (np.sqrt(np.mean(b ** 2)) + 1e-12))


def check_agreement(served: ServingModel, batch: dict, served_out: dict, failures: list) -> None:
    """The b=10 batch again in float32 with TF32 off: kernels on, then the
    plain versions. fp32 kernels vs plain must agree to FP32_LOGIT_RTOL;
    the served bf16 logits must stay inside the bf16 drift bound."""
    state = served.model.state_dict()
    runs = {}
    for use_kernels in (True, False):
        cfg = load_config(overrides=["tpu.compute_dtype=float32",
                                     f"tpu.use_pallas={str(use_kernels).lower()}"])
        model = ServingModel(cfg, state, device="cuda", batch_buckets=(10,))
        runs[use_kernels] = model.predict(batch)
        del model
        torch.cuda.empty_cache()
    plain, fp32_kernels = runs[False], runs[True]
    result = {"phase": "agreement"}
    for head in ("verb", "noun", "weights"):
        ref = plain[head]
        diff = float(np.abs(fp32_kernels[head] - ref).max())
        tol = FP32_LOGIT_RTOL * float(np.abs(ref).max()) + 1e-7
        drift = rel_rmse(served_out[head], ref)
        result[head] = {"fp32_kernels_vs_plain_max_abs": diff, "tolerance": tol,
                        "bf16_served_vs_fp32_plain_rel_rmse": drift,
                        "rel_rmse_bound": DRIFT_REL_RMSE}
        if not diff <= tol:
            failures.append(f"fp32 kernels vs plain {head}: {diff} > {tol}")
        if head != "weights" and not drift < DRIFT_REL_RMSE:
            failures.append(f"bf16 vs fp32 {head}: rel-RMSE {drift} >= {DRIFT_REL_RMSE}")
    result["top1_agreement"] = {
        h: float(np.mean(served_out[h].argmax(-1) == plain[h].argmax(-1))) for h in ("verb", "noun")
    }
    emit(result)


# Kernel-name keywords of the device-time breakdown, first match wins.
# cuDNN's convolutions name their direction (fprop) or convolve; cuBLAS's
# GEMMs (sm90_xmma_gemm_*, cutlass*gemm*, nvjet_*) do not, so the conv keys
# come first and stay specific. The pool kernel's own names come before
# torch's pools; reductions (the live BatchNorm statistics, losses) last.
CATEGORIES = (
    ("pe_block", ("pe_block_kernel",)),
    ("mha", ("linear_kernel", "attend_kernel")),
    ("max_pool_kernel", ("max_pool_nchw_kernel", "max_pool_nhwc_kernel")),
    ("fused_stem", ("fused_stem_kernel",)),
    ("consensus_heads", ("consensus_heads_kernel",)),
    ("conv", ("fprop", "convolve", "conv2d", "convolution", "winograd", "wgrad", "dgrad")),
    ("gemm", ("gemm", "gemv", "nvjet", "matmul")),
    ("pool", ("pool",)),
    ("copy", ("copy", "memcpy", "memset", "cat")),
    ("reduce", ("reduce_kernel",)),
)


def device_profile(run) -> dict:
    """Device time of one call of ``run`` by kernel category and the
    longest kernels (torch.profiler's device events: kernels and copies),
    and the device's busy share of the call's host wall time (one stream,
    so device events do not overlap). ``run`` ends in a host sync."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_category: dict = {}
    by_kernel: dict = {}
    for event in prof.events():
        if event.device_type != DeviceType.CUDA:
            continue
        ms = event.time_range.elapsed_us() / 1e3
        name = event.name.lower()
        category = next((c for c, keys in CATEGORIES if any(k in name for k in keys)),
                        "elementwise/other")
        by_category[category] = by_category.get(category, 0.0) + ms
        total, count = by_kernel.get(event.name[:90], (0.0, 0))
        by_kernel[event.name[:90]] = (total + ms, count + 1)
    device_ms = sum(by_category.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_events": sum(count for _, count in by_kernel.values()),
            "device_ms_by_category": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
            "top_device_events": [[name, ms, count] for name, (ms, count) in top]}


def profile_request(model: ServingModel, b: int) -> dict:
    """Device profile of one served request after a warm-up one."""
    batch = model.example_batch(b, seed=b)
    model.predict(batch)
    return {"phase": "profile", "batch": b, **device_profile(lambda: model.predict(batch))}


def layer_times(model: ServingModel, b: int) -> dict:
    """Device time of one served request per layer: a CUDA event recorded
    on the stream at the entry and exit of each top-level module of the
    model (forward hooks), and before and after ``predict``. The span
    between two events is the device time between those points, idle gaps
    included. The span before the first tower is the input's host-to-device
    copy; the one before ``Base_Audio`` is the audio spectrogram; the one
    after the classifier is the consensus and the outputs' copy back."""
    batch = model.example_batch(b, seed=b)
    model.predict(batch)
    marks = []

    def mark(label):
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        marks.append((label, event))

    hooks = []
    for name, module in model.model.named_children():
        hooks.append(module.register_forward_pre_hook(
            lambda mod, args, name=name: mark(("enter", name))))
        hooks.append(module.register_forward_hook(
            lambda mod, args, out, name=name: mark(("exit", name))))
    try:
        mark(("enter", "predict"))
        model.predict(batch)
        mark(("exit", "predict"))
    finally:
        for hook in hooks:
            hook.remove()
    torch.cuda.synchronize()
    spans = {}
    for (prev, ev0), (cur, ev1) in zip(marks, marks[1:]):
        if prev == ("enter", cur[1]) and cur[0] == "exit":
            label = cur[1]
        elif prev == ("enter", "predict"):
            label = "input copy"
        elif cur[0] == "enter":
            label = {"Base_Audio": "spectrogram"}.get(cur[1], f"before {cur[1]}")
        else:
            label = f"after {prev[1]}"
        spans[label] = spans.get(label, 0.0) + ev0.elapsed_time(ev1)
    return {"phase": "layers", "batch": b, "device_ms": marks[0][1].elapsed_time(marks[-1][1]),
            "device_ms_by_layer": spans}


class SmokeLoader:
    """Seeded in-memory batches made on the card, in the JAX package's
    loader contract: ``(batch, targets, meta)`` with ``meta["batch_size"]``,
    ``__len__`` and ``set_epoch``. Uniform uint8 frames and flow, N(0, 0.1)
    audio, uniform labels."""

    def __init__(self, cfg, sizes, segments: int, crop: int, seed: int):
        self.sizes, self.segments, self.crop, self.seed = sizes, segments, crop, seed
        self.flow_channels = 2 * int(cfg.data.flow.win_length)
        self.audio_len = int(cfg.data.audio.audio_length * cfg.data.audio.sampling_rate)
        self.num_classes = dict(cfg.model.num_classes)
        self.epoch = 0

    def __len__(self):
        return len(self.sizes)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __iter__(self):
        gen = torch.Generator(device="cuda").manual_seed(self.seed + self.epoch)
        n, crop = self.segments, self.crop
        for b in self.sizes:
            def frames(channels):
                return torch.randint(0, 256, (b, n, crop, crop, channels), generator=gen,
                                     device="cuda", dtype=torch.uint8)
            batch = {"RGB": frames(3), "Flow": frames(self.flow_channels),
                     "Audio": torch.randn(b, n, self.audio_len, generator=gen, device="cuda") * 0.1}
            targets = {"class": {k: torch.randint(0, c, (b,), generator=gen, device="cuda")
                                 for k, c in self.num_classes.items()}}
            yield batch, targets, {"batch_size": b}


def train_loaders(cfg):
    train = SmokeLoader(cfg, TRAIN_BATCHES, int(cfg.train.num_segments),
                        int(cfg.data.train_crop_size), seed=1)
    val = SmokeLoader(cfg, VAL_BATCHES, int(cfg.val.num_segments),
                      int(cfg.data.test_crop_size), seed=2)
    return train, val


def train_path(card: str, failures: list):
    """The training main path: one ``train_one_epoch`` of the flagship
    recipe, then ``validate``, with the launch counts set to 0 just before
    and read just after. Returns (state, cfg, launches)."""
    cfg = load_config(overrides=TRAIN_OVERRIDES)
    model = build_model(cfg, get_modality(cfg), device="cuda")
    state = create_train_state(cfg, model)
    epoch = 0
    state.optimizer.set_learning_rate(lr_at_epoch(cfg, epoch))
    frozen_names = set(state.optimizer.frozen_names)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats_before = {n: b.clone() for n, b in model.named_buffers() if "running_" in n}
    train_loader, val_loader = train_loaders(cfg)
    step = make_train_step(cfg)
    totals = []

    def recording_step(state, batch, targets, ep, bs):
        state, loss, preds = step(state, batch, targets, ep, bs)
        totals.append(loss["total"])
        return state, loss, preds

    logger = logging.getLogger("chip_smoke")
    kernels.reset_launch_counts()
    start = time.perf_counter()
    state, train_loss = train_one_epoch(cfg, state, recording_step, train_loader,
                                        Metric(cfg, len(train_loader)), epoch, logger)
    val_loss, val_acc, _ = validate(cfg, state, make_eval_step(cfg), val_loader, epoch, logger)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}

    losses = [float(t) for t in totals]
    after = dict(model.named_parameters())
    trainable_changed = {n: not torch.equal(after[n], before[n]) for n in after
                         if n not in frozen_names}
    # conv biases cancel through live BatchNorm: zero gradient, no weight decay
    must_change = [n for n in trainable_changed
                   if not (n.startswith("Base_") and n.endswith(".bias") and "_bn." not in n)]
    frozen_same = all(torch.equal(after[n], before[n]) for n in frozen_names)
    buffers = dict(model.named_buffers())
    stats_changed = {
        tower: all(not torch.equal(buffers[n], v) for n, v in stats_before.items()
                   if n.startswith(tower + "."))
        for tower in TOWERS}
    lr = state.optimizer.current_learning_rate()
    expected_pools = 12 * (len(TRAIN_BATCHES) + len(VAL_BATCHES))
    result = {
        "phase": "train", "gpu": card, "steps": state.step, "seconds": seconds,
        "losses": losses, "train_loss": train_loss, "val_loss": val_loss, "val_acc": val_acc,
        "launches": launches, "expected_max_pool_launches": expected_pools,
        "trainable_changed": sum(trainable_changed.values()),
        "trainable": len(trainable_changed), "must_change": len(must_change),
        "frozen": len(frozen_names), "frozen_bit_identical": frozen_same,
        "running_stats_changed": stats_changed, "lr": lr, "lr_at_epoch": lr_at_epoch(cfg, epoch),
    }
    emit(result)
    if state.step != len(TRAIN_BATCHES) or not all(np.isfinite(losses)):
        failures.append(f"train: steps {state.step}, losses {losses}")
    if not all(np.isfinite(v) for v in list(train_loss.values()) + list(val_loss.values())):
        failures.append(f"train: non-finite epoch losses {train_loss} {val_loss}")
    if not all(trainable_changed[n] for n in must_change):
        failures.append("train: some trainable parameters did not change: "
                        f"{[n for n in must_change if not trainable_changed[n]][:5]}")
    if not frozen_same or not frozen_names:
        failures.append("train: partialbn-frozen BN parameters changed")
    if not all(stats_changed.values()):
        failures.append(f"train: running statistics unchanged in {stats_changed}")
    if lr != lr_at_epoch(cfg, epoch):
        failures.append(f"train: lr {lr} != lr_at_epoch {lr_at_epoch(cfg, epoch)}")
    if launches["max_pool"] != expected_pools:
        failures.append(f"train: max_pool launched {launches['max_pool']} times, "
                        f"expected {expected_pools}")
    for name in ("pe_block", "mha", "max_pool"):  # pe_block and mha in validate
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the training path")
    return state, cfg, launches


def train_timing(state, cfg, card: str) -> dict:
    """Host time of full steps, each ended by a synchronize, after two
    warm-up steps; peak device memory over them."""
    step = make_train_step(cfg)
    loader = SmokeLoader(cfg, [12] * 12, int(cfg.train.num_segments),
                         int(cfg.data.train_crop_size), seed=3)
    batches = list(loader)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for batch, targets, meta in batches:
        start = time.perf_counter()
        step(state, batch, targets, 0, meta["batch_size"])
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
    steady = sorted(times[2:])
    p50 = steady[len(steady) // 2] * 1e3
    result = {"phase": "train_timing", "gpu": card, "batch": 12,
              "segments": int(cfg.train.num_segments), "steps_timed": len(steady),
              "step_ms_p50": p50, "step_ms_min": steady[0] * 1e3,
              "step_ms_max": steady[-1] * 1e3, "clips_per_sec": 12 / (p50 / 1e3),
              "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
              "compute_dtype": cfg.tpu.compute_dtype, "pool_impl": cfg.tpu.pool_impl}
    emit(result)

    # one more step under the profiler; the pool kernel's inputs recorded
    batch, targets, meta = batches[-1]
    layouts = []
    launch = kernels.CeilMaxPool2d.forward_impl

    def recording(x):
        layouts.append("channels_last" if kernels.pool_layout(x) else "nchw")
        return launch(x)

    def one_step():
        step(state, batch, targets, 0, meta["batch_size"])
        torch.cuda.synchronize()

    kernels.CeilMaxPool2d.forward_impl = staticmethod(recording)
    try:
        prof = device_profile(one_step)
    finally:
        kernels.CeilMaxPool2d.forward_impl = staticmethod(launch)
    emit({"phase": "train_profile", "gpu": card, **prof,
          "pool_kernel_layouts": {k: layouts.count(k) for k in set(layouts)}})
    return {**result, "pool_layouts": layouts}


def train_agreement(state_dict: dict, failures: list) -> None:
    """One float32 step (TF32 off, dropout off, deterministic cuDNN) from
    the same weights on the same batch, with the pool kernel and with the
    plain pool: loss and updated parameters must agree."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    try:
        for impl in ("pallas", "reduce_window"):
            cfg = load_config(overrides=[
                "model.pretrained=false", "tpu.compute_dtype=float32", f"tpu.pool_impl={impl}",
                "model.attention.attn_dropout=0", "model.fusion_dropout=0", "data.audio.dropout=0"])
            model = build_model(cfg, get_modality(cfg), device="cuda")
            model.load_state_dict(state_dict, strict=True)
            state = create_train_state(cfg, model)
            batch, targets, meta = next(iter(train_loaders(cfg)[0]))
            kernels.reset_launch_counts()
            _, loss, _ = make_train_step(cfg)(state, batch, targets, 0, meta["batch_size"])
            runs[impl] = (float(loss["total"]), kernels.ceil_max_pool2d.launches,
                          {n: p.detach().clone() for n, p in model.named_parameters()})
            del model, state, batch, targets
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved
    (loss_k, launches_k, params_k), (loss_p, launches_p, params_p) = runs["pallas"], runs[
        "reduce_window"]
    worst, identical = 0.0, 0
    for name, want in params_p.items():
        diff = (params_k[name] - want).abs().max().item()
        worst = max(worst, diff / max(want.abs().max().item(), 1e-12))
        identical += bool(torch.equal(params_k[name], want))
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    emit({"phase": "train_agreement", "loss_pool_kernel": loss_k, "loss_plain_pool": loss_p,
          "loss_rel_diff": loss_rel, "param_max_rel_diff": worst,
          "params_bit_identical": identical, "params": len(params_p),
          "pool_kernel_launches": [launches_k, launches_p], "rtol": TRAIN_AGREEMENT_RTOL})
    if not (loss_rel <= TRAIN_AGREEMENT_RTOL and worst <= TRAIN_AGREEMENT_RTOL):
        failures.append(f"train_agreement: loss rel {loss_rel}, params rel {worst}")
    if launches_k != 12 or launches_p != 0:
        failures.append(f"train_agreement: pool kernel launches {launches_k}, {launches_p}")


def pallas_serving(served: ServingModel, batch: dict, want: dict, card: str,
                   failures: list) -> dict:
    """One b=10 request with tpu.pool_impl=pallas (the same weights) against
    the default config's logits; its latency and launches."""
    cfg = load_config(overrides=["tpu.pool_impl=pallas"])
    model = ServingModel(cfg, served.model.state_dict(), device="cuda", batch_buckets=(10,))
    kernels.reset_launch_counts()
    out = model.predict(batch)
    launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
    atol, rtol = KERNEL_TOL[torch.bfloat16]
    result = {"phase": "serve_pool_kernel", "gpu": card, "launches": launches}
    for head in ("verb", "noun", "weights"):
        diff = float(np.abs(out[head] - want[head]).max())
        tol = atol + rtol * float(np.abs(want[head]).max())
        result[head] = {"max_abs_vs_default": diff, "tolerance": tol}
        if not diff <= tol:
            failures.append(f"pool_impl=pallas serving {head}: {diff} > {tol}")
    result["latency"] = bench(model, 10, 10)
    emit(result)
    for name in ("pe_block", "mha", "max_pool"):
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched serving with pool_impl=pallas")
    if launches["max_pool"] != 12:
        failures.append(f"pool_impl=pallas serving: {launches['max_pool']} pool launches, not 12")
    del model
    torch.cuda.empty_cache()
    return launches


FUSED_OVERRIDES = ["tpu.fused_stem=true", "tpu.fast_consensus=true"]


def fused_serving(served: ServingModel, batch: dict, want: dict, card: str,
                  failures: list) -> dict:
    """One b=10 request with tpu.fused_stem and tpu.fast_consensus on the
    served weights: bf16 logits within the drift bound of the default
    config's, a float32 pair (TF32 off) within FP32_LOGIT_RTOL, one fused
    stem launch per 7x7 tower and a consensus_heads launch per forward, and
    the latency beside the default's."""
    state = served.model.state_dict()
    model = ServingModel(load_config(overrides=FUSED_OVERRIDES), state, device="cuda",
                         batch_buckets=(10,))
    kernels.reset_launch_counts()
    out = model.predict(batch)
    launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
    result = {"phase": "serve_fused", "gpu": card, "overrides": FUSED_OVERRIDES,
              "launches": launches}
    for head in ("verb", "noun"):
        drift = rel_rmse(out[head], want[head])
        result[head] = {"bf16_rel_rmse_vs_default": drift, "rel_rmse_bound": DRIFT_REL_RMSE}
        if not drift < DRIFT_REL_RMSE:
            failures.append(f"fused serving {head}: rel-RMSE {drift} >= {DRIFT_REL_RMSE}")
    result["latency"] = bench(model, 10, 10)
    result["default_latency"] = bench(served, 10, 10)
    del model
    torch.cuda.empty_cache()
    runs = {}
    for name, over in (("default", []), ("fused", FUSED_OVERRIDES)):
        cfg = load_config(overrides=["tpu.compute_dtype=float32"] + over)
        fp32 = ServingModel(cfg, state, device="cuda", batch_buckets=(10,))
        runs[name] = fp32.predict(batch)
        del fp32
        torch.cuda.empty_cache()
    for head in ("verb", "noun"):
        ref = runs["default"][head]
        diff = float(np.abs(runs["fused"][head] - ref).max())
        tol = FP32_LOGIT_RTOL * float(np.abs(ref).max()) + 1e-7
        result[head].update({"fp32_max_abs_vs_default": diff, "fp32_tolerance": tol})
        if not diff <= tol:
            failures.append(f"fused serving fp32 {head}: {diff} > {tol}")
    emit(result)
    if launches["fused_stem"] != 3 or launches["consensus_heads"] < 1:
        failures.append(f"fused serving launches {launches}: want 3 fused_stem, "
                        ">= 1 consensus_heads")
    return launches


def write_test_fixture(root: str, videos: int, actions: int, frames: int, seed: int) -> None:
    """A Flow + Audio Epic-Kitchens tree from numpy and the standard library:
    per video, an .npz flow stack (256 x 342 x 10, so the test transform's
    rescale to the shorter side 256 is a no-op) for every flow frame, as
    links to 8 distinct stacks, and a WAV file; a labelled and an
    unlabelled annotation CSV; a split list."""
    rng = np.random.default_rng(seed)
    sr, fps = 24000, 60
    pool = os.path.join(root, "stacks")
    os.makedirs(pool)
    for k in range(8):
        stack = rng.integers(0, 256, (256, 342, 10), dtype=np.uint8)
        np.savez(os.path.join(pool, f"{k}.npz"), flow=stack)
    os.makedirs(os.path.join(root, "audio"))
    rows = []
    names = [f"P{v + 1:02d}_01" for v in range(videos)]
    for v, vid in enumerate(names):
        flow_dir = os.path.join(root, "flow", vid)
        os.makedirs(flow_dir)
        for i in range(frames // 2 + 8):
            os.symlink(os.path.join(pool, f"{(v * 3 + i) % 8}.npz"),
                       os.path.join(flow_dir, f"frame_{i:010d}.npz"))
        t = np.arange(int(frames / fps * sr) + sr) / sr
        tone = 0.3 * np.sin(2 * np.pi * (300 + 40 * v) * t) + 0.05 * rng.standard_normal(t.shape)
        with wave.open(os.path.join(root, "audio", f"{vid}.wav"), "wb") as handle:
            handle.setnchannels(1)
            handle.setsampwidth(2)
            handle.setframerate(sr)
            handle.writeframes(np.clip(tone * 32767, -32768, 32767).astype("<i2").tobytes())
        span = frames // actions
        for a in range(actions):
            rows.append({"uid": len(rows), "participant_id": vid[:3], "video_id": vid,
                         "start_timestamp": "00:00:00.00", "stop_timestamp": "00:00:01.00",
                         "start_frame": a * span + 2, "stop_frame": (a + 1) * span - 1,
                         "verb_class": int(rng.integers(125)),
                         "noun_class": int(rng.integers(352)), "action_class": len(rows)})
    os.makedirs(os.path.join(root, "annotations"))
    for name, keys in (("labelled.csv", list(rows[0])), ("unlabelled.csv", list(rows[0])[:7])):
        with open(os.path.join(root, "annotations", name), "w", newline="") as fh:
            writer = csv.DictWriter(fh, keys, extrasaction="ignore")
            writer.writeheader()
            writer.writerows(rows)
    with open(os.path.join(root, "split.txt"), "w") as fh:
        fh.write("\n".join(names) + "\n")


def run_log_lines(run_root: str, needle: str) -> list:
    """The lines of the run logs under ``run_root`` that hold ``needle``."""
    found = []
    for dirpath, _, files in sorted(os.walk(run_root)):
        for f in sorted(files):
            if f.endswith(".log"):
                with open(os.path.join(dirpath, f)) as fh:
                    found += [line.strip() for line in fh if needle in line]
    return found


def read_scores(path: str) -> dict:
    """{uid: (verb scores, noun scores)} of a challenge JSON."""
    with open(path) as fh:
        results = json.load(fh)["results"]
    return {uid: tuple(np.array(list(s[h].values()), np.float64) for h in ("verb", "noun"))
            for uid, s in results.items()}


def evaluation_path(card: str, failures: list) -> dict:
    """The evaluation entry point at full width: the port's main in test
    mode on a Flow (.npz) + Audio (WAV) fixture with 10-crop, the fused
    stem, fast consensus and the challenge JSON, from a seeded {"model":
    state_dict} .pth; launch counts set to 0 just before main and read just
    after. Then main again on the same fixture and .pth with the kernels off
    (tpu.fused_stem=false, tpu.use_pallas=false): both challenge JSONs hold
    the same uids and their scores stay within the bf16 drift bound.
    Returns the launches."""
    root = tempfile.mkdtemp(prefix=".smoke_fixture_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        start = time.perf_counter()
        write_test_fixture(root, videos=TEST_VIDEOS, actions=TEST_ACTIONS,
                           frames=120 * TEST_ACTIONS, seed=5)
        model_over = ["data.rgb.enable=false", "model.pretrained=false"]
        cfg = load_config(overrides=model_over)
        model = build_model(cfg, get_modality(cfg), device="cuda", seed=11)
        pth = os.path.join(root, "weights.pth")
        torch.save({"model": model.state_dict()}, pth)
        del model
        torch.cuda.empty_cache()
        setup_s = time.perf_counter() - start
        overrides = model_over + [
            "train.enable=false", "test.enable=true", f"data_dir={root}",
            f"out_dir={root}/out", "exp_name=smoke", "data.flow.read_flow_pickle=true",
            "data.flow.dir_prefix=flow", "test.ten_crop=true", "test.save_results=true",
            "tpu.fused_stem=true", "tpu.fast_consensus=true", f"test.pre_trained={pth}",
            "test.annotation_file=[annotations/labelled.csv, annotations/unlabelled.csv]",
            "test.results_file=[labelled.json, unlabelled.json]",
            f"test.vid_list={root}/split.txt", f"test.batch_size={TEST_BATCH}",
        ]
        kernels.reset_launch_counts()
        start = time.perf_counter()
        results = port_main.main(overrides)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
        uids = [r["uid"] for r in load_annotations(os.path.join(root, "annotations",
                                                                "labelled.csv"))]
        throughput = run_log_lines(os.path.join(root, "out"), "Inference throughput")
        for name in ("fused_stem", "consensus_heads", "pe_block", "mha"):
            if launches[name] < 1:
                failures.append(f"kernel {name} was not launched on the test path")

        # the same fixture and .pth with every kernel off
        plain_over = overrides + ["tpu.fused_stem=false", "tpu.use_pallas=false",
                                  "test.results_file=[plain_labelled.json, plain_unlabelled.json]",
                                  "exp_name=plain"]
        kernels.reset_launch_counts()
        plain_results = port_main.main(plain_over)
        plain_launches = sum(fn.launches for fn in kernels.WRAPPERS.values())
        if plain_launches:
            failures.append(f"test path with the kernels off launched {plain_launches} kernels")
        plain_throughput = run_log_lines(os.path.join(root, "out", "log", "plain"),
                                         "Inference throughput")

        files = {}
        for name in ("labelled.json", "unlabelled.json"):
            got = read_scores(os.path.join(root, "out", "inferences", name))
            want = read_scores(os.path.join(root, "out", "inferences", "plain_" + name))
            complete = (sorted(got) == sorted(uids) == sorted(want) and all(
                len(v) == 125 and len(n) == 352 and np.isfinite(v).all() and np.isfinite(n).all()
                for v, n in got.values()))
            files[name] = {"uids": len(got), "complete": complete}
            if not complete:
                failures.append(f"test path: {name} lacks uids or 125 / 352 finite scores")
                continue
            for h, head in enumerate(("verb", "noun")):
                drift = rel_rmse(np.stack([got[u][h] for u in uids]),
                                 np.stack([want[u][h] for u in uids]))
                files[name][f"{head}_rel_rmse_vs_kernels_off"] = drift
                if not drift < DRIFT_REL_RMSE:
                    failures.append(f"test path {name} {head}: rel-RMSE {drift} vs the "
                                    f"kernels-off run >= {DRIFT_REL_RMSE}")
        labelled = results[0] if results else None
        loss_ok = labelled is not None and np.isfinite(labelled[0]["total"])
        if not loss_ok or results[1] is not None:
            failures.append(f"test path: labelled results {labelled}, unlabelled {results[1]}")
        # once more over the unlabelled file under the profiler: the device's
        # busy share of the loader-in-the-loop sweep
        profiled = overrides + ["test.annotation_file=[annotations/unlabelled.csv]",
                                "test.results_file=[profiled.json]", "exp_name=profiled"]
        profile = device_profile(lambda: (port_main.main(profiled), torch.cuda.synchronize()))
        emit({"phase": "test_path", "gpu": card, "clips": len(uids), "files": files,
              "setup_s": setup_s, "wall_s": wall, "launches": launches,
              "test_loss": labelled[0] if labelled else None,
              "test_acc": labelled[1] if labelled else None,
              "kernels_off_test_loss": (plain_results[0][0]
                                        if plain_results and plain_results[0] else None),
              "throughput_log": throughput, "kernels_off_throughput_log": plain_throughput})
        emit({"phase": "test_path_profile", "gpu": card, "clips": len(uids), **profile})
        for line in throughput:
            print(f"test path: {len(uids)} clips per file; {line.split(' : ')[-1]}", flush=True)
        for line in plain_throughput:
            print(f"test path, kernels off: {line.split(' : ')[-1]}", flush=True)
        print(f"test path: wall {wall:.1f} s for both files", flush=True)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    global _LOG
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default=None, help="also append every JSON line to this file")
    parser.add_argument("--quick", action="store_true",
                        help="build and check the kernels only; prints no ok line")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    logging.basicConfig(stream=sys.stderr, level=logging.INFO, format="%(message)s")
    _LOG = args.out
    if _LOG:
        os.makedirs(os.path.dirname(_LOG) or ".", exist_ok=True)
    failures: list = []
    card = gpu_line()
    start = time.perf_counter()
    build_s = build.build()
    emit({"phase": "env", "gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": time.perf_counter() - start,
          "build_s_by_kernel": build_s,
          "ptxas": {n: [line.split("ptxas info    : ")[-1].strip()
                        for line in build.ptxas_report(n).splitlines() if "Used" in line]
                    for n in build.KERNELS}})

    main_case = check_kernels(failures)
    pool_records = check_max_pool(failures)
    stem_records = check_fused_stem(failures)
    emit({"phase": "fused_stem_serve_forward",
          **stem_forward_summary(stem_records, SERVE_STEMS, "bfloat16")})
    # the two new kernels' main path is the evaluation path: its shapes
    main_case["fused_stem"] = stem_forward_summary(stem_records, TEST_STEMS, "bfloat16")
    consensus_records = check_consensus_heads(failures)
    main_case["consensus_heads"] = next(
        r for r in consensus_records
        if tuple(r["shape"][:2]) == CONSENSUS_SHAPES[-1] and r["dtype"] == "bfloat16")
    if args.quick:
        for failure in failures:
            print(f"FAILED: {failure}", file=sys.stderr)
        return 1 if failures else 0

    # serving path: pe_block and mha
    cfg = load_config()  # flagship defaults: tri-modal MHA, 224^2, 25 seg, bf16, kernels on
    model = ServingModel(cfg, None, device="cuda", batch_buckets=(1, 10))
    kernels.reset_launch_counts()
    outputs = serve_requests(model, failures)
    serve_launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
    emit({"phase": "launches", "path": "serve", **serve_launches})
    for name in ("pe_block", "mha"):
        if serve_launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the main path")

    batch10, out10 = outputs[10]
    check_agreement(model, batch10, out10, failures)

    for b in (1, 10):
        emit({"phase": "latency", "gpu": card, **bench(model, 20, b)})
        emit({**profile_request(model, b), "gpu": card})
        emit({**layer_times(model, b), "gpu": card})
    pallas_serving(model, batch10, out10, card, failures)
    fused_serving(model, batch10, out10, card, failures)
    del model
    torch.cuda.empty_cache()

    # evaluation path: fused_stem and consensus_heads, with pe_block and mha
    test_launches = evaluation_path(card, failures)
    emit({"phase": "launches", "path": "test", **test_launches})

    # training path: the pool kernel, and pe_block / mha in validate
    state, train_cfg, train_launches = train_path(card, failures)
    emit({"phase": "launches", "path": "train", **train_launches})
    timing = train_timing(state, train_cfg, card)
    trained = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    train_agreement(trained, failures)

    layouts = timing["pool_layouts"]
    layout = max(set(layouts), key=layouts.count) if layouts else "nchw"
    pool_case = pool_step_summary(pool_records, POOL_ROWS[0], "bfloat16", layout)
    emit({"phase": "max_pool_train_step", **pool_case})
    main_case["max_pool"] = pool_case
    launches = {"pe_block": serve_launches["pe_block"], "mha": serve_launches["mha"],
                "max_pool": train_launches["max_pool"],
                "fused_stem": test_launches["fused_stem"],
                "consensus_heads": test_launches["consensus_heads"]}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": main_case[name]["max_abs_err"],
         "ms": main_case[name]["ms"], "plain_ms": main_case[name]["plain_ms"],
         "bound_ms": main_case[name]["bound_ms"], "bound_by": main_case[name]["bound_by"],
         "library_ms": main_case[name]["library_ms"]}
        for name in SOURCES
    ]})
    if failures:
        for failure in failures:
            print(f"FAILED: {failure}", file=sys.stderr)
        return 1
    print(card)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

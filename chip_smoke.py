#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --out smoke.jsonl   # every line to a file too
    python3 chip_smoke.py --quick   # build and kernel checks only (no ok line)

Builds the hand-written kernels from ``attention_based_tbn_tpu_torch/ops/csrc``
(one ``nvcc`` per source, all at once) and, beside them, the port's native IO
library (``native/``, g++, with the port's own JPEG decoder), reports the
host's decoders (libjpeg's header and library, cv2, nvJPEG's header, g++:
the env phase), holds the native library
to the checksums recorded with ``native/testdata`` (cv2's decodes of six
JPEGs, the JAX package's read of a 48 kHz WAV) and times its decode (the
native_io phase), counts the wgmma (HGMMA, IGMMA)
instructions in each library's SASS, holds Hopper's wgmma against
``torch.matmul`` (one m64n64k16 product without swizzle, a K = 64 one with
the 128-byte swizzle the kernels use, and a K = 64 one of the register-A
form with A by ldmatrix) and wgmma's s8 form against the exact integer
product (m64nNk32 at every N tile of qconv, the 64-byte swizzle), and
holds each kernel against its plain PyTorch
version at the main paths' shapes, with parameters in the activations'
type as the models pass them: conv3x3 also at BN-Inception shapes (one on
its streaming route) and a ragged one, each record naming the route the
library took (``route``), and a NaN input; consensus_heads with its device
time by CUDA graph (``graph_ms``) at every shape, plus one-row, one-clip,
F = 1024, 2048 and 4096 (a ResNet or VGG tower feeding the heads alone)
and one-, three- and four-head cases. Then drives nine paths,
each with the kernels' launch counts set to 0 just before it and read just
after:

* the fused-block probe: ``tools/fused_block_probe.main`` at its defaults
  (200 x 28 x 28 x 96 -> 128, bf16), conv3x3 against cuDNN and the plain
  version, event-timed and by CUDA graph;
* serving: the flagship model (tri-modal BN-Inception, 224x224 crops, 25
  segments, 2.1 s audio, MHA attention, bf16, kernels on) with seeded
  weights through ``tools/serve.ServingModel``: requests of batch 1, 3 (in
  the 10 bucket) and 10 through ``predict``, and one HTTP POST; the served
  logits are checked against the same weights run in float32 with the
  kernels off; latency, device profile and per-layer times; then one b=10
  request with ``tpu.pool_impl=pallas`` and one with ``tpu.fused_stem`` +
  ``tpu.fast_consensus`` against the default config's;
* evaluation: the port's ``main`` in test mode at full width, tri-modal,
  on RGB JPEG frames (256 x 456), Flow ``.npz`` stacks and WAV audio
  written by the port's ``data/synthetic`` and
  ``preprocessing/create_flow_pickle``, 10-crop, the fused stem on all
  three towers, fast consensus and the challenge JSON, over a labelled and
  an unlabelled annotation file (20 clips each), from a seeded ``{"model":
  state_dict}`` .pth; the same run with every kernel off must give the same
  uids and scores within the bf16 drift bound, and so must the same run
  with ``tpu.native_io=false`` (cv2 and the Python WAV reader); clips/s of
  the three from the run logs, and a device profile of one more sweep;
* training: the flagship recipe (batch 12 x 3 segments, SGD momentum 0.9
  at lr 1e-2, partialbn, clip 20, dropout 0.5, bf16, ``tpu.pool_impl=
  pallas``, seeded weights: ``model.pretrained=false``) through
  ``tools/train.train_one_epoch`` over an in-memory seeded loader (6 batches
  of 12 clips and a ragged one of 7), then ``validate`` on 2 batches of 2
  clips x 25 segments; step time, memory and a device profile of one step;
  and one float32 step with the pool kernel against the same step with the
  plain pool; the same step with ``tpu.remat`` (``remat_step``): its state
  bit-equal to the plain step's, its peak memory below it;
* the int8 towers (``int8_path``, ``tpu.quantize=int8``): the serving
  flagship calibrated, one b=10 int8 forward through ``quantize`` (12 a
  tower) and ``qconv`` (43 a tower; 31 inputs a tower quantized in the
  epilogue of the qconv before them), logits within rel-RMSE 0.2 of bf16,
  both kernels bit-equal to their plain versions at every site shape of a
  b=1 and of that b=10 forward, every output segment included; times at
  the largest sites beside ``torch._int_mm`` and cuDNN's bf16 conv;
* the training entry point: the port's ``main`` in train mode on a
  tri-modal fixture (RGB JPEG frames, Flow JPEG pairs, WAV audio, by the
  port's writers; 40 training clips: 3 batches of 12 and a ragged one of 4;
  5 validation clips at 25 segments) with ``model.pretrained`` towers from
  seeded pretrainedmodels-layout files (the Audio conv1 adapted from 3
  channels), 2 epochs with validation and the best checkpoint; ``main``
  again to resume 1 epoch from the ``.pth`` (the log must continue from
  epoch 3, the history hold 3 epochs); the ``.pth`` reloaded into a fresh
  train state, bit-equal to the trained one; ``main`` in test mode from
  it with the fused stem and fast consensus (the challenge JSON complete);
* the visualizer (``vis_path``, on the training entry point's fixture and
  checkpoint): ``models/convert_back``'s CLI writes the reference ``.pth``
  (seconds, bytes), which reloads strictly through ``load_weights`` with
  logits bit-equal to the checkpoint's own; ``tools/vis.initialize`` from
  it (``config_vis``: 3 segments, batch 1, bf16, kernels on),
  ``create_dataset`` on the two (verb, noun) pairs with the most clips,
  ``get_info`` on up to 8 samples (``pe_block`` and ``mha`` launched once
  a forward) against the same with ``tpu.use_pallas=false`` (scores within
  the drift bound; argmax agreement, entropy gap), ``panels``' shapes, the
  PNG where matplotlib imports and the clip where cv2 does; one general
  MHA call (3 queries, key != value, float32) against the CPU;
  ``models/convert_cli`` on a seeded BN-Inception tower, bit-equal through
  ``load_npz``;
* the serving export: the flagship with ``tpu.fused_stem``,
  ``tpu.fast_consensus`` and ``tpu.pool_impl=pallas`` exported by
  ``tools/export.export_inference`` as a bf16 bundle (batch 10, a bucket
  of 1) and an int8 one (batch 10), served by ``tools/serve.BundleModel``:
  each ``torch.export`` program must hold the five kernels' ``tbn::`` op
  nodes and launch them; b = 1, 3 and 10 against the eager model on the
  bundle's own weights within rel-RMSE 1e-3; the int8 ``params.pt`` stored
  as int8 in under 0.6x the bf16 one's bytes; ten concurrent b=1 requests
  through a ``BatchingFront`` equal to their lone predicts, one group at
  least coalesced; export seconds, bytes, latency and device launches per
  request beside the eager model's;
* the tower families (``arch_path``): ResNet-101 (tri-modal, attention
  off, 224^2, 25 segments, bf16, fast consensus, kernels on, seeded
  weights) served at b = 1 and 10 against the same weights in float32
  with the kernels off and in bf16 with them off (the drift bound), with
  latency, peak memory and a device profile (cuDNN convs, the BatchNorm
  affine, the rest); evaluated through ``main`` (Flow .npz + Audio, 10-crop,
  10 clips in each of two files, the challenge JSON; again with the
  kernels off, scores compared); trained (12 x 3 segments, two warm-ups,
  four timed steps); exported as a bf16 bundle at batch 1 and served
  against eager on its own weights; then VGG-16 served at b = 1 and 2 (its
  Audio tower's 8 x 13 map through the adaptive pool to 7 x 7).
  consensus_heads must launch on each part;
* data parallelism (``multi_rank_path``, ``parallel/mesh``): this script's
  worker under ``torch.distributed.run`` on R = max(2, cards) ranks, one
  card each over NCCL, or sharing one card over gloo (the backend is
  printed); (a) three flagship train steps at full width (12 x 3 global
  batches, seeded pretrained towers, ``tpu.pool_impl=pallas``; the third
  ragged, 11 true rows, rank R-1 holding the pad row) at float32 and bf16,
  against the same steps in this process: float32 losses within 1e-4
  relative, parameters and running statistics within rel-RMSE 1e-3, their
  change over the three steps (each state minus the initial one) within
  1e-2 and 1e-3; bf16 within the drift bound 0.04, the parameters' change
  within one process's bf16 change against its float32 one; every rank's
  state bit-equal;
  (b) ``main`` in train mode on the trainer's tri-modal fixture, 1 epoch +
  validation, then a resume of 1 (from epoch 2): rank 0 alone writes,
  every rank's state digest equals the ``.pth`` read back; (c) ``main`` in
  test mode from it (10-crop, fused stem, fast consensus) on the
  evaluation's fixture, 20 clips in global batches of 4, at float32 and
  bf16 on R ranks and here: one JSON each, the same uid order, scores
  within rel-RMSE 1e-3 (float32) and 0.04 (bf16); and here at bf16 with a
  batch of 1 against 4. Per rank: step p50, the share of it in collectives (CUDA
  events around every all-reduce), launches; global sustained clips/s. The
  kernels line's launches are this path's, rank 0's (conv3x3's the
  probe's).

One JSON line per phase; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
no CUDA device is present or any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import hashlib
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
from attention_based_tbn_tpu_torch import native
from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.data import synthetic
from attention_based_tbn_tpu_torch.data.loader import collate
from attention_based_tbn_tpu_torch.data.records import load_annotations
from attention_based_tbn_tpu_torch.models.attention import (
    PE_CHANNELS, MultiheadAttention, positional_encoding_table,
)
from attention_based_tbn_tpu_torch.models.bn_inception import BN_INCEPTION_BLOCKS, BNInception
from attention_based_tbn_tpu_torch.models import layers
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.models import convert_back, convert_cli
from attention_based_tbn_tpu_torch.models.convert import convert_bninception, load_npz_tower
from attention_based_tbn_tpu_torch.ops import build, kernels
from attention_based_tbn_tpu_torch.parallel.optim import lr_at_epoch
from attention_based_tbn_tpu_torch.preprocessing import create_flow_pickle
from attention_based_tbn_tpu_torch.parallel.train_step import (
    create_train_state, make_eval_step, make_train_step,
)
from attention_based_tbn_tpu_torch.tools import fused_block_probe
from attention_based_tbn_tpu_torch.tools.serve import ServingModel, bench, make_server
from attention_based_tbn_tpu_torch.tools import train as port_train
from attention_based_tbn_tpu_torch.tools import vis
from attention_based_tbn_tpu_torch.tools.train import checkpoint_stem, train_one_epoch, validate
from attention_based_tbn_tpu_torch.utils import checkpoint
from attention_based_tbn_tpu_torch.utils.metrics import Metric
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from attention_based_tbn_tpu_torch.utils.device import tf32_scope
from attention_based_tbn_tpu_torch.utils.timing import event_ms, graph_ms

# Published peaks of one H100 SXM (dense): HBM bytes/s and operations/s by
# the activations' type (bf16 tensor cores; fp32 outside the tensor cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12, torch.int8: 1979e12}
# Kernel vs plain version: |err| <= atol + rtol * max|plain|. fp32 differs
# only in summation order over 1024-long dot products; bf16 also in the
# final rounding of outputs up to ~8 (one bf16 ulp there is 0.03).
KERNEL_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}
# The wgmma descriptor check: exact bf16 products, fp32 sums of 16 or 64
# terms in another order than torch.matmul's.
WGMMA_RTOL = 1e-5
# Served (bf16, kernels) vs float32 plain logits: the repo's bf16 drift
# bound (tests/test_bf16_drift.py). float32 kernels vs float32 plain: the
# kernels' own fp32 error carried to the logits.
DRIFT_REL_RMSE = 0.04
FP32_LOGIT_RTOL = 1e-4
ROWS = (25, 250)  # B*N at b=1 and b=10 with 25 segments
# config_vis: a visualizer forward holds one clip of 3 segments
VIS_ROWS = 3
# pe_block / mha rows: also one evaluation batch's 2 clips x 10 crops x 25,
# and the visualizer's forward
KERNEL_ROWS = (VIS_ROWS,) + ROWS + (500,)
S, E, HEADS = 13, 1024, 4
REPLACES = {
    "pe_block": "attention_based_tbn_tpu/ops/pallas_kernels.py:122",
    "mha": "attention_based_tbn_tpu/ops/pallas_kernels.py:232",
    "max_pool": "attention_based_tbn_tpu/ops/pallas_pool.py:88",
    "fused_stem": "attention_based_tbn_tpu/ops/fused_stem.py:264",
    "consensus_heads": "attention_based_tbn_tpu/ops/pallas_kernels.py:299",
    "conv3x3": "benchmarks/fused_block_probe.py:76",
    # XLA's s8 convolution and its quantize, not a pallas_call
    "quantize": "attention_based_tbn_tpu/models/layers.py:54",
    "qconv": "attention_based_tbn_tpu/models/layers.py:54",
}
SOURCES = {
    "pe_block": "attention_based_tbn_tpu_torch/ops/csrc/pe_block.cu",
    "mha": "attention_based_tbn_tpu_torch/ops/csrc/mha.cu",
    "max_pool": "attention_based_tbn_tpu_torch/ops/csrc/max_pool.cu",
    "fused_stem": "attention_based_tbn_tpu_torch/ops/csrc/fused_stem.cu",
    "consensus_heads": "attention_based_tbn_tpu_torch/ops/csrc/consensus_heads.cu",
    "conv3x3": "attention_based_tbn_tpu_torch/ops/csrc/conv3x3.cu",
    "quantize": "attention_based_tbn_tpu_torch/ops/csrc/qconv.cu",
    "qconv": "attention_based_tbn_tpu_torch/ops/csrc/qconv.cu",
}
# (H, W, C, input type) of each tower's stem input on the main paths: uint8
# 224x224 RGB and 10-channel Flow, the float32 256x420 spectrogram of 2.1 s
# audio; normalization affine per modality (RGB BGR mean, Flow 0.502).
STEM_INPUTS = {
    "RGB": (224, 224, 3, torch.uint8, (0.408, 0.459, 0.502)),
    "Flow": (224, 224, 10, torch.uint8, (0.502,) * 10),
    "Audio": (256, 420, 1, torch.float32, None),
}
# (case, rows, H, W, C_in, C_out) of the conv3x3 checks: the fused-block
# probe's default; BN-Inception's inception_3a_double_3x3_1 (28 x 28, 64 ->
# 96) at a b=10 served request's 250 rows; a ragged case (odd H and W, one
# image, C_in and C_out multiples of 8 only, C_out inside one 64-wide tile);
# BN-Inception's inception_5a_3x3 (7 x 7, an image smaller than one tile,
# 192 -> 320), whose weight does not fit a block: the streaming route.
CONV3X3_CASES = (
    ("probe", fused_block_probe.BATCH, *fused_block_probe.DEFAULT_SHAPE),
    ("inception_3a_double_3x3_1", 250, 28, 28, 64, 96),
    ("ragged", 1, 13, 17, 24, 40),
    ("inception_5a_3x3", 250, 7, 7, 192, 320),
)
CLASS_HEADS = (125, 352)  # verb, noun
FUSION = 512
# The evaluation path: 2 clips x 25 segments per batch, RGB and Flow
# 10-cropped; videos x actions clips in each of its two annotation files
# (20: cut from 200, then 100, then 40, to keep the whole smoke, RGB decode,
# the fixture's JPEGs and the multi-rank path included, near half its
# limit), each action spanning TEST_SPAN frames of its video.
TEST_BATCH = 2
TEST_VIDEOS, TEST_ACTIONS, TEST_SPAN = 4, 5, 12
TEST_STEMS = (("RGB", 500), ("Flow", 500), ("Audio", 50))  # (modality, rows) of one forward's stems
# Epic-Kitchens-55's frame size (H, W): the fixtures' RGB frames and Flow maps
EK55_FRAME = (256, 456)
UNLABELLED_KEYS = ["uid", "participant_id", "video_id", "start_timestamp", "stop_timestamp",
                   "start_frame", "stop_frame"]
# native_io: the committed JPEGs and WAV, and their recorded checksums
NATIVE_TESTDATA = os.path.join(os.path.dirname(os.path.abspath(native.__file__)), "testdata")
SERVE_STEMS = tuple((m, ROWS[-1]) for m in STEM_INPUTS)  # a b=10 served request's
CONSENSUS_SHAPES = ((10, ROWS[0]), (10, ROWS[-1]), (TEST_BATCH, 10 * ROWS[0]))  # (B, N)
# More consensus_heads cases, (B, N, F, heads, offset): one segment row
# (fewer rows than the cluster's 8 blocks); three heads; one clip; F = 1024
# (a single-modality model without Fusion); one head; four heads; and the
# kernel's element-wise loads: F = 100 (not a multiple of 8 or 4), and
# features starting `offset` elements into their buffer (not on 16 bytes).
CONSENSUS_EXTRA = (
    (TEST_BATCH, 1, FUSION, CLASS_HEADS, 0),
    (TEST_BATCH, 10 * ROWS[0], FUSION, (125, 352, 97), 0),
    (1, 10 * ROWS[0], FUSION, CLASS_HEADS, 0),
    (TEST_BATCH, ROWS[0], 1024, CLASS_HEADS, 0),
    (TEST_BATCH, ROWS[0], FUSION, (97,), 0),
    (3, 10, FUSION, (125, 352, 97, 8), 0),
    (TEST_BATCH, ROWS[0], 100, CLASS_HEADS, 0),
    (TEST_BATCH, ROWS[0], FUSION, CLASS_HEADS, 1),
    # one modality's ResNet (F = 2048, depth 50 on) or VGG (F = 4096)
    # tower feeding the heads without Fusion, at a b=10 request's (10, 25)
    (10, ROWS[0], 2048, CLASS_HEADS, 0),
    (10, ROWS[0], 4096, CLASS_HEADS, 0),
)
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
# The training entry point (trainer_path): the port's main in train mode on
# a tri-modal fixture (RGB JPEG frames, Flow JPEG pairs, WAV audio) of
# TRAINER_VIDEOS videos of TRAINER_ACTIONS clips (TEST_SPAN frames each):
# the first TRAINER_TRAIN_VIDEOS train, 3 full batches of 12 clips and a
# ragged one of 4, the last validates, 5 clips at 25 segments; pretrained
# towers from seeded files.
TRAINER_VIDEOS, TRAINER_TRAIN_VIDEOS, TRAINER_ACTIONS = 9, 8, 5
TRAINER_TRAIN_CLIPS = TRAINER_TRAIN_VIDEOS * TRAINER_ACTIONS
TRAINER_VAL_CLIPS = (TRAINER_VIDEOS - TRAINER_TRAIN_VIDEOS) * TRAINER_ACTIONS
TRAINER_KERNELS = ("max_pool", "pe_block", "mha", "fused_stem", "consensus_heads")
# One float32 step (TF32 off, dropout 0, deterministic cuDNN) with the pool
# kernel vs the plain pool: the pools are exact, so any gap is cuDNN's
# summation order; loss and parameters within this relative tolerance.
TRAIN_AGREEMENT_RTOL = 1e-5
# The int8 towers (int8_path): calibration on INT8_CALIBRATION seeded b=10
# batches; the int8 logits within INT8_REL_RMSE of the bf16 ones (the JAX
# package's bound, tests/test_quantize.py test_flagship_quantized_forward).
# Launches a tower, from models/bn_inception.py: qconv at the two conv2
# cells, four sites a block (the merged 1x1, 3x3, double_3x3_1,
# double_3x3_2) and the proj of each max-pool branch (inception_5b): 43;
# quantize where no qconv produced the site's input (conv2_3x3_reduce's,
# each block's, the max-pool branch's pooled input): 12. The other 31
# inputs are int8 segments of the qconv before them.
INT8_CALIBRATION = 2
INT8_REL_RMSE = 0.2
INT8_QCONV_PER_TOWER = 2 + sum(4 + (b.proj > 0 and b.pool == "max")
                               for _, b in BN_INCEPTION_BLOCKS)
INT8_QUANTIZE_PER_TOWER = 1 + sum(1 + (b.proj > 0 and b.pool == "max")
                                  for _, b in BN_INCEPTION_BLOCKS)
INT8_FOLDED_PER_TOWER = 1 + 3 * len(BN_INCEPTION_BLOCKS)

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


def decoder_report() -> dict:
    """What this machine offers to decode JPEG and to build the port's
    native IO library: libjpeg's header (with ``JPEG_LIB_VERSION``) and
    shared libraries, cv2 (imported, and decoding a JPEG it encoded),
    nvJPEG's header and g++."""
    prefixes = ["/usr/include", "/usr/local/include", os.path.join(sys.prefix, "include")]
    prefixes += [os.path.join("/usr/include", d) for d in ("x86_64-linux-gnu",
                                                         "aarch64-linux-gnu")]
    headers = [p for d in prefixes for p in [os.path.join(d, "jpeglib.h")] if os.path.isfile(p)]
    version = None
    for d in prefixes:
        for name in ("jconfig.h", "jpeglib.h"):
            path = os.path.join(d, name)
            if version is None and os.path.isfile(path):
                with open(path, errors="replace") as fh:
                    for line in fh:
                        if line.startswith("#define JPEG_LIB_VERSION"):
                            version = line.split()[2]
                            break
    libs = []
    for d in ("/usr/lib/x86_64-linux-gnu", "/usr/lib64", "/usr/lib", "/usr/local/lib",
              "/lib/x86_64-linux-gnu", os.path.join(sys.prefix, "lib")):
        if os.path.isdir(d):
            libs += sorted(os.path.join(d, f) for f in os.listdir(d) if f.startswith("libjpeg.so"))
    report = {"jpeglib_h": headers, "jpeg_lib_version": version, "libjpeg_so": libs,
              "nvjpeg_h": [p for p in ("/usr/local/cuda/include/nvjpeg.h",)
                           if os.path.isfile(p)],
              "gxx": shutil.which("g++"), "cv2": None, "cv2_imread_jpeg": False}
    try:
        import cv2
        report["cv2"] = cv2.__version__
        ok, data = cv2.imencode(".jpg", np.full((16, 16, 3), 128, np.uint8))
        with tempfile.NamedTemporaryFile(suffix=".jpg") as fh:
            fh.write(data.tobytes())
            fh.flush()
            img = cv2.imread(fh.name)
        report["cv2_imread_jpeg"] = bool(ok and img is not None and img.shape == (16, 16, 3))
    except ImportError as exc:
        report["cv2_error"] = str(exc)
    return report


def bound(bytes_moved: float, ops: float, dtype) -> tuple:
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kernel_inputs(rows: int, dtype, gen: torch.Generator):
    """Seeded flagship-shape inputs of both kernels, on the card, the table
    and the parameters in ``dtype`` as the models pass them (rounded once
    from float32 at bf16)."""
    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).cuda().to(dtype)

    x = rnd(rows, S, E)
    # the table as the model passes it: a transposed view of a (D, S) buffer
    table = positional_encoding_table(PE_CHANNELS, S)
    pe = dict(
        pe_table=torch.from_numpy(table.T.copy()).cuda().to(dtype).T,
        conv_weight=rnd(E, E + PE_CHANNELS, scale=0.03), conv_bias=rnd(E, scale=0.1),
        gn_scale=(torch.rand(E, generator=gen) + 0.5).cuda().to(dtype), gn_bias=rnd(E, scale=0.1),
    )
    mha = dict(
        in_proj_weight=rnd(3 * E, E, scale=0.03), in_proj_bias=rnd(3 * E, scale=0.1),
        out_proj_weight=rnd(E, E, scale=0.03), out_proj_bias=rnd(E, scale=0.1),
    )
    query = rnd(rows, E)
    return x, pe, query, mha


def pe_block_cost(rows: int, dtype) -> tuple:
    elt = torch.finfo(dtype).bits // 8  # activations, table and parameters
    moved = elt * (2 * rows * S * E + E * (E + PE_CHANNELS) + 3 * E + S * PE_CHANNELS)
    ops = 2 * rows * S * E * E + 2 * S * PE_CHANNELS * E + 7 * rows * S * E
    return bound(moved, ops, dtype)


def mha_cost(rows: int, dtype) -> tuple:
    elt = torch.finfo(dtype).bits // 8
    # query, keyval (read once: k and v come from it), out, weights; params
    moved = elt * (2 * rows * E + rows * S * E + rows * S + 4 * E * E + 4 * E)
    ops = 4 * rows * E * E + 4 * rows * S * E * E + 4 * rows * S * E
    return bound(moved, ops, dtype)


def max_pool_cost(rows: int, c: int, h: int, w: int, dtype, backward: bool = False) -> tuple:
    """Forward: each input element read once, each output written once; 8
    comparisons per output on the fp32 ALUs (the kernel compares in fp32).
    With ``backward``, also the training pair's extra bytes: the forward's
    tap byte per output, and the backward's gradient and taps read once and
    dx written once."""
    elt = torch.finfo(dtype).bits // 8
    inputs = rows * c * h * w
    outputs = rows * c * kernels.ceil_out_size(h) * kernels.ceil_out_size(w)
    moved = elt * (inputs + outputs)
    if backward:
        moved += outputs + elt * outputs + outputs + elt * inputs
    return bound(moved, 8 * outputs + (4 * inputs if backward else 0), torch.float32)


def pool_input(rows: int, c: int, h: int, w: int, dtype, gen, ties: bool):
    """Seeded NCHW input: N(0, 1), or with ``ties`` the values 0, 1, 2 (exact
    ties in most windows) and NaN at every 997th element and the one after
    it (two NaNs in a window: the last one wins)."""
    if not ties:
        return torch.randn(rows, c, h, w, generator=gen, device="cuda", dtype=dtype)
    x = torch.randint(0, 3, (rows, c, h, w), generator=gen, device="cuda").to(dtype)
    flat = x.view(-1)
    flat[::997] = float("nan")
    flat[1::997] = float("nan")
    return x


def pool_pair(x, gen) -> dict:
    """The kernels against torch on one input: the forward (NaN where torch
    has NaN, equal elsewhere, in x's memory format) and the gradient of the
    autograd Function (taps forward, gather backward) against torch's
    autograd, both exact."""
    fmt = torch.channels_last if kernels.pool_layout(x) else torch.contiguous_format
    got, want = kernels.ceil_max_pool2d(x), kernels.ceil_max_pool2d_plain(x)
    xg = x.detach().requires_grad_(True)
    g = torch.randn(want.shape, generator=gen, device="cuda", dtype=x.dtype).contiguous(
        memory_format=fmt)
    (dx,) = torch.autograd.grad(kernels.ceil_max_pool2d(xg), xg, g)
    (dw,) = torch.autograd.grad(kernels.ceil_max_pool2d_plain(xg), xg, g)
    torch.cuda.synchronize()
    same = (got == want) | (got.isnan() & want.isnan())
    finite = ~want.isnan()
    return {
        "exact": bool(same.all()) and got.is_contiguous(memory_format=fmt),
        "grad_exact": bool(torch.equal(dx, dw)) and dx.is_contiguous(memory_format=fmt),
        "max_abs_err": (got.float() - want.float())[finite].abs().max().item(),
        "grad_max_abs_err": (dx.float() - dw.float()).abs().max().item(),
        "nan_outputs": int(want.isnan().sum()),
    }


def check_max_pool(failures: list) -> list:
    """The pool kernels against torch's pool (the plain version, also the
    one-call library yardstick) at every tower pool shape, POOL_ROWS rows,
    fp32 and bf16, NCHW and channels-last: the forward must be exact, in
    the input's memory format, and the gradient through the autograd
    Function (the forward's taps, the gather kernel) bit-equal to torch's
    autograd; at the train step's rows also on an input of ties and NaNs.
    Times the forward alone and forward + backward against torch's (event
    timing of back-to-back calls, and at the train step's rows also each
    call's device time from a CUDA graph). Returns one record per case."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for rows in POOL_ROWS:
        for tower, shapes in POOL_SHAPES.items():
            for c, h, w in shapes:
                for dtype in (torch.float32, torch.bfloat16):
                    for ties in ((False, True) if rows == POOL_ROWS[0] else (False,)):
                        base = pool_input(rows, c, h, w, dtype, gen, ties)
                        for channels_last in (False, True):
                            fmt = torch.channels_last if channels_last else torch.contiguous_format
                            x = base.contiguous(memory_format=fmt)
                            record = {
                                "phase": "max_pool_check", "tower": tower, "rows": rows,
                                "shape": [c, h, w], "dtype": str(dtype).replace("torch.", ""),
                                "layout": "channels_last" if channels_last else "nchw",
                                "input": "ties_nan" if ties else "normal", **pool_pair(x, gen),
                            }
                            if not ties:
                                record.update(time_pool(x, gen))
                                record["bound_ms"], record["bound_by"] = max_pool_cost(
                                    rows, c, h, w, dtype)
                                record["fwd_bwd_bound_ms"] = max_pool_cost(
                                    rows, c, h, w, dtype, backward=True)[0]
                            emit(record)
                            records.append(record)
                            if not (record["exact"] and record["grad_exact"]):
                                failures.append(
                                    f"max_pool {rows}x{c}x{h}x{w} {dtype} {record['layout']} "
                                    f"{record['input']}: exact={record['exact']} "
                                    f"grad_exact={record['grad_exact']}")
                        del base, x
    torch.cuda.empty_cache()
    return [r for r in records if r["input"] == "normal"]


def time_pool(x, gen) -> dict:
    """Device times of the kernel's forward, torch's forward, and of forward
    + backward through each (the kernel's with its taps), by CUDA events."""
    fmt = torch.channels_last if kernels.pool_layout(x) else torch.contiguous_format
    xg = x.detach().requires_grad_(True)
    out = kernels.ceil_max_pool2d_plain(x)
    g = torch.randn(out.shape, generator=gen, device="cuda", dtype=x.dtype).contiguous(
        memory_format=fmt)

    def pair(fn):
        return lambda: torch.autograd.grad(fn(xg), xg, g)

    fns = {"": lambda: kernels.ceil_max_pool2d(x),
           "plain_": lambda: kernels.ceil_max_pool2d_plain(x),
           "fwd_bwd_": pair(kernels.ceil_max_pool2d),
           "torch_fwd_bwd_": pair(kernels.ceil_max_pool2d_plain)}
    times = {f"{k}ms": event_ms(fn, 20) for k, fn in fns.items()}
    if x.shape[0] == POOL_ROWS[0]:  # the train step's pools: also the device's own time
        times.update({f"{k}device_ms": graph_ms(fn) for k, fn in fns.items()})
    return times


def uniform_pool_calls(layout: str) -> list:
    """(shape, layout) of the twelve stride-2 pools of one forward (4 per
    tower, RGB and Flow at the visual shapes, Audio at its own), all in
    one layout."""
    return [(shape, layout) for t in TOWERS for shape in POOL_SHAPES[TOWERS[t]]]


def pool_step_summary(records: list, rows: int, dtype: str, calls: list) -> dict:
    """The pools of one forward, ``calls`` as (shape, layout), summed from
    the check's records: the forward's ms, plain ms and bound, and forward
    + backward against torch's."""
    by_case = {(tuple(r["shape"]), r["layout"]): r for r in records
               if r["rows"] == rows and r["dtype"] == dtype}
    pools = [by_case[(tuple(shape), layout)] for shape, layout in calls]
    keys = ("ms", "plain_ms", "bound_ms", "fwd_bwd_ms", "torch_fwd_bwd_ms", "fwd_bwd_bound_ms",
            "device_ms", "plain_device_ms", "fwd_bwd_device_ms", "torch_fwd_bwd_device_ms")
    total = {k: sum(r[k] for r in pools) for k in keys if k in pools[0]}
    layouts = [layout for _, layout in calls]
    return {**total, "library_ms": total["plain_ms"], "bound_by": "bytes",
            "max_abs_err": max(r["max_abs_err"] for r in pools), "rows": rows,
            "dtype": dtype, "layouts": {k: layouts.count(k) for k in sorted(set(layouts))},
            "pools": len(pools)}


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
                "ms": event_ms(lambda: kernels.fused_stem(*args, dtype), 10),
                "plain_ms": event_ms(lambda: stem_composition(*args, dtype), 10),
                "plain_function_ms": event_ms(lambda: kernels.fused_stem_plain(*args, dtype), 3),
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


def consensus_cost(b: int, n: int, dtype, heads=CLASS_HEADS, f=FUSION) -> tuple:
    """Features, weights, biases (in the features' type) and fp32 logits
    once; N adds per feature and a multiply-add per feature and class, on
    the fp32 units (the kernel computes in fp32)."""
    elt = torch.finfo(dtype).bits // 8
    classes = sum(heads)
    moved = elt * (b * n * f + classes * f + classes) + 4 * b * classes
    ops = b * n * f + 2 * b * f * classes
    return bound(moved, ops, torch.float32)


def check_consensus_heads(failures: list) -> list:
    """The consensus + heads kernel against its plain version at (B, N,
    512) for (B, N) in CONSENSUS_SHAPES with the verb / noun heads, and at
    CONSENSUS_EXTRA, fp32 and bf16 features: ms event-timed (back-to-back
    calls: the wrapper's host work), graph_ms by CUDA graph (the kernel's
    device time); composition_ms is the port's fast consensus without the
    kernel (mean, round to the compute type, Linear heads in it). Heads on
    the CPU with features on the card must raise."""
    gen = torch.Generator().manual_seed(4)
    records = []
    cases = [(b, n, FUSION, CLASS_HEADS, 0) for b, n in CONSENSUS_SHAPES] + list(
        CONSENSUS_EXTRA)
    for b, n, f, heads, offset in cases:
        for dtype in (torch.float32, torch.bfloat16):
            feats = torch.randn(b, n, f, generator=gen).relu().to(dtype)
            # `offset` elements into a larger buffer on the card: contiguous,
            # but not on 16 bytes
            feats = torch.empty(offset + feats.numel(), dtype=dtype, device="cuda")[
                offset:].view(b, n, f).copy_(feats)
            # parameters in the features' type, as the model passes them
            weights = [(torch.randn(c, f, generator=gen) * 0.03).cuda().to(dtype)
                       for c in heads]
            biases = [(torch.randn(c, generator=gen) * 0.1).cuda().to(dtype) for c in heads]

            def kernel():
                return kernels.consensus_heads(feats, weights, biases)

            def plain():
                return kernels.consensus_heads_plain(feats, weights, biases)

            def composition():
                pooled = feats.float().mean(dim=1).to(dtype)
                return [(torch.nn.functional.linear(pooled, w) + v).float()
                        for w, v in zip(weights, biases)]

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[dtype]  # at bf16 a logit may round one ulp apart
            errs = [(g - w).abs().max().item() for g, w in zip(got, want)]
            tols = [atol + rtol * w.abs().max().item() for w in want]
            ok = all(e <= t for e, t in zip(errs, tols)) and all(
                tuple(g.shape) == tuple(w.shape) and g.is_contiguous() for g, w in zip(got, want))
            bound_ms, bound_by = consensus_cost(b, n, dtype, heads, f)
            record = {
                "phase": "consensus_heads_check", "shape": [b, n, f],
                "heads": list(heads), "offset": offset,
                "dtype": str(dtype).replace("torch.", ""), "max_abs_err": max(errs),
                "tolerance": tols, "ok": ok,
                "ms": event_ms(kernel), "graph_ms": graph_ms(kernel),
                "plain_ms": event_ms(plain), "composition_ms": event_ms(composition),
                "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            }
            emit(record)
            records.append(record)
            if not ok:
                failures.append(f"consensus_heads {b}x{n}x{f} {heads} +{offset} {dtype}: "
                                f"{errs} > {tols}")
    # heads left on the CPU with features on the card: refused before a launch
    try:
        kernels.consensus_heads(feats, [w.cpu() for w in weights], [v.cpu() for v in biases])
        failures.append("consensus_heads took CPU heads with features on the card")
    except ValueError:
        pass
    return records


def conv3x3_cost(rows: int, h: int, w: int, c_in: int, c_out: int, dtype) -> tuple:
    """x, the weight, the bias and the output once, in the activations'
    type; 2 * 9 C_in operations per output for the products, and its bias
    and ReLU, at the peak of ``dtype`` (bf16 tensor cores, or fp32 units)."""
    elt = torch.finfo(dtype).bits // 8
    positions = rows * h * w
    moved = elt * (positions * (c_in + c_out) + 9 * c_in * c_out + c_out)
    ops = positions * c_out * (2 * 9 * c_in + 2)
    return bound(moved, ops, dtype)


def check_conv3x3(failures: list) -> list:
    """The conv3x3 kernel against its plain version at CONV3X3_CASES, fp32
    (TF32 off) and bf16, weight and bias in the activations' type as the
    probe passes them; each record names the route the library took (which
    must be the one kernels.conv3x3_route names): ms (event-timed),
    graph_ms (CUDA graph), the plain
    version's ms, and library_ms, the cuDNN composition on the same NHWC
    memory (``F.conv2d`` with the bias in channels-last, then ``F.relu``:
    two calls). A bf16 input whose C_in the kernel cannot take must raise.
    Returns one record per case."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(7)
    records = []
    for case, rows, h, w, c_in, c_out in CONV3X3_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(rows, h, w, c_in, generator=gen).cuda().to(dtype)
            weight = (torch.randn(c_out, c_in, 3, 3, generator=gen) / (9 * c_in) ** 0.5).cuda()
            weight, bias = weight.to(dtype), torch.randn(c_out, generator=gen).cuda().to(dtype)
            x_nchw = x.permute(0, 3, 1, 2)  # channels-last view of the NHWC memory
            weight_cl = weight.contiguous(memory_format=torch.channels_last)

            def kernel():
                return kernels.conv3x3(x, weight, bias)

            def plain():
                return kernels.conv3x3_plain(x, weight, bias)

            def library():
                return torch.nn.functional.relu(
                    torch.nn.functional.conv2d(x_nchw, weight_cl, bias, 1, 1), inplace=True)

            got, want = kernel(), plain()
            torch.cuda.synchronize()
            atol, rtol = KERNEL_TOL[dtype]
            err = (got.float() - want.float()).abs().max().item()
            tol = atol + rtol * want.float().abs().max().item()
            ok = (err <= tol and tuple(got.shape) == tuple(want.shape)
                  and got.is_contiguous())
            bound_ms, bound_by = conv3x3_cost(rows, h, w, c_in, c_out, dtype)
            # the route kernels.py names, and the one the library takes
            route = kernels.conv3x3_route(x.shape, c_out, dtype)
            library_route = kernels.conv3x3_library_route(x.shape, c_out, dtype)
            record = {
                "phase": "conv3x3_check", "case": case, "rows": rows,
                "shape": [h, w, c_in, c_out], "dtype": str(dtype).replace("torch.", ""),
                "route": library_route, "max_abs_err": err, "tolerance": tol, "ok": ok,
                "library_vs_plain_max_abs": (library().permute(0, 2, 3, 1).float()
                                             - want.float()).abs().max().item(),
                "ms": event_ms(kernel, 20), "graph_ms": graph_ms(kernel),
                "plain_ms": event_ms(plain, 5), "library_ms": event_ms(library, 20),
                "library_graph_ms": graph_ms(library), "bound_ms": bound_ms,
                "bound_by": bound_by,
            }
            emit(record)
            records.append(record)
            if not ok:
                failures.append(f"conv3x3 {case} {dtype}: err {err} > {tol}")
            if route != library_route:
                failures.append(f"conv3x3 {case} {dtype}: kernels.py names route {route}, "
                                f"the library takes {library_route}")
            del x, weight, bias, x_nchw, weight_cl, got, want
    # a NaN in x reaches every output whose window holds it, on both routes
    for c_in in (32, 192):
        x = torch.randn(2, 9, 9, c_in, generator=gen).cuda().to(torch.bfloat16)
        x[1, 4, 4, 3] = float("nan")
        weight = torch.randn(16, c_in, 3, 3, generator=gen).cuda().to(torch.bfloat16) / c_in
        bias = torch.randn(16, generator=gen).cuda().to(torch.bfloat16)
        got, want = kernels.conv3x3(x, weight, bias), kernels.conv3x3_plain(x, weight, bias)
        nan_ok = torch.equal(got.isnan(), want.isnan()) and got.isnan().sum().item() == 9 * 16
        emit({"phase": "conv3x3_nan", "route": kernels.conv3x3_route(x.shape, 16),
              "nan_outputs": got.isnan().sum().item(), "ok": nan_ok})
        if not nan_ok:
            failures.append(f"conv3x3: a NaN in x did not reach the outputs of its windows "
                            f"(C_in {c_in})")
    x = torch.zeros(1, 5, 5, 12, device="cuda", dtype=torch.bfloat16)
    try:
        kernels.conv3x3(x, torch.zeros(8, 12, 3, 3, device="cuda", dtype=torch.bfloat16),
                        torch.zeros(8, device="cuda"))
        failures.append("conv3x3 took a bf16 input of 12 channels (C_in % 8 != 0)")
    except ValueError:
        pass
    torch.cuda.empty_cache()
    return records


def probe_path(card: str, failures: list) -> dict:
    """conv3x3's main path: the port's fused-block probe at its defaults,
    in this process, with the launch counts set to 0 just before and read
    just after; its output must agree with the plain version's."""
    kernels.reset_launch_counts()
    start = time.perf_counter()
    result = fused_block_probe.main([])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
    emit({"phase": "probe_path", **result, "gpu": card, "seconds": seconds,
          "launches": launches})
    if launches["conv3x3"] < 1:
        failures.append("kernel conv3x3 was not launched on the probe path")
    rtol = KERNEL_TOL[torch.bfloat16][1]
    if not result["rel_err_vs_plain"] <= rtol:
        failures.append(f"probe path: rel err vs the plain version "
                        f"{result['rel_err_vs_plain']} > {rtol}")
    return launches


def check_kernels(failures: list) -> dict:
    """Each kernel against its plain version at B*N in KERNEL_ROWS, fp32
    (TF32 off) and bf16. Returns the main path's case (bf16, 250 rows) per
    kernel: errors and times."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    main_case = {}
    for rows in KERNEL_ROWS:
        for dtype in (torch.float32, torch.bfloat16):
            x, pe, query, mha = kernel_inputs(rows, dtype, gen)
            atol, rtol = KERNEL_TOL[dtype]
            split = None
            if dtype == torch.bfloat16:  # the wgmma kernel's operands, made once as the model does
                split = kernels.pe_block_split(pe["pe_table"], pe["conv_weight"], pe["conv_bias"])
                gn = (pe["gn_scale"], pe["gn_bias"])
                pe_fn = lambda: (kernels.pe_block_bf16(x, split, *gn),)  # noqa: E731
            else:
                pe_fn = lambda: (kernels.pe_block(x, **pe),)  # noqa: E731
            cases = {
                "pe_block": (pe_fn, lambda: (kernels.pe_block_plain(x, **pe),), None,
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
                    "ms": event_ms(kernel_fn), "plain_ms": event_ms(plain_fn),
                    "library_ms": event_ms(library_fn) if library_fn else None,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                }
                if name == "pe_block" and split is not None:
                    # the kernel's own arithmetic (split PE term, single-pass
                    # statistics): the gap left is summation order
                    twin = kernels.pe_block_split_plain(x, split, pe["gn_scale"], pe["gn_bias"])
                    result["max_abs_err_vs_split_plain"] = (
                        got[0].float() - twin.float()).abs().max().item()
                    result["grid"] = kernels.pe_block_grid(rows, S, E)
                emit(result)
                if not ok:
                    failures.append(f"{name} {rows} {dtype}: {errs}")
                if dtype == torch.bfloat16:
                    # device time of each of the route's launches, one call
                    prof = device_profile(lambda: (kernel_fn(), torch.cuda.synchronize()))
                    emit({"phase": f"{name}_launches", "rows": rows, "dtype": "bfloat16",
                          "device_ms": prof["device_ms"],
                          "by_kernel": prof["top_device_events"]})
                if rows == 250 and dtype == torch.bfloat16:
                    main_case[name] = result
    emit({"phase": "kernels", "kernels": [
        {"name": n, "status": "ported", "route": "cuda", "source": SOURCES[n]} for n in SOURCES
    ]})
    return main_case


def library_mha(query, keyval, mha, dtype):
    """One PyTorch call computing the same function (yardstick only): the
    functional torch MultiheadAttention on the same parameters."""
    q = query[None]
    kv = keyval.transpose(0, 1)
    w = mha

    def call():
        return torch.nn.functional.multi_head_attention_forward(
            q, kv, kv, E, HEADS, w["in_proj_weight"], w["in_proj_bias"], None, None, False,
            0.0, w["out_proj_weight"], w["out_proj_bias"], training=False,
            need_weights=True, average_attn_weights=True,
        )
    return call


def check_wgmma(failures: list) -> None:
    """Hopper's wgmma shared-memory descriptor (ops/csrc/wgmma.cuh) against
    torch.matmul before any kernel uses it: one m64n64k16 product of (64,
    16) bf16 operands in the interleaved layout (no swizzle), then a K = 64
    product in the 128-byte-swizzled layout the bf16 kernels stage, then a
    K = 64 product of the register-A form (A by ldmatrix) that conv3x3's
    resident route issues."""
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(6)
    for swizzle in (False, True):
        k = 64 if swizzle else 16
        a, b = (torch.randn(64, k, generator=gen).to(torch.bfloat16).cuda() for _ in range(2))
        got = kernels.wgmma_probe(a, b, swizzle)
        want = a.float() @ b.float().T
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        tol = WGMMA_RTOL * (1.0 + want.abs().max().item())
        emit({"phase": "wgmma_check", "layout": "swizzle_128B" if swizzle else "interleave",
              "shape": [64, 64, k], "max_abs_err": err, "tolerance": tol, "ok": err <= tol})
        if not err <= tol:
            failures.append(f"wgmma descriptor, {'128B swizzle' if swizzle else 'no swizzle'}: "
                            f"err {err} > {tol}")
    # the register-A form: A by ldmatrix from padded rows, B swizzled
    a, b = (torch.randn(64, 64, generator=gen).to(torch.bfloat16).cuda() for _ in range(2))
    got = kernels.wgmma_rs_probe(a, b)
    want = a.float() @ b.float().T
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = WGMMA_RTOL * (1.0 + want.abs().max().item())
    emit({"phase": "wgmma_check", "layout": "register_a_ldmatrix", "shape": [64, 64, 64],
          "max_abs_err": err, "tolerance": tol, "ok": err <= tol})
    if not err <= tol:
        failures.append(f"wgmma register-A form: err {err} > {tol}")
    # the s8 form (qconv.cu): m64nNk32 at every N tile, 64-byte swizzle, K =
    # 128 as two K tiles, against the exact integer product
    gen8 = torch.Generator(device="cuda").manual_seed(8)
    for n in kernels.QCONV_N_TILES:
        a, b = (torch.randint(-127, 128, (rows, 128), device="cuda", dtype=torch.int8,
                              generator=gen8) for rows in (64, n))
        got = kernels.qconv_wgmma_probe(a, b)
        want = (a.double() @ b.double().T).to(torch.int32)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        emit({"phase": "wgmma_check", "layout": "s8_swizzle_64B", "shape": [64, n, 128],
              "max_abs_err": err, "tolerance": 0, "ok": err == 0})
        if err:
            failures.append(f"wgmma s8 form m64n{n}k32: err {err} against the integer product")


def sass_counts() -> dict:
    """Instructions per built library in its SASS (cuobjdump --dump-sass):
    HGMMA is wgmma on bf16 / fp16, IGMMA wgmma on int8, HMMA mma.sync on
    bf16 / fp16, IMMA mma.sync on int8, FFMA the fp32 FMA units."""
    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    counts = {}
    for name in build.KERNELS:
        sass = subprocess.run([tool, "--dump-sass", build.library_path(name)],
                              capture_output=True, text=True, check=True).stdout.splitlines()
        counts[name] = {op: sum(f" {op}" in line for line in sass)
                        for op in ("HGMMA", "IGMMA", "HMMA", "IMMA", "FFMA")}
    return counts


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
    ("pe_block", ("pe_block_kernel", "pe_block_mma_kernel")),
    ("mha", ("linear_kernel", "attend_kernel", "::gemm_kernel<")),
    ("max_pool_kernel", ("ceil_pool_forward", "ceil_pool_backward")),
    ("fused_stem", ("fused_stem_kernel", "stem_mma_kernel")),
    ("qconv", ("qconv_kernel",)),
    ("quantize", ("quantize_kernel", "quantize_vec_kernel", "quantize_nhwc_kernel")),
    ("consensus_heads", ("consensus_heads_kernel",)),
    # the ResNet / VGG towers' BatchNorm at eval: y * scale + offset after
    # the conv (models/layers.conv_bn)
    ("bn_affine", ("addcmul",)),
    ("conv", ("fprop", "convolve", "conv2d", "convolution", "winograd", "wgrad", "dgrad")),
    ("gemm", ("gemm", "gemv", "nvjet", "matmul")),
    ("pool", ("pool",)),
    ("copy", ("copy", "memcpy", "memset", "cat")),
    ("reduce", ("reduce_kernel",)),
)


def device_profile(run, needles=()) -> dict:
    """Device time of one call of ``run`` by kernel category and the
    longest kernels (torch.profiler's device events: kernels and copies),
    and the device's busy share of the call's host wall time (one stream,
    so device events do not overlap). ``run`` ends in a host sync.
    ``needles``: substrings of kernel names whose launches are counted.
    The device-side copies of the host's ``record_function`` ranges (the
    program's spans, ``utils/spans.py``) span kernels and are not counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        run()
        wall_ms = (time.perf_counter() - start) * 1e3
    by_category: dict = {}
    by_kernel: dict = {}
    ranges = {e.name for e in prof.events() if e.device_type == DeviceType.CPU
              and getattr(e, "is_user_annotation", False)}
    for event in prof.events():
        if (event.device_type != DeviceType.CUDA or event.name in ranges
                or getattr(event, "is_user_annotation", False)):
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
            "top_device_events": [[name, ms, count] for name, (ms, count) in top],
            "device_events_matching": {
                needle: sum(count for name, (_, count) in by_kernel.items() if needle in name)
                for needle in needles}}


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
    backward_launches = kernels.ceil_max_pool2d.backward_launches

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
    expected_backward = 12 * len(TRAIN_BATCHES)  # validate takes no gradient
    result = {
        "phase": "train", "gpu": card, "steps": state.step, "seconds": seconds,
        "losses": losses, "train_loss": train_loss, "val_loss": val_loss, "val_acc": val_acc,
        "launches": launches, "expected_max_pool_launches": expected_pools,
        "max_pool_backward_launches": backward_launches,
        "expected_max_pool_backward_launches": expected_backward,
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
    if backward_launches != expected_backward:
        failures.append(f"train: the pool's backward kernel launched {backward_launches} "
                        f"times, expected {expected_backward}")
    for name in ("pe_block", "mha", "max_pool"):  # pe_block and mha in validate
        if launches[name] < 1:
            failures.append(f"kernel {name} was not launched on the training path")
    return state, cfg, launches


def set_pool_impl(model, impl: str) -> None:
    """Every tower's max-pool lowering (``tpu.pool_impl``), switched in place."""
    for tower in model.modules():
        if isinstance(tower, BNInception):
            tower.pool_impl = impl


def step_times(step, state, batches) -> list:
    """Host ms of each step, each ended by a synchronize, after two warm-ups."""
    times = []
    for batch, targets, meta in batches:
        start = time.perf_counter()
        step(state, batch, targets, 0, meta["batch_size"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
    return sorted(times[2:])


def train_timing(state, cfg, card: str, failures: list) -> dict:
    """Host time of full steps, each ended by a synchronize, after two
    warm-up steps; peak device memory over them; then the same batches with
    torch's pools (``pool_impl=reduce_window``), the plain step of the same
    run. Then one step under the profiler: with the pool kernels it must
    launch torch's max-pool forward only for the towers' stride-1 pools
    (inception 5b's pool branch), never for the stride-2 pools the kernels
    own."""
    step = make_train_step(cfg)
    loader = SmokeLoader(cfg, [12] * 12, int(cfg.train.num_segments),
                         int(cfg.data.train_crop_size), seed=3)
    batches = list(loader)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    steady = step_times(step, state, batches)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    set_pool_impl(state.model, "reduce_window")
    try:
        plain = step_times(step, state, batches)
    finally:
        set_pool_impl(state.model, cfg.tpu.pool_impl)
    p50 = steady[len(steady) // 2]
    result = {"phase": "train_timing", "gpu": card, "batch": 12,
              "segments": int(cfg.train.num_segments), "steps_timed": len(steady),
              "step_ms_p50": p50, "step_ms_min": steady[0], "step_ms_max": steady[-1],
              "clips_per_sec": 12 / (p50 / 1e3), "max_memory_allocated_gib": peak_gib,
              "compute_dtype": cfg.tpu.compute_dtype, "pool_impl": cfg.tpu.pool_impl,
              "plain_pool_step_ms_p50": plain[len(plain) // 2],
              "plain_pool_step_ms_min": plain[0], "plain_pool_step_ms_max": plain[-1]}
    emit(result)

    # one more step under the profiler; the pool kernel's inputs recorded
    batch, targets, meta = batches[-1]
    layouts = []
    launch = kernels.CeilMaxPool2d.forward_impl

    def recording(x, with_taps):
        layouts.append((list(x.shape[1:]), "channels_last" if kernels.pool_layout(x) else "nchw"))
        return launch(x, with_taps)

    def one_step():
        step(state, batch, targets, 0, meta["batch_size"])
        torch.cuda.synchronize()

    kernels.CeilMaxPool2d.forward_impl = staticmethod(recording)
    try:
        prof = device_profile(one_step, needles=("max_pool_forward",))
    finally:
        kernels.CeilMaxPool2d.forward_impl = staticmethod(launch)
    torch_pools = prof["device_events_matching"]["max_pool_forward"]
    stride1 = len(TOWERS) * sum(1 for _, b in BN_INCEPTION_BLOCKS if b.pool == "max" and b.proj)
    emit({"phase": "train_profile", "gpu": card,
          **prof,
          "pool_kernel_calls": layouts,
          "torch_max_pool_forward_launches": torch_pools,
          "expected_torch_max_pool_forward_launches": stride1})
    if torch_pools != stride1:
        failures.append(f"train_profile: {torch_pools} torch max-pool forward kernels in a "
                        f"pool_impl=pallas step, expected {stride1} (the stride-1 pools)")
    if len(layouts) != 12:
        failures.append(f"train_profile: {len(layouts)} pool kernel calls in a step, not 12")
    remat_step(state, step, batches, peak_gib, p50, card, failures)
    return {**result, "pool_calls": [(tuple(shape), layout) for shape, layout in layouts]}


def remat_step(state, step, batches, peak_gib: float, p50: float, card: str,
               failures: list) -> None:
    """``tpu.remat``: from one snapshot of the train state, the same 12 x 3
    step without and with remat (peak memory of each, the states after
    each bit-equal: the bf16 step is bit-reproducible, and remat replays
    the same forward); then remat steps timed as train_timing's (two
    warm-ups), beside its plain p50 and peak. The snapshot is restored
    afterwards."""
    import copy
    import dataclasses

    model = state.model
    spec = model.spec
    snapshot = ({k: v.detach().clone() for k, v in model.state_dict().items()},
                copy.deepcopy(state.optimizer.state_dict()), state.generator.get_state(),
                state.step)

    def restore():
        model.load_state_dict(snapshot[0])
        state.optimizer.load_state_dict(copy.deepcopy(snapshot[1]))
        state.generator.set_state(snapshot[2])
        state.step = snapshot[3]

    batch, targets, meta = batches[0]
    after, peaks, losses = {}, {}, {}
    try:
        for remat in (False, True):
            restore()
            model.spec = dataclasses.replace(spec, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, loss, _ = step(state, batch, targets, 0, meta["batch_size"])
            losses[remat] = float(loss["total"])
            torch.cuda.synchronize()
            peaks[remat] = torch.cuda.max_memory_allocated() / 2**30
            after[remat] = {k: v.detach().clone() for k, v in model.state_dict().items()}
        model.spec = dataclasses.replace(spec, remat=True)
        times = step_times(step, state, batches[:6])
    finally:
        model.spec = spec
        restore()
    differing = [k for k, v in after[False].items() if not torch.equal(after[True][k], v)]
    remat_p50 = times[len(times) // 2]
    emit({"phase": "train_remat", "gpu": card, "batch": 12, "loss_plain": losses[False],
          "loss_remat": losses[True], "tensors_bit_equal": len(after[False]) - len(differing),
          "tensors": len(after[False]), "differing": differing[:10],
          "one_step_peak_gib": {"plain": peaks[False], "remat": peaks[True]},
          "step_ms_p50": remat_p50, "step_ms_min": times[0], "step_ms_max": times[-1],
          "plain_step_ms_p50": p50, "plain_max_memory_allocated_gib": peak_gib,
          "compute_dtype": spec.compute_dtype})
    if differing:
        failures.append(f"train_remat: {len(differing)} of {len(after[False])} tensors of the "
                        f"remat step's state differ from the plain step's: {differing[:5]}")
    if not peaks[True] < peaks[False]:
        failures.append(f"train_remat: peak memory {peaks[True]:.2f} GiB with remat, "
                        f"{peaks[False]:.2f} GiB without")


def int8_cost(xq, wq, outputs) -> tuple:
    """qconv: its int8 input and weight, the fp32 scale and bias once, and
    each output (a float segment in its type, an int8 one in bytes) once;
    2 M N K int8 operations at the int8 peak."""
    positions = xq.shape[0] * outputs[0].shape[1] * outputs[0].shape[2]
    moved = (xq.numel() + wq.numel() + 8 * wq.shape[0]
             + sum(out.numel() * out.element_size() for out in outputs))
    return bound(moved, 2 * positions * wq.numel(), torch.int8)


def quantize_cost(x) -> tuple:
    """quantize: x once, the int8 output once; four fp32 operations an
    element (divide, round, two clamps)."""
    return bound(x.numel() * (x.element_size() + 1), 4 * x.numel(), torch.float32)


def segment_outputs(segments, dtype) -> list:
    """Fresh destinations of a recorded site's segments: each float one in
    ``dtype`` with its view's sizes and strides (a channel slice of a block
    buffer keeps its pixel stride), each int8 one as it was, with its
    scale."""
    outs = []
    for out, x_scale in segments:
        if x_scale is None:
            outs.append((torch.empty_strided(out.size(), out.stride(), dtype=dtype,
                                             device=out.device), None))
        else:
            outs.append((torch.empty_like(out), x_scale))
    return outs


def segment_layout(segments) -> tuple:
    return tuple((out.shape[-1], "float" if x_scale is None else "int8", out.stride(2))
                 for out, x_scale in segments)


def int8_site_checks(sites, batch: int) -> list:
    """Each distinct site shape of a forward's recorded ``sites``
    (``layers.recording_sites``) against the plain versions on the recorded
    inputs: quantize (its route), and qconv at fp32 and bf16 with the site's
    segments (each float segment in that type, each int8 one as integers):
    a record each."""
    records, seen = [], set()
    for kind, *site in sites:
        if kind == "quantize":
            x, x_scale = site
            key = ("quantize", tuple(x.shape), kernels.quantize_route(x), str(x.dtype))
            if key in seen:
                continue
            seen.add(key)
            got, want = kernels.quantize(x, x_scale), kernels.quantize_plain(x, x_scale)
            records.append({"kernel": "quantize", "batch": batch, "shape": list(x.shape),
                            "route": key[2], "dtype": key[3].replace("torch.", ""),
                            "max_abs_err": (got.int() - want.int()).abs().max().item()})
            continue
        args, segments = site
        xq, wq, scale, bias, stride, padding, relu_from, _ = args
        key = ("qconv", tuple(xq.shape), tuple(wq.shape), stride, padding, relu_from,
               segment_layout(segments))
        if key in seen:
            continue
        seen.add(key)
        plan = kernels.qconv_plan(tuple(xq.shape), wq.shape[0], wq.shape[1], stride, padding)
        for dtype in (torch.float32, torch.bfloat16):
            call = (xq, wq, scale, bias, stride, padding, relu_from, dtype)
            got = segment_outputs(segments, dtype)
            want = segment_outputs(segments, dtype)
            kernels.qconv(*call, segments=got)
            kernels.qconv_plain(*call, segments=want)
            errs = [(g.float() - w.float()).abs().max().item()
                    for (g, _), (w, _) in zip(got, want)]
            records.append({"kernel": "qconv", "batch": batch, "x": list(xq.shape),
                            "w": list(wq.shape), "stride": stride, "padding": padding,
                            "relu_from": relu_from, "dtype": str(dtype).replace("torch.", ""),
                            "route": plan.name, "n_tile": plan.n_tile,
                            "box": [plan.box_w, plan.box_h, plan.box_i],
                            "segments": [[w, k] for w, k, _ in key[-1]],
                            "segment_errs": errs, "max_abs_err": max(errs)})
            del got, want
    torch.cuda.synchronize()
    return records


def int8_route_counts(sites) -> dict:
    """Launches of a forward's recorded ``sites`` by kernel route."""
    counts: dict = {"quantize": {}, "qconv": {}}
    for kind, *site in sites:
        if kind == "quantize":
            route = kernels.quantize_route(site[0])
        else:
            xq, wq, _, _, stride, padding = site[0][:6]
            route = kernels.qconv_plan(tuple(xq.shape), wq.shape[0], wq.shape[1], stride,
                                       padding).name
        counts[kind][route] = counts[kind].get(route, 0) + 1
    return counts


def int8_site_times(sites) -> dict:
    """Times at the largest quantize site (bytes) and the largest 1x1 and
    3x3 qconv sites (operations) of a forward's recorded ``sites``:
    event-timed and by CUDA graph, the plain versions, the bound. quantize
    as the tower hands it its input (its route) and on an NCHW copy (the
    planes route). qconv with an all-float output (one float segment) and
    as the tower runs it (its segments), each with its own bound; beside it cuDNN's bf16 conv of the
    site on NCHW and on channels-last input (the int8 input widened, a
    seeded bf16 weight), and at the 1x1 site torch._int_mm on its int8 GEMM
    (the int32 products alone, no dequantize)."""
    x, x_scale = max((site[1:] for site in sites if site[0] == "quantize"),
                     key=lambda site: site[0].numel())
    planes = x.contiguous()
    bound_ms, bound_by = quantize_cost(x)
    out = {"quantize": {
        "shape": list(x.shape), "route": kernels.quantize_route(x),
        "ms": event_ms(lambda: kernels.quantize(x, x_scale), 20),
        "graph_ms": graph_ms(lambda: kernels.quantize(x, x_scale)),
        "planes_ms": event_ms(lambda: kernels.quantize(planes, x_scale), 20),
        "planes_graph_ms": graph_ms(lambda: kernels.quantize(planes, x_scale)),
        "plain_ms": event_ms(lambda: kernels.quantize_plain(x, x_scale), 3),
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}}
    del planes

    def operations(site):
        xq, wq, _, _, stride, padding = site[1][:6]
        ho, wo = (kernels.qconv_out_size(s, wq.shape[1], stride, padding) for s in xq.shape[1:3])
        return xq.shape[0] * ho * wo * wq.numel()

    for k in (1, 3):
        _, args, segments = max((site for site in sites
                                 if site[0] == "qconv" and site[1][1].shape[1] == k),
                                key=operations)
        xq, wq, scale, bias, stride, padding, relu_from, dtype = args
        plan = kernels.qconv_plan(tuple(xq.shape), wq.shape[0], k, stride, padding)
        whole = kernels.qconv(*args)
        bound_ms, bound_by = int8_cost(xq, wq, [layers.nhwc(whole)])
        tower = segment_outputs(segments, dtype)
        tower_bound_ms, _ = int8_cost(xq, wq, [o for o, _ in tower])
        gen = torch.Generator(device=xq.device).manual_seed(13)
        weight = (torch.randn(wq.permute(0, 3, 1, 2).shape, device=xq.device, generator=gen)
                  * 0.05).to(dtype)
        conv_bias = torch.zeros(wq.shape[0], device=xq.device, dtype=dtype)
        x_nchw = xq.permute(0, 3, 1, 2).to(dtype).contiguous()
        x_cl = x_nchw.contiguous(memory_format=torch.channels_last)
        weight_cl = weight.contiguous(memory_format=torch.channels_last)

        def cudnn():
            return torch.nn.functional.conv2d(x_nchw, weight, conv_bias, stride, padding)

        def cudnn_cl():
            return torch.nn.functional.conv2d(x_cl, weight_cl, conv_bias, stride, padding)

        record = {
            "x": list(xq.shape), "w": list(wq.shape), "stride": stride, "padding": padding,
            "route": plan.name, "n_tile": plan.n_tile,
            "box": [plan.box_w, plan.box_h, plan.box_i],
            "ms": event_ms(lambda: kernels.qconv(*args), 20),
            "graph_ms": graph_ms(lambda: kernels.qconv(*args)),
            "plain_ms": event_ms(lambda: kernels.qconv_plain(*args), 3),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tower_segments": [[o.shape[-1], "float" if s is None else "int8"]
                               for o, s in segments],
            "tower_ms": event_ms(lambda: kernels.qconv(*args, segments=tower), 20),
            "tower_graph_ms": graph_ms(lambda: kernels.qconv(*args, segments=tower)),
            "tower_bound_ms": tower_bound_ms,
            "cudnn_bf16_conv_ms": event_ms(cudnn, 20), "cudnn_bf16_conv_graph_ms": graph_ms(cudnn),
            "cudnn_bf16_conv_channels_last_ms": event_ms(cudnn_cl, 20),
            "cudnn_bf16_conv_channels_last_graph_ms": graph_ms(cudnn_cl),
            "library_ms": None}
        if k == 1:
            a = xq.reshape(-1, xq.shape[-1])
            b = wq.reshape(wq.shape[0], -1).t()  # (K, N), column-major
            record["int_mm_ms"] = record["library_ms"] = event_ms(
                lambda: torch._int_mm(a, b), 20)
            record["int_mm_graph_ms"] = graph_ms(lambda: torch._int_mm(a, b))
        out[f"qconv_{k}x{k}"] = record
        del whole, tower, x_nchw, x_cl
    return out


def int8_path(card: str, failures: list) -> dict:
    """The int8 towers (``tpu.quantize=int8``) at full width: the serving
    flagship (tri-modal BN-Inception, 224^2, 25 segments, 2.1 s audio, PE +
    4-head MHA, bf16, kernels on, seeded weights) built with quantize
    "int8" (the drivers refuse the key, so as the JAX package's API:
    ``models.tbn.calibrate_quantization``); (a) calibrated on
    INT8_CALIBRATION seeded b=10 batches; (b) 126 amaxes, all > 0; (c) one
    b=10 int8 forward with the launch counts set to 0 just before and read
    just after: quantize INT8_QUANTIZE_PER_TOWER and qconv
    INT8_QCONV_PER_TOWER a tower, pe_block and mha launched; (d) its logits
    against the same weights' bf16 forward, rel-RMSE < INT8_REL_RMSE, top-1
    agreement beside it; (e) every distinct site shape of a b=1 and of the
    b=10 forward (RGB, Flow and Audio towers), quantize and qconv (fp32 and
    bf16 outputs, every segment) against the plain versions on the
    recorded inputs: bit-equal; the recorded b=10 forward's routes and its
    INT8_FOLDED_PER_TOWER int8 segments a tower; (f) times at the largest
    sites of the b=10 forward (int8_site_times); (g) device time of the
    b=10 int8 forward and of the bf16 one, by profiler. Returns (the
    launches of (c), the kernels line's records)."""
    import dataclasses

    from attention_based_tbn_tpu_torch.models.tbn import (TBNModel, TBNSpec,
                                                          calibrate_quantization)
    start = time.perf_counter()
    cfg = load_config(overrides=["tpu.quantize=int8"])
    spec = TBNSpec.from_config(cfg, get_modality(cfg))
    model = TBNModel(spec)
    model.reset_parameters(torch.Generator().manual_seed(int(cfg.data.manual_seed)))
    model = model.cuda().eval()
    plain = TBNModel(dataclasses.replace(spec, quantize=""))
    plain.load_state_dict(model.state_dict())
    plain = plain.cuda().eval()
    n, crop = int(cfg.test.num_segments), int(cfg.data.test_crop_size)
    batches = [b for b, _, _ in SmokeLoader(cfg, [10] * (INT8_CALIBRATION + 1), n, crop, seed=11)]
    calibration, request = batches[:INT8_CALIBRATION], batches[-1]
    began = time.perf_counter()
    calibrate_quantization(model, calibration)
    torch.cuda.synchronize()
    calibrate_s = time.perf_counter() - began
    stats = {m: getattr(model, f"Base_{m}").quant_stats() for m in spec.modality}
    amaxes = [v.item() for tower in stats.values() for v in tower.values()]
    if len(amaxes) != 42 * len(spec.modality) or not all(a > 0 for a in amaxes):
        failures.append(f"int8: {len(amaxes)} amaxes after calibration (expected "
                        f"{42 * len(spec.modality)}, all > 0), min {min(amaxes, default=0)}")

    with torch.no_grad():
        model(request)  # the operand caches: made once per weight version
        kernels.reset_launch_counts()
        out = model(request)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
        want = plain(request)
    towers = len(spec.modality)
    expected = {"quantize": INT8_QUANTIZE_PER_TOWER * towers,
                "qconv": INT8_QCONV_PER_TOWER * towers}
    for name, count in expected.items():
        if launches[name] != count:
            failures.append(f"int8: {name} launched {launches[name]} times in a b=10 forward, "
                            f"expected {count} ({count // towers} a tower)")
    for name in ("pe_block", "mha"):
        if launches[name] < 1:
            failures.append(f"int8: kernel {name} was not launched")
    agreement = {}
    for key in ("verb", "noun"):
        a, b = want[key].float().cpu().numpy(), out[key].float().cpu().numpy()
        agreement[key] = {"rel_rmse_vs_bf16": rel_rmse(b, a),
                          "top1_agreement": float((a.argmax(-1) == b.argmax(-1)).mean()),
                          "finite": bool(np.isfinite(b).all())}
        if not (agreement[key]["finite"] and agreement[key]["rel_rmse_vs_bf16"] < INT8_REL_RMSE):
            failures.append(f"int8: {key} logits {agreement[key]} (bound {INT8_REL_RMSE})")

    # (e) every distinct site shape at b=1 (25 images a tower) and at b=10;
    # (f) the largest sites of the b=10 forward
    checks = []
    with torch.no_grad():
        for b in (1, 10):
            with layers.recording_sites() as sites:
                model({k: v[:b] for k, v in request.items()})
            checks += int8_site_checks(sites, b)
        times = int8_site_times(sites)
    routes = int8_route_counts(sites)
    folded = sum(x_scale is not None for kind, *site in sites if kind == "qconv"
                 for _, x_scale in site[1])
    if folded != INT8_FOLDED_PER_TOWER * towers:
        failures.append(f"int8: {folded} int8 segments in a b=10 forward, expected "
                        f"{INT8_FOLDED_PER_TOWER * towers}")
    del sites
    torch.cuda.empty_cache()
    for record in checks:
        emit({"phase": "int8_site_check", **record})
    quantize_err, qconv_err = (max(r["max_abs_err"] for r in checks if r["kernel"] == name)
                               for name in ("quantize", "qconv"))
    if quantize_err or qconv_err:
        failures.append(f"int8: kernels differ from their plain versions: quantize "
                        f"{quantize_err}, qconv {qconv_err}")

    # (g) device time of the b=10 forward, int8 and bf16
    def forward(m):
        def run():
            with torch.no_grad():
                m(request)
            torch.cuda.synchronize()
        return run

    profiles = {"int8": device_profile(forward(model)), "bf16": device_profile(forward(plain))}
    result = {"phase": "int8_path", "gpu": card, "batch": 10, "segments": n,
              "calibrate_s": calibrate_s, "amaxes": len(amaxes), "amax_min": min(amaxes),
              "launches": launches, "expected_launches": expected, "routes": routes,
              "folded_quantizes": folded,
              "logits": agreement, "site_shapes_checked": len(checks),
              "quantize_max_abs_err": quantize_err, "qconv_max_abs_err": qconv_err,
              "times": times,
              "device_ms": {k: p["device_ms"] for k, p in profiles.items()},
              "device_busy_share": {k: p["device_busy_share"] for k, p in profiles.items()},
              "device_ms_by_category": {k: p["device_ms_by_category"]
                                        for k, p in profiles.items()},
              "seconds": time.perf_counter() - start}
    emit(result)
    qconv_1x1 = times["qconv_1x1"]
    line = {"quantize": {**times["quantize"], "max_abs_err": quantize_err,
                         "routes": routes["quantize"]},
            "qconv": {**qconv_1x1, "max_abs_err": qconv_err, "routes": routes["qconv"]}}
    del model, plain, batches, calibration, request
    torch.cuda.empty_cache()
    return launches, line


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


def write_trimodal_fixture(root: str, videos: int, actions: int, frames: int, seed: int,
                           flow_pickle: bool) -> dict:
    """A tri-modal Epic-Kitchens tree from the port's own writers: RGB JPEG
    frames and Flow JPEG pairs at EK55_FRAME and a 24 kHz WAV per video, by
    ``data/synthetic.generate`` (seeded content; labels drawn over the
    flagship's 125 verbs and 352 nouns; JPEGs by cv2.imwrite); with
    ``flow_pickle``, the Flow pairs also as ``.npz`` stacks under
    ``flow_pickle/`` by ``preprocessing/create_flow_pickle`` (win 5, as the
    JAX package's preprocessing writes them). The labelled CSV is
    ``annotations/labelled.csv``, an unlabelled copy ``unlabelled.csv``,
    the split list ``split.txt``. Returns the seconds each writer took."""
    names = [f"P{v + 1:02d}_01" for v in range(videos)]
    start = time.perf_counter()
    synthetic.generate(root, videos=names, frames_per_video=frames, actions_per_video=actions,
                       image_hw=EK55_FRAME, seed=seed)
    timing = {"generate_s": time.perf_counter() - start}
    if flow_pickle:
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as log:
            create_flow_pickle.main(["--in_dir", os.path.join(root, "links"), "--out_dir",
                                     os.path.join(root, "flow_pickle"), "--win_length", "5",
                                     "--workers", "8"])
        timing["flow_pickle_s"] = time.perf_counter() - start
        timing["flow_pickle_log"] = log.getvalue().strip()
    ann = os.path.join(root, "annotations")
    os.replace(os.path.join(ann, "epic_train_val.csv"), os.path.join(ann, "labelled.csv"))
    with open(os.path.join(ann, "labelled.csv"), newline="") as fh:
        rows = list(csv.DictReader(fh))
    with open(os.path.join(ann, "unlabelled.csv"), "w", newline="") as fh:
        writer = csv.DictWriter(fh, UNLABELLED_KEYS, extrasaction="ignore")
        writer.writeheader()
        writer.writerows(rows)
    os.replace(os.path.join(root, "train_split.txt"), os.path.join(root, "split.txt"))
    return timing


def sha256(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def native_io_check(card: str, failures: list) -> dict:
    """The port's native IO library on this host: each committed JPEG
    (``native/testdata``: 256 x 456 RGB at 4:2:0, 4:4:4 and with restart
    markers, two gray Flow maps, an odd-sized 4:2:2 frame) decoded to BGR
    and gray, held to the SHA-256 of cv2's decodes recorded with the files
    (and this host's cv2 beside it, reported); the 48 kHz WAV read at 24 kHz,
    held to the checksum of the JAX package's reader. Then decode rates on
    the 4:2:0 frame: one thread, ``decode_batch`` (decode + centre crop
    224) on 1 and 8 threads, cv2.imread; and the WAV's read time."""
    lib = native.ensure_built()
    record = read_json(os.path.join(NATIVE_TESTDATA, "checksums.json"))
    try:
        import cv2
    except ImportError:
        cv2 = None
    files = {}
    for name, want in sorted(record["jpeg"].items()):
        path = os.path.join(NATIVE_TESTDATA, name)
        bgr, gray = lib.decode_jpeg_file(path), lib.decode_jpeg_file(path, grayscale=True)
        ok = (list(bgr.shape) == want["shape"] and sha256(bgr) == want["bgr_sha256"]
              and sha256(gray) == want["gray_sha256"])
        files[name] = {"ok": ok, "shape": list(bgr.shape)}
        if cv2 is not None:
            files[name]["host_cv2_equal"] = (sha256(cv2.imread(path)) == want["bgr_sha256"]
                                             and sha256(cv2.imread(path, 0)) == want["gray_sha256"])
        if not ok:
            failures.append(f"native_io: {name} decodes off its recorded cv2 checksum")
    wavs = {}
    for name, want in sorted(record["wav"].items()):
        path = os.path.join(NATIVE_TESTDATA, name)
        samples = lib.read_wav(path, want["target_sr"])
        ok = samples.shape == (want["samples"],) and sha256(samples) == want["float32_sha256"]
        times = []
        for _ in range(20):
            start = time.perf_counter()
            lib.read_wav(path, want["target_sr"])
            times.append((time.perf_counter() - start) * 1e3)
        wavs[name] = {"ok": ok, "samples": int(samples.shape[0]), "ms_p50": float(np.median(times))}
        if not ok:
            failures.append(f"native_io: {name} reads off the JAX reader's checksum")

    frame = os.path.join(NATIVE_TESTDATA, "rgb_420_q95.jpg")

    def rate(fn, frames):
        fn()  # warm-up
        start = time.perf_counter()
        fn()
        return frames / (time.perf_counter() - start)

    n = 256
    rates = {
        "decode_1_thread": rate(lambda: [lib.decode_jpeg_file(frame) for _ in range(n)], n),
        "decode_batch_1_thread": rate(
            lambda: lib.decode_batch([frame] * n, 256, 224, num_threads=1), n),
        "decode_batch_8_threads": rate(
            lambda: lib.decode_batch([frame] * 4 * n, 256, 224, num_threads=8), 4 * n),
    }
    if cv2 is not None:
        rates["cv2_imread_1_thread"] = rate(lambda: [cv2.imread(frame) for _ in range(n)], n)
    result = {"phase": "native_io", "gpu": card, "library": lib.path,
              "files": files, "wav": wavs, "frames_per_s": rates, "frame": "rgb_420_q95.jpg",
              "host_cpus": os.cpu_count()}
    emit(result)
    return result


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
    """The evaluation entry point at full width, tri-modal (the flagship
    recipe: the RGB feature queries the audio sequence): the port's main in
    test mode on RGB JPEG frames, Flow ``.npz`` stacks and WAV audio written
    by the port's own writers (write_trimodal_fixture), with 10-crop, the
    fused stem on all three towers, fast consensus and the challenge JSON,
    from a seeded {"model": state_dict} .pth; launch counts set to 0 just
    before main and read just after. Then main again on the same fixture and
    .pth with the kernels off (tpu.fused_stem=false, tpu.use_pallas=false)
    over the labelled file: both challenge JSONs hold the same uids and
    their scores stay within the bf16 drift bound. Then main with the
    kernels on and tpu.native_io=false (cv2 and the Python WAV reader) over
    the labelled file, whose scores must agree too and whose clips/s stands
    beside the native decoder's. Returns the launches."""
    root = tempfile.mkdtemp(prefix=".smoke_fixture_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        start = time.perf_counter()
        fixture_s = write_trimodal_fixture(root, videos=TEST_VIDEOS, actions=TEST_ACTIONS,
                                           frames=TEST_SPAN * TEST_ACTIONS, seed=5,
                                           flow_pickle=True)
        model_over = ["model.pretrained=false"]
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
            "data.flow.dir_prefix=flow_pickle", "test.ten_crop=true", "test.save_results=true",
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
        batches = 2 * -(-len(uids) // TEST_BATCH)  # both files
        if launches["fused_stem"] != len(TEST_STEMS) * batches:
            failures.append(f"test path: fused_stem launched {launches['fused_stem']} times, "
                            f"not once per stem and batch ({len(TEST_STEMS)} x {batches})")

        # the same fixture and .pth with every kernel off (the labelled file)
        labelled_only = ["test.annotation_file=[annotations/labelled.csv]"]
        plain_over = overrides + labelled_only + [
            "tpu.fused_stem=false", "tpu.use_pallas=false",
            "test.results_file=[plain_labelled.json]", "exp_name=plain"]
        kernels.reset_launch_counts()
        plain_results = port_main.main(plain_over)
        plain_launches = sum(fn.launches for fn in kernels.WRAPPERS.values())
        if plain_launches:
            failures.append(f"test path with the kernels off launched {plain_launches} kernels")
        plain_throughput = run_log_lines(os.path.join(root, "out", "log", "plain"),
                                         "Inference throughput")

        # the same run, kernels on, with tpu.native_io=false: RGB frames by
        # cv2.imread and WAV by the Python reader, the JAX package's A/B
        # switch; the loader's rate beside the native decoder's
        cv2_over = overrides + labelled_only + ["tpu.native_io=false", "exp_name=cv2",
                                                "test.results_file=[cv2_labelled.json]"]
        cv2_results = port_main.main(cv2_over)
        torch.cuda.synchronize()
        cv2_throughput = run_log_lines(os.path.join(root, "out", "log", "cv2"),
                                       "Inference throughput")
        if not cv2_results or not np.isfinite(cv2_results[0][0]["total"]):
            failures.append(f"test path under tpu.native_io=false: results {cv2_results}")

        files = {}
        for name in ("labelled.json", "unlabelled.json"):
            got = read_scores(os.path.join(root, "out", "inferences", name))
            complete = sorted(got) == sorted(uids) and all(
                len(v) == 125 and len(n) == 352 and np.isfinite(v).all() and np.isfinite(n).all()
                for v, n in got.values())
            files[name] = {"uids": len(got), "complete": complete}
            if not complete:
                failures.append(f"test path: {name} lacks uids or 125 / 352 finite scores")
                continue
            if name != "labelled.json":
                continue  # the kernels-off and native_io=false runs read the labelled file
            decoded_by_cv2 = read_scores(os.path.join(root, "out", "inferences", "cv2_" + name))
            want = read_scores(os.path.join(root, "out", "inferences", "plain_" + name))
            if not sorted(decoded_by_cv2) == sorted(want) == sorted(uids):
                failures.append(f"test path: the kernels-off or tpu.native_io=false run's {name} "
                                "lacks uids")
                continue
            for h, head in enumerate(("verb", "noun")):
                drift = rel_rmse(np.stack([got[u][h] for u in uids]),
                                 np.stack([want[u][h] for u in uids]))
                files[name][f"{head}_rel_rmse_vs_kernels_off"] = drift
                if not drift < DRIFT_REL_RMSE:
                    failures.append(f"test path {name} {head}: rel-RMSE {drift} vs the "
                                    f"kernels-off run >= {DRIFT_REL_RMSE}")
                # the native decoder and reader are bit-equal to cv2 and the
                # Python reader at the fixture's 24 kHz
                gap = rel_rmse(np.stack([got[u][h] for u in uids]),
                               np.stack([decoded_by_cv2[u][h] for u in uids]))
                files[name][f"{head}_rel_rmse_vs_native_io_off"] = gap
                if not gap < DRIFT_REL_RMSE:
                    failures.append(f"test path {name} {head}: rel-RMSE {gap} vs the "
                                    f"tpu.native_io=false run >= {DRIFT_REL_RMSE}")
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
              "modalities": get_modality(cfg), "fixture_s": fixture_s,
              "setup_s": setup_s, "wall_s": wall, "launches": launches,
              "test_loss": labelled[0] if labelled else None,
              "test_acc": labelled[1] if labelled else None,
              "kernels_off_test_loss": (plain_results[0][0]
                                        if plain_results and plain_results[0] else None),
              "throughput_log": throughput, "kernels_off_throughput_log": plain_throughput,
              "native_io_off_throughput_log": cv2_throughput})
        emit({"phase": "test_path_profile", "gpu": card, "clips": len(uids), **profile})
        for line in throughput:
            print(f"test path: {len(uids)} clips per file; {line.split(' : ')[-1]}", flush=True)
        for line in plain_throughput:
            print(f"test path, kernels off: {line.split(' : ')[-1]}", flush=True)
        for line in cv2_throughput:
            print(f"test path, tpu.native_io=false: {line.split(' : ')[-1]}", flush=True)
        print(f"test path: wall {wall:.1f} s for both files", flush=True)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_pretrained(directory: str, seed: int) -> dict:
    """Seeded pretrainedmodels-layout BN-Inception towers, written with
    numpy values: ``imagenet_bninception_rgb.pth`` (3-channel conv1, a
    1000-class head) and ``kinetics_bninception_flow.pth`` (10 channels, a
    400-class head). He-scaled weights and BatchNorm statistics near (0, 1),
    so an evaluation forward on them stays finite. Returns {file: bytes}."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)

    def tower(in_channels, classes):
        sd = {}

        def conv(name, cin, cout, k):
            fan_in = cin * k * k
            sd[f"{name}.weight"] = rng.standard_normal((cout, cin, k, k)) * np.sqrt(2 / fan_in)
            sd[f"{name}.bias"] = rng.standard_normal(cout) * 0.01
            sd[f"{name}_bn.weight"] = rng.uniform(0.8, 1.2, cout)
            sd[f"{name}_bn.bias"] = rng.standard_normal(cout) * 0.05
            sd[f"{name}_bn.running_mean"] = rng.standard_normal(cout) * 0.05
            sd[f"{name}_bn.running_var"] = rng.uniform(0.8, 1.2, cout)

        conv("conv1_7x7_s2", in_channels, 64, 7)
        conv("conv2_3x3_reduce", 64, 64, 1)
        conv("conv2_3x3", 64, 192, 3)
        width = 192
        for name, b in BN_INCEPTION_BLOCKS:
            if b.b1x1:
                conv(f"{name}_1x1", width, b.b1x1, 1)
            conv(f"{name}_3x3_reduce", width, b.r3x3, 1)
            conv(f"{name}_3x3", b.r3x3, b.b3x3, 3)
            conv(f"{name}_double_3x3_reduce", width, b.rd3x3, 1)
            conv(f"{name}_double_3x3_1", b.rd3x3, b.d3x3, 3)
            conv(f"{name}_double_3x3_2", b.d3x3, b.d3x3, 3)
            if b.proj:
                conv(f"{name}_pool_proj", width, b.proj, 1)
            width = b.b1x1 + b.b3x3 + b.d3x3 + (b.proj or width)
        sd["last_linear.weight"] = rng.standard_normal((classes, width)) * 0.01
        sd["last_linear.bias"] = np.zeros(classes)
        return {k: torch.from_numpy(v.astype(np.float32)) for k, v in sd.items()}

    sizes = {}
    for name, in_channels, classes in (("imagenet_bninception_rgb", 3, 1000),
                                       ("kinetics_bninception_flow", 10, 400)):
        path = os.path.join(directory, name + ".pth")
        torch.save(tower(in_channels, classes), path)
        sizes[name + ".pth"] = os.path.getsize(path)
    return sizes


def read_json(path: str):
    with open(path) as fh:
        return json.load(fh)


def launch_counts() -> dict:
    counts = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
    counts["max_pool_backward"] = kernels.ceil_max_pool2d.backward_launches
    return counts


def state_equal(state, other) -> dict:
    """Which parts of two train states are bit-equal: the model's state
    dict, the optimizer's momentum, the generator, the step."""
    own, theirs = state.model.state_dict(), other.model.state_dict()
    model = set(own) == set(theirs) and all(torch.equal(own[k], theirs[k]) for k in own)
    opt, opt2 = state.optimizer.inner, other.optimizer.inner
    momentum = all(
        torch.equal(opt.state[p]["momentum_buffer"], opt2.state[q]["momentum_buffer"])
        for p, q in zip(state.optimizer.trainable, other.optimizer.trainable) if p in opt.state)
    return {"model": model, "momentum": momentum,
            "generator": torch.equal(state.generator.get_state(), other.generator.get_state()),
            "step": state.step == other.step}


def trainer_path(card: str, failures: list, then=None) -> dict:
    """The training entry point at full width: the port's main in train
    mode on a tri-modal fixture (RGB JPEG frames, Flow JPEG pairs in
    Epic-Kitchens' own layout, WAV audio; write_trimodal_fixture) with
    pretrained towers from seeded files, 2 epochs with validation and the best checkpoint; main
    again to resume 1 epoch from the written .pth; the .pth reloaded into a
    fresh train state (bit-equal to the trained one); main in test mode
    from it with the fused stem and fast consensus. Launch counts set to 0
    just before the first main and read after each step. ``then(card,
    failures, root, pth, overrides)``, when given, runs on the fixture and
    the checkpoint before they are removed (vis_path). Returns the launches
    of the whole phase."""
    root = tempfile.mkdtemp(prefix=".smoke_fixture_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        start = time.perf_counter()
        fixture_s = write_trimodal_fixture(root, videos=TRAINER_VIDEOS, actions=TRAINER_ACTIONS,
                                           frames=TEST_SPAN * TRAINER_ACTIONS, seed=9,
                                           flow_pickle=False)
        names = [f"P{v + 1:02d}_01" for v in range(TRAINER_VIDEOS)]
        for split, vids in (("train", names[:TRAINER_TRAIN_VIDEOS]),
                            ("val", names[TRAINER_TRAIN_VIDEOS:])):
            with open(os.path.join(root, f"{split}_split.txt"), "w") as fh:
                fh.write("\n".join(vids) + "\n")
        weight_files = write_pretrained(os.path.join(root, "weights"), seed=4)
        setup_s = time.perf_counter() - start
        overrides = [
            "model.pretrained=true", f"model.weights_dir={root}/weights",
            "tpu.pool_impl=pallas", "train.enable=true", "test.enable=false", "val.enable=true",
            "train.save_best=true", "train.epochs=2", f"data_dir={root}", f"out_dir={root}/out",
            "exp_name=trainer", "data.flow.read_flow_pickle=false",
            "train.annotation_file=annotations/labelled.csv",
            f"train.vid_list={root}/train_split.txt", f"val.vid_list={root}/val_split.txt",
        ]
        cfg = load_config(overrides=overrides)
        modality = get_modality(cfg)
        stem = checkpoint_stem(cfg, modality)
        states = []
        run_trainer = port_train.run_trainer

        def keep_state(*args, **kwargs):  # main's trainer, its final state kept
            states.append(run_trainer(*args, **kwargs))
            return states[-1]

        port_train.run_trainer = keep_state
        steps = {}
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            start = time.perf_counter()
            port_main.main(overrides)
            torch.cuda.synchronize()
            steps["train"] = {"wall_s": time.perf_counter() - start, "launches": launch_counts()}
            history = read_json(checkpoint.history_path(stem))
            trained = {"epochs": len(history["train_loss"]), "train_loss": history["train_loss"],
                       "validation_loss": history["validation_loss"],
                       "validation_accuracy": history["validation_accuracy"],
                       "best": os.path.isfile(stem + "_best.pth")}
            start = time.perf_counter()
            port_main.main(overrides + [f"train.pre_trained={stem}.pth", "train.epochs=1"])
            torch.cuda.synchronize()
            steps["resume"] = {"wall_s": time.perf_counter() - start, "launches": launch_counts()}
        finally:
            port_train.run_trainer = run_trainer
        history = read_json(checkpoint.history_path(stem))
        continued = run_log_lines(os.path.join(root, "out"), "Model will continue training")
        resumed = {"epochs": len(history["train_loss"]), "epoch": history["epoch"],
                   "continue_log": [line.split(" : ")[-1] for line in continued]}

        # the checkpoint reloaded into a fresh train state
        trained_state = states[-1]
        fresh = create_train_state(cfg, build_model(cfg, modality, device="cuda", seed=123))
        torch.cuda.synchronize()
        start = time.perf_counter()
        checkpoint.restore_checkpoint(stem + ".pth", fresh)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - start) * 1e3
        reload_equal = state_equal(trained_state, fresh)
        start = time.perf_counter()
        checkpoint.save_checkpoint(os.path.join(root, "resave", "tbn"), fresh, history["epoch"])
        save_ms = (time.perf_counter() - start) * 1e3
        del fresh, trained_state, states[:]
        torch.cuda.empty_cache()

        # test mode from the same .pth, the fused stem and fast consensus
        test_over = overrides + [
            "train.enable=false", "test.enable=true", f"test.pre_trained={stem}.pth",
            "tpu.fused_stem=true", "tpu.fast_consensus=true", "test.ten_crop=true",
            "test.save_results=true", "test.annotation_file=[annotations/labelled.csv]",
            "test.results_file=[trainer.json]", f"test.vid_list={root}/val_split.txt",
            "exp_name=trainer_test"]
        start = time.perf_counter()
        results = port_main.main(test_over)
        torch.cuda.synchronize()
        steps["test"] = {"wall_s": time.perf_counter() - start, "launches": launch_counts()}
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        launches = steps["test"]["launches"]
        scores = read_scores(os.path.join(root, "out", "inferences", "trainer.json"))
        complete = (len(scores) == TRAINER_VAL_CLIPS and all(
            len(v) == CLASS_HEADS[0] and len(n) == CLASS_HEADS[1]
            and np.isfinite(v).all() and np.isfinite(n).all() for v, n in scores.values()))

        throughput = [line.split(" : ")[-1] for line in
                      run_log_lines(os.path.join(root, "out", "log", "trainer"),
                                    "Train epoch throughput")]
        step_lines = [line.split(" : ")[-1] for line in
                      run_log_lines(os.path.join(root, "out", "log", "trainer"), "s/step")]
        result = {
            "phase": "trainer_path", "gpu": card, "setup_s": setup_s, "fixture_s": fixture_s,
            "modalities": modality,
            "pretrained_files": weight_files, "train_clips": TRAINER_TRAIN_CLIPS,
            "val_clips": TRAINER_VAL_CLIPS, "trained": trained, "resumed": resumed,
            "reload_bit_equal": reload_equal, "checkpoint_bytes": os.path.getsize(stem + ".pth"),
            "save_ms": save_ms, "restore_ms": restore_ms, "steps": steps,
            "test_loss": results[0][0] if results and results[0] else None,
            "challenge_json_complete": complete, "peak_memory_gib": peak_gib,
            "throughput_log": throughput, "step_log": step_lines, "launches": launches,
        }
        emit(result)
        for line in throughput:
            print(f"trainer path: {line}", flush=True)
        losses = [v for h in (history["train_loss"], history["validation_loss"])
                  for epoch in h for v in epoch.values()]
        if not (losses and all(np.isfinite(losses))):
            failures.append(f"trainer path: non-finite losses {history}")
        if trained["epochs"] != 2 or not trained["best"]:
            failures.append(f"trainer path: after training {trained}")
        if resumed["epochs"] != 3 or not any("epoch no 3" in line for line in continued):
            failures.append(f"trainer path: the resume did not continue from epoch 3: {resumed}")
        if not all(reload_equal.values()):
            failures.append(f"trainer path: the reloaded checkpoint differs: {reload_equal}")
        if not complete:
            failures.append("trainer path: the challenge JSON lacks clips or finite scores")
        for name in TRAINER_KERNELS + ("max_pool_backward",):
            if launches[name] < 1:
                failures.append(f"kernel {name} was not launched on the trainer path")
        if then is not None:
            then(card, failures, root, stem + ".pth", overrides)
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The visualizer's path (tools/vis.py), on the trainer path's fixture and
# checkpoint: convert_back's reference .pth, vis.initialize from it
# (config_vis: 3 segments, batch 1, bf16, kernels on), a dataset filtered
# to the fewest (verb, noun) pairs that hold VIS_SAMPLES clips, get_info's
# sweep with the kernels on and off, panels, the PNG and the clip.
VIS_SAMPLES = 8       # get_info's samples
VIS_MHA_TOL = 1e-5    # general MHA, float32 on the card against the CPU (rtol and atol)
VIS_MHA_SHAPE = (2, 3, 13, 1024, 4)  # B, L, S, E, heads


def write_class_tables(root: str, verbs: int, nouns: int) -> None:
    """EPIC_verb_classes.csv / EPIC_noun_classes.csv for the fixture: class
    i named ``verb<i>`` / ``noun<i>``, so an action list resolves."""
    for kind, n in (("verb", verbs), ("noun", nouns)):
        with open(os.path.join(root, "annotations", f"EPIC_{kind}_classes.csv"), "w",
                  newline="") as fh:
            writer = csv.writer(fh)
            writer.writerow([f"{kind}_id", "class_key", f"{kind}s"])
            writer.writerows([i, f"{kind}{i}", f"['{kind}{i}']"] for i in range(n))


def vis_action_pairs(root: str, clips: int) -> list:
    """The fewest (verb, noun) name pairs of the labelled CSV, those with
    the most clips first (first use breaks ties), that hold ``clips`` clips
    (all of them where the file holds fewer)."""
    with open(os.path.join(root, "annotations", "labelled.csv"), newline="") as fh:
        pairs = [(f"verb{r['verb_class']}", f"noun{r['noun_class']}")
                 for r in csv.DictReader(fh)]
    chosen, held = [], 0
    for pair in sorted(dict.fromkeys(pairs), key=lambda p: -pairs.count(p)):
        if held >= clips:
            break
        chosen.append(pair)
        held += pairs.count(pair)
    return chosen


def general_mha_check() -> dict:
    """One general MultiheadAttention call (L = 3 queries, key != value,
    float32, TF32 off) on the card against the same call on the CPU."""
    b, length, s, e, heads = VIS_MHA_SHAPE
    mha = MultiheadAttention(e, heads)
    mha.reset_parameters(torch.Generator().manual_seed(21))
    rng = np.random.default_rng(21)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((b, length, e), (b, s, e), (b, s, e)))
    with torch.no_grad():
        want = mha.eval()(q, k, v, True)
        with tf32_scope("float32"):
            got = mha.cuda()(q.cuda(), k.cuda(), v.cuda(), True)
    err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
    ok = all(torch.allclose(g.cpu(), w, rtol=VIS_MHA_TOL, atol=VIS_MHA_TOL)
             for g, w in zip(got, want))
    return {"shape": {"B": b, "L": length, "S": s, "E": e, "heads": heads},
            "out": list(got[0].shape), "weights": list(got[1].shape), "max_abs_err": err,
            "tol": VIS_MHA_TOL, "ok": ok}


def convert_cli_check(root: str) -> dict:
    """convert_cli on write_pretrained's BN-Inception tower: the .npz read
    back by load_npz equals the in-memory conversion bit for bit, and
    through models/convert's load_npz_tower gives the tower's own state
    dict back bit for bit."""
    sizes = write_pretrained(os.path.join(root, "vis_weights"), seed=4)
    src = os.path.join(root, "vis_weights", "imagenet_bninception_rgb.pth")
    out = os.path.join(root, "vis_weights", "imagenet_bninception_rgb.npz")
    start = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        convert_cli.main(["--input", src, "--kind", "bninception", "--output", out])
    seconds = time.perf_counter() - start
    params, stats = convert_cli.load_npz(out)
    want_params, want_stats = convert_cli.convert(checkpoint.read_state_dict(src), "bninception")
    flat, want = convert_cli.flatten({"params": params, "batch_stats": stats}), \
        convert_cli.flatten({"params": want_params, "batch_stats": want_stats})
    trees_equal = set(flat) == set(want) and all(
        flat[k].dtype == want[k].dtype and np.array_equal(flat[k], want[k]) for k in want)
    tower = convert_bninception(checkpoint.read_state_dict(src))
    back = load_npz_tower(out)
    tower_equal = set(back) == set(tower) and all(torch.equal(back[k], tower[k]) for k in tower)
    return {"seconds": seconds, "arrays": len(flat), "pth_bytes": sizes,
            "npz_bytes": os.path.getsize(out), "bit_equal": trees_equal and tower_equal}


def vis_path(card: str, failures: list, root: str, pth: str, trainer_overrides: list) -> dict:
    """The visualizer on the card (see VIS_SAMPLES above). Launch counts set
    to 0 just before each get_info sweep and read just after. Emits the
    phase's line and its launches line; returns the kernels-on launches."""
    began = time.perf_counter()
    seconds = {}
    ref = os.path.join(root, "reference.pth")
    start = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        convert_back.main(["--output", ref, f"test.pre_trained={pth}"] + trainer_overrides)
    seconds["convert_back"] = time.perf_counter() - start

    write_class_tables(root, *CLASS_HEADS)
    pairs = vis_action_pairs(root, VIS_SAMPLES)
    vis_over = [f"data_dir={root}", f"out_dir={root}/out", "data.audio.read_audio_pickle=false",
                "data.flow.read_flow_pickle=false",
                "train.annotation_file=annotations/labelled.csv", "val.vid_list="]
    start = time.perf_counter()
    cfg, model, modality, state = vis.initialize(vis_over, ref)
    seconds["initialize"] = time.perf_counter() - start
    dataset = vis.create_dataset(cfg, modality, action_list=pairs)
    n = min(VIS_SAMPLES, len(dataset))

    # the reference .pth against the port's own checkpoint: strict, equal
    left_out = checkpoint.load_weights(model, checkpoint.read_state_dict(ref), ref)
    own = build_model(cfg, modality, device="cuda", seed=1)
    checkpoint.load_weights(own, checkpoint.read_state_dict(pth), pth)
    theirs = own.state_dict()
    weights_equal = all(torch.equal(v, theirs[k]) for k, v in model.state_dict().items())
    batch, _, _ = collate([dataset.sample(0)])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
    with torch.no_grad():
        got, want = model(batch), own(batch)
    logits_equal = all(torch.equal(got[k], want[k]) for k in want)
    del own
    torch.cuda.empty_cache()

    off_cfg, off_model, _, off_state = vis.initialize(vis_over + ["tpu.use_pallas=false"], ref)
    for args in ((cfg, model, state), (off_cfg, off_model, off_state)):
        vis.sweep(*args, dataset, max_samples=1)  # warm-up: first calls out of the timed sweeps
    sweeps, launches_by = {}, {}
    for side, args in (("on", (cfg, model, state)), ("off", (off_cfg, off_model, off_state))):
        kernels.reset_launch_counts()
        start = time.perf_counter()
        sweeps[side] = vis.sweep(*args, dataset, max_samples=n)
        torch.cuda.synchronize()
        seconds[f"get_info_{side}"] = time.perf_counter() - start
        launches_by[side] = launch_counts()
    (rows_on, scores_on), (rows_off, scores_off) = sweeps["on"], sweeps["off"]
    launches_on, launches_off = launches_by["on"], launches_by["off"]
    drift = rel_rmse(*(np.concatenate([sc["verb"], sc["noun"]], axis=1)
                       for sc in (scores_on, scores_off)))
    agree = {key: sum(a[f"pred_{key}"] == b[f"pred_{key}"] for a, b in zip(rows_on, rows_off)) / n
             for key in ("verb", "noun")}
    entropy_gap = max(abs(a["attn_entropy"] - b["attn_entropy"])
                      for a, b in zip(rows_on, rows_off))
    del off_model, off_state
    torch.cuda.empty_cache()

    start = time.perf_counter()
    grid = vis.panels(cfg, model, state, dataset, 0)
    seconds["panels"] = time.perf_counter() - start
    shapes = {name: list(grid[name].shape) for name in ("rgb", "spectrograms", "weights")}
    shapes["top5"] = {key: len(top) for key, (top, _) in grid["top5"].items()}

    try:
        import matplotlib  # noqa: F401
    except ImportError as exc:
        rendered = {"done": False, "reason": f"matplotlib is not importable: {exc}"}
    else:
        start = time.perf_counter()
        png = vis.visualize(cfg, model, state, dataset, 0,
                            out_path=os.path.join(root, "vis", "vis_0.png"))
        rendered = {"done": True, "png_bytes": os.path.getsize(png),
                    "seconds": time.perf_counter() - start}
    try:
        import cv2  # noqa: F401
    except ImportError as exc:
        clip = {"done": False, "reason": f"cv2 is not importable: {exc}"}
    else:
        start = time.perf_counter()
        meta = grid["meta"]
        path = vis.save_action_segment(root, meta["vid_id"], meta["start_time"],
                                       meta["stop_time"],
                                       out_path=os.path.join(root, "vis", "temp.MP4"),
                                       fps=float(cfg.data.vid_fps),
                                       rgb_prefix=cfg.data.rgb.dir_prefix)
        clip = {"done": True, "file": os.path.basename(path), "bytes": os.path.getsize(path),
                "seconds": time.perf_counter() - start}

    start = time.perf_counter()
    mha = general_mha_check()
    seconds["general_mha"] = time.perf_counter() - start
    cli = convert_cli_check(root)
    seconds["convert_cli"] = cli["seconds"]
    seconds["phase"] = time.perf_counter() - began
    launches = {"pe_block": launches_on["pe_block"], "mha": launches_on["mha"]}
    emit({"phase": "vis_path", "gpu": card,
          "config": {"entry": "config_vis", "segments": int(cfg.test.num_segments),
                     "compute_dtype": cfg.tpu.compute_dtype,
                     "use_pallas": bool(cfg.tpu.use_pallas), "modalities": modality},
          "convert_back": {"seconds": seconds["convert_back"], "bytes": os.path.getsize(ref)},
          "reload": {"strict": left_out == {"not_in_file": [], "not_in_model": []},
                     "left_out": left_out, "weights_equal": weights_equal,
                     "logits_bit_equal": logits_equal},
          "actions": pairs, "samples": n, "rows": rows_on,
          "kernels_on_vs_off": {"score_rel_rmse": drift, "bound": DRIFT_REL_RMSE,
                                "argmax_agreement": agree, "max_entropy_gap": entropy_gap},
          "launches": {"kernels_on": launches, "kernels_off": {
              "pe_block": launches_off["pe_block"], "mha": launches_off["mha"]}},
          "panels": shapes, "general_mha": mha, "convert_cli": cli,
          "rendered": rendered, "clip": clip, "seconds": seconds})
    emit({"phase": "launches", "path": "vis", **launches_on})
    if not (left_out == {"not_in_file": [], "not_in_model": []} and weights_equal):
        failures.append(f"vis path: the reference .pth did not reload whole: {left_out}")
    if not logits_equal:
        failures.append("vis path: the reference .pth's logits differ from the checkpoint's")
    if n < 1:
        failures.append(f"vis path: the action list {pairs} kept no clip")
    if not drift < DRIFT_REL_RMSE:
        failures.append(f"vis path: scores kernels on vs off rel-RMSE {drift:.4g}")
    if launches != {"pe_block": n, "mha": n}:
        failures.append(f"vis path: launches {launches}, expected one each per forward ({n})")
    if launches_off["pe_block"] or launches_off["mha"]:
        failures.append(f"vis path: kernels off launched {launches_off}")
    if not mha["ok"]:
        failures.append(f"vis path: general MHA on the card vs the CPU {mha['max_abs_err']:.3g}")
    if not cli["bit_equal"]:
        failures.append("vis path: convert_cli's .npz is not bit-equal to its conversion")
    if rendered["done"] and rendered["png_bytes"] < 1000:
        failures.append(f"vis path: the PNG holds {rendered['png_bytes']} bytes")
    if clip["done"] and clip["bytes"] < 1:
        failures.append("vis path: the clip is empty")
    if shapes["weights"][0] != int(cfg.test.num_segments):
        failures.append(f"vis path: panel shapes {shapes}")
    if shapes["weights"][0] not in KERNEL_ROWS:
        failures.append(f"vis path: a forward of {shapes['weights'][0]} rows, which "
                        f"check_kernels does not hold against the plain versions")
    return launches_on


# The multi-rank path: the port's data parallelism (parallel/mesh) through
# torchrun, R = max(2, cards) ranks: one rank per card over NCCL, or two
# ranks sharing one card over gloo. (a) three flagship train steps at full
# width (12 x 3 global batches, seeded pretrained towers, tpu.pool_impl=
# pallas; the third batch ragged, 11 true rows, so rank R-1 holds the pad
# row) on R ranks and in this process, at float32 then bf16; (b) main in
# train mode (the trainer's tri-modal JPEG fixture, 1 epoch + validation,
# then a resume of 1); (c) main in test mode from its .pth on the evaluation
# fixture's labelled file (20 clips; 10-crop, fused stem, fast consensus), at
# float32 and bf16, on R ranks and in this process, and in this process at
# bf16 with a batch of 1, which shows how far bf16 scores move with the
# batch a forward holds alone.
MULTI_RANK_STEPS = (12, 12, 11)  # true rows of each 12-clip global batch
MULTI_RANK_LOSS_RTOL = 1e-4      # float32 losses, R ranks vs one process
# float32 parameters and running statistics, R ranks vs one process, and the
# test scores; the running statistics' change over the three steps (each
# state minus the initial one); bf16: DRIFT_REL_RMSE
MULTI_RANK_REL_RMSE = 1e-3
# The parameters' change over the three steps is ~6e-5 of their norm, near
# float32's spacing, and this process's own steps run twice differ in it
# by ~1e-3 (the card's nondeterministic kernels): float32 holds it to 1e-2,
# where a lost update reads 1 and a world-size factor 0.5; bf16 to one
# process's bf16 change against its float32 one (bf16's own rounding).
MULTI_RANK_CHANGE_REL_RMSE = 1e-2
MULTI_RANK_TEST_BATCH = 4  # global clips a test batch: 5 batches of the 20 (R <= 4)
MULTI_RANK_BATCH1_CLIPS = 8  # the bf16 batch-1 run reads the first 8 clips (time)
# (b)'s fixture, the trainer's cut to 4 + 1 videos (20 + 5 clips; time): an
# epoch is two global batches of 12, the second of 8
MULTI_RANK_VIDEOS, MULTI_RANK_TRAIN_VIDEOS = 5, 4
MULTI_RANK_KERNELS = ("max_pool", "pe_block", "mha", "fused_stem", "consensus_heads")
MULTI_RANK_TIMEOUT_S = 900


def multi_rank_batch(cfg, index: int, rank: int, world: int):
    """This rank's rows of global batch ``index`` (numpy, seeded, the same
    in every process): 12 clips x 3 segments of 224^2 RGB and Flow, 2.1 s
    audio; rows past the true count repeat row 0, the loader's tail
    padding."""
    true_rows, rows = MULTI_RANK_STEPS[index], MULTI_RANK_STEPS[0]
    rng = np.random.default_rng(1000 + index)
    n, crop = int(cfg.train.num_segments), int(cfg.data.train_crop_size)
    audio_len = int(cfg.data.audio.audio_length * cfg.data.audio.sampling_rate)
    batch = {"RGB": rng.integers(0, 256, (true_rows, n, crop, crop, 3), dtype=np.uint8),
             "Flow": rng.integers(0, 256, (true_rows, n, crop, crop,
                                           2 * int(cfg.data.flow.win_length)), dtype=np.uint8),
             "Audio": (rng.standard_normal((true_rows, n, audio_len)) * 0.1).astype(np.float32)}
    targets = {k: rng.integers(0, c, true_rows).astype(np.int64)
               for k, c in cfg.model.num_classes.items()}
    local = rows // world
    own = np.arange(rank * local, (rank + 1) * local) % rows
    own = np.where(own < true_rows, own, 0)  # pad rows: copies of row 0
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x[own])).cuda()  # noqa: E731
    return ({k: to(v) for k, v in batch.items()},
            {"class": {k: to(v) for k, v in targets.items()}}, true_rows)


def multi_rank_steps(weights_dir: str, dtype: str, device) -> tuple:
    """The flagship's three train steps of MULTI_RANK_STEPS on this
    process's rows (all of them in one process); returns (the initial and
    the final state dict on the host, per-step records: global losses, host
    ms to a synchronize, collective ms and count)."""
    from attention_based_tbn_tpu_torch.models.builder import load_pretrained_towers
    from attention_based_tbn_tpu_torch.parallel import mesh

    cfg = load_config(overrides=["model.pretrained=true", f"model.weights_dir={weights_dir}",
                                 "tpu.pool_impl=pallas", f"tpu.compute_dtype={dtype}"])
    modality = get_modality(cfg)
    model = build_model(cfg, modality, device=device)
    load_pretrained_towers(cfg, modality, model, logging.getLogger("chip_smoke"))
    state = create_train_state(cfg, model)
    state.optimizer.set_learning_rate(lr_at_epoch(cfg, 0))
    step = make_train_step(cfg)
    initial = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    records = []
    for index in range(len(MULTI_RANK_STEPS)):
        batch, targets, true_rows = multi_rank_batch(cfg, index, mesh.rank(), mesh.world_size())
        torch.cuda.synchronize()
        start = time.perf_counter()
        with mesh.timed_collectives() as timer:
            state, loss, _ = step(state, batch, targets, 0, true_rows)
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - start) * 1e3
            collective_ms = timer.ms()
        records.append({"losses": {k: float(v) for k, v in loss.items()}, "step_ms": step_ms,
                        "collective_ms": collective_ms, "collectives": timer.calls})
    host = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    del state, model
    torch.cuda.empty_cache()
    return initial, host, records


def state_digest(state_dict: dict) -> str:
    digest = hashlib.sha256()
    for key in sorted(state_dict):
        digest.update(key.encode())
        digest.update(state_dict[key].detach().cpu().contiguous().reshape(-1)
                      .view(torch.uint8).numpy().tobytes())
    return digest.hexdigest()


def counting_main(argv_runs: list) -> list:
    """The port's main once per argv, in this process; per run: its result
    (losses and accuracies where labelled), the trainer's final state digest,
    the digest of the .pth it wrote as read back (rank 0), the files this
    process wrote, and the kernels' launches."""
    from attention_based_tbn_tpu_torch.parallel import mesh
    from attention_based_tbn_tpu_torch.tools import test as port_test

    writes, states = [], []
    write_replacing, save_scores = checkpoint._write_replacing, port_test.save_scores
    run_trainer = port_train.run_trainer

    def counted_write(path, *args):
        writes.append(os.path.basename(path))
        return write_replacing(path, *args)

    def counted_scores(output, path, *args):
        writes.append(os.path.basename(path))
        return save_scores(output, path, *args)

    def kept_trainer(*args, **kwargs):
        states.append(run_trainer(*args, **kwargs))
        return states[-1]

    checkpoint._write_replacing, port_test.save_scores = counted_write, counted_scores
    port_train.run_trainer = kept_trainer
    runs = []
    try:
        for argv in argv_runs:
            del writes[:], states[:]
            kernels.reset_launch_counts()
            start = time.perf_counter()
            results = port_main.main(list(argv))
            torch.cuda.synchronize()
            run = {"wall_s": time.perf_counter() - start, "writes": list(writes),
                   "launches": launch_counts(),
                   "results": [r[:2] if r else None for r in (results or [])]}
            if states:
                cfg = load_config(overrides=list(argv))
                run["state_digest"] = state_digest(states[-1].model.state_dict())
                run["step"] = states[-1].step
                if mesh.is_primary():
                    path = checkpoint_stem(cfg, get_modality(cfg)) + ".pth"
                    run["file_digest"] = state_digest(checkpoint.read_state_dict(path))
            runs.append(run)
    finally:
        checkpoint._write_replacing, port_test.save_scores = write_replacing, save_scores
        port_train.run_trainer = run_trainer
    return runs


def multi_rank_worker(spec_path: str) -> int:
    """One rank of the multi-rank path, under torchrun: (a) the flagship's
    steps at float32 and bf16, (b) main in train mode and a resume, (c) main
    in test mode at float32 and bf16; writes its record to ``<out>/rank<r>.json`` (and rank 0
    its final float32 and bf16 states)."""
    from attention_based_tbn_tpu_torch.parallel import mesh

    logging.basicConfig(stream=sys.stderr, level=logging.WARNING, format="%(message)s")
    spec = read_json(spec_path)
    made = mesh.make_mesh(None, "cuda")
    kernels.reset_launch_counts()
    record = {"rank": made.rank, "world": made.world, "backend": made.backend,
              "device": str(made.device), "shared_card": made.shared_card,
              "describe": made.describe(), "card": torch.cuda.get_device_name(made.device)}
    for dtype in ("float32", "bfloat16"):
        _, state, steps = multi_rank_steps(spec["weights_dir"], dtype, made.device)
        record[dtype] = {"steps": steps, "state_digest": state_digest(state)}
        if made.is_primary():
            torch.save(state, os.path.join(spec["out"], f"state_{dtype}.pt"))
    record["step_launches"] = launch_counts()
    record["main"] = counting_main(spec["main"])
    record["test"] = counting_main(spec["test"])
    with open(os.path.join(spec["out"], f"rank{made.rank}.json"), "w") as fh:
        json.dump(record, fh)
    mesh.shutdown()
    return 0


def run_torchrun(ranks: int, spec_path: str, log_path: str) -> float:
    """This script's worker on ``ranks`` ranks through torchrun, in its own
    process group (killed whole on timeout); raises on a failed rank."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={ranks}", os.path.abspath(__file__),
           "--multi-rank-worker", spec_path]
    start = time.perf_counter()
    with open(log_path, "wb") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)),
                                start_new_session=True)
        try:
            proc.wait(timeout=MULTI_RANK_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, 9)
            proc.wait()
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        with open(log_path, errors="replace") as fh:
            sys.stderr.write(fh.read()[-6000:])
        raise RuntimeError(f"multi-rank path: torchrun exited {proc.returncode}")
    return seconds


def state_rel_rmse(got: dict, want: dict, initial: dict, keys) -> tuple:
    """(rel-RMSE of got's change from ``initial`` against want's change,
    want's change relative to want): a state that did not move reads 1."""
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in keys)
    change = sum(float((want[k].double() - initial[k].double()).square().sum()) for k in keys)
    norm = sum(float(want[k].double().square().sum()) for k in keys)
    return float(np.sqrt(num / max(change, 1e-30))), float(np.sqrt(change / max(norm, 1e-30)))


def multi_rank_path(card: str, failures: list) -> dict:
    """The multi-rank main path (see MULTI_RANK_STEPS): torchrun of this
    script's worker on R ranks, then the one-process references here, the
    gates and the numbers. Returns rank 0's launches over its whole run."""
    ranks = max(2, torch.cuda.device_count())
    root = tempfile.mkdtemp(prefix=".smoke_fixture_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        start = time.perf_counter()
        train_root, test_root = os.path.join(root, "train"), os.path.join(root, "test")
        write_trimodal_fixture(train_root, videos=MULTI_RANK_VIDEOS, actions=TRAINER_ACTIONS,
                               frames=TEST_SPAN * TRAINER_ACTIONS, seed=9, flow_pickle=False)
        names = [f"P{v + 1:02d}_01" for v in range(MULTI_RANK_VIDEOS)]
        for split, vids in (("train", names[:MULTI_RANK_TRAIN_VIDEOS]),
                            ("val", names[MULTI_RANK_TRAIN_VIDEOS:])):
            with open(os.path.join(train_root, f"{split}_split.txt"), "w") as fh:
                fh.write("\n".join(vids) + "\n")
        write_trimodal_fixture(test_root, videos=TEST_VIDEOS, actions=TEST_ACTIONS,
                               frames=TEST_SPAN * TEST_ACTIONS, seed=5, flow_pickle=True)
        ann = os.path.join(test_root, "annotations")
        with open(os.path.join(ann, "labelled.csv")) as fh:
            head = fh.readlines()[:1 + MULTI_RANK_BATCH1_CLIPS]
        with open(os.path.join(ann, "first.csv"), "w") as fh:
            fh.writelines(head)
        weights_dir = os.path.join(root, "weights")
        write_pretrained(weights_dir, seed=4)
        train_over = [
            "model.pretrained=true", f"model.weights_dir={weights_dir}", "tpu.pool_impl=pallas",
            "train.enable=true", "test.enable=false", "val.enable=true", "train.epochs=1",
            f"data_dir={train_root}", f"out_dir={root}/out", "exp_name=ranks",
            "data.flow.read_flow_pickle=false", "train.annotation_file=annotations/labelled.csv",
            f"train.vid_list={train_root}/train_split.txt",
            f"val.vid_list={train_root}/val_split.txt", f"val.batch_size={ranks}"]
        cfg = load_config(overrides=train_over)
        stem = checkpoint_stem(cfg, get_modality(cfg))

        test_batch = max(MULTI_RANK_TEST_BATCH, ranks)

        def test_over(exp, dtype, batch=test_batch, annotations="labelled"):
            return [
                "model.pretrained=false", "train.enable=false", "test.enable=true",
                f"tpu.compute_dtype={dtype}",
                f"data_dir={test_root}", f"out_dir={root}/out", f"exp_name={exp}",
                "data.flow.read_flow_pickle=true", "data.flow.dir_prefix=flow_pickle",
                "test.ten_crop=true", "test.save_results=true", "tpu.fused_stem=true",
                "tpu.fast_consensus=true", f"test.pre_trained={stem}.pth",
                f"test.annotation_file=[annotations/{annotations}.csv]",
                f"test.results_file=[{exp}.json]", f"test.vid_list={test_root}/split.txt",
                f"test.batch_size={batch}"]

        dtypes = ("float32", "bfloat16")
        spec = {"out": root, "weights_dir": weights_dir,
                "main": [train_over, train_over + [f"train.pre_trained={stem}.pth"]],
                "test": [test_over(f"ranks_{d}", d) for d in dtypes]}
        spec_path = os.path.join(root, "spec.json")
        with open(spec_path, "w") as fh:
            json.dump(spec, fh)
        setup_s = time.perf_counter() - start
        torch.cuda.empty_cache()
        torchrun_s = run_torchrun(ranks, spec_path, os.path.join(root, "torchrun.log"))
        records = [read_json(os.path.join(root, f"rank{r}.json")) for r in range(ranks)]

        # the one-process references, in this process (no process group)
        start = time.perf_counter()
        gates = {}
        one_process = {}
        for dtype in dtypes:
            initial, want, want_steps = multi_rank_steps(weights_dir, dtype,
                                                         torch.device("cuda"))
            got = torch.load(os.path.join(root, f"state_{dtype}.pt"), weights_only=True)
            params = [k for k in want if "running_" not in k and "num_batches" not in k
                      and want[k].is_floating_point()]
            stats = [k for k in want if "running_" in k]
            losses = [max(abs(g - w) / abs(w) for k, w in ws["losses"].items()
                          for g in [gs["losses"][k]])
                      for gs, ws in zip(records[0][dtype]["steps"], want_steps)]
            g = {"loss_rel": losses,
                 "ranks_bit_equal": len({r[dtype]["state_digest"] for r in records}) == 1,
                 "one_process_step_ms": [s["step_ms"] for s in want_steps]}
            for name, keys in (("params", params), ("running_stats", stats)):
                gap, change = state_rel_rmse(got, want, initial, keys)
                g.update({f"{name}_change_rel_rmse": gap, f"{name}_change_of_norm": change,
                          f"{name}_rel_rmse": gap * change})
            # what the change's gap is made of without a second rank: float32,
            # this process's steps again (the card's nondeterministic
            # kernels); bf16, one process's bf16 change against its float32 one
            if dtype == "float32":
                _, again, _ = multi_rank_steps(weights_dir, dtype, torch.device("cuda"))
                g["params_change_rel_rmse_one_process_again"] = state_rel_rmse(
                    again, want, initial, params)[0]
                del again
            else:
                g["params_change_rel_rmse_one_process_vs_float32"] = state_rel_rmse(
                    want, one_process["float32"], initial, params)[0]
            gates[dtype] = g
            one_process[dtype] = want
            del initial, got
        del one_process
        one_tests = counting_main([test_over(f"one_{d}", d) for d in dtypes]
                                  + [test_over("one_bfloat16_batch1", "bfloat16", 1, "first")])
        reference_s = time.perf_counter() - start

        def scores(exp):
            path = os.path.join(root, "out", "inferences", f"{exp}.json")
            with open(path) as fh:
                return list(json.load(fh)["results"]), read_scores(path)

        def score_gap(got, want):
            """Over got's uids, which must lead want's in the same order."""
            (got_order, got_scores), (want_order, want_scores) = got, want
            if not got_order or got_order != want_order[:len(got_order)]:
                return None
            return {head: rel_rmse(np.stack([got_scores[u][h] for u in got_order]),
                                   np.stack([want_scores[u][h] for u in got_order]))
                    for h, head in enumerate(("verb", "noun"))}

        test_runs = {exp: scores(exp) for exp in [f"{w}_{d}" for w in ("ranks", "one")
                                                   for d in dtypes] + ["one_bfloat16_batch1"]}
        score_gaps = {d: score_gap(test_runs[f"ranks_{d}"], test_runs[f"one_{d}"])
                      for d in dtypes}
        # one process, bf16: a batch of 1 against the batch of test_batch
        batch_gap = score_gap(test_runs["one_bfloat16_batch1"], test_runs["one_bfloat16"])
        sustained = {exp: [line.split(" : ")[-1] for line in run_log_lines(
            os.path.join(root, "out", "log", exp), "Inference throughput")] for exp in test_runs}
        train_log = run_log_lines(os.path.join(root, "out", "log", "ranks"), "epoch no 2")

        per_rank = []
        for r in records:
            steps = r["float32"]["steps"] + r["bfloat16"]["steps"]
            per_rank.append({
                "rank": r["rank"], "device": r["device"], "card": r["card"],
                "step_ms_p50": {d: float(np.median([s["step_ms"] for s in r[d]["steps"]]))
                                for d in ("float32", "bfloat16")},
                "collective_share": {d: float(np.median([s["collective_ms"] / s["step_ms"]
                                                         for s in r[d]["steps"]]))
                                     for d in ("float32", "bfloat16")},
                "collectives_per_step": steps[0]["collectives"],
                "step_launches": r["step_launches"],
                "main_launches": [m["launches"] for m in r["main"]],
                "test_launches": [t["launches"] for t in r["test"]],
                "digests": [r["float32"]["state_digest"][:12], r["bfloat16"]["state_digest"][:12]]
                + [m["state_digest"][:12] for m in r["main"]],
                "writes": [m["writes"] for m in r["main"] + r["test"]]})
        first = records[0]
        result = {
            "phase": "multi_rank_path", "gpu": card, "ranks": ranks,
            "backend": first["backend"], "shared_card": first["shared_card"],
            "mesh": first["describe"], "setup_s": setup_s, "torchrun_s": torchrun_s,
            "reference_s": reference_s, "gates": gates, "per_rank": per_rank,
            "losses": {d: [s["losses"]["total"] for s in first[d]["steps"]]
                       for d in ("float32", "bfloat16")},
            "main_wall_s": [m["wall_s"] for m in first["main"]],
            "test_batch": test_batch, "test_wall_s": [t["wall_s"] for t in first["test"]],
            "one_process_test_wall_s": [t["wall_s"] for t in one_tests],
            "test_score_rel_rmse": score_gaps, "bf16_batch1_vs_batch_rel_rmse": batch_gap,
            "test_uids": len(test_runs["one_float32"][0]), "throughput_log": sustained,
            "resume_log": [line.split(" : ")[-1] for line in train_log],
            "test_results": [t["results"] for t in first["test"]],
            "one_test_results": [t["results"] for t in one_tests],
        }
        emit(result)
        print(f"multi-rank path: {ranks} ranks, backend {first['backend']}"
              f"{' (ranks share one card)' if first['shared_card'] else ''}; {card}", flush=True)
        for r in per_rank:
            print(f"multi-rank path: rank {r['rank']} state digests (fp32 / bf16 steps, "
                  f"main train / resume) {r['digests']}; the .pth read back "
                  f"{[m.get('file_digest', '')[:12] for m in first['main']]}", flush=True)
            print(f"multi-rank path: rank {r['rank']} on {r['device']}: step p50 "
                  f"{r['step_ms_p50']['float32']:.1f} ms fp32 / "
                  f"{r['step_ms_p50']['bfloat16']:.1f} ms bf16, collectives "
                  f"{100 * r['collective_share']['float32']:.1f}% / "
                  f"{100 * r['collective_share']['bfloat16']:.1f}% of it "
                  f"({r['collectives_per_step']} a step); launches {r['step_launches']}",
                  flush=True)
        for dtype, g in gates.items():
            floor = {k: v for k, v in g.items() if "_one_process_" in k}
            print(f"multi-rank path, {dtype}: loss rel {max(g['loss_rel']):.3g}; params "
                  f"rel-RMSE {g['params_rel_rmse']:.3g}, running stats "
                  f"{g['running_stats_rel_rmse']:.3g}; the change of the params rel-RMSE "
                  f"{g['params_change_rel_rmse']:.3g} (the change "
                  f"{g['params_change_of_norm']:.3g} of their norm; {floor}), of the running "
                  f"stats {g['running_stats_change_rel_rmse']:.3g} "
                  f"({g['running_stats_change_of_norm']:.3g}); ranks bit-equal "
                  f"{g['ranks_bit_equal']}", flush=True)
        print(f"multi-rank path: test scores rel-RMSE, {ranks} ranks vs one process at batch "
              f"{test_batch}: {score_gaps}; one process, bf16, batch 1 vs {test_batch}: "
              f"{batch_gap}", flush=True)
        for exp, lines in sustained.items():
            for line in lines:
                print(f"multi-rank path: test {exp}, {line}", flush=True)

        # the gates
        for dtype, bound in (("float32", MULTI_RANK_REL_RMSE), ("bfloat16", DRIFT_REL_RMSE)):
            g = gates[dtype]
            loss_bound = MULTI_RANK_LOSS_RTOL if dtype == "float32" else DRIFT_REL_RMSE
            if not max(g["loss_rel"]) < loss_bound:
                failures.append(f"multi-rank {dtype}: step losses {g['loss_rel']} vs one "
                                f"process >= {loss_bound}")
            change_bounds = {"params": MULTI_RANK_CHANGE_REL_RMSE, "running_stats": bound}
            if dtype == "bfloat16":  # bf16's own rounding of the change
                change_bounds["params"] = g["params_change_rel_rmse_one_process_vs_float32"]
            for name, change_bound in change_bounds.items():
                for key, limit in ((f"{name}_rel_rmse", bound),
                                   (f"{name}_change_rel_rmse", change_bound)):
                    if not g[key] < limit:
                        failures.append(f"multi-rank {dtype}: {key} {g[key]} >= {limit}")
            if not g["ranks_bit_equal"]:
                failures.append(f"multi-rank {dtype}: the ranks' states differ")
        for i, name in enumerate(("train", "resume")):
            digests = {r["main"][i]["state_digest"] for r in records}
            if len(digests) != 1 or first["main"][i].get("file_digest") not in digests:
                failures.append(f"multi-rank main {name}: rank digests {digests}, file "
                                f"{first['main'][i].get('file_digest')}")
            writes = [r["main"][i]["writes"] for r in records]
            if any(writes[1:]) or not writes[0]:
                failures.append(f"multi-rank main {name}: files written per rank {writes}")
        if not train_log:
            failures.append("multi-rank main: the resume did not continue from epoch 2")
        for i, dtype in enumerate(dtypes):
            writes = [r["test"][i]["writes"] for r in records]
            if any(writes[1:]) or writes[0] != [f"ranks_{dtype}.json"]:
                failures.append(f"multi-rank test {dtype}: files written per rank {writes}")
            order = test_runs[f"ranks_{dtype}"][0]
            if score_gaps[dtype] is None or order != test_runs[f"one_{dtype}"][0] \
                    or len(order) != TEST_VIDEOS * TEST_ACTIONS:
                failures.append(f"multi-rank test {dtype}: uid order {order} vs one process "
                                f"{test_runs[f'one_{dtype}'][0]}")
                continue
            bound = MULTI_RANK_REL_RMSE if dtype == "float32" else DRIFT_REL_RMSE
            if not all(v < bound for v in score_gaps[dtype].values()):
                failures.append(f"multi-rank test {dtype}: scores rel-RMSE {score_gaps[dtype]} "
                                f"vs one process >= {bound}")
        for r in records:
            ran = {name: r["step_launches"][name] + sum(m["launches"][name]
                                                        for m in r["main"] + r["test"])
                   for name in MULTI_RANK_KERNELS}
            ran["max_pool_backward"] = r["step_launches"]["max_pool_backward"]
            for name, count in ran.items():
                if count < 1:
                    failures.append(f"multi-rank path: kernel {name} not launched on rank "
                                    f"{r['rank']}")
        totals = {name: first["step_launches"][name] + sum(m["launches"][name]
                                                          for m in first["main"] + first["test"])
                  for name in kernels.WRAPPERS}
        return totals
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The export path: the flagship with five kernels inside its programs.
EXPORT_OVERRIDES = ["tpu.fused_stem=true", "tpu.fast_consensus=true", "tpu.pool_impl=pallas"]
EXPORT_OPS = {"pe_block": ("tbn::pe_block", "tbn::pe_block_bf16"), "mha": ("tbn::mha",),
              "fused_stem": ("tbn::fused_stem",), "consensus_heads": ("tbn::consensus_heads",),
              "max_pool": ("tbn::max_pool",)}
# A bundle against the eager model on the same weights, same flags and
# batch shapes: the same ops in the same order; only cuDNN's choice of
# algorithm may differ.
EXPORT_REL_RMSE = 1e-3
# The int8 bundle's params.pt against the bf16 one's (int8 kernels + fp32
# scales against bf16 kernels; BatchNorm, biases and buffers fp32 in both).
INT8_BYTES_RATIO = 0.6


def outputs_rel_rmse(got: dict, want: dict) -> dict:
    return {k: rel_rmse(got[k], want[k]) for k in want}


def export_path(card: str, failures: list) -> dict:
    """The serving export at full width: the flagship (tri-modal, MHA,
    224^2, 25 segments, bf16) with EXPORT_OVERRIDES, from the serving
    phase's seeded weights, exported by ``tools/export.export_inference`` as
    (a) a bf16 bundle at batch 10 with a bucket of 1 and (b) an int8 bundle
    at batch 10, then served by ``tools/serve.BundleModel``. Gates: each
    program holds the five kernels' op nodes; the bundles against the eager
    ``ServingModel`` on the bundle's own weights (bf16 kernels widened to
    fp32; dequantize(quantize_int8(weights))) within EXPORT_REL_RMSE at b =
    1, 3 and 10; the int8 params stored as int8 in under INT8_BYTES_RATIO of
    the bf16 bytes; ten concurrent b=1 requests through a BatchingFront
    (5 ms window) equal to their lone predicts, at least one group
    coalesced. Launch counts are set to 0 just before the bundles serve and
    read after; each of the five must rise. Returns those launches."""
    from attention_based_tbn_tpu_torch.models.bridge import kernel_keys
    from attention_based_tbn_tpu_torch.tools.export import (
        _kernel_ops, dequantize, export_inference, quantize_int8)
    from attention_based_tbn_tpu_torch.tools.serve import BatchingFront, BundleModel

    root = tempfile.mkdtemp(prefix=".smoke_fixture_export_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        cfg = load_config(overrides=EXPORT_OVERRIDES)
        modality = get_modality(cfg)
        weights = build_model(cfg, modality, device="cuda").state_dict()
        dirs = {"bf16": os.path.join(root, "bf16"), "int8": os.path.join(root, "int8")}
        export = {}
        for name, dtype, buckets in (("bf16", "bfloat16", [1]), ("int8", "int8", None)):
            export_inference(cfg, modality, state=weights, out_dir=dirs[name], batch_size=10,
                             serving_dtype=dtype, batch_buckets=buckets, device="cuda")
            manifest = read_json(os.path.join(dirs[name], "manifest.json"))
            export[name] = {"export_seconds": manifest["export_seconds"],
                            "kernel_ops": manifest["kernel_ops"],
                            "bytes": {f: os.path.getsize(os.path.join(dirs[name], f))
                                      for f in sorted(os.listdir(dirs[name]))}}
        emit({"phase": "export", "gpu": card, "overrides": EXPORT_OVERRIDES, **export})

        # stored int8: every quantized tensor as int8, the file under the ratio
        stored = torch.load(os.path.join(dirs["int8"], "params.pt"), weights_only=True)
        quantized = {k for k, v in stored.items() if isinstance(v, dict)}
        not_int8 = sorted(k for k in quantized if stored[k]["q"].dtype != torch.int8)
        ratio = export["int8"]["bytes"]["params.pt"] / export["bf16"]["bytes"]["params.pt"]
        emit({"phase": "export_int8_params", "quantized": len(quantized),
              "kernel_keys": len(kernel_keys(weights)), "not_int8": not_int8,
              "bytes_vs_bf16": ratio, "bound": INT8_BYTES_RATIO})
        if not_int8 or quantized != kernel_keys(weights):
            failures.append(f"int8 params: {len(quantized)} quantized tensors, "
                            f"{len(kernel_keys(weights))} kernels, not int8: {not_int8[:5]}")
        if not ratio < INT8_BYTES_RATIO:
            failures.append(f"int8 params.pt is {ratio:.3f}x the bf16 one's bytes, "
                            f"not under {INT8_BYTES_RATIO}")
        del stored

        # the eager references, after the exports: the bundles' own weights
        own = {"bf16": {k: v.float() if v.dtype == torch.bfloat16 else v for k, v in
                        torch.load(os.path.join(dirs["bf16"], "params.pt"),
                                   map_location="cuda", weights_only=True).items()},
               "int8": dequantize(quantize_int8(weights))}
        # each eager model at its bundle's buckets: a b=1 request runs at
        # batch 1 or padded to 10 in both (cuDNN's algorithms differ by batch)
        buckets = {"bf16": (1, 10), "int8": (10,), "original": (1, 10)}
        eager = {name: ServingModel(cfg, own.get(name, weights), device="cuda",
                                    batch_buckets=buckets[name])
                 for name in ("bf16", "int8", "original")}
        requests = {b: eager["original"].example_batch(b, seed=40 + b) for b in (1, 3, 10)}
        want = {name: {b: model.predict(batch) for b, batch in requests.items()}
                for name, model in eager.items()}
        # the bundles, fresh, serving with the launch counts from 0
        bundles = {name: BundleModel(d, device="cuda") for name, d in dirs.items()}
        program_ops = {name: {str(b): _kernel_ops(gm) for b, gm in bundle._programs.items()}
                       for name, bundle in bundles.items()}
        for name, by_bucket in program_ops.items():
            for bucket, ops in by_bucket.items():
                missing = [k for k, names in EXPORT_OPS.items()
                           if not any(ops.get(n) for n in names)]
                if missing:
                    failures.append(f"export {name} bucket {bucket}: no op node of {missing}")
        kernels.reset_launch_counts()
        got = {name: {b: bundle.predict(batch) for b, batch in requests.items()}
               for name, bundle in bundles.items()}
        launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
        result = {"phase": "export_agreement", "gpu": card, "program_ops": program_ops,
                  "launches": launches, "rel_rmse_bound": EXPORT_REL_RMSE}
        for name in ("bf16", "int8"):
            result[name] = {}
            for b in requests:
                errs = outputs_rel_rmse(got[name][b], want[name][b])
                result[name][f"b{b}"] = errs
                bucket = 1 if b == 1 else 10
                if any(not e <= EXPORT_REL_RMSE for e in errs.values()):
                    failures.append(f"export {name} b={b} (bucket {bucket}) vs eager: {errs}")
                check_outputs(f"export {name} b={b}", got[name][b], b, failures)
        # reported, not gated: the bf16 bundle against the fp32 weights, and
        # int8 against bf16
        result["bf16_vs_fp32_weights"] = outputs_rel_rmse(got["bf16"][10], want["original"][10])
        result["int8_vs_bf16"] = outputs_rel_rmse(got["int8"][10], got["bf16"][10])
        result["int8_vs_bf16_top1_agreement"] = {
            h: float(np.mean(got["int8"][10][h].argmax(-1) == got["bf16"][10][h].argmax(-1)))
            for h in ("verb", "noun")}
        emit(result)
        for name in EXPORT_OPS:
            if launches[name] < 1:
                failures.append(f"kernel {name} was not launched serving the bundles")

        # BatchingFront: ten concurrent b=1 requests against their lone predicts
        front_model = bundles["int8"]  # one bucket: lone and grouped rows share a program
        singles = [front_model.example_batch(1, seed=60 + i) for i in range(10)]
        start = time.perf_counter()
        lone = [front_model.predict(batch) for batch in singles]
        serial_s = time.perf_counter() - start
        front = BatchingFront(front_model, window_ms=5.0)
        replies: list = [None] * len(singles)
        barrier = threading.Barrier(len(singles))

        def client(i):
            barrier.wait()
            try:
                replies[i] = front.submit(singles[i])
            except Exception as exc:  # each reply is checked below
                replies[i] = exc

        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(singles))]
        start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=300)
        concurrent_s = time.perf_counter() - start
        front.close()
        errs = []
        for i, reply in enumerate(replies):
            if not isinstance(reply, dict):
                failures.append(f"BatchingFront request {i}: {reply!r}")
                continue
            errs.append(max(outputs_rel_rmse(reply, lone[i]).values()))
        emit({"phase": "export_batching_front", "gpu": card, "bundle": "int8",
              "window_ms": 5.0, "requests": len(singles),
              "group_sizes": dict(front.group_sizes), "concurrent_s": concurrent_s,
              "serial_s": serial_s, "max_rel_rmse_vs_lone": max(errs, default=None),
              "rel_rmse_bound": EXPORT_REL_RMSE})
        if any(not e <= EXPORT_REL_RMSE for e in errs):
            failures.append(f"BatchingFront replies vs lone predicts: rel-RMSE {errs}")
        if not any(size > 1 for size in front.group_sizes):
            failures.append(f"BatchingFront coalesced no group: {dict(front.group_sizes)}")

        # latency and device launches per request: the bundles beside eager
        perf = {"phase": "export_latency", "gpu": card}
        for name, model in (("bf16_bundle", bundles["bf16"]), ("int8_bundle", bundles["int8"]),
                            ("eager", eager["original"])):
            perf[name] = {f"b{b}": bench(model, 20, b) for b in (1, 10)}
            batch = requests[10]
            model.predict(batch)
            perf[name]["profile_b10"] = device_profile(lambda: model.predict(batch))
        emit(perf)
        del bundles, eager, front_model
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# The arch path: the ResNet and VGG tower families at full width (224^2,
# 25 segments, bf16, kernels on), attention off (the JAX package refuses
# audio attention on these towers), fast consensus on so that the eval
# forward runs consensus_heads at F = 512 (Fusion).
ARCH_OVERRIDES = ["model.attention.enable=false", "tpu.fast_consensus=true"]
RESNET_OVERRIDES = ["model.arch=resnet", "model.resnet.depth=101"] + ARCH_OVERRIDES
VGG_OVERRIDES = ["model.arch=vgg", "model.vgg.type=16"] + ARCH_OVERRIDES
ARCH_TEST_VIDEOS, ARCH_TEST_ACTIONS = 2, 5  # clips per annotation file: 10 (cut from 20: time)
ARCH_TRAIN_BATCHES = [12] * 6  # two warm-ups, four timed steps


def check_logits(name: str, out: dict, b: int, failures: list) -> None:
    for key, classes in (("verb", CLASS_HEADS[0]), ("noun", CLASS_HEADS[1])):
        arr = out.get(key)
        if arr is None or arr.shape != (b, classes) or not np.isfinite(arr).all():
            failures.append(f"{name}: {key} {None if arr is None else arr.shape} != "
                            f"{(b, classes)} or not finite")


def arch_serving(name: str, overrides: list, buckets: tuple, card: str, failures: list):
    """One tower family served (seeded weights, buckets ``buckets``): a
    request at each bucket, kernels' launches counted from 0 over them;
    the largest bucket's logits against the same weights in float32 with
    the kernels off and in bf16 with them off (both within the drift
    bound); latency, peak memory and a device profile. Returns (the model,
    its state dict, the launches)."""
    cfg = load_config(overrides=overrides)
    served = ServingModel(cfg, None, device="cuda", batch_buckets=buckets)
    state = served.model.state_dict()
    batches = {b: served.example_batch(b, seed=70 + b) for b in buckets}
    kernels.reset_launch_counts()
    outs = {b: served.predict(batch) for b, batch in batches.items()}
    launches = {k: fn.launches for k, fn in kernels.WRAPPERS.items()}
    for b, out in outs.items():
        check_logits(f"{name} b={b}", out, b, failures)
    top = buckets[-1]
    refs = {}
    for ref, over in (("fp32_kernels_off", ["tpu.compute_dtype=float32", "tpu.use_pallas=false"]),
                      ("bf16_kernels_off", ["tpu.use_pallas=false"])):
        model = ServingModel(load_config(overrides=overrides + over), state, device="cuda",
                             batch_buckets=(top,))
        refs[ref] = outputs_rel_rmse(outs[top], model.predict(batches[top]))
        del model
        torch.cuda.empty_cache()
    result = {"phase": f"{name}_serve", "gpu": card, "overrides": overrides,
              "buckets": list(buckets), "launches": launches,
              "rel_rmse_vs": refs, "rel_rmse_bound": DRIFT_REL_RMSE}
    for ref, errs in refs.items():
        if any(not e < DRIFT_REL_RMSE for e in errs.values()):
            failures.append(f"{name} serving vs {ref}: rel-RMSE {errs} >= {DRIFT_REL_RMSE}")
    if launches["consensus_heads"] < len(buckets):
        failures.append(f"{name} serving: consensus_heads launched "
                        f"{launches['consensus_heads']} times for {len(buckets)} requests")
    result["latency"] = {f"b{b}": bench(served, 20 if b == 1 else 10, b) for b in buckets}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    served.predict(batches[top])
    result["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    result[f"profile_b{top}"] = device_profile(lambda: served.predict(batches[top]))
    emit(result)
    return served, state, launches


def arch_evaluation(card: str, failures: list) -> dict:
    """ResNet-101 through the port's main in test mode on the smoke's Flow
    (.npz) + Audio (WAV) fixture (RGB off: the tri-modal evaluation is the
    flagship's), from a seeded {"model": state_dict} .pth, 10-crop, 25
    segments, the challenge JSON of a labelled and an unlabelled file; once
    with the kernels on (consensus_heads) and once off; both JSONs' scores
    within the drift bound. Returns the launches of the kernels-on run."""
    root = tempfile.mkdtemp(prefix=".smoke_fixture_arch_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        write_test_fixture(root, videos=ARCH_TEST_VIDEOS, actions=ARCH_TEST_ACTIONS,
                           frames=120 * ARCH_TEST_ACTIONS, seed=6)
        model_over = RESNET_OVERRIDES + ["data.rgb.enable=false", "model.pretrained=false"]
        cfg = load_config(overrides=model_over)
        pth = os.path.join(root, "weights.pth")
        torch.save({"model": build_model(cfg, get_modality(cfg), device="cuda",
                                         seed=11).state_dict()}, pth)
        torch.cuda.empty_cache()
        overrides = model_over + ["train.enable=false",
            "test.enable=true", f"data_dir={root}", f"out_dir={root}/out", "exp_name=arch",
            "data.flow.read_flow_pickle=true", "data.flow.dir_prefix=flow", "test.ten_crop=true",
            "test.save_results=true", f"test.pre_trained={pth}",
            "test.annotation_file=[annotations/labelled.csv, annotations/unlabelled.csv]",
            "test.results_file=[labelled.json, unlabelled.json]",
            f"test.vid_list={root}/split.txt", f"test.batch_size={TEST_BATCH}",
        ]
        kernels.reset_launch_counts()
        start = time.perf_counter()
        results = port_main.main(overrides)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
        launches = {k: fn.launches for k, fn in kernels.WRAPPERS.items()}
        plain_over = overrides + ["tpu.use_pallas=false", "exp_name=arch_plain",
                                  "test.results_file=[plain_labelled.json, plain_unlabelled.json]"]
        kernels.reset_launch_counts()
        port_main.main(plain_over)
        plain_launches = sum(fn.launches for fn in kernels.WRAPPERS.values())
        uids = [r["uid"] for r in load_annotations(os.path.join(root, "annotations",
                                                                "labelled.csv"))]
        files = {}
        for name in ("labelled.json", "unlabelled.json"):
            got = read_scores(os.path.join(root, "out", "inferences", name))
            want = read_scores(os.path.join(root, "out", "inferences", "plain_" + name))
            complete = sorted(got) == sorted(uids) == sorted(want) and all(
                np.isfinite(v).all() and np.isfinite(n).all() for v, n in got.values())
            files[name] = {"uids": len(got), "complete": complete}
            if not complete:
                failures.append(f"arch test path: {name} lacks uids or finite scores")
                continue
            for h, head in enumerate(("verb", "noun")):
                drift = rel_rmse(np.stack([got[u][h] for u in uids]),
                                 np.stack([want[u][h] for u in uids]))
                files[name][f"{head}_rel_rmse_vs_kernels_off"] = drift
                if not drift < DRIFT_REL_RMSE:
                    failures.append(f"arch test path {name} {head}: rel-RMSE {drift} >= "
                                    f"{DRIFT_REL_RMSE}")
        labelled = results[0] if results else None
        if labelled is None or not np.isfinite(labelled[0]["total"]):
            failures.append(f"arch test path: labelled results {labelled}")
        if launches["consensus_heads"] < 1 or plain_launches:
            failures.append(f"arch test path: consensus_heads launches "
                            f"{launches['consensus_heads']}, kernels off {plain_launches}")
        throughput = run_log_lines(os.path.join(root, "out", "log", "arch"),
                                   "Inference throughput")
        emit({"phase": "resnet101_test_path", "gpu": card, "clips_per_file": len(uids),
              "files": files, "wall_s": wall, "launches": launches,
              "kernels_off_launches": plain_launches,
              "test_loss": labelled[0] if labelled else None, "throughput_log": throughput})
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def arch_training(card: str, failures: list) -> dict:
    """ResNet-101 train steps of the flagship recipe (12 x 3 segments, SGD
    momentum 0.9 at lr 1e-2, partialbn, which these towers ignore, clip 20,
    bf16, seeded weights) on in-memory batches: two warm-ups, then timed
    steps; every loss finite, no parameter frozen."""
    cfg = load_config(overrides=RESNET_OVERRIDES + ["model.pretrained=false"])
    model = build_model(cfg, get_modality(cfg), device="cuda")
    state = create_train_state(cfg, model)
    state.optimizer.set_learning_rate(lr_at_epoch(cfg, 0))
    step = make_train_step(cfg)
    loader = SmokeLoader(cfg, ARCH_TRAIN_BATCHES, int(cfg.train.num_segments),
                         int(cfg.data.train_crop_size), seed=3)
    times, losses = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for batch, targets, meta in loader:
        start = time.perf_counter()
        state, loss, _ = step(state, batch, targets, 0, meta["batch_size"])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - start) * 1e3)
        losses.append(float(loss["total"]))
    timed = sorted(times[2:])
    result = {"phase": "resnet101_train_step", "gpu": card, "batch": ARCH_TRAIN_BATCHES[0],
              "segments": int(cfg.train.num_segments), "losses": losses,
              "step_ms_p50": timed[len(timed) // 2], "step_ms": times,
              "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2**30,
              "frozen": len(state.optimizer.frozen_names),
              "trainable": len(state.optimizer.trainable)}
    emit(result)
    if not all(np.isfinite(losses)) or state.step != len(ARCH_TRAIN_BATCHES):
        failures.append(f"resnet101 train: steps {state.step}, losses {losses}")
    if state.optimizer.frozen_names:
        failures.append(f"resnet101 train: partialbn froze {len(state.optimizer.frozen_names)} "
                        "parameters; these towers ignore it")
    del state, model
    torch.cuda.empty_cache()
    return result


def arch_bundle(state: dict, card: str, failures: list) -> dict:
    """The ResNet-101 TBN exported as a bf16 bundle at batch 1 and served:
    equal to the eager model on the bundle's own weights within
    EXPORT_REL_RMSE; the program holds the consensus_heads op node."""
    from attention_based_tbn_tpu_torch.tools.export import export_inference
    from attention_based_tbn_tpu_torch.tools.serve import BundleModel

    root = tempfile.mkdtemp(prefix=".smoke_fixture_arch_export_",
                            dir=os.path.dirname(os.path.abspath(__file__)))
    try:
        cfg = load_config(overrides=RESNET_OVERRIDES)
        modality = get_modality(cfg)
        export_inference(cfg, modality, state=state, out_dir=root, batch_size=1,
                         serving_dtype="bfloat16", device="cuda")
        manifest = read_json(os.path.join(root, "manifest.json"))
        own = {k: v.float() if v.dtype == torch.bfloat16 else v
               for k, v in torch.load(os.path.join(root, "params.pt"), map_location="cuda",
                                      weights_only=True).items()}
        eager = ServingModel(cfg, own, device="cuda", batch_buckets=(1,))
        bundle = BundleModel(root, device="cuda")
        batch = eager.example_batch(1, seed=80)
        kernels.reset_launch_counts()
        got = bundle.predict(batch)
        launches = {k: fn.launches for k, fn in kernels.WRAPPERS.items()}
        errs = outputs_rel_rmse(got, eager.predict(batch))
        ops = manifest["kernel_ops"]["module.pt2"]
        result = {"phase": "resnet101_bundle", "gpu": card, "serving_dtype": "bfloat16",
                  "export_seconds": manifest["export_seconds"], "kernel_ops": ops,
                  "bytes": {f: os.path.getsize(os.path.join(root, f))
                            for f in sorted(os.listdir(root))},
                  "rel_rmse_vs_eager": errs, "rel_rmse_bound": EXPORT_REL_RMSE,
                  "launches": launches, "latency_b1": bench(bundle, 20, 1)}
        emit(result)
        check_logits("resnet101 bundle", got, 1, failures)
        if any(not e <= EXPORT_REL_RMSE for e in errs.values()):
            failures.append(f"resnet101 bundle vs eager: {errs}")
        if not ops.get("tbn::consensus_heads") or launches["consensus_heads"] < 1:
            failures.append(f"resnet101 bundle: consensus_heads ops {ops}, launches {launches}")
        del eager, bundle
        torch.cuda.empty_cache()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def arch_path(card: str, failures: list) -> dict:
    """The ResNet and VGG tower families at full width: ResNet-101 served,
    evaluated through main, trained and exported; VGG-16 served. Each part
    counts the kernels' launches from 0; returns them per part."""
    start = time.perf_counter()
    served, state, serve_launches = arch_serving("resnet101", RESNET_OVERRIDES, (1, 10), card,
                                                 failures)
    del served
    torch.cuda.empty_cache()
    launches = {"resnet101_serve": serve_launches,
                "resnet101_test": arch_evaluation(card, failures)}
    arch_training(card, failures)
    launches["resnet101_bundle"] = arch_bundle(state, card, failures)
    del state
    torch.cuda.empty_cache()
    served, _, launches["vgg16_serve"] = arch_serving("vgg16", VGG_OVERRIDES, (1, 2), card,
                                                      failures)
    del served
    torch.cuda.empty_cache()
    emit({"phase": "arch_path", "gpu": card, "wall_s": time.perf_counter() - start,
          "consensus_heads_launches": {k: v["consensus_heads"] for k, v in launches.items()}})
    return launches


def main(argv=None) -> int:
    global _LOG
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", default=None, help="also append every JSON line to this file")
    parser.add_argument("--quick", action="store_true",
                        help="build and check the kernels only; prints no ok line")
    parser.add_argument("--multi-rank-worker", metavar="SPEC", default=None,
                        help="(internal) one rank of the multi-rank path, under torchrun")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.multi_rank_worker:
        return multi_rank_worker(args.multi_rank_worker)
    logging.basicConfig(stream=sys.stderr, level=logging.INFO, format="%(message)s")
    _LOG = args.out
    if _LOG:
        os.makedirs(os.path.dirname(_LOG) or ".", exist_ok=True)
    failures: list = []
    card = gpu_line()
    start = time.perf_counter()
    native_build: dict = {}

    def build_native():  # g++, beside the nvcc builds
        began = time.perf_counter()
        try:
            native_build["compile_s"] = native.build()
            native.load()
        except native.NativeBuildError as exc:
            native_build["error"] = str(exc)
        native_build["build_s"] = time.perf_counter() - began

    native_thread = threading.Thread(target=build_native)
    native_thread.start()
    build_s = build.build()
    native_thread.join()
    if "error" in native_build:
        failures.append(f"native IO library: {native_build['error']}")
    sass = sass_counts()
    emit({"phase": "env", "gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": time.perf_counter() - start,
          "build_s_by_kernel": build_s, "decoders": decoder_report(), "native_io": native_build,
          "sass_instructions": sass,
          "ptxas": {n: [line.split("ptxas info    : ")[-1].strip()
                        for line in build.ptxas_report(n).splitlines()
                        if "Used" in line or "spill" in line or "wgmma" in line]
                    for n in build.KERNELS}})
    for name in ("pe_block", "mha", "fused_stem", "conv3x3"):  # their bf16 routes run on wgmma
        if sass[name]["HGMMA"] < 1:
            failures.append(f"{name}: no HGMMA instruction in its library's SASS")
    if sass["qconv"]["IGMMA"] < 1:  # the int8 tensor cores, by wgmma (IMMA reported beside)
        failures.append("qconv: no IGMMA (s8 wgmma) instruction in its library's SASS")
    # the limits the wrappers check without a card, against the library's own
    limits = {str(dt).replace("torch.", ""): (kernels.PE_BLOCK_LIMITS[dt],
                                               kernels.pe_block_library_limits(dt))
              for dt in kernels.PE_BLOCK_LIMITS}
    emit({"phase": "pe_block_limits", "python_vs_library": limits})
    for dt, (stated, built) in limits.items():
        if tuple(stated) != tuple(built):
            failures.append(f"pe_block limits at {dt}: kernels.py says {stated}, "
                            f"the library {built}")
    limits = {str(dt).replace("torch.", ""): (kernels.CONV3X3_LIMITS[dt],
                                               kernels.conv3x3_library_limits(dt))
              for dt in kernels.CONV3X3_LIMITS}
    resident_max = (kernels.CONV3X3_RESIDENT_MAX_C_IN,
                    kernels._library("conv3x3").conv3x3_resident_max_c_in())
    emit({"phase": "conv3x3_limits", "python_vs_library": limits,
          "resident_max_c_in": resident_max})
    for dt, (stated, built) in limits.items():
        if tuple(stated) != tuple(built):
            failures.append(f"conv3x3 limits at {dt}: kernels.py says {stated}, "
                            f"the library {built}")
    if resident_max[0] != resident_max[1]:
        failures.append(f"conv3x3 resident route's largest C_in: kernels.py says "
                        f"{resident_max[0]}, the library {resident_max[1]}")
    resident_b = (kernels.QCONV_RESIDENT_B_BYTES,
                  kernels._library("qconv").qconv_resident_b_limit())
    emit({"phase": "qconv_limits", "resident_b_bytes": resident_b,
          "n_tiles": kernels.QCONV_N_TILES, "k_chunk": kernels.QCONV_K_CHUNK})
    if resident_b[0] != resident_b[1]:
        failures.append(f"qconv resident B bytes: kernels.py says {resident_b[0]}, "
                        f"the library {resident_b[1]}")

    mha_lib = kernels._library("mha")
    limits = (kernels.MHA_LIMITS,
              (mha_lib.mha_max_heads(), mha_lib.mha_max_seq(), mha_lib.mha_bf16_tile()))
    emit({"phase": "mha_limits", "python_vs_library": limits})
    if tuple(limits[0]) != tuple(limits[1]):
        failures.append(f"mha limits: kernels.py says {limits[0]}, the library {limits[1]}")

    limits = {"max_features": (kernels.CONSENSUS_MAX_FEATURES,
                               kernels._library("consensus_heads").consensus_heads_max_features()),
              "max_heads": (kernels.CONSENSUS_MAX_HEADS,
                            kernels._library("consensus_heads").consensus_heads_max_heads())}
    emit({"phase": "consensus_heads_limits", "python_vs_library": limits,
          "cluster": kernels._library("consensus_heads").consensus_heads_cluster()})
    for name, (stated, built) in limits.items():
        if stated != built:
            failures.append(f"consensus_heads {name}: kernels.py says {stated}, "
                            f"the library {built}")

    if "error" not in native_build:
        native_io_check(card, failures)
    check_wgmma(failures)
    main_case = check_kernels(failures)
    pool_records = check_max_pool(failures)
    for layout in ("nchw", "channels_last"):
        emit({"phase": "max_pool_step_pools", **pool_step_summary(
            pool_records, POOL_ROWS[0], "bfloat16", uniform_pool_calls(layout))})
    stem_records = check_fused_stem(failures)
    emit({"phase": "fused_stem_serve_forward",
          **stem_forward_summary(stem_records, SERVE_STEMS, "bfloat16")})
    # the two new kernels' main path is the evaluation path: its shapes
    main_case["fused_stem"] = stem_forward_summary(stem_records, TEST_STEMS, "bfloat16")
    consensus_records = check_consensus_heads(failures)
    main_case["consensus_heads"] = next(
        r for r in consensus_records if r["shape"] == [*CONSENSUS_SHAPES[-1], FUSION]
        and r["dtype"] == "bfloat16" and tuple(r["heads"]) == CLASS_HEADS)
    conv3x3_records = check_conv3x3(failures)
    main_case["conv3x3"] = next(  # the probe's default shape and type
        r for r in conv3x3_records if r["case"] == "probe" and r["dtype"] == "bfloat16")
    if args.quick:
        for failure in failures:
            print(f"FAILED: {failure}", file=sys.stderr)
        return 1 if failures else 0

    # the fused-block probe: conv3x3
    probe_launches = probe_path(card, failures)
    emit({"phase": "launches", "path": "probe", **probe_launches})

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
    timing = train_timing(state, train_cfg, card, failures)
    trained = {k: v.detach().clone() for k, v in state.model.state_dict().items()}
    del state
    torch.cuda.empty_cache()
    train_agreement(trained, failures)

    # the step's own pools, each in the layout the step handed the kernel
    pool_case = pool_step_summary(pool_records, POOL_ROWS[0], "bfloat16", timing["pool_calls"])
    emit({"phase": "max_pool_train_step", **pool_case})  # forward, and forward + backward
    # the kernels line: event timing of back-to-back calls, as for every
    # kernel there (the device times, from a CUDA graph, are in the line above)
    main_case["max_pool"] = pool_case

    # the training entry point: main in train mode, resume, reload, test mode
    # then the visualizer on its fixture and checkpoint (vis_path)
    trainer_launches = trainer_path(card, failures, then=vis_path)
    emit({"phase": "launches", "path": "trainer", **trainer_launches})

    # the serving export: bundles with the kernels as op nodes, served
    export_launches = export_path(card, failures)
    emit({"phase": "launches", "path": "export", **export_launches})

    # the ResNet and VGG towers: consensus_heads at F = 512 on each part
    for part, counts in arch_path(card, failures).items():
        emit({"phase": "launches", "path": f"arch/{part}", **counts})

    # the int8 towers: calibration, the int8 forward, quantize and qconv
    int8_launches, int8_line = int8_path(card, failures)
    emit({"phase": "launches", "path": "int8", **int8_launches})
    main_case.update(int8_line)

    # data parallelism: the flagship's steps, main's train and test modes
    # on R ranks under torchrun, against one process
    multi_rank_launches = multi_rank_path(card, failures)
    emit({"phase": "launches", "path": "multi_rank (rank 0)", **multi_rank_launches})
    # launches: the multi-rank path's rank 0, for the kernels it runs;
    # conv3x3 runs on the probe's path only, quantize and qconv on the int8
    # path only
    launches = {name: multi_rank_launches[name] for name in MULTI_RANK_KERNELS}
    launches["conv3x3"] = probe_launches["conv3x3"]
    launches.update({name: int8_launches[name] for name in ("quantize", "qconv")})
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": main_case[name]["max_abs_err"],
         "ms": main_case[name]["ms"], "plain_ms": main_case[name]["plain_ms"],
         "bound_ms": main_case[name]["bound_ms"], "bound_by": main_case[name]["bound_by"],
         "library_ms": main_case[name]["library_ms"],
         **({"routes": main_case[name]["routes"]} if "routes" in main_case[name] else {})}
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

"""Serving export: freeze the inference forward to a deployable bundle.

Port of the JAX package's ``tools/export.py``. It writes, into
``<out_dir>/export/`` (or ``out_dir``):

* ``module.pt2`` — the eval forward (BatchNorm folded into BN-Inception's
  convs, applied after ResNet's and VGG's; on-device spectrogram) at
  the main batch, captured by ``torch.export`` and saved with
  ``torch.export.save``; ``module.b<k>.pt2`` the same forward at each extra
  batch bucket. Each program takes the parameters as inputs (through
  ``torch.func.functional_call``) and holds none of them, as the JAX
  package keeps its parameters out of its modules. On the card the
  hand-written kernels are nodes of the program: their ``tbn::`` ops
  (``ops/kernels.py``);
* ``params.pt`` — the parameters once, as a state dict in the serving
  dtype, or with every quantized tensor as ``{"q": int8, "scale": fp32}``;
* ``manifest.json`` — input and output names, shapes and dtypes, each
  output's rows per sample (verified batch-invariant), the buckets, the
  serving dtype, the config fields that fix the preprocessing, and each
  program's SHA-256 and kernel ops.

``serving_dtype``: None for float32; ``"bfloat16"`` casts the kernels (the
conv and dense weights: the images of JAX ``kernel`` leaves,
``models/bridge.kernel_keys``) and keeps BatchNorm, biases and buffers in
float32 (the fold and the affine need ``rsqrt(var + eps)`` in float32);
``"int8"`` is weight-only symmetric per-output-channel quantization of the
same tensors, the dequantize part of the exported graph.

Usage::

    python -m attention_based_tbn_tpu_torch.tools.export [--device cpu] \\
        test.pre_trained=<ckpt> tpu.export_batch=10 tpu.export_buckets=[1] \\
        tpu.serving_dtype=bfloat16

or programmatically via :func:`export_inference`.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Dict, Mapping, Optional, Sequence

import torch
from torch.utils import _pytree as pytree

from ..models.bridge import kernel_keys
from ..models.builder import build_model
from ..utils.device import resolve_device
from .serve import input_specs

INT8_SCHEME = {
    "scheme": "weight-only symmetric per-output-channel",
    "bits": 8,
    "dequantize": "in-graph (module inputs are the int8 tree)",
}


def _is_quantized(value) -> bool:
    return isinstance(value, Mapping) and set(value) == {"q", "scale"}


def quantize_int8(state_dict: Mapping[str, torch.Tensor]) -> Dict:
    """Weight-only symmetric per-output-channel int8 quantization.

    Every float32 kernel tensor (``bridge.kernel_keys``: torch layout keeps
    the output channels on axis 0, where JAX's HWIO / (in, out) kernels
    keep them last) becomes ``{"q": int8, "scale": float32 (out, 1, ...)}``
    with ``scale = max|w| / 127`` per output channel (1.0 where the channel
    is all zero) and ``q = clip(round(w / scale), -127, 127)``, rounded half
    to even as JAX rounds. Everything else is returned unchanged."""
    quantized = kernel_keys(state_dict)
    out = {}
    for key, w in state_dict.items():
        if key in quantized and w.dtype == torch.float32 and w.dim() >= 2:
            amax = w.abs().amax(dim=tuple(range(1, w.dim())), keepdim=True)
            scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
            q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
            out[key] = {"q": q, "scale": scale}
        else:
            out[key] = w
    return out


def dequantize(qstate: Mapping) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`quantize_int8` up to rounding: the dense float32
    state dict, ``q * scale``. The int8 programs run it in their graph."""
    return {k: v["q"].float() * v["scale"] if _is_quantized(v) else v
            for k, v in qstate.items()}


def cast_kernels(state_dict: Mapping[str, torch.Tensor], dtype: torch.dtype) -> Dict:
    """The float32 kernel tensors cast to ``dtype``; the rest unchanged."""
    keys = kernel_keys(state_dict)
    return {k: v.to(dtype) if k in keys and v.dtype == torch.float32 else v
            for k, v in state_dict.items()}


class _Forward(torch.nn.Module):
    """(params, batch) -> the outputs in ``names`` order (set once the
    shape pass has named them): the eval forward of ``model`` with its
    parameters and persistent buffers taken from ``params`` (dequantized
    first when ``quantized``). The model is held as a plain attribute, not
    a submodule, so that an exported program captures none of its
    tensors."""

    def __init__(self, model, quantized: bool):
        super().__init__()
        object.__setattr__(self, "model", model)
        self.quantized = quantized
        self.names: tuple = ()

    def outputs(self, params, batch) -> Dict[str, torch.Tensor]:
        if self.quantized:
            params = dequantize(params)
        return torch.func.functional_call(self.model, params, (batch,))

    def forward(self, params, batch):
        out = self.outputs(params, batch)
        return tuple(out[name] for name in self.names)


def _example_batch(cfg, modality, batch_size: int, n_seg: int, device) -> Dict:
    """Zero inputs of the served shapes, in sorted name order."""
    return {name: torch.zeros(shape, dtype=getattr(torch, dtype.name), device=device)
            for name, (shape, dtype) in input_specs(cfg, modality, batch_size, n_seg).items()}


def _output_shapes(forward, params, batch) -> Dict[str, tuple]:
    """{output: shape} of ``forward(params, batch)``, a dict, by a
    shape-only pass on fake tensors (nothing is computed or compiled)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake_params, fake_batch = pytree.tree_map(mode.from_tensor, (params, batch))
        with torch.no_grad():
            out = forward(fake_params, fake_batch)
    return {name: tuple(v.shape) for name, v in sorted(out.items())}


def _output_row_multipliers(forward, params, cfg, modality: Sequence[str], batch_size: int,
                            n_seg: int, device) -> Dict[str, Optional[int]]:
    """Rows per sample of each output of ``forward`` (a dict of tensors),
    VERIFIED batch-invariant as the JAX package's
    ``_output_row_multipliers``: k only if the leading dim is ``k * b`` at
    the export batch b and at b + 1, both from shape-only passes; else None
    (served whole, never trimmed, and BatchingFront refuses to coalesce).
    Divisibility at b alone would call a global output of leading dim 1 per
    row at b = 1. Sorted by name: the programs' flat output order."""
    shapes, shapes_next = (
        _output_shapes(forward, params, _example_batch(cfg, modality, b, n_seg, device))
        for b in (batch_size, batch_size + 1))
    mults = {}
    for name, shape in shapes.items():
        shape1 = shapes_next[name]
        k = None
        if shape and shape1 and shape[0] % batch_size == 0:
            cand = shape[0] // batch_size
            if shape1[0] == cand * (batch_size + 1):
                k = int(cand)
        mults[name] = k
    return mults


def _kernel_ops(program) -> Dict[str, int]:
    """{op name: nodes} of the ``tbn::`` kernel ops in a program's graph."""
    counts: Dict[str, int] = {}
    for node in program.graph.nodes:
        if node.op == "call_function" and isinstance(node.target, torch._ops.OpOverload):
            name = node.target.name()
            if name.startswith("tbn::"):
                counts[name] = counts.get(name, 0) + 1
    return dict(sorted(counts.items()))


def _sha256(path: str) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def export_inference(cfg, modality: Sequence[str], state=None, out_dir: Optional[str] = None,
                     batch_size: int = 1, num_segments: Optional[int] = None,
                     serving_dtype: Optional[str] = None,
                     batch_buckets: Optional[Sequence[int]] = None, logger=None,
                     device="cuda") -> Dict[str, str]:
    """Export the inference forward and save the serving bundle; returns
    the paths of the manifest, the parameters and the main program.

    ``state``: a ``TrainState`` (``tools/test.load_state``), whose model is
    exported, or a state dict; None exports seeded weights
    (``data.manual_seed``). ``batch_buckets``: extra batch sizes in
    ``[1, batch_size)`` at which the same forward is exported
    (``module.b<k>.pt2``), so that a server runs a small request at a small
    batch. The export runs on ``device`` (default the card), under
    ``torch.no_grad()`` with the model in eval mode."""
    log = logger.info if logger else (lambda *_: None)
    device = resolve_device(device)
    buckets = sorted({int(b) for b in (batch_buckets or [])} - {batch_size})
    bad = [b for b in buckets if not 1 <= b < batch_size]
    if bad:
        raise ValueError(f"batch buckets {bad} must be in [1, batch_size={batch_size})")
    if serving_dtype not in (None, "float32", "bfloat16", "int8"):
        raise ValueError(f"serving_dtype {serving_dtype!r} not in float32, bfloat16, int8")
    serving_dtype = None if serving_dtype == "float32" else serving_dtype

    if hasattr(state, "model"):
        model = state.model
    else:
        model = build_model(cfg, modality, device)
        if state is not None:
            model.load_state_dict(state, strict=True)
    model.eval()
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    if serving_dtype == "int8":
        params = quantize_int8(weights)
    elif serving_dtype:
        params = cast_kernels(weights, getattr(torch, serving_dtype))
    else:
        params = weights
    quantized = serving_dtype == "int8"
    n_seg = int(num_segments or cfg.test.num_segments)

    forward = _Forward(model, quantized)
    mults = _output_row_multipliers(forward.outputs, params, cfg, modality, batch_size, n_seg,
                                    device)
    forward.names = tuple(mults)

    out_dir = out_dir or os.path.join(cfg.out_dir, "export")
    os.makedirs(out_dir, exist_ok=True)
    bucket_files, hashes, kernel_ops, seconds = {}, {}, {}, {}
    for b in [batch_size] + buckets:
        name = "module.pt2" if b == batch_size else f"module.b{b}.pt2"
        path = os.path.join(out_dir, name)
        batch = _example_batch(cfg, modality, b, n_seg, device)
        start = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(forward, (params, batch))
        # the program keeps its example inputs, the parameters among them,
        # and would save them beside the graph
        program.example_inputs = None
        torch.export.save(program, path)
        seconds[name] = time.perf_counter() - start
        bucket_files[str(b)] = name
        hashes[name] = _sha256(path)
        kernel_ops[name] = _kernel_ops(program)
        log(f"Exported batch {b} ({os.path.getsize(path) // 1024} KiB, kernel ops "
            f"{kernel_ops[name]}) -> {path}")

    params_path = os.path.join(out_dir, "params.pt")
    torch.save(pytree.tree_map(lambda t: t.cpu(), params), params_path)
    specs = input_specs(cfg, modality, batch_size, n_seg)
    manifest = {
        "modality": list(modality),
        "inputs": {k: {"shape": list(shape), "dtype": dtype.name}
                   for k, (shape, dtype) in specs.items()},
        "outputs": sorted(cfg.model.num_classes.keys()),
        "output_names": list(forward.names),
        "output_row_multipliers": mults,
        "param_leaf_count": len(pytree.tree_leaves(params)),
        "num_segments": n_seg,
        "batch_size": batch_size,
        "batch_buckets": bucket_files,
        "serving_dtype": serving_dtype or "float32",
        "quantization": dict(INT8_SCHEME) if quantized else None,
        "arch": cfg.model.arch,
        "attention": dict(enable=bool(cfg.model.attention.enable),
                          type=str(cfg.model.attention.type)),
        "audio": dict(sampling_rate=int(cfg.data.audio.sampling_rate),
                      audio_length=float(cfg.data.audio.audio_length),
                      spec_type=str(cfg.data.audio.spec_type)),
        # the float32 precision regime (TF32) is process state, not part of
        # a program: the server sets it from this, as the model does
        "compute_dtype": model.spec.compute_dtype,
        "kernel_ops": kernel_ops,
        "export_seconds": seconds,  # trace + save, host clock
        "program_sha256": hashes,
        "format": "torch.export",
        "torch_version": torch.__version__,
    }
    manifest_path = os.path.join(out_dir, "manifest.json")
    with open(manifest_path, "w") as fh:
        json.dump(manifest, fh, indent=2)
    return {"module": os.path.join(out_dir, "module.pt2"), "params": params_path,
            "manifest": manifest_path}


def main(argv=None):
    import argparse
    import logging

    from ..config import load_config
    from ..utils.misc import get_modality
    from ..utils.platform import cli_device, note_unused_keys
    from .test import load_state

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--device", default=None,
                        help="torch device (default: tpu.platform's, cuda unless it says cpu)")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(overrides=overrides)
    device = cli_device(cfg, args.device)
    modality = get_modality(cfg)
    logging.basicConfig(level=logging.INFO)
    logger = logging.getLogger("export")
    note_unused_keys(cfg, logger)
    state = load_state(cfg, logger, modality, device) if cfg.test.pre_trained else None
    buckets = cfg.get_path("tpu.export_buckets", None)
    paths = export_inference(
        cfg, modality, state=state,
        batch_size=int(cfg.get_path("tpu.export_batch", 1)),
        serving_dtype=str(cfg.get_path("tpu.serving_dtype", "") or "") or None,
        batch_buckets=list(buckets) if buckets else None,
        logger=logger, device=device)
    print(json.dumps(paths, indent=2))


if __name__ == "__main__":
    main()

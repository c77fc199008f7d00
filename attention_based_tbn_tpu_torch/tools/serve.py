"""Serve the TBN from the PyTorch port: model and weights resident on the
card, numpy in, numpy out.

The JAX package serves a compiled StableHLO bundle (its ``tools/serve.py``);
the port builds the model from the same config keys instead and takes an
optional weight file (a ``torch.save``d state dict in the reference layout;
without one, weights are drawn from ``data.manual_seed``). The request
contract is the JAX server's:

* ``predict`` takes a dict of numpy arrays in the JAX model's layouts —
  RGB (b, N, H, W, 3) uint8, Flow (b, N, H, W, 2*win) uint8, Audio
  (b, N, L) float32 (plus ``weights`` (b, N, W, 1) float32 for fixed-prior
  models) — and returns ``verb``, ``noun`` and, with learned attention,
  ``weights``, all float32;
* a request of any batch 1..max bucket routes to the smallest batch bucket
  that holds it; rows are padded with copies of the first sample and the
  outputs trimmed back per row;
* HTTP: ``POST /predict`` with an ``.npz`` body, ``GET /healthz``;
  client errors -> 400 (411 without a length, 413 over the size limit),
  device lock not acquired in time -> 503, any other failure -> 500.

Usage::

    python -m attention_based_tbn_tpu_torch.tools.serve --bench 30
    python -m attention_based_tbn_tpu_torch.tools.serve --weights tbn.pt --port 8080 \\
        tpu.export_buckets=[1,10]

Request micro-batching (the JAX package's ``BatchingFront``) and export
are not ported yet.
"""

from __future__ import annotations

import io
import json
import threading
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.builder import build_model
from ..utils.device import resolve_device
from ..utils.misc import get_modality


class DispatcherTimeout(RuntimeError):
    """The device lock was not acquired within the deadline -> 503, so
    clients know to retry later or elsewhere. (Client-input problems raise
    ValueError -> 4xx; any other failure is a server fault -> 500.)"""


class ServingModel:
    """The model on its device, serving numpy batches.

    ``predict`` serializes device execution with a lock (one card; a
    request that cannot take the lock within ``lock_timeout_s`` fails with
    :class:`DispatcherTimeout`). HTTP handler threads parse and respond
    concurrently."""

    def __init__(self, cfg, weights=None, device="cuda",
                 batch_buckets: Optional[Sequence[int]] = None,
                 lock_timeout_s: float = 30.0):
        self.device = resolve_device(device)
        self.modality = get_modality(cfg)
        self.model = build_model(cfg, self.modality, self.device)
        if weights is not None:
            state = weights
            if not isinstance(weights, dict):
                state = torch.load(weights, map_location=self.device, weights_only=True)
            self.model.load_state_dict(state, strict=True)
        self.spec = self.model.spec
        if batch_buckets is None:
            batch_buckets = [cfg.tpu.export_batch, *(cfg.tpu.export_buckets or [])]
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        if not self.batch_buckets or self.batch_buckets[0] < 1:
            raise ValueError(f"batch buckets must be positive, got {batch_buckets}")
        self.lock_timeout_s = float(lock_timeout_s)
        self.last_bucket: Optional[int] = None
        self._lock = threading.Lock()

        max_bs = self.batch_buckets[-1]
        n_seg = int(cfg.test.num_segments)
        crop = int(cfg.data.test_crop_size)
        specs = {}
        if "RGB" in self.modality:
            specs["RGB"] = ((max_bs, n_seg, crop, crop, 3), np.dtype(np.uint8))
        if "Flow" in self.modality:
            specs["Flow"] = ((max_bs, n_seg, crop, crop, 2 * self.spec.flow_win_length),
                             np.dtype(np.uint8))
        if "Audio" in self.modality:
            audio_len = int(cfg.data.audio.audio_length * cfg.data.audio.sampling_rate)
            specs["Audio"] = ((max_bs, n_seg, audio_len), np.dtype(np.float32))
            if self.spec.audio_attends and self.spec.use_fixed:
                specs["weights"] = ((max_bs, n_seg, self.spec.attn_win, 1),
                                    np.dtype(np.float32))
        self.input_specs = specs

    @property
    def platform(self) -> str:
        return self.device.type

    @property
    def output_names(self):
        names = [name for name, _ in self.spec.num_classes]
        return names + (["weights"] if self.spec.learned_attention else [])

    @property
    def max_request_bytes(self) -> int:
        """Largest request body a server accepts: 2x the full-bucket input
        payload (npz overhead, 64-bit clients) plus 1 MiB."""
        total = sum(int(np.prod(shape)) * dtype.itemsize
                    for shape, dtype in self.input_specs.values())
        return 2 * total + (1 << 20)

    def example_batch(self, batch_size: Optional[int] = None,
                      seed: int = 0) -> Dict[str, np.ndarray]:
        """Synthetic inputs of the served shapes (``--bench``, smoke tests)."""
        rng = np.random.default_rng(seed)
        batch = {}
        for name, (shape, dtype) in self.input_specs.items():
            shape = (batch_size or shape[0],) + shape[1:]
            if dtype == np.uint8:
                batch[name] = rng.integers(0, 255, shape).astype(np.uint8)
            else:
                batch[name] = (rng.standard_normal(shape) * 0.1).astype(dtype)
        return batch

    def _validate(self, batch: Dict[str, np.ndarray]):
        """Names, dtypes, shapes and one common batch size; ValueError on
        anything a client could get wrong. Returns (arrays, batch size)."""
        if set(batch) != set(self.input_specs):
            raise ValueError(f"inputs {sorted(batch)} != expected {sorted(self.input_specs)}")
        true_bs = None
        arrays = {}
        for name in sorted(batch):
            shape, dtype = self.input_specs[name]
            arr = np.asarray(batch[name])
            if arr.dtype != dtype or arr.ndim != len(shape) or arr.shape[1:] != shape[1:]:
                raise ValueError(
                    f"input {name!r}: got {arr.dtype}{list(arr.shape)}, "
                    f"served as {dtype}{['b', *shape[1:]]}"
                )
            if not 1 <= arr.shape[0] <= shape[0]:
                raise ValueError(
                    f"input {name!r}: batch {arr.shape[0]} outside [1, {shape[0]}]"
                )
            if true_bs is None:
                true_bs = arr.shape[0]
            elif arr.shape[0] != true_bs:
                raise ValueError(
                    f"input {name!r}: batch {arr.shape[0]} != {true_bs} of the other inputs"
                )
            arrays[name] = arr
        return arrays, true_bs

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        arrays, true_bs = self._validate(batch)
        bucket = min(b for b in self.batch_buckets if b >= true_bs)
        tensors = {}
        for name, arr in arrays.items():
            # only the true rows cross to the device; the pad rows are made there
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
            if true_bs < bucket:
                t = torch.cat([t, t[:1].expand((bucket - true_bs,) + t.shape[1:])])
            tensors[name] = t
        if not self._lock.acquire(timeout=self.lock_timeout_s):
            raise DispatcherTimeout(
                f"device busy: lock not acquired within {self.lock_timeout_s:.0f}s"
            )
        try:
            self.last_bucket = bucket
            with torch.no_grad():
                out = self.model(tensors)
                arrays_out = {k: v.float().cpu().numpy() for k, v in out.items()}
        finally:
            self._lock.release()
        # every output is per row: k rows per sample (1 for logits, N for
        # the attention weights over the folded batch)
        return {k: v[: (v.shape[0] // bucket) * true_bs] for k, v in arrays_out.items()}


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_server(model: ServingModel, port: int, host: str = ""):
    """stdlib HTTP server: POST /predict (.npz body) -> .npz response,
    GET /healthz -> JSON. ``port=0`` picks a free port
    (``server.server_address``)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/healthz":
                self._send(404, b"not found", "text/plain")
                return
            info = {
                "status": "ok",
                "platform": model.platform,
                "inputs": {k: {"shape": list(s), "dtype": str(d)}
                           for k, (s, d) in model.input_specs.items()},
                "outputs": model.output_names,
                "compute_dtype": model.spec.compute_dtype,
                "kernels": model.spec.use_pallas,
                "batch_buckets": list(model.batch_buckets),
                "max_request_bytes": model.max_request_bytes,
            }
            self._send(200, json.dumps(info).encode(), "application/json")

        def do_POST(self):
            if self.path != "/predict":
                self._send(404, b"not found", "text/plain")
                return
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                self._send(411, b"Content-Length required", "text/plain")
                return
            if length < 0 or length > model.max_request_bytes:
                # bound the request before reading the body
                self._send(413, f"request {length} bytes exceeds limit "
                                f"{model.max_request_bytes}".encode(), "text/plain")
                return
            body = self.rfile.read(length)
            try:
                with np.load(io.BytesIO(body), allow_pickle=False) as data:
                    batch = {k: data[k] for k in data.files}
            except Exception as exc:  # a malformed body is the client's fault
                self._send(400, f"invalid npz body: {exc}".encode(), "text/plain")
                return
            try:
                preds = model.predict(batch)
            except ValueError as exc:
                self._send(400, str(exc).encode(), "text/plain")
                return
            except DispatcherTimeout as exc:
                self._send(503, str(exc).encode(), "text/plain")
                return
            except Exception as exc:  # server-side fault: never a 4xx
                self._send(500, str(exc).encode(), "text/plain")
                return
            self._send(200, _npz_bytes(preds), "application/octet-stream")

    return ThreadingHTTPServer((host, port), Handler)


def bench(model: ServingModel, iters: int, batch_size: int) -> Dict:
    """Request latency of ``predict`` at one batch size, host clock around
    calls that end in a device-to-host copy (so the device work is done)."""
    batch = model.example_batch(batch_size)
    model.predict(batch)  # warm: allocator, cuDNN plans, kernel libraries
    times = []
    for _ in range(iters):
        start = time.perf_counter()
        model.predict(batch)
        times.append(time.perf_counter() - start)
    times.sort()
    return {
        "metric": "serve_latency_ms",
        "batch_size": batch_size,
        "p50": times[len(times) // 2] * 1e3,
        "p95": times[min(len(times) - 1, int(len(times) * 0.95))] * 1e3,
        "clips_per_sec": batch_size / (sum(times) / len(times)),
        "iters": iters,
        "platform": model.platform,
        "device": torch.cuda.get_device_name(model.device) if model.platform == "cuda" else "cpu",
        "compute_dtype": model.spec.compute_dtype,
        "kernels": model.spec.use_pallas,
    }


def main(argv=None):
    import argparse

    from ..config import load_config

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--weights", default=None, help="state-dict file (torch.save)")
    parser.add_argument("--device", default="cuda", help="torch device (default cuda)")
    parser.add_argument("--port", type=int, default=0, help="serve HTTP on this port")
    parser.add_argument("--bench", type=int, default=0,
                        help="latency iterations per batch bucket")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(overrides=overrides)
    model = ServingModel(cfg, args.weights, device=args.device)
    if args.bench:
        for bs in model.batch_buckets:
            print(json.dumps(bench(model, args.bench, bs)))
    if args.port:
        server = make_server(model, args.port)
        print(json.dumps({"serving": True, "port": args.port, "platform": model.platform}))
        try:
            server.serve_forever()
        finally:
            server.server_close()


if __name__ == "__main__":
    main()

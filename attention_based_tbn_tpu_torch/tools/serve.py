"""Serve the TBN from the PyTorch port: parameters resident on the card,
numpy in, numpy out.

Port of the JAX package's ``tools/serve.py``. Two servers keep one request
contract:

* :class:`ServingModel` builds the model from the config keys and takes an
  optional weight file (a ``torch.save``d state dict in the reference
  layout; without one, weights are drawn from ``data.manual_seed``);
* :class:`BundleModel` serves a bundle written by ``tools/export.py`` with
  no model code: each batch bucket's ``torch.export`` program, the
  parameters of ``params.pt`` loaded onto the card once and handed to the
  program as inputs, the manifest's names and row multipliers (the JAX
  package's module-direct ``ServingModel``).

The contract:

* ``predict`` takes a dict of numpy arrays in the JAX model's layouts —
  RGB (b, N, H, W, 3) uint8, Flow (b, N, H, W, 2*win) uint8, Audio
  (b, N, L) float32 (plus ``weights`` (b, N, W, 1) float32 for fixed-prior
  models) — and returns ``verb``, ``noun`` and, with learned attention,
  ``weights``, all float32;
* a request of any batch 1..max bucket routes to the smallest batch bucket
  that holds it; rows are padded with copies of the first sample and the
  outputs trimmed back by their rows per sample (1 for the logits, N for
  the attention weights over the folded batch);
* on a card, a request's arrays cross through page-locked host buffers
  on a copy stream of their own (:class:`PinnedStaging`), so one
  client's input copy overlaps another client's forward;
* :class:`BatchingFront` coalesces concurrent requests into one ``predict``
  within a window (``--batch-window``) and splits the outputs back;
* HTTP: ``POST /predict`` with an ``.npz`` body, ``GET /healthz``;
  client errors -> 400 (411 without a length, 413 over the size limit),
  no result in time (:class:`DispatcherTimeout`) -> 503, any other failure
  (:class:`ServerFault` among them) -> 500.

Usage::

    python -m attention_based_tbn_tpu_torch.tools.serve --bench 30
    python -m attention_based_tbn_tpu_torch.tools.serve --weights tbn.pt --port 8080 \\
        tpu.export_buckets=[1,10]
    python -m attention_based_tbn_tpu_torch.tools.serve <bundle_dir> --port 8080 \\
        --batch-window 2
"""

from __future__ import annotations

import collections
import io
import json
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..models.builder import build_model
from ..models.tbn import TBNSpec
from ..ops import kernels  # noqa: F401  (registers the tbn:: ops a bundle's programs call)
from ..utils.device import resolve_device, tf32_scope
from ..utils.misc import get_modality
from ..utils.spans import span


class ServerFault(RuntimeError):
    """Server-side failure (device execution, batching dispatcher, bundle
    mismatch) -> HTTP 5xx. Client-input problems raise ValueError -> 4xx;
    keeping the two apart means a request coalesced with a faulting
    group-mate gets a 500, never a 400 about someone else's request."""


class DispatcherTimeout(ServerFault):
    """No result within the deadline (the device lock not acquired, or the
    batching dispatcher silent) -> 503, so clients retry later or
    elsewhere."""


def input_specs(cfg, modality: Sequence[str], batch_size: int,
                num_segments: int) -> Dict[str, tuple]:
    """{input name: (shape at ``batch_size``, numpy dtype)} of the served
    forward, in sorted name order (the order of a program's inputs)."""
    spec = TBNSpec.from_config(cfg, modality)
    crop = int(cfg.data.test_crop_size)
    specs = {}
    if "RGB" in modality:
        specs["RGB"] = ((batch_size, num_segments, crop, crop, 3), np.dtype(np.uint8))
    if "Flow" in modality:
        specs["Flow"] = ((batch_size, num_segments, crop, crop, 2 * spec.flow_win_length),
                         np.dtype(np.uint8))
    if "Audio" in modality:
        audio_len = int(cfg.data.audio.audio_length * cfg.data.audio.sampling_rate)
        specs["Audio"] = ((batch_size, num_segments, audio_len), np.dtype(np.float32))
        if spec.audio_attends and spec.use_fixed:
            specs["weights"] = ((batch_size, num_segments, spec.attn_win, 1),
                                np.dtype(np.float32))
    return dict(sorted(specs.items()))


def _pad_rows(t: torch.Tensor, bucket: int) -> torch.Tensor:
    """``t`` with copies of its first row appended up to ``bucket`` rows."""
    if t.shape[0] == bucket:
        return t
    return torch.cat([t, t[:1].expand((bucket - t.shape[0],) + t.shape[1:])])


class PinnedStaging:
    """Request inputs staged on a card through page-locked host memory.

    A staging takes a set of pinned buffers (one an input, each at the
    largest bucket's shape) from a pool, copies the request's rows into
    them on the host, and issues their copies to the card on ``stream``:
    one of torch's pooled streams, which are non-blocking, so the copy
    neither waits for nor holds up the caller's stream, where another
    request's forward may be running. The device tensors are allocated on
    ``stream`` too: the caching allocator hands a stream a block only once
    that stream's own uses of it are done, and a block freed by a forward
    still running on the caller's stream is not done on it. The set goes
    back to the pool with the event of its copies; whoever takes it next
    waits for that event before writing into it.

    The pool grows only when every set is taken, i.e. to the number of
    requests staged at once, and ``counts`` gets ``pinned`` for each
    staging and ``pinned_alloc`` for each set allocated."""

    def __init__(self, input_specs: Dict[str, tuple], device: torch.device,
                 counts: collections.Counter):
        self._specs = input_specs
        self._device = device
        self._counts = counts
        self.stream = torch.cuda.Stream(device)
        self._free: "collections.deque" = collections.deque()  # (buffers, event), oldest first
        self._lock = threading.Lock()

    def _take(self):
        with self._lock:
            self._counts["pinned"] += 1
            if self._free:
                return self._free.popleft()
            self._counts["pinned_alloc"] += 1
        buffers = {name: torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                     pin_memory=True)
                   for name, (shape, dtype) in self._specs.items()}
        return buffers, None

    def stage(self, arrays: Dict[str, np.ndarray]):
        """The arrays' rows as tensors on the card and the event their
        copies record: the caller's stream waits on it before using them
        (:meth:`ready`)."""
        buffers, last_copy = self._take()
        if last_copy is not None:
            last_copy.synchronize()  # the set's last copy has left it (normally long since)
        tensors = {}
        with torch.cuda.stream(self.stream):
            for name, arr in arrays.items():
                host = buffers[name][: arr.shape[0]]
                host.copy_(torch.from_numpy(arr))
                tensors[name] = host.to(self._device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self.stream)
        with self._lock:
            self._free.append((buffers, copied))
        return tensors, copied

    def ready(self, tensors: Dict[str, torch.Tensor], copied) -> None:
        """Order the caller's stream after the copies, and keep each
        tensor's block from being reused before that stream is done with
        it."""
        stream = torch.cuda.current_stream(self._device)
        stream.wait_event(copied)
        for t in tensors.values():
            t.record_stream(stream)


class _Served:
    """The request contract both servers keep. A subclass sets ``device``,
    ``input_specs`` (shapes at the largest bucket), ``batch_buckets``,
    ``output_names``, ``_row_mult`` ({output: rows per sample, or None for
    an output that is not per row}), ``compute_dtype``, ``serving_dtype``,
    ``kernels`` and ``lock_timeout_s``, and runs a padded batch in
    ``_run``.

    ``predict`` serializes device execution with a lock (one card; a
    request that cannot take it within ``lock_timeout_s`` fails with
    :class:`DispatcherTimeout`). HTTP handler threads parse and respond
    concurrently. On a card a request stages its inputs before it waits
    for the lock (:class:`PinnedStaging`); ``staging`` counts the requests
    staged that way (``pinned``), the pinned buffer sets allocated
    (``pinned_alloc``) and the requests copied as they are (``plain``: the
    CPU)."""

    last_bucket: Optional[int] = None

    def _init_serving(self, lock_timeout_s: float) -> None:
        self.lock_timeout_s = float(lock_timeout_s)
        self._lock = threading.Lock()
        self.staging: collections.Counter = collections.Counter()
        self._pinned = (PinnedStaging(self.input_specs, self.device, self.staging)
                        if self.device.type == "cuda" else None)

    def _run(self, bucket: int, tensors: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    @property
    def platform(self) -> str:
        return self.device.type

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
        # under a profiler session each phase is a span (utils/spans.py);
        # the six children cover the request from end to end
        with span("serve.predict"):
            with span("serve.validate"):
                arrays, true_bs = self._validate(batch)
                bucket = min(b for b in self.batch_buckets if b >= true_bs)
            with span("serve.stage"):
                # only the true rows cross to the device; the pad rows are made there
                arrays = {name: np.ascontiguousarray(arr) for name, arr in arrays.items()}
                if self._pinned is None:
                    tensors = {name: _pad_rows(torch.from_numpy(arr).to(self.device), bucket)
                               for name, arr in arrays.items()}
                else:
                    tensors, copied = self._pinned.stage(arrays)
            with span("serve.lock_wait"):
                if not self._lock.acquire(timeout=self.lock_timeout_s):
                    raise DispatcherTimeout(
                        f"device busy: lock not acquired within {self.lock_timeout_s:.0f}s"
                    )
            try:
                self.last_bucket = bucket
                if self._pinned is None:
                    self.staging["plain"] += 1  # under the lock: handler threads predict at once
                with torch.no_grad():
                    with span("serve.forward"):
                        if self._pinned is not None:
                            # the forward's stream waits for the copies only now: before
                            # the lock, the wait would stall the other request's forward
                            self._pinned.ready(tensors, copied)
                            tensors = {name: _pad_rows(t, bucket) for name, t in tensors.items()}
                        out = self._run(bucket, tensors)
                    with span("serve.readback"):
                        arrays_out = {k: v.float().cpu().numpy() for k, v in out.items()}
            finally:
                self._lock.release()
            with span("serve.trim"):
                if true_bs == bucket:
                    return arrays_out
                # trim the pad rows: k rows per sample; an output that is not
                # per row (k None) is returned whole
                return {name: arr[: k * true_bs] if (k := self._row_mult.get(name)) else arr
                        for name, arr in arrays_out.items()}


class ServingModel(_Served):
    """The model built from the config on its device, serving numpy
    batches; ``weights`` is a state dict or a file of one."""

    serving_dtype = "float32"

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
        n_seg = int(cfg.test.num_segments)
        self.input_specs = input_specs(cfg, self.modality, self.batch_buckets[-1], n_seg)
        # rows per sample of each output: the logits one, the learned
        # attention's weights one per segment of the folded batch
        self._row_mult = {name: 1 for name, _ in self.spec.num_classes}
        if self.spec.learned_attention:
            self._row_mult["weights"] = n_seg
        self.compute_dtype = self.spec.compute_dtype
        self.kernels = self.spec.use_pallas
        self._init_serving(lock_timeout_s)

    @property
    def output_names(self) -> List[str]:
        return list(self._row_mult)

    def _run(self, bucket, tensors):
        return self.model(tensors)


class BundleModel(_Served):
    """An export bundle (``tools/export.py``) on its device: the parameters
    of ``params.pt`` moved there once and handed to each bucket's program
    as inputs; no model code runs. A request routes to the smallest bucket
    that holds it. Raises ValueError for a bundle whose files disagree with
    its manifest (parameter count, format), and :class:`ServerFault` when
    a program returns other outputs than the manifest names."""

    def __init__(self, bundle_dir: str, device="cuda", lock_timeout_s: float = 30.0):
        self.device = resolve_device(device)
        bundle_dir = os.path.abspath(bundle_dir)
        with open(os.path.join(bundle_dir, "manifest.json")) as fh:
            self.manifest = json.load(fh)
        if self.manifest.get("format") != "torch.export":
            raise ValueError(f"{bundle_dir}: not a torch.export bundle "
                             f"(format {self.manifest.get('format')!r})")
        self.params = torch.load(os.path.join(bundle_dir, "params.pt"),
                                 map_location=self.device, weights_only=True)
        count = len(pytree.tree_leaves(self.params))
        want = self.manifest["param_leaf_count"]
        if count != want:
            raise ValueError(f"bundle params have {count} leaves, the manifest says {want}: "
                             "params.pt and the programs disagree")
        self.input_specs = {k: (tuple(v["shape"]), np.dtype(v["dtype"]))
                            for k, v in sorted(self.manifest["inputs"].items())}
        self._programs = {
            int(b): torch.export.load(os.path.join(bundle_dir, name)).module()
            for b, name in self.manifest["batch_buckets"].items()
        }
        self.batch_buckets = tuple(sorted(self._programs))
        self.output_names = list(self.manifest["output_names"])
        self._row_mult = self.manifest["output_row_multipliers"]
        self.compute_dtype = self.manifest["compute_dtype"]
        self.serving_dtype = self.manifest["serving_dtype"]
        self.kernels = bool(self.manifest["kernel_ops"])
        self._init_serving(lock_timeout_s)

    def _run(self, bucket, tensors):
        with tf32_scope(self.compute_dtype):
            outs = self._programs[bucket](self.params, tensors)
        if len(outs) != len(self.output_names):
            # zip would drop outputs silently: a mixed-version bundle
            raise ServerFault(
                f"program returned {len(outs)} outputs but the manifest names "
                f"{len(self.output_names)}: {self.output_names}")
        return dict(zip(self.output_names, outs))


class BatchingFront:
    """Request micro-batching: concurrent requests coalesced into one
    device execution (the JAX package's ``BatchingFront``).

    Handler threads call :meth:`submit`, which validates on the caller's
    thread; one dispatcher thread drains the queue, concatenates requests
    up to the largest bucket's rows (waiting at most ``window_ms`` after
    the first arrives), runs ONE ``predict`` on the combined batch and
    splits the outputs back per request by the row multipliers. A request
    that would overflow the bucket is carried into the next cycle, so
    order is kept and nothing starves. A failure of the combined run is a
    :class:`ServerFault` for every member of the group.

    Coalescing needs every output declared per row: a model with a
    ``None`` multiplier (an output computed over the whole batch, i.e.
    over other clients' rows) is refused with ValueError. ``submit`` waits
    at most ``submit_timeout_s`` (then :class:`DispatcherTimeout`);
    ``close()`` stops the dispatcher and is idempotent."""

    _SHUTDOWN = object()

    def __init__(self, model: _Served, window_ms: float = 2.0, submit_timeout_s: float = 30.0):
        mults = getattr(model, "_row_mult", None)
        bad = (sorted(k for k, v in mults.items() if v is None) if mults
               else "no output_row_multipliers")
        if bad:
            raise ValueError(
                "model not coalescable: outputs without a per-row multiplier would leak "
                f"values across requests: {bad}. Serve without --batch-window.")
        self.model = model
        self.window = float(window_ms) / 1e3
        self.submit_timeout = float(submit_timeout_s)
        self.max_rows = model.batch_buckets[-1]
        self.group_sizes: collections.Counter = collections.Counter()  # requests per group
        self._queue: "queue.Queue" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def close(self, join_timeout_s: float = 5.0) -> None:
        """Stop the dispatcher thread; requests still in flight time out
        with DispatcherTimeout."""
        if self._closed:
            return
        self._closed = True
        self._queue.put(self._SHUTDOWN)
        self._thread.join(join_timeout_s)

    def submit(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        # a malformed request fails here (4xx) and never reaches the group
        arrays, true_bs = self.model._validate(batch)
        if self._closed:
            raise ServerFault("batching front is closed")
        item = {"arrays": arrays, "bs": true_bs, "event": threading.Event(),
                "result": None, "error": None}
        self._queue.put(item)
        if not item["event"].wait(self.submit_timeout):
            raise DispatcherTimeout(
                f"no result within {self.submit_timeout:.0f}s: dispatcher wedged or shut down")
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def _run(self) -> None:
        carry = None
        while True:
            first = carry if carry is not None else self._queue.get()
            carry = None
            if first is self._SHUTDOWN:
                return
            group, rows = [first], first["bs"]
            deadline = time.perf_counter() + self.window
            while rows < self.max_rows:
                timeout = deadline - time.perf_counter()
                if timeout <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=timeout)
                except queue.Empty:
                    break
                if nxt is self._SHUTDOWN:
                    self._dispatch(group)
                    return
                if rows + nxt["bs"] > self.max_rows:
                    carry = nxt  # next cycle; keeps the arrival order
                    break
                group.append(nxt)
                rows += nxt["bs"]
            self._dispatch(group)

    def _dispatch(self, group) -> None:
        self.group_sizes[len(group)] += 1
        try:
            combined = {name: np.concatenate([g["arrays"][name] for g in group])
                        for name in group[0]["arrays"]}
            preds = self.model.predict(combined)
        except Exception as exc:
            # every member was validated: a failure here is the server's
            fault = ServerFault(f"batched execution failed: {exc}")
            for g in group:
                g["error"] = fault
                g["event"].set()
            return
        offset = 0
        for g in group:
            out = {}
            for name, arr in preds.items():
                k = self.model._row_mult[name]  # none is None (__init__)
                out[name] = arr[k * offset:k * (offset + g["bs"])]
            g["result"] = out
            g["event"].set()
            offset += g["bs"]


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def make_server(model: _Served, port: int, host: str = "", batch_window_ms: float = 0.0):
    """stdlib HTTP server: POST /predict (.npz body) -> .npz response,
    GET /healthz -> JSON. ``port=0`` picks a free port
    (``server.server_address``). ``batch_window_ms > 0`` coalesces
    concurrent requests (:class:`BatchingFront`, ``server.batching_front``;
    ValueError for a model with an output that is not per row);
    ``server_close()`` also stops the front."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    front = BatchingFront(model, batch_window_ms) if batch_window_ms > 0 else None
    run = front.submit if front else model.predict

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
                "compute_dtype": model.compute_dtype,
                "serving_dtype": model.serving_dtype,
                "kernels": model.kernels,
                "batch_buckets": list(model.batch_buckets),
                "max_request_bytes": model.max_request_bytes,
                "batch_window_ms": batch_window_ms,
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
                preds = run(batch)
            except ValueError as exc:
                self._send(400, str(exc).encode(), "text/plain")
                return
            except DispatcherTimeout as exc:
                self._send(503, str(exc).encode(), "text/plain")
                return
            except Exception as exc:  # server-side fault (ServerFault among them): never a 4xx
                self._send(500, str(exc).encode(), "text/plain")
                return
            self._send(200, _npz_bytes(preds), "application/octet-stream")

    class Server(ThreadingHTTPServer):
        batching_front = front

        def server_close(self):
            if front is not None:
                front.close()
            super().server_close()

    return Server((host, port), Handler)


def bench(model: _Served, iters: int, batch_size: int) -> Dict:
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
        "compute_dtype": model.compute_dtype,
        "serving_dtype": model.serving_dtype,
        "kernels": model.kernels,
    }


def main(argv=None):
    import argparse
    import sys

    from ..config import load_config
    from ..utils.platform import cli_device, note_unused_keys

    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("bundle", nargs="?", default=None,
                        help="export bundle directory (tools/export.py); without it the "
                             "model is built from the config overrides")
    parser.add_argument("--weights", default=None, help="state-dict file (torch.save)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: tpu.platform's, cuda unless it says cpu)")
    parser.add_argument("--port", type=int, default=0, help="serve HTTP on this port")
    parser.add_argument("--bench", type=int, default=0,
                        help="latency iterations per batch bucket")
    parser.add_argument("--batch-window", type=float, default=0.0,
                        help="micro-batching window in ms (0 = off): concurrent requests "
                             "arriving within it share one device execution")
    argv = sys.argv[1:] if argv is None else list(argv)
    # config overrides (key=value) are not the positional bundle
    overrides = [a for a in argv if "=" in a and not a.startswith("-")]
    args = parser.parse_args([a for a in argv if a not in overrides])
    if args.bundle:
        if overrides or args.weights:
            parser.error("a bundle carries its weights and config: no --weights or overrides")
        model = BundleModel(args.bundle, device=args.device or "cuda")
    else:
        cfg = load_config(overrides=overrides)
        note_unused_keys(cfg)
        model = ServingModel(cfg, args.weights, device=cli_device(cfg, args.device))
    if args.bench:
        for bs in model.batch_buckets:
            print(json.dumps(bench(model, args.bench, bs)))
    if args.port:
        server = make_server(model, args.port, batch_window_ms=args.batch_window)
        print(json.dumps({"serving": args.bundle or "config", "port": args.port,
                          "platform": model.platform, "batch_window_ms": args.batch_window}))
        try:
            server.serve_forever()
        finally:
            server.server_close()


if __name__ == "__main__":
    main()

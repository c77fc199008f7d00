"""The port's serving entry point on the CPU: batch-bucket routing,
first-row padding and per-row trimming, input validation, weight files,
the HTTP contract (200 / 400 / 411 / 413 / 503) and the CLI — plus the
rule that a default-device entry point raises without a card, and the
TF32 regime a forward sets for itself and undoes.

Config: RGB + Audio, 64-px crops, 2 segments, 1.279 s audio, fp32.
Tolerance for padded-vs-alone rows: 1e-5 (eval BatchNorm makes rows
independent; only the batch size of the convolutions differs).
"""

import http.client
import io
import json
import threading

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.builder import build_model
from attention_based_tbn_tpu_torch.tools import serve
from attention_based_tbn_tpu_torch.tools.serve import DispatcherTimeout, ServingModel, make_server
from attention_based_tbn_tpu_torch.utils.device import resolve_device, tf32_scope
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    SMALL,
    one_torch_thread,
)

OVERRIDES = SMALL + ["data.flow.enable=false"]


@pytest.fixture(scope="module")
def model():
    return ServingModel(load_config(overrides=OVERRIDES), device="cpu", batch_buckets=(1, 4))


def test_buckets_pad_and_trim(model):
    assert model.input_specs["RGB"][0] == (4, 2, 64, 64, 3)
    assert model.input_specs["Audio"][0] == (4, 2, int(1.279 * 24000))
    batch = model.example_batch(3, seed=1)
    out = model.predict(batch)
    assert model.last_bucket == 4
    assert out["verb"].shape == (3, 125) and out["noun"].shape == (3, 352)
    assert out["weights"].shape == (6, 1, 8)
    assert all(v.dtype == np.float32 for v in out.values())
    for row in (0, 2):
        alone = model.predict({k: v[row : row + 1] for k, v in batch.items()})
        assert model.last_bucket == 1
        for key in out:
            rows = slice(row, row + 1) if key != "weights" else slice(2 * row, 2 * row + 2)
            np.testing.assert_allclose(out[key][rows], alone[key], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("change", ["missing", "extra", "dtype", "shape", "too_big", "ragged"])
def test_invalid_requests_raise_value_error(model, change):
    batch = model.example_batch(2)
    if change == "missing":
        del batch["Audio"]
    elif change == "extra":
        batch["Flow"] = batch["RGB"]
    elif change == "dtype":
        batch["RGB"] = batch["RGB"].astype(np.float32)
    elif change == "shape":
        batch["RGB"] = batch["RGB"][:, :, :32]
    elif change == "too_big":
        batch = model.example_batch(5)
    else:
        batch["Audio"] = batch["Audio"][:1]
    with pytest.raises(ValueError):
        model.predict(batch)


def test_weight_file_loads(model, tmp_path):
    path = tmp_path / "tbn.pt"
    torch.save(model.model.state_dict(), path)
    other = ServingModel(load_config(overrides=OVERRIDES + ["data.manual_seed=7"]),
                         weights=str(path), device="cpu", batch_buckets=(2,))
    batch = model.example_batch(2, seed=2)
    want, got = model.predict(batch), other.predict(batch)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)


def _request(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _npz(arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def test_http_contract(model):
    server = make_server(model, 0, host="127.0.0.1")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        code, body = _request(port, "GET", "/healthz")
        info = json.loads(body)
        assert code == 200 and info["status"] == "ok" and info["batch_buckets"] == [1, 4]
        assert info["outputs"] == ["verb", "noun", "weights"]

        code, body = _request(port, "POST", "/predict", _npz(model.example_batch(2)))
        assert code == 200
        out = dict(np.load(io.BytesIO(body)))
        assert out["verb"].shape == (2, 125) and out["weights"].shape == (4, 1, 8)

        bad = model.example_batch(1)
        bad["Audio"] = bad["Audio"].astype(np.float64)
        assert _request(port, "POST", "/predict", _npz(bad))[0] == 400
        bad = model.example_batch(1)
        bad["RGB"] = bad["RGB"][:, :1]  # one segment instead of two
        assert _request(port, "POST", "/predict", _npz(bad))[0] == 400
        assert _request(port, "POST", "/predict", b"not an npz")[0] == 400
        assert _request(port, "GET", "/nope")[0] == 404

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/predict")
        conn.putheader("Content-Length", str(model.max_request_bytes + 1))
        conn.endheaders()
        assert conn.getresponse().status == 413  # refused before the body is read
        conn.close()
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.putrequest("POST", "/predict")
        conn.endheaders()
        assert conn.getresponse().status == 411
        conn.close()

        # device lock held elsewhere -> 503, not a 4xx or a hang
        model.lock_timeout_s = 0.05
        with model._lock:
            assert _request(port, "POST", "/predict", _npz(model.example_batch(1)))[0] == 503
            with pytest.raises(DispatcherTimeout):
                model.predict(model.example_batch(1))
    finally:
        model.lock_timeout_s = 30.0
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_cli_bench_on_cpu(capsys):
    serve.main(["--device", "cpu", "--bench", "1", *OVERRIDES, "tpu.export_buckets=[2]"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["batch_size"] for line in lines] == [1, 2]
    assert all(line["platform"] == "cpu" and line["p50"] > 0 for line in lines)


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid here")
    cfg = load_config(overrides=OVERRIDES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg, ["RGB", "Audio"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingModel(cfg)


def _tf32_flags():
    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


@pytest.mark.parametrize("compute_dtype,inside", [("float32", False), ("bfloat16", True)])
def test_tf32_scope_sets_and_restores(compute_dtype, inside):
    saved = _tf32_flags()
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = not inside
        with tf32_scope(compute_dtype):
            assert _tf32_flags() == (inside, inside)
        assert _tf32_flags() == (not inside, not inside)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_forward_leaves_the_process_tf32_flags_alone(model):
    """A float32 model runs with TF32 off and hands the flags back as it
    found them, so models of other dtypes in one process do not interfere."""
    saved = _tf32_flags()
    seen = []
    hook = model.model.classifier.register_forward_pre_hook(
        lambda mod, args: seen.append(_tf32_flags()))
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        model.predict(model.example_batch(1))
        assert seen == [(False, False)]
        assert _tf32_flags() == (True, True)
    finally:
        hook.remove()
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

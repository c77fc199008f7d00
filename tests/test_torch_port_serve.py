"""The port's serving entry point on the CPU: batch-bucket routing,
first-row padding and per-row trimming, input validation, weight files,
the HTTP contract (200 / 400 / 411 / 413 / 503) and the CLI — plus the
rule that a default-device entry point raises without a card, the TF32
regime a forward sets for itself and undoes, and the CPU's input staging
(copied as it is, bit for bit the arrays-as-tensors path).

On a card (``cuda`` marker): the staging through pinned buffers on a copy
stream against the plain ``.to(device)`` path, bit for bit, alone and
with two threads at once; the pinned buffer sets stop growing after
warm-up; a bundle served that way matches the eager model. The file
imports no JAX, so it runs on the card's machine too:

    python -m pytest --noconftest tests/test_torch_port_serve.py -q

Config: RGB + Audio, 64-px crops, 2 segments, 1.279 s audio, fp32.
Tolerance for padded-vs-alone rows: 1e-5 (eval BatchNorm makes rows
independent; only the batch size of the convolutions differs).
"""

import collections
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

# torch_port_helpers.SMALL (that module imports JAX): 64-px crops, 2
# segments, 1.279 s audio, fp32; RGB + Audio
OVERRIDES = ["data.audio.audio_length=1.279", "tpu.compute_dtype=float32",
             "data.test_crop_size=64", "test.num_segments=2", "data.flow.enable=false"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread, as torch_port_helpers.one_torch_thread: the
    suite's xdist workers share a few cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


# ------------------------------------------------------------- input staging


def _plain_predict(served, batch):
    """``predict`` by the path it had before input staging: each array as
    a tensor moved with ``.to(device)``, the pad rows copies of the first,
    the forward, then the outputs read back and trimmed."""
    rows = next(iter(batch.values())).shape[0]
    bucket = min(b for b in served.batch_buckets if b >= rows)
    tensors = {}
    for name, arr in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(served.device)
        tensors[name] = torch.cat([t, t[:1].expand((bucket - rows,) + t.shape[1:])])
    with torch.no_grad():
        out = served._run(bucket, tensors)
    return {k: v.float().cpu().numpy()[: served._row_mult[k] * rows] for k, v in out.items()}


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("rows", [4, 3], ids=["full", "padded"])
def test_cpu_requests_are_copied_as_they_are(model, rows):
    """On the CPU no pinned buffer is made: each request counts as
    ``plain`` and its outputs equal the arrays-as-tensors path bit for bit."""
    batch = model.example_batch(rows, seed=11)
    before = collections.Counter(model.staging)
    got = model.predict(batch)
    assert model._pinned is None
    assert model.staging - before == collections.Counter(plain=1)
    assert model.staging["pinned"] == model.staging["pinned_alloc"] == 0
    _assert_same(got, _plain_predict(model, batch))


@pytest.fixture(scope="module")
def card_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging's pinned path runs on a card")
    return ServingModel(load_config(overrides=OVERRIDES), device="cuda", batch_buckets=(1, 4))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [4, 3], ids=["full", "padded"])
def test_pinned_staging_matches_the_plain_copy(card_model, rows):
    batch = card_model.example_batch(rows, seed=12)
    before = collections.Counter(card_model.staging)
    got = card_model.predict(batch)
    assert card_model.staging["pinned"] - before["pinned"] == 1
    assert card_model.staging["plain"] == 0
    _assert_same(got, _plain_predict(card_model, batch))


@pytest.mark.cuda
def test_two_threads_at_once_match_serial_calls(card_model):
    """Each thread's request stages on the copy stream while the other's
    forward runs; every answer equals the same request served alone."""
    batches = [card_model.example_batch(4, seed=20 + i) for i in range(6)]
    want = [card_model.predict(b) for b in batches]
    got, errors = [None] * len(batches), []

    def client(k):
        try:
            for i in range(k, len(batches), 2):
                got[i] = card_model.predict(batches[i])
        except Exception as exc:  # reported below, on the test's thread
            errors.append(exc)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert card_model.staging["pinned_alloc"] <= 2  # never more sets than requests at once


@pytest.mark.cuda
def test_pinned_sets_stop_growing_after_warm_up(card_model):
    batch = card_model.example_batch(3, seed=30)
    card_model.predict(batch)  # warm-up
    before = collections.Counter(card_model.staging)
    for _ in range(20):
        card_model.predict(batch)
    assert card_model.staging["pinned"] - before["pinned"] == 20
    assert card_model.staging["pinned_alloc"] == before["pinned_alloc"] >= 1


@pytest.mark.cuda
def test_bundle_served_through_pinned_staging_matches_eager(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the staging's pinned path runs on a card")
    from attention_based_tbn_tpu_torch.tools.export import export_inference

    cfg = load_config(overrides=OVERRIDES)
    eager = ServingModel(cfg, device="cuda", batch_buckets=(2,))
    export_inference(cfg, eager.modality, state=eager.model.state_dict(),
                     out_dir=str(tmp_path), batch_size=2, device="cuda")
    bundle = serve.BundleModel(str(tmp_path), device="cuda")
    batch = bundle.example_batch(seed=31)
    want, got = eager.predict(batch), bundle.predict(batch)
    assert bundle.staging["pinned"] == 1 and bundle.staging["plain"] == 0
    for key in want:
        err = np.sqrt(np.mean((got[key] - want[key]) ** 2) / np.mean(want[key] ** 2))
        assert err <= 1e-5, (key, err)

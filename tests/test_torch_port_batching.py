"""The port's bundle server and request micro-batching on the CPU
(tools/serve.BundleModel, BatchingFront, make_server): the JAX package's
tests/test_serve.py bundle and BatchingFront cases, on a bundle written by
the port's tools/export.py.

Bundle: RGB + Audio, PE + MHA, 64-px crops, 2 segments, 1.279 s audio,
fp32, exported at batch 2 with a bucket of 1. Replies through the front
must equal lone predicts exactly: eval BatchNorm makes rows independent
and every request runs the same program at the same bucket.
"""

import copy
import http.client
import io
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.tools.export import export_inference
from attention_based_tbn_tpu_torch.tools.serve import (
    BatchingFront,
    BundleModel,
    DispatcherTimeout,
    ServerFault,
    ServingModel,
    _npz_bytes,
    make_server,
)
from attention_based_tbn_tpu_torch.utils.misc import get_modality
from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    SMALL,
    one_torch_thread,
)

OVERRIDES = SMALL + ["data.flow.enable=false", "model.attention.type=mha"]


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("bundle"))
    cfg = load_config(overrides=OVERRIDES)
    export_inference(cfg, get_modality(cfg), out_dir=out, batch_size=2, batch_buckets=[1],
                     device="cpu")
    return out


@pytest.fixture(scope="module")
def loaded(bundle_dir):
    return BundleModel(bundle_dir, device="cpu")


@pytest.fixture()
def sm(loaded):
    """The loaded bundle, its programs and parameters shared: a test may
    reassign any attribute of its copy (buckets, names, ``predict``)."""
    return copy.copy(loaded)


def _rows(model, seed, b=1):
    return model.example_batch(b, seed=seed)


def _assert_equal(got, want):
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def _item(model, batch):
    arrays, bs = model._validate(batch)
    return {"arrays": arrays, "bs": bs, "event": threading.Event(), "result": None,
            "error": None}


# ------------------------------------------------------------ bundle server


def test_bundle_matches_the_config_built_model(sm):
    """The bundle was exported from the config's seeded weights: the config-
    built ServingModel on the same config gives the same outputs, and its
    row multipliers (from its spec) equal the manifest's verified ones."""
    eager = ServingModel(load_config(overrides=OVERRIDES), device="cpu", batch_buckets=(1, 2))
    batch = sm.example_batch(seed=11)
    _assert_equal(sm.predict(batch), eager.predict(batch))
    assert sm.output_names == ["noun", "verb", "weights"]
    assert eager._row_mult == sm.manifest["output_row_multipliers"] == {
        "noun": 1, "verb": 1, "weights": 2}


def test_bundle_validates_inputs(sm):
    batch = sm.example_batch()
    with pytest.raises(ValueError, match="served as"):
        sm.predict({**batch, "RGB": batch["RGB"][:, :, :32]})  # wrong spatial shape
    with pytest.raises(ValueError, match="served as"):
        sm.predict({**batch, "RGB": batch["RGB"].astype(np.float32)})  # wrong dtype
    with pytest.raises(ValueError, match="expected"):
        sm.predict({"Flow": batch["RGB"]})
    with pytest.raises(ValueError, match="outside"):
        sm.predict(sm.example_batch(3))  # above the largest bucket
    with pytest.raises(ValueError, match="other inputs"):
        sm.predict({**batch, "Audio": batch["Audio"][:1]})


def test_bundle_rejects_output_count_mismatch(sm):
    """A manifest naming more outputs than the program returns raises a
    ServerFault (a 500), never a truncated reply."""
    sm.output_names = sm.output_names + ["ghost_head"]
    with pytest.raises(ServerFault, match="manifest"):
        sm.predict(sm.example_batch())


def test_bundle_rejects_param_count_mismatch(bundle_dir, tmp_path):
    for name in os.listdir(bundle_dir):
        os.symlink(os.path.join(bundle_dir, name), tmp_path / name)
    manifest = json.load(open(os.path.join(bundle_dir, "manifest.json")))
    manifest["param_leaf_count"] += 1
    os.unlink(tmp_path / "manifest.json")
    json.dump(manifest, open(tmp_path / "manifest.json", "w"))
    with pytest.raises(ValueError, match="leaves"):
        BundleModel(str(tmp_path), device="cpu")
    manifest["format"] = "stablehlo"
    json.dump(manifest, open(tmp_path / "manifest.json", "w"))
    with pytest.raises(ValueError, match="torch.export"):
        BundleModel(str(tmp_path), device="cpu")


def test_batch_buckets_route_and_match(sm):
    """A b=1 request runs the b=1 program and returns the row the b=2
    program computes for it."""
    assert sm.batch_buckets == (1, 2)
    assert sm.manifest["batch_buckets"] == {"2": "module.pt2", "1": "module.b1.pt2"}
    full = sm.example_batch(seed=13)
    want = sm.predict(full)
    assert sm.last_bucket == 2
    one = sm.predict({k: v[:1] for k, v in full.items()})
    assert sm.last_bucket == 1
    for head in ("verb", "noun"):
        np.testing.assert_allclose(one[head], want[head][:1], rtol=1e-5, atol=1e-6,
                                   err_msg=head)


def test_ragged_batch_trims_folded_weights(sm):
    """A ragged request padded to the bucket keeps true_bs * N rows of the
    folded attention weights, by the manifest's row multipliers."""
    sm._programs = {2: sm._programs[2]}  # no b=1 program: b=1 pads to 2
    sm.batch_buckets = (2,)
    assert sm._row_mult == {"noun": 1, "verb": 1, "weights": 2}
    full = sm.example_batch(seed=9)
    want = sm.predict(full)
    got = sm.predict({k: v[:1] for k, v in full.items()})
    assert got["verb"].shape == (1, 125) and got["weights"].shape == (2, 1, 8)
    for name in ("verb", "noun", "weights"):
        np.testing.assert_allclose(got[name], want[name][: got[name].shape[0]], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_cli_serves_a_bundle(bundle_dir, capsys):
    from attention_based_tbn_tpu_torch.tools import serve

    serve.main([bundle_dir, "--device", "cpu", "--bench", "1"])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [line["batch_size"] for line in lines] == [1, 2]
    assert all(line["serving_dtype"] == "float32" and line["p50"] > 0 for line in lines)
    with pytest.raises(SystemExit):
        serve.main([bundle_dir, "--device", "cpu", "data.test_crop_size=64"])


# ------------------------------------------------------------ BatchingFront


def test_single_request_passes_through(sm):
    front = BatchingFront(sm, window_ms=1.0)
    try:
        batch = _rows(sm, 2)
        _assert_equal(front.submit(batch), sm.predict(batch))
    finally:
        front.close()


def test_concurrent_requests_coalesce_and_match(sm):
    """Four concurrent b=1 requests (largest bucket 2): every client gets
    exactly its lone predict, and at least one group held two requests."""
    front = BatchingFront(sm, window_ms=200.0)
    batches = [_rows(sm, s) for s in range(4)]
    sm._programs = {2: sm._programs[2]}  # lone and grouped requests share one program
    sm.batch_buckets = (2,)
    want = [sm.predict(b) for b in batches]
    results, errors = [None] * 4, []
    barrier = threading.Barrier(4)

    def worker(i):
        barrier.wait()
        try:
            results[i] = front.submit(batches[i])
        except Exception as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    front.close()
    assert not errors
    for got, exp in zip(results, want):
        _assert_equal(got, exp)
    assert sum(front.group_sizes.values()) < 4 and front.group_sizes[2] >= 1


def test_many_clients_stress(sm):
    """Sixteen clients (more than the cores) of two requests each, with the
    interpreter switching threads every 10 us: every reply is its own lone
    predict, and the groups served hold every request once (a lost or
    doubled request breaks the count)."""
    sm._programs = {2: sm._programs[2]}
    sm.batch_buckets = (2,)
    clients, per_client = 16, 2
    batches = [_rows(sm, s % 4) for s in range(clients * per_client)]
    want = [sm.predict(b) for b in batches[:4]]
    front = BatchingFront(sm, window_ms=2.0)
    results, errors = {}, []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def client(c):
            for i in range(c * per_client, (c + 1) * per_client):
                try:
                    results[i] = front.submit(batches[i])
                except Exception as exc:  # reported below
                    errors.append(exc)

        threads = [threading.Thread(target=client, args=(c,)) for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
        front.close()
    assert not errors and len(results) == clients * per_client
    for i, got in results.items():
        _assert_equal(got, want[i % 4])
    assert sum(size * n for size, n in front.group_sizes.items()) == clients * per_client


def test_mixed_sizes_split_correctly(sm):
    """The splitting math on a hand-built group: b=1 then b=1 (the second
    at offset 1, its weights at rows 2..3), each against its lone predict."""
    front = BatchingFront(sm, window_ms=1.0)
    try:
        sm._programs = {2: sm._programs[2]}
        sm.batch_buckets = (2,)
        batches = [_rows(sm, s) for s in (21, 22)]
        reqs = [_item(sm, b) for b in batches]
        front._dispatch(reqs)
        for req, batch in zip(reqs, batches):
            assert req["event"].is_set() and req["error"] is None
            _assert_equal(req["result"], sm.predict(batch))
    finally:
        front.close()


def test_overflow_carries_to_next_cycle(sm):
    """A b=2 request arriving while a b=1 group is open overflows the
    bucket (2) and is carried into the next cycle; both clients get their
    lone answers."""
    front = BatchingFront(sm, window_ms=300.0)
    small, big = _rows(sm, 31), _rows(sm, 32, b=2)
    want_small, want_big = sm.predict(small), sm.predict(big)
    results = {}

    def run(name, batch):
        results[name] = front.submit(batch)

    t1 = threading.Thread(target=run, args=("small", small))
    t2 = threading.Thread(target=run, args=("big", big))
    t1.start()
    time.sleep(0.05)  # inside the open window
    t2.start()
    t1.join(timeout=120)
    t2.join(timeout=120)
    front.close()
    _assert_equal(results["small"], want_small)
    _assert_equal(results["big"], want_big)
    assert front.group_sizes == {1: 2}


def test_malformed_request_fails_only_itself(sm):
    front = BatchingFront(sm, window_ms=1.0)
    try:
        good = _rows(sm, 5)
        with pytest.raises(ValueError, match="expected"):
            front.submit({"Bogus": np.zeros((1, 2))})
        _assert_equal(front.submit(good), sm.predict(good))  # the dispatcher lives on
    finally:
        front.close()


def test_close_stops_dispatcher_and_is_idempotent(sm):
    front = BatchingFront(sm, window_ms=1.0)
    assert front._thread.is_alive()
    front.close()
    front._thread.join(timeout=10)
    assert not front._thread.is_alive()
    front.close()  # idempotent
    with pytest.raises(ServerFault, match="closed"):
        front.submit(_rows(sm, 1))


def test_submit_timeout_raises_dispatcher_timeout(sm):
    front = BatchingFront(sm, window_ms=1.0, submit_timeout_s=0.3)
    release = threading.Event()
    orig = sm.predict

    def wedged(batch):
        release.wait(20)  # a stuck device call
        return orig(batch)

    sm.predict = wedged
    try:
        with pytest.raises(DispatcherTimeout, match="within"):
            front.submit(_rows(sm, 2))
    finally:
        release.set()
        sm.predict = orig
        front.close()


def test_refuses_model_with_null_multiplier(sm):
    mults = dict(sm._row_mult)
    sm._row_mult = {**mults, "noun": None}
    with pytest.raises(ValueError, match="coalescable"):
        BatchingFront(sm, window_ms=1.0)
    sm._row_mult = None  # no multipliers declared at all
    with pytest.raises(ValueError, match="coalescable"):
        BatchingFront(sm, window_ms=1.0)
    sm._row_mult = {**mults, "weights": None}
    with pytest.raises(ValueError, match="coalescable"):
        make_server(sm, 0, host="127.0.0.1", batch_window_ms=5.0)


def test_group_fault_is_server_fault_not_value_error(sm):
    """A failure of a coalesced group's run reaches every member as a
    ServerFault (a 5xx), never as a client error."""
    front = BatchingFront(sm, window_ms=1.0)

    def boom(batch):
        raise RuntimeError("device fell over")

    try:
        reqs = [_item(sm, _rows(sm, s)) for s in (41, 42)]
        sm.predict = boom
        front._dispatch(reqs)
        for req in reqs:
            assert req["event"].is_set()
            assert isinstance(req["error"], ServerFault)
            assert not isinstance(req["error"], ValueError)
            assert "device fell over" in str(req["error"])
    finally:
        del sm.predict
        front.close()


# -------------------------------------------------------------------- HTTP


def _request(port, method, path, body=b""):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def test_http_server_fault_maps_to_500(sm):
    def boom(batch):
        raise RuntimeError("internal execution failure")

    sm.predict = boom  # before make_server: the handler binds model.predict
    server = make_server(sm, 0, host="127.0.0.1")
    thread = _serve(server)
    try:
        code, body = _request(server.server_address[1], "POST", "/predict",
                              _npz_bytes(sm.example_batch(seed=3)))
        assert code == 500 and b"internal execution failure" in body
    finally:
        del sm.predict
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_http_micro_batched_round_trip(sm):
    """--batch-window: concurrent clients all get their lone answers
    through the coalescing path; /healthz reports the window and the
    bundle's serving dtype."""
    sm._programs = {2: sm._programs[2]}
    sm.batch_buckets = (2,)
    server = make_server(sm, 0, host="127.0.0.1", batch_window_ms=100.0)
    thread = _serve(server)
    port = server.server_address[1]
    try:
        code, body = _request(port, "GET", "/healthz")
        info = json.loads(body)
        assert code == 200 and info["batch_window_ms"] == 100.0
        assert info["serving_dtype"] == "float32" and info["batch_buckets"] == [2]
        batches = [_rows(sm, s) for s in range(3)]
        want = [sm.predict(b) for b in batches]
        results = [None] * 3

        def post(i):
            status, reply = _request(port, "POST", "/predict", _npz_bytes(batches[i]))
            assert status == 200
            with np.load(io.BytesIO(reply)) as data:
                results[i] = {k: data[k] for k in data.files}

        threads = [threading.Thread(target=post, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        for got, exp in zip(results, want):
            _assert_equal(got, exp)
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def test_server_close_stops_batching_front(sm):
    server = make_server(sm, 0, host="127.0.0.1", batch_window_ms=5.0)
    front = server.batching_front
    assert front is not None and front._thread.is_alive()
    server.server_close()
    front._thread.join(timeout=10)
    assert not front._thread.is_alive()


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
def test_export_and_serve_on_the_card(tmp_path):
    """On the card: the bf16 flagship flags at 64 px exported with the
    kernels as op nodes, served, equal to the eager model on the bundle's
    weights within rel-RMSE 1e-3, and the kernels launched by the bundle."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from attention_based_tbn_tpu_torch.ops import kernels
    from attention_based_tbn_tpu_torch.tools.export import _kernel_ops

    over = ["data.audio.audio_length=1.279", "data.test_crop_size=64", "test.num_segments=2",
            "tpu.compute_dtype=bfloat16", "tpu.fused_stem=true", "tpu.fast_consensus=true",
            "tpu.pool_impl=pallas"]
    cfg = load_config(overrides=over)
    export_inference(cfg, get_modality(cfg), out_dir=str(tmp_path), batch_size=2,
                     serving_dtype="bfloat16", device="cuda")
    bundle = BundleModel(str(tmp_path), device="cuda")
    ops = _kernel_ops(bundle._programs[2])
    for op in ("tbn::pe_block_bf16", "tbn::mha", "tbn::fused_stem", "tbn::consensus_heads",
               "tbn::max_pool"):
        assert ops.get(op), (op, ops)
    weights = {k: v.float() if v.dtype == torch.bfloat16 else v
               for k, v in torch.load(tmp_path / "params.pt", weights_only=True).items()}
    eager = ServingModel(cfg, weights, device="cuda", batch_buckets=(2,))
    batch = bundle.example_batch(seed=3)
    want = eager.predict(batch)
    kernels.reset_launch_counts()
    got = bundle.predict(batch)
    for name in ("pe_block", "mha", "fused_stem", "consensus_heads", "max_pool"):
        assert kernels.WRAPPERS[name].launches >= 1, name
    for key in want:
        err = np.sqrt(np.mean((got[key] - want[key]) ** 2) / np.mean(want[key] ** 2))
        assert err <= 1e-3, (key, err)

#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the hand-written kernels from ``attention_based_tbn_tpu_torch/ops/csrc``,
holds each against its plain PyTorch version at the flagship shapes, then
serves the flagship model (tri-modal BN-Inception, 224x224 crops,
25 segments, 2.1 s audio, MHA attention, bf16, kernels on) with seeded
weights through ``tools/serve.ServingModel``: requests of batch 1, 3 (in
the 10 bucket) and 10 through ``predict``, and one HTTP POST. The served
logits are checked against the same weights run in float32 with the
kernels off, and the kernels' launch counts against the served requests.

One JSON line per phase; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero, without that line, when
no CUDA device is present or any phase fails. Imports nothing of JAX.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import torch

from attention_based_tbn_tpu_torch.config import load_config
from attention_based_tbn_tpu_torch.models.attention import PE_CHANNELS, positional_encoding_table
from attention_based_tbn_tpu_torch.ops import build, kernels
from attention_based_tbn_tpu_torch.tools.serve import ServingModel, bench, make_server

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
}
SOURCES = {
    "pe_block": "attention_based_tbn_tpu_torch/ops/csrc/pe_block.cu",
    "mha": "attention_based_tbn_tpu_torch/ops/csrc/mha.cu",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
# come first and stay specific.
CATEGORIES = (
    ("pe_block", ("pe_block_kernel",)),
    ("mha", ("linear_kernel", "attend_kernel")),
    ("conv", ("fprop", "convolve", "conv2d", "convolution", "winograd", "wgrad", "dgrad")),
    ("gemm", ("gemm", "gemv", "nvjet", "matmul")),
    ("pool", ("pool",)),
    ("copy", ("copy", "memcpy", "memset", "cat")),
)


def profile_request(model: ServingModel, b: int) -> dict:
    """Device time of one served request by kernel category and the
    longest kernels (torch.profiler's device events: kernels and copies),
    and the device's busy share of the request's host wall time (one
    stream, so device events do not overlap)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = model.example_batch(b, seed=b)
    model.predict(batch)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        model.predict(batch)
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
    return {"phase": "profile", "batch": b, "wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "device_events": sum(count for _, count in by_kernel.values()),
            "device_ms_by_category": dict(sorted(by_category.items(), key=lambda kv: -kv[1])),
            "top_device_events": [[name, ms, count] for name, (ms, count) in top]}


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    failures: list = []
    card = gpu_line()
    start = time.perf_counter()
    build.build()
    emit({"phase": "env", "gpu": card, "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "build_s": time.perf_counter() - start,
          "ptxas": {n: [line.split("ptxas info    : ")[-1].strip()
                        for line in build.ptxas_report(n).splitlines() if "Used" in line]
                    for n in build.KERNELS}})

    main_case = check_kernels(failures)

    cfg = load_config()  # flagship defaults: tri-modal MHA, 224^2, 25 seg, bf16, kernels on
    model = ServingModel(cfg, None, device="cuda", batch_buckets=(1, 10))
    kernels.reset_launch_counts()
    outputs = serve_requests(model, failures)
    launches = {name: fn.launches for name, fn in kernels.WRAPPERS.items()}
    emit({"phase": "launches", **launches})
    for name, count in launches.items():
        if count < 1:
            failures.append(f"kernel {name} was not launched on the main path")

    batch10, out10 = outputs[10]
    check_agreement(model, batch10, out10, failures)

    for b in (1, 10):
        emit({"phase": "latency", "gpu": card, **bench(model, 20, b)})
        emit({**profile_request(model, b), "gpu": card})
        emit({**layer_times(model, b), "gpu": card})

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

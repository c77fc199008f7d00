"""Closed-loop serving through ``ServingModel.predict``.

``clients`` threads each send requests back to back, every request
``clips_per_request`` clips of ``segments`` segments in all the
configuration's modalities, cycling a pool of ``distinct_per_client``
seeded requests of their own. The model serves one batch bucket, the
request's size. The window opens when the clients start and closes
``--seconds`` later; no request is sent after it closes, and the ones in
flight are waited for. Rate and tail count the requests completed inside
the window; every completed request is compared with the reference.

A traced run adds CUDA events around each tower (forward hooks on
``Base_<modality>``) for the window, then a profiled stretch of
``traced_requests_per_client`` requests a client.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import torch

from portbench.costs import flops, kernels
from portbench.harness import checks, device as dev, seeded
from portbench.harness import trace as tracing
from portbench.reference import tbn
from portbench.reference.precision import FLOAT32, Precision

JOIN_S = 120.0  # a request still out this long after the window never came


def _clients(served, pool, clients: int, distinct: int, stop: Optional[float] = None,
             count: Optional[int] = None) -> list:
    """Run the clients until ``stop`` (perf_counter) or for ``count``
    requests each. Returns (input index, sent, done, outputs, error) per
    request sent; raises if a client never returns."""
    results, lock = [], threading.Lock()

    def client(k: int) -> None:
        i = 0
        while (time.perf_counter() < stop) if count is None else (i < count):
            index = k * distinct + i % distinct
            sent = time.perf_counter()
            try:
                with torch.profiler.record_function(tracing.LABELS[0]):
                    out, error = served.predict(pool[index]), None
            except Exception as exc:  # a failed request is counted, not fatal
                out, error = None, repr(exc)
            done = time.perf_counter()
            with lock:
                results.append((index, sent, done, out, error))
            i += 1

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(0.0, (stop or time.perf_counter()) - time.perf_counter()) + JOIN_S)
    if any(t.is_alive() for t in threads):
        raise RuntimeError(f"a client got no answer within {JOIN_S} s of the window's end")
    return results


class TowerSpans:
    """CUDA events at the entry and exit of each tower's forward: the
    device time between them, summed over the towers, per request."""

    def __init__(self, model, modality: List[str]):
        self.events, self.hooks = [], []
        for m in modality:
            module = getattr(model, f"Base_{m}")
            self.hooks.append(module.register_forward_pre_hook(
                lambda mod, args, m=m: self._mark(m, "enter")))
            self.hooks.append(module.register_forward_hook(
                lambda mod, args, out, m=m: self._mark(m, "exit")))
        self.first = modality[0]

    def _mark(self, modality: str, edge: str) -> None:
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        self.events.append((modality, edge, event))

    def close(self) -> dict:
        for hook in self.hooks:
            hook.remove()
        torch.cuda.synchronize()
        total, requests, open_ = 0.0, 0, {}
        for modality, edge, event in self.events:
            if edge == "enter":
                open_[modality] = event
                requests += modality == self.first
            else:
                total += open_.pop(modality).elapsed_time(event)
        return {"towers_ms": total, "requests": requests}


def reference_outputs(run, host_params: dict, pool: list, rows: int,
                      prec: Precision = FLOAT32) -> dict:
    """{input index: the reference's outputs as numpy} for every request of
    the pool, one request at a time (``prec``: the control's rounding)."""
    params = {k: v.to(run.device) for k, v in host_params.items()}
    out = {}
    with dev.exact_float32():
        for index, request in enumerate(pool):
            batch = {k: torch.from_numpy(v).to(run.device) for k, v in request.items()}
            got = tbn.forward_in_blocks(params, run.desc, batch, rows, prec)
            out[index] = {k: v.float().cpu().numpy() for k, v in got.items()}
    return out


def run(run) -> dict:
    phases = dev.Phases(run.started)
    from attention_based_tbn_tpu_torch.tools.serve import ServingModel

    mix, desc, device = run.traffic, run.desc, run.device
    b, n = mix["clips_per_request"], mix["segments"]
    clients, distinct = mix["clients"], mix["distinct_per_client"]
    phases.mark("imports")
    dev.build_kernels(device, run.config["kernels"]["serve"])
    phases.mark("kernel builds")
    params = seeded.make_params(desc, run.seed, device)
    phases.mark("weights")
    cfg = run.port_config([f"test.num_segments={n}", f"tpu.export_batch={b}"])
    served = ServingModel(cfg, weights=params, device=device, batch_buckets=[b])
    phases.mark("ServingModel")
    host_params = {k: v.cpu() for k, v in params.items()}
    del params
    gen = seeded.generator(run.seed, "inputs", device)
    pool = [{k: v.cpu().numpy() for k, v in seeded.clips(desc, b, n, gen, device).items()}
            for _ in range(clients * distinct)]
    dev.release(device)
    dev.reset_peak(device)
    phases.mark("requests")

    # warm-up: every client's first request alone, then all of them at once
    for k in range(clients):
        served.predict(pool[k * distinct])
    _clients(served, pool, clients, distinct, count=2)
    dev.sync(device)
    phases.mark("warm-up")
    spans = (TowerSpans(served.model, desc["modality"])
             if run.trace and dev.is_cuda(device) else None)
    setup_s = run.since_start()

    start = time.perf_counter()
    stop = start + run.seconds
    results = _clients(served, pool, clients, distinct, stop=stop)
    record = {"setup_s": setup_s, "setup_phases": phases.seconds, "window_s": run.seconds,
              "chips": run.chips,
              "attempted": len(results), "failed": sum(r[4] is not None for r in results),
              "errors": [r[4] for r in results if r[4] is not None][:5]}
    inside = [r for r in results if r[4] is None and r[2] <= stop]
    record["clips"] = b * len(inside)
    record["latencies_s"] = [done - sent for _, sent, done, _, _ in inside]

    if run.trace:
        record["spans"] = spans.close() if spans else None
        per = mix["traced_requests_per_client"]
        record["trace"] = tracing.profile(
            lambda: _clients(served, pool, clients, distinct, count=per), device)
        record["items_traced"] = clients * per
        shapes = flops.model_shapes(desc, b, n)
        record["work_least_s"] = kernels.work(run.config["kernels"]["serve"], shapes, train=False)
        record["flops_per_clip"] = flops.flops_per_clip(desc, n, train=False)
    record["peak_bytes"] = dev.peak_bytes(device)
    record["device_kind"] = dev.kind(device)
    del served
    dev.release(device)
    record["pool"], record["host_params"] = pool, host_params

    completed = [(r[0], r[3]) for r in results if r[4] is None]
    want = reference_outputs(run, host_params, pool, b)
    record["reference"] = want
    record["numbers"] = checks.serve_numbers(completed, want, list(desc["num_classes"]))
    return record


def control_numbers(run, record: dict, prec: Precision) -> dict:
    """The reference in ``prec`` put in the program's place: its numbers
    against the float32 reference, on the run's requests."""
    got = reference_outputs(run, record["host_params"], record["pool"],
                            run.traffic["clips_per_request"], prec)
    return checks.serve_numbers(list(got.items()), record["reference"],
                                list(run.desc["num_classes"]))


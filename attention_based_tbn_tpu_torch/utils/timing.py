"""Device time of a call on the card, by CUDA events.

* :func:`event_ms`: events around back-to-back calls. Where the caller's
  host work (a wrapper's checks, allocations and launch) takes longer than
  the device's, this is the host's pace.
* :func:`graph_ms`: the calls captured in one CUDA graph and replayed
  between events: the device's own time, with dispatch out of the way.
"""

from __future__ import annotations

import torch


def event_ms(fn, iters: int = 50) -> float:
    """Mean ms of one call of ``fn``, by CUDA events over ``iters``
    back-to-back calls after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 10) -> float:
    """Device ms of one call of ``fn``: ``iters`` calls captured in one CUDA
    graph after one warm-up call, the graph replayed once to settle, then
    once between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms
